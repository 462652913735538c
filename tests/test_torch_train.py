"""The port's training path against the JAX package (CPU, small shapes).

A whole port train step (fused path, the kernels' plain versions) against
svnet_tpu.train.steps.make_train_step on flax ``model.apply``: loss,
gradients, new BN running statistics and the parameters after two Adam
steps. The flax path splits the k-max pool's gradient among exact ties
and the fused path routes it to the first argmax rank, and binary STE
signs turn f32 reassociation into isolated flips, so the gradient bars
are the flip-tolerant ones of tests/test_fused_train.py: cosine >= 0.99
on d(points)-class tensors, >= 0.9 per parameter leaf of 8 or more
entries, and relative error of all parameter gradients together <= 5e-2.
Inputs are made with numpy from a seed and handed to both sides.

The un-fused train forward in float64 is in
tests/test_torch_train_unfused.py.
"""

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnet_tpu import models
from svnet_tpu.nn.sv_layers import ste_sign as jax_ste_sign
from svnet_tpu.train.losses import cal_loss as jax_cal_loss
from svnet_tpu.train.optim import cosine_schedule as jax_cosine
from svnet_tpu.train.optim import make_optimizer as jax_make_optimizer
from svnet_tpu.train.steps import TrainState
from svnet_tpu.train.steps import make_train_step as jax_make_train_step
from svnet_tpu_torch.cli import flags
from svnet_tpu_torch.cli.main_cls_dgcnn import main as cls_main
from svnet_tpu_torch.data import ArrayDataset, Loader
from svnet_tpu_torch.infer import SVDGCNNClsEngine
from svnet_tpu_torch.nn.sv_layers import ste_sign
from svnet_tpu_torch.train.fused import make_fused_train_apply
from svnet_tpu_torch.train.losses import cal_loss
from svnet_tpu_torch.train.optim import cosine_schedule
from svnet_tpu_torch.train.steps import create_state, make_train_step, tree_map
from svnet_tpu_torch.utils.convert import from_flax, to_flax

B, N, K, CLASSES = 4, 64, 4, 10
LR, WD = 1e-3, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def compile_once(fn, *args, **jit_kw):
    """``jax.jit(fn, **jit_kw)`` compiled for ``args``' shapes without XLA's
    backend optimizations, for a float64 reference or a ``model.init``
    whose weights both sides take: about half the compile time. A float32
    reference keeps ``jax.jit``, the rounding its bars were set against.
    Call the result on arguments of the same structure and types."""
    return jax.jit(fn, **jit_kw).lower(*args).compile(
        {"xla_backend_optimization_level": 0})


def _flat(tree, prefix=""):
    out = {}
    for name, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{name}."))
        else:
            out[f"{prefix}{name}"] = np.asarray(val, dtype=np.float64)
    return out


def _cos(a, b):
    a, b = np.ravel(a), np.ravel(b)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def _rel(a, b):
    return float(np.linalg.norm(np.ravel(a) - np.ravel(b))
                 / (np.linalg.norm(np.ravel(b)) + 1e-6))


def _flip_tolerant(got: dict, want: dict, total: float):
    for path, w in want.items():
        # leaves whose gradient is pure rounding noise (the head's B=2
        # batch norm normalizes to +-1) are held by the total below
        if w.size >= 8 and np.linalg.norm(w) * np.linalg.norm(got[path]) > 1e-10:
            assert _cos(got[path], w) >= 0.9, path
    order = sorted(want)
    assert _rel(np.concatenate([got[p].ravel() for p in order]),
                np.concatenate([want[p].ravel() for p in order])) <= total


@pytest.fixture(scope="module", params=[True, False], ids=["binary", "fp"])
def two_steps(request):
    """Two train steps through both packages: the binary model with its
    recipe's Adam, and the FP model (dropout off) with Adam forced."""
    binary = request.param
    rng = np.random.default_rng(0)
    points = rng.standard_normal((B, N, 3)).astype(np.float32)
    target = np.array([3, 7, 1, 9])
    model = models.SV_DGCNN_CLS(num_classes=CLASSES, k=K, binary=binary,
                                dropout=0.0)
    # numpy leaves carry no weak types: the jitted step compiles once
    init_args = (jax.random.PRNGKey(1), jnp.asarray(points))
    var = jax.tree.map(np.asarray, compile_once(model.init, *init_args)(*init_args))
    tx = jax_make_optimizer(binary=binary, lr=LR, epochs=2, steps_per_epoch=1,
                            weight_decay=WD, opt="adam")
    state = TrainState.create(params=var["params"],
                              batch_stats=var["batch_stats"], tx=tx)
    batch = {"points": jnp.asarray(points), "target": jnp.asarray(target)}

    def loss_fn(params, stats, batch):
        out, _ = model.apply({"params": params, "batch_stats": stats},
                             batch["points"], True, mutable=["batch_stats"])
        return jax_cal_loss(out, batch["target"])

    jstep = jax_make_train_step(model, jax_cal_loss, rot="aligned")

    def both(state, batch, key):
        return (jax.value_and_grad(loss_fn)(state.params, state.batch_stats, batch),
                jstep(state, batch, key)[0])

    key = jax.random.PRNGKey(0)
    # one compile: the gradients at the state, and its step (float32, under
    # jax.jit: the rounding the bars were set against)
    grads_and_step = jax.jit(both)
    (want_loss, want_grads), s1 = grads_and_step(state, batch, key)
    s2 = grads_and_step(s1, batch, key)[1]

    tstate = create_state(from_flax(var), binary=binary, lr=LR, epochs=2,
                          steps_per_epoch=1, weight_decay=WD, opt="adam",
                          device="cpu")
    step = make_train_step(
        make_fused_train_apply(CLASSES, K, binary=binary, dropout=0.0),
        cal_loss, rot="aligned")
    tb = {"points": torch.from_numpy(points), "target": torch.from_numpy(target)}
    gen = torch.Generator().manual_seed(0)
    got_loss, _ = step(tstate, tb, gen)
    got_grads = _flat(to_flax(tree_map(lambda t: t.grad, tstate.params)))
    got_stats1 = _flat(to_flax(tstate.batch_stats))
    step(tstate, tb, gen)
    return binary, {
        "loss": (got_loss.item(), float(want_loss)),
        "grads": (got_grads, _flat(want_grads)),
        "stats": (got_stats1, _flat(s1.batch_stats)),
        "params": (_flat(to_flax(tstate.params)), _flat(s2.params),
                   _flat(var["params"])),
    }


def _concat(tree: dict):
    return np.concatenate([tree[p].ravel() for p in sorted(tree)])


def test_train_step_loss_matches_jax(two_steps):
    binary, r = two_steps
    got, want = r["loss"]
    np.testing.assert_allclose(got, want, rtol=1e-4 if binary else 1e-5)


def test_train_step_grads_match_jax(two_steps):
    """Binary: the flip-tolerant bars. FP has no sign to flip and no exact
    max ties: all gradients together within 1e-3 (measured 2.4e-5)."""
    binary, r = two_steps
    got, want = r["grads"]
    assert set(got) == set(want)
    _flip_tolerant(got, want, 5e-2 if binary else 1e-3)


def test_train_step_batch_stats_match_jax(two_steps):
    _, r = two_steps
    got, want = r["stats"]
    assert set(got) == set(want)
    for path, w in want.items():
        assert _rel(got[path], w) <= 2e-2, path


def test_two_adam_steps_match_jax(two_steps):
    """Parameters after two Adam steps (L2 decay before the moments, the
    per-epoch cosine). Adam divides each gradient by its own magnitude,
    so an entry whose small gradient differs by a flip moves by up to lr
    either way: the binary update is held as a whole (cosine >= 0.95,
    measured 0.98); the FP update entry by entry."""
    binary, r = two_steps
    got, want, start = r["params"]
    du, dw = _concat(got) - _concat(start), _concat(want) - _concat(start)
    if binary:
        assert _cos(du, dw) >= 0.95
    else:
        assert _rel(du, dw) <= 1e-2
        # measured 0.997: the rest are entries whose gradient is tiny
        assert np.mean(np.abs(_concat(got) - _concat(want)) <= 1e-5) >= 0.99


def test_ste_sign_matches_jax():
    x = np.random.default_rng(1).uniform(-3, 3, 257).astype(np.float32)
    x[:3] = (0.0, 1.0, -1.0)
    w = np.random.default_rng(2).standard_normal(257).astype(np.float32)
    want, want_g = jax.value_and_grad(
        lambda v: jnp.sum(jax_ste_sign(v) * w))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = (ste_sign(xt) * torch.from_numpy(w)).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want_g))
    assert torch.equal(ste_sign(torch.zeros(2)), torch.zeros(2))


@pytest.mark.parametrize("smoothing", [True, False])
def test_cal_loss_matches_jax(smoothing):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((6, 40)).astype(np.float32)
    target = rng.integers(0, 40, 6)
    want, want_g = jax.value_and_grad(
        lambda z: jax_cal_loss(z, jnp.asarray(target), smoothing))(jnp.asarray(logits))
    lt = torch.tensor(logits, requires_grad=True)
    got = cal_loss(lt, torch.from_numpy(target), smoothing)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("eta_min", [0.0, 1e-3])
def test_cosine_schedule_matches_jax(eta_min):
    got = cosine_schedule(0.1, 7, 5, eta_min)
    want = jax_cosine(0.1, 7, 5, eta_min)
    for step in range(0, 40, 3):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)


def test_entry_points_need_the_card_unless_asked():
    """The engine, the trainer and the Loader default to the card and
    raise without one; they never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from svnet_tpu_torch.models.sv_dgcnn import init_params

    tree = init_params(CLASSES, K, True, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError):
        SVDGCNNClsEngine(tree, CLASSES, K, True)
    with pytest.raises(RuntimeError):
        create_state(tree, binary=True, lr=LR, epochs=1, steps_per_epoch=1)
    with pytest.raises(RuntimeError):
        Loader(ArrayDataset(np.zeros((2, 8, 3)), np.zeros(2)), 2)
    with pytest.raises(RuntimeError):
        cls_main(["--binary", "--epochs", "1"])


def test_unported_flags_raise():
    """The features still missing raise NotImplementedError; KD, --fused
    eval and the knobs are ported (tests/test_torch_recipe.py,
    tests/test_torch_knobs.py), and so are --model vn|original,
    --dataset scanobjectnn (tests/test_torch_zoo_data.py), --profile-dir
    and --debug-nans (tests/test_torch_profile_flag.py)."""
    parser = flags.build_parser()
    for argv in (["--dp", "2"], ["--tp", "2"]):
        with pytest.raises(NotImplementedError):
            flags.check_ported(parser.parse_args(argv))
    for argv in (["--distill", "--preload", "x"], ["--model", "vn"],
                 ["--dataset", "scanobjectnn"], ["--profile-dir", "p"],
                 ["--debug-nans"]):
        flags.check_ported(parser.parse_args(argv))


def test_cli_trains_one_epoch_on_cpu(tmp_path):
    """The CLI end to end on a tiny ModelNet40-format HDF5 file: fused
    train steps (``config.fused_train`` "on": "auto" takes the un-fused
    path off the card), BN re-estimation, eval through the eager model,
    checkpoint and the greppable EPOCH line; then --test on the best
    checkpoint."""
    from svnet_tpu_torch import config

    was = config.fused_train
    config.set_fused_train("on")
    try:
        _cli_one_epoch(tmp_path)
    finally:
        config.set_fused_train(was)


def _cli_one_epoch(tmp_path):
    rng = np.random.default_rng(4)
    root = tmp_path / "data" / "modelnet40_ply_hdf5_2048"
    root.mkdir(parents=True)
    for part, n in (("train", 8), ("test", 4)):
        with h5py.File(root / f"ply_data_{part}0.h5", "w") as f:
            f["data"] = rng.standard_normal((n, 48, 3)).astype("float32")
            f["label"] = rng.integers(0, 40, (n, 1)).astype("int64")
    save = tmp_path / "results"
    common = ["--binary", "--epochs", "1", "--batch-size", "4",
              "--num-points", "32", "--k", "4", "--num-workers", "1",
              "--bn-reestimate", "1", "--rot-test", "aligned", "--device", "cpu",
              "--data-dir", str(tmp_path / "data"), "--save-dir", str(save)]
    acc = cls_main(common)
    assert 0.0 <= acc <= 1.0
    log = (save / "cls-log.txt").read_text()
    assert "EPOCH 000/001 | Test: loss" in log
    best = save / "save_models" / "model_best.ckpt"
    assert best.exists() and (save / "save_models" / "latest.txt").exists()
    assert cls_main(common + ["--test", str(best)]) == acc
