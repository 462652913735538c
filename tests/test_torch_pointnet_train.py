"""The port's SV-PointNet classification training against the JAX package
(CPU, B=4, N=64, k=8; the model's widths are fixed).

Kernel B7's plain versions (``ops/kernels/edge_gather.py``) against the
Pallas ``edge_gather`` in interpret mode and against a float64
``np.add.at``; ``EdgeGather`` through autograd; the train forward
(``train/pointnet.py``, ``oracle=True``) against flax
``SV_PointNet_CLS.apply(train=True, mutable=["batch_stats"])``; one train
step and two Adam steps of the ``pointnet_cls`` recipe against the JAX
step; the StepLR schedule; the flags; the CLI for one epoch on the CPU.

Weights are made by the port's seeded ``init_params`` and handed to flax
as numpy. The JAX side runs one jitted ``value_and_grad`` per model and
precision: its loss, logits, new batch statistics and gradients, and the
jitted ``TrainState.apply_gradients`` of the ``pointnet_cls`` optimizer
for the Adam steps -- the body of ``svnet_tpu.train.steps.make_train_step``
with ``rot="aligned"``. The FP model's dropout is off on both sides
(flax's ``Dropout`` patched to the identity, the port's ``dropout=0.0``).
The binary model's float32 train forward is chaotic at random init (JAX
under jit and JAX eager differ at top-1), so both models are held to flax
in float64 (JAX with x64 enabled), where no sign lies within rounding of
0, and the FP model also in float32, as the trainer runs it.

The float64 train forward, step and Adam steps are in
tests/test_torch_pointnet_train_steps.py.
"""

import flax.linen as flax_nn
import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnet_tpu import config as jax_config
from svnet_tpu import models
from svnet_tpu.ops.pallas import edge_gather as jax_eg
from svnet_tpu.train.losses import cal_loss as jax_cal_loss
from svnet_tpu.train.optim import make_optimizer as jax_make_optimizer
from svnet_tpu.train.optim import step_schedule as jax_step_schedule
from svnet_tpu.train.steps import TrainState
from svnet_tpu_torch import ops
from svnet_tpu_torch.cli import flags
from svnet_tpu_torch.cli.main_cls_pointnet import main as pointnet_main
from svnet_tpu_torch.models.sv_pointnet import init_params
from svnet_tpu_torch.ops.kernels import edge_gather as eg
from svnet_tpu_torch.train.losses import cal_loss
from svnet_tpu_torch.train.optim import make_optimizer, step_schedule
from svnet_tpu_torch.train.pointnet import make_train_apply_cls
from svnet_tpu_torch.train.steps import TrainState as TrainState_
from svnet_tpu_torch.train.steps import create_state, make_train_step, tree_map
from svnet_tpu_torch.utils.convert import flatten, from_flax, to_flax

from test_torch_train import compile_once

B, N, K, CLASSES = 4, 64, 8, 10
LR, WD = 1e-3, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _concat(tree: dict):
    return np.concatenate([tree[p].ravel() for p in sorted(tree)])


def _gather_inputs(shape, seed=0, hub=False):
    b, n, k, c = shape
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((b, n, c)).astype(np.float32)
    idx = rng.integers(0, n, (b, n, k)).astype(np.int32)
    if hub:  # point 5 is a neighbour of every centre, many times over
        idx[:, :, : k // 2] = 5
    g = rng.standard_normal((b, n, k, c)).astype(np.float32)
    return src, idx, g


def _dsrc64(idx, g, n):
    want = np.zeros((idx.shape[0], n, g.shape[-1]))
    for b in range(idx.shape[0]):
        np.add.at(want[b], idx[b].reshape(-1), g[b].reshape(-1, g.shape[-1]))
    return want


@pytest.mark.parametrize("shape", [(2, 128, 20, 3), (2, 128, 8, 22)])
def test_edge_gather_plain_matches_jax_kernel(shape):
    """Forward bitwise; dsrc within 1e-4: the Pallas backward sums bf16 hi
    and lo planes of the cotangent (ROADMAP C12), the plain version f32 in
    edge order."""
    src, idx, g = _gather_inputs(shape)
    want, vjp = jax.vjp(lambda s: jax_eg.edge_gather(s, jnp.asarray(idx), True),
                        jnp.asarray(src))
    (want_d,) = vjp(jnp.asarray(g))
    got = eg.edge_gather_fwd_plain(torch.from_numpy(src), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got_d = eg.edge_gather_bwd_plain(torch.from_numpy(g), torch.from_numpy(idx),
                                     shape[1])
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("hub", [False, True], ids=["ragged", "hub"])
def test_edge_gather_bwd_plain_matches_float64(hub):
    """Ragged N and k, and a hub point with an in-degree of 400: within
    1e-6 of max |dsrc| of a float64 scatter-add."""
    shape = (2, 100, 7, 5) if not hub else (2, 100, 8, 5)
    _, idx, g = _gather_inputs(shape, seed=1, hub=hub)
    got = eg.edge_gather_bwd_plain(torch.from_numpy(g), torch.from_numpy(idx),
                                   shape[1]).double().numpy()
    want = _dsrc64(idx, g, shape[1])
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_edge_gather_autograd_on_cpu():
    """``EdgeGather`` and ``gather_neighbors`` on CPU tensors take the plain
    route: the same rows and gradient as advanced indexing, none for the
    ids; a device that is neither CPU nor CUDA raises."""
    src, idx, g = _gather_inputs((2, 100, 7, 6), seed=2)
    x = torch.from_numpy(src).reshape(2, 100, 2, 3).requires_grad_(True)
    ids = torch.from_numpy(idx)
    got = ops.gather_neighbors(x, ids)
    got.backward(torch.from_numpy(g).reshape(got.shape))
    x_ref = x.detach().clone().requires_grad_(True)
    want = x_ref[torch.arange(2)[:, None, None], ids.long()]
    want.backward(torch.from_numpy(g).reshape(want.shape))
    assert torch.equal(got, want)
    np.testing.assert_allclose(x.grad.numpy(), x_ref.grad.numpy(), rtol=0,
                               atol=1e-6)
    assert eg.edge_gather_fwd.launches == 0 and eg.edge_gather_bwd.launches == 0
    with pytest.raises(RuntimeError):
        eg.edge_gather(torch.empty(2, 100, 3, device="meta"),
                       torch.empty(2, 100, 7, dtype=torch.int32, device="meta"))


def _run(binary: bool, f64: bool):
    """The same weights and batch through both packages, in float64 (JAX
    with x64 enabled, the port's trees cast) or float32: the train
    forward, one step's loss, gradients and new statistics, and the
    parameters after two Adam steps of the pointnet_cls recipe."""
    dt = np.float64 if f64 else np.float32
    rng = np.random.default_rng(3)
    points = rng.standard_normal((B, N, 3)).astype(dt)
    target = np.array([3, 7, 1, 9])
    var32 = to_flax(init_params(CLASSES, K, binary, torch.Generator().manual_seed(5)))
    model = models.SV_PointNet_CLS(num_classes=CLASSES, k=K, binary=binary)

    def loss_fn(params, stats, pts, tgt):
        out, upd = model.apply({"params": params, "batch_stats": stats}, pts,
                               True, mutable=["batch_stats"])
        return jax_cal_loss(out, tgt), (out, upd["batch_stats"])

    mp = pytest.MonkeyPatch()
    mp.setattr(flax_nn.Dropout, "__call__", lambda self, x, *a, **kw: x)
    try:
        # float64 compiled once without backend optimizations; the float32
        # reference under jax.jit, at the rounding its bars were set against
        jit = compile_once if f64 else (lambda fn, *args: jax.jit(fn))
        with jax.enable_x64(f64):
            var = jax.tree.map(lambda a: np.asarray(a, dt), var32)
            data = (jnp.asarray(points), jnp.asarray(target))
            vg = jit(jax.value_and_grad(loss_fn, has_aux=True),
                     var["params"], var["batch_stats"], *data)
            (loss, (logits, stats)), grads = vg(var["params"], var["batch_stats"],
                                                *data)
            tx = jax_make_optimizer(binary=binary, lr=LR, epochs=2,
                                    steps_per_epoch=1, weight_decay=WD,
                                    recipe="pointnet_cls")
            # TrainState.create with the optimizer's state made in one compile
            s0 = TrainState(step=jnp.zeros((), jnp.int32), params=var["params"],
                            batch_stats=var["batch_stats"],
                            opt_state=jit(tx.init, var["params"])(var["params"]),
                            tx=tx)
            update = jit(TrainState.apply_gradients, s0, grads, stats)
            s1 = update(s0, grads, stats)
            (_, (_, stats2)), grads2 = vg(s1.params, s1.batch_stats, *data)
            s2 = update(s1, grads2, stats2)
            want = {"logits": np.asarray(logits), "stats": _flat(stats),
                    "loss": float(loss), "grads": _flat(grads),
                    "params": _flat(s2.params)}
    finally:
        mp.undo()

    tw = from_flax(var32)
    if f64:  # create_state keeps float32: the same state, cast
        params = tree_map(lambda t: t.double().requires_grad_(True), tw["params"])
        leaves = [leaf for _, leaf in sorted(flatten(params).items())]
        opt, sched = make_optimizer(leaves, binary=binary, lr=LR, epochs=2,
                                    steps_per_epoch=1, weight_decay=WD,
                                    recipe="pointnet_cls")
        state = TrainState_(params, tree_map(torch.Tensor.double,
                                             tw["batch_stats"]), opt, sched)
    else:
        state = create_state(tw, binary=binary, lr=LR, epochs=2, steps_per_epoch=1,
                             weight_decay=WD, recipe="pointnet_cls", device="cpu")
    start = _flat(to_flax(state.params))
    oracle = make_train_apply_cls(CLASSES, K, binary, dropout=0.0, oracle=True)
    with torch.no_grad():
        logits, stats = oracle(state.params, state.batch_stats,
                               torch.from_numpy(points))
    tstep = make_train_step(make_train_apply_cls(CLASSES, K, binary, dropout=0.0),
                            cal_loss, rot="aligned")
    batch = {"points": torch.from_numpy(points), "target": torch.from_numpy(target)}
    gen = torch.Generator().manual_seed(0)
    loss, _ = tstep(state, batch, gen)
    got = {"logits": logits.numpy(), "stats": _flat(to_flax(stats)),
           "loss": loss.item(),
           "grads": _flat(to_flax(tree_map(lambda t: t.grad, state.params)))}
    tstep(state, batch, gen)
    got["params"] = _flat(to_flax(state.params))
    return got, want, start


def test_fp_train_step_matches_jax_float32():
    """The FP model's step in float32, as the trainer runs it. BatchNorm's
    E[x^2] - E[x]^2 (flax's fast variance, which the port keeps) over the
    SV_STNkd token's B=4 samples amplifies reassociation, so the bars are
    wider than float64's: logits within 2e-3 (measured 8e-4, JAX jit
    against JAX eager 1.3e-4), loss 1e-4 relative, gradients together
    within 2e-2 and each leaf's cosine >= 0.99, running statistics 1e-3
    relative, the two-step update's cosine >= 0.98. The binary model's
    float32 forward is chaotic at random init (JAX jit against JAX eager:
    logits 0.84 apart, top-1 agreement 0.25) and is held in float64
    above."""
    got, want, start = _run(False, f64=False)
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=0, atol=2e-3)
    for path, w in want["stats"].items():
        assert _rel(got["stats"][path], w) <= 1e-3, path
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    g, w = got["grads"], want["grads"]
    for path in w:
        if w[path].size >= 8 and np.linalg.norm(w[path]) > 1e-10:
            assert _cos(g[path], w[path]) >= 0.99, path
    assert _rel(_concat(g), _concat(w)) <= 2e-2
    st = _concat(start)
    assert _cos(_concat(got["params"]) - st, _concat(want["params"]) - st) >= 0.98


def test_gather_runs_forward_only_in_a_train_step(monkeypatch):
    """The step differentiates the weights, not the points, in both
    packages: the JAX step (``config.edge_gather='pallas'``) traces the
    Pallas gather's forward and never its backward, and the port's step
    never calls the scatter-add."""
    var = to_flax(init_params(CLASSES, K, True, torch.Generator().manual_seed(5)))
    model = models.SV_PointNet_CLS(num_classes=CLASSES, k=K, binary=True)
    pts = jnp.asarray(np.random.default_rng(4).standard_normal((2, N, 3)),
                      jnp.float32)

    def loss(params):
        out, _ = model.apply({"params": params, "batch_stats": var["batch_stats"]},
                             pts, True, mutable=["batch_stats"])
        return out.sum()

    monkeypatch.setattr(jax_config, "edge_gather", "pallas")
    jaxpr = str(jax.make_jaxpr(jax.value_and_grad(loss))(var["params"]))
    assert jaxpr.count("pallas_call") == 1

    calls, bwd = [], eg.edge_gather_bwd_plain
    monkeypatch.setattr(eg, "edge_gather_bwd_plain",
                        lambda *a: calls.append(a) or bwd(*a))
    state = create_state(from_flax(var), binary=True, lr=LR, epochs=1,
                         steps_per_epoch=1, recipe="pointnet_cls", device="cpu")
    tstep = make_train_step(make_train_apply_cls(CLASSES, K, True), cal_loss, "z")
    batch = {"points": torch.from_numpy(np.array(pts)),
             "target": torch.tensor([1, 2])}
    loss_val, _ = tstep(state, batch, torch.Generator().manual_seed(0))
    assert torch.isfinite(loss_val) and not calls


def test_step_schedule_matches_jax():
    got, want = step_schedule(0.1, 3), jax_step_schedule(0.1, 3)
    for s in range(0, 200, 7):
        np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-6)


def test_entry_points_need_the_card_unless_asked():
    """The PointNet CLI and the state its apply trains default to the card
    and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tree = init_params(CLASSES, K, True, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError):
        create_state(tree, binary=True, lr=LR, epochs=1, steps_per_epoch=1,
                     recipe="pointnet_cls")
    with pytest.raises(RuntimeError):
        pointnet_main(["--binary", "--epochs", "1"])


def test_pointnet_flags():
    """``build_parser("cls", "pointnet")``: the JAX surface's defaults and
    model choices; every model of it is ported (``--model bipointnet``
    passes ``check_ported``; ``--binary`` beside it raises, C24)."""
    parser = flags.build_parser("cls", "pointnet")
    args = parser.parse_args([])
    assert (args.backbone, args.k, args.num_points, args.device) == (
        "pointnet", 20, 1024, "cuda")
    for model in ("original", "vn", "svnet", "bipointnet"):
        flags.check_ported(parser.parse_args(["--model", model]))
    with pytest.raises(ValueError):
        flags.check_ported(parser.parse_args(["--model", "bipointnet", "--binary"]))


def test_cli_trains_one_epoch_on_cpu(tmp_path):
    """``main_cls_pointnet --binary --device cpu`` end to end on a tiny
    ModelNet40-format HDF5 file: train steps, BN re-estimation, eval
    through the eager model, checkpoint and the EPOCH line; then --test on
    the best checkpoint."""
    rng = np.random.default_rng(6)
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
    acc = pointnet_main(common)
    assert 0.0 <= acc <= 1.0
    assert "EPOCH 000/001 | Test: loss" in (save / "cls-log.txt").read_text()
    best = save / "save_models" / "model_best.ckpt"
    assert best.exists()
    assert pointnet_main(common + ["--test", str(best)]) == acc
