"""The port's part-segmentation training against the JAX package (CPU,
B=2, N=64, k=4; the models' widths are fixed).

``shape_iou`` and ``manual_clip_schedule`` exactly JAX's; ``ShapeNetPart``
and the Loader's partseg batch bitwise JAX's on an HDF5 file the test
writes; one SV-DGCNN partseg train step (the fused forward, the kernels'
plain versions) and two Adam steps against
``svnet_tpu.train.steps.make_train_step(..., with_label=True)`` on flax
``SV_DGCNN_PSEG.apply``, to tests/test_torch_train.py's flip-tolerant
bars; the SV-PointNet partseg train forward, step and two Adam steps of
the ``pointnet_partseg`` recipe against flax ``SV_PointNet_PSEG`` in
float64 (its binary float32 forward is chaotic at random init, as the
classifier's is: tests/test_torch_pointnet_train.py); both partseg CLIs
for one epoch on the CPU; the entry points need the card unless asked;
the flags.

Weights are made by the port's seeded ``init_params_pseg`` and handed to
flax as numpy; one module-scoped JAX reference per family.

The SV-DGCNN partseg step and Adam steps are in
tests/test_torch_pseg_train_dgcnn.py.
"""

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnet_tpu import models
from svnet_tpu.data import Loader as JaxLoader
from svnet_tpu.data import ShapeNetPart as JaxShapeNetPart
from svnet_tpu.train.losses import cal_loss as jax_cal_loss
from svnet_tpu.train.metrics import shape_iou as jax_shape_iou
from svnet_tpu.train.optim import make_optimizer as jax_make_optimizer
from svnet_tpu.train.optim import manual_clip_schedule as jax_clip_schedule
from svnet_tpu.train.steps import TrainState
from svnet_tpu_torch.cli import flags
from svnet_tpu_torch.cli.main_partseg_dgcnn import main as dgcnn_main
from svnet_tpu_torch.cli.main_partseg_pointnet import main as pointnet_main
from svnet_tpu_torch.data import Loader, PartArrayDataset, ShapeNetPart
from svnet_tpu_torch.models import sv_pointnet
from svnet_tpu_torch.train.losses import cal_loss
from svnet_tpu_torch.train.metrics import INDEX_START, SEG_NUM, shape_iou
from svnet_tpu_torch.train.optim import make_optimizer, manual_clip_schedule
from svnet_tpu_torch.train.pointnet import make_train_apply_pseg
from svnet_tpu_torch.train.steps import TrainState as TrainState_
from svnet_tpu_torch.train.steps import create_state, make_train_step, tree_map
from svnet_tpu_torch.utils.convert import flatten, from_flax, to_flax

from test_torch_train import _concat, _cos, _flat, _rel, compile_once

B, N, K, PARTS = 2, 64, 4, 50
LR, WD = 1e-3, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed: int, dt=np.float32):
    """Seeded points, categories, their one-hot and part ids inside each
    category's range."""
    rng = np.random.default_rng(seed)
    points = rng.standard_normal((B, N, 3)).astype(dt)
    cat = np.array([3, 12])
    label = np.zeros((B, 16), np.float32)
    label[np.arange(B), cat] = 1.0
    seg = np.stack([INDEX_START[c] + rng.integers(0, SEG_NUM[c], N) for c in cat])
    return points, cat, label.astype(dt), seg


@pytest.mark.parametrize("class_choice", [None, "chair"])
def test_shape_iou_matches_jax(class_choice):
    """Per-shape IoUs equal JAX's, parts absent from both sides included."""
    rng = np.random.default_rng(1)
    cat = rng.integers(0, 16, 12) if class_choice is None else np.full(12, 4)
    seg = np.stack([INDEX_START[c] + rng.integers(0, SEG_NUM[c], 40) for c in cat])
    pred = np.where(rng.random(seg.shape) < 0.7, seg, rng.integers(0, 50, seg.shape))
    if class_choice is not None:
        seg, pred = seg - INDEX_START[4], np.clip(pred - INDEX_START[4], 0, 49)
    pred[0] = 49  # shape 0 predicts no part of its category
    got = shape_iou(pred, seg, cat, class_choice)
    assert got == jax_shape_iou(pred, seg, cat, class_choice)


def test_manual_clip_schedule_matches_jax():
    got, want = manual_clip_schedule(0.1, 3), jax_clip_schedule(0.1, 3)
    for s in range(0, 1200, 11):
        np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-6)
    assert manual_clip_schedule(1e-3, 1)(10_000) == 1e-5


def _write_shapenetpart(root, rng, n_points=48, sizes=(("train", 5), ("val", 3),
                                                       ("test", 4))):
    d = root / "shapenet_part_seg_hdf5_data"
    d.mkdir(parents=True)
    for part, m in sizes:
        cat = rng.integers(0, 16, (m, 1))
        cat[0] = 4  # a chair in every file, for --class-choice
        with h5py.File(d / f"ply_data_{part}0.h5", "w") as f:
            f["data"] = rng.standard_normal((m, n_points, 3)).astype("float32")
            f["label"] = cat.astype("int64")
            f["pid"] = np.stack([INDEX_START[c] + rng.integers(0, SEG_NUM[c], n_points)
                                 for c in cat[:, 0]]).astype("int64")


@pytest.mark.parametrize("class_choice", [None, "chair"])
def test_shapenetpart_and_loader_match_jax(tmp_path, class_choice):
    """The trainval set (its point permutation drawn from its own seed) and
    the test set, batched by both Loaders (shuffled, dropping the last
    batch; padding it): points, part ids, one-hot label, category, pad and
    size bitwise JAX's."""
    _write_shapenetpart(tmp_path, np.random.default_rng(2))
    for part, kw in (("trainval", {"shuffle": True, "drop_last": True, "seed": 5}),
                     ("test", {"pad_last": True})):
        ours = ShapeNetPart(32, str(tmp_path), part, class_choice, seed=7)
        theirs = JaxShapeNetPart(32, str(tmp_path), part, class_choice, seed=7)
        assert (ours.seg_num_all, ours.seg_start_index) == (
            theirs.seg_num_all, theirs.seg_start_index)
        got = list(Loader(ours, 2, device="cpu", **kw))
        want = list(JaxLoader(theirs, 2, **kw))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for key in ("points", "seg", "label", "category"):
                np.testing.assert_array_equal(g[key].numpy(), w[key])
            assert torch.equal(g["target"], g["seg"])
            assert (g["pad"], g["size"]) == (w["pad"], w["size"])


def test_part_array_dataset_batch():
    """The in-memory twin yields (points, category, seg), permuting points
    and part ids together; its batch carries the one-hot label."""
    points, cat, _, seg = _batch(3)
    data = PartArrayDataset(points, cat, seg, shuffle=True, seed=1)
    (batch,) = list(Loader(data, B, device="cpu"))
    assert batch["label"].shape == (B, 16) and batch["label"].dtype == torch.float32
    assert torch.equal(batch["label"].argmax(1), torch.from_numpy(cat))
    for b in range(B):  # each point keeps its part id
        got = {tuple(p): s for p, s in zip(batch["points"][b].tolist(),
                                           batch["seg"][b].tolist())}
        want = {tuple(p): s for p, s in zip(points[b].tolist(), seg[b].tolist())}
        assert got == want


@pytest.fixture(scope="module")
def pointnet_steps():
    """The binary SV-PointNet partseg train forward, one step's loss,
    gradients and statistics, and two Adam steps of the pointnet_partseg
    recipe, in float64 (JAX with x64 enabled, the port's trees cast)."""
    points, _, label, seg = _batch(4, np.float64)
    var32 = to_flax(sv_pointnet.init_params_pseg(PARTS, K, True,
                                                 torch.Generator().manual_seed(5)))
    model = models.SV_PointNet_PSEG(num_part=PARTS, k=K, binary=True)

    def loss_fn(params, stats, pts, lab, tgt):
        out, upd = model.apply({"params": params, "batch_stats": stats}, pts, lab,
                               True, mutable=["batch_stats"])
        return jax_cal_loss(out, tgt, False), (out, upd["batch_stats"])

    with jax.enable_x64(True):
        var = jax.tree.map(lambda a: np.asarray(a, np.float64), var32)
        data = (jnp.asarray(points), jnp.asarray(label), jnp.asarray(seg))
        vg = compile_once(jax.value_and_grad(loss_fn, has_aux=True),
                          var["params"], var["batch_stats"], *data)
        (loss, (logits, stats)), grads = vg(var["params"], var["batch_stats"], *data)
        tx = jax_make_optimizer(binary=True, lr=LR, epochs=2, steps_per_epoch=1,
                                weight_decay=WD, recipe="pointnet_partseg")
        # TrainState.create with the optimizer's state made in one compile
        s0 = TrainState(step=jnp.zeros((), jnp.int32), params=var["params"],
                        batch_stats=var["batch_stats"],
                        opt_state=compile_once(tx.init, var["params"])(var["params"]),
                        tx=tx)
        update = compile_once(TrainState.apply_gradients, s0, grads, stats)
        s1 = update(s0, grads, stats)
        (_, (_, stats2)), grads2 = vg(s1.params, s1.batch_stats, *data)
        s2 = update(s1, grads2, stats2)
        want = {"logits": np.asarray(logits), "stats": _flat(stats),
                "loss": float(loss), "grads": _flat(grads),
                "params": _flat(s2.params)}

    tw = from_flax(var32)
    params = tree_map(lambda t: t.double().requires_grad_(True), tw["params"])
    leaves = [leaf for _, leaf in sorted(flatten(params).items())]
    opt, sched = make_optimizer(leaves, binary=True, lr=LR, epochs=2,
                                steps_per_epoch=1, weight_decay=WD,
                                recipe="pointnet_partseg")
    state = TrainState_(params, tree_map(torch.Tensor.double, tw["batch_stats"]),
                        opt, sched)
    start = _flat(to_flax(state.params))
    pts, lab = torch.from_numpy(points), torch.from_numpy(label)
    with torch.no_grad():
        logits, stats = make_train_apply_pseg(PARTS, K, True, oracle=True)(
            state.params, state.batch_stats, pts, lab)
    tstep = make_train_step(make_train_apply_pseg(PARTS, K, True),
                            lambda o, t: cal_loss(o, t, False), rot="aligned",
                            with_label=True)
    batch = {"points": pts, "label": lab, "target": torch.from_numpy(seg)}
    gen = torch.Generator().manual_seed(0)
    loss, _ = tstep(state, batch, gen)
    got = {"logits": logits.numpy(), "stats": _flat(to_flax(stats)),
           "loss": loss.item(),
           "grads": _flat(to_flax(tree_map(lambda t: t.grad, state.params)))}
    tstep(state, batch, gen)
    got["params"] = _flat(to_flax(state.params))
    return got, want, start


def test_pointnet_pseg_train_forward_matches_flax_float64(pointnet_steps):
    """The train forward (the oracle twin: plain kNN and gather) against
    flax ``SV_PointNet_PSEG.apply(train=True)`` in float64: logits and new
    running statistics within 1e-9."""
    got, want, _ = pointnet_steps
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=1e-9, atol=1e-9)
    assert set(got["stats"]) == set(want["stats"])
    for path, w in want["stats"].items():
        assert _rel(got["stats"][path], w) <= 1e-9, path


def test_pointnet_pseg_step_loss_and_grads_match_jax_float64(pointnet_steps):
    """Loss within 1e-12, all gradients together within 1e-9 relative."""
    got, want, _ = pointnet_steps
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-12)
    assert set(got["grads"]) == set(want["grads"])
    assert _rel(_concat(got["grads"]), _concat(want["grads"])) <= 1e-9


def test_pointnet_pseg_two_adam_steps_match_jax_float64(pointnet_steps):
    """Parameters after two Adam steps of the pointnet_partseg recipe, the
    binary update held as a whole as in
    tests/test_torch_pointnet_train.py: cosine >= 0.95."""
    got, want, start = pointnet_steps
    st = _concat(start)
    assert _cos(_concat(got["params"]) - st, _concat(want["params"]) - st) >= 0.95


@pytest.mark.parametrize("main", [dgcnn_main, pointnet_main],
                         ids=["dgcnn", "pointnet"])
def test_cli_trains_one_epoch_on_cpu(tmp_path, main):
    """Each partseg CLI end to end with ``--device cpu`` on a tiny
    ShapeNetPart-format HDF5 file: train steps, BN re-estimation, eval
    through the eager model, a finite IoU, the checkpoint and the EPOCH
    line; then --test on the best checkpoint gives the same IoU."""
    _write_shapenetpart(tmp_path / "data", np.random.default_rng(6))
    save = tmp_path / "results"
    common = ["--binary", "--epochs", "1", "--batch-size", "4",
              "--num-points", "32", "--k", "4", "--num-workers", "1",
              "--bn-reestimate", "1", "--rot-test", "aligned", "--device", "cpu",
              "--data-dir", str(tmp_path / "data"), "--save-dir", str(save)]
    iou = main(common)
    assert np.isfinite(iou) and 0.0 <= iou <= 1.0
    log = (save / "partseg-log.txt").read_text()
    assert "EPOCH 000/001 | Test: loss" in log and " iou " in log
    best = save / "save_models" / "model_best.ckpt"
    assert best.exists() and (save / "save_models" / "latest.txt").exists()
    assert main(common + ["--test", str(best)]) == iou


def test_entry_points_need_the_card_unless_asked():
    """The partseg CLIs and a pointnet_partseg state default to the card
    and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tree = sv_pointnet.init_params_pseg(PARTS, K, True,
                                        torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError):
        create_state(tree, binary=True, lr=LR, epochs=1, steps_per_epoch=1,
                     recipe="pointnet_partseg")
    for main in (dgcnn_main, pointnet_main):
        with pytest.raises(RuntimeError):
            main(["--binary", "--epochs", "1"])


def test_partseg_flags():
    """The partseg surface's defaults; ``--dataset shapenetpart`` is ported
    for partseg and not for cls; another dataset, --dp and --tp still
    raise NotImplementedError; --preload is ported, and --distill without
    it and --fused on SV-PointNet partseg raise ValueError (C24)."""
    parser = flags.build_parser("partseg", "pointnet")
    args = parser.parse_args([])
    assert (args.task, args.dataset, args.k, args.num_points, args.smoothing) == (
        "partseg", "shapenetpart", 40, 2048, False)
    flags.check_ported(args)
    flags.check_ported(flags.build_parser("partseg", "dgcnn").parse_args(
        ["--class-choice", "chair"]))
    for argv in (["--dataset", "s3dis"], ["--dp", "2"], ["--tp", "2"]):
        with pytest.raises(NotImplementedError):
            flags.check_ported(parser.parse_args(argv))
    flags.check_ported(parser.parse_args(["--preload", "x"]))
    for argv in (["--distill"], ["--fused", "--test", "x"]):
        with pytest.raises(ValueError):
            flags.check_ported(parser.parse_args(argv))
    with pytest.raises(NotImplementedError):
        flags.check_ported(flags.build_parser().parse_args(
            ["--dataset", "scanobjectnn"]))
