"""``--test --fused`` against JAX's ``_fused_cls_eval_step`` at
``--rot-test aligned``, and the serving pick's recipe (stage 1, stage 2,
the certification legs) through both SV-DGCNN CLIs at a tiny size, as in
tests/test_torch_recipe.py, whose helpers and autouse ``_one_torch_thread``
this file imports.

At most six tests a file: pytest-xdist's ``--dist loadfile`` queues files
by their number of tests, largest first, so these long JAX references run
beside tests/test_sharded_infer.py, the suite's longest file, instead of
ahead of it.
"""

import types
import h5py

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnet_tpu.train import loop as jax_loop
from svnet_tpu_torch.cli import flags
from svnet_tpu_torch.cli.main_cls_dgcnn import main as cls_main
from svnet_tpu_torch.cli.main_partseg_dgcnn import main as pseg_main
from svnet_tpu_torch.train import loop
from svnet_tpu_torch.train.losses import cal_loss
from svnet_tpu_torch.utils.convert import to_flax

from test_torch_knobs import K, _inputs, _weights
from test_torch_recipe import _one_torch_thread


def _write_data(root, rng, pseg: bool, n_points=48):
    from test_torch_pseg_train import _write_shapenetpart

    if pseg:
        _write_shapenetpart(root, rng, n_points)
        return
    d = root / "modelnet40_ply_hdf5_2048"
    d.mkdir(parents=True)
    for part, n in (("train", 8), ("test", 4)):
        with h5py.File(d / f"ply_data_{part}0.h5", "w") as f:
            f["data"] = rng.standard_normal((n, n_points, 3)).astype("float32")
            f["label"] = rng.integers(0, 40, (n, 1)).astype("int64")


LEGS = [["--engine-mode", "exact"], ["--engine-mode", "fast"],
        ["--engine-mode", "approx"], ["--engine-mode", "approx",
                                      "--approx-gather-bits", "8"]] + [
    ["--engine-mode", "approx"] + bits + ["--graph-reuse", reuse] + rk
    for bits, rk in (([], []), (["--approx-gather-bits", "8"], []),
                     (["--approx-gather-bits", "8"], ["--reuse-k", "RK"]))
    for reuse in ("conv2", "spatial")]


def test_fused_eval_matches_jax():
    """``--test --fused`` (exact engine, ``--rot-test aligned``) against
    JAX's ``_fused_cls_eval_step``: equal argmax, loss within 1e-5."""
    tree = _weights(False)
    args = flags.build_parser().parse_args(
        ["--binary", "--k", str(K), "--rot-test", "aligned", "--test", "x",
         "--fused"])
    points = _inputs(False)[0].astype(np.float32)
    target = np.array([3, 7])
    jt = to_flax(tree)
    want_loss, want = jax_loop._fused_cls_eval_step(
        args, types.SimpleNamespace(**jt))(
        jt["params"], jt["batch_stats"],
        {"points": jnp.asarray(points), "target": jnp.asarray(target)},
        jax.random.PRNGKey(0))
    step = loop.make_fused_eval_step(tree, args, "cls", cal_loss, "cpu")
    loss, got = step({"points": torch.from_numpy(points),
                      "target": torch.from_numpy(target)},
                     torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)


@pytest.mark.parametrize("pseg", [False, True], ids=["cls", "pseg"])
def test_recipe_through_the_cli(tmp_path, pseg):
    """The serving pick's recipe (ACCURACY.md:180-246) through the CLI at
    a tiny size, on the un-fused path ("auto" off the card): a binary
    base and an FP teacher; stage 1 ``--preload BASE --train-knobs
    --graph-reuse spatial --approx-gather-bits 8`` (the student's own
    tree, loaded whole); stage 2 ``--resume-from STAGE1 --preload FP
    --distill --kd-t 2 --kd-alpha 0.3 --no-kd-init`` with the same knobs;
    then ``--test CKPT --fused`` on every leg of
    ``tools/certify_serving.sh`` (fold 512 at partseg), each a finite
    metric; the exact leg equals the eager eval of the same weights
    without knobs."""
    main = pseg_main if pseg else cls_main
    _write_data(tmp_path / "data", np.random.default_rng(4), pseg)
    common = ["--batch-size", "4", "--num-points", "32", "--k", "4",
              "--num-workers", "1", "--bn-reestimate", "1",
              "--rot-test", "aligned", "--device", "cpu",
              "--data-dir", str(tmp_path / "data")]
    one = ["--epochs", "1"] + common
    knobs = ["--train-knobs", "--graph-reuse", "spatial",
             "--approx-gather-bits", "8"]

    def best(name):
        return str(tmp_path / name / "save_models" / "model_best.ckpt")

    def save(name):
        return ["--save-dir", str(tmp_path / name)]

    main(one + ["--binary"] + save("base"))
    main(one + save("fp"))
    main(one + ["--binary", "--preload", best("base")] + knobs + save("s1"))
    last1 = str(tmp_path / "s1" / "save_models" / "checkpoint_000.ckpt")
    main(["--epochs", "2", "--binary", "--resume-from", last1, "--preload",
          best("fp"), "--distill", "--kd-t", "2", "--kd-alpha", "0.3",
          "--no-kd-init"] + knobs + common + save("s2"))
    texts = {n: "".join(p.read_text() for p in (tmp_path / n).glob("*.txt"))
             for n in ("s1", "s2")}
    assert "preloaded weights from" in texts["s1"]
    assert "overlap merge" not in texts["s1"]
    assert "KD teacher loaded" in texts["s2"] and "EPOCH 001/002" in texts["s2"]
    ckpt = best("s2")
    fold = ["--approx-fold", "512"] if pseg else []
    metrics = []
    for leg in LEGS:
        leg = [a if a != "RK" else "2" for a in leg]
        extra = fold if "approx" in leg else []
        metrics.append(main(one + ["--binary", "--test", ckpt, "--fused"]
                            + leg + extra + save("cert")))
    assert all(np.isfinite(m) and 0.0 <= m <= 1.0 for m in metrics)
    assert metrics[0] == main(one + ["--binary", "--test", ckpt] + save("eager"))
