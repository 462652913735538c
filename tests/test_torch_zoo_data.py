"""ScanObjectNN, ModelNet40_v2, the flags of the VN and original models
and the loss choice of ``--model original`` (ROADMAP C26), against the
JAX package (CPU).

The datasets' items are bitwise JAX's at a seed (the same numpy draws in
the same order; ModelNet40_v2's farthest-point sampling through
``ops/sampling.py`` on the CPU, JAX's through its own), on files written
to ``tmp_path``.
"""

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnet_tpu.data import datasets as jdata
from svnet_tpu.models import DGCNN_CLS
from svnet_tpu.train.loop import _pick_loss
from svnet_tpu_torch.cli import flags
from svnet_tpu_torch.data import (
    ModelNet40_v2,
    ScanArrayDataset,
    ScanObjectNNCls,
)
from svnet_tpu_torch.data.datasets import SCANOBJECTNN_FILES, pc_normalize
from svnet_tpu_torch.models import DGCNNCls, get_model
from svnet_tpu_torch.train.losses import model_loss
from svnet_tpu_torch.utils.convert import module_tree, to_flax


def _write_scanobjectnn(root, rng, n_points=64):
    d = root / "h5_files" / "main_split"
    d.mkdir(parents=True)
    for name in SCANOBJECTNN_FILES.values():
        with h5py.File(d / name, "w") as f:
            f["data"] = rng.standard_normal((6, n_points, 3)).astype("float32")
            f["label"] = rng.integers(0, 15, (6,)).astype("int64")


@pytest.mark.parametrize("subset", ["easy", "hard"])
def test_scanobjectnn_items_match_jax(tmp_path, subset):
    """Train and test items (points, label) bitwise JAX's at a seed, item
    after item (each draw advances the generator), from each subset's
    files; ``ScanArrayDataset`` on the same arrays gives the same items;
    an unknown subset raises."""
    _write_scanobjectnn(tmp_path, np.random.default_rng(1))
    for part in ("train", "test"):
        got = ScanObjectNNCls(32, str(tmp_path), part, subset, seed=5)
        want = jdata.ScanObjectNNCls(32, str(tmp_path), part, subset, seed=5)
        arr = ScanArrayDataset(want.points, want.labels, 32, part == "train", seed=5)
        assert len(got) == len(want) == 6 and got.num_classes == 15
        for i in (0, 3, 3, 5):
            (gp, gl), (wp, wl), (ap, al) = got[i], want[i], arr[i]
            assert gp.dtype == np.float32 and gp.shape == (32, 3)
            np.testing.assert_array_equal(gp, wp)
            np.testing.assert_array_equal(ap, wp)
            assert gl == wl == al
    with pytest.raises(ValueError):
        ScanObjectNNCls(32, str(tmp_path), "val", subset)


def test_modelnet40_v2_matches_jax(tmp_path):
    """Raw text clouds: ``pc_normalize`` as JAX's; items with ``uniform``
    off (the first points) and on (farthest-point sampling), with and
    without the normals, bitwise JAX's; the cache returns the same item."""
    rng = np.random.default_rng(2)
    names = ["airplane", "bathtub", "bed"]
    (tmp_path / "modelnet40_shape_names.txt").write_text("\n".join(names) + "\n")
    ids = {"train": ["airplane_0001", "bed_0002", "bathtub_0003"],
           "test": ["bed_0004"]}
    for part, part_ids in ids.items():
        (tmp_path / f"modelnet40_{part}.txt").write_text("\n".join(part_ids) + "\n")
        for i in part_ids:
            d = tmp_path / "_".join(i.split("_")[:-1])
            d.mkdir(exist_ok=True)
            np.savetxt(d / f"{i}.txt", rng.standard_normal((200, 6)), delimiter=",",
                       fmt="%.6f")
    pc = rng.standard_normal((50, 3)).astype(np.float32)
    np.testing.assert_array_equal(pc_normalize(pc), jdata.pc_normalize(pc))
    for uniform in (False, True):
        for normal in (False, True):
            got = ModelNet40_v2(str(tmp_path), 64, "train", uniform, normal,
                                device="cpu")
            want = jdata.ModelNet40_v2(str(tmp_path), 64, "train", uniform, normal)
            assert len(got) == len(want) == 3
            for i in range(3):
                (gp, gl), (wp, wl) = got[i], want[i]
                assert gp.shape == (64, 6 if normal else 3) and gl == wl
                np.testing.assert_array_equal(gp, wp)
                assert got[i][0] is gp  # the cache
    assert len(ModelNet40_v2(str(tmp_path), 64, "test", device="cpu")) == 1


def test_zoo_flags():
    """``--model vn|original`` on both backbones and both tasks and
    ``--dataset scanobjectnn`` (with ``--subset``) are ported;
    ``--model bipointnet`` on the PointNet backbone builds (``get_model``:
    the exported LSR ema-max classes) and passes ``check_ported``, and
    ``get_model`` raises ValueError for it on DGCNN, as JAX's does; C24:
    ``--pooling max`` off VN, ``--subset`` off ScanObjectNN, ``--fused``
    off the SV models and ``--binary`` on BiPointNet raise ValueError."""
    for task in ("cls", "partseg"):
        for backbone in ("pointnet", "dgcnn"):
            parser = flags.build_parser(task, backbone)
            for model in ("vn", "original"):
                flags.check_ported(parser.parse_args(["--model", model]))
            flags.check_ported(parser.parse_args(["--model", "vn", "--pooling",
                                                  "max"]))
            for argv in (["--pooling", "max"], ["--model", "original", "--pooling",
                                                "max"], ["--subset", "easy"],
                         ["--model", "vn", "--test", "x", "--fused"]):
                with pytest.raises(ValueError):
                    flags.check_ported(parser.parse_args(argv))
    parser = flags.build_parser("cls", "dgcnn")
    args = parser.parse_args(["--dataset", "scanobjectnn"])
    assert args.subset is None  # hard unless given (loop.cls_datasets)
    flags.check_ported(args)
    flags.check_ported(parser.parse_args(["--dataset", "scanobjectnn", "--subset",
                                          "easy"]))
    for task in ("cls", "partseg"):
        parser = flags.build_parser(task, "pointnet")
        flags.check_ported(parser.parse_args(["--model", "bipointnet"]))
        for argv in (["--binary"], ["--pooling", "max"], ["--test", "x", "--fused"]):
            with pytest.raises(ValueError):
                flags.check_ported(parser.parse_args(["--model", "bipointnet", *argv]))
        width = {"cls": {"num_classes": 40}, "partseg": {"num_part": 50}}[task]
        model = get_model(task, "pointnet", "bipointnet", k=4, **width)
        assert model.config == {**width, "k": 4, "linear": "BiLinearLSR",
                                "pool": "ema-max", "affine": True}
        with pytest.raises(ValueError):
            get_model(task, "dgcnn", "bipointnet")
    with pytest.raises(ValueError):
        get_model("cls", "dgcnn", "bipointnet_x")


def test_original_dgcnn_loss_choice():
    """C26: JAX's ``_pick_loss("original")`` is ``cal_pointnet_loss``,
    which unpacks (logits, trans_feat); DGCNN_CLS returns plain logits, so
    the JAX trainer's first step with ``--model original --backbone
    dgcnn`` raises. The port's ``model_loss`` takes ``cal_loss`` on those
    logits and the T-Net loss only on a pair."""
    port = DGCNNCls(40, 4, torch.Generator().manual_seed(0))
    pts = np.random.default_rng(3).standard_normal((4, 16, 3)).astype(np.float32)
    logits = DGCNN_CLS(num_classes=40, k=4).apply(to_flax(module_tree(port)),
                                                  jnp.asarray(pts), False)
    target = jnp.asarray([1, 2, 3, 4])
    with pytest.raises(ValueError):  # too many values to unpack
        _pick_loss("original")(logits, target)
    with pytest.raises(IndexError):
        _pick_loss("original")(logits[:2], target[:2])
    got = model_loss(torch.from_numpy(np.array(logits)), torch.tensor([1, 2, 3, 4]))
    assert torch.isfinite(got)
    assert get_model("cls", "pointnet", "original", k=4)(torch.from_numpy(pts))[1] \
        .shape == (4, 64, 64)



def test_shape_clouds_match_the_learning_test():
    """``utils.synth.shape_clouds`` (chip_smoke.py's learning check) draws
    the clouds and labels of tests/test_learning.py's ``_clouds``."""
    from svnet_tpu_torch.utils.synth import shape_clouds
    from test_learning import N as LEARNING_N
    from test_learning import _clouds

    got = shape_clouds(np.random.default_rng(0), 5, LEARNING_N)
    want = _clouds(np.random.default_rng(0), 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
