"""The CLIs with ``--model vn|original`` on both backbones and both tasks,
and ``--dataset scanobjectnn``, end to end on the CPU (``--device cpu``)
on tiny HDF5 files: one epoch of train steps, eval through the eager
model, the checkpoint, the EPOCH line; the head's width from the dataset.
"""

import h5py
import numpy as np
import pytest
import torch

from svnet_tpu_torch import config
from svnet_tpu_torch.cli.main_cls_dgcnn import main as cls_dgcnn
from svnet_tpu_torch.cli.main_cls_pointnet import main as cls_pointnet
from svnet_tpu_torch.cli.main_partseg_dgcnn import main as pseg_dgcnn
from svnet_tpu_torch.cli.main_partseg_pointnet import main as pseg_pointnet
from svnet_tpu_torch.utils.convert import flatten

from test_torch_pseg_train import _write_shapenetpart
from test_torch_zoo_cls import _one_torch_thread  # noqa: F401
from test_torch_zoo_data import _write_scanobjectnn

MAINS = {("cls", "dgcnn"): cls_dgcnn, ("cls", "pointnet"): cls_pointnet,
         ("partseg", "dgcnn"): pseg_dgcnn, ("partseg", "pointnet"): pseg_pointnet}


def _write_modelnet40(root, rng):
    d = root / "modelnet40_ply_hdf5_2048"
    d.mkdir(parents=True)
    for part, n in (("train", 8), ("test", 4)):
        with h5py.File(d / f"ply_data_{part}0.h5", "w") as f:
            f["data"] = rng.standard_normal((n, 48, 3)).astype("float32")
            f["label"] = rng.integers(0, 40, (n, 1)).astype("int64")


def _common(data, save, extra=()):
    return ["--epochs", "1", "--batch-size", "4", "--num-points", "32", "--k", "4",
            "--num-workers", "1", "--rot-test", "aligned", "--device", "cpu",
            "--data-dir", str(data), "--save-dir", str(save), *extra]


def _head(save):
    """The checkpoint's last linear: (in, out)."""
    ckpt = torch.load(save / "save_models" / "model_best.ckpt", map_location="cpu",
                      weights_only=False)
    kernels = {p: v for p, v in flatten(ckpt["params"]).items() if p.endswith("kernel")}
    last = [p for p in kernels if p.split(".")[0] in ("fc3", "linear3", "convs4",
                                                      "conv11")]
    assert len(last) == 1, last
    return tuple(kernels[last[0]].shape)


@pytest.mark.parametrize("task,backbone", list(MAINS))
def test_zoo_cli_trains_and_evaluates(tmp_path, task, backbone):
    """``--model vn`` (``--pooling max`` on one backbone) and ``--model
    original`` through the CLI for one epoch: a finite loss, the EPOCH
    line, a checkpoint whose head has 40 classes or 50 parts, and
    ``--test`` on it giving the same metric."""
    data = tmp_path / "data"
    if task == "cls":
        _write_modelnet40(data, np.random.default_rng(4))
    else:
        _write_shapenetpart(data, np.random.default_rng(6))
    main = MAINS[(task, backbone)]
    for model, extra in (("vn", ("--pooling", "max") if backbone == "dgcnn" else ()),
                         ("original", ())):
        save = tmp_path / f"results_{model}"
        common = _common(data, save, ("--model", model, *extra))
        metric = main(common)
        assert 0.0 <= metric <= 1.0
        assert "EPOCH 000/001 | Test: loss" in (save / f"{task}-log.txt").read_text()
        assert _head(save)[1] == (40 if task == "cls" else 50)
        best = str(save / "save_models" / "model_best.ckpt")
        assert main(common + ["--test", best]) == metric


def test_scanobjectnn_cli_trains_a_15_class_head(tmp_path):
    """``--dataset scanobjectnn`` (subset hard by default) trains a
    15-class head: ``--model original --backbone dgcnn`` (C26: plain
    logits, ``cal_loss``) and binary SV-DGCNN through the fused train
    forward (``config.fused_train`` "on"), whose eval engine width and
    eager model take the dataset's count."""
    _write_scanobjectnn(tmp_path / "data", np.random.default_rng(7))
    was = config.fused_train
    config.set_fused_train("on")
    try:
        for extra in (("--model", "original"), ("--binary", "--bn-reestimate", "1")):
            save = tmp_path / f"results_{extra[1]}"
            metric = cls_dgcnn(_common(tmp_path / "data", save,
                                       ("--dataset", "scanobjectnn", *extra)))
            assert 0.0 <= metric <= 1.0
            assert _head(save)[1] == 15
    finally:
        config.set_fused_train(was)
