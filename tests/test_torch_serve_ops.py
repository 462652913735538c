"""The serving kernels' ``svnet::`` op registrations, the SV-PointNet part
segmenter's artifact, and the certification CLI
(svnet_tpu_torch/cli/certify_serving.py), on the CPU. The helpers are
tests/test_torch_serve.py's."""

import pytest
import torch

from svnet_tpu_torch.models import sv_dgcnn
from svnet_tpu_torch.ops.kernels import library

from test_torch_serve import (OTHER_CASES, _gen, _one_torch_thread,  # noqa: F401
                              check_artifact)
from test_torch_serve_trunks import TRUNK_CASES


@pytest.mark.parametrize("case", [c for c in OTHER_CASES
                                  if c not in TRUNK_CASES])
def test_artifact_equals_live_engine(case):
    """The engine's artifact equals its live engine (``check_artifact``)."""
    check_artifact(*OTHER_CASES[case])


def test_every_serving_wrapper_is_an_op_on_both_devices():
    """One svnet:: op for each wrapper a serving engine calls, each with a
    CPU and a CUDA implementation and a fake one."""
    names = ["sv_round3_first", "sv_round3", "sv_round3_reuse",
             "sv_point_block_cm", "sv_point_block", "sv_block_point",
             "sv_round2_first", "sv_round2", "sv_round_first", "sv_round",
             "sv_edge_first_block", "sv_edge_block", "knn"]
    for name in names:
        op = f"{library.NS}::{name}"
        for key in ("CPU", "CUDA", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(op, key), \
                (op, key)


def test_certify_serving_runs_every_leg(tmp_path, capsys):
    """python -m svnet_tpu_torch.cli.certify_serving: the ten legs of
    tools/certify_serving.sh through the classification CLI on a port
    checkpoint, each printing its test line; a missing checkpoint exits 2,
    a failing leg 1."""
    import h5py
    import numpy as np

    from svnet_tpu_torch.cli.certify_serving import CERT_LEGS, main

    rng = np.random.default_rng(4)
    root = tmp_path / "data" / "modelnet40_ply_hdf5_2048"
    root.mkdir(parents=True)
    for part, n in (("train", 4), ("test", 4)):
        with h5py.File(root / f"ply_data_{part}0.h5", "w") as f:
            f["data"] = rng.standard_normal((n, 64, 3)).astype("float32")
            f["label"] = rng.integers(0, 40, (n, 1)).astype("int64")
    ckpt = tmp_path / "model_best.ckpt"
    torch.save({"epoch": 0, **sv_dgcnn.init_params(40, 4, True, _gen()),
                "best_metric": 0.0}, ckpt)
    argv = ["cls", str(ckpt), str(tmp_path / "data"), "--k", "4",
            "--save-dir", str(tmp_path / "res"), "--device", "cpu",
            "--num-points", "64", "--batch-size", "4", "--num-workers", "1",
            "--rot-test", "aligned"]
    assert main(argv) == 0
    out = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("=== ") for line in out) == len(CERT_LEGS) == 10
    assert "=== --engine-mode approx --approx-gather-bits 8 --graph-reuse " \
           "spatial --reuse-k 2" in out
    assert sum(line.startswith("TEST: loss") for line in out) == 10
    assert main(["cls", str(tmp_path / "none.ckpt"), "d"]) == 2
    assert main(argv[:3] + ["--k", "100"] + argv[5:]) == 1
