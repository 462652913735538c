"""--profile-dir and --debug-nans in the port's trainers
(svnet_tpu_torch/train/loop.py), on the CPU: the profiler's trace written
by the classification trainer (the original PointNet at N = 64, as
tests/test_profile_flag.py runs JAX's), a NaN in a train batch raising
``FloatingPointError`` (as ``jax_debug_nans`` does) while the same run
without the flag does not. The flags' refusals where JAX's loop does not
read them (ROADMAP C24) are tests/test_torch_flag_refusals.py."""

import json

import numpy as np
import pytest

from svnet_tpu_torch.cli import flags
from svnet_tpu_torch.data import ArrayDataset, PartArrayDataset
from svnet_tpu_torch.train.loop import run_cls, run_partseg

from test_torch_serve import _one_torch_thread  # noqa: F401


def _args(tmp_path, *extra, task="cls"):
    argv = ["--model", "original", "--epochs", "1", "--num-points", "64",
            "--batch-size", "8", "--k", "8", "--rot", "aligned",
            "--rot-test", "aligned", "--bn-reestimate", "0",
            "--num-workers", "1", "--device", "cpu",
            "--save-dir", str(tmp_path / "res"), *extra]
    return flags.build_parser(task, "pointnet").parse_args(argv)


def _cls_sets(nan: bool = False):
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((40, 64, 3)).astype(np.float32)
    if nan:
        pts[5, 3, 1] = np.nan
    labels = rng.integers(0, 40, 40)
    return (ArrayDataset(pts[:32], labels[:32], train=True),
            ArrayDataset(pts[32:], labels[32:]))


def test_profile_dir_writes_a_trace(tmp_path):
    """Step index 2 of the first epoch runs under torch.profiler and its
    Chrome trace lands in the directory; the run still trains."""
    prof = tmp_path / "trace"
    acc = run_cls(_args(tmp_path, "--profile-dir", str(prof)), _cls_sets())
    assert 0.0 <= acc <= 1.0
    trace = prof / "train_step.json"
    assert json.loads(trace.read_text())["traceEvents"]
    log = next((tmp_path / "res").glob("cls-2*.txt")).read_text()
    assert f"profiler trace written to {prof}" in log


def test_debug_nans_raises_on_a_nan_batch(tmp_path):
    """A NaN in a train batch: FloatingPointError naming the leaf with
    --debug-nans; without it the run ends."""
    with pytest.raises(FloatingPointError, match="--debug-nans: NaN in loss"):
        run_cls(_args(tmp_path, "--debug-nans"), _cls_sets(nan=True))
    run_cls(_args(tmp_path), _cls_sets(nan=True))


def test_debug_nans_passes_a_clean_partseg_run(tmp_path):
    """--debug-nans on the part-segmentation trainer: finite steps pass."""
    rng = np.random.default_rng(1)
    pts = rng.standard_normal((24, 64, 3)).astype(np.float32)
    cls = rng.integers(0, 16, 24)
    seg = rng.integers(0, 50, (24, 64))
    sets = (PartArrayDataset(pts[:16], cls[:16], seg[:16], shuffle=True),
            PartArrayDataset(pts[16:], cls[16:], seg[16:]))
    iou = run_partseg(_args(tmp_path, "--debug-nans", task="partseg"), sets)
    assert 0.0 <= iou <= 1.0
