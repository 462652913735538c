"""The port's engine (plain versions, CPU) at B=2, N=64, k=4, 10 classes:
its rotation invariance, the modes it refuses, and both SV-DGCNN engines'
plain versions in float64 against the eager models in float64.

The engine and the eager model against the JAX engine and flax
``model.apply`` (tests/test_kernel_smoke.py's bar: rtol=1e-4, atol=1e-5)
are in tests/test_torch_engine_models.py.
"""

import numpy as np
import pytest
import torch

from svnet_tpu_torch import config, ops
from svnet_tpu_torch.infer import SVDGCNNClsEngine, SVDGCNNPsegEngine
from svnet_tpu_torch.models.sv_dgcnn import (
    SVDGCNNCls,
    SVDGCNNPseg,
    init_params,
    init_params_pseg,
)
from svnet_tpu_torch.utils.convert import load_tree


B, N, K, CLASSES = 2, 64, 4, 10
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's thread pool only competes with the other
    test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_engine_rotation_invariant():
    """SO(3) invariance through the fused path, FP model (the bar of
    tests/test_infer_engine.py)."""
    gen = torch.Generator().manual_seed(2)
    eng = SVDGCNNClsEngine(init_params(CLASSES, K, False, gen), CLASSES, K,
                           False, device="cpu")
    points = torch.randn(B, N, 3, generator=gen)
    rot = ops.random_rotations(B, gen)
    out = eng(points)
    out_r = eng(ops.rotate_points(points, rot))
    np.testing.assert_allclose(out_r.numpy(), out.numpy(), rtol=2e-2, atol=2e-3)


@pytest.mark.parametrize("mode,rounds_impl", [
    ("turbo", "round3"), ("fast", "round2"), ("fast", "round"),
    ("fast", "edge"), ("approx", "round2")])
def test_engine_rejects_other_modes(mode, rounds_impl):
    """Modes not ported on the trunk: an unknown mode anywhere; on the
    legacy trunks and the edge trunk, which take fast and approx mode, a
    knob of the mode that would not act there (C23: 8-bit gathers, a fold
    other than 256)."""
    was = (config.fast_gather_bits, config.approx_gather_bits,
           config.approx_fold)
    if rounds_impl in ("round2", "round", "edge"):
        SVDGCNNClsEngine(init_params(CLASSES, K, True), CLASSES, K, True,
                         mode=mode, device="cpu", rounds_impl=rounds_impl)
        if mode == "fast":
            config.set_fast_gather_bits(8)
        else:
            config.set_approx_fold(512)
    try:
        with pytest.raises(ValueError):
            SVDGCNNClsEngine(init_params(CLASSES, K, True), CLASSES, K, True,
                             mode=mode, device="cpu", rounds_impl=rounds_impl)
    finally:
        config.set_fast_gather_bits(was[0])
        config.set_approx_gather_bits(was[1])
        config.set_approx_fold(was[2])


@pytest.mark.parametrize("pseg", [False, True], ids=["cls", "pseg"])
def test_float64_plain_engine_matches_eager_model(pseg):
    """The binary engine's plain versions in float64 (``dtype=
    torch.float64``, exact mode) against the binary eager model in float64
    (``oracle``): logits within 1e-12, where no sign lies within rounding
    of 0 (chip_smoke.py phase 27 holds the same at full width); float64
    off the plain path is refused (the kernels take float32)."""
    width = 50 if pseg else CLASSES
    init = init_params_pseg if pseg else init_params
    w = init(width, K, True, torch.Generator().manual_seed(3))
    engine = SVDGCNNPsegEngine if pseg else SVDGCNNClsEngine
    model = (SVDGCNNPseg if pseg else SVDGCNNCls)(width, K, True, oracle=True)
    load_tree(model, w)
    gen = torch.Generator().manual_seed(4)
    args = (torch.randn(B, N, 3, generator=gen, dtype=torch.float64),)
    if pseg:
        args += (torch.eye(16, dtype=torch.float64)[[3, 11]],)
    got = engine(w, width, K, True, device="cpu", oracle=True,
                 dtype=torch.float64)(*args)
    with torch.no_grad():
        want = model.double().eval()(*args)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError):
        engine(w, width, K, True, device="cpu", dtype=torch.float64)
