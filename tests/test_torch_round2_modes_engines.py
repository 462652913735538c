"""Both SV-DGCNN engines through the legacy round2 trunk in fast and approx
mode against the JAX engines on the CPU (the Pallas kernels in interpret
mode), to the bars of tests/test_torch_round2_modes.py, whose helpers and
autouse ``_one_torch_thread`` this file imports.

At most six tests a file: pytest-xdist's ``--dist loadfile`` queues files
by their number of tests, largest first, so these long JAX references run
beside tests/test_sharded_infer.py, the suite's longest file, instead of
ahead of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnet_tpu.infer import SVDGCNNClsEngine as JaxClsEngine
from svnet_tpu.infer import SVDGCNNPsegEngine as JaxPsegEngine
from svnet_tpu_torch.infer import SVDGCNNClsEngine, SVDGCNNPsegEngine
from svnet_tpu_torch.models.sv_dgcnn import init_params, init_params_pseg
from svnet_tpu_torch.utils.convert import to_flax

from test_torch_round2_modes import (
    B,
    K_ENG,
    N_ENG,
    _one_torch_thread,
    _rand,
    _with_beta,
)


@pytest.fixture(scope="module")
def cls_weights():
    """The port's seeded binary weights, batch stats moved off 0/1 and beta
    seeded (C19)."""
    w = init_params(10, K_ENG, True, torch.Generator().manual_seed(5))
    w = dict(w, batch_stats=jax.tree.map(
        lambda x: x + 0.3 * x.abs() + 0.05, w["batch_stats"]))
    return _with_beta(w, 6)


@pytest.mark.parametrize("mode", ["fast", "approx"])
def test_cls_round2_engine_modes_match_jax(cls_weights, mode):
    """The binary classifier, round2 trunk, N = 128: two key tiles of 64 a
    round (tile=16, as the engines' T heuristic gives); top-1 equal and
    logits close; the oracle twin equals the CPU engine."""
    points = _rand(7, B, N_ENG, 3)
    jeng = JaxClsEngine(to_flax(cls_weights), num_classes=10, k=K_ENG,
                        binary=True, tile=16, mode=mode, rounds_impl="round2",
                        interpret=True)
    want = np.asarray(jeng(jnp.asarray(points)))
    kw = dict(mode=mode, device="cpu", rounds_impl="round2", tile=16)
    got = SVDGCNNClsEngine(cls_weights, 10, K_ENG, True, **kw)(
        torch.from_numpy(points))
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    oracle = SVDGCNNClsEngine(cls_weights, 10, K_ENG, True, oracle=True, **kw)
    assert torch.equal(oracle(torch.from_numpy(points)), got)


@pytest.fixture(scope="module")
def pseg_approx():
    """The FP part segmenter at N = 512 and the JAX engine's round2 approx
    logits on one request: each round folds 512 to 256 lanes on key tiles
    of 256."""
    weights = init_params_pseg(50, 4, False, torch.Generator().manual_seed(1))
    points = _rand(2, 1, 512, 3)
    label = np.eye(16, dtype=np.float32)[[3]]
    jeng = JaxPsegEngine(to_flax(weights), num_part=50, k=4, binary=False,
                         mode="approx", rounds_impl="round2", interpret=True)
    want = np.asarray(jeng(jnp.asarray(points), jnp.asarray(label)))
    return weights, points, label, want


@pytest.mark.parametrize("impl", ["round2", "edge"])
def test_pseg_round2_engine_approx_matches_jax(pseg_approx, impl):
    """The part segmenter asked for round2, and for "edge", which runs
    round2 as JAX's does, in approx mode: per-point top-1 equal to the JAX
    engine's round2, logits close."""
    weights, points, label, want = pseg_approx
    eng = SVDGCNNPsegEngine(weights, 50, 4, False, mode="approx",
                            device="cpu", rounds_impl=impl)
    assert eng.trunk == "round2"
    got = eng(torch.from_numpy(points), torch.from_numpy(label)).numpy()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_pseg_round2_engine_fast_matches_jax():
    """The FP part segmenter, round2 trunk, fast mode at N = 128."""
    weights = init_params_pseg(50, K_ENG, False, torch.Generator().manual_seed(2))
    points = _rand(3, B, N_ENG, 3)
    label = np.eye(16, dtype=np.float32)[[1, 9]]
    jeng = JaxPsegEngine(to_flax(weights), num_part=50, k=K_ENG, binary=False,
                         mode="fast", rounds_impl="round2", interpret=True)
    want = np.asarray(jeng(jnp.asarray(points), jnp.asarray(label)))
    got = SVDGCNNPsegEngine(weights, 50, K_ENG, False, mode="fast",
                            device="cpu", rounds_impl="round2")(
        torch.from_numpy(points), torch.from_numpy(label)).numpy()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
