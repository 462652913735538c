"""The port's engine (plain versions, CPU) and eager model against the JAX
engine and flax ``model.apply`` at B=2, N=64, k=4, 10 classes.

The bar is tests/test_kernel_smoke.py's: rtol=1e-4, atol=1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnet_tpu import models
from svnet_tpu.infer import SVDGCNNClsEngine as JaxEngine
from svnet_tpu_torch import ops
from svnet_tpu_torch.infer import SVDGCNNClsEngine
from svnet_tpu_torch.models.sv_dgcnn import SVDGCNNCls, init_params
from svnet_tpu_torch.utils.convert import from_flax

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


@pytest.fixture(scope="module", params=[False, True], ids=["fp", "binary"])
def setup(request):
    binary = request.param
    model = models.SV_DGCNN_CLS(num_classes=CLASSES, k=K, binary=binary)
    points = np.random.default_rng(0).standard_normal((B, N, 3)).astype(np.float32)
    var = model.init(jax.random.PRNGKey(1), jnp.asarray(points))
    var = {"params": var["params"], "batch_stats": jax.tree.map(
        lambda x: x + 0.3 * jnp.abs(x) + 0.05, var["batch_stats"])}
    want = np.asarray(model.apply(var, jnp.asarray(points), False))
    weights = from_flax(jax.tree.map(np.asarray, var))
    return binary, points, var, weights, want


def test_engine_matches_jax_engine(setup):
    binary, points, var, weights, _ = setup
    jeng = JaxEngine(var, num_classes=CLASSES, k=K, binary=binary,
                     knn_impl="xla", exact=True, interpret=True)
    want = np.asarray(jeng(jnp.asarray(points)))
    got = SVDGCNNClsEngine(weights, CLASSES, K, binary, device="cpu")(
        torch.from_numpy(points))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_eager_model_matches_flax(setup):
    binary, points, _, weights, want = setup
    model = SVDGCNNCls.from_tree(weights, CLASSES, K, binary)
    with torch.no_grad():
        got = model(torch.from_numpy(points))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_engine_matches_eager_model(setup):
    """The fused path (folds, j-major layouts, head_perm) and the un-fused
    oracle agree on the model's own output."""
    binary, points, _, weights, want = setup
    got = SVDGCNNClsEngine(weights, CLASSES, K, binary, device="cpu")(
        torch.from_numpy(points))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    oracle = SVDGCNNClsEngine(weights, CLASSES, K, binary, device="cpu",
                              oracle=True)
    assert torch.equal(oracle(torch.from_numpy(points)), got)


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


def test_engine_rejects_other_modes():
    with pytest.raises(ValueError):
        SVDGCNNClsEngine(init_params(CLASSES, K, True), CLASSES, K, True,
                         mode="fast", device="cpu")
