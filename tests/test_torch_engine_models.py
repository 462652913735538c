"""The port's engine (plain versions) and eager model against the JAX
engine and flax ``model.apply`` on the CPU, and the engine against the
eager model, to the bars of tests/test_torch_engine.py, whose helpers and
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

from svnet_tpu import models
from svnet_tpu.infer import SVDGCNNClsEngine as JaxEngine
from svnet_tpu_torch.infer import SVDGCNNClsEngine
from svnet_tpu_torch.models.sv_dgcnn import SVDGCNNCls
from svnet_tpu_torch.utils.convert import from_flax

from test_torch_train import compile_once
from test_torch_engine import ATOL, B, CLASSES, K, N, RTOL, _one_torch_thread


@pytest.fixture(scope="module", params=[False, True], ids=["fp", "binary"])
def setup(request):
    binary = request.param
    model = models.SV_DGCNN_CLS(num_classes=CLASSES, k=K, binary=binary)
    points = np.random.default_rng(0).standard_normal((B, N, 3)).astype(np.float32)
    # one compile of init instead of its eager ops (bitwise the same tree)
    init_args = (jax.random.PRNGKey(1), jnp.asarray(points))
    var = compile_once(model.init, *init_args)(*init_args)
    var = {"params": var["params"], "batch_stats": jax.tree.map(
        lambda x: x + 0.3 * jnp.abs(x) + 0.05, var["batch_stats"])}
    want = np.asarray(jax.jit(model.apply, static_argnums=2)(
        var, jnp.asarray(points), False))
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
