"""The SV-DGCNN and SV-PointNet classification engines in fast mode against
the JAX engines on the CPU (the Pallas kernels in interpret mode), to the
bars of tests/test_torch_fast.py, whose helpers and autouse
``_one_torch_thread`` this file imports.

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
from svnet_tpu.infer import SVDGCNNClsEngine as JaxDGCNNEngine
from svnet_tpu.infer import SVPointNetClsEngine as JaxPointNetEngine
from svnet_tpu_torch.infer import SVDGCNNClsEngine, SVPointNetClsEngine
from svnet_tpu_torch.models import sv_pointnet
from svnet_tpu_torch.utils.convert import from_flax, to_flax

from test_torch_train import compile_once
from test_torch_fast import (
    B,
    K_ENG,
    N_ENG,
    _gather_bits,
    _one_torch_thread,
    _rand,
    _with_beta,
    bits,
)


def _pointnet_engine_case(binary):
    weights = sv_pointnet.init_params(10, K_ENG, binary,
                                      torch.Generator().manual_seed(1))
    points = _rand(8, B, N_ENG, 3)
    jeng = JaxPointNetEngine(to_flax(weights), num_classes=10, k=K_ENG,
                             binary=binary, mode="fast", interpret=True)
    want = np.asarray(jeng(jnp.asarray(points)))
    got = SVPointNetClsEngine(weights, 10, K_ENG, binary, mode="fast",
                              device="cpu")(torch.from_numpy(points))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_dgcnn_cls_engine_fast_matches_jax():
    """The binary classifier at 16-bit gathers (the JAX engine's jit is
    the file's largest cost; 8 bits are held round by round above)."""
    model = models.SV_DGCNN_CLS(num_classes=10, k=K_ENG, binary=True)
    points = _rand(7, B, N_ENG, 3)
    # one compile of init instead of its eager ops (bitwise the same tree)
    init_args = (jax.random.PRNGKey(1), jnp.asarray(points))
    var = compile_once(model.init, *init_args)(*init_args)
    weights = _with_beta(from_flax(jax.tree.map(np.asarray, {
        "params": var["params"], "batch_stats": jax.tree.map(
            lambda x: x + 0.3 * jnp.abs(x) + 0.05, var["batch_stats"])})), 6)
    jeng = JaxDGCNNEngine(to_flax(weights), num_classes=10, k=K_ENG,
                          binary=True, mode="fast", interpret=True)
    want = np.asarray(jeng(jnp.asarray(points)))
    eng = SVDGCNNClsEngine(weights, 10, K_ENG, True, mode="fast", device="cpu")
    got = eng(torch.from_numpy(points))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    oracle = SVDGCNNClsEngine(weights, 10, K_ENG, True, mode="fast",
                              device="cpu", oracle=True)
    assert torch.equal(oracle(torch.from_numpy(points)), got)


@pytest.mark.parametrize("bits,binary", [(16, False), (8, True)],
                         ids=["gb16-fp", "gb8-binary"])
def test_pointnet_cls_engine_fast_matches_jax(bits, binary):
    with _gather_bits(bits):
        _pointnet_engine_case(binary)
