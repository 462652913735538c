"""The classifier's edge trunk against the JAX engine's on the CPU (the
Pallas kernels in interpret mode), to the bars of tests/test_torch_edge.py,
whose helpers and autouse ``_one_torch_thread`` this file imports.

At most six tests a file: pytest-xdist's ``--dist loadfile`` queues files
by their number of tests, largest first, so these long JAX references run
beside tests/test_sharded_infer.py, the suite's longest file, instead of
ahead of it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnet_tpu.infer import SVDGCNNClsEngine as JaxClsEngine
from svnet_tpu_torch.infer import SVDGCNNClsEngine
from svnet_tpu_torch.models.sv_dgcnn import init_params
from svnet_tpu_torch.utils.convert import from_flax, to_flax

from test_torch_edge import ATOL, B, CLASSES, K, N, RTOL, _one_torch_thread, _rand


@pytest.mark.parametrize("binary", [False, True], ids=["fp", "binary"])
def test_cls_edge_engine_matches_jax_engine(binary):
    """The port's edge trunk (kNN x4, B10d, svblock_gate and B10c x3, B3r)
    against the JAX engine's (knn_impl="xla", the Pallas kernels in
    interpret mode), on the port's seeded weights crossed over as a flax
    tree; the oracle twin equals the CPU engine."""
    var = to_flax(init_params(CLASSES, K, binary,
                              torch.Generator().manual_seed(4)))
    points = _rand(2, B, N, 3)
    jeng = JaxClsEngine(var, num_classes=CLASSES, k=K, binary=binary,
                        tile=16, knn_impl="xla", exact=True,
                        rounds_impl="edge", interpret=True)
    want = np.asarray(jeng(jnp.asarray(points)))
    weights = from_flax(var)
    x = torch.from_numpy(points)
    got = SVDGCNNClsEngine(weights, CLASSES, K, binary, device="cpu",
                           rounds_impl="edge")(x)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    oracle = SVDGCNNClsEngine(weights, CLASSES, K, binary, device="cpu",
                              rounds_impl="edge", oracle=True)
    assert torch.equal(oracle(x), got)
