"""The classifier's round-1 trunk against the JAX engine's on the CPU (the
Pallas kernels in interpret mode), to the bars of
tests/test_torch_round1.py, whose helpers and autouse ``_one_torch_thread``
this file imports.

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

from test_torch_round1 import ATOL, B, CLASSES, K, N, RTOL, _one_torch_thread, _rand


@pytest.fixture(scope="module", params=[False, True], ids=["fp", "binary"])
def cls_setup(request):
    """The port's seeded weights as a flax tree for the JAX engine, and
    back through ``from_flax`` for the port's (flax's own init costs
    seconds of compile here)."""
    binary = request.param
    var = to_flax(init_params(CLASSES, K, binary,
                              torch.Generator().manual_seed(3)))
    return binary, var, from_flax(var)


def test_cls_round_engine_matches_jax_engine(cls_setup):
    """The port's round trunk (B10a x4, B3r) against the JAX engine's
    (sv_round_first, sv_round x3, sv_point_block in interpret mode); the
    oracle twin equals the CPU engine."""
    binary, var, weights = cls_setup
    points = _rand(1, B, N, 3)
    jeng = JaxClsEngine(var, num_classes=CLASSES, k=K, binary=binary,
                        tile=16, exact=True, rounds_impl="round",
                        interpret=True)
    want = np.asarray(jeng(jnp.asarray(points)))
    eng = SVDGCNNClsEngine(weights, CLASSES, K, binary, device="cpu",
                           rounds_impl="round")
    x = torch.from_numpy(points)
    got = eng(x)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    oracle = SVDGCNNClsEngine(weights, CLASSES, K, binary, device="cpu",
                              rounds_impl="round", oracle=True)
    assert torch.equal(oracle(x), got)
