"""The eager SV-PointNet part segmenter against flax ``model.apply`` and
its engine against the JAX engine on the CPU, to the bars of
tests/test_torch_pointnet.py, whose helpers and autouse
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
from svnet_tpu.infer import SVPointNetPsegEngine as JaxPsegEngine
from svnet_tpu_torch.infer import SVPointNetPsegEngine
from svnet_tpu_torch.models.sv_pointnet import SVPointNetPseg, init_params_pseg
from svnet_tpu_torch.utils.convert import to_flax

from test_torch_pointnet import (
    B,
    K,
    N,
    PARTS,
    RTOL,
    _flip_tolerant,
    _one_torch_thread,
    _rand,
)


def _labels():
    return np.eye(16, dtype=np.float32)[np.arange(B) % 16]


@pytest.fixture(scope="module", params=[False, True], ids=["fp", "binary"])
def pseg_setup(request):
    binary = request.param
    weights = init_params_pseg(PARTS, K, binary, torch.Generator().manual_seed(1))
    var = to_flax(weights)
    points, label = _rand(0, B, N, 3), _labels()
    model = models.SV_PointNet_PSEG(num_part=PARTS, k=K, binary=binary)
    want = np.asarray(jax.jit(model.apply)(var, jnp.asarray(points),
                                           jnp.asarray(label)))
    jeng = JaxPsegEngine(var, num_part=PARTS, k=K, binary=binary, exact=True,
                         interpret=True)
    return (binary, weights, points, label, want,
            np.asarray(jeng(jnp.asarray(points), jnp.asarray(label))))


def test_eager_pseg_matches_flax(pseg_setup):
    binary, weights, points, label, want, _ = pseg_setup
    model = SVPointNetPseg.from_tree(weights, PARTS, K, binary)
    with torch.no_grad():
        got = model(torch.from_numpy(points), torch.from_numpy(label)).numpy()
    if binary:
        _flip_tolerant(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-4)


def test_pseg_engine_matches_jax_engine(pseg_setup):
    """FP within 1e-4; binary to the flip-tolerant bar (``_flip_tolerant``):
    sign flips cascade through the binary blocks at random init."""
    binary, weights, points, label, _, want = pseg_setup
    eng = SVPointNetPsegEngine(weights, PARTS, K, binary, device="cpu")
    got = eng(torch.from_numpy(points), torch.from_numpy(label)).numpy()
    assert got.shape == (B, N, PARTS)
    if binary:
        _flip_tolerant(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-4)
