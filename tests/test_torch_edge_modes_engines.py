"""The classifier's edge trunk in fast and approx mode against the JAX
engine on the CPU (the Pallas kernels in interpret mode), to the bars of
tests/test_torch_edge_modes.py, whose helpers and autouse
``_one_torch_thread`` this file imports.

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
from svnet_tpu_torch.utils.convert import from_flax, to_flax

from test_torch_edge_modes import (
    ATOL,
    B,
    CLASSES,
    K,
    N,
    RTOL,
    _one_torch_thread,
    _rand,
    _weights,
)


@pytest.mark.parametrize("mode", ["fast", "approx"])
@pytest.mark.parametrize("binary", [False, True], ids=["fp", "binary"])
def test_cls_edge_engine_modes_match_jax(binary, mode):
    """The edge trunk in fast and approx mode (exact kNN x4, B10d and
    B10c with exact=False, B3r) against the JAX engine's (knn_impl="xla",
    the Pallas kernels in interpret mode, tile 16); approx is fast
    bitwise; the oracle twin equals the CPU engine."""
    weights = _weights(binary, seed=5)
    points = _rand(2, B, N, 3)
    jeng = JaxClsEngine(to_flax(weights), num_classes=CLASSES, k=K,
                        binary=binary, tile=16, knn_impl="xla", mode=mode,
                        rounds_impl="edge", interpret=True)
    want = np.asarray(jeng(jnp.asarray(points)))
    w = from_flax(to_flax(weights))
    x = torch.from_numpy(points)
    kw = dict(device="cpu", rounds_impl="edge")
    got = SVDGCNNClsEngine(w, CLASSES, K, binary, mode=mode, **kw)(x)
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    other = "fast" if mode == "approx" else "approx"
    assert torch.equal(SVDGCNNClsEngine(w, CLASSES, K, binary, mode=other,
                                        **kw)(x), got)
    oracle = SVDGCNNClsEngine(w, CLASSES, K, binary, mode=mode, oracle=True, **kw)
    assert torch.equal(oracle(x), got)
