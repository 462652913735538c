"""The classifier's round-1 trunk in fast and approx mode against the JAX
engine on the CPU (the Pallas kernels in interpret mode), to the bars of
tests/test_torch_round1_modes.py, whose helpers and autouse
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

from svnet_tpu.infer import SVDGCNNClsEngine as JaxClsEngine
from svnet_tpu_torch.infer import SVDGCNNClsEngine
from svnet_tpu_torch.models.sv_dgcnn import init_params
from svnet_tpu_torch.utils.convert import to_flax

from test_torch_round2_modes import _with_beta
from test_torch_round1_modes import B, CLASSES, _one_torch_thread, _rand


@pytest.fixture(scope="module")
def cls_weights():
    """The port's seeded binary weights, batch stats moved off 0/1 and beta
    seeded."""
    w = init_params(CLASSES, 4, True, torch.Generator().manual_seed(6))
    w = dict(w, batch_stats=jax.tree.map(
        lambda x: x + 0.3 * x.abs() + 0.05, w["batch_stats"]))
    return _with_beta(w, 7)


@pytest.mark.parametrize("mode", ["fast", "approx"])
def test_cls_round_engine_modes_match_jax(cls_weights, mode):
    """The binary classifier's round trunk at N = 128 (key tiles of 64,
    tile=16): JAX passes ``exact=False`` in both modes, so approx is fast
    bitwise; top-1 equal, logits close; the oracle twin equals the CPU
    engine."""
    points = _rand(8, B, 128, 3)
    jeng = JaxClsEngine(to_flax(cls_weights), num_classes=CLASSES, k=4,
                        binary=True, tile=16, mode=mode, rounds_impl="round",
                        interpret=True)
    want = np.asarray(jeng(jnp.asarray(points)))
    kw = dict(mode=mode, device="cpu", rounds_impl="round", tile=16)
    x = torch.from_numpy(points)
    got = SVDGCNNClsEngine(cls_weights, CLASSES, 4, True, **kw)(x)
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    oracle = SVDGCNNClsEngine(cls_weights, CLASSES, 4, True, oracle=True, **kw)
    assert torch.equal(oracle(x), got)
    fast = SVDGCNNClsEngine(cls_weights, CLASSES, 4, True,
                            **dict(kw, mode="fast"))
    assert torch.equal(fast(x), got)
