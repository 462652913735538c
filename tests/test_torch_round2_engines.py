"""The classification engine's round2 trunk against the JAX engine's and
against the port's own round3 trunk on the CPU, to the bars of
tests/test_torch_round2.py, whose helpers and autouse ``_one_torch_thread``
this file imports.

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
from svnet_tpu.infer import SVDGCNNClsEngine as JaxClsEngine
from svnet_tpu_torch.infer import SVDGCNNClsEngine
from svnet_tpu_torch.utils.convert import from_flax

from test_torch_train import compile_once
from test_torch_round2 import ATOL, B, CLASSES, K, N, RTOL, _one_torch_thread, _rand


@pytest.fixture(scope="module", params=[False, True], ids=["fp", "binary"])
def cls_setup(request):
    """flax's own init, as tests/test_torch_engine.py: at the port's seeded
    init the binary model sits on sign() ties that flip between any two
    summation orders (JAX's round3 engine is 0.3 from flax there)."""
    binary = request.param
    model = models.SV_DGCNN_CLS(num_classes=CLASSES, k=K, binary=binary)
    points = _rand(0, B, N, 3)
    init_args = (jax.random.PRNGKey(1), jnp.zeros((1, 16, 3)))
    var = compile_once(model.init, *init_args)(*init_args)
    var = {"params": var["params"], "batch_stats": jax.tree.map(
        lambda x: x + 0.3 * jnp.abs(x) + 0.05, var["batch_stats"])}
    jeng = JaxClsEngine(var, num_classes=CLASSES, k=K, binary=binary,
                        exact=True, rounds_impl="round2", interpret=True)
    weights = from_flax(jax.tree.map(np.asarray, var))
    return binary, weights, points, np.asarray(jeng(jnp.asarray(points)))


def test_cls_round2_engine_matches_jax_engine(cls_setup):
    binary, weights, points, want = cls_setup
    eng = SVDGCNNClsEngine(weights, CLASSES, K, binary, device="cpu",
                           rounds_impl="round2")
    got = eng(torch.from_numpy(points))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_cls_round2_engine_equals_round3_engine(cls_setup):
    """Both trunks through their plain versions: the same logits, bitwise
    (the gate and head means are reduced in one layout, ``_mean_points``);
    the oracle twin equals the CPU engine."""
    binary, weights, points, _ = cls_setup
    x = torch.from_numpy(points)
    r2 = SVDGCNNClsEngine(weights, CLASSES, K, binary, device="cpu",
                          rounds_impl="round2")(x)
    r3 = SVDGCNNClsEngine(weights, CLASSES, K, binary, device="cpu")(x)
    assert torch.equal(r2, r3)
    oracle = SVDGCNNClsEngine(weights, CLASSES, K, binary, device="cpu",
                              rounds_impl="round2", oracle=True)
    assert torch.equal(oracle(x), r2)
