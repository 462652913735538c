"""The SV-PointNet classifier's train forward, one train step and two Adam
steps against the JAX step in float64, as set out in
tests/test_torch_pointnet_train.py, whose helpers and autouse
``_one_torch_thread`` this file imports.

At most six tests a file: pytest-xdist's ``--dist loadfile`` queues files
by their number of tests, largest first, so these long JAX references run
beside tests/test_sharded_infer.py, the suite's longest file, instead of
ahead of it.
"""

import numpy as np
import pytest

from test_torch_pointnet_train import _concat, _cos, _one_torch_thread, _rel, _run


@pytest.fixture(scope="module", params=[True, False], ids=["binary", "fp"])
def step64(request):
    return request.param, _run(request.param, f64=True)


def test_train_forward_matches_flax_float64(step64):
    """The train forward (the oracle twin: plain kNN and gather) against
    flax ``apply(train=True)`` in float64: logits and new running
    statistics within 1e-9 (measured 2e-12 FP, 6e-16 binary). In float64 no
    sign lies within rounding of 0, so the binary model is held as tightly
    as the FP one."""
    _, (got, want, _) = step64
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=1e-9, atol=1e-9)
    assert set(got["stats"]) == set(want["stats"])
    for path, w in want["stats"].items():
        assert _rel(got["stats"][path], w) <= 1e-9, path


def test_train_step_loss_and_grads_match_jax_float64(step64):
    """Loss within 1e-12 and all gradients together within 1e-9 relative
    (measured 5e-11 binary, 8e-12 FP): the STE windows, the tie-split max
    pools and the leaky slope at exactly 0 (1, as jax.nn.leaky_relu) are
    the JAX step's."""
    _, (got, want, _) = step64
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-12)
    assert set(got["grads"]) == set(want["grads"])
    assert _rel(_concat(got["grads"]), _concat(want["grads"])) <= 1e-9


def test_two_adam_steps_match_jax_float64(step64):
    """Parameters after two Adam steps of the pointnet_cls recipe (L2 decay
    before the moments, StepLR). FP: entry by entry within 1e-7. Binary: a
    ``beta`` in front of a BatchNorm'd linear has an exactly zero gradient,
    of which each side computes its own rounding noise; Adam divides it by
    its own magnitude and moves beta by +-1e-14, which flips the sign of
    an input that is exactly 0 in the second step. So the binary update is
    held as a whole, as in tests/test_torch_train.py: cosine >= 0.95
    (measured 0.984)."""
    binary, (got, want, start) = step64
    g, w = _concat(got["params"]), _concat(want["params"])
    if binary:
        assert _cos(g - _concat(start), w - _concat(start)) >= 0.95
    else:
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-7)
