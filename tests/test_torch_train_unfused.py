"""The un-fused SV-DGCNN train forward (``train/dgcnn.py``) and its
gradients against flax ``SV_DGCNN_CLS.apply(train=True)`` in float64, as in
tests/test_torch_train.py, whose helpers and autouse ``_one_torch_thread``
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
from svnet_tpu.train.losses import cal_loss as jax_cal_loss
from svnet_tpu_torch.train.dgcnn import make_train_apply_cls as make_dgcnn_apply
from svnet_tpu_torch.train.losses import cal_loss
from svnet_tpu_torch.train.steps import tree_map
from svnet_tpu_torch.utils.convert import from_flax, to_flax

from test_torch_train import (
    B,
    CLASSES,
    K,
    N,
    _concat,
    _flat,
    _one_torch_thread,
    _rel,
    compile_once,
)


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "fp"])
def test_unfused_train_forward_and_grads_match_flax_float64(binary):
    """The un-fused train forward (``train/dgcnn.py``; the oracle twin,
    plain kNN and gather) against flax ``SV_DGCNN_CLS.apply(train=True)``
    in float64, where no sign lies within rounding of 0 and max ties are
    exact on both sides: logits, new running statistics and the loss's
    gradients within 1e-9 (measured 1e-12 or less)."""
    from svnet_tpu_torch.models.sv_dgcnn import init_params

    rng = np.random.default_rng(5)
    points = rng.standard_normal((B, N, 3))
    target = np.array([3, 7, 1, 9])
    var32 = to_flax(init_params(CLASSES, K, binary, torch.Generator().manual_seed(6)))
    model = models.SV_DGCNN_CLS(num_classes=CLASSES, k=K, binary=binary,
                                dropout=0.0)

    def loss_fn(params, stats, pts, tgt):
        out, upd = model.apply({"params": params, "batch_stats": stats}, pts,
                               True, mutable=["batch_stats"])
        return jax_cal_loss(out, tgt), (out, upd["batch_stats"])

    with jax.enable_x64(True):
        var = jax.tree.map(lambda a: np.asarray(a, np.float64), var32)
        args = (var["params"], var["batch_stats"], jnp.asarray(points),
                jnp.asarray(target))
        (want_loss, (want, want_st)), want_g = compile_once(
            jax.value_and_grad(loss_fn, has_aux=True), *args)(*args)
    tree = tree_map(torch.Tensor.double, from_flax(var32))
    params = tree_map(lambda t: t.requires_grad_(True), tree["params"])
    apply = make_dgcnn_apply(CLASSES, K, binary, dropout=0.0, oracle=True)
    logits, stats = apply(params, tree["batch_stats"], torch.from_numpy(points))
    loss = cal_loss(logits, torch.from_numpy(target))
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want),
                               rtol=1e-9, atol=1e-9)
    got_st, want_st = _flat(to_flax(stats)), _flat(want_st)
    assert set(got_st) == set(want_st)
    for path, w in want_st.items():
        assert _rel(got_st[path], w) <= 1e-9, path
    got_g = _flat(to_flax(tree_map(lambda t: t.grad, params)))
    assert _rel(_concat(got_g), _concat(_flat(want_g))) <= 1e-9
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-12)
