"""One SV-DGCNN partseg train step (the fused forward, the kernels' plain
versions) and two Adam steps against the JAX step, to the bars of
tests/test_torch_pseg_train.py, whose helpers and autouse
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
from svnet_tpu.train.losses import cal_loss as jax_cal_loss
from svnet_tpu.train.optim import make_optimizer as jax_make_optimizer
from svnet_tpu.train.steps import TrainState
from svnet_tpu.train.steps import make_train_step as jax_make_train_step
from svnet_tpu_torch.models import sv_dgcnn
from svnet_tpu_torch.train.fused import make_fused_train_apply_pseg
from svnet_tpu_torch.train.losses import cal_loss
from svnet_tpu_torch.train.steps import create_state, make_train_step, tree_map
from svnet_tpu_torch.utils.convert import from_flax, to_flax

from test_torch_train import _concat, _cos, _flat, _flip_tolerant, _rel
from test_torch_pseg_train import B, K, LR, N, PARTS, WD, _batch, _one_torch_thread


@pytest.fixture(scope="module")
def dgcnn_steps():
    """Two binary SV-DGCNN partseg train steps through both packages (the
    JAX train step with its label, jitted; the port's fused forward on the
    CPU), and the JAX loss's gradients at the first step."""
    points, _, label, seg = _batch(0)
    var = to_flax(sv_dgcnn.init_params_pseg(PARTS, K, True,
                                            torch.Generator().manual_seed(1)))
    model = models.SV_DGCNN_PSEG(num_part=PARTS, k=K, binary=True, dropout=0.0)
    tx = jax_make_optimizer(binary=True, lr=LR, epochs=2, steps_per_epoch=1,
                            weight_decay=WD)
    state = TrainState.create(params=var["params"],
                              batch_stats=var["batch_stats"], tx=tx)
    batch = {"points": jnp.asarray(points), "target": jnp.asarray(seg),
             "label": jnp.asarray(label)}

    def loss_fn(params, stats, batch):
        out, _ = model.apply({"params": params, "batch_stats": stats},
                             batch["points"], batch["label"], True,
                             mutable=["batch_stats"])
        return jax_cal_loss(out, batch["target"], False)

    jstep = jax_make_train_step(model, lambda o, t: jax_cal_loss(o, t, False),
                                rot="aligned", with_label=True)

    @jax.jit  # one compile: the gradients at the state, and its step
    def grads_and_step(state, batch, key):
        return (jax.value_and_grad(loss_fn)(state.params, state.batch_stats, batch),
                jstep(state, batch, key)[0])

    (want_loss, want_grads), s1 = grads_and_step(state, batch, jax.random.PRNGKey(0))
    s2 = grads_and_step(s1, batch, jax.random.PRNGKey(0))[1]

    tstate = create_state(from_flax(var), binary=True, lr=LR, epochs=2,
                          steps_per_epoch=1, weight_decay=WD, device="cpu")
    step = make_train_step(make_fused_train_apply_pseg(PARTS, K, binary=True),
                           lambda o, t: cal_loss(o, t, False), rot="aligned",
                           with_label=True)
    tb = {"points": torch.from_numpy(points), "target": torch.from_numpy(seg),
          "label": torch.from_numpy(label)}
    gen = torch.Generator().manual_seed(0)
    got_loss, preds = step(tstate, tb, gen)
    got_grads = _flat(to_flax(tree_map(lambda t: t.grad, tstate.params)))
    got_stats1 = _flat(to_flax(tstate.batch_stats))
    step(tstate, tb, gen)
    return {"loss": (got_loss.item(), float(want_loss)), "preds": preds,
            "grads": (got_grads, _flat(want_grads)),
            "stats": (got_stats1, _flat(s1.batch_stats)),
            "params": (_flat(to_flax(tstate.params)), _flat(s2.params),
                       _flat(var["params"]))}


def test_dgcnn_pseg_step_loss_matches_jax(dgcnn_steps):
    got, want = dgcnn_steps["loss"]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert dgcnn_steps["preds"].shape == (B, N)


def test_dgcnn_pseg_step_grads_match_jax(dgcnn_steps):
    """The flip-tolerant bars of tests/test_torch_train.py: each leaf of 8
    or more entries at cosine >= 0.9, all together within 5e-2."""
    got, want = dgcnn_steps["grads"]
    assert set(got) == set(want)
    _flip_tolerant(got, want, 5e-2)


def test_dgcnn_pseg_step_batch_stats_match_jax(dgcnn_steps):
    got, want = dgcnn_steps["stats"]
    assert set(got) == set(want)
    for path, w in want.items():
        assert _rel(got[path], w) <= 2e-2, path


def test_dgcnn_pseg_two_adam_steps_match_jax(dgcnn_steps):
    """The binary update as a whole, as tests/test_torch_train.py holds
    it: cosine >= 0.95."""
    got, want, start = dgcnn_steps["params"]
    assert _cos(_concat(got) - _concat(start), _concat(want) - _concat(start)) >= 0.95
