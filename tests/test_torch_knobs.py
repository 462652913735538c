"""The port's knob-aware training (``--train-knobs``) and KD step against
the JAX package (CPU; B=2, N=64, k=8, reuse_k 4; the models' widths are
fixed).

Per knob composition (spatial reuse with the 8-bit grid, conv2 reuse
with reuse_k 4, the 8-bit grid alone; the part segmenter with spatial
reuse, the 8-bit grid and reuse_k 4, and without knobs): the un-fused
train forward (``train/dgcnn.py``, plain kNN and gather) against flax
``apply(train=True)`` with JAX's ``train_knobs`` on, in float64 (the
binary float32 forward is chaotic at random init): logits, new running
statistics and gradients within 1e-6 relative; the fused trunk
(``train/fused.py``, B4-B6's plain versions run in float64) to the same
forward, its gradients to the flip-tolerant bars of
tests/test_torch_train.py (it routes a max tie's gradient to the first
rank, C5; flax splits it); the eager models' knob-world eval against
flax ``apply(train=False)`` with the knobs on (C2 kept). One KD step of
the recipe's stage 2 (knobs on, SGD so the update is the gradient's)
against ``_make_kd_train_step`` in float64.

Each JAX reference is compiled once, in float64, without XLA's backend
optimizations (``test_torch_train.compile_once``), with JAX's knobs set
as module globals while it traces and reset in a ``finally``. A test
takes one composition whole (one compile), which also keeps this file's
few long tests behind the suite's many short ones under ``--dist
loadfile``.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnet_tpu import config as jax_config
from svnet_tpu import models
from svnet_tpu.train import loop as jax_loop
from svnet_tpu.train.losses import cal_loss as jax_cal_loss
from svnet_tpu.train.optim import make_optimizer as jax_make_optimizer
from svnet_tpu.train.steps import TrainState
from svnet_tpu_torch import config
from svnet_tpu_torch.models import sv_dgcnn
from svnet_tpu_torch.train import dgcnn
from svnet_tpu_torch.train.fused import (
    make_fused_train_apply,
    make_fused_train_apply_pseg,
)
from svnet_tpu_torch.train.losses import cal_loss
from svnet_tpu_torch.train.optim import make_optimizer
from svnet_tpu_torch.train.steps import Distiller, TrainState as TrainState_
from svnet_tpu_torch.train.steps import make_train_step, tree_map
from svnet_tpu_torch.utils.convert import flatten, from_flax, load_tree, to_flax

from test_torch_train import _concat, _flat, _flip_tolerant, _rel, compile_once

B, N, K, RK, CLASSES, PARTS = 2, 64, 8, 4, 10, 50
LR, WD = 1e-3, 1e-4
# the knob compositions: (graph_reuse, reuse_k, approx_gather_bits)
CLS_KNOBS = {"spatial-gb8": ("spatial", 0, 8), "conv2-rk4": ("conv2", RK, 16),
             "gb8": ("none", 0, 8)}
PSEG_KNOBS = {"none": None, "spatial-gb8-rk4": ("spatial", RK, 8)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def jax_knobs(knob):
    """JAX's train knobs set as module globals (its setters would clear
    every jit cache), for a reference traced inside; reset in a finally."""
    try:
        if knob is not None:
            jax_config.train_knobs = True
            jax_config.graph_reuse, jax_config.reuse_k = knob[0], knob[1]
            jax_config.approx_gather_bits = knob[2]
        yield
    finally:
        jax_config.train_knobs = False
        jax_config.graph_reuse, jax_config.reuse_k = "none", 0
        jax_config.approx_gather_bits = 16


def compile_once_call(fn, *args):
    return compile_once(fn, *args)(*args)


def port_knobs(knob):
    return None if knob is None else config.TrainKnobs(knob[0], knob[1], knob[2] == 8)


def _inputs(pseg: bool):
    """Seeded float64 points, targets and (partseg) one-hot labels."""
    rng = np.random.default_rng(5)
    points = rng.standard_normal((B, N, 3))
    if not pseg:
        return points, np.array([3, 7]), None
    label = np.zeros((B, 16))
    label[np.arange(B), [3, 12]] = 1.0
    return points, rng.integers(0, PARTS, (B, N)), label


def _weights(pseg: bool, binary: bool = True, seed: int = 6):
    init = sv_dgcnn.init_params_pseg if pseg else sv_dgcnn.init_params
    return init(PARTS if pseg else CLASSES, K, binary,
                torch.Generator().manual_seed(seed))


def _jax_model(pseg: bool, binary: bool = True):
    if pseg:
        return models.SV_DGCNN_PSEG(num_part=PARTS, k=K, binary=binary, dropout=0.0)
    return models.SV_DGCNN_CLS(num_classes=CLASSES, k=K, binary=binary, dropout=0.0)


def _reference(pseg: bool, knob, with_eval: bool):
    """JAX in float64 under ``knob``: the train loss, logits, new running
    statistics and gradients, and (``with_eval``) the eval logits."""
    points, target, label = _inputs(pseg)
    model = _jax_model(pseg)
    args = (points, label) if pseg else (points,)

    def fn(params, stats, args, target):
        def loss_fn(p):
            out, upd = model.apply({"params": p, "batch_stats": stats}, *args,
                                   True, mutable=["batch_stats"])
            return jax_cal_loss(out, target, not pseg), (out, upd["batch_stats"])

        res = jax.value_and_grad(loss_fn, has_aux=True)(params)
        ev = (model.apply({"params": params, "batch_stats": stats}, *args, False)
              if with_eval else None)
        return res, ev

    with jax.enable_x64(True), jax_knobs(knob):
        var = jax.tree.map(lambda a: np.asarray(a, np.float64),
                           to_flax(_weights(pseg)))
        ((loss, (logits, stats)), grads), ev = compile_once_call(
            fn, var["params"], var["batch_stats"], args, target)
        return {"loss": float(loss), "logits": np.asarray(logits),
                "stats": _flat(stats), "grads": _flat(grads),
                "eval": None if ev is None else np.asarray(ev)}


def _port(pseg: bool, knob, make):
    """The port's train forward ``make(..., knobs=, oracle=True)`` in
    float64 on the same weights and inputs: loss, logits, statistics,
    gradients."""
    points, target, label = _inputs(pseg)
    tree = tree_map(torch.Tensor.double, _weights(pseg))
    params = tree_map(lambda t: t.requires_grad_(True), tree["params"])
    apply = make(PARTS if pseg else CLASSES, K, True, dropout=0.0, oracle=True,
                 knobs=port_knobs(knob))
    args = (torch.from_numpy(points),) + ((torch.from_numpy(label),) if pseg else ())
    logits, stats = apply(params, tree["batch_stats"], *args)
    loss = cal_loss(logits, torch.from_numpy(target), not pseg)
    loss.backward()
    return {"loss": loss.item(), "logits": logits.detach().numpy(),
            "stats": _flat(to_flax(stats)),
            "grads": _flat(to_flax(tree_map(lambda t: t.grad, params)))}


CASES = [(False, name, knob) for name, knob in CLS_KNOBS.items()] + \
        [(True, name, knob) for name, knob in PSEG_KNOBS.items()]


def _forward_close(got, want, tol=1e-6):
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=tol, atol=tol)
    assert set(got["stats"]) == set(want["stats"])
    for path, w in want["stats"].items():
        assert _rel(got["stats"][path], w) <= tol, path
    assert got["loss"] == pytest.approx(want["loss"], rel=tol)


@pytest.mark.parametrize("pseg,name,knob", CASES,
                         ids=[("pseg-" if c[0] else "cls-") + c[1] for c in CASES])
def test_knob_forwards_match_flax_float64(pseg, name, knob):
    """One knob composition (the part segmenter's also without knobs)
    against flax under JAX's ``train_knobs``, in float64, one JAX compile:

    - the un-fused train forward (``train/dgcnn.py``): logits, new
      statistics, loss and all gradients within 1e-6 relative;
    - the fused train forward (B4, B5 and B6's plain versions, reused ids
      as contiguous rank prefixes, ``ste_quant8`` before B6): logits,
      statistics and loss within 1e-6; gradients to the flip-tolerant
      bars (max ties routed to the first rank, C5);
    - C2 kept (the recipe's spatial compositions): the eager model a
      trainer builds with the knobs evaluates in their world, as flax
      ``apply(train=False)`` does with ``train_knobs`` on (logits within
      1e-6); an FP model (a teacher) takes none."""
    with_eval = knob is not None and name.startswith("spatial")
    want = _reference(pseg, knob, with_eval)
    make = dgcnn.make_train_apply_pseg if pseg else dgcnn.make_train_apply_cls
    got = _port(pseg, knob, make)
    _forward_close(got, want)
    assert set(got["grads"]) == set(want["grads"])
    assert _rel(_concat(got["grads"]), _concat(want["grads"])) <= 1e-6

    got = _port(pseg, knob, make_fused_train_apply_pseg if pseg
                else make_fused_train_apply)
    _forward_close(got, want)
    _flip_tolerant(got["grads"], want["grads"], 5e-2)

    knobs = port_knobs(knob)
    cls = sv_dgcnn.SVDGCNNPseg if pseg else sv_dgcnn.SVDGCNNCls
    width = PARTS if pseg else CLASSES
    assert cls(width, K, False, knobs=knobs).knobs is None
    if not with_eval:
        return
    model = cls(width, K, True, knobs=knobs).double()
    load_tree(model, tree_map(torch.Tensor.double, _weights(pseg)))
    points, _, label = _inputs(pseg)
    args = (torch.from_numpy(points),) + ((torch.from_numpy(label),) if pseg else ())
    with torch.no_grad():
        got = model.eval()(*args).numpy()
    np.testing.assert_allclose(got, want["eval"], rtol=1e-6, atol=1e-6)


def test_kd_step_matches_jax_float64():
    """One KD step of the recipe's stage 2 (``kd_t`` 2, ``kd_alpha`` 0.3,
    the knobs on, the FP teacher's eval forward) against
    ``_make_kd_train_step`` in float64, through SGD so that the update is
    the gradient's: loss within 1e-9 relative, the update within 1e-6."""
    knob = CLS_KNOBS["spatial-gb8"]
    points, target, _ = _inputs(False)
    student, teacher = to_flax(_weights(False)), to_flax(_weights(False, False, 9))
    model, t_model = _jax_model(False), _jax_model(False, False)
    tx = jax_make_optimizer(binary=True, lr=LR, epochs=1, steps_per_epoch=1,
                            weight_decay=WD, opt="sgd")
    with jax.enable_x64(True), jax_knobs(knob):
        var, t_var = (jax.tree.map(lambda a: np.asarray(a, np.float64), t)
                      for t in (student, teacher))
        distiller = jax_loop._Distiller(t_model, t_var, False, 2.0)
        step = jax_loop._make_kd_train_step(model, jax_cal_loss, distiller,
                                            "aligned", alpha=0.3)
        state = TrainState.create(params=var["params"],
                                  batch_stats=var["batch_stats"], tx=tx)
        new, loss, _ = compile_once_call(step, state, {"points": jnp.asarray(points),
                                              "target": jnp.asarray(target)},
                                jax.random.PRNGKey(0))
        want_du = _concat(_flat(new.params)) - _concat(_flat(var["params"]))
        want_loss = float(loss)

    tree = tree_map(torch.Tensor.double, from_flax(student))
    params = tree_map(lambda t: t.requires_grad_(True), tree["params"])
    leaves = [leaf for _, leaf in sorted(flatten(params).items())]
    opt, sched = make_optimizer(leaves, binary=True, lr=LR, epochs=1,
                                steps_per_epoch=1, weight_decay=WD, opt="sgd")
    tstate = TrainState_(params, tree["batch_stats"], opt, sched)
    start = _concat(_flat(to_flax(params)))
    t_eager = sv_dgcnn.SVDGCNNCls(CLASSES, K, False).double()
    load_tree(t_eager, tree_map(torch.Tensor.double, from_flax(teacher)))
    step = make_train_step(
        dgcnn.make_train_apply_cls(CLASSES, K, True, dropout=0.0, oracle=True,
                                   knobs=port_knobs(knob)),
        cal_loss, rot="aligned", distiller=Distiller(t_eager, 2.0), alpha=0.3)
    loss, _ = step(tstate, {"points": torch.from_numpy(points),
                            "target": torch.from_numpy(target)},
                   torch.Generator().manual_seed(0))
    assert loss.item() == pytest.approx(want_loss, rel=1e-9)
    assert _rel(_concat(_flat(to_flax(params))) - start, want_du) <= 1e-6
