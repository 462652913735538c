"""The port's VN and original classifiers (``--model vn|original``,
PointNet and DGCNN backbones) against the JAX package's flax models (CPU,
B=4, N=32, k=8, 40 classes; the widths are the models' own).

For each class: the weight tree the port draws has flax ``init``'s keys
and shapes (``jax.eval_shape``) and comes back unchanged through
``from_flax``/``load_tree``/``module_tree``; the eager eval model against
``model.apply`` in float32 (rtol 1e-4, atol 1e-5 of the logit scale); the
train forward (``make_train_apply``) against ``apply(train=True,
mutable=["batch_stats"])`` and one train step (its loss, new running
statistics and gradients) against JAX's ``make_train_step`` with
``rot="aligned"``, both in float64 (JAX with x64 enabled; 1e-9 of the
scale, gradients 1e-6 of the largest: the VN reflection divides by
|d|^2 + 1e-6, which magnifies rounding where a direction is near 0),
where BatchNorm over B=4 clouds does not magnify the rounding of another
summation order. JAX's step takes ``optax.sgd(1.0)``, so its
gradients are the parameters' change; flax's dropout is the identity and
the port's forward gets no generator. The part segmenters are in
tests/test_torch_zoo_pseg.py.
"""

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from svnet_tpu import models
from svnet_tpu.train import losses as jlosses
from svnet_tpu.train.steps import TrainState, make_train_step
from svnet_tpu_torch.models import get_model
from svnet_tpu_torch.models.sv_dgcnn import seeded_tree
from svnet_tpu_torch.train import losses
from svnet_tpu_torch.train.steps import TrainState as PortState
from svnet_tpu_torch.train.steps import tree_map
from svnet_tpu_torch.train.steps import make_train_step as port_train_step
from svnet_tpu_torch.utils.convert import (
    flatten,
    from_flax,
    load_tree,
    module_tree,
    to_flax,
)

from test_torch_train import compile_once

B, N, K = 4, 32, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(task, seed=0):
    rng = np.random.default_rng(seed)
    points = rng.standard_normal((B, N, 3)).astype(np.float32)
    if task == "cls":
        return (points,), rng.integers(0, 40, B)
    label = np.eye(16, dtype=np.float32)[rng.integers(0, 16, B)]
    return (points, label), rng.integers(0, 50, (B, N))


def _config(task, model, pooling):
    kw = {"k": K, ("num_classes" if task == "cls" else "num_part"):
          40 if task == "cls" else 50}
    if model == "vn":
        kw["pooling"] = pooling
    return kw


def _jax_loss(task):
    """The JAX trainers' losses: ``_pick_loss``'s for classification
    (``cal_pointnet_loss`` for a T-Net pair), run_partseg's ``seg_loss``
    (no label smoothing) for part segmentation."""
    smoothing = task == "cls"

    def loss(outputs, target):
        logits = outputs[0] if isinstance(outputs, tuple) else outputs
        base = jlosses.cal_loss(logits, target, smoothing=smoothing)
        if isinstance(outputs, tuple):
            base = base + 0.001 * jlosses.feature_transform_regularizer(outputs[1])
        return base

    return loss


def _arrays(outputs):
    """A model's outputs (logits, or (logits, trans_feat)) as float64
    numpy arrays."""
    outputs = outputs if isinstance(outputs, tuple) else (outputs,)
    return [np.asarray(o.detach() if isinstance(o, torch.Tensor) else o,
                       dtype=np.float64) for o in outputs]


def _close(got, want, rtol):
    """Each array within ``rtol`` of its largest |value|."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=rtol * (np.abs(w).max() + 1e-30))


def check_model(task, backbone, model, pooling="mean"):
    """Tree, eval, train forward and one train step of one class."""
    cfg = _config(task, model, pooling)
    port = get_model(task, backbone, model, generator=torch.Generator().manual_seed(3),
                     **cfg)
    tree = seeded_tree(port)
    var = to_flax(tree)
    (inputs, target) = _inputs(task)
    jmodel = models.get_model(task, backbone, model, **cfg)

    # the tree: flax init's keys and shapes; from_flax carries it whole
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                *map(jnp.asarray, inputs)))
    want_shapes = flatten(jax.tree.map(lambda a: tuple(a.shape), dict(shapes),
                                       is_leaf=lambda a: hasattr(a, "shape")))
    got_shapes = flatten(tree_map(lambda t: tuple(t.shape), tree))
    assert got_shapes == want_shapes
    load_tree(port, from_flax(var))
    back = flatten(module_tree(port))
    assert all(torch.equal(back[p], v) for p, v in flatten(tree).items())

    # eval, float32
    evaluate = jax.jit(lambda v, *a: jmodel.apply(v, *a, False))
    want = evaluate(var, *map(jnp.asarray, inputs))
    with torch.no_grad():
        got = port.eval()(*map(torch.from_numpy, inputs))
    _close(_arrays(got), _arrays(want), 1e-5)

    # train forward and one step, float64
    mp = pytest.MonkeyPatch()
    mp.setattr(flax_nn.Dropout, "__call__", lambda self, x, *a, **kw: x)
    try:
        with jax.enable_x64(True):
            v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), var)
            x64 = [jnp.asarray(i.astype(np.float64)) for i in inputs]

            def fwd(v, *a):
                return jmodel.apply(v, *a, True, mutable=["batch_stats"])

            out, upd = compile_once(fwd, v64, *x64)(v64, *x64)
            state = TrainState.create(params=v64["params"],
                                      batch_stats=v64["batch_stats"],
                                      tx=optax.sgd(1.0))
            batch = {"points": x64[0], "target": jnp.asarray(target)}
            if task == "partseg":
                batch["label"] = x64[1]
            step = make_train_step(jmodel, _jax_loss(task), rot="aligned",
                                   with_label=task == "partseg")
            rng = jax.random.PRNGKey(0)
            new_state, loss, _ = compile_once(step, state, batch, rng)(
                state, batch, rng)
            grads = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                                 v64["params"], new_state.params)
    finally:
        mp.undo()

    t64 = tree_map(torch.Tensor.double, from_flax(var))
    apply = port.make_train_apply()
    got, new = apply(t64["params"], t64["batch_stats"],
                     *[torch.from_numpy(i.astype(np.float64)) for i in inputs])
    _close(_arrays(got), _arrays(out), 1e-9)
    want_st = flatten(jax.tree.map(np.asarray, dict(upd["batch_stats"])))
    assert set(flatten(new)) == set(want_st)
    for path, w in want_st.items():
        _close([flatten(new)[path].numpy()], [w], 1e-9)

    # one step through the port's train step (lr 0: the parameters stay);
    # the gradients it leaves against JAX's parameter change
    smoothing = task == "cls"
    params = tree_map(lambda t: t.clone().requires_grad_(True), t64["params"])
    opt = torch.optim.SGD([v for _, v in sorted(flatten(params).items())], lr=0.0)
    state = PortState(params, t64["batch_stats"], opt, lambda step: 0.0)
    # the step hands its generator last; without it dropout is off, as
    # flax's is here
    tstep = port_train_step(lambda p, st, *a: apply(p, st, *a[:-1]),
                            lambda o, t: losses.model_loss(o, t, smoothing),
                            rot="aligned", with_label=task == "partseg")
    pbatch = {"points": torch.from_numpy(inputs[0].astype(np.float64)),
              "target": torch.from_numpy(target)}
    if task == "partseg":
        pbatch["label"] = torch.from_numpy(inputs[1].astype(np.float64))
    ploss, _ = tstep(state, pbatch, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(ploss.item(), float(loss), rtol=1e-9)
    want_st = flatten(jax.tree.map(np.asarray, dict(new_state.batch_stats)))
    for path, w in want_st.items():
        _close([flatten(state.batch_stats)[path].numpy()], [w], 1e-9)
    want_g = flatten(grads)
    # a VNMaxPool's direction only picks an index: no gradient reaches it
    got_g = flatten(tree_map(lambda t: np.zeros(t.shape) if t.grad is None
                             else t.grad.numpy(), state.params))
    assert set(got_g) == set(want_g)
    scale = max(np.abs(w).max() for w in want_g.values())
    for path, w in want_g.items():
        np.testing.assert_allclose(got_g[path], w, rtol=0, atol=1e-6 * scale,
                                   err_msg=path)


@pytest.mark.parametrize("backbone,model,pooling", [
    ("pointnet", "vn", "max"), ("dgcnn", "vn", "mean"),
    ("pointnet", "original", "mean"), ("dgcnn", "original", "mean")])
def test_classifier_matches_flax(backbone, model, pooling):
    check_model("cls", backbone, model, pooling)
