"""The port's BiPointNet models (``--model bipointnet``:
``models/bipointnet.py``) against the JAX package's flax models (CPU,
B=2, N=64; the widths are the models' own: 40 classes, 50 parts, 13
S3DIS classes on 9 channels).

The weights are flax ``init``'s (float32), carried through ``from_flax``,
the running statistics moved off their init by the suite's recipe (x +
0.3|x| + 0.05). Every comparison is in float64 on both sides (JAX with
x64 enabled): a binary linear's ±1 products times a float32 scale sum
exactly there, so no sign hangs on the order of a sum, which in float32
flips signs near 0 and the top-1 with them. Bars: 1e-9 of each output's
largest |value| (logits and trans_feat, new running statistics, the
loss), gradients 1e-7 of the largest. For each model: the tree's paths
and shapes against flax ``init``'s; eval at pool max, mean and ema-max,
with and without the BatchNorm affine leaves; the LSR scales drawn from
the first batch (``init_tree`` on JAX's kernels, as ``init_on`` draws
them) against JAX's float32 init on it: the input T-Net's conv2, the
first binary layer, within 1e-5; every later one finite and positive. A
later layer's scale is not comparable: the scales drawn before it are
not float32 values, so a ±1 sum that is 0 in exact arithmetic (a tenth of
a layer's outputs at these widths) comes out 0 in one summation order and
±1e-18 in another, and its sign, 0 or ±1, moves the next layer's
statistics by up to a third (the scales' formula on given data is held
to JAX's in tests/test_torch_bipointnet_layers.py). One train
step of the classifier and the semantic segmenter against JAX's
``make_train_step`` (``optax.sgd(1.0)``: its gradients are the
parameters' change): the loss, the gradients and the new running
statistics. Each reference (``init`` too) is compiled once without
XLA's backend optimizations (``test_torch_train.compile_once``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from svnet_tpu.models import bipointnet as jbm
from svnet_tpu.train import losses as jlosses
from svnet_tpu.train.steps import TrainState, make_train_step
from svnet_tpu_torch.models import bipointnet as pbm
from svnet_tpu_torch.nn.scope import Scope, init_tree
from svnet_tpu_torch.train import losses
from svnet_tpu_torch.train.steps import TrainState as PortState
from svnet_tpu_torch.train.steps import make_train_step as port_train_step
from svnet_tpu_torch.train.steps import tree_map
from svnet_tpu_torch.utils.convert import flatten, from_flax, nest

from test_torch_train import compile_once

B, N = 2, 64
# task -> (flax class, port function, point width, head width)
MODELS = {"cls": (jbm.BiPointNet_CLS, pbm.bipointnet_cls, 3, 40),
          "pseg": (jbm.BiPointNet_PSEG, pbm.bipointnet_pseg, 3, 50),
          "semseg": (jbm.BiPointNet_SEMSEG, pbm.bipointnet_semseg, 9, 13)}
# eval: every pool with the affine leaves, and ema-max without them
CONFIGS = [("max", True), ("mean", True), ("ema-max", True), ("ema-max", False)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(task, seed=0):
    rng = np.random.default_rng(seed)
    points = rng.standard_normal((B, N, MODELS[task][2])).astype(np.float32)
    width = MODELS[task][3]
    if task == "pseg":
        label = np.eye(16, dtype=np.float32)[rng.integers(0, 16, B)]
        return (points, label), rng.integers(0, width, (B, N))
    return (points,), rng.integers(0, width, B if task == "cls" else (B, N))


def _bumped(var):
    """flax variables with the running statistics bumped."""
    return {**var, "batch_stats": jax.tree.map(lambda a: a + 0.3 * np.abs(a) + 0.05,
                                               var["batch_stats"])}


def _init(jmod, seed, inputs):
    def init(*a):
        return jmod.init(jax.random.PRNGKey(seed), *a)

    args = tuple(map(jnp.asarray, inputs))
    return compile_once(init, *args)(*args)


def _f64(tree):
    return tree_map(torch.Tensor.double, tree)


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * (np.abs(want).max() + 1e-300),
                               err_msg=what)


def _lsr_scales(tree):
    """The paths of the LSR linears' scale leaves (a ``scale`` beside a
    ``kernel``; BatchNorm's sit beside a ``bias``)."""
    flat = flatten(tree["params"])
    return {p for p in flat if p.endswith(".scale") and p[:-5] + "kernel" in flat}


@pytest.mark.parametrize("task", list(MODELS))
def test_model_eval_and_init(task):
    """The tree, eval at every pool with and without the affine leaves,
    and the LSR scales drawn from the batch."""
    fn = MODELS[task][1]
    inputs, _ = _inputs(task)
    x64 = [i.astype(np.float64) for i in inputs]
    inits = {}  # max and mean share a tree
    for pool, affine in CONFIGS:
        jmod = MODELS[task][0](pool=pool, affine=affine)
        key = (pool == "ema-max", affine)
        if key not in inits:
            inits[key] = jax.tree.map(np.asarray, dict(_init(jmod, 1, inputs)))
        var = _bumped(inits[key])
        cfg = {"pool": pool, "affine": affine}
        # the tree the port draws: flax init's paths and shapes
        drawn = init_tree(fn, tuple(map(torch.from_numpy, inputs)), cfg, None)
        assert {p: tuple(v.shape) for p, v in flatten(drawn).items()} == \
            {p: tuple(np.shape(v)) for p, v in flatten(var).items()}, (pool, affine)
        with jax.enable_x64(True):
            v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), var)
            args = (v64,) + tuple(map(jnp.asarray, x64))
            want = compile_once(lambda v, *a: jmod.apply(v, *a, False), *args)(*args)
        got = fn(Scope(_f64(from_flax(var))), *map(torch.from_numpy, x64), **cfg)
        for g, w, what in zip(got, want, ("logits", "trans_feat")):
            _close(g.numpy(), np.asarray(w), 1e-9, f"{pool} {affine} {what}")
    # the LSR scales drawn from the batch at the exported configuration
    var = inits[(True, True)]
    tree = _f64(from_flax(var))
    scales = _lsr_scales(tree)
    assert len(scales) >= 15
    params = {p: v for p, v in flatten(tree["params"]).items() if p not in scales}
    part = {"params": nest(params), "batch_stats": tree["batch_stats"]}
    init_tree(fn, tuple(map(torch.from_numpy, x64)), {"pool": "ema-max"}, None, part)
    got, want = flatten(part["params"]), flatten(var["params"])
    first = [p for p in scales if p.split(".")[-4:-2] == ["stn", "conv2"]]
    assert len(first) == 1
    np.testing.assert_allclose(float(got[first[0]]), float(want[first[0]]), rtol=1e-5)
    assert all(np.isfinite(float(got[p])) and float(got[p]) > 0 for p in scales)


def _jax_loss(task):
    """The JAX trainers' loss of a (logits, trans_feat) model
    (``cal_pointnet_loss``): label smoothing for classification, none for
    part and semantic segmentation (their CLIs' defaults)."""
    def loss(outputs, target):
        logits, trans_feat = outputs
        return jlosses.cal_loss(logits, target, smoothing=task == "cls") + \
            0.001 * jlosses.feature_transform_regularizer(trans_feat)

    return loss


@pytest.mark.parametrize("task", ["cls", "semseg"])
def test_train_step(task):
    """One train step at the exported configuration (LSR, ema-max)
    against JAX's ``make_train_step``: loss, gradients, new running
    statistics; the train forward's logits and trans_feat."""
    fn = MODELS[task][1]
    inputs, target = _inputs(task, seed=1)
    jmod = MODELS[task][0]()
    var = _bumped(jax.tree.map(np.asarray, dict(_init(jmod, 1, inputs))))
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), var)
        x64 = [jnp.asarray(i.astype(np.float64)) for i in inputs]
        out, _ = compile_once(
            lambda v, *a: jmod.apply(v, *a, True, mutable=["batch_stats"]),
            v64, *x64)(v64, *x64)
        state = TrainState.create(params=v64["params"],
                                  batch_stats=v64["batch_stats"], tx=optax.sgd(1.0))
        batch = {"points": x64[0], "target": jnp.asarray(target)}
        step = make_train_step(jmod, _jax_loss(task), rot="aligned")
        rng = jax.random.PRNGKey(0)
        new_state, loss, _ = compile_once(step, state, batch, rng)(state, batch, rng)
        grads = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                             v64["params"], new_state.params)
        new_stats = flatten(jax.tree.map(np.asarray, dict(new_state.batch_stats)))

    t64 = _f64(from_flax(var))
    params = tree_map(lambda t: t.clone().requires_grad_(True), t64["params"])
    opt = torch.optim.SGD([v for _, v in sorted(flatten(params).items())], lr=0.0)
    state = PortState(params, t64["batch_stats"], opt, lambda step: 0.0)
    seen = []

    def apply(p, st, points, generator=None):
        s = Scope({"params": p, "batch_stats": st}, train=True)
        seen.append(fn(s, points))
        return seen[-1], s.new

    step = port_train_step(apply, lambda o, t: losses.model_loss(o, t, task == "cls"),
                           rot="aligned")
    ploss, _ = step(state, {"points": torch.from_numpy(inputs[0].astype(np.float64)),
                            "target": torch.from_numpy(target)},
                    torch.Generator().manual_seed(0))
    for g, w, what in zip(seen[0], out, ("logits", "trans_feat")):
        _close(g.detach().numpy(), np.asarray(w), 1e-9, what)
    np.testing.assert_allclose(ploss.item(), float(loss), rtol=1e-9)
    got_st = flatten(state.batch_stats)
    assert set(got_st) == set(new_stats)
    for path, w in new_stats.items():
        _close(got_st[path].numpy(), w, 1e-9, path)
    want_g = flatten(grads)
    got_g = {p: v.grad.numpy() for p, v in flatten(state.params).items()}
    assert set(got_g) == set(want_g)
    scale = max(np.abs(w).max() for w in want_g.values())
    for path, w in want_g.items():
        np.testing.assert_allclose(got_g[path], w, rtol=0, atol=1e-7 * scale,
                                   err_msg=path)
