"""BiPointNet's binarization primitives in the port
(``svnet_tpu_torch/nn/bipointnet_layers.py``, ``models/bipointnet.py``'s
``ema_max_offset``) against the JAX package's (CPU, small shapes).

The weights are flax ``init``'s, carried through ``from_flax``; every
comparison is in float64 on both sides (JAX with x64 enabled), where a
product of ±1 by ±1 times a float32 scale sums exactly and a sign near
zero does not hang on the order of a sum. Outputs and gradients (of a
seeded weighted sum of the outputs, with respect to every parameter and
the input) within rtol 1e-12 of the largest |value| (bitwise where no sum
lies between). Inputs hold exact 0 and ±1, where the quantizers' sign
and ``jnp.clip``'s gradient (1/2 at ±1) are decided.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnet_tpu.models import bipointnet as jbm
from svnet_tpu.nn import bipointnet_layers as jbl
from svnet_tpu_torch.models.bipointnet import ema_max_offset
from svnet_tpu_torch.nn import bipointnet_layers as bl
from svnet_tpu_torch.nn.scope import Scope, init_tree
from svnet_tpu_torch.train.steps import tree_map
from svnet_tpu_torch.utils.convert import flatten, from_flax, nest

RTOL = 1e-12
D_IN, FEATURES = 8, 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(seed, *shape):
    """Seeded normal values with exact 0, ±1 and ±2 planted among them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    flat = x.reshape(-1)
    flat[rng.choice(flat.size, 7, replace=False)] = [0.0, 1.0, -1.0, 0.0, 2.0,
                                                     -2.0, 1.0]
    return x


def _close(got, want, rtol=RTOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * (np.abs(want).max() + 1e-300),
                               err_msg=what)


def _flax_vars(module, x, plant=True):
    """flax ``init``'s float32 variables (as numpy), a kernel's first
    entries set to exact 0 and ±1 (``plant``)."""
    var = jax.tree.map(np.array, dict(module.init(jax.random.PRNGKey(3),
                                                  jnp.asarray(x, jnp.float32))))
    if plant and "kernel" in var["params"]:
        k = var["params"]["kernel"].reshape(-1)
        k[:4] = [0.0, 1.0, -1.0, 0.5]
    var.setdefault("batch_stats", {})
    return var


def _port_grads(fn, tree, x, c, train, **kw):
    """``fn(scope, x, **kw)``'s output and the gradients of sum(out * c)
    with respect to the parameters and x, in float64."""
    params = tree_map(lambda t: t.double().requires_grad_(True), tree["params"])
    stats = tree_map(torch.Tensor.double, tree["batch_stats"])
    xt = torch.tensor(x, dtype=torch.float64, requires_grad=True)
    s = Scope({"params": params, "batch_stats": stats}, train=train)
    out = fn(s, xt, **kw)
    (out * torch.from_numpy(c)).sum().backward()
    grads = {p: v.grad.numpy() for p, v in flatten(params).items()}
    return out.detach().numpy(), grads, xt.grad.numpy(), s


def _jax_grads(module, var, x, c, train):
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), var)
        x64 = jnp.asarray(x, jnp.float64)

        def f(params, x):
            out = module.apply({**v64, "params": params}, x, train)
            return jnp.sum(out * c), out

        (_, out), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
            v64["params"], x64)
        return (np.asarray(out), flatten(jax.tree.map(np.asarray, gp)),
                np.asarray(gx))


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", ["bi_quantize", "bi_quantize_identity",
                                  "bi_quantize_irnet"])
def test_quantizer(name, train):
    """Each quantizer's forward (sign, 0 at 0) and gradient at exact 0,
    ±1, ±2 and seeded values: bitwise JAX's."""
    x = np.concatenate([[-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0], _x(1, 25)])
    c = np.random.default_rng(2).standard_normal(x.shape)
    extra = (10.0, 0.1) if name == "bi_quantize_irnet" else ()
    jfn, pfn = getattr(jbl, name), getattr(bl, name)
    with jax.enable_x64(True):
        want, jvjp = jax.vjp(lambda v: jfn(v, *extra, train), jnp.asarray(x))
        want_g = jvjp(jnp.asarray(c))[0]
    xt = torch.tensor(x, requires_grad=True)
    got = pfn(xt, *extra, train)
    (got * torch.from_numpy(c)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    if train:
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g), rtol=1e-15,
                                   atol=0)
        if name == "bi_quantize":  # jnp.clip's tie at ±1 passes half
            np.testing.assert_array_equal(xt.grad.numpy()[[1, 5]], 0.5 * c[[1, 5]])


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", list(jbl.BI_LINEARS))
def test_bi_linear(name, train):
    """Every ``BI_LINEARS`` entry on (2, 5, 8) -> 6, eval and train: the
    output and the gradients of every parameter and of the input."""
    x = _x(4, 2, 5, D_IN)
    c = np.random.default_rng(5).standard_normal((2, 5, FEATURES))
    module = jbl.BI_LINEARS[name](FEATURES)
    var = _flax_vars(module, x)
    want, want_gp, want_gx = _jax_grads(module, var, x, c, train)
    got, got_gp, got_gx, _ = _port_grads(bl.BI_LINEARS[name], from_flax(var), x, c,
                                         train, features=FEATURES)
    _close(got, want, what="output")
    assert set(got_gp) == set(want_gp)
    for path, w in want_gp.items():
        _close(got_gp[path], w, what=path)
    _close(got_gx, want_gx, what="input")


@pytest.mark.parametrize("zero", [False, True])
def test_lsr_data_init_scale(zero):
    """``BiLinearLSR``'s scale drawn at init from the data: std(x @ w0) /
    std(sign(x) @ sign(w0)) (ddof 0) on a seeded batch; on an all-zero
    batch that is NaN and the fallback std(w0) / std(sign(w0)) is taken.
    The port redraws only the scale (``init_tree`` on a tree that holds
    JAX's kernel) in float64, against JAX's init with x64 enabled, which
    centres its float32 kernel in float32 (rtol 1e-6)."""
    x = np.zeros((2, 5, D_IN)) if zero else _x(6, 2, 5, D_IN)
    module = jbl.BiLinearLSR(FEATURES)
    with jax.enable_x64(True):
        var = jax.tree.map(np.asarray, dict(module.init(jax.random.PRNGKey(7),
                                                        jnp.asarray(x))))
    want = float(var["params"]["scale"])
    kernel = torch.from_numpy(np.asarray(var["params"]["kernel"], np.float64))
    tree = {"params": {"kernel": kernel}, "batch_stats": {}}
    init_tree(bl.bi_linear_lsr, (torch.from_numpy(x),), {"features": FEATURES}, None,
              tree)
    got = float(tree["params"]["scale"])
    assert tree["params"]["kernel"] is kernel  # kept, not redrawn
    w0 = var["params"]["kernel"] - var["params"]["kernel"].mean()
    fallback = np.std(w0) / np.std(np.sign(w0))
    assert (abs(want - fallback) < 1e-12 * fallback) == zero
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_mean_shift_two_train_steps():
    """``MeanShift`` over two train steps on 8 rows (an even count: the
    median is the mean of the two middle values), then eval: outputs,
    the running median and count after each step, the input's gradient."""
    xs = [_x(8 + i, 2, 4, 5) for i in range(2)] + [_x(10, 2, 3, 5)]
    c = np.random.default_rng(11).standard_normal((2, 4, 5))
    module = jbl.MeanShift()
    with jax.enable_x64(True):
        var = {"params": {}, **module.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))}
    tree = tree_map(torch.Tensor.double, from_flax(var))
    for step, x in enumerate(xs):
        train = step < 2
        with jax.enable_x64(True):
            if train:
                def f(v):
                    out, upd = module.apply(var, v, True, mutable=["batch_stats"])
                    return jnp.sum(out * c), (out, upd)

                (_, (want, upd)), want_gx = jax.value_and_grad(f, has_aux=True)(
                    jnp.asarray(x))
                var = {**var, **upd}
            else:
                want = module.apply(var, jnp.asarray(x), False)
        xt = torch.tensor(x, requires_grad=True)
        s = Scope(tree, train=train)
        got = bl.mean_shift(s, xt)
        _close(got.detach().numpy(), np.asarray(want), what=f"step {step}")
        if train:
            (got * torch.from_numpy(c)).sum().backward()
            _close(xt.grad.numpy(), np.asarray(want_gx), what=f"step {step} grad")
            tree = {"params": {}, "batch_stats": s.new}
            want_st = jax.tree.map(np.asarray, dict(var["batch_stats"]))
            _close(s.new["median"].numpy(), want_st["median"], what="median")
            assert float(s.new["num_track"]) == int(want_st["num_track"]) == step + 1


@pytest.mark.parametrize("padding", ["VALID", "SAME"])
@pytest.mark.parametrize("kernel_size,stride", [(1, 1), (1, 2), (3, 1), (3, 2),
                                                (4, 1), (4, 2)])
def test_bi_conv1d(kernel_size, stride, padding):
    """``BiConv1d`` on (2, 9, 5) -> 4 (SAME: the odd pad on the right),
    train mode: the output and the gradients of the kernel, the bias and
    the input; eval: the output."""
    x = _x(12, 2, 9, 5)
    module = jbl.BiConv1d(4, kernel_size, stride, padding)
    var = _flax_vars(module, x)
    kw = dict(features=4, kernel_size=kernel_size, stride=stride, padding=padding)
    n_out = -(-9 // stride) if padding == "SAME" else (9 - kernel_size) // stride + 1
    for train in (False, True):
        c = np.random.default_rng(13).standard_normal((2, n_out, 4))
        want, want_gp, want_gx = _jax_grads(module, var, x, c, train)
        got, got_gp, got_gx, _ = _port_grads(bl.bi_conv1d, from_flax(var), x, c,
                                             train, **kw)
        _close(got, want, what="output")
        for path, w in want_gp.items():
            _close(got_gp[path], w, what=path)
        _close(got_gx, want_gx, what="input")


def test_ema_max_offset():
    """The table at 1,024, 2,048 and 4,096 points and the log2
    interpolation off it (below, between and above the table)."""
    for n in (1024, 2048, 4096, 2, 64, 1000, 1500, 3000, 4097, 8192, 100000):
        assert ema_max_offset(n) == jbm.ema_max_offset(n), n


def test_flax_names_of_the_layers():
    """The port draws each layer's tree at flax's paths and shapes (LSR:
    kernel and scale, no bias; BiReal: the kernel alone; BiConv1d's
    (kernel_size, C, F) kernel)."""
    x = _x(14, 2, 5, D_IN)
    for name, fn in bl.BI_LINEARS.items():
        want = jax.eval_shape(lambda: jbl.BI_LINEARS[name](FEATURES).init(
            jax.random.PRNGKey(0), jnp.asarray(x, jnp.float32)))["params"]
        got = init_tree(fn, (torch.from_numpy(x).float(),), {"features": FEATURES},
                        None)["params"]
        assert {p: tuple(v.shape) for p, v in flatten(got).items()} == \
            {p: tuple(v.shape) for p, v in flatten(dict(want)).items()}, name
    got = init_tree(bl.bi_conv1d, (torch.from_numpy(x).float(),),
                    {"features": 4, "kernel_size": 3}, None)["params"]
    assert nest({p: tuple(v.shape) for p, v in flatten(got).items()}) == {
        "kernel": (3, D_IN, 4), "bias": (4,)}
