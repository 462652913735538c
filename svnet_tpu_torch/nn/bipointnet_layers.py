"""BiPointNet's binarization primitives (``--model bipointnet``;
counterpart of svnet_tpu/nn/bipointnet_layers.py): the straight-through
sign quantizers and the binary linears, each a function ``fn(scope, x,
features)`` of its flax-named weights (``nn/scope.py``; train mode is the
scope's), channels last.

The ±1 products are plain ``x @ w`` as in the JAX package (no kernel: the
XNOR-popcount product B9 is exact only on zero-free operands, and
``sign(0)`` is 0 here). Each quantizer is ``q + (sign(x) - q).detach()``,
as JAX writes it, so the gradients are the surrogate's; ``jnp.clip``'s
gradient is 1/2 at exactly ±1 (``lax.max``/``lax.min`` split a tie), and
``clip`` below keeps that. Standard deviations are the biased ones of
``jnp.std`` (``correction=0``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from svnet_tpu_torch.nn.scope import Scope, torch_linear_init


def clip(x: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(x, -1, 1)``: its gradient is 1 inside, 1/2 at ±1 (a tie
    of ``torch.maximum``/``torch.minimum`` is split, as in JAX), 0 outside."""
    one = x.new_tensor(1.0)
    return torch.minimum(torch.maximum(x, -one), one)


def bi_quantize(x: torch.Tensor, train: bool) -> torch.Tensor:
    """sign forward; straight-through gradient inside |x| <= 1."""
    if not train:
        return torch.sign(x)
    q = clip(x)
    return q + (torch.sign(x) - q).detach()


def bi_quantize_identity(x: torch.Tensor, train: bool) -> torch.Tensor:
    """sign forward; identity gradient."""
    if not train:
        return torch.sign(x)
    return x + (torch.sign(x) - x).detach()


def bi_quantize_irnet(x: torch.Tensor, k: float, t: float,
                      train: bool) -> torch.Tensor:
    """sign forward; k t (1 - tanh^2(x t)) surrogate gradient."""
    if not train:
        return torch.sign(x)
    q = k * torch.tanh(x * t)
    return q + (torch.sign(x) - q).detach()


def _kernel(s: Scope, x: torch.Tensor, features: int) -> torch.Tensor:
    d_in = x.shape[-1]
    return s.param("kernel", (d_in, features), torch_linear_init(d_in))


def _bias(s: Scope, y: torch.Tensor, d_in: int, features: int,
          use_bias: bool) -> torch.Tensor:
    if not use_bias:
        return y
    return y + s.param("bias", (features,), torch_linear_init(d_in))


def bi_linear(s: Scope, x: torch.Tensor, features: int, binary_act: bool = True,
              use_bias: bool = True) -> torch.Tensor:
    """sign(w), sign(a), a real bias."""
    w = bi_quantize(_kernel(s, x, features), s.train)
    a = bi_quantize(x, s.train) if binary_act else x
    return _bias(s, a @ w, x.shape[-1], features, use_bias)


def bi_linear_xnor(s: Scope, x: torch.Tensor, features: int,
                   binary_act: bool = True, use_bias: bool = True) -> torch.Tensor:
    """XNOR-Net: each output column centred, then its sign times its mean
    |w|; the activations' sign times their mean |a| per point. The scales
    are detached."""
    kernel = _kernel(s, x, features)
    w = kernel - kernel.mean(dim=0, keepdim=True)
    sw = w.abs().mean(dim=0, keepdim=True).detach()
    w = bi_quantize(w, s.train) * sw
    a = x
    if binary_act:
        a = bi_quantize(a, s.train) * a.abs().mean(dim=-1, keepdim=True).detach()
    return _bias(s, a @ w, x.shape[-1], features, use_bias)


def _lsr_scale(x: torch.Tensor, w0: torch.Tensor):
    """The LSR scale drawn at init from the data the layer sees:
    std(x @ w0) / std(sign(x) @ sign(w0)), or std(w0) / std(sign(w0))
    where that is NaN."""
    def draw(shape, generator):
        xf = x.reshape(-1, x.shape[-1])
        num = torch.std(xf @ w0, correction=0)
        den = torch.std(torch.sign(xf) @ torch.sign(w0), correction=0)
        ratio = num / den
        fallback = torch.std(w0, correction=0) / torch.std(torch.sign(w0),
                                                           correction=0)
        return torch.where(torch.isnan(ratio), fallback, ratio)

    return draw


def bi_linear_lsr(s: Scope, x: torch.Tensor, features: int,
                  binary_act: bool = True) -> torch.Tensor:
    """Learned-scale binary linear (the exported BiPointNet config): the
    kernel centred on its global mean, signed, times the scalar ``scale``
    (drawn at init from the data, ``_lsr_scale``); no bias."""
    kernel = _kernel(s, x, features)
    w0 = kernel - kernel.mean()
    scale = s.param("scale", (), _lsr_scale(x, w0))
    w = bi_quantize(w0, s.train) * scale
    a = bi_quantize(x, s.train) if binary_act else x
    return a @ w


def bi_linear_bireal(s: Scope, x: torch.Tensor, features: int,
                     binary_act: bool = True) -> torch.Tensor:
    """Bi-Real-Net: the activations' sign with the piecewise-polynomial
    gradient (always, whatever ``binary_act`` says, as in the reference),
    the weights' sign times each column's mean |w| with the clipped
    gradient; no bias."""
    del binary_act
    kernel = _kernel(s, x, features)
    m1, m2, m3 = ((x < c).to(x.dtype) for c in (-1, 0, 1))
    out1 = -1 * m1 + (x * x + 2 * x) * (1 - m1)
    out2 = out1 * m2 + (-x * x + 2 * x) * (1 - m2)
    out3 = out2 * m3 + 1 * (1 - m3)
    a = out3 + (torch.sign(x) - out3).detach()
    sw = kernel.abs().mean(dim=0, keepdim=True).detach()
    q = clip(kernel)
    w = q + (sw * torch.sign(kernel) - q).detach()
    return a @ w


def bi_linear_irnet(s: Scope, x: torch.Tensor, features: int,
                    binary_act: bool = True, use_bias: bool = True,
                    k: float = 10.0, t: float = 0.1) -> torch.Tensor:
    """IR-Net: each column standardized, signed through the tanh
    surrogate, times the power of two nearest its mean |w| (round half to
    even, as ``jnp.round``)."""
    kernel = _kernel(s, x, features)
    w = kernel - kernel.mean(dim=0, keepdim=True)
    w = w / torch.std(w, dim=0, keepdim=True, correction=0)
    sw = torch.exp2(torch.round(torch.log2(w.abs().mean(dim=0, keepdim=True))))
    w = bi_quantize_irnet(w, k, t, s.train) * sw.detach()
    a = bi_quantize_irnet(x, k, t, s.train) if binary_act else x
    return _bias(s, a @ w, x.shape[-1], features, use_bias)


def _median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` over axis 0: the mean of the two middle values when
    the count is even (``torch.median`` takes the lower one)."""
    v = torch.sort(x, dim=0).values
    n = v.shape[0]
    return (v[(n - 1) // 2] + v[n // 2]) * 0.5


def mean_shift(s: Scope, x: torch.Tensor) -> torch.Tensor:
    """Running-median centring: in train mode the running median (1, C)
    moves to the cumulative mean of the batch medians first (``num_track``
    batches so far), then ``x - median``."""
    c = x.shape[-1]
    median = s.stat("median", 0.0, (1, c))
    num = s.stat("num_track", 0, ())
    if s.train:
        n = num.to(x.dtype)
        median = (median * n + _median(x.reshape(-1, c))[None]) / (n + 1)
        s.record({"median": median.detach(), "num_track": num + 1})
    return x - median


def _same_pad(length: int, kernel_size: int, stride: int) -> tuple:
    """JAX's 'SAME' padding (low, high): the odd one on the right."""
    out = -(-length // stride)
    total = max((out - 1) * stride + kernel_size - length, 0)
    return total // 2, total - total // 2


def bi_conv1d(s: Scope, x: torch.Tensor, features: int, kernel_size: int = 1,
              stride: int = 1, padding: str = "VALID",
              use_bias: bool = True) -> torch.Tensor:
    """Binary 1-D convolution over (B, L, C) -> (B, L', features): the
    kernel (kernel_size, C, features) centred on its global mean and
    signed, the activations signed; the bias drawn as a linear's of C
    inputs (not C * kernel_size), as in the JAX package."""
    d_in = x.shape[-1]
    kernel = s.param("kernel", (kernel_size, d_in, features),
                     torch_linear_init(d_in * kernel_size))
    w = bi_quantize(kernel - kernel.mean(), s.train)
    a = bi_quantize(x, s.train).transpose(1, 2)  # (B, C, L)
    if padding == "SAME":
        a = F.pad(a, _same_pad(a.shape[-1], kernel_size, stride))
    elif padding != "VALID":
        raise ValueError(f"unknown padding {padding!r}")
    y = F.conv1d(a, w.permute(2, 1, 0), stride=stride).transpose(1, 2)
    return _bias(s, y, d_in, features, use_bias)


BI_LINEARS = {
    "BiLinear": bi_linear,
    "BiLinearXNOR": bi_linear_xnor,
    "BiLinearABC": bi_linear_xnor,
    "BiLinearLSR": bi_linear_lsr,
    "BiLinearBiReal": bi_linear_bireal,
    "BiLinearIRNet": bi_linear_irnet,
}
