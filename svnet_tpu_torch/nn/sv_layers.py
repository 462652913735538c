"""SV (scalar/vector) layer library, eval mode (counterpart of
svnet_tpu/nn/sv_layers.py:77-357).

Parameter and buffer names follow the flax tree exactly, so a module's
``state_dict`` key is the flax path joined by dots (``linear1.kernel``,
``bn1.bn.mean``) and kernels are stored ``(in, out)``. Binarized layers
use ``torch.sign``, which is 0 at 0 like ``jnp.sign``.

Layouts are channels-last: s (B, N, [k,] S), v (B, N, [k,] 3, V).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from svnet_tpu_torch.config import BN_EPS, EPS


def binary_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Product of ±1 (or 0) operands (``_binary_matmul_eval``). An f32
    matmul is exact here: every partial sum is an integer below 2^24."""
    return x @ w


CLIP = 1.2  # the STE passes the sign's gradient where |x| <= CLIP


class _SteSign(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.sign(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (torch.abs(x) <= CLIP).to(g.dtype)


def ste_sign(x: torch.Tensor) -> torch.Tensor:
    """Straight-through sign for training: forward ``sign(x)`` (0 at 0),
    backward the gradient of ``clip(x, -1.2, 1.2)``."""
    return _SteSign.apply(x)


def _uniform(shape, bound, generator):
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


class Linear(nn.Module):
    """Binarizable dense layer: ``bw`` signs the weights, ``ba`` signs
    ``x + beta``; a binarized layer scales its output by ``scale``."""

    def __init__(self, d_in: int, features: int, use_bias: bool = True,
                 bw: bool = False, ba: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.bw, self.ba = bw, ba
        bound = 1.0 / math.sqrt(d_in)
        self.kernel = nn.Parameter(_uniform((d_in, features), bound, generator))
        if ba:
            self.beta = nn.Parameter(torch.zeros(d_in))
        if bw or ba:
            self.scale = nn.Parameter(torch.full((features,), bound))
        if use_bias:
            self.bias = nn.Parameter(_uniform((features,), bound, generator))
        else:
            self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.bw or self.ba):
            y = x @ self.kernel
        else:
            if self.ba:
                x = torch.sign(x + self.beta)
            w = torch.sign(self.kernel) if self.bw else self.kernel
            y = (binary_matmul(x, w) if self.ba and self.bw else x @ w) * self.scale
        if self.bias is not None:
            y = y + self.bias
        return y


class _BN(nn.Module):
    """Eval BatchNorm over the last axis: flax ``nn.BatchNorm`` leaves."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.var + BN_EPS) * self.scale
        return (x - self.mean) * mul + self.bias


class BatchNorm(nn.Module):
    """svl.BatchNorm: the flax wrapper whose leaves sit under ``bn``."""

    def __init__(self, features: int):
        super().__init__()
        self.bn = _BN(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(x)


class VectorBN(nn.Module):
    """BN of the vector norms: ``v / (|v| + EPS) * BN(|v| + EPS)``."""

    def __init__(self, features: int):
        super().__init__()
        self.bn = _BN(features)

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        nsq = torch.clamp(torch.sum(v * v, dim=-2), min=1e-12)
        norm = torch.sqrt(nsq) + EPS
        return v / norm[..., None, :] * self.bn(norm)[..., None, :]


class Vector2Scalar(nn.Module):
    """Invariants ``s = v^T z`` with the frame ``z = Linear(v)``; output
    flattened channel-major (..., V * multi)."""

    def __init__(self, d_in: int, multi: int, bw: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.linear = Linear(d_in, multi, use_bias=False, bw=bw,
                             generator=generator)

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        return v2s_invariants(v, self.linear(v))


def v2s_invariants(v: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``s[..., c, j] = sum_i v[..., i, c] * z[..., i, j]`` for v (..., 3, V)
    and a frame z (..., 3, multi), flattened c-major to (..., V * multi)."""
    s = sum(v[..., i, :, None] * z[..., i, None, :] for i in range(3))
    return s.reshape(s.shape[:-2] + (-1,))


class SVBlock(nn.Module):
    """SE gate from the mean input scalars, scalar path
    [s, v2s(v)] -> Linear -> BN -> leaky 0.2, vector path
    Linear -> VectorBN -> * gate."""

    def __init__(self, in_s: int, in_v: int, out_s: int, out_v: int,
                 binary: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.gate_fc1 = Linear(in_s, out_v // 2, use_bias=False, generator=g)
        self.gate_fc2 = Linear(out_v // 2, out_v, use_bias=False, generator=g)
        self.v2s = Vector2Scalar(in_v, 3, bw=binary, generator=g)
        self.linear1 = Linear(in_s + 3 * in_v, out_s, use_bias=False,
                              bw=binary, ba=binary, generator=g)
        self.bn1 = BatchNorm(out_s)
        self.linear2 = Linear(in_v, out_v, use_bias=False, bw=binary,
                              generator=g)
        self.bn2 = VectorBN(out_v)

    def forward(self, x):
        s, v = x
        B = s.shape[0]
        s_mean = torch.mean(s.reshape(B, -1, s.shape[-1]), dim=1)
        g = torch.sigmoid(self.gate_fc2(torch.relu(self.gate_fc1(s_mean))))
        g = g.reshape((B,) + (1,) * (v.ndim - 2) + (g.shape[-1],))

        s = torch.cat([s, self.v2s(v)], dim=-1)
        s = nn.functional.leaky_relu(self.bn1(self.linear1(s)), 0.2)
        v = self.bn2(self.linear2(v))
        return s, v * g


class SVFuse(nn.Module):
    """Terminal fusion: ``[s, Vector2Scalar(v)]``."""

    def __init__(self, in_v: int, multi: int = 3, binary: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.v2s = Vector2Scalar(in_v, multi, bw=binary, generator=generator)

    def forward(self, x):
        s, v = x
        return torch.cat([s, self.v2s(v)], dim=-1)
