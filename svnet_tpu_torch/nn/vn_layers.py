"""Vector-Neuron layers (counterpart of svnet_tpu/nn/vn_layers.py), as
functions of a ``nn.scope.Scope``: one definition for init, eval and
train mode, named as the flax modules name their leaves.

Layout: vectors v (B, N, [k,] 3, C); channel mixing is a product over the
last axis.
"""

from __future__ import annotations

import torch

from svnet_tpu_torch.config import EPS
from svnet_tpu_torch.nn.scope import Scope, batch_norm, torch_linear_init


def vn_linear(s: Scope, x: torch.Tensor, features: int) -> torch.Tensor:
    """VNLinear: ``x @ kernel`` over the channel axis."""
    d_in = x.shape[-1]
    return x @ s.param("kernel", (d_in, features), torch_linear_init(d_in))


def _reflect(p: torch.Tensor, d: torch.Tensor, slope: float) -> torch.Tensor:
    """Where <p, d> < 0 remove p's component along d, blended with slope."""
    dot = torch.sum(p * d, dim=-2, keepdim=True)
    d_sq = torch.sum(d * d, dim=-2, keepdim=True)
    mask = (dot >= 0).to(p.dtype)
    reflected = p - (dot / (d_sq + EPS)) * d
    return slope * p + (1 - slope) * (mask * p + (1 - mask) * reflected)


def vn_leaky_relu(s: Scope, x: torch.Tensor, slope: float = 0.2,
                  share: bool = False) -> torch.Tensor:
    """VNLeakyReLU: the direction d = map_to_dir(x), one per channel (or
    one shared)."""
    d = vn_linear(s.child("map_to_dir"), x, 1 if share else x.shape[-1])
    return _reflect(x, d, slope)


def vn_batch_norm(s: Scope, x: torch.Tensor) -> torch.Tensor:
    """VNBatchNorm: BatchNorm of the vector norms (floored at 1e-12 before
    the sqrt, plus EPS), directions kept."""
    norm = torch.sqrt(torch.clamp(torch.sum(x * x, dim=-2), min=1e-12)) + EPS
    norm_bn = batch_norm(s, norm)
    return x / norm[..., None, :] * norm_bn[..., None, :]


def vn_linear_leaky_relu(s: Scope, x: torch.Tensor, features: int,
                         slope: float = 0.2, share: bool = False,
                         use_batchnorm: bool = True) -> torch.Tensor:
    """VNLinearLeakyReLU: p = map_to_feat(x) (then VNBatchNorm), the
    direction from the input x, the reflection on p."""
    p = vn_linear(s.child("map_to_feat"), x, features)
    if use_batchnorm:
        p = vn_batch_norm(s.child("batchnorm"), p)
    d = vn_linear(s.child("map_to_dir"), x, 1 if share else features)
    return _reflect(p, d, slope)


def vn_linear_and_leaky_relu(s: Scope, x: torch.Tensor, features: int,
                             slope: float = 0.2, share: bool = False,
                             use_batchnorm: str = "norm") -> torch.Tensor:
    """VNLinearAndLeakyReLU: linear, VNBatchNorm unless ``"none"``, then
    VNLeakyReLU on the result."""
    x = vn_linear(s.child("linear"), x, features)
    if use_batchnorm != "none":
        x = vn_batch_norm(s.child("batchnorm"), x)
    return vn_leaky_relu(s.child("leaky_relu"), x, slope, share)


def vn_max_pool(s: Scope, x: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """VNMaxPool over ``axis`` of (B, N, [k,] 3, C): per channel the entry
    of largest <x, d> (the first on ties, as ``jnp.argmax``)."""
    d = vn_linear(s.child("map_to_dir"), x, x.shape[-1])
    dot = torch.sum(x * d, dim=-2)
    idx = torch.argmax(dot, dim=axis, keepdim=True).unsqueeze(-2)
    idx = idx.expand(x.shape[:axis] + (1,) + x.shape[axis + 1:])
    return torch.gather(x, axis, idx).squeeze(axis)


def mean_pool(x: torch.Tensor, axis: int = 1, keepdim: bool = False) -> torch.Tensor:
    return torch.mean(x, dim=axis, keepdim=keepdim)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def vn_std_feature(s: Scope, x: torch.Tensor, slope: float = 0.2,
                   share: bool = False, normalize_frame: bool = False):
    """VNStdFeature: a frame z0 (..., 3, 3) learned from x (C // 2 then
    C // 4 channels), and the invariants ``x_std[..., j, c] = sum_i
    x[..., i, c] z0[..., i, j]``. ``normalize_frame`` orthonormalizes two
    learned directions (Gram-Schmidt) and completes them by their cross
    product. Returns (x_std, z0)."""
    C = x.shape[-1]
    z = vn_linear_leaky_relu(s.child("vn1"), x, C // 2, slope, share)
    z = vn_linear_leaky_relu(s.child("vn2"), z, C // 4, slope, share)
    z0 = vn_linear(s.child("vn_lin"), z, 2 if normalize_frame else 3)
    if normalize_frame:
        v1 = z0[..., 0]
        u1 = v1 / (_norm(v1) + EPS)
        v2 = z0[..., 1]
        v2 = v2 - torch.sum(v2 * u1, dim=-1, keepdim=True) * u1
        u2 = v2 / (_norm(v2) + EPS)
        z0 = torch.stack([u1, u2, torch.linalg.cross(u1, u2, dim=-1)], dim=-1)
    return torch.einsum("...ic,...ij->...jc", x, z0), z0


def vn_stnkd(s: Scope, x: torch.Tensor, d: int = 21,
             pooling: str = "mean") -> torch.Tensor:
    """VN_STNkd: (B, N, 3, C) -> a global (B, 3, d) token."""
    for name, f in (("conv1", 64 // 3), ("conv2", 128 // 3), ("conv3", 1024 // 3)):
        x = vn_linear_leaky_relu(s.child(name), x, f, slope=0.0)
    x = vn_max_pool(s.child("pool"), x, 1) if pooling == "max" else mean_pool(x, 1)
    for name, f in (("fc1", 512 // 3), ("fc2", 256 // 3)):
        x = vn_linear_leaky_relu(s.child(name), x, f, slope=0.0)
    return vn_linear(s.child("fc3"), x, d)
