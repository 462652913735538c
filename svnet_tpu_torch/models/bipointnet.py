"""BiPointNet, the binarization baseline (``--model bipointnet``;
counterpart of svnet_tpu/models/bipointnet.py): the binary T-Nets
(``bi_stnkd``) with pool max, mean or ema-max, the encoder, and the
classification, part- and semantic-segmentation heads, each one function
of its flax-named weights (``nn/scope.py``) behind an eager eval model;
``BiPointNetLSREMax`` and ``BiPointNetPartSegLSREMax`` are the exported
configurations (LSR linears, ema-max). Every model returns (logits,
trans_feat) for the T-Net regularizer (``train.losses.model_loss``).

The LSR linears draw their ``scale`` from the data at init
(``ScopedModel.init_on``; ``data_init``): the trainers init on their first
test batch, as the JAX trainers do. Hard-tanh is a ``clamp``, whose
gradient at exactly ±1 is 1, as ``jax.nn.hard_tanh``'s (``F.hardtanh``
gives 0 there; ROADMAP C27). No kernel lies on this path: the ±1 products
are ``torch.matmul``, as the JAX package's are plain XLA products.
"""

from __future__ import annotations

import math

import torch

from svnet_tpu_torch.nn.bipointnet_layers import BI_LINEARS
from svnet_tpu_torch.nn import scope as sc
from svnet_tpu_torch.nn.scope import Scope, ScopedModel, batch_norm

OFFSET_MAP = {1024: -3.2041, 2048: -3.4025, 4096: -3.5836}


def ema_max_offset(n: int) -> float:
    """The EMA-max offset for n points: the table at 1,024, 2,048 and
    4,096 points, else piecewise linear in log2(n) through it (extended
    by the end segments)."""
    if n in OFFSET_MAP:
        return OFFSET_MAP[n]
    xs, ys = [10.0, 11.0, 12.0], [-3.2041, -3.4025, -3.5836]
    x = math.log2(n)
    lo, hi = (0, 1) if x < xs[1] else (1, 2)
    t = (x - xs[lo]) / (xs[hi] - xs[lo])
    return ys[lo] + t * (ys[hi] - ys[lo])


def pool_points(x: torch.Tensor, how: str, dim: int = 1) -> torch.Tensor:
    """Max (also ema-max's, whose offset the caller adds) or mean over
    the points."""
    if how in ("max", "ema-max"):
        return torch.amax(x, dim=dim)
    if how == "mean":
        return torch.mean(x, dim=dim)
    raise ValueError(f"unknown pool {how!r}")


def fp_linear(s: Scope, x: torch.Tensor, features: int) -> torch.Tensor:
    """A full-precision linear under ``lin`` (the Bi linears' calling
    convention; its tree path is ``<name>/lin/lin/kernel``)."""
    return sc.linear(s.child("lin"), x, features)


def conv_bn_ht(s: Scope, x: torch.Tensor, features: int, lin,
               affine: bool = True) -> torch.Tensor:
    """A pointwise linear ``lin`` under ``lin``, BatchNorm (``affine=False``:
    no scale or bias) and hard-tanh."""
    x = batch_norm(s, lin(s.child("lin"), x, features), affine)
    return torch.clamp(x, -1.0, 1.0)


def _global(s: Scope, x: torch.Tensor, lin, name: str, features: int,
            how: str) -> torch.Tensor:
    """``<name>_lin`` and ``<name>_bn``, then the pool over the points
    (ema-max: the max, then the offset of N)."""
    n = x.shape[1]
    x = batch_norm(s.child(f"{name}_bn"), lin(s.child(f"{name}_lin"), x, features))
    if how == "ema-max":
        return torch.amax(x, dim=1) + ema_max_offset(n)
    return pool_points(x, how)


def bi_stnkd(s: Scope, x: torch.Tensor, k: int = 3, lin=BI_LINEARS["BiLinearLSR"],
             how: str = "max", affine: bool = True,
             bi_first: bool = False) -> torch.Tensor:
    """The binary T-Net: (B, N, C) -> (B, k, k), the identity added. Its
    first linear is full precision only for k = 3 without ``bi_first``;
    ema-max puts the offset inside the max."""
    B, n = x.shape[:2]
    first = fp_linear if k == 3 and not bi_first else lin
    x = conv_bn_ht(s.child("conv1"), x, 64, first, affine)
    x = conv_bn_ht(s.child("conv2"), x, 128, lin, affine)
    if how == "ema-max":
        x = batch_norm(s.child("conv3_bn"), lin(s.child("conv3_lin"), x, 1024))
        x = torch.amax(x + ema_max_offset(n), dim=1)
    else:
        x = pool_points(conv_bn_ht(s.child("conv3"), x, 1024, lin, affine), how)
    x = conv_bn_ht(s.child("fc1"), x, 512, lin, affine)
    x = conv_bn_ht(s.child("fc2"), x, 256, lin, affine)
    x = lin(s.child("fc3"), x, k * k)
    x = x + torch.eye(k, dtype=x.dtype, device=x.device).reshape(-1)
    return x.reshape(B, k, k)


def _transform(x: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bni,bij->bnj", x, trans)


def bi_encoder(s: Scope, points: torch.Tensor, lin=BI_LINEARS["BiLinearLSR"],
               how: str = "ema-max", affine: bool = True, tnet: bool = True,
               bi_first: bool = False):
    """BiPointNetEncoder: (B, N, 3) -> (global (B, 1024), trans,
    trans_feat); without ``tnet`` both transforms are None."""
    trans = trans_feat = None
    x = points
    if tnet:
        trans = bi_stnkd(s.child("stn"), points, 3, lin, how, affine, bi_first)
        x = _transform(points, trans)
    x = conv_bn_ht(s.child("conv1"), x, 64, lin if bi_first else fp_linear, affine)
    if tnet:
        trans_feat = bi_stnkd(s.child("fstn"), x, 64, lin, how, affine, bi_first)
        x = _transform(x, trans_feat)
    x = conv_bn_ht(s.child("conv2"), x, 128, lin, affine)
    return _global(s, x, lin, "conv3", 1024, how), trans, trans_feat


def bipointnet_cls(s: Scope, points: torch.Tensor, num_classes: int = 40,
                   k: int = 20, linear: str = "BiLinearLSR", pool: str = "ema-max",
                   affine: bool = True):
    """BiPointNet_CLS: the encoder, fc1 and fc2 (binary, BN, hard-tanh),
    a full-precision fc3. ``k`` is unused (the zoo's uniform
    constructor)."""
    del k
    lin = BI_LINEARS[linear]
    x, _, trans_feat = bi_encoder(s.child("feat"), points, lin, pool, affine)
    x = conv_bn_ht(s.child("fc1"), x, 512, lin, affine)
    x = conv_bn_ht(s.child("fc2"), x, 256, lin, affine)
    return sc.linear(s.child("fc3"), x, num_classes), trans_feat


def bipointnet_pseg(s: Scope, points: torch.Tensor, label: torch.Tensor,
                    num_part: int = 50, k: int = 40, linear: str = "BiLinearLSR",
                    pool: str = "ema-max", affine: bool = True):
    """BiPointNet_PSEG: the input T-Net, conv1 (full precision) to conv3,
    the feature T-Net (128), conv4, conv5 and its pool beside the one-hot
    label, every layer's features per point, convs1-3 and a
    full-precision convs4. ``k`` is unused."""
    del k
    lin = BI_LINEARS[linear]
    B, n = points.shape[:2]
    trans = bi_stnkd(s.child("stn"), points, 3, lin, pool, affine)
    out1 = conv_bn_ht(s.child("conv1"), _transform(points, trans), 64, fp_linear,
                      affine)
    out2 = conv_bn_ht(s.child("conv2"), out1, 128, lin, affine)
    out3 = conv_bn_ht(s.child("conv3"), out2, 128, lin, affine)
    trans_feat = bi_stnkd(s.child("fstn"), out3, 128, lin, pool, affine)
    out4 = conv_bn_ht(s.child("conv4"), _transform(out3, trans_feat), 512, lin,
                      affine)
    out5 = batch_norm(s.child("conv5_bn"), lin(s.child("conv5_lin"), out4, 2048))
    g = torch.amax(out5, dim=1) + ema_max_offset(n) if pool == "ema-max" \
        else pool_points(out5, pool)
    expand = torch.cat([g, label], dim=-1)[:, None].expand(B, n, -1)
    net = torch.cat([expand, out1, out2, out3, out4, out5], dim=-1)
    for name, f in (("convs1", 256), ("convs2", 256), ("convs3", 128)):
        net = conv_bn_ht(s.child(name), net, f, lin, affine)
    return sc.linear(s.child("convs4"), net, num_part), trans_feat


def bipointnet_semseg(s: Scope, points: torch.Tensor, num_classes: int = 13,
                      linear: str = "BiLinearLSR", pool: str = "ema-max",
                      affine: bool = True):
    """BiPointNet_SEMSEG: points (B, N, 3 + features) -> per-point logits.
    The input T-Net sees the xyz only; its transform's output joins the
    features before conv1 (full precision); the feature T-Net (64), conv2,
    conv3 and its pool, broadcast beside the transformed conv1 features
    (1,088 wide), convs1-3 and a full-precision convs4."""
    lin = BI_LINEARS[linear]
    B, n = points.shape[:2]
    xyz = points[..., :3]
    x = _transform(xyz, bi_stnkd(s.child("stn"), xyz, 3, lin, pool, affine))
    if points.shape[-1] > 3:
        x = torch.cat([x, points[..., 3:]], dim=-1)
    x = conv_bn_ht(s.child("conv1"), x, 64, fp_linear, affine)
    trans_feat = bi_stnkd(s.child("fstn"), x, 64, lin, pool, affine)
    pointfeat = _transform(x, trans_feat)
    x = conv_bn_ht(s.child("conv2"), pointfeat, 128, lin, affine)
    g = _global(s, x, lin, "conv3", 1024, pool)
    x = torch.cat([g[:, None].expand(B, n, -1), pointfeat], dim=-1)
    for name, f in (("convs1", 512), ("convs2", 256), ("convs3", 128)):
        x = conv_bn_ht(s.child(name), x, f, lin, affine)
    return sc.linear(s.child("convs4"), x, num_classes), trans_feat


class BiPointNetCls(ScopedModel):
    """Eager eval BiPointNet_CLS: (B, N, 3) -> ((B, num_classes), (B, 64,
    64))."""

    forward_fn = bipointnet_cls
    data_init = True

    def __init__(self, num_classes: int = 40, k: int = 20,
                 linear: str = "BiLinearLSR", pool: str = "ema-max",
                 affine: bool = True, generator: torch.Generator | None = None):
        super().__init__(generator, num_classes=num_classes, k=k, linear=linear,
                         pool=pool, affine=affine)


class BiPointNetPseg(ScopedModel):
    """Eager eval BiPointNet_PSEG: (B, N, 3), (B, 16) -> ((B, N, num_part),
    (B, 128, 128))."""

    forward_fn = bipointnet_pseg
    with_label = True
    data_init = True

    def __init__(self, num_part: int = 50, k: int = 40,
                 linear: str = "BiLinearLSR", pool: str = "ema-max",
                 affine: bool = True, generator: torch.Generator | None = None):
        super().__init__(generator, num_part=num_part, k=k, linear=linear,
                         pool=pool, affine=affine)


class BiPointNetSemseg(ScopedModel):
    """Eager eval BiPointNet_SEMSEG: (B, N, 9) S3DIS points -> ((B, N,
    num_classes), (B, 64, 64))."""

    forward_fn = bipointnet_semseg
    in_channels = 9
    data_init = True

    def __init__(self, num_classes: int = 13, linear: str = "BiLinearLSR",
                 pool: str = "ema-max", affine: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__(generator, num_classes=num_classes, linear=linear,
                         pool=pool, affine=affine)


def BiPointNetLSREMax(num_classes: int = 40, **kw) -> BiPointNetCls:
    """The exported classifier: LSR linears, ema-max."""
    return BiPointNetCls(num_classes, linear="BiLinearLSR", pool="ema-max", **kw)


def BiPointNetPartSegLSREMax(num_part: int = 50, **kw) -> BiPointNetPseg:
    """The exported part segmenter: LSR linears, ema-max."""
    return BiPointNetPseg(num_part, linear="BiLinearLSR", pool="ema-max", **kw)
