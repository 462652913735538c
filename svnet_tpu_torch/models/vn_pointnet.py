"""Vector-Neuron PointNet classifier and part segmenter (``--model vn``;
counterparts of svnet_tpu/models/vn_pointnet.py), each one function of
its weights (``nn/scope.py``) behind an eager eval model.

One kNN graph over the coordinates (kernel B4 on the card) with a
cross-product edge channel, gathered by kernel B7; the rest is torch.
"""

from __future__ import annotations

import torch

from svnet_tpu_torch import ops
from svnet_tpu_torch.nn import vn_layers as vnl
from svnet_tpu_torch.nn.scope import Scope, ScopedModel, batch_norm, dropout, linear


def _pool_k(s: Scope, x: torch.Tensor, pooling: str) -> torch.Tensor:
    if pooling == "max":
        return vnl.vn_max_pool(s.child("pool"), x, 2)
    return vnl.mean_pool(x, 2)


def _first(s: Scope, points: torch.Tensor, k: int, pooling: str) -> torch.Tensor:
    """Cross edges (B, N, k, 3, 3), conv_pos, the pool over k."""
    feat = ops.get_graph_feature_cross(points, k, plain=s.plain)
    x = vnl.vn_linear_leaky_relu(s.child("conv_pos"), feat, 64 // 3, slope=0.0)
    return _pool_k(s, x, pooling)


def _token(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return torch.cat([like, x[:, None].expand_as(like)], dim=-1)


def _mean_cat(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.mean(x, dim=1, keepdim=True).expand_as(x)], dim=-1)


def vn_pointnet_encoder(s: Scope, points: torch.Tensor, k: int = 20,
                        pooling: str = "mean") -> torch.Tensor:
    """VNPointNetEncoder: (B, N, 3) -> (B, 1024 // 3 * 6) invariants."""
    B, N = points.shape[:2]
    x = vnl.vn_linear_leaky_relu(s.child("conv1"), _first(s, points, k, pooling),
                                 64 // 3, slope=0.0)
    x = _token(vnl.vn_stnkd(s.child("fstn"), x, 64 // 3, pooling), x)
    x = vnl.vn_linear_leaky_relu(s.child("conv2"), x, 128 // 3, slope=0.0)
    x = vnl.vn_batch_norm(s.child("bn3"), vnl.vn_linear(s.child("conv3"), x, 1024 // 3))
    x, _ = vnl.vn_std_feature(s.child("std_feature"), _mean_cat(x), slope=0.0)
    return torch.amax(x.reshape(B, N, -1), dim=1)


def vn_pointnet_cls(s: Scope, points: torch.Tensor, num_classes: int = 40,
                    k: int = 20, pooling: str = "mean") -> torch.Tensor:
    """VN_PointNet_CLS: the encoder, fc1/bn1/relu, fc2/dropout 0.4/bn2/relu,
    fc3."""
    x = vn_pointnet_encoder(s.child("feat"), points, k, pooling)
    x = torch.relu(batch_norm(s.child("bn1"), linear(s.child("fc1"), x, 512)))
    x = dropout(s, linear(s.child("fc2"), x, 256), 0.4)
    x = torch.relu(batch_norm(s.child("bn2"), x))
    return linear(s.child("fc3"), x, num_classes)


def vn_pointnet_pseg(s: Scope, points: torch.Tensor, label: torch.Tensor,
                     num_part: int = 50, k: int = 40,
                     pooling: str = "mean") -> torch.Tensor:
    """VN_PointNet_PSEG: conv1-3, the VN_STNkd token on conv3, conv4, conv5
    and its norm BN, VNStdFeature on [conv5 | its mean] whose frame
    un-projects the skip vectors of conv1-4; the max over the points
    beside the (B, 16) label; convs1-4 per point."""
    B, N = points.shape[:2]
    x = _first(s, points, k, pooling)
    out1 = vnl.vn_linear_leaky_relu(s.child("conv1"), x, 64 // 3, slope=0.0)
    out2 = vnl.vn_linear_leaky_relu(s.child("conv2"), out1, 128 // 3, slope=0.0)
    out3 = vnl.vn_linear_leaky_relu(s.child("conv3"), out2, 128 // 3, slope=0.0)
    net = _token(vnl.vn_stnkd(s.child("fstn"), out3, 128 // 3, pooling), out3)
    out4 = vnl.vn_linear_leaky_relu(s.child("conv4"), net, 512 // 3, slope=0.0)
    out5 = vnl.vn_batch_norm(s.child("bn5"),
                             vnl.vn_linear(s.child("conv5"), out4, 2048 // 3))
    out5_std, trans = vnl.vn_std_feature(s.child("std_feature"), _mean_cat(out5),
                                         slope=0.0)
    out5_std = out5_std.reshape(B, N, -1)
    expand = torch.cat([torch.amax(out5_std, dim=1), label], dim=-1)
    out1234 = torch.cat([out1, out2, out3, out4], dim=-1)
    out1234 = torch.einsum("bnic,bnij->bnjc", out1234, trans).reshape(B, N, -1)
    net = torch.cat([expand[:, None].expand(B, N, -1), out1234, out5_std], dim=-1)
    for name, f in (("convs1", 256), ("convs2", 256), ("convs3", 128)):
        net = torch.relu(batch_norm(s.child("bns" + name[-1]),
                                    linear(s.child(name), net, f)))
    return linear(s.child("convs4"), net, num_part)


class VNPointNetCls(ScopedModel):
    """Eager eval VN_PointNet_CLS: (B, N, 3) -> (B, num_classes)."""

    forward_fn = vn_pointnet_cls

    def __init__(self, num_classes: int = 40, k: int = 20, pooling: str = "mean",
                 generator: torch.Generator | None = None):
        super().__init__(generator, num_classes=num_classes, k=k, pooling=pooling)


class VNPointNetPseg(ScopedModel):
    """Eager eval VN_PointNet_PSEG: (B, N, 3), (B, 16) -> (B, N, num_part)."""

    forward_fn = vn_pointnet_pseg
    with_label = True

    def __init__(self, num_part: int = 50, k: int = 40, pooling: str = "mean",
                 generator: torch.Generator | None = None):
        super().__init__(generator, num_part=num_part, k=k, pooling=pooling)
