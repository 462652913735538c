"""Vector-Neuron DGCNN classifier and part segmenter (``--model vn``;
counterparts of svnet_tpu/models/vn_dgcnn.py), each one function of its
weights (``nn/scope.py``) behind an eager eval model.

Every round's kNN runs over the flattened 3V vector features (kernel B4
on the card: C = 3, 63, 63, 126 in the classifier) and gathers its
neighbours through kernel B7, whose scatter-add backward carries the
features' gradient in training.
"""

from __future__ import annotations

import torch

from svnet_tpu_torch import ops
from svnet_tpu_torch.nn import sv_train as svt
from svnet_tpu_torch.nn import vn_layers as vnl
from svnet_tpu_torch.nn.scope import Scope, ScopedModel, batch_norm, dropout, linear


def _pool(s: Scope, x: torch.Tensor, name: str, pooling: str) -> torch.Tensor:
    if pooling == "max":
        return vnl.vn_max_pool(s.child(name), x, 2)
    return vnl.mean_pool(x, 2)


def _std(s: Scope, x: torch.Tensor):
    """[x | its mean over the points] through VNStdFeature -> (x_std, z0)."""
    x = torch.cat([x, torch.mean(x, dim=1, keepdim=True).expand_as(x)], dim=-1)
    return vnl.vn_std_feature(s.child("std_feature"), x)


def vn_dgcnn_cls(s: Scope, points: torch.Tensor, num_classes: int = 40,
                 k: int = 20, pooling: str = "mean") -> torch.Tensor:
    """VN_DGCNN_CLS: four edge rounds (21, 21, 42, 85 vector channels) each
    pooled over k, conv5 with one shared direction, VNStdFeature, the max
    and mean over the points, linear1-3 with leaky ReLU and dropout 0.5."""
    B, N = points.shape[:2]
    x, pooled = points[..., None], []
    for i, f in enumerate((64 // 3, 64 // 3, 128 // 3, 256 // 3), 1):
        e = ops.vn_graph_feature(x, k, plain=s.plain)
        x = _pool(s, vnl.vn_linear_leaky_relu(s.child(f"conv{i}"), e, f),
                  f"pool{i}", pooling)
        pooled.append(x)
    x = vnl.vn_linear_leaky_relu(s.child("conv5"), torch.cat(pooled, dim=-1),
                                 1024 // 3, share=True)
    x = _std(s, x)[0].reshape(B, N, -1)
    x = torch.cat([torch.amax(x, dim=1), torch.mean(x, dim=1)], dim=-1)
    x = svt.leaky(batch_norm(s.child("bn1"), linear(s.child("linear1"), x, 512)))
    x = dropout(s, x, 0.5)
    x = svt.leaky(batch_norm(s.child("bn2"), linear(s.child("linear2"), x, 256)))
    x = dropout(s, x, 0.5)
    return linear(s.child("linear3"), x, num_classes)


def vn_dgcnn_pseg(s: Scope, points: torch.Tensor, label: torch.Tensor,
                  num_part: int = 50, k: int = 40,
                  pooling: str = "mean") -> torch.Tensor:
    """VN_DGCNN_PSEG: three edge rounds (two VN layers, two, one; 21
    vector channels each), conv6 with one shared direction on their
    concat, VNStdFeature whose frame un-projects the rounds' features, the
    max over the points beside the label branch (conv7/bn7), conv8-11 per
    point."""
    B, N = points.shape[:2]
    x, pooled = points[..., None], []
    for i, convs in enumerate((("conv1", "conv2"), ("conv3", "conv4"), ("conv5",)), 1):
        x = ops.vn_graph_feature(x, k, plain=s.plain)
        for name in convs:
            x = vnl.vn_linear_leaky_relu(s.child(name), x, 64 // 3)
        x = _pool(s, x, f"pool{i}", pooling)
        pooled.append(x)
    x123 = torch.cat(pooled, dim=-1)  # (B, N, 3, 63)
    x = vnl.vn_linear_leaky_relu(s.child("conv6"), x123, 1024 // 3, share=True)
    x, z0 = _std(s, x)
    x123 = torch.einsum("bnic,bnij->bnjc", x123, z0).reshape(B, N, -1)
    x = torch.amax(x.reshape(B, N, -1), dim=1)
    lab = svt.leaky(batch_norm(s.child("bn7"),
                               linear(s.child("conv7"), label, 64, use_bias=False)))
    g = torch.cat([x, lab], dim=-1)[:, None].expand(B, N, -1)
    x = torch.cat([g, x123], dim=-1)
    for i, f in ((8, 256), (9, 256), (10, 128)):
        x = svt.leaky(batch_norm(s.child(f"bn{i}"),
                                 linear(s.child(f"conv{i}"), x, f, use_bias=False)))
        if i < 10:
            x = dropout(s, x, 0.5)
    return linear(s.child("conv11"), x, num_part, use_bias=False)


class VNDGCNNCls(ScopedModel):
    """Eager eval VN_DGCNN_CLS: (B, N, 3) -> (B, num_classes)."""

    forward_fn = vn_dgcnn_cls

    def __init__(self, num_classes: int = 40, k: int = 20, pooling: str = "mean",
                 generator: torch.Generator | None = None):
        super().__init__(generator, num_classes=num_classes, k=k, pooling=pooling)


class VNDGCNNPseg(ScopedModel):
    """Eager eval VN_DGCNN_PSEG: (B, N, 3), (B, 16) -> (B, N, num_part)."""

    forward_fn = vn_dgcnn_pseg
    with_label = True

    def __init__(self, num_part: int = 50, k: int = 40, pooling: str = "mean",
                 generator: torch.Generator | None = None):
        super().__init__(generator, num_part=num_part, k=k, pooling=pooling)
