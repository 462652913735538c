"""Classic DGCNN classifier and part segmenter (``--model original``;
counterparts of svnet_tpu/models/dgcnn.py, Transform_Net included), each
one function of its weights (``nn/scope.py``) behind an eager eval model.

Every round's kNN runs over its scalar features (kernel B4 on the card:
C = 3, 64, 64, 128 in the classifier) and gathers its neighbours through
kernel B7, whose scatter-add backward carries the features' gradient in
training. Both return plain logits (no T-Net regularizer: the trainer
takes ``cal_loss``; ROADMAP C26).
"""

from __future__ import annotations

import torch

from svnet_tpu_torch import ops
from svnet_tpu_torch.nn import sv_train as svt
from svnet_tpu_torch.nn.scope import Scope, ScopedModel, batch_norm, dropout, linear


def _conv_bn_lrelu(s: Scope, x: torch.Tensor, features: int, name: str) -> torch.Tensor:
    x = linear(s.child(name), x, features, use_bias=False)
    return svt.leaky(batch_norm(s.child(f"bn_{name}"), x))


def dgcnn_cls(s: Scope, points: torch.Tensor, num_classes: int = 40,
              k: int = 20) -> torch.Tensor:
    """DGCNN_CLS: four edge rounds (64, 64, 128, 256) each pooled by max
    over k, conv5 (1024), the max and mean over the points, linear1-3
    with leaky ReLU and dropout 0.5."""
    x, pooled = points, []
    for i, f in enumerate((64, 64, 128, 256), 1):
        e = ops.scalar_graph_feature(x, k, plain=s.plain)
        x = torch.amax(_conv_bn_lrelu(s, e, f, f"conv{i}"), dim=2)
        pooled.append(x)
    x = _conv_bn_lrelu(s, torch.cat(pooled, dim=-1), 1024, "conv5")
    x = torch.cat([torch.amax(x, dim=1), torch.mean(x, dim=1)], dim=-1)
    x = linear(s.child("linear1"), x, 512, use_bias=False)
    x = dropout(s, svt.leaky(batch_norm(s.child("bn6"), x)), 0.5)
    x = svt.leaky(batch_norm(s.child("bn7"), linear(s.child("linear2"), x, 256)))
    return linear(s.child("linear3"), dropout(s, x, 0.5), num_classes)


def transform_head(s: Scope, x: torch.Tensor) -> torch.Tensor:
    """_TransformHead: 256 -> 9, zero kernel and identity bias at init."""
    kernel = s.param("kernel", (x.shape[-1], 9), lambda shape, g: torch.zeros(shape))
    bias = s.param("bias", (9,), lambda shape, g: torch.eye(3).reshape(9))
    return x @ kernel + bias


def transform_net(s: Scope, edges: torch.Tensor) -> torch.Tensor:
    """Transform_Net: the points' edges (B, N, k, 6) -> a (B, 3, 3) transform."""
    x = _conv_bn_lrelu(s, _conv_bn_lrelu(s, edges, 64, "conv1"), 128, "conv2")
    x = _conv_bn_lrelu(s, torch.amax(x, dim=2), 1024, "conv3")
    x = linear(s.child("linear1"), torch.amax(x, dim=1), 512, use_bias=False)
    x = svt.leaky(batch_norm(s.child("bn3"), x))
    x = linear(s.child("linear2"), x, 256, use_bias=False)
    x = svt.leaky(batch_norm(s.child("bn4"), x))
    return transform_head(s.child("transform"), x).reshape(-1, 3, 3)


def dgcnn_pseg(s: Scope, points: torch.Tensor, label: torch.Tensor,
               num_part: int = 50, k: int = 40) -> torch.Tensor:
    """DGCNN_PSEG: Transform_Net on the points' edges, three edge rounds
    (two layers, two, one; 64 channels each), conv6 (1024) and its max
    over the points beside the label branch (conv7/bn7), conv8-11 per
    point."""
    B, N = points.shape[:2]
    t = transform_net(s.child("transform_net"),
                      ops.scalar_graph_feature(points, k, plain=s.plain))
    x, pooled = torch.einsum("bni,bij->bnj", points, t), []
    for convs in (("conv1", "conv2"), ("conv3", "conv4"), ("conv5",)):
        x = ops.scalar_graph_feature(x, k, plain=s.plain)
        for name in convs:
            x = _conv_bn_lrelu(s, x, 64, name)
        x = torch.amax(x, dim=2)
        pooled.append(x)
    x = torch.amax(_conv_bn_lrelu(s, torch.cat(pooled, dim=-1), 1024, "conv6"), dim=1)
    lab = linear(s.child("conv7"), label, 64, use_bias=False)
    lab = svt.leaky(batch_norm(s.child("bn7"), lab))
    g = torch.cat([x, lab], dim=-1)[:, None].expand(B, N, -1)
    x = torch.cat([g] + pooled, dim=-1)  # (B, N, 1280)
    x = dropout(s, _conv_bn_lrelu(s, x, 256, "conv8"), 0.5)
    x = dropout(s, _conv_bn_lrelu(s, x, 256, "conv9"), 0.5)
    x = _conv_bn_lrelu(s, x, 128, "conv10")
    return linear(s.child("conv11"), x, num_part, use_bias=False)


class DGCNNCls(ScopedModel):
    """Eager eval DGCNN_CLS: (B, N, 3) -> (B, num_classes)."""

    forward_fn = dgcnn_cls

    def __init__(self, num_classes: int = 40, k: int = 20,
                 generator: torch.Generator | None = None):
        super().__init__(generator, num_classes=num_classes, k=k)


class DGCNNPseg(ScopedModel):
    """Eager eval DGCNN_PSEG: (B, N, 3), (B, 16) -> (B, N, num_part)."""

    forward_fn = dgcnn_pseg
    with_label = True

    def __init__(self, num_part: int = 50, k: int = 40,
                 generator: torch.Generator | None = None):
        super().__init__(generator, num_part=num_part, k=k)
