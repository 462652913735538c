"""Classic PointNet classifier and part segmenter with the input and
feature T-Nets (``--model original``; counterparts of
svnet_tpu/models/pointnet.py), each one function of its weights
(``nn/scope.py``) behind an eager eval model. Both return (logits,
trans_feat) for the T-Net regularizer (``train.losses.cal_pointnet_loss``).
No kNN and no gather: every layer is a torch product per point.
"""

from __future__ import annotations

import torch

from svnet_tpu_torch.nn.scope import Scope, ScopedModel, batch_norm, dropout, linear


def _lin_bn_relu(s: Scope, x: torch.Tensor, features: int, name: str) -> torch.Tensor:
    x = linear(s.child(name), x, features)
    return torch.relu(batch_norm(s.child(f"bn_{name}"), x))


def stnkd(s: Scope, x: torch.Tensor, k: int = 64) -> torch.Tensor:
    """STNkd: (B, N, C) -> a (B, k, k) transform, the identity added."""
    B = x.shape[0]
    for name, f in (("conv1", 64), ("conv2", 128), ("conv3", 1024)):
        x = _lin_bn_relu(s, x, f, name)
    x = torch.amax(x, dim=1)
    x = _lin_bn_relu(s, _lin_bn_relu(s, x, 512, "fc1"), 256, "fc2")
    x = linear(s.child("fc3"), x, k * k)
    x = x + torch.eye(k, dtype=x.dtype, device=x.device).reshape(-1)
    return x.reshape(B, k, k)


def pointnet_encoder(s: Scope, points: torch.Tensor):
    """PointNetEncoder: (B, N, 3) -> (global (B, 1024), trans, trans_feat)."""
    trans = stnkd(s.child("stn"), points, 3)
    x = _lin_bn_relu(s, torch.einsum("bni,bij->bnj", points, trans), 64, "conv1")
    trans_feat = stnkd(s.child("fstn"), x, 64)
    x = _lin_bn_relu(s, torch.einsum("bni,bij->bnj", x, trans_feat), 128, "conv2")
    x = batch_norm(s.child("bn_conv3"), linear(s.child("conv3"), x, 1024))
    return torch.amax(x, dim=1), trans, trans_feat


def pointnet_cls(s: Scope, points: torch.Tensor, num_classes: int = 40,
                 k: int = 20):
    """PointNet_CLS: the encoder, fc1/bn1/relu, fc2/dropout 0.4/bn2/relu,
    fc3. ``k`` is unused (the zoo's uniform constructor)."""
    del k
    x, _, trans_feat = pointnet_encoder(s.child("feat"), points)
    x = torch.relu(batch_norm(s.child("bn1"), linear(s.child("fc1"), x, 512)))
    x = dropout(s, linear(s.child("fc2"), x, 256), 0.4)
    x = torch.relu(batch_norm(s.child("bn2"), x))
    return linear(s.child("fc3"), x, num_classes), trans_feat


def pointnet_pseg(s: Scope, points: torch.Tensor, label: torch.Tensor,
                  num_part: int = 50, k: int = 40):
    """PointNet_PSEG: the input T-Net, conv1-3, the feature T-Net (128),
    conv4, conv5 and its max over the points beside the label, every
    layer's features per point, convs1-4. ``k`` is unused."""
    del k
    B, N = points.shape[:2]
    trans = stnkd(s.child("stn"), points, 3)
    out1 = _lin_bn_relu(s, torch.einsum("bni,bij->bnj", points, trans), 64, "conv1")
    out2 = _lin_bn_relu(s, out1, 128, "conv2")
    out3 = _lin_bn_relu(s, out2, 128, "conv3")
    trans_feat = stnkd(s.child("fstn"), out3, 128)
    out4 = _lin_bn_relu(s, torch.einsum("bni,bij->bnj", out3, trans_feat), 512,
                        "conv4")
    out5 = batch_norm(s.child("bn_conv5"), linear(s.child("conv5"), out4, 2048))
    expand = torch.cat([torch.amax(out5, dim=1), label], dim=-1)
    net = torch.cat([expand[:, None].expand(B, N, -1), out1, out2, out3, out4,
                     out5], dim=-1)
    for name, f in (("convs1", 256), ("convs2", 256), ("convs3", 128)):
        net = _lin_bn_relu(s, net, f, name)
    return linear(s.child("convs4"), net, num_part), trans_feat


class PointNetCls(ScopedModel):
    """Eager eval PointNet_CLS: (B, N, 3) -> ((B, num_classes), (B, 64, 64))."""

    forward_fn = pointnet_cls

    def __init__(self, num_classes: int = 40, k: int = 20,
                 generator: torch.Generator | None = None):
        super().__init__(generator, num_classes=num_classes, k=k)


class PointNetPseg(ScopedModel):
    """Eager eval PointNet_PSEG: (B, N, 3), (B, 16) -> ((B, N, num_part),
    (B, 128, 128))."""

    forward_fn = pointnet_pseg
    with_label = True

    def __init__(self, num_part: int = 50, k: int = 40,
                 generator: torch.Generator | None = None):
        super().__init__(generator, num_part=num_part, k=k)
