"""SV-PointNet classifier and part segmenter, eager eval forward
(counterparts of svnet_tpu/models/sv_pointnet.py).

One kNN graph over the coordinates with a cross-product edge channel,
conv_pos on the edges and a pool over k, then per-point SVBlocks, the
SV_STNkd global token and a global-mean context concat. This is the
un-fused oracle; the serving paths are ``svnet_tpu_torch.infer``'s
``SVPointNetClsEngine`` and ``SVPointNetPsegEngine``.
"""

from __future__ import annotations

import torch
from torch import nn

from svnet_tpu_torch import ops
from svnet_tpu_torch.models.sv_dgcnn import seeded_tree
from svnet_tpu_torch.nn.sv_layers import (
    BatchNorm,
    Linear,
    SV_STNkd,
    SVBlock,
    SVFuse,
    Vector2Scalar,
)
from svnet_tpu_torch.utils.convert import load_tree

# (in_s, in_v, out_s, out_v) of the encoders' per-point SVBlocks; conv_pos
# runs on the edges' 9 init scalars and 3 vector channels
ENC_CLS = {
    "conv_pos": (9, 3, 64 // 2, 64 // 6),
    "conv1": (32, 10, 64 // 2, 64 // 6),
    "conv2": (64, 20, 128 // 2, 128 // 6),
    "conv3": (64, 21, 1024 // 2, 1024 // 6),
    "conv_fuse": (1024, 340, 1024 // 2, 1024 // 6),
}
ENC_PSEG = {
    "conv_pos": (9, 3, 64 // 2, 64 // 6),
    "conv1": (32, 10, 64 // 2, 64 // 6),
    "conv2": (32, 10, 128 // 2, 128 // 6),
    "conv3": (64, 21, 128 // 2, 128 // 6),
    "conv4": (128, 42, 512 // 2, 512 // 6),
    "conv5": (256, 85, 2048 // 2, 2048 // 6),
}
NUM_CATEGORIES = 16  # ShapeNet part's object categories (the label one-hot)


def _blocks(module: nn.Module, spec: dict, binary: bool, g) -> None:
    for name, (i_s, i_v, o_s, o_v) in spec.items():
        blk_binary = binary and name != "conv_pos"  # conv_pos is always FP
        module.add_module(name, SVBlock(i_s, i_v, o_s, o_v, blk_binary, g))


def _first(module: nn.Module, points: torch.Tensor):
    """Cross edges -> init_scalar -> conv_pos -> pool over k."""
    v = ops.get_graph_feature_cross(points, module.k)  # (B, N, k, 3, 3)
    return ops.svpool(module.conv_pos((module.init_scalar(v), v)))


class SVPointNetEncoder(nn.Module):
    """The classifier's trunk: (B, N, 3) -> (B, 1022)."""

    def __init__(self, k: int = 20, binary: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.k = k
        self.init_scalar = Vector2Scalar(3, 3, generator=g)
        _blocks(self, {n: ENC_CLS[n] for n in ("conv_pos", "conv1")}, binary, g)
        self.fstn = SV_STNkd(32, 10, binary, g)
        _blocks(self, {n: ENC_CLS[n] for n in ("conv2", "conv3", "conv_fuse")},
                binary, g)
        self.svfuse = SVFuse(1024 // 6, 3, binary, generator=g)

    def forward(self, points: torch.Tensor) -> torch.Tensor:
        x = self.conv1(_first(self, points))
        tok = self.fstn(x)  # (B, S), (B, 3, V)
        x = ops.svcat([x, ops.svexpand((tok[0][:, None], tok[1][:, None]), x)])
        x = self.conv3(self.conv2(x))
        x = ops.svcat([x, ops.svexpand(ops.svpool(x, dim=1, keepdim=True), x)])
        return self.svfuse(ops.svpool(self.conv_fuse(x), dim=1))


class SVPointNetCls(nn.Module):
    """SV_PointNet_CLS: encoder, then fc1/bn1/relu, fc2/bn2/relu (binarizable)
    and the FP fc3. Eval only; dropout is identity."""

    def __init__(self, num_classes: int = 40, k: int = 20, binary: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.feat = SVPointNetEncoder(k, binary, g)
        self.fc1 = Linear(512 + 3 * 170, 512, use_bias=False, bw=binary,
                          ba=binary, generator=g)
        self.bn1 = BatchNorm(512)
        self.fc2 = Linear(512, 256, use_bias=False, bw=binary, ba=binary,
                          generator=g)
        self.bn2 = BatchNorm(256)
        self.fc3 = Linear(256, num_classes, use_bias=True, generator=g)

    def forward(self, points: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.fc1(self.feat(points))))
        x = torch.relu(self.bn2(self.fc2(x)))
        return self.fc3(x)

    @classmethod
    def from_tree(cls, tree: dict, num_classes: int = 40, k: int = 20,
                  binary: bool = False) -> "SVPointNetCls":
        model = cls(num_classes, k, binary)
        load_tree(model, tree)
        return model.eval()


def _add_conv_bn(module: nn.Module, name: str, d_in: int, features: int,
                 binary: bool, g) -> None:
    """A pointwise binarizable linear and its BN, named ``<name>_conv`` and
    ``<name>_bn`` as flax names them."""
    module.add_module(f"{name}_conv", Linear(d_in, features, use_bias=False,
                                             bw=binary, ba=binary, generator=g))
    module.add_module(f"{name}_bn", BatchNorm(features))


def _conv_bn_relu(module: nn.Module, name: str, x: torch.Tensor) -> torch.Tensor:
    conv = getattr(module, f"{name}_conv")
    return torch.relu(getattr(module, f"{name}_bn")(conv(x)))


def _pseg_widths(num_part: int) -> dict:
    """(in, out) of the part segmenter's pointwise linears."""
    fused = 2048 + 3 * (2 * (2048 // 6))  # [s5 | mean] + SVFuse invariants
    skip = sum(o_s + 3 * o_v for n, (_, _, o_s, o_v) in ENC_PSEG.items()
               if n != "conv_pos")
    return {"conv_fuse1": (fused, fused // 8), "conv_fuse2": (fused // 8, fused),
            "convs1": (fused + NUM_CATEGORIES + skip, 256),
            "convs2": (256, 256), "convs3": (256, 128), "convs4": (128, num_part)}


class SVPointNetPseg(nn.Module):
    """SV_PointNet_PSEG: conv1-5 with the SV_STNkd token after conv3,
    SVFuse(trans_back) on [conv5 | its mean over the points], the conv_fuse
    bottleneck pooled over the points (mean when binary, max when FP), the
    category label, and the skip vectors un-projected through the learned
    frame; then convs1-3 and the FP convs4. Eval only."""

    def __init__(self, num_part: int = 50, k: int = 40, binary: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.k, self.binary = k, binary
        self.init_scalar = Vector2Scalar(3, 3, generator=g)
        _blocks(self, {n: ENC_PSEG[n] for n in ("conv_pos", "conv1", "conv2",
                                                "conv3")}, binary, g)
        self.fstn = SV_STNkd(64, 21, binary, g)
        _blocks(self, {n: ENC_PSEG[n] for n in ("conv4", "conv5")}, binary, g)
        self.svfuse = SVFuse(2 * (2048 // 6), 3, binary, generator=g,
                             trans_back=True)
        for name, (d_in, out) in _pseg_widths(num_part).items():
            if name == "convs4":
                self.convs4 = Linear(d_in, out, use_bias=True, generator=g)
            else:
                _add_conv_bn(self, name, d_in, out, binary, g)

    def forward(self, points: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        """(B, N, 3) points, (B, 16) one-hot category -> (B, N, num_part)."""
        B, N = points.shape[:2]
        out1 = self.conv1(_first(self, points))
        out2 = self.conv2(out1)
        out3 = self.conv3(out2)
        tok = self.fstn(out3)
        out4 = self.conv4(ops.svcat([out3, ops.svexpand(
            (tok[0][:, None], tok[1][:, None]), out3)]))
        out5 = self.conv5(out4)
        mean = ops.svpool(out5, dim=1, keepdim=True, spool="mean")
        x, trans = self.svfuse(ops.svcat([out5, ops.svexpand(mean, out5)]))
        x = _conv_bn_relu(self, "conv_fuse2", _conv_bn_relu(self, "conv_fuse1", x))
        x = torch.mean(x, dim=1) if self.binary else torch.amax(x, dim=1)
        x_l = torch.cat([x, label], dim=-1)[:, None, :].expand(B, N, -1)
        cs, cv = ops.svcat([out1, out2, out3, out4, out5])
        concat_v = torch.einsum("bnic,bnik->bnck", cv, trans).reshape(B, N, -1)
        net = torch.cat([x_l, cs, concat_v], dim=-1)
        for name in ("convs1", "convs2", "convs3"):
            net = _conv_bn_relu(self, name, net)
        return self.convs4(net)

    @classmethod
    def from_tree(cls, tree: dict, num_part: int = 50, k: int = 40,
                  binary: bool = False) -> "SVPointNetPseg":
        model = cls(num_part, k, binary)
        load_tree(model, tree)
        return model.eval()


def init_params(num_classes: int = 40, k: int = 20, binary: bool = False,
                generator: torch.Generator | None = None) -> dict:
    """Seeded SVPointNetCls weights as ``{'params', 'batch_stats'}``: the
    tree, keys and shapes of flax ``SV_PointNet_CLS(...).init``, running
    stats by the test-suite recipe (``sv_dgcnn.init_params``)."""
    del k
    return seeded_tree(SVPointNetCls(num_classes, 1, binary, generator))


def init_params_pseg(num_part: int = 50, k: int = 40, binary: bool = False,
                     generator: torch.Generator | None = None) -> dict:
    """Seeded SVPointNetPseg weights, as ``init_params``."""
    del k
    return seeded_tree(SVPointNetPseg(num_part, 1, binary, generator))
