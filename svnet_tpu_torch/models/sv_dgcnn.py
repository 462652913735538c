"""SV-DGCNN classifier and part segmenter, eager eval forward (counterparts
of svnet_tpu/models/sv_dgcnn.py:83-251 with ``train_knobs`` off).

These are the un-fused oracles: every round builds its (B, N, k, ...) edge
tensors explicitly. The serving paths are ``svnet_tpu_torch.infer``'s
``SVDGCNNClsEngine`` and ``SVDGCNNPsegEngine``.
"""

from __future__ import annotations

import torch
from torch import nn

from svnet_tpu_torch import ops
from svnet_tpu_torch.nn.sv_layers import (
    _BN,
    BatchNorm,
    Linear,
    SVBlock,
    SVFuse,
    Vector2Scalar,
)
from svnet_tpu_torch.utils.convert import load_tree, module_tree

# (in_s, in_v, out_s, out_v) of the trunk's SVBlocks; edge rounds see
# twice the input channels ([nbr - ctr, ctr])
_BLOCKS = {
    "conv1": (6, 2, 64 // 2, 64 // 6),
    "conv2": (2 * 32, 2 * 10, 64 // 2, 64 // 6),
    "conv3": (2 * 32, 2 * 10, 128 // 2, 128 // 6),
    "conv4": (2 * 64, 2 * 21, 256 // 2, 256 // 6),
    "conv5": (256, 83, 1024 // 2, 1024 // 6),
}


class SVDGCNNCls(nn.Module):
    """SV_DGCNN_CLS: 4 dynamic-graph rounds, skip-concat, conv5 SVBlock,
    SVFuse read-out, max+mean pool, binarizable MLP head. conv1 and
    linear3 are always full-precision. Eval only; dropout is identity."""

    def __init__(self, num_classes: int = 40, k: int = 20, binary: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.k = k
        self.binary = binary
        self.init_scalar = Vector2Scalar(2, 3, generator=g)
        for name, (i_s, i_v, o_s, o_v) in _BLOCKS.items():
            blk_binary = binary and name != "conv1"
            self.add_module(name, SVBlock(i_s, i_v, o_s, o_v, blk_binary, g))
        self.svfuse = SVFuse(1024 // 6, 3, binary, generator=g)
        width = 2 * (512 + 3 * 170)
        self.linear1 = Linear(width, 512, use_bias=False, bw=binary, ba=binary,
                              generator=g)
        self.bn1 = BatchNorm(512)
        self.linear2 = Linear(512, 256, use_bias=False, bw=binary, ba=binary,
                              generator=g)
        self.bn2 = BatchNorm(256)
        self.linear3 = Linear(256, num_classes, use_bias=True, generator=g)

    def forward(self, points: torch.Tensor) -> torch.Tensor:
        k = self.k
        v = ops.get_graph_feature(points, k)  # (B, N, k, 3, 2)
        x = (self.init_scalar(v), v)
        x1 = ops.svpool(self.conv1(x))
        x2 = ops.svpool(self.conv2(ops.get_graph_feature_sv(x1, k)))
        x3 = ops.svpool(self.conv3(ops.get_graph_feature_sv(x2, k)))
        x4 = ops.svpool(self.conv4(ops.get_graph_feature_sv(x3, k)))
        x = self.svfuse(self.conv5(ops.svcat([x1, x2, x3, x4])))  # (B, N, 1022)
        x = torch.cat([torch.amax(x, dim=1), torch.mean(x, dim=1)], dim=-1)
        lrelu = nn.functional.leaky_relu
        x = lrelu(self.bn1(self.linear1(x)), 0.2)
        x = lrelu(self.bn2(self.linear2(x)), 0.2)
        return self.linear3(x)

    @classmethod
    def from_tree(cls, tree: dict, num_classes: int = 40, k: int = 20,
                  binary: bool = False) -> "SVDGCNNCls":
        model = cls(num_classes, k, binary)
        load_tree(model, tree)
        return model.eval()


def make_divisible(v: float, divisor: int = 8) -> int:
    """Channel widths rounded to a multiple of 8, as SV_DGCNN_PSEG rounds
    them (svnet_tpu/models/sv_dgcnn.py:72-79)."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


_V = make_divisible
# (S, V) of SV_DGCNN_PSEG's trunk rounds, conv5 (the embedding) and conv6
PSEG_DIMS = {
    "conv1": (_V(64 // 2), _V(64 // 6)),
    "conv2": (_V(64 // 2), _V(64 // 6)),
    "conv3": (_V(128 // 2), _V(128 // 6)),
    "conv4": (_V(256 // 2), _V(256 // 6)),
    "conv5": (_V(1024 // 2), _V(1024 // 6)),
    "conv6": (_V(1024 // 4), _V(1024 // 12)),
}
NUM_CATEGORIES = 16  # ShapeNet part's object categories (the label one-hot)
LABEL_WIDTH = 64  # conv7's output


class ConvBNLReLU(nn.Module):
    """_ConvBNLReLU: a binarizable pointwise linear ``conv`` and flax's own
    BatchNorm ``bn`` (leaves ``conv8.bn.scale``, not ``bn7.bn.bn.scale``),
    then leaky 0.2."""

    def __init__(self, d_in: int, features: int, binary: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv = Linear(d_in, features, use_bias=False, bw=binary,
                           ba=binary, generator=generator)
        self.bn = _BN(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn.functional.leaky_relu(self.bn(self.conv(x)), 0.2)


def pseg_head_width() -> int:
    """conv8's input width: [x_max | x_pool | label | x_fine]."""
    d = PSEG_DIMS
    s_c = sum(d[n][0] for n in ("conv1", "conv2", "conv3", "conv4"))
    v_c = sum(d[n][1] for n in ("conv1", "conv2", "conv3", "conv4"))
    return (d["conv5"][0] + 3 * d["conv5"][1] + d["conv6"][0]
            + 3 * d["conv6"][1] + LABEL_WIDTH + s_c + 3 * v_c)


class SVDGCNNPseg(nn.Module):
    """SV_DGCNN_PSEG: the four-round trunk at make_divisible widths, three
    SVFuse taps (per-point fine features; conv5 pooled, conv6, svfuse2; the
    per-point conv5 embedding through svfuse3, max over the points), the
    16 -> 64 label branch (conv7, bn7; always FP) and the binarizable
    pointwise head conv8-10, then the FP conv11. Eval only; dropout is
    identity."""

    def __init__(self, num_part: int = 50, k: int = 40, binary: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        g, d = generator, PSEG_DIMS
        self.k, self.binary = k, binary
        self.init_scalar = Vector2Scalar(2, 3, generator=g)
        blocks = {"conv1": (6, 2), "conv2": (2 * d["conv1"][0], 2 * d["conv1"][1]),
                  "conv3": (2 * d["conv2"][0], 2 * d["conv2"][1]),
                  "conv4": (2 * d["conv3"][0], 2 * d["conv3"][1])}
        for name, (i_s, i_v) in blocks.items():
            self.add_module(name, SVBlock(i_s, i_v, *d[name],
                                          binary and name != "conv1", g))
        s_c = sum(d[n][0] for n in blocks)
        v_c = sum(d[n][1] for n in blocks)
        self.svfuse1 = SVFuse(v_c, 3, binary, generator=g)
        self.conv5 = SVBlock(s_c, v_c, *d["conv5"], binary, g)
        self.conv6 = SVBlock(*d["conv5"], *d["conv6"], binary, g)
        self.svfuse2 = SVFuse(d["conv6"][1], 3, binary, generator=g)
        self.svfuse3 = SVFuse(d["conv5"][1], 3, binary, generator=g)
        self.conv7 = Linear(NUM_CATEGORIES, LABEL_WIDTH, use_bias=False,
                            generator=g)
        self.bn7 = BatchNorm(LABEL_WIDTH)
        self.conv8 = ConvBNLReLU(pseg_head_width(), 256, binary, g)
        self.conv9 = ConvBNLReLU(256, 256, binary, g)
        self.conv10 = ConvBNLReLU(256, 128, binary, g)
        self.conv11 = Linear(128, num_part, use_bias=False, generator=g)

    def forward(self, points: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        """(B, N, 3) points, (B, 16) one-hot category -> (B, N, num_part)."""
        k = self.k
        B, N = points.shape[:2]
        v = ops.get_graph_feature(points, k)
        x1 = ops.svpool(self.conv1((self.init_scalar(v), v)))
        x2 = ops.svpool(self.conv2(ops.get_graph_feature_sv(x1, k)))
        x3 = ops.svpool(self.conv3(ops.get_graph_feature_sv(x2, k)))
        x4 = ops.svpool(self.conv4(ops.get_graph_feature_sv(x3, k)))
        x = ops.svcat([x1, x2, x3, x4])
        x_fine = self.svfuse1(x)  # (B, N, S_c + 3V_c)
        x = self.conv5(x)
        x_pool = self.svfuse2(self.conv6(ops.svpool(x, dim=1, keepdim=True)))
        x_max = torch.amax(self.svfuse3(x), dim=1, keepdim=True)
        lab = nn.functional.leaky_relu(self.bn7(self.conv7(label)), 0.2)
        g = torch.cat([x_max, x_pool, lab[:, None, :]], dim=-1)
        net = torch.cat([g.expand(B, N, -1), x_fine], dim=-1)
        net = self.conv10(self.conv9(self.conv8(net)))
        return self.conv11(net)

    @classmethod
    def from_tree(cls, tree: dict, num_part: int = 50, k: int = 40,
                  binary: bool = False) -> "SVDGCNNPseg":
        model = cls(num_part, k, binary)
        load_tree(model, tree)
        return model.eval()


def _running_stats(x: torch.Tensor) -> torch.Tensor:
    """Non-trivial BN statistics for random-weight runs: the test-suite
    recipe ``x + 0.3*|x| + 0.05`` (tests/test_kernel_smoke.py:29-34)."""
    return x + 0.3 * torch.abs(x) + 0.05


def seeded_tree(model: nn.Module) -> dict:
    """A freshly built model's weights as ``{'params', 'batch_stats'}``,
    the running stats moved off their init by ``_running_stats``."""
    tree = module_tree(model)

    def bump(d):
        return {n: bump(c) if isinstance(c, dict) else _running_stats(c)
                for n, c in d.items()}

    return {"params": tree["params"], "batch_stats": bump(tree["batch_stats"])}


def init_params(num_classes: int = 40, k: int = 20, binary: bool = False,
                generator: torch.Generator | None = None) -> dict:
    """Seeded weights as ``{'params', 'batch_stats'}``: the same tree, keys
    and shapes as flax ``SV_DGCNN_CLS(...).init`` (kernels ``(in, out)``).
    Running stats follow the test-suite recipe; ``k`` does not change any
    shape and is accepted for symmetry with the model."""
    del k
    return seeded_tree(SVDGCNNCls(num_classes, 1, binary, generator))


def init_params_pseg(num_part: int = 50, k: int = 40, binary: bool = False,
                     generator: torch.Generator | None = None) -> dict:
    """Seeded SVDGCNNPseg weights, as ``init_params``: the tree of flax
    ``SV_DGCNN_PSEG(...).init``."""
    del k
    return seeded_tree(SVDGCNNPseg(num_part, 1, binary, generator))
