"""SV-DGCNN classifier, eager eval forward (counterpart of
svnet_tpu/models/sv_dgcnn.py:83-151 with ``train_knobs`` off).

This is the un-fused oracle: every round builds its (B, N, k, ...) edge
tensors explicitly. The serving path is ``svnet_tpu_torch.infer``.
"""

from __future__ import annotations

import torch
from torch import nn

from svnet_tpu_torch import ops
from svnet_tpu_torch.nn.sv_layers import (
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


def _running_stats(x: torch.Tensor) -> torch.Tensor:
    """Non-trivial BN statistics for random-weight runs: the test-suite
    recipe ``x + 0.3*|x| + 0.05`` (tests/test_kernel_smoke.py:29-34)."""
    return x + 0.3 * torch.abs(x) + 0.05


def init_params(num_classes: int = 40, k: int = 20, binary: bool = False,
                generator: torch.Generator | None = None) -> dict:
    """Seeded weights as ``{'params', 'batch_stats'}``: the same tree, keys
    and shapes as flax ``SV_DGCNN_CLS(...).init`` (kernels ``(in, out)``).
    Running stats follow the test-suite recipe; ``k`` does not change any
    shape and is accepted for symmetry with the model."""
    del k
    tree = module_tree(SVDGCNNCls(num_classes, 1, binary, generator))
    stats = tree["batch_stats"]

    def bump(d):
        return {n: bump(c) if isinstance(c, dict) else _running_stats(c)
                for n, c in d.items()}

    return {"params": tree["params"], "batch_stats": bump(stats)}
