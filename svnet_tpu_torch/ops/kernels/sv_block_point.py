"""Per-point gated SVBlock, no edges and no pooling (counterpart of
svnet_tpu/ops/pallas/sv_block_point.py::sv_block_point): the SV-PointNet
engines' conv, conv_fuse and SV_STNkd trunk blocks.

``src (B, N, S + 3V)`` row-major holds each point's scalars, then its
vectors i-major (component i, channel c at ``S + i*V + c``); ``gate
(B, V_out)`` is the SE gate the caller computed from the mean input
scalars. Returns ``s (B, N, S_out)`` and the gated ``v (B, N, 3*V_out)``,
i-major. Weights are ``fold.fold_point_like_params``' dict.

A CPU tensor goes to the plain PyTorch version; a CUDA tensor launches
csrc/sv_block_point.cu or raises. ``sv_block_point.launches`` counts kernel
launches. The plain version contracts in the kernel's order with every
product and sum rounded on its own, so the two agree bitwise.
"""

from __future__ import annotations

import torch

from svnet_tpu_torch.config import require_cuda
from svnet_tpu_torch.nn.sv_layers import binary_matmul, v2s_invariants
from svnet_tpu_torch.ops.kernels import _build
from svnet_tpu_torch.ops.kernels.fold import Folded, packed_signs
from svnet_tpu_torch.ops.kernels.sv_round3 import (
    _leaky,
    jmajor,
    ordered_matmul,
    vector_bn_scale,
)


def sv_block_point_plain(src: torch.Tensor, gate: torch.Tensor,
                         folded: Folded, *, S: int, V: int, S_out: int,
                         V_out: int, binary: bool):
    B, N, _ = src.shape
    v = src[..., S:].reshape(B, N, 3, V)
    sv = jmajor(v2s_invariants(v, ordered_matmul(v, folded["wz"])))
    xc = torch.cat([src[..., :S], sv], dim=-1)
    if binary:  # +-1 products: exact in any order
        h = binary_matmul(torch.sign(xc + folded["beta"]), folded["w1"])
    else:
        h = ordered_matmul(xc, folded["w1"])
    s = _leaky(h * folded["a1"] + folded["b1"])
    wl = ordered_matmul(v, folded["w2"]) * folded["scale2"]
    vo = wl * (vector_bn_scale(wl, folded["a2"], folded["b2"])
               * gate[:, None, None, :])
    return s, vo.reshape(B, N, 3 * V_out)


def sv_block_point(src: torch.Tensor, gate: torch.Tensor, folded: Folded, *,
                   S: int, V: int, S_out: int, V_out: int, binary: bool = True):
    """See the module docstring."""
    Cin = S + 3 * V
    if src.dim() != 3 or src.shape[2] != Cin:
        raise ValueError(f"src: shape {tuple(src.shape)}, expected (B, N, {Cin})")
    B, N, _ = src.shape
    if tuple(gate.shape) != (B, V_out):
        raise ValueError(f"gate: shape {tuple(gate.shape)}, expected {(B, V_out)}")
    if src.device.type == "cpu":
        return sv_block_point_plain(src, gate, folded, S=S, V=V, S_out=S_out,
                                    V_out=V_out, binary=binary)
    dev = require_cuda(src.device)
    _build.check_arg(src, "src", (B, N, Cin), dev)
    _build.check_arg(gate, "gate", (B, V_out), dev)
    f = folded
    w = [_build.check_arg(f["wz"], "wz", (V, 3), dev),
         _build.check_arg(f["w1"], "w1", (Cin, S_out), dev),
         _build.check_arg(f["beta"], "beta", (1, Cin), dev),
         _build.check_arg(f["a1"], "a1", (1, S_out), dev),
         _build.check_arg(f["b1"], "b1", (1, S_out), dev),
         _build.check_arg(f["w2"], "w2", (V, V_out), dev),
         _build.check_arg(f["scale2"], "scale2", (1, V_out), dev),
         _build.check_arg(f["a2"], "a2", (1, V_out), dev),
         _build.check_arg(f["b2"], "b2", (1, V_out), dev)]
    w.insert(2, packed_signs(f["w1"], S_out).data_ptr() if binary else None)
    lib = _build.lib()
    s = torch.empty((B, N, S_out), device=dev)
    v = torch.empty((B, N, 3 * V_out), device=dev)
    err = lib.sv_block_point_launch(
        src.data_ptr(), gate.data_ptr(), *w, s.data_ptr(), v.data_ptr(), B, N,
        S, V, S_out, V_out, int(binary), _build.stream_ptr(dev))
    _build.check(err, "sv_block_point")
    sv_block_point.launches += 1
    return s, v


sv_block_point.launches = 0


def points_per_block(S: int, V: int, S_out: int, V_out: int,
                     binary: bool = True) -> int:
    """The points one block of the kernel takes at these widths: binary,
    the tile of csrc/sv_point_tile.cuh (128 where S_out <= 256, 64 where
    S_out <= 512, else 32); FP, 16, or fewer where 16 do not fit; 0 if not
    even one does."""
    return int(_build.lib().sv_block_point_ppb(S, V, S_out, V_out, int(binary)))
