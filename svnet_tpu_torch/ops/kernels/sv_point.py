"""Per-point tail: gated conv5 SVBlock + SVFuse, channel-major (kernel B3,
counterpart of svnet_tpu/ops/pallas/sv_point.py::sv_point_block_cm) and
row-major (kernel B3r, ::sv_point_block, the legacy round2 trunks' tail).

Channel-major: ``src (B, S + 3V, N)`` holds the trunk's scalars in its
first S rows and its per-round j-major vector blocks after them; ``v_off``
names each block's (row offset, V_r), in order. Row-major: ``src (B, N,
S + 3V)`` = [s | v flat i-major over the whole V, column S + i*V + c].
Both return x (SVFuse's channels j-major; (B, S_out + 3*V_out, N) or
(B, N, S_out + 3*V_out)), and the pooled s5_max (B, S_out) and v5_mean
(B, 3*V_out) of the gated conv5 output.

The pooled outputs are reduced as the kernel reduces them: per block of 16
points (a max, and a sum in point order), then over the blocks by torch, so
that kernel and plain version agree bitwise on them too (the part
segmentation engine feeds v5_mean into a binary SVBlock).

A CPU tensor goes to the plain PyTorch version; a CUDA tensor launches
csrc/sv_point.cu or raises. ``sv_point_block_cm.launches`` and
``sv_point_block.launches`` count kernel launches.
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

_BLOCK = 16  # points per block of the kernel


def vector_rows(v_off: tuple, S: int, V: int) -> list[int]:
    """src row of vector component i, channel c (reference round order) at
    index i*V + c. Checks that the blocks tile [S, S + 3V) in order: a
    mis-based offset would read scalar rows as vectors with no shape error."""
    o = S
    for off, Vr in v_off:
        if off != o:
            raise ValueError(f"v_off {v_off}: blocks must tile [S, S+3V) in order")
        o += 3 * Vr
    if o != S + 3 * V:
        raise ValueError(f"v_off {v_off} does not cover V={V}")
    return [off + i * Vr + c for i in range(3) for off, Vr in v_off
            for c in range(Vr)]


def _pool_blocks(s5: torch.Tensor, v5: torch.Tensor):
    """s5 (B, N, S_out), v5 (B, N, C) -> (max over N, mean over N) reduced
    as the kernel does: per block of _BLOCK points (the sum in point
    order), then over the blocks (B, nblk, C) by torch."""
    B, N, C = v5.shape
    nblk = -(-N // _BLOCK)
    pad = torch.zeros((B, nblk * _BLOCK - N, C), dtype=v5.dtype,
                      device=v5.device)
    blocks = torch.cat([v5, pad], dim=1).reshape(B, nblk, _BLOCK, C)
    acc = blocks[:, :, 0].contiguous()
    for p in range(1, _BLOCK):
        acc += blocks[:, :, p]
    return torch.amax(s5, dim=1), torch.sum(acc, dim=1) / N


def _point_rows(s: torch.Tensor, v: torch.Tensor, gate: torch.Tensor,
                folded: Folded, binary: bool):
    """The block's function on s (B, N, S), v (B, N, 3, V): x (B, N,
    S_out + 3*V_out) row-major, s5_max, v5_mean."""
    B, N = s.shape[:2]
    sv = jmajor(v2s_invariants(v, ordered_matmul(v, folded["wz"])))
    xc = torch.cat([s, sv], dim=-1)
    if binary:  # +-1 products: exact in any order
        h = binary_matmul(torch.sign(xc + folded["beta"]), folded["w1"])
    else:
        h = ordered_matmul(xc, folded["w1"])
    s5 = _leaky(h * folded["a1"] + folded["b1"])  # (B, N, S_out)
    wl = ordered_matmul(v, folded["w2"]) * folded["scale2"]
    v5 = wl * (vector_bn_scale(wl, folded["a2"], folded["b2"])
               * gate[:, None, None, :])
    svf = jmajor(v2s_invariants(v5, ordered_matmul(v5, folded["wzf"])))
    return (torch.cat([s5, svf], dim=-1),
            *_pool_blocks(s5, v5.reshape(B, N, -1)))


def sv_point_block_cm_plain(src: torch.Tensor, gate: torch.Tensor,
                            folded: Folded, *, S: int, V: int, S_out: int,
                            V_out: int, v_off: tuple, binary: bool):
    B, _, N = src.shape
    rows = torch.tensor(vector_rows(v_off, S, V), device=src.device)
    s = src[:, :S, :].transpose(1, 2)  # (B, N, S)
    v = src[:, rows, :].reshape(B, 3, V, N).permute(0, 3, 1, 2)  # (B, N, 3, V)
    x, s5_max, v5_mean = _point_rows(s, v, gate, folded, binary)
    return x.transpose(1, 2), s5_max, v5_mean


def _weights(f: Folded, S: int, V: int, S_out: int, V_out: int, dev,
             binary: bool) -> list:
    """The folded weights' pointers, in the launch functions' order (W1's
    packed signs after w1 when binary)."""
    Cin = S + 3 * V
    w1 = _build.check_arg(f["w1"], "w1", (Cin, S_out), dev)
    return [_build.check_arg(f["wz"], "wz", (V, 3), dev), w1,
            packed_signs(f["w1"], S_out).data_ptr() if binary else None,
            _build.check_arg(f["beta"], "beta", (1, Cin), dev),
            _build.check_arg(f["a1"], "a1", (1, S_out), dev),
            _build.check_arg(f["b1"], "b1", (1, S_out), dev),
            _build.check_arg(f["w2"], "w2", (V, V_out), dev),
            _build.check_arg(f["scale2"], "scale2", (1, V_out), dev),
            _build.check_arg(f["a2"], "a2", (1, V_out), dev),
            _build.check_arg(f["b2"], "b2", (1, V_out), dev),
            _build.check_arg(f["wzf"], "wzf", (V_out, 3), dev)]


def sv_point_block_cm(src: torch.Tensor, gate: torch.Tensor, folded: Folded,
                      *, S: int, V: int, S_out: int, V_out: int,
                      v_off: tuple, binary: bool = True):
    """See the module docstring."""
    Cin = S + 3 * V
    if src.dim() != 3 or src.shape[1] != Cin:
        raise ValueError(f"src: shape {tuple(src.shape)}, expected (B, {Cin}, N)")
    B, _, N = src.shape
    rows = vector_rows(v_off, S, V)
    if src.device.type == "cpu":
        return sv_point_block_cm_plain(src, gate, folded, S=S, V=V,
                                       S_out=S_out, V_out=V_out,
                                       v_off=v_off, binary=binary)
    dev = require_cuda(src.device)
    _build.check_arg(src, "src", (B, Cin, N), dev)
    _build.check_arg(gate, "gate", (B, V_out), dev)
    w = _weights(folded, S, V, S_out, V_out, dev, binary)
    lib = _build.lib()
    vrow = torch.tensor(rows, dtype=torch.int32, device=dev)
    Cout = S_out + 3 * V_out
    x = torch.empty((B, Cout, N), device=dev)
    nblk = (N + _BLOCK - 1) // _BLOCK
    smax = torch.empty((B, nblk, S_out), device=dev)
    vsum = torch.empty((B, nblk, 3 * V_out), device=dev)
    err = lib.sv_point_launch(
        src.data_ptr(), gate.data_ptr(), vrow.data_ptr(), *w, x.data_ptr(),
        smax.data_ptr(), vsum.data_ptr(), B, N, S, V, S_out, V_out,
        int(binary), _build.stream_ptr(dev))
    _build.check(err, "sv_point_block_cm")
    sv_point_block_cm.launches += 1
    return x, torch.amax(smax, dim=1), torch.sum(vsum, dim=1) / N


sv_point_block_cm.launches = 0


def sv_point_block_plain(src: torch.Tensor, gate: torch.Tensor,
                         folded: Folded, *, S: int, V: int, S_out: int,
                         V_out: int, binary: bool):
    B, N, _ = src.shape
    return _point_rows(src[..., :S], src[..., S:].reshape(B, N, 3, V), gate,
                       folded, binary)


def sv_point_block(src: torch.Tensor, gate: torch.Tensor, folded: Folded, *,
                   S: int, V: int, S_out: int, V_out: int,
                   binary: bool = True):
    """Row-major: src (B, N, S+3V) -> (x (B, N, S_out+3*V_out), s5_max,
    v5_mean); see the module docstring."""
    Cin = S + 3 * V
    if src.dim() != 3 or src.shape[-1] != Cin:
        raise ValueError(f"src: shape {tuple(src.shape)}, expected (B, N, {Cin})")
    B, N, _ = src.shape
    if src.device.type == "cpu":
        return sv_point_block_plain(src, gate, folded, S=S, V=V, S_out=S_out,
                                    V_out=V_out, binary=binary)
    dev = require_cuda(src.device)
    _build.check_arg(src, "src", (B, N, Cin), dev)
    _build.check_arg(gate, "gate", (B, V_out), dev)
    w = _weights(folded, S, V, S_out, V_out, dev, binary)
    x = torch.empty((B, N, S_out + 3 * V_out), device=dev)
    nblk = (N + _BLOCK - 1) // _BLOCK
    smax = torch.empty((B, nblk, S_out), device=dev)
    vsum = torch.empty((B, nblk, 3 * V_out), device=dev)
    err = _build.lib().sv_point_rm_launch(
        src.data_ptr(), gate.data_ptr(), *w, x.data_ptr(), smax.data_ptr(),
        vsum.data_ptr(), B, N, S, V, S_out, V_out, int(binary),
        _build.stream_ptr(dev))
    _build.check(err, "sv_point_block")
    sv_point_block.launches += 1
    return x, torch.amax(smax, dim=1), torch.sum(vsum, dim=1) / N


sv_point_block.launches = 0
