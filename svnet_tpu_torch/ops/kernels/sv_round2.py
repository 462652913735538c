"""The legacy row-major fused rounds, exact mode, kernel B10b (counterparts
of svnet_tpu/ops/pallas/sv_round2.py::sv_round2_first and ::sv_round2):
the trunk behind ``rounds_impl="round2"`` of both SV-DGCNN engines.

Row-major contract of the JAX functions: the first round takes points
(B, N, 3), the conv round ``src (B, N, S + 3V)`` = [s | v flat i-major];
both return ``s (B, N, S_out)``, ``v (B, N, 3*V_out)`` UNGATED (column
``i*V_out + c``) and the gate statistics (the first round's init-scalar
mean (B, 3*n_ch) c-major, a conv round's edge-scalar mean (B, 2S)), plus
the ``(B, N, k)`` int32 neighbour ids when ``emit_wins``. The function is
the round3 kernels' (ops/kernels/sv_round3.py) on another layout: the
plain versions share its row-major core, so the two trunks agree bitwise.
``launch_first`` and ``launch_conv`` also launch B10a (sv_round.py), the
same function through its own entry points.

A CPU tensor goes to the plain version; a CUDA tensor launches
csrc/sv_round2.cu or raises. ``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from svnet_tpu_torch.config import require_cuda
from svnet_tpu_torch.ops.kernels import _build
from svnet_tpu_torch.ops.kernels.fold import Folded
from svnet_tpu_torch.ops.kernels.sv_round3 import (
    conv_round_rows,
    first_perm,
    first_round_rows,
)


def check_points(points: torch.Tensor, k: int) -> None:
    if points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError(f"points: shape {tuple(points.shape)}, expected (B, N, 3)")
    if not 1 <= k <= points.shape[1]:
        raise ValueError(f"k={k} must lie in [1, N={points.shape[1]}]")


def check_src(src: torch.Tensor, C: int, k: int) -> None:
    if src.dim() != 3 or src.shape[-1] != C:
        raise ValueError(f"src: shape {tuple(src.shape)}, expected (B, N, {C})")
    if not 1 <= k <= src.shape[1]:
        raise ValueError(f"k={k} must lie in [1, N={src.shape[1]}]")


def launch_first(entry: str, points: torch.Tensor, folded: Folded, *,
                 S_out: int, V_out: int, k: int, cross: bool):
    """Launch the row-major first round through the library's ``entry``
    (B10b's or B10a's) on CUDA points: (s, v ungated, s_mean, wins)."""
    B, N, _ = points.shape
    dev = require_cuda(points.device)
    _build.check_arg(points, "points", (B, N, 3), dev)
    f, n_ch = folded, 3 if cross else 2
    w = [_build.check_arg(f["wz0"], "wz0", (n_ch, 3), dev),
         _build.check_arg(f["wz1"], "wz1", (n_ch, 3), dev),
         _build.check_arg(f["w1"], "w1", (6 * n_ch, S_out), dev),
         _build.check_arg(f["a1"], "a1", (1, S_out), dev),
         _build.check_arg(f["b1"], "b1", (1, S_out), dev),
         _build.check_arg(f["w2"], "w2", (n_ch, V_out), dev),
         _build.check_arg(f["a2"], "a2", (1, V_out), dev),
         _build.check_arg(f["b2"], "b2", (1, V_out), dev)]
    lib = _build.lib()
    aa = torch.empty((B, N), device=dev)
    s = torch.empty((B, N, S_out), device=dev)
    v = torch.empty((B, N, 3 * V_out), device=dev)
    ssum = torch.empty((B, 3 * n_ch, N), device=dev)
    wins = torch.empty((B, N, k), device=dev, dtype=torch.int32)
    err = getattr(lib, entry)(
        points.data_ptr(), aa.data_ptr(), *w, s.data_ptr(), v.data_ptr(),
        ssum.data_ptr(), wins.data_ptr(), B, N, k, S_out, V_out, int(cross),
        _build.stream_ptr(dev))
    _build.check(err, entry)
    s_mean = ssum.sum(dim=2)[:, first_perm(n_ch)] / (N * k)
    return s, v, s_mean, wins


def launch_conv(entry: str, src: torch.Tensor, folded: Folded, *, S: int,
                V: int, S_out: int, V_out: int, k: int, binary: bool):
    """Launch the row-major conv round through the library's ``entry``
    (B10b's or B10a's) on a CUDA src: (s, v ungated, s_edge_mean, wins)."""
    B, N, C = src.shape
    dev = require_cuda(src.device)
    _build.check_arg(src, "src", (B, N, C), dev)
    IN1, f = 2 * S + 6 * V, folded
    w = [_build.check_arg(f["wz"], "wz", (2 * V, 3), dev),
         _build.check_arg(f["w1"], "w1", (IN1, S_out), dev),
         _build.check_arg(f["beta"], "beta", (1, IN1), dev),
         _build.check_arg(f["a1"], "a1", (1, S_out), dev),
         _build.check_arg(f["b1"], "b1", (1, S_out), dev),
         _build.check_arg(f["w2"], "w2", (2 * V, V_out), dev),
         _build.check_arg(f["scale2"], "scale2", (1, V_out), dev),
         _build.check_arg(f["a2"], "a2", (1, V_out), dev),
         _build.check_arg(f["b2"], "b2", (1, V_out), dev)]
    lib = _build.lib()
    aa = torch.empty((B, N), device=dev)
    s = torch.empty((B, N, S_out), device=dev)
    v = torch.empty((B, N, 3 * V_out), device=dev)
    ssum = torch.empty((B, 2 * S, N), device=dev)
    wins = torch.empty((B, N, k), device=dev, dtype=torch.int32)
    err = getattr(lib, entry)(
        src.data_ptr(), aa.data_ptr(), *w, s.data_ptr(), v.data_ptr(),
        ssum.data_ptr(), wins.data_ptr(), B, N, S, V, S_out, V_out, k,
        int(binary), _build.stream_ptr(dev))
    _build.check(err, entry)
    return s, v, ssum.sum(dim=2) / (N * k), wins


def sv_round2_first_plain(points: torch.Tensor, folded: Folded, *,
                          S_out: int, V_out: int, k: int, cross: bool = False):
    """Plain version of the first round; the kernel's outputs with the ids
    (B, N, k) last."""
    return first_round_rows(points, folded, S_out=S_out, V_out=V_out, k=k,
                            cross=cross)


def sv_round2_first(points: torch.Tensor, folded: Folded, *, S_out: int,
                    V_out: int, k: int, cross: bool = False,
                    emit_wins: bool = False):
    """points (B, N, 3) -> (s (B, N, S_out), v (B, N, 3*V_out) ungated,
    s_mean (B, 3*n_ch) c-major[, wins (B, N, k) int32]); n_ch = 3 with
    ``cross``, else 2. The kernel takes S_out = 32 and V_out = 10 or 16."""
    check_points(points, k)
    kw = dict(S_out=S_out, V_out=V_out, k=k, cross=cross)
    if points.device.type == "cpu":
        out = sv_round2_first_plain(points, folded, **kw)
    else:
        out = launch_first("sv_round2_first_launch", points, folded, **kw)
        sv_round2_first.launches += 1
    return out if emit_wins else out[:3]


sv_round2_first.launches = 0


def sv_round2_plain(src: torch.Tensor, folded: Folded, *, S: int, V: int,
                    S_out: int, V_out: int, k: int, binary: bool):
    """Plain version of a conv round on row-major src (B, N, S+3V); the
    kernel's outputs with the ids (B, N, k) last."""
    return conv_round_rows(src, folded, S=S, V=V, S_out=S_out, V_out=V_out,
                           k=k, binary=binary)


def sv_round2(src: torch.Tensor, folded: Folded, *, S: int, V: int,
              S_out: int, V_out: int, k: int, binary: bool = True,
              emit_wins: bool = False):
    """src (B, N, S+3V) row-major [s | v i-major] -> (s (B, N, S_out),
    v (B, N, 3*V_out) ungated, s_edge_mean (B, 2S)[, wins (B, N, k)])."""
    check_src(src, S + 3 * V, k)
    kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=k, binary=binary)
    if src.device.type == "cpu":
        out = sv_round2_plain(src, folded, **kw)
    else:
        out = launch_conv("sv_round2_launch", src, folded, **kw)
        sv_round2.launches += 1
    return out if emit_wins else out[:3]


sv_round2.launches = 0
