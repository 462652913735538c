"""The legacy row-major fused rounds, kernel B10b, exact, fast and approx
mode (counterparts of svnet_tpu/ops/pallas/sv_round2.py::sv_round2_first
and ::sv_round2): the trunk behind ``rounds_impl="round2"`` of both
SV-DGCNN engines.

Row-major contract of the JAX functions: the first round takes points
(B, N, 3), the conv round ``src (B, N, S + 3V)`` = [s | v flat i-major];
both return ``s (B, N, S_out)``, ``v (B, N, 3*V_out)`` UNGATED (column
``i*V_out + c``) and the gate statistics (the first round's init-scalar
mean (B, 3*n_ch) c-major, a conv round's edge-scalar mean (B, 2S)), plus
the ``(B, N, k)`` int32 neighbour ids when ``emit_wins``. The function is
the round3 kernels' (ops/kernels/sv_round3.py) on another layout: the
plain versions share its row-major core, so the two trunks agree bitwise
in exact mode. ``launch_first`` and ``launch_conv`` also launch B10a
(sv_round.py), the same function through its own entry points.

``mode="fast"`` ranks by round3's packed 18-bit key (``_packed_key``,
:197-210) on the scale of each key tile of ``T`` centres (the JAX
function's program: T is part of the result; the engines take it from
``quant.auto_round_tile``), over the raw features, and runs the block on
the rows through the 16-bit grid (``pack_planes_fast``, :95-154) whatever
``config.fast_gather_bits`` says. ``mode="approx"`` folds those keys to
L = ``quant.fold_width(N, k, APPROX_L2)`` lanes by key max (``_build_key``,
:213-228; the fold is fixed at 256 lanes, not ``config.approx_fold``) and
keeps the 16-bit grid. On a CUDA tensor the key tiles' scales come from
the pre-pass kernel (``ops.kernels.knn.neg_min``), then the round's
kernel runs; nothing falls back to the plain version.

A CPU tensor goes to the plain version; a CUDA tensor launches
csrc/sv_round2.cu or raises. ``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from svnet_tpu_torch import config
from svnet_tpu_torch.config import require_cuda
from svnet_tpu_torch.ops.kernels import _build
from svnet_tpu_torch.ops.kernels.fold import Folded
from svnet_tpu_torch.ops.kernels.quant import APPROX_L2, fold_width
from svnet_tpu_torch.ops.kernels.sv_round3 import (
    conv_round_rows,
    data_ptr,
    fast_args,
    first_perm,
    first_round_rows,
)

MAX_N_PACKED = 1 << 20  # the packed key's rows (sv_round2.py:398)


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


def key_tile(mode: str, N: int, T: int, k: int,
             fold: int | None = APPROX_L2) -> int | None:
    """A legacy round's key tile: None in exact mode (its selection reads
    no tile), else ``T``, raising where the JAX functions assert: T must
    divide N, the packed key holds at most 2^20 rows, and in approx mode N
    must halve evenly to at least k lanes at ``fold`` (C20)."""
    if config.check_mode(mode) == "exact":
        return None
    if T < 1 or N % T:
        raise ValueError(f"key tile T={T} must divide N={N}")
    if N > MAX_N_PACKED:
        raise ValueError(f"mode {mode!r}: the packed key holds at most "
                         f"{MAX_N_PACKED} rows, N={N}")
    if mode == "approx":
        fold_width(N, k, fold)
    return T


def launch_first(entry: str, points: torch.Tensor, folded: Folded, *,
                 S_out: int, V_out: int, k: int, cross: bool,
                 mode: str = "exact", T: int | None = None,
                 grid: int | str = 16, fold: int | None = APPROX_L2):
    """Launch the row-major first round through the library's ``entry``
    (B10b's or B10a's) on CUDA points: (s, v ungated, s_mean, wins). Fast
    and approx ``mode`` on key tiles of ``T``, through the gather grid
    ``grid`` (16 bits, or "bf16"), approx folding at ``fold``."""
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
    pts_q, scale, L = fast_args(points, T, mode, cm=False, grid=grid, fold=fold)
    aa = torch.empty((B, N), device=dev)
    s = torch.empty((B, N, S_out), device=dev)
    v = torch.empty((B, N, 3 * V_out), device=dev)
    ssum = torch.empty((B, 3 * n_ch, N), device=dev)
    wins = torch.empty((B, N, k), device=dev, dtype=torch.int32)
    err = getattr(lib, entry)(
        points.data_ptr(), aa.data_ptr(), *w, s.data_ptr(), v.data_ptr(),
        ssum.data_ptr(), wins.data_ptr(), data_ptr(pts_q), data_ptr(scale), B, N, k,
        S_out, V_out, int(cross), T or 0, L, _build.stream_ptr(dev))
    _build.check(err, entry)
    s_mean = ssum.sum(dim=2)[:, first_perm(n_ch)] / (N * k)
    return s, v, s_mean, wins


def launch_conv(entry: str, src: torch.Tensor, folded: Folded, *, S: int,
                V: int, S_out: int, V_out: int, k: int, binary: bool,
                mode: str = "exact", T: int | None = None,
                grid: int | str = 16, fold: int | None = APPROX_L2):
    """Launch the row-major conv round through the library's ``entry``
    (B10b's or B10a's) on a CUDA src: (s, v ungated, s_edge_mean, wins);
    ``mode``, ``T``, ``grid`` and ``fold`` as ``launch_first``'s."""
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
    src_q, scale, L = fast_args(src, T, mode, cm=False, grid=grid, fold=fold)
    aa = torch.empty((B, N), device=dev)
    s = torch.empty((B, N, S_out), device=dev)
    v = torch.empty((B, N, 3 * V_out), device=dev)
    ssum = torch.empty((B, 2 * S, N), device=dev)
    wins = torch.empty((B, N, k), device=dev, dtype=torch.int32)
    err = getattr(lib, entry)(
        src.data_ptr(), aa.data_ptr(), *w, s.data_ptr(), v.data_ptr(),
        ssum.data_ptr(), wins.data_ptr(), data_ptr(src_q), data_ptr(scale), B, N, S,
        V, S_out, V_out, k, int(binary), T or 0, L, _build.stream_ptr(dev))
    _build.check(err, entry)
    return s, v, ssum.sum(dim=2) / (N * k), wins


def sv_round2_first_plain(points: torch.Tensor, folded: Folded, *,
                          S_out: int, V_out: int, k: int, cross: bool = False,
                          mode: str = "exact", T: int = 128):
    """Plain version of the first round; the kernel's outputs with the ids
    (B, N, k) last."""
    T = key_tile(mode, points.shape[1], T, k)
    return first_round_rows(points, folded, S_out=S_out, V_out=V_out, k=k,
                            cross=cross, T=T, mode=mode, grid=16,
                            fold=APPROX_L2)


def sv_round2_first(points: torch.Tensor, folded: Folded, *, S_out: int,
                    V_out: int, k: int, cross: bool = False,
                    mode: str = "exact", T: int = 128,
                    emit_wins: bool = False):
    """points (B, N, 3) -> (s (B, N, S_out), v (B, N, 3*V_out) ungated,
    s_mean (B, 3*n_ch) c-major[, wins (B, N, k) int32]); n_ch = 3 with
    ``cross``, else 2. The kernel takes S_out = 32 and V_out = 10 or 16.
    ``mode`` "exact", "fast" or "approx" on key tiles of ``T`` (see the
    module's docstring; exact mode reads no T)."""
    check_points(points, k)
    T = key_tile(mode, points.shape[1], T, k)
    kw = dict(S_out=S_out, V_out=V_out, k=k, cross=cross, mode=mode, T=T)
    if points.device.type == "cpu":
        out = sv_round2_first_plain(points, folded, **kw)
    else:
        out = launch_first("sv_round2_first_launch", points, folded, **kw)
        sv_round2_first.launches += 1
    return out if emit_wins else out[:3]


sv_round2_first.launches = 0


def sv_round2_plain(src: torch.Tensor, folded: Folded, *, S: int, V: int,
                    S_out: int, V_out: int, k: int, binary: bool,
                    mode: str = "exact", T: int = 128):
    """Plain version of a conv round on row-major src (B, N, S+3V); the
    kernel's outputs with the ids (B, N, k) last."""
    T = key_tile(mode, src.shape[1], T, k)
    return conv_round_rows(src, folded, S=S, V=V, S_out=S_out, V_out=V_out,
                           k=k, binary=binary, T=T, mode=mode, grid=16,
                           fold=APPROX_L2)


def sv_round2(src: torch.Tensor, folded: Folded, *, S: int, V: int,
              S_out: int, V_out: int, k: int, binary: bool = True,
              mode: str = "exact", T: int = 128, emit_wins: bool = False):
    """src (B, N, S+3V) row-major [s | v i-major] -> (s (B, N, S_out),
    v (B, N, 3*V_out) ungated, s_edge_mean (B, 2S)[, wins (B, N, k)]);
    ``mode`` and ``T`` as ``sv_round2_first``'s."""
    check_src(src, S + 3 * V, k)
    T = key_tile(mode, src.shape[1], T, k)
    kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=k, binary=binary,
              mode=mode, T=T)
    if src.device.type == "cpu":
        out = sv_round2_plain(src, folded, **kw)
    else:
        out = launch_conv("sv_round2_launch", src, folded, **kw)
        sv_round2.launches += 1
    return out if emit_wins else out[:3]


sv_round2.launches = 0
