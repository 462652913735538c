"""Fused SV-DGCNN rounds, exact, fast and approx mode (counterparts of
svnet_tpu/ops/pallas/sv_round3.py::sv_round3_first and ::sv_round3).

Each wrapper keeps the JAX function's channel-major contract: the conv
round takes ``src (B, S + 3V, N)`` and both return ``s (B, S_out, N)``,
``v (B, 3*V_out, N)`` UNGATED (rows ``i*V_out + c``) and the gate
statistics, plus the ``(B, k, N)`` neighbour ids when ``emit_wins``.
Weights are the folded dicts of ``svnet_tpu_torch.ops.kernels.fold``.

A CPU tensor goes to the plain PyTorch version beside each kernel; a CUDA
tensor launches the kernel (csrc/sv_round3_first.cu, csrc/sv_round3.cu)
or raises. ``<wrapper>.launches`` counts kernel launches.

The plain versions contract and accumulate in the kernels' order, each
product and sum rounded on its own (the kernels are built with
-fmad=false), so a kernel and its plain version agree bitwise on any
device: a binarized sign never flips between them, and the whole engine
can be checked against its plain twin on the card exactly.

``mode="fast"`` (ops/kernels/quant.py) ranks neighbours by the packed
18-bit key on the scale of each key tile of T centres (T from
``quant.round3_tiles`` unless given) over the raw features, and runs the
block on the features through the gather grid of
``config.fast_gather_bits``. On a CUDA tensor the tiles' scales come
from the pre-pass kernel (``ops.kernels.knn.neg_min``), then the round's
kernel runs; nothing falls back to the plain version.

``mode="approx"`` takes fast's keys and folds each centre's N candidates
to L = ``quant.fold_width(N)`` lanes by key max before the top k (lane i
the best row m = i mod L); the kernel's selection folds in shared memory
and is told L (0 where nothing folds, L = N: approx is fast bitwise). Its
key tile and grid follow ``config.approx_gather_bits`` (``quant.gb8``).
A k above L raises.

Graph reuse (``wins_in``, svnet_tpu/ops/pallas/sv_round3.py's take_wins
round): a conv round given an earlier round's neighbour ids (B, k, N)
int32 selects nothing and runs the block on them, reading the rows
through the mode's gather grid in fast and approx mode. It returns no ids,
makes one launch (``sv_round3_reuse``, also counted on
``sv_round3.launches``) and needs no pre-pass. ``gather_window``, the
TPU's compaction of the winners' row blocks, is bitwise the full gather,
which is what runs here. The ids may be the first ranks of a wider
tensor (``wins[:, :r]``): the kernel takes their batch stride.

The candidate window (``window=``, sv_round3.py:548-591, :1274-1313,
:1196-1205, :1574-1583; ops/window.py): for 0 < window < N the round
tiles its centres by T in every mode (``key_tile``), the pre-pass
certifies each tile's kept 128-row blocks, and where the whole batch
fits W rows a tile ranks only those (compacted in block order; fast
mode's key scale from the kept rows, with 0.0 where the window has
padding; approx mode folding the W positions to ``quant.fold_width(W)``
lanes), else every row, as without a window. The kernels read the
certificate on the card: one launch of the windowed selection and the
block (``<wrapper>.window_launches`` counts them beside ``launches``),
after the pre-pass's kernels and, in fast and approx mode, the windowed
scale pre-pass. Exact mode's result is the full scan's, bitwise. The
window excludes ``wins_in``.
"""

from __future__ import annotations

import torch

from svnet_tpu_torch import config, ops
from svnet_tpu_torch.config import EPS, require_cuda
from svnet_tpu_torch.nn.sv_layers import binary_matmul, v2s_invariants
from svnet_tpu_torch.ops.kernels import _build, quant
from svnet_tpu_torch.ops.kernels.fold import Folded
from svnet_tpu_torch.ops.kernels.knn import neg_min
from svnet_tpu_torch.ops.knn import (
    knn_approx_plain,
    knn_fast_plain,
    knn_window_plain,
)
from svnet_tpu_torch.ops.window import check_window, prune_prepass


def jmajor(s: torch.Tensor, multi: int = 3) -> torch.Tensor:
    """Vector2Scalar output (..., C*multi) c-major -> j-major (j*C + c)."""
    C = s.shape[-1] // multi
    return s.reshape(s.shape[:-1] + (C, multi)).transpose(-1, -2).reshape(s.shape)


def _leaky(y: torch.Tensor) -> torch.Tensor:
    return torch.where(y >= 0, y, 0.2 * y)


def vector_bn_scale(wl: torch.Tensor, a2: torch.Tensor,
                    b2: torch.Tensor) -> torch.Tensor:
    """Folded eval VectorBN factor on (..., 3, V): ``a2 + b2 / (|wl| + EPS)``
    (..., 1, V); the normalized vectors are ``wl`` times it."""
    nsq = (wl[..., 0, :] * wl[..., 0, :] + wl[..., 1, :] * wl[..., 1, :]
           + wl[..., 2, :] * wl[..., 2, :])
    return (a2 + b2 / (torch.sqrt(nsq) + EPS))[..., None, :]


def ordered_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for w (K, O), accumulated over K in order, as the kernels
    do (a library matmul picks its own order)."""
    acc = x[..., 0:1] * w[0]
    for q in range(1, w.shape[0]):
        acc += x[..., q:q + 1] * w[q]
    return acc


def rank_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the rank axis (dim 2) of (B, N, k, ...), rank by rank."""
    acc = x[:, :, 0].clone()
    for r in range(1, x.shape[2]):
        acc += x[:, :, r]
    return acc


def _rank_mean(x: torch.Tensor) -> torch.Tensor:
    """svpool's vector mean as the kernels take it: sum * (1/k)."""
    return rank_sum(x) * (1.0 / x.shape[2])


def _point_sums(x: torch.Tensor) -> torch.Tensor:
    """(B, N, k, C) -> per-point rank sums laid out (B, C, N), as the
    kernels emit their gate statistics."""
    return rank_sum(x).transpose(1, 2).contiguous()


def first_perm(n_ch: int = 2) -> list[int]:
    """j-major (j*n_ch + c) -> the reference's c-major (c*3 + j) order."""
    return [j * n_ch + c for c in range(n_ch) for j in range(3)]


def key_tile(mode: str, N: int, C: int, T: int | None, k: int,
             window: int = 0) -> int | None:
    """A round's key tile: None in exact mode without an active window
    (0 < window < N), else ``T`` or the JAX package's heuristic
    (``quant.round3_tiles``); it must divide N. In approx mode N must fold
    (``quant.fold_width``) to at least k lanes."""
    if config.check_mode(mode) == "exact" and not 0 < window < N:
        return None
    T = T or quant.round3_tiles(N, C, mode)
    if N % T:
        raise ValueError(f"key tile T={T} must divide N={N}")
    if mode == "approx":
        quant.fold_width(N, k)
    return T


def round_window(x: torch.Tensor, k: int, T: int | None, window: int,
                 mode: str, plain: bool = False):
    """A round's candidate window over row-major x (B, N, C): None where
    it is off, else (T, W, keep, ok) from ``ops.window.prune_prepass`` on
    x's device (keep (B, N/T, N/128) and ok () int32, never read on the
    host here; ``plain``: the pre-pass's plain block test). ``T`` is the
    round's ``key_tile``."""
    W = check_window(window, x.shape[1], T, k, mode)
    if not W:
        return None
    keep, ok = prune_prepass(x, k, T, W, plain)
    return T, W, keep.contiguous(), ok.to(torch.int32)


def _select(x: torch.Tensor, k: int, T: int | None, mode: str, win=None,
            grid: int | str | None = None, fold: int | None = None):
    """The plain selection and the block's rows for row-major x (B, N, C):
    exact mode's (knn_plain, x), or fast or approx mode's on key tiles of
    T (knn_fast_plain, or knn_approx_plain at the fold width ``fold``; x
    through the gather grid ``grid``, ``quant.grid_rows``); over a
    candidate window ``win`` (``round_window``) knn_window_plain's. The
    round3 trunk leaves ``grid`` and ``fold`` None (``config``'s); the
    legacy trunks pass their own."""
    rows = x if mode == "exact" else quant.grid_rows(x, mode, grid)
    if win is not None:
        T, W, keep, ok = win
        return knn_window_plain(x, k, T, W, keep, ok, mode), rows
    if mode == "exact":
        return ops.knn_plain(x, k), rows
    if mode == "approx":
        return knn_approx_plain(x, k, T, fold), rows
    return knn_fast_plain(x, k, T), rows


def fast_args(x: torch.Tensor, T: int | None, mode: str, cm: bool, win=None,
              grid: int | str | None = None, fold: int | None = None):
    """The kernels' fast- and approx-mode arguments for row-major x
    (B, N, C): the block's rows through the gather grid ``grid``
    (``_select``; channel-major when ``cm``), the key tiles' scales from
    the pre-pass (over the window ``win``, if any) and the fold width L at
    ``fold`` (0: no fold); in exact mode (None, None, 0). The tensors are
    returned to outlive the launch."""
    if mode == "exact":
        return None, None, 0
    N = x.shape[1]
    L = quant.fold_width(N, fold=fold) if mode == "approx" else N
    xq = quant.grid_rows(x, mode, grid)
    xq = (xq.transpose(1, 2) if cm else xq).contiguous()
    scale = quant.tile_scales(neg_min(x, win), T, N).contiguous()
    return xq, scale, (L if L < N else 0)


def _window_args(win, mode: str) -> tuple:
    """The launchers' window arguments: keep, ok, W and approx mode's fold
    width at W (0 in the other modes); no window: (None, None, 0, 0)."""
    if win is None:
        return None, None, 0, 0
    _, W, keep, ok = win
    return keep, ok, W, (quant.fold_width(W) if mode == "approx" else 0)


def data_ptr(t: torch.Tensor | None):
    """A launcher's pointer argument: the tensor's address, or None."""
    return None if t is None else t.data_ptr()


def check_ids(idx: torch.Tensor, shape: tuple, N: int, device,
              in_range: bool = False) -> None:
    """Neighbour ids of ``shape``, int32 on ``device``, every id in [0, N):
    the kernels never read outside the source (ROADMAP C17). The range
    check waits for the device; ``in_range`` skips it, for ids that a
    selecting round emitted over the same N points."""
    if not isinstance(idx, torch.Tensor) or idx.dtype != torch.int32:
        raise TypeError(f"idx: expected an int32 tensor, got "
                        f"{getattr(idx, 'dtype', type(idx).__name__)}")
    if tuple(idx.shape) != tuple(shape):
        raise ValueError(f"idx: shape {tuple(idx.shape)}, expected {tuple(shape)}")
    if idx.device != device:
        raise ValueError(f"idx: on {idx.device}, expected {device}")
    if in_range:
        return
    lo, hi = torch.aminmax(idx)
    if int(lo) < 0 or int(hi) >= N:
        raise ValueError(f"idx: ids in [{int(lo)}, {int(hi)}] leave [0, {N})")


# ---------------------------------------------------------------------------
# B1: the first round
# ---------------------------------------------------------------------------


def first_block_rows(points: torch.Tensor, idx: torch.Tensor, folded: Folded,
                     *, S_out: int, V_out: int, cross: bool = False):
    """The first round's block on the neighbour ids ``idx`` (B, N, k),
    row-major: (s (B, N, S_out), v (B, N, 3*V_out) ungated, s_mean
    (B, 3*n_ch) c-major). Shared by every first round's plain version."""
    B, N, _ = points.shape
    k = idx.shape[-1]
    edges = ops.get_graph_feature_cross if cross else ops.get_graph_feature
    v = edges(points, k, idx, plain=True)  # (B, N, k, 3, n_ch)
    sva = jmajor(v2s_invariants(v, ordered_matmul(v, folded["wz0"])))
    svb = jmajor(v2s_invariants(v, ordered_matmul(v, folded["wz1"])))
    h = ordered_matmul(torch.cat([sva, svb], dim=-1), folded["w1"])
    y = _leaky(h * folded["a1"] + folded["b1"])
    wl = ordered_matmul(v, folded["w2"])
    vb = wl * vector_bn_scale(wl, folded["a2"], folded["b2"])
    s = torch.amax(y, dim=2)  # svpool: max over k, vector mean
    vm = _rank_mean(vb)  # (B, N, 3, V_out)
    s_mean = _point_sums(sva).sum(dim=2)[:, first_perm(v.shape[-1])] / (N * k)
    return s, vm.reshape(B, N, 3 * V_out), s_mean


def first_round_rows(points: torch.Tensor, folded: Folded, *, S_out: int,
                     V_out: int, k: int, cross: bool = False,
                     T: int | None = None, mode: str = "exact", win=None,
                     grid: int | str | None = None, fold: int | None = None):
    """The first round's function on row-major outputs, shared by the plain
    versions of both layouts and trunks: the kNN (fast or approx ``mode``'s
    on key tiles of ``T`` when given, ``grid`` and ``fold`` as
    ``_select``'s; over the candidate window ``win``), then
    ``first_block_rows``; (s, v ungated, s_mean, ids (B, N, k) int32)."""
    idx, rows = _select(points, k, T, mode, win, grid, fold)
    return (*first_block_rows(rows, idx, folded, S_out=S_out, V_out=V_out,
                              cross=cross), idx)


def sv_round3_first_plain(points: torch.Tensor, folded: Folded, *,
                          S_out: int, V_out: int, k: int, cross: bool = False,
                          mode: str = "exact", T: int | None = None,
                          window: int = 0):
    """Plain version of the first round; same outputs as the kernel, with
    the neighbour ids (B, k, N) int32 last."""
    T = key_tile(mode, points.shape[1], 3, T, k, window)
    win = round_window(points, k, T, window, mode, plain=True)
    s, v, s_mean, idx = first_round_rows(points, folded, S_out=S_out,
                                         V_out=V_out, k=k, cross=cross, T=T,
                                         mode=mode, win=win)
    return s.transpose(1, 2), v.transpose(1, 2), s_mean, idx.transpose(1, 2)


def sv_round3_first(points: torch.Tensor, folded: Folded, *, S_out: int,
                    V_out: int, k: int, cross: bool = False,
                    mode: str = "exact", T: int | None = None,
                    emit_wins: bool = False, window: int = 0):
    """points (B, N, 3) -> (s (B, S_out, N), v (B, 3*V_out, N) ungated,
    s_mean (B, 3*n_ch) c-major[, wins (B, k, N) int32]); the edges carry
    n_ch = 3 channels with ``cross`` (SV-PointNet), else 2. The kernel takes
    S_out = 32 and V_out = 10 or 16 (SV_DGCNN_PSEG's conv1). ``mode``
    "exact", "fast" or "approx" (key tiles of ``T``: see the module's
    docstring); ``window``: the candidate window (0 = off; see the
    module's docstring)."""
    if points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError(f"points: shape {tuple(points.shape)}, expected (B, N, 3)")
    B, N, _ = points.shape
    if not 1 <= k <= N:
        raise ValueError(f"k={k} must lie in [1, N={N}]")
    T = key_tile(mode, N, 3, T, k, window)
    if points.device.type == "cpu":
        out = sv_round3_first_plain(points, folded, S_out=S_out, V_out=V_out,
                                    k=k, cross=cross, mode=mode, T=T,
                                    window=window)
        return out if emit_wins else out[:3]
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
    pts = points.transpose(1, 2).contiguous()  # (B, 3, N)
    win = round_window(points, k, T, window, mode)
    pts_q, scale, L = fast_args(points, T, mode, cm=True, win=win)
    keep, ok, W, LW = _window_args(win, mode)
    aa = torch.empty((B, N), device=dev)
    s = torch.empty((B, S_out, N), device=dev)
    v = torch.empty((B, 3 * V_out, N), device=dev)
    ssum = torch.empty((B, 3 * n_ch, N), device=dev)
    wins = torch.empty((B, k, N), device=dev, dtype=torch.int32)
    err = lib.sv_round3_first_launch(
        pts.data_ptr(), aa.data_ptr(), *w, s.data_ptr(), v.data_ptr(),
        ssum.data_ptr(), wins.data_ptr(), data_ptr(pts_q), data_ptr(scale), data_ptr(keep),
        data_ptr(ok), B, N, k, S_out, V_out, int(cross), T or 0, L, W, LW,
        _build.stream_ptr(dev))
    _build.check(err, "sv_round3_first")
    sv_round3_first.launches += 1
    sv_round3_first.window_launches += win is not None
    s_mean = ssum.sum(dim=2)[:, first_perm(n_ch)] / (N * k)
    out = (s, v, s_mean, wins)
    return out if emit_wins else out[:3]


sv_round3_first.launches = 0
sv_round3_first.window_launches = 0


# ---------------------------------------------------------------------------
# B2: a conv round
# ---------------------------------------------------------------------------


def conv_block_rows(x: torch.Tensor, idx: torch.Tensor, folded: Folded, *,
                    S: int, V: int, S_out: int, V_out: int, binary: bool,
                    v2_bf16: bool = False):
    """A conv round's block on row-major x (B, N, S + 3V) and the neighbour
    ids ``idx`` (B, N, k): (s (B, N, S_out), v (B, N, 3, V_out) ungated,
    the edge scalars s_e (B, N, k, 2S)). Shared by every conv round's plain
    version. ``v2_bf16``: linear2 reads the edge vectors and w2 rounded to
    bf16 (B10c's ``exact=False``, sv_edge.py:144-152)."""
    B, N, _ = x.shape
    k = idx.shape[-1]
    s_e, v_e = ops.get_graph_feature_sv(
        (x[..., :S], x[..., S:].reshape(B, N, 3, V)), k, idx, plain=True)
    sv = jmajor(v2s_invariants(v_e, ordered_matmul(v_e, folded["wz"])))
    xc = torch.cat([s_e, sv], dim=-1)  # (B, N, k, 2S + 6V)
    if binary:  # +-1 products: exact in any order
        h = binary_matmul(torch.sign(xc + folded["beta"]), folded["w1"])
    else:
        h = ordered_matmul(xc, folded["w1"])
    y = _leaky(h * folded["a1"] + folded["b1"])
    v2, w2 = v_e, folded["w2"]
    if v2_bf16:
        v2, w2 = quant.bf16_rows(v_e), quant.bf16_rows(w2)
    wl = ordered_matmul(v2, w2) * folded["scale2"]
    vb = wl * vector_bn_scale(wl, folded["a2"], folded["b2"])
    return torch.amax(y, dim=2), _rank_mean(vb), s_e  # svpool: max, mean


def conv_round_rows(x: torch.Tensor, folded: Folded, *, S: int, V: int,
                    S_out: int, V_out: int, k: int, binary: bool,
                    T: int | None = None, mode: str = "exact",
                    idx: torch.Tensor | None = None, win=None,
                    grid: int | str | None = None, fold: int | None = None):
    """A conv round's function on row-major x (B, N, S + 3V), shared by the
    plain versions of both layouts and trunks: the kNN (fast or approx
    ``mode``'s on key tiles of ``T`` when given, ``grid`` and ``fold`` as
    ``_select``'s; over the candidate window ``win``) unless the ids
    ``idx`` (B, N, k) are given (graph reuse: x through ``mode``'s grid,
    no selection), then ``conv_block_rows``; (s (B, N, S_out), v (B, N,
    3*V_out) ungated, s_edge_mean (B, 2S), ids (B, N, k) int32)."""
    B, N, _ = x.shape
    if idx is None:
        idx, rows = _select(x, k, T, mode, win, grid, fold)
    else:
        rows = x if mode == "exact" else quant.grid_rows(x, mode)
    s, vm, s_e = conv_block_rows(rows, idx, folded, S=S, V=V, S_out=S_out,
                                 V_out=V_out, binary=binary)
    se_mean = _point_sums(s_e).sum(dim=2) / (N * k)
    return s, vm.reshape(B, N, 3 * V_out), se_mean, idx


def sv_round3_plain(src: torch.Tensor, folded: Folded, *, S: int, V: int,
                    S_out: int, V_out: int, k: int, binary: bool,
                    mode: str = "exact", T: int | None = None,
                    wins_in: torch.Tensor | None = None,
                    gather_window: int = 0, window: int = 0):
    """Plain version of a conv round on channel-major src (B, S+3V, N);
    same outputs as the kernel, with the neighbour ids (B, k, N) last.
    Given ``wins_in`` (B, k, N) (graph reuse) it is the block on those ids
    over ``mode``'s grid rows, no selection, and returns no ids; any
    ``gather_window`` gathers in full, as the kernel does."""
    if wins_in is not None:
        if window:
            raise ValueError("wins_in (graph reuse) excludes the window")
        config.check_mode(mode)
        s, v, se_mean, _ = conv_round_rows(
            src.transpose(1, 2), folded, S=S, V=V, S_out=S_out, V_out=V_out,
            k=k, binary=binary, mode=mode, idx=wins_in.transpose(1, 2))
        return s.transpose(1, 2), v.transpose(1, 2), se_mean
    T = key_tile(mode, src.shape[2], S + 3 * V, T, k, window)
    x = src.transpose(1, 2)
    s, v, se_mean, idx = conv_round_rows(
        x, folded, S=S, V=V, S_out=S_out, V_out=V_out, k=k, binary=binary,
        T=T, mode=mode, win=round_window(x, k, T, window, mode, plain=True))
    return s.transpose(1, 2), v.transpose(1, 2), se_mean, idx.transpose(1, 2)


def _conv_weights(folded: Folded, S: int, V: int, S_out: int, V_out: int,
                  dev) -> list:
    """The conv round's folded weights, checked, as the launchers' pointers."""
    IN1, f = 2 * S + 6 * V, folded
    return [_build.check_arg(f["wz"], "wz", (2 * V, 3), dev),
            _build.check_arg(f["w1"], "w1", (IN1, S_out), dev),
            _build.check_arg(f["beta"], "beta", (1, IN1), dev),
            _build.check_arg(f["a1"], "a1", (1, S_out), dev),
            _build.check_arg(f["b1"], "b1", (1, S_out), dev),
            _build.check_arg(f["w2"], "w2", (2 * V, V_out), dev),
            _build.check_arg(f["scale2"], "scale2", (1, V_out), dev),
            _build.check_arg(f["a2"], "a2", (1, V_out), dev),
            _build.check_arg(f["b2"], "b2", (1, V_out), dev)]


def sv_round3(src: torch.Tensor, folded: Folded, *, S: int, V: int,
              S_out: int, V_out: int, k: int, binary: bool = True,
              mode: str = "exact", T: int | None = None,
              emit_wins: bool = False, wins_in: torch.Tensor | None = None,
              gather_window: int = 0, emitted: bool = False, window: int = 0):
    """src (B, S+3V, N) channel-major [s | v i-major] -> (s (B, S_out, N),
    v (B, 3*V_out, N) ungated, s_edge_mean (B, 2S)[, wins (B, k, N))];
    ``mode`` "exact", "fast" or "approx" (key tiles of ``T``: see the
    module's docstring); ``window``: the candidate window (0 = off; see
    the module's docstring). ``wins_in`` (B, k, N) int32: graph reuse, the
    round runs ``sv_round3_reuse`` on those ids (``emitted``: as it says
    there); it excludes ``emit_wins`` and ``window``, and
    ``gather_window`` (0, or a multiple of 128) needs it."""
    C = S + 3 * V
    if src.dim() != 3 or src.shape[1] != C:
        raise ValueError(f"src: shape {tuple(src.shape)}, expected (B, {C}, N)")
    B, _, N = src.shape
    if not 1 <= k <= N:
        raise ValueError(f"k={k} must lie in [1, N={N}]")
    if gather_window < 0 or gather_window % 128:
        raise ValueError(f"gather_window={gather_window}: 0 or a multiple of 128")
    if wins_in is not None:
        if emit_wins:
            raise ValueError("wins_in (graph reuse) excludes emit_wins")
        if window:
            raise ValueError("wins_in (graph reuse) excludes the window")
        return sv_round3_reuse(src, wins_in, folded, S=S, V=V, S_out=S_out,
                               V_out=V_out, k=k, binary=binary, mode=mode,
                               emitted=emitted)
    if gather_window:
        raise ValueError("gather_window requires wins_in (a graph-reuse round)")
    T = key_tile(mode, N, C, T, k, window)
    if src.device.type == "cpu":
        out = sv_round3_plain(src, folded, S=S, V=V, S_out=S_out,
                              V_out=V_out, k=k, binary=binary, mode=mode, T=T,
                              window=window)
        return out if emit_wins else out[:3]
    dev = require_cuda(src.device)
    _build.check_arg(src, "src", (B, C, N), dev)
    w = _conv_weights(folded, S, V, S_out, V_out, dev)
    lib = _build.lib()
    rows = src.transpose(1, 2).contiguous()  # the kernels read neighbour rows
    win = round_window(rows, k, T, window, mode)
    rows_q, scale, L = fast_args(rows, T, mode, cm=False, win=win)
    keep, ok, W, LW = _window_args(win, mode)
    aa = torch.empty((B, N), device=dev)
    s = torch.empty((B, S_out, N), device=dev)
    v = torch.empty((B, 3 * V_out, N), device=dev)
    ssum = torch.empty((B, 2 * S, N), device=dev)
    wins = torch.empty((B, k, N), device=dev, dtype=torch.int32)
    err = lib.sv_round3_launch(
        rows.data_ptr(), aa.data_ptr(), *w, s.data_ptr(), v.data_ptr(),
        ssum.data_ptr(), wins.data_ptr(), data_ptr(rows_q), data_ptr(scale), data_ptr(keep),
        data_ptr(ok), B, N, S, V, S_out, V_out, k, int(binary), T or 0, L, W, LW,
        _build.stream_ptr(dev))
    _build.check(err, "sv_round3")
    sv_round3.launches += 1
    sv_round3.window_launches += win is not None
    se_mean = ssum.sum(dim=2) / (N * k)
    out = (s, v, se_mean, wins)
    return out if emit_wins else out[:3]


sv_round3.launches = 0
sv_round3.window_launches = 0


def sv_round3_reuse(src: torch.Tensor, wins: torch.Tensor, folded: Folded, *,
                    S: int, V: int, S_out: int, V_out: int, k: int,
                    binary: bool = True, mode: str = "exact",
                    emitted: bool = False):
    """A graph-reuse conv round, what ``sv_round3(wins_in=wins)`` runs: the
    block on the ids ``wins`` (B, k, N) int32, every id in [0, N), over
    src's rows (exact) or their gather grid (fast, approx) -> (s (B, S_out,
    N), v (B, 3*V_out, N) ungated, s_edge_mean (B, 2S)). A rank prefix
    ``w[:, :k]`` of a wider contiguous (B, k', N) tensor is read in place;
    ids in any other layout are copied to a contiguous tensor first.
    ``emitted``: the ids are (a rank prefix of) those a selecting round
    emitted over these N points, as the engines' are, so they lie in
    [0, N) by construction and the range check is skipped: it waits for
    the device, which then idles until the host queues the next work
    (PERF.md §6). Shape, dtype and device are still checked."""
    config.check_mode(mode)
    C = S + 3 * V
    if src.dim() != 3 or src.shape[1] != C:
        raise ValueError(f"src: shape {tuple(src.shape)}, expected (B, {C}, N)")
    B, _, N = src.shape
    if not 1 <= k <= N:
        raise ValueError(f"k={k} must lie in [1, N={N}]")
    check_ids(wins, (B, k, N), N, src.device, in_range=emitted)
    if src.device.type == "cpu":
        return sv_round3_plain(src, folded, S=S, V=V, S_out=S_out,
                               V_out=V_out, k=k, binary=binary, mode=mode,
                               wins_in=wins)
    dev = require_cuda(src.device)
    _build.check_arg(src, "src", (B, C, N), dev)
    if wins.stride(2) != 1 or wins.stride(1) != N or (
            B > 1 and wins.stride(0) < k * N):
        wins = wins.contiguous()  # not a rank prefix of (B, k', N) ids
    bs = wins.stride(0) if B > 1 else k * N
    w = _conv_weights(folded, S, V, S_out, V_out, dev)
    lib = _build.lib()
    rows = src.transpose(1, 2)  # the kernel reads neighbour rows
    rows = (rows if mode == "exact" else quant.grid_rows(rows, mode)).contiguous()
    s = torch.empty((B, S_out, N), device=dev)
    v = torch.empty((B, 3 * V_out, N), device=dev)
    ssum = torch.empty((B, 2 * S, N), device=dev)
    err = lib.sv_round3_reuse_launch(
        rows.data_ptr(), wins.data_ptr(), bs, *w, s.data_ptr(), v.data_ptr(),
        ssum.data_ptr(), B, N, S, V, S_out, V_out, k, int(binary),
        _build.stream_ptr(dev))
    _build.check(err, "sv_round3_reuse")
    sv_round3_reuse.launches += 1
    sv_round3.launches += 1
    return s, v, ssum.sum(dim=2) / (N * k)


sv_round3_reuse.launches = 0
