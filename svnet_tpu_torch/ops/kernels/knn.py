"""kNN, kernel B4 (counterpart of svnet_tpu/ops/pallas/knn.py::knn_pallas).

``knn(x, k, mode="exact", tile=128)`` maps channels-last features
(B, N, C) to (B, N, k) int32 neighbour ids, nearest first. A CPU tensor
goes to the plain version; a CUDA tensor launches csrc/knn.cu (the
serving rounds' selection, sv_common.cuh, writing the ids point-major)
or raises. ``knn.launches`` counts kernel launches.

Exact mode ranks by the sortable-int key of the f32 distance, ties to
the minimum row (plain version ``ops.knn.knn_plain``); the distances are
summed channel by channel with every product and sum rounded on its own,
so the ids are identical on any device. Fast mode (knn.py:38-96) ranks by
the packed key of the distance quantized on the scale of each key tile
of ``tile`` centres (``ops.knn.knn_fast_plain``, ``quant.packed_keys``);
approx mode folds those keys to ``quant.fold_width(N, k, 256)`` lanes
first (``knn_approx_plain``): B4's fold is the fixed 256 of
sv_round2.py:58, not ``config.approx_fold``. In both, ``tile`` must
divide N (the JAX kernel asserts it), and approx mode raises for k above
the folded width. On the card a fast or approx call first launches the
pre-pass ``neg_min`` for the key tiles' scales (``knn.neg_min_launches``
counts those, beside ``neg_min.launches``). No JAX engine passes a mode
to B4; the wrapper takes one, as ``knn_pallas`` does.

``neg_min(x)`` is fast mode's pre-pass (csrc/knn.cu, sv_neg_min_launch):
each centre's least negative squared distance, whence the key tiles'
scales (quant.tile_scales). The kernel sums each pair's inner product
once, as the selection sums it, and takes both centres' distances from
it (the product is bitwise symmetric). Its plain version takes the min of
``pairwise_neg_sqdist``; a min has no order, so the two are equal. ``neg_min.launches`` counts its launches. Over a
candidate window (ops/window.py) it takes the key tile's kept rows only
(csrc/knn.cu, sv_neg_min_window_launch).
"""

from __future__ import annotations

import torch

from svnet_tpu_torch.config import MODES, require_cuda
from svnet_tpu_torch.ops.kernels import _build, quant
from svnet_tpu_torch.ops.knn import (
    knn_approx_plain,
    knn_fast_plain,
    window_neg,
    knn_plain,
    pairwise_neg_sqdist,
    window_neg_min,
)

KNN_FOLD = 256  # B4's approx fold width (sv_round2.py:58, _APPROX_L)


def _fold(mode: str, N: int, k: int, tile: int) -> int:
    """A mode's fold width L (0: none), its arguments checked: ``tile``
    divides N in fast and approx mode; approx mode halves N to at most
    256 lanes, and k must not exceed them."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}; expected one of {MODES}")
    if mode == "exact":
        return 0
    if tile < 1 or N % tile:
        raise ValueError(f"{mode} mode: the key tile {tile} must divide N={N}")
    if mode == "fast":
        return 0
    L = quant.fold_width(N, k, KNN_FOLD)
    return L if L < N else 0


def knn_mode_plain(x: torch.Tensor, k: int, mode: str = "exact",
                   tile: int = 128) -> torch.Tensor:
    """Plain version of every mode: ``knn_plain``, ``knn_fast_plain`` on
    key tiles of ``tile``, or ``knn_approx_plain`` at the 256-lane fold."""
    _fold(mode, x.shape[1], k, tile)
    if mode == "exact":
        return knn_plain(x, k)
    if mode == "fast":
        return knn_fast_plain(x, k, tile)
    return knn_approx_plain(x, k, tile, KNN_FOLD)


def knn(x: torch.Tensor, k: int, mode: str = "exact",
        tile: int = 128) -> torch.Tensor:
    """(B, N, C) float32 -> (B, N, k) int32 neighbour ids (self included);
    ``mode`` and ``tile`` as the module's docstring says."""
    if x.dim() != 3:
        raise ValueError(f"x: shape {tuple(x.shape)}, expected (B, N, C)")
    B, N, C = x.shape
    if not 1 <= k <= N:
        raise ValueError(f"k={k} must lie in [1, N={N}]")
    L = _fold(mode, N, k, tile)
    if x.device.type == "cpu":
        return knn_mode_plain(x, k, mode, tile)
    dev = require_cuda(x.device)
    if x.dtype != torch.float32:
        raise TypeError(f"x: dtype {x.dtype}, expected torch.float32")
    x = x.detach()
    scale, T = None, 0
    if mode != "exact":
        scale, T = quant.tile_scales(neg_min(x), tile, N).contiguous(), tile
        knn.neg_min_launches += 1
    xt = x.transpose(1, 2).contiguous()  # (B, C, N)
    aa = torch.empty((B, N), device=dev)
    ids = torch.empty((B, N, k), device=dev, dtype=torch.int32)
    err = _build.lib().sv_knn_launch(
        xt.data_ptr(), aa.data_ptr(), ids.data_ptr(),
        None if scale is None else scale.data_ptr(), B, N, C, k, T, L,
        _build.stream_ptr(dev))
    _build.check(err, "knn")
    knn.launches += 1
    return ids


knn.launches = 0
knn.neg_min_launches = 0  # the pre-pass launches of fast and approx calls


def neg_min_plain(x: torch.Tensor) -> torch.Tensor:
    """(B, N, C) -> (B, N): min over the candidates of the negative squared
    distances, as the selection ranks them."""
    return pairwise_neg_sqdist(x.float()).amin(dim=-1)


def neg_min_window_plain(x: torch.Tensor, window) -> torch.Tensor:
    """``neg_min_plain`` over a candidate window ``(T, W, keep, ok)``
    (ops/window.py): each centre's least over its key tile's kept rows,
    0.0 where the tile's window has padding; all N rows where ``ok`` is
    False."""
    T, W, keep, ok = window
    if not bool(ok):
        return neg_min_plain(x)
    neg, _, valid = window_neg(x, T, keep, W)
    return window_neg_min(neg, valid).reshape(x.shape[:2])


def neg_min(x: torch.Tensor, window=None) -> torch.Tensor:
    """(B, N, C) float32 -> (B, N) each centre's least negative squared
    distance (its farthest candidate); over a candidate window
    ``(T, W, keep, ok)`` as ``neg_min_window_plain`` says, with ``ok``
    read on the device (``neg_min.window_launches`` counts those
    launches)."""
    if x.dim() != 3:
        raise ValueError(f"x: shape {tuple(x.shape)}, expected (B, N, C)")
    if x.device.type == "cpu":
        return neg_min_plain(x) if window is None else neg_min_window_plain(x, window)
    dev = require_cuda(x.device)
    if x.dtype != torch.float32:
        raise TypeError(f"x: dtype {x.dtype}, expected torch.float32")
    B, N, C = x.shape
    x = x.detach().contiguous()
    aa = torch.empty((B, N), device=dev)
    out = torch.empty((B, N), device=dev)
    lib, stream = _build.lib(), _build.stream_ptr(dev)
    if window is None:
        err = lib.sv_neg_min_launch(x.data_ptr(), aa.data_ptr(),
                                    out.data_ptr(), B, N, C, stream)
    else:
        T, W, keep, ok = window
        err = lib.sv_neg_min_window_launch(
            x.data_ptr(), aa.data_ptr(), out.data_ptr(), keep.data_ptr(),
            ok.data_ptr(), B, N, C, T, W, stream)
    _build.check(err, "neg_min")
    neg_min.launches += 1
    if window is not None:
        neg_min.window_launches += 1
    return out


neg_min.launches = 0
neg_min.window_launches = 0
