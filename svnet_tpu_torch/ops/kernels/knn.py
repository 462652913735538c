"""Exact kNN, kernel B4 (counterpart of svnet_tpu/ops/pallas/knn.py::knn_pallas).

``knn(x, k)`` maps channels-last features (B, N, C) to (B, N, k) int32
neighbour ids, nearest first, ties to the minimum row. A CPU tensor goes
to the plain version ``ops.knn.knn_plain``; a CUDA tensor launches
csrc/knn.cu (the serving rounds' selection, sv_common.cuh, writing the
ids point-major) or raises. ``knn.launches`` counts kernel launches.

Both rank by the sortable-int key of the f32 distance, summed channel by
channel with every product and sum rounded on its own, so their ids are
identical on any device.

``neg_min(x)`` is fast mode's pre-pass (csrc/knn.cu, sv_neg_min_launch):
each centre's least negative squared distance, by the same distance
stage, whence the key tiles' scales (quant.tile_scales). Its plain
version takes the min of ``pairwise_neg_sqdist``; a min has no order, so
the two are equal. ``neg_min.launches`` counts its launches. Over a
candidate window (ops/window.py) it takes the key tile's kept rows only
(csrc/knn.cu, sv_neg_min_window_launch).
"""

from __future__ import annotations

import torch

from svnet_tpu_torch.config import require_cuda
from svnet_tpu_torch.ops.kernels import _build
from svnet_tpu_torch.ops.knn import (
    window_neg,
    knn_plain,
    pairwise_neg_sqdist,
    window_neg_min,
)


def knn(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N, C) float32 -> (B, N, k) int32 neighbour ids (self included)."""
    if x.dim() != 3:
        raise ValueError(f"x: shape {tuple(x.shape)}, expected (B, N, C)")
    B, N, C = x.shape
    if not 1 <= k <= N:
        raise ValueError(f"k={k} must lie in [1, N={N}]")
    if x.device.type == "cpu":
        return knn_plain(x, k)
    dev = require_cuda(x.device)
    if x.dtype != torch.float32:
        raise TypeError(f"x: dtype {x.dtype}, expected torch.float32")
    xt = x.detach().transpose(1, 2).contiguous()  # (B, C, N)
    aa = torch.empty((B, N), device=dev)
    ids = torch.empty((B, N, k), device=dev, dtype=torch.int32)
    err = _build.lib().sv_knn_launch(xt.data_ptr(), aa.data_ptr(),
                                     ids.data_ptr(), B, N, C, k,
                                     _build.stream_ptr(dev))
    _build.check(err, "knn")
    knn.launches += 1
    return ids


knn.launches = 0


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
