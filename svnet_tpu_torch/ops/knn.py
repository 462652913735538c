"""Exact k-nearest-neighbour search (counterpart of svnet_tpu/ops/knn.py).

Ranking is the exact-mode key of the fused round kernels
(svnet_tpu/ops/pallas/sv_round3.py:194-196, :441-451): the sortable-int
bits of the f32 negative squared distance, larger first, ties to the
MINIMUM row id. ``torch.topk``'s order among equal values is unspecified,
so the key and the row are packed into one unique int64 before the topk.
Layout: channels-last ``x (B, N, C)``.
"""

from __future__ import annotations

import torch


def _channel_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_c a[..., c] * b[..., c], one channel at a time in order, each
    product and sum rounded on its own."""
    acc = a[..., 0] * b[..., 0]
    for c in range(1, a.shape[-1]):
        acc += a[..., c] * b[..., c]
    return acc


def pairwise_neg_sqdist(x: torch.Tensor, y: torch.Tensor | None = None) -> torch.Tensor:
    """(B, N, C), (B, M, C) -> (B, N, M) ``2<x, y> - |x|^2 - |y|^2``.

    Evaluated in that order, like svnet_tpu/ops/knn.py:53. The inner
    products and norms are summed channel by channel, as the kernels'
    selection does (csrc/sv_common.cuh), so that the ranking is bitwise the
    kernels' on any device and every self-distance is exactly 0; a matmul
    would sum in a library-chosen order and flip near-tied ranks.
    """
    if y is None:
        y = x
    xx = _channel_sum(x, x)
    yy = _channel_sum(y, y)
    inner = _channel_sum(x[:, :, None, :], y[:, None, :, :])
    return 2.0 * inner - xx[:, :, None] - yy[:, None, :]


def sortable_key(neg: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 whose signed order is the float order (-0.0 < +0.0)."""
    bits = neg.contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def topk_rows(neg: torch.Tensor, k: int) -> torch.Tensor:
    """Row ids of the k largest entries along the last axis of ``neg``,
    by (sortable key desc, row asc). Returns int64 (..., k), rank-major."""
    M = neg.shape[-1]
    rows = torch.arange(M, device=neg.device, dtype=torch.int64)
    packed = sortable_key(neg).to(torch.int64) * (1 << 32) + (M - 1 - rows)
    top = torch.topk(packed, k, dim=-1, sorted=True).values
    return (M - 1) - (top & 0xFFFFFFFF)


def knn_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N, C) -> (B, N, k) int32 neighbour ids, nearest first (self
    included: its distance is ~0, the maximum of the negated distances)."""
    return topk_rows(pairwise_neg_sqdist(x), k).to(torch.int32)


def knn(x: torch.Tensor, k: int) -> torch.Tensor:
    """``knn_plain``'s ids; on a CUDA tensor they come from kernel B4
    (``ops/kernels/knn.py``)."""
    from svnet_tpu_torch.ops.kernels.knn import knn as knn_kernel

    return knn_kernel(x, k)
