"""Exact k-nearest-neighbour search (counterpart of svnet_tpu/ops/knn.py),
and the fast- and approx-mode selections of the fused rounds
(``knn_fast_plain``, ``knn_approx_plain``).

Ranking is the exact-mode key of the fused round kernels
(svnet_tpu/ops/pallas/sv_round3.py:194-196, :441-451): the sortable-int
bits of the f32 negative squared distance, larger first, ties to the
MINIMUM row id. ``torch.topk``'s order among equal values is unspecified,
so the key and the row are packed into one unique int64 before the topk.
Layout: channels-last ``x (B, N, C)``.
"""

from __future__ import annotations

import torch

from svnet_tpu_torch.ops.kernels import quant


def channel_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_c a[..., c] * b[..., c], one channel at a time in order, each
    product and sum rounded on its own."""
    acc = a[..., 0] * b[..., 0]
    for c in range(1, a.shape[-1]):
        acc += a[..., c] * b[..., c]
    return acc


@torch.library.custom_op("svnet::pair_inner", mutates_args=())
def pair_inner(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``channel_sum`` of a and b broadcast against each other, as one op
    (``svnet::pair_inner``): a traced graph then holds the kNN's inner
    products as one node, which the complexity analyzer
    (utils/analysis.py) counts as the product it is."""
    a, b = torch.broadcast_tensors(a, b)
    return channel_sum(a, b)


@pair_inner.register_fake
def _(a, b):
    return a.new_empty(torch.broadcast_shapes(a.shape, b.shape)[:-1])


def _pair_inner_bwd(ctx, g):
    a, b = ctx.saved_tensors
    g = g[..., None]
    return (g * b).sum_to_size(a.shape), (g * a).sum_to_size(b.shape)


pair_inner.register_autograd(
    _pair_inner_bwd,
    setup_context=lambda ctx, inputs, output: ctx.save_for_backward(*inputs))


def pairwise_neg_sqdist(x: torch.Tensor, y: torch.Tensor | None = None) -> torch.Tensor:
    """(B, N, C), (B, M, C) -> (B, N, M) ``2<x, y> - |x|^2 - |y|^2``.

    Evaluated in that order, like svnet_tpu/ops/knn.py:53. The inner
    products and norms are summed channel by channel, as the kernels'
    selection does (csrc/sv_common.cuh), so that the ranking is bitwise the
    kernels' on any device and every self-distance is exactly 0; a matmul
    would sum in a library-chosen order and flip near-tied ranks.
    """
    xx = channel_sum(x, x)
    if y is None:
        y, yy = x, xx
    else:
        yy = channel_sum(y, y)
    inner = pair_inner(x[:, :, None, :], y[:, None, :, :])
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
    included: its distance is ~0, the maximum of the negated distances).
    The ranking key is that of the f32 distances whatever the dtype of x."""
    return topk_rows(pairwise_neg_sqdist(x.float()), k).to(torch.int32)


def _fast_keys(x: torch.Tensor, T: int) -> torch.Tensor:
    """(B, N, C) -> (B, N centres, N candidates) fast mode's packed keys."""
    neg = pairwise_neg_sqdist(x.float())
    scale = quant.tile_scales(neg.amin(dim=-1), T, x.shape[1])
    return quant.packed_keys(neg, scale, T)


def _top_rows(keys: torch.Tensor, k: int, N: int) -> torch.Tensor:
    top = torch.topk(keys, k, dim=-1, sorted=True).values
    return quant.key_rows(top, N)


def knn_fast_plain(x: torch.Tensor, k: int, T: int) -> torch.Tensor:
    """Fast mode's selection (sv_round3.py:199-235, :453-459): (B, N, C)
    -> (B, N, k) int32 ids by the packed keys of ``pairwise_neg_sqdist``'s
    distances, each quantized on the scale of the worst distance of its
    tile of T centres (ops/kernels/quant.py); the keys are unique, so
    ``topk`` orders them fully."""
    return _top_rows(_fast_keys(x, T), k, x.shape[1])


def knn_approx_plain(x: torch.Tensor, k: int, T: int,
                     fold: int | None = None) -> torch.Tensor:
    """Approx mode's selection (sv_round3.py:209-234, :449-458): fast
    mode's keys folded to L = ``quant.fold_width(N, k, fold)`` lanes by
    key max, then the top k of the L; the winners are distinct rows, one
    a residue class mod L. Raises for k > L (the JAX kernel would decode
    its empty lanes into rows that are not neighbours)."""
    N = x.shape[1]
    L = quant.fold_width(N, k, fold)
    return _top_rows(quant.fold_keys(_fast_keys(x, T), L), k, N)


def window_neg(x: torch.Tensor, T: int, keep: torch.Tensor, W: int):
    """The distances of a certified candidate window: (neg (B*nt, T, W)
    over each tile's compacted kept rows, +inf on padding; rows (B*nt, W)
    absolute; valid (B*nt, W)). The same values as the full scan's
    (``pairwise_neg_sqdist`` sums channel by channel)."""
    from svnet_tpu_torch.ops.window import window_rows

    B, N, C = x.shape
    nt = N // T
    rows, valid = window_rows(keep, W)  # (B, nt, W)
    xf = x.float()
    cand = torch.take_along_dim(xf, rows.reshape(B, nt * W, 1), dim=1)
    neg = pairwise_neg_sqdist(xf.reshape(B * nt, T, C), cand.reshape(B * nt, W, C))
    valid = valid.reshape(B * nt, W)
    return neg.masked_fill(~valid[:, None, :], float("inf")), rows.reshape(B * nt, W), valid


def window_neg_min(neg: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(B*nt, T, W) window distances -> (B*nt, T): each centre's least
    over the kept rows, and 0.0 where its tile's window has padding (the
    JAX kernel zeroes neg there before the tile's min, sv_round3.py:586-591)."""
    mn = neg.amin(dim=-1)
    pad = ~valid.all(dim=-1)
    return torch.where(pad[:, None], torch.clamp(mn, max=0.0), mn)


def knn_window_plain(x: torch.Tensor, k: int, T: int, W: int,
                     keep: torch.Tensor, ok: torch.Tensor,
                     mode: str = "exact") -> torch.Tensor:
    """The windowed selection of ``mode`` (sv_round3.py:548-591, the W < N
    branch): (B, N, C) -> (B, N, k) int32 absolute ids, each tile of T
    centres ranking the compacted rows of its kept blocks (ops/window.py:
    ``keep``, ``ok`` from ``prune_prepass``). Exact mode: the sortable key,
    ties to the lower row (bitwise the full scan where certified). Fast
    mode: the packed key on the tile's scale over the kept rows (with 0.0
    where the window has padding), the idx bits of N. Approx mode: those
    keys with padding lowest, the W positions folded to
    ``quant.fold_width(W)`` lanes. Where ``ok`` is False, the full scan of
    ``mode`` on key tiles of T."""
    B, N, _ = x.shape
    if not bool(ok):
        if mode == "exact":
            return knn_plain(x, k)
        return (knn_approx_plain if mode == "approx" else knn_fast_plain)(x, k, T)
    neg, rows, valid = window_neg(x, T, keep, W)
    if mode == "exact":
        pos = topk_rows(neg.masked_fill(~valid[:, None, :], float("-inf")), k)
        ids = torch.gather(rows[:, None, :].expand(-1, T, -1), 2, pos)
    else:
        scale = quant.tile_scales(window_neg_min(neg, valid).reshape(B, N), T, N)
        keys = quant.packed_keys(neg, scale.reshape(-1, 1), T,
                                 rows=rows[:, None, :], M=N)
        keys = keys.masked_fill(~valid[:, None, :], torch.iinfo(torch.int32).min)
        if mode == "approx":
            keys = quant.fold_keys(keys, quant.fold_width(W, k))
        ids = _top_rows(keys, k, N)
    return ids.reshape(B, N, k).to(torch.int32)


def knn(x: torch.Tensor, k: int) -> torch.Tensor:
    """``knn_plain``'s ids; on a CUDA tensor they come from kernel B4
    (``ops/kernels/knn.py``)."""
    from svnet_tpu_torch.ops.kernels.knn import knn as knn_kernel

    return knn_kernel(x, k)
