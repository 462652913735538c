"""The certified Morton candidate window (``window=``; counterpart of
svnet_tpu/ops/pallas/sv_round3.py::_prune_prepass and the W < N branch of
_round3_kernel and _round3_first_kernel).

On a Morton-sorted cloud a round may restrict each key tile's candidate
scan to at most W rows: the 128-row blocks that a cheap pre-pass cannot
rule out for any of the tile's T centres. ``prune_prepass`` certifies the
blocks (``keep``) and says whether every tile's kept blocks fit in W rows
over the whole batch (``ok``); where they do not, the round scans all N
rows, as it does without a window. Both come back as device tensors: the
kernels read ``ok`` on the card, so no round waits for the host.

The windowed round ranks a tile's kept blocks compacted in ascending block
order (``window_rows``), W positions of which those past the kept rows are
padding. Exact mode's result is bitwise the full scan's (the certificate
keeps every row the full scan would select). Fast and approx mode are
another function: a key tile's quantization scale is taken over the kept
rows only (and 0.0 where the tile has padding), and approx mode folds the
W compacted positions, not the N rows, to ``quant.fold_width(W)`` lanes.

The pre-pass is XLA outside any kernel in the JAX package. Here its two
scans of the cloud are kernels on the card (csrc/window.cu): tau, each
centre's k-th distance to its band of 384 rows (``window_tau``), and the
block test, bounding-box lower bounds of every centre to every block
(``window_keep``), which PyTorch runs as a (B, N, 384) slab and a
kthvalue, and as tens of GB of temporaries, at the long clouds the window
is for. The rest is plain tensor code on every device.
"""

from __future__ import annotations

import torch

from svnet_tpu_torch.config import require_cuda
from svnet_tpu_torch.ops.kernels import _build, quant
from svnet_tpu_torch.ops.knn import channel_sum

BS = 128  # rows of a Morton block (sv_round3.py:894)


def check_window(window: int, N: int, T: int, k: int, mode: str) -> int:
    """The width W of a round's window, 0 (off) unless 0 < window < N, as
    the JAX wrappers take it (sv_round3.py:1196-1200, :1574-1578); ``T``
    is the round's key tile, which ``key_tile`` resolves whenever a window
    is active, exact mode included (the certificate tiles the centres).
    Raises ``ValueError`` where JAX asserts or fails: N or W not a
    multiple of 128, W below T, k above the pre-pass's 384 band rows,
    approx mode's W not halving evenly or folding below k (C20 applied to
    W); and for T not a multiple of 128 (C22: the TPU's lane
    tile, and the card's selection keeps a block of centres inside one key
    tile)."""
    if window < 0:
        raise ValueError(f"window={window} must be >= 0")
    if not 0 < window < N:
        return 0
    if N % BS:
        raise ValueError(f"window={window}: N={N} must be a multiple of {BS}")
    if window % BS:
        raise ValueError(f"window={window} must be a multiple of {BS}")
    if T % BS:
        raise ValueError(f"window={window}: the key tile T={T} must be a "
                         f"multiple of {BS}")
    if window < T:
        raise ValueError(f"window={window} must be >= the key tile T={T}")
    if k > 3 * BS:  # tau is the k-th of a centre's 384 band rows
        raise ValueError(f"window={window}: k={k} above the pre-pass's "
                         f"{3 * BS} band rows")
    if mode == "approx":
        quant.fold_width(window, k)
    return window


def prune_prepass(src: torch.Tensor, k: int, T: int, W: int,
                  plain: bool = False):
    """(B, N, C) row-major features -> (keep (B, N/T, N/128) int32, ok
    0-dim bool), both on src's device.

    tau[b, n]: the k-th smallest squared distance from n to the 384 rows of
    its own 128-row block and the two beside it (the ends wrap), in the
    matmul form |x|^2 + |y|^2 - 2<x, y>, raised by 2e-5 * max_n |x_n|^2 +
    1e-30 against both distance forms' rounding (``window_tau``). A block
    is kept for a tile of T centres unless every centre's bounding-box
    lower bound to it (direct form) is strictly above its tau
    (``window_keep``). Both are kernels on the card, their plain versions
    where ``plain``. ``ok``: every tile of every cloud keeps at most W
    rows."""
    B, N, C = src.shape
    x = src.float().contiguous()
    tau = raise_tau(x, (window_tau_plain if plain else window_tau)(x, k))
    xb = x.reshape(B, N // BS, BS, C)
    lo, hi = xb.amin(dim=2).contiguous(), xb.amax(dim=2).contiguous()
    keep = (window_keep_plain if plain else window_keep)(x, lo, hi, tau, T)
    ok = (keep.sum(dim=-1) * BS <= W).all()
    return keep, ok


def raise_tau(x: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """tau (B, N) raised by the pre-pass's margin against both distance
    forms' rounding, 2e-5 * max_n |x_n|^2 + 1e-30 for each cloud of x
    (B, N, C); contiguous."""
    mx = (x * x).sum(-1).amax(dim=1)  # (B,)
    return (tau + (2e-5 * mx + 1e-30)[:, None]).contiguous()


def window_tau_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """x (B, N, C) -> (B, N): each centre's k-th smallest squared distance
    (|x_n|^2 + |x_m|^2) - 2<x_n, x_m> to the 384 rows of its block and the
    two beside it (the ends wrap, rows counted as often as they appear),
    the norms and inner products summed channel by channel, as the kernel
    sums."""
    B, N, C = x.shape
    nb = N // BS
    xb = x.reshape(B, nb, BS, C)
    nbhd = torch.cat([xb.roll(1, dims=1), xb, xb.roll(-1, dims=1)], dim=2)
    sq = channel_sum(xb, xb)  # (B, nb, BS)
    sqn = torch.cat([sq.roll(1, dims=1), sq, sq.roll(-1, dims=1)], dim=2)
    inner = channel_sum(xb[:, :, :, None], nbhd[:, :, None])  # (B, nb, BS, 3BS)
    d2 = (sq[..., None] + sqn[:, :, None, :]) - 2.0 * inner
    return torch.kthvalue(d2.reshape(B, N, 3 * BS), k, dim=-1).values


def window_tau(x: torch.Tensor, k: int) -> torch.Tensor:
    """``window_tau_plain``'s values; on a CUDA tensor from the kernel
    (csrc/window.cu), counted on ``window_tau.launches``."""
    if x.device.type == "cpu":
        return window_tau_plain(x, k)
    dev = require_cuda(x.device)
    B, N, C = x.shape
    aa = torch.empty((B, N), device=dev)
    tau = torch.empty((B, N), device=dev)
    err = _build.lib().sv_window_tau_launch(
        _build.check_arg(x, "x", (B, N, C), dev), aa.data_ptr(), tau.data_ptr(),
        B, N, C, k, _build.stream_ptr(dev))
    _build.check(err, "window_tau")
    window_tau.launches += 1
    return tau


window_tau.launches = 0


def window_keep_plain(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                      tau: torch.Tensor, T: int) -> torch.Tensor:
    """x (B, N, C), the blocks' boxes lo, hi (B, N/128, C), tau (B, N) ->
    keep (B, N/T, N/128) int32: 1 unless every centre of the tile has
    lb2 > tau, lb2 = sum_c max(lo_c - x_c, x_c - hi_c, 0)^2 summed channel
    by channel, each product and sum rounded on its own, as the kernel
    sums. A few blocks at a time: (B, N, blocks) stays within 2^24 floats."""
    B, N, C = x.shape
    nb = lo.shape[1]
    step = max(1, (1 << 24) // (B * N))
    keep = []
    for i in range(0, nb, step):
        lb2 = None
        for c in range(C):
            xc = x[:, :, None, c]
            d = torch.clamp(torch.maximum(lo[:, None, i:i + step, c] - xc,
                                          xc - hi[:, None, i:i + step, c]), min=0.0)
            lb2 = d * d if lb2 is None else lb2 + d * d
        prune = (lb2 > tau[..., None]).reshape(B, N // T, T, -1).all(dim=2)
        keep.append((~prune).to(torch.int32))
    return torch.cat(keep, dim=-1)


def window_keep(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                tau: torch.Tensor, T: int) -> torch.Tensor:
    """``window_keep_plain``'s flags; on a CUDA tensor from the kernel
    (csrc/window.cu), counted on ``window_keep.launches``."""
    if x.device.type == "cpu":
        return window_keep_plain(x, lo, hi, tau, T)
    dev = require_cuda(x.device)
    B, N, C = x.shape
    nb = N // BS
    keep = torch.empty((B, N // T, nb), device=dev, dtype=torch.int32)
    err = _build.lib().sv_window_keep_launch(
        _build.check_arg(x, "x", (B, N, C), dev),
        _build.check_arg(lo, "lo", (B, nb, C), dev),
        _build.check_arg(hi, "hi", (B, nb, C), dev),
        _build.check_arg(tau, "tau", (B, N), dev), keep.data_ptr(), B, N, C,
        T, _build.stream_ptr(dev))
    _build.check(err, "window_keep")
    window_keep.launches += 1
    return keep


window_keep.launches = 0


def window_rows(keep: torch.Tensor, W: int):
    """keep (B, nt, nb) of a certified batch -> (rows (B, nt, W) int64,
    valid (B, nt, W) bool): the absolute row at each compacted position of
    each tile, kept blocks in ascending order, positions past them padding
    (row 0, not valid)."""
    B, nt, nb = keep.shape
    slots = W // BS
    kept = keep > 0
    pos = torch.cumsum(kept.long(), dim=-1) - 1  # the slot of a kept block
    pos = torch.where(kept, pos, torch.full_like(pos, slots))  # the rest: a spare slot
    blk = torch.full((B, nt, slots + 1), -1, dtype=torch.long, device=keep.device)
    blk.scatter_(-1, pos, torch.arange(nb, device=keep.device).expand(B, nt, nb))
    blk = blk[..., :slots, None]  # (B, nt, slots, 1)
    rows = blk * BS + torch.arange(BS, device=keep.device)
    valid = (blk >= 0).expand(-1, -1, -1, BS)
    return (torch.where(valid, rows, torch.zeros_like(rows)).reshape(B, nt, W),
            valid.reshape(B, nt, W))
