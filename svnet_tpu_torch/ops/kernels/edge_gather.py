"""Row gather with a deterministic scatter-add backward, kernel B7
(counterpart of svnet_tpu/ops/pallas/edge_gather.py::edge_gather).

``edge_gather(src, idx)`` maps src (B, n_src, C) float32 and ids
idx (B, M, k) to rows (B, M, k, C): ``out[b, n, j] = src[b, idx[b, n, j]]``,
a bit-exact copy. Its gradient is the scatter-add ``dsrc[b, m]`` = the sum
of ``g[b, n, j]`` over the edges with ``idx[b, n, j] == m``; the ids get
none (``None``, as the JAX VJP returns float0).

Both directions dispatch like ``ops.kernels.knn.knn``: a CPU tensor runs
the plain versions below; a CUDA tensor launches csrc/edge_gather.cu
(``edge_gather_fwd.launches`` and ``edge_gather_bwd.launches`` count the
launches) or raises. ``plain=True`` runs the plain versions on any device:
the on-card reference of the kernels.

The backward sums each target's incoming rows in ascending edge order
``n*k + j``, in f32, from 0, in kernel and plain version alike: they agree
bitwise and every launch gives the same ``dsrc``. The kernel builds each
cloud's inverse adjacency (``adjacency_plan``: blocks a cloud, ids a block
ranks in shared memory at once), then sums. The JAX kernel sums
bf16 hi and lo planes of the cotangent on the MXU instead (about 2^-16
relative; ROADMAP C12).
"""

from __future__ import annotations

import torch

from svnet_tpu_torch.config import require_cuda
from svnet_tpu_torch.ops.kernels import _build


def _check(src: torch.Tensor, idx: torch.Tensor) -> None:
    if src.dim() != 3:
        raise ValueError(f"src: shape {tuple(src.shape)}, expected (B, N, C)")
    if idx.dim() != 3 or idx.shape[0] != src.shape[0]:
        raise ValueError(f"idx: shape {tuple(idx.shape)}, expected "
                         f"({src.shape[0]}, M, k)")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx: dtype {idx.dtype}, expected torch.int32")


def _ids(idx: torch.Tensor, dev) -> torch.Tensor:
    """The kernel's int32 ids on ``dev``, contiguous."""
    if idx.device != dev:
        raise ValueError(f"idx: on {idx.device}, expected {dev}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx: dtype {idx.dtype}, expected torch.int32")
    return idx.contiguous()


ADJ_BLOCKS = 264  # blocks of the adjacency kernel that fill the card: 2 an SM
ADJ_TARGETS = (128, 4096)  # targets a block: at least, at most
ADJ_SMEM_INTS = 12288 - 32  # a block's shared memory in ints: 48 KB less the warp sums


def adjacency_plan(B: int, n_src: int, ek: int) -> tuple[int, int]:
    """(ranges, cap) of the backward's adjacency kernel for B clouds of
    n_src targets and ek = M*k edges: each cloud's targets split into
    ``ranges`` consecutive ranges, a block each, enough for ADJ_BLOCKS
    blocks where every range keeps ADJ_TARGETS[0] targets, and never more
    than ADJ_TARGETS[1] targets a range; a block ranks its range's edges
    in windows of whole segments of at most ``cap`` ids in shared memory
    (what ADJ_SMEM_INTS leaves beside the range's scan and cursors), and a
    single segment above ``cap`` in device memory."""
    lo, hi = ADJ_TARGETS
    ranges = max(-(-n_src // hi), min(-(-ADJ_BLOCKS // B), -(-n_src // lo)))
    ranges = max(1, min(ranges, n_src))
    nt = -(-n_src // ranges)
    return ranges, max(1, min(ek, ADJ_SMEM_INTS - 2 * nt - 1))


def edge_gather_fwd_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, n_src, C), (B, M, k) -> (B, M, k, C) by advanced indexing."""
    bidx = torch.arange(src.shape[0], device=src.device)[:, None, None]
    return src[bidx, idx.long()]


def edge_gather_bwd_plain(g: torch.Tensor, idx: torch.Tensor,
                          n_src: int) -> torch.Tensor:
    """(B, M, k, C) cotangent -> dsrc (B, n_src, C) in the kernel's order.

    A stable sort of the flat target ids lists each target's edges in
    ascending edge order; the loop over in-degree rank r then adds every
    target's r-th row at once, so each sum is the kernel's sequence of
    rounded additions."""
    B, M, k = idx.shape
    C = g.shape[-1]
    flat = (idx.reshape(B, M * k).long()
            + n_src * torch.arange(B, device=idx.device)[:, None]).reshape(-1)
    order = torch.sort(flat, stable=True).indices
    deg = torch.bincount(flat, minlength=B * n_src)
    start = torch.cumsum(deg, 0) - deg
    rows = g.reshape(B * M * k, C)
    acc = torch.zeros(B * n_src, C, device=g.device, dtype=g.dtype)
    for r in range(int(deg.max()) if deg.numel() else 0):
        t = torch.nonzero(deg > r).squeeze(1)
        acc[t] = acc[t] + rows[order[start[t] + r]]
    return acc.reshape(B, n_src, C)


def edge_gather_fwd(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The forward: plain on a CPU tensor, the kernel on a CUDA tensor."""
    _check(src, idx)
    if src.device.type == "cpu":
        return edge_gather_fwd_plain(src, idx)
    dev = require_cuda(src.device)
    B, n_src, C = src.shape
    _, M, k = idx.shape
    src = src.contiguous()
    ids = _ids(idx, dev)
    _build.check_arg(src, "src", (B, n_src, C), dev)
    out = torch.empty((B, M, k, C), device=dev)
    err = _build.lib().sv_edge_gather_fwd_launch(
        src.data_ptr(), ids.data_ptr(), out.data_ptr(), B, n_src, M, k, C,
        _build.stream_ptr(dev))
    _build.check(err, "edge_gather_fwd")
    edge_gather_fwd.launches += 1
    return out


def edge_gather_bwd(g: torch.Tensor, idx: torch.Tensor, n_src: int) -> torch.Tensor:
    """The backward: plain on a CPU tensor, the kernel on a CUDA tensor."""
    if g.device.type == "cpu":
        return edge_gather_bwd_plain(g, idx, n_src)
    dev = require_cuda(g.device)
    B, M, k = idx.shape
    C = g.shape[-1]
    g = g.contiguous()
    ids = _ids(idx, dev)
    _build.check_arg(g, "g", (B, M, k, C), dev)
    dsrc = torch.empty((B, n_src, C), device=dev)
    scratch = torch.empty(2 * B * n_src + 2 * B * M * k, device=dev,
                          dtype=torch.int32)
    err = _build.lib().sv_edge_gather_bwd_launch(
        g.data_ptr(), ids.data_ptr(), dsrc.data_ptr(), scratch.data_ptr(), B,
        n_src, M, k, C, *adjacency_plan(B, n_src, M * k), _build.stream_ptr(dev))
    _build.check(err, "edge_gather_bwd")
    edge_gather_bwd.launches += 1
    return dsrc


edge_gather_fwd.launches = 0
edge_gather_bwd.launches = 0


class EdgeGather(torch.autograd.Function):
    """``edge_gather`` with the scatter-add backward; ``plain`` picks the
    plain versions on any device."""

    @staticmethod
    def forward(ctx, src, idx, plain):
        ctx.save_for_backward(idx)
        ctx.n_src, ctx.plain = src.shape[1], plain
        return (edge_gather_fwd_plain if plain else edge_gather_fwd)(src, idx)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        (idx,) = ctx.saved_tensors
        bwd = edge_gather_bwd_plain if ctx.plain else edge_gather_bwd
        return bwd(g.contiguous(), idx, ctx.n_src), None, None


def edge_gather(src: torch.Tensor, idx: torch.Tensor,
                plain: bool = False) -> torch.Tensor:
    """(B, n_src, C) float32, (B, M, k) int32 -> (B, M, k, C), differentiable
    in ``src``."""
    return EdgeGather.apply(src, idx, plain)
