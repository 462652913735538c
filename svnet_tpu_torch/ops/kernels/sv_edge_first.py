"""The ids-consuming first round, kernel B10d (counterpart of
svnet_tpu/ops/pallas/sv_edge_first.py::sv_edge_first_block): the first
round of the classifier's ``rounds_impl="edge"`` trunk, on the neighbour
ids of a separate kNN over the points.

``sv_edge_first_block(points (B, N, 3), idx (B, N, k) int32)`` returns
``s (B, N, S_out)``, ``v (B, N, 3*V_out)`` UNGATED and ``s_mean (B, 6)``,
the mean of the init-scalar edge features in the reference's c-major
order ``[c*3 + j]`` (sv_edge_first.py:84-88), which the caller's conv1
gate reads. The ids are checked as ``sv_round3.check_ids`` does.

``exact=False`` (sv_edge_first.py:40-57) reads the points, neighbours
and centres alike, through one bf16 cast (``quant.bf16_rows``: rounded
to nearest even, read back in f32; a self-edge is exactly 0); everything
after runs in f32, as on the JAX package's CPU oracle. So the function
is exact mode's on the rounded points, and both the plain version and
the kernel take those.

A CPU tensor goes to the plain version; a CUDA tensor launches
csrc/sv_edge.cu or raises. ``sv_edge_first_block.launches`` counts
launches.
"""

from __future__ import annotations

import torch

from svnet_tpu_torch.config import require_cuda
from svnet_tpu_torch.ops.kernels import _build, quant
from svnet_tpu_torch.ops.kernels.fold import Folded
from svnet_tpu_torch.ops.kernels.sv_round3 import (
    check_ids,
    first_block_rows,
    first_perm,
)


def sv_edge_first_block_plain(points: torch.Tensor, idx: torch.Tensor,
                              folded: Folded, *, S_out: int, V_out: int,
                              k: int, exact: bool = True):
    """Plain version: the first-round plain core on the given ids."""
    if not exact:
        points = quant.bf16_rows(points)
    return first_block_rows(points, idx, folded, S_out=S_out, V_out=V_out)


def sv_edge_first_block(points: torch.Tensor, idx: torch.Tensor,
                        folded: Folded, *, S_out: int, V_out: int, k: int,
                        exact: bool = True):
    """points (B, N, 3), idx (B, N, k) int32 -> (s (B, N, S_out), v
    (B, N, 3*V_out) ungated, s_mean (B, 6) c-major). The kernel takes
    S_out = 32 and V_out = 10 or 16. ``exact=False``: the points through
    bf16 (see the module's docstring)."""
    if points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError(f"points: shape {tuple(points.shape)}, expected (B, N, 3)")
    B, N, _ = points.shape
    if not 1 <= k <= N:
        raise ValueError(f"k={k} must lie in [1, N={N}]")
    check_ids(idx, (B, N, k), N, points.device)
    if points.device.type == "cpu":
        return sv_edge_first_block_plain(points, idx, folded, S_out=S_out,
                                         V_out=V_out, k=k, exact=exact)
    dev = require_cuda(points.device)
    _build.check_arg(points, "points", (B, N, 3), dev)
    if not exact:
        points = quant.bf16_rows(points)
    if not idx.is_contiguous():
        raise ValueError("idx: must be contiguous")
    f = folded
    w = [_build.check_arg(f["wz0"], "wz0", (2, 3), dev),
         _build.check_arg(f["wz1"], "wz1", (2, 3), dev),
         _build.check_arg(f["w1"], "w1", (12, S_out), dev),
         _build.check_arg(f["a1"], "a1", (1, S_out), dev),
         _build.check_arg(f["b1"], "b1", (1, S_out), dev),
         _build.check_arg(f["w2"], "w2", (2, V_out), dev),
         _build.check_arg(f["a2"], "a2", (1, V_out), dev),
         _build.check_arg(f["b2"], "b2", (1, V_out), dev)]
    lib = _build.lib()
    s = torch.empty((B, N, S_out), device=dev)
    v = torch.empty((B, N, 3 * V_out), device=dev)
    ssum = torch.empty((B, 6, N), device=dev)
    err = lib.sv_edge_first_launch(
        points.data_ptr(), idx.data_ptr(), *w, s.data_ptr(), v.data_ptr(),
        ssum.data_ptr(), B, N, k, S_out, V_out, _build.stream_ptr(dev))
    _build.check(err, "sv_edge_first_block")
    sv_edge_first_block.launches += 1
    return s, v, ssum.sum(dim=2)[:, first_perm(2)] / (N * k)


sv_edge_first_block.launches = 0
