"""The ids-consuming conv round, kernel B10c (counterpart of
svnet_tpu/ops/pallas/sv_edge.py::sv_edge_block), and its host gate
``svblock_gate`` (sv_edge.py:286-306): the classifier's
``rounds_impl="edge"`` trunk, whose neighbour ids come from a separate kNN.

``sv_edge_block(src (B, N, S + 3V), idx (B, N, k) int32, gate (B, V_out))``
returns ``s (B, N, S_out)`` and ``v (B, N, 3*V_out)`` GATED: the mean over
k times the gate, as the JAX kernel applies it. There are no gate
statistics: the gate comes in. The ids are checked (shape, int32, device)
and an id outside [0, N) raises, on any device: JAX's one-hot gather
would read a zero row there; the port refuses.

``exact=False`` (sv_edge.py:57-159) changes two things. The gathered rows
and the centres are read through one bf16 cast of ``src``
(``quant.bf16_rows``; a self-edge is exactly 0). And linear2 takes its
operands through bf16: each edge vector ``[nbr - ctr | ctr]``, whose
difference half is an f32 difference of bf16 values and in general not
a bf16 value itself, and ``w2`` (a no-op for binary's +-1). The products
of two bf16 values are exact in f32 and are summed in f32. The frames,
the invariants and linear1 read the unrounded differences, in f32 as on
the JAX package's CPU oracle. The wrapper rounds ``w2`` on the host; the
kernel rounds the vectors (csrc/sv_rounds.cuh, ``V2BF16``).

A CPU tensor goes to the plain version; a CUDA tensor launches
csrc/sv_edge.cu or raises. ``sv_edge_block.launches`` counts launches.
"""

from __future__ import annotations

import torch

from svnet_tpu_torch.config import require_cuda
from svnet_tpu_torch.ops.kernels import _build, quant
from svnet_tpu_torch.ops.kernels.fold import Folded
from svnet_tpu_torch.ops.kernels.sv_round3 import check_ids, conv_block_rows


def svblock_gate(p: dict, s: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """An SVBlock's SE gate from the mean of its edge scalars over (N, k),
    without the edges: the centre half is the mean of s, the neighbour
    half the in-degree-weighted mean; s (B, N, S), idx (B, N, k) ->
    (B, V_out). The degrees are counted as integers (exact whatever the
    order of the scatter), then made float."""
    B, N, _ = s.shape
    k = idx.shape[-1]
    flat = idx.reshape(B, -1).long()
    counts = torch.zeros((B, N), dtype=torch.int64, device=s.device)
    counts.scatter_add_(1, flat, torch.ones_like(flat))
    mean_nbr = torch.einsum("bn,bns->bs", counts.to(s.dtype), s) / (N * k)
    mean_ctr = torch.mean(s, dim=1)
    g = torch.cat([mean_nbr - mean_ctr, mean_ctr], dim=-1)  # (B, 2S)
    g = torch.relu(g @ p["gate_fc1"]["kernel"])
    return torch.sigmoid(g @ p["gate_fc2"]["kernel"])


def sv_edge_block_plain(src: torch.Tensor, idx: torch.Tensor,
                        gate: torch.Tensor, folded: Folded, *, S: int, V: int,
                        S_out: int, V_out: int, k: int, binary: bool,
                        exact: bool = True):
    """Plain version: the round3 plain core on the given ids, v pooled
    then gated; ``exact=False`` on the bf16 rows, linear2 through bf16."""
    B, N, _ = src.shape
    if not exact:
        src = quant.bf16_rows(src)
    s, vm, _ = conv_block_rows(src, idx, folded, S=S, V=V, S_out=S_out,
                               V_out=V_out, binary=binary, v2_bf16=not exact)
    return s, (vm * gate[:, None, None, :]).reshape(B, N, 3 * V_out)


def sv_edge_block(src: torch.Tensor, idx: torch.Tensor, gate: torch.Tensor,
                  folded: Folded, *, S: int, V: int, S_out: int, V_out: int,
                  k: int, binary: bool = True, exact: bool = True):
    """src (B, N, S+3V) row-major [s | v i-major], idx (B, N, k) int32,
    gate (B, V_out) -> (s (B, N, S_out), v (B, N, 3*V_out) gated);
    ``exact=False`` as the module's docstring says."""
    C = S + 3 * V
    if src.dim() != 3 or src.shape[-1] != C:
        raise ValueError(f"src: shape {tuple(src.shape)}, expected (B, N, {C})")
    B, N, _ = src.shape
    if not 1 <= k <= N:
        raise ValueError(f"k={k} must lie in [1, N={N}]")
    check_ids(idx, (B, N, k), N, src.device)
    kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=k, binary=binary,
              exact=exact)
    if src.device.type == "cpu":
        return sv_edge_block_plain(src, idx, gate, folded, **kw)
    dev = require_cuda(src.device)
    _build.check_arg(src, "src", (B, N, C), dev)
    _build.check_arg(gate, "gate", (B, V_out), dev)
    if not idx.is_contiguous():
        raise ValueError("idx: must be contiguous")
    IN1, f = 2 * S + 6 * V, folded
    w2 = f["w2"] if exact else quant.bf16_rows(f["w2"])
    if not exact:
        src = quant.bf16_rows(src)
    w = [_build.check_arg(f["wz"], "wz", (2 * V, 3), dev),
         _build.check_arg(f["w1"], "w1", (IN1, S_out), dev),
         _build.check_arg(f["beta"], "beta", (1, IN1), dev),
         _build.check_arg(f["a1"], "a1", (1, S_out), dev),
         _build.check_arg(f["b1"], "b1", (1, S_out), dev),
         _build.check_arg(w2, "w2", (2 * V, V_out), dev),
         _build.check_arg(f["scale2"], "scale2", (1, V_out), dev),
         _build.check_arg(f["a2"], "a2", (1, V_out), dev),
         _build.check_arg(f["b2"], "b2", (1, V_out), dev)]
    lib = _build.lib()
    s = torch.empty((B, N, S_out), device=dev)
    v = torch.empty((B, N, 3 * V_out), device=dev)
    err = lib.sv_edge_launch(
        src.data_ptr(), idx.data_ptr(), gate.data_ptr(), *w, s.data_ptr(),
        v.data_ptr(), B, N, S, V, S_out, V_out, k, int(binary), int(exact),
        _build.stream_ptr(dev))
    _build.check(err, "sv_edge_block")
    sv_edge_block.launches += 1
    return s, v


sv_edge_block.launches = 0
