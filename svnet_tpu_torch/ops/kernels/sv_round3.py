"""Fused SV-DGCNN rounds, exact mode (counterparts of
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
"""

from __future__ import annotations

import torch

from svnet_tpu_torch import ops
from svnet_tpu_torch.config import EPS, require_cuda
from svnet_tpu_torch.nn.sv_layers import binary_matmul, v2s_invariants
from svnet_tpu_torch.ops.kernels import _build
from svnet_tpu_torch.ops.kernels.fold import Folded

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


# ---------------------------------------------------------------------------
# B1: the first round
# ---------------------------------------------------------------------------


def sv_round3_first_plain(points: torch.Tensor, folded: Folded, *,
                          S_out: int, V_out: int, k: int):
    """Plain version of the first round; same outputs as the kernel, with
    the neighbour ids (B, k, N) int32 last."""
    B, N, _ = points.shape
    idx = ops.knn_plain(points, k)
    v = ops.get_graph_feature(points, k, idx)  # (B, N, k, 3, 2)
    sva = jmajor(v2s_invariants(v, ordered_matmul(v, folded["wz0"])))
    svb = jmajor(v2s_invariants(v, ordered_matmul(v, folded["wz1"])))
    h = ordered_matmul(torch.cat([sva, svb], dim=-1), folded["w1"])
    y = _leaky(h * folded["a1"] + folded["b1"])
    wl = ordered_matmul(v, folded["w2"])
    vb = wl * vector_bn_scale(wl, folded["a2"], folded["b2"])
    s = torch.amax(y, dim=2)  # svpool: max over k, vector mean
    vm = _rank_mean(vb)  # (B, N, 3, V_out)
    s_mean = _point_sums(sva).sum(dim=2)[:, first_perm()] / (N * k)
    return (s.transpose(1, 2), vm.reshape(B, N, 3 * V_out).transpose(1, 2),
            s_mean, idx.transpose(1, 2).to(torch.int32))


def sv_round3_first(points: torch.Tensor, folded: Folded, *, S_out: int,
                    V_out: int, k: int, emit_wins: bool = False):
    """points (B, N, 3) -> (s (B, S_out, N), v (B, 3*V_out, N) ungated,
    s_mean (B, 6) c-major[, wins (B, k, N) int32])."""
    if points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError(f"points: shape {tuple(points.shape)}, expected (B, N, 3)")
    B, N, _ = points.shape
    if not 1 <= k <= N:
        raise ValueError(f"k={k} must lie in [1, N={N}]")
    if points.device.type == "cpu":
        out = sv_round3_first_plain(points, folded, S_out=S_out,
                                    V_out=V_out, k=k)
        return out if emit_wins else out[:3]
    dev = require_cuda(points.device)
    _build.check_arg(points, "points", (B, N, 3), dev)
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
    pts = points.transpose(1, 2).contiguous()  # (B, 3, N)
    aa = torch.empty((B, N), device=dev)
    s = torch.empty((B, S_out, N), device=dev)
    v = torch.empty((B, 3 * V_out, N), device=dev)
    ssum = torch.empty((B, 6, N), device=dev)
    wins = torch.empty((B, k, N), device=dev, dtype=torch.int32)
    err = lib.sv_round3_first_launch(
        pts.data_ptr(), aa.data_ptr(), *w, s.data_ptr(), v.data_ptr(),
        ssum.data_ptr(), wins.data_ptr(), B, N, k, S_out, V_out,
        _build.stream_ptr(dev))
    _build.check(err, "sv_round3_first")
    sv_round3_first.launches += 1
    s_mean = ssum.sum(dim=2)[:, first_perm()] / (N * k)
    out = (s, v, s_mean, wins)
    return out if emit_wins else out[:3]


sv_round3_first.launches = 0


# ---------------------------------------------------------------------------
# B2: a conv round
# ---------------------------------------------------------------------------


def sv_round3_plain(src: torch.Tensor, folded: Folded, *, S: int, V: int,
                    S_out: int, V_out: int, k: int, binary: bool):
    """Plain version of a conv round on channel-major src (B, S+3V, N);
    same outputs as the kernel, with the neighbour ids last."""
    B, _, N = src.shape
    x = src.transpose(1, 2)  # (B, N, S + 3V): the joint kNN features
    idx = ops.knn_plain(x, k)
    s_e, v_e = ops.get_graph_feature_sv(
        (x[..., :S], x[..., S:].reshape(B, N, 3, V)), k, idx)
    sv = jmajor(v2s_invariants(v_e, ordered_matmul(v_e, folded["wz"])))
    xc = torch.cat([s_e, sv], dim=-1)  # (B, N, k, 2S + 6V)
    if binary:  # +-1 products: exact in any order
        h = binary_matmul(torch.sign(xc + folded["beta"]), folded["w1"])
    else:
        h = ordered_matmul(xc, folded["w1"])
    y = _leaky(h * folded["a1"] + folded["b1"])
    wl = ordered_matmul(v_e, folded["w2"]) * folded["scale2"]
    vb = wl * vector_bn_scale(wl, folded["a2"], folded["b2"])
    s = torch.amax(y, dim=2)  # svpool: max over k, vector mean
    vm = _rank_mean(vb)
    se_mean = _point_sums(s_e).sum(dim=2) / (N * k)
    return (s.transpose(1, 2), vm.reshape(B, N, 3 * V_out).transpose(1, 2),
            se_mean, idx.transpose(1, 2).to(torch.int32))


def sv_round3(src: torch.Tensor, folded: Folded, *, S: int, V: int,
              S_out: int, V_out: int, k: int, binary: bool = True,
              emit_wins: bool = False):
    """src (B, S+3V, N) channel-major [s | v i-major] -> (s (B, S_out, N),
    v (B, 3*V_out, N) ungated, s_edge_mean (B, 2S)[, wins (B, k, N))]."""
    C = S + 3 * V
    if src.dim() != 3 or src.shape[1] != C:
        raise ValueError(f"src: shape {tuple(src.shape)}, expected (B, {C}, N)")
    B, _, N = src.shape
    if not 1 <= k <= N:
        raise ValueError(f"k={k} must lie in [1, N={N}]")
    if src.device.type == "cpu":
        out = sv_round3_plain(src, folded, S=S, V=V, S_out=S_out,
                              V_out=V_out, k=k, binary=binary)
        return out if emit_wins else out[:3]
    dev = require_cuda(src.device)
    _build.check_arg(src, "src", (B, C, N), dev)
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
    aa = torch.empty((B, N), device=dev)
    s = torch.empty((B, S_out, N), device=dev)
    v = torch.empty((B, 3 * V_out, N), device=dev)
    ssum = torch.empty((B, 2 * S, N), device=dev)
    wins = torch.empty((B, k, N), device=dev, dtype=torch.int32)
    err = lib.sv_round3_launch(
        src.data_ptr(), aa.data_ptr(), *w, s.data_ptr(), v.data_ptr(),
        ssum.data_ptr(), wins.data_ptr(), B, N, S, V, S_out, V_out, k,
        int(binary), _build.stream_ptr(dev))
    _build.check(err, "sv_round3")
    sv_round3.launches += 1
    se_mean = ssum.sum(dim=2) / (N * k)
    out = (s, v, se_mean, wins)
    return out if emit_wins else out[:3]


sv_round3.launches = 0
