"""Differentiable fused conv round for training, kernel B6 (counterpart of
svnet_tpu/ops/pallas/sv_round3_train.py::make_fused_round).

``fused_round_apply((sv_round3_train_fwd, sv_round3_train_bwd),
RoundDims(S, V, S_out, V_out, k, binary), src, idx, params)`` returns
``(s_out (B, N, S_out), v_out (B, N, 3*V_out) ungated, s_mean (B, 2S),
(bn1_mean, bn1_var, bnn_mean, bnn_var))``,
differentiable in ``src`` and in the leaves of ``params``, the flax-named
SVBlock subtree ``{v2s, linear1, bn1, linear2, bn2}`` (gate excluded: the
gate runs on ``s_mean`` outside). ``idx`` (B, N, k) int32 carries no
gradient. The batch statistics are biased and carry no gradient; the
caller updates the running statistics from them.

The forward is two passes (F1: BN sums; F2: outputs and the first argmax
rank per point and channel) and the backward two more (B1: BN-backward
sums; B2: d(src) and every parameter gradient). Batch statistics and the
divisions by M = B*N*k run here, in torch, between the passes. On a CUDA
tensor the passes launch csrc/sv_round3_train.cu (``sv_round3_train_fwd``
/ ``sv_round3_train_bwd``, each with a ``.launches`` counter) or raise; on
a CPU tensor the plain versions run: forward and an explicit backward in
plain PyTorch, recomputing the edges from src + idx like the kernel.

The plain versions compute the edges, frames, invariants, h and v2 in
the kernel's order, op by op, pool over the ranks in rank order, and both
sides sum the BN statistics in float64 before rounding them to f32, so
the forward passes agree bitwise (a binary network turns an ulp into a
sign or kNN flip downstream). Parameter gradients are summed over the
edges in other orders (kernel: per block, then torch), and d(src) in the
kernel adds the neighbour contributions with float atomics (run-to-run
ulp noise), so gradients agree to f32 rounding.

The first round (B5, ``sv_first_train.py``) is the same computation with
S = 0, V = 1 and init_scalar's invariants in place of the gathered
scalars (``RoundDims.first``).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from svnet_tpu_torch.config import EPS, require_cuda
from svnet_tpu_torch.nn.sv_layers import CLIP, v2s_invariants
from svnet_tpu_torch.ops.graph import gather_neighbors
from svnet_tpu_torch.ops.kernels import _build
from svnet_tpu_torch.ops.kernels.sv_round3 import (
    first_perm,
    jmajor,
    ordered_matmul,
    rank_sum,
)
from svnet_tpu_torch.utils.convert import flatten, nest

BN_EPS = 1e-5
NSQ_FLOOR = 1e-12
TILE = 8  # the smallest tile of centre points (csrc/sv_train.cuh)
PHASE = {"f1": 0, "f2": 1, "b1": 2, "b2": 3}
# pointer slots of the launch functions, in csrc/sv_train.cuh's P_* order
SLOTS = ("src", "idx", "wz0", "wz", "scalez", "w1", "w1t", "beta", "scale1",
         "g1", "bb1", "mu1", "inv1", "w2", "w2t", "scale2", "g2", "bb2",
         "mun", "invn", "dso", "dvo", "kmax", "dssum", "red", "part", "ssum",
         "s_out", "v_out", "dctr", "dnbr")


@dataclass(frozen=True)
class RoundDims:
    S: int
    V: int
    S_out: int
    V_out: int
    k: int
    binary: bool
    first: bool = False

    @property
    def C(self) -> int:
        return self.S + 3 * self.V

    @property
    def twoV(self) -> int:
        return 2 * self.V

    @property
    def SX(self) -> int:
        """Width of x's scalar part: the edge scalars, or init_scalar's
        invariants in the first round."""
        return 3 * self.twoV if self.first else 2 * self.S

    @property
    def IN1(self) -> int:
        return self.SX + 3 * self.twoV

    def perm(self) -> list[int]:
        """Kernel row order of linear1's input (invariants j-major) -> the
        flax row (invariants c-major, c*3 + j)."""
        inv = [c * 3 + j for j in range(3) for c in range(self.twoV)]
        head = inv if self.first else list(range(self.SX))
        return head + [self.SX + r for r in inv]


def _col(x):
    return x.reshape(-1).contiguous()


def kernel_params(p: dict, d: RoundDims) -> dict:
    """The flax-named subtree -> the passes' weights: linear1 rows (and
    beta) permuted j-major, weights signed when binary, unit scales and
    zero beta for FP."""
    perm = torch.tensor(d.perm(), device=p["linear1"]["kernel"].device)
    wz = p["v2s"]["linear"]["kernel"]
    w1 = p["linear1"]["kernel"][perm]
    w2 = p["linear2"]["kernel"]
    dev = w1.device
    if d.binary:
        wz, w1, w2 = torch.sign(wz), torch.sign(w1), torch.sign(w2)
        scalez = p["v2s"]["linear"]["scale"]
        beta = p["linear1"]["beta"][perm]
        scale1, scale2 = p["linear1"]["scale"], p["linear2"]["scale"]
    else:
        scalez = torch.ones(3, device=dev)
        beta = torch.zeros(d.IN1, device=dev)
        scale1 = torch.ones(d.S_out, device=dev)
        scale2 = torch.ones(d.V_out, device=dev)
    kp = {
        "wz": wz.contiguous(), "scalez": _col(scalez),
        "w1": w1.contiguous(), "w1t": w1.t().contiguous(), "beta": _col(beta),
        "scale1": _col(scale1),
        "g1": _col(p["bn1"]["bn"]["scale"]), "bb1": _col(p["bn1"]["bn"]["bias"]),
        "w2": w2.contiguous(), "w2t": w2.t().contiguous(),
        "scale2": _col(scale2),
        "g2": _col(p["bn2"]["bn"]["scale"]), "bb2": _col(p["bn2"]["bn"]["bias"]),
    }
    if d.first:
        kp["wz0"] = p["init_scalar"]["linear"]["kernel"].contiguous()
    return kp


def bn_stats(sums: torch.Tensor, M: int, n: int):
    """float64 sums [x (n), x^2 (n)] over M samples -> float32 (mean,
    biased var, 1/std). Double sums round to the same f32 statistics in
    any summation order, so kernel and plain version agree on them."""
    mu = sums[:n] / M
    var = torch.clamp(sums[n:] / M - mu * mu, min=0.0)
    return mu.float(), var.float(), (1.0 / torch.sqrt(var + BN_EPS)).float()


def _dsum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the edge axes (B, N, k) in float64."""
    return x.sum((0, 1, 2), dtype=torch.float64)


def _leaky(y):
    return torch.where(y >= 0, y, 0.2 * y)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _edges(src, idx, kp, d: RoundDims):
    """Recompute a round's edge quantities from src (B, N, C) + idx."""
    B, N, _ = src.shape
    S, V = d.S, d.V
    nbr = gather_neighbors(src, idx, plain=True)  # (B, N, k, C)
    ctr = src[:, :, None, :].expand_as(nbr)
    e = nbr - ctr
    kk = idx.shape[-1]
    ve = torch.cat([e[..., S:].reshape(B, N, kk, 3, V),
                    ctr[..., S:].reshape(B, N, kk, 3, V)], dim=-1)  # (.., 3, 2V)
    zr = ordered_matmul(ve, kp["wz"])  # (B, N, k, 3, 3) [i][j]
    z = zr * kp["scalez"]
    sv = jmajor(v2s_invariants(ve, z))
    q = {"ve": ve, "zr": zr, "z": z}
    if d.first:
        q["z0"] = ordered_matmul(ve, kp["wz0"])
        head = jmajor(v2s_invariants(ve, q["z0"]))
    else:
        head = torch.cat([e[..., :S], ctr[..., :S]], dim=-1)
    x = torch.cat([head, sv], dim=-1)  # (B, N, k, IN1)
    if d.binary:  # +-1 products: exact in any order
        xq = torch.sign(x + kp["beta"])
        hr = xq @ kp["w1"]
    else:
        xq = x
        hr = ordered_matmul(x, kp["w1"])
    v2r = ordered_matmul(ve, kp["w2"])  # (B, N, k, 3, V_out)
    v2 = v2r * kp["scale2"]
    nsq = v2[..., 0, :] * v2[..., 0, :] + v2[..., 1, :] * v2[..., 1, :] \
        + v2[..., 2, :] * v2[..., 2, :]
    sq = torch.sqrt(torch.clamp(nsq, min=NSQ_FLOOR))
    q.update(x=x, xq=xq, hr=hr, h=hr * kp["scale1"], v2r=v2r, v2=v2, nsq=nsq,
             sq=sq, n=sq + EPS)
    return q


def _first_argmax_max(y: torch.Tensor):
    """Max over the rank axis (dim 2) of (B, N, k, C) and the FIRST rank
    among equal maxima (``>`` in rank order, as the kernels)."""
    acc = y[:, :, 0]
    arg = torch.zeros(acc.shape, dtype=torch.int32, device=y.device)
    for r in range(1, y.shape[2]):
        upd = y[:, :, r] > acc
        acc = torch.where(upd, y[:, :, r], acc)
        arg = torch.where(upd, torch.full_like(arg, r), arg)
    return acc, arg


def train_fwd_plain(src, idx, kp, d: RoundDims):
    """Plain forward: (s_out, v_out, ssum (B, SX) float64 j-major sums of
    the gate scalars, (mu1, var1, inv1, mun, varn, invn), kmax (B, N, S_out)
    int32)."""
    B, N, _ = src.shape
    q = _edges(src, idx, kp, d)
    M = B * N * d.k
    h, n = q["h"], q["n"]
    mu1, var1, inv1 = bn_stats(torch.cat([_dsum(h), _dsum(h * h)]), M, d.S_out)
    mun, varn, invn = bn_stats(torch.cat([_dsum(n), _dsum(n * n)]), M, d.V_out)
    # per point over the ranks in rank order (as the kernel), then over N
    ssum = rank_sum(q["x"][..., :d.SX]).sum(1, dtype=torch.float64)
    y = _leaky(kp["g1"] * ((h - mu1) * inv1) + kp["bb1"])
    s_out, kmax = _first_argmax_max(y)
    nbn = kp["g2"] * ((n - mun) * invn) + kp["bb2"]
    v = q["v2"] * (nbn / n)[..., None, :]
    v_out = (rank_sum(v) * (1.0 / d.k)).reshape(B, N, 3 * d.V_out)
    return s_out, v_out, ssum, (mu1, var1, inv1, mun, varn, invn), kmax


def train_bwd_plain(src, idx, kp, d: RoundDims, saved, dso, dvo, dssum):
    """Plain backward. saved = (kmax, mu1, inv1, mun, invn); dssum (B, SX)
    is the pre-divided gate cotangent, j-major. Returns (dsrc, grads) with
    grads keyed like the kernel's: w1 (kernel row order), w2, wz, wz0,
    beta, scale1, scale2, scalez, and the BN sums dysum, dyxh, dnbsum,
    dnbnh."""
    kmax, mu1, inv1, mun, invn = saved
    B, N, C = src.shape
    k = d.k
    q = _edges(src, idx, kp, d)
    M = B * N * k
    xhat = (q["h"] - mu1) * inv1
    lmask = torch.where(kp["g1"] * xhat + kp["bb1"] >= 0, 1.0, 0.2)
    ranks = torch.arange(k, device=src.device, dtype=torch.int32)[:, None]
    dy = torch.where(kmax[:, :, None, :] == ranks, dso[:, :, None, :], 0.0) * lmask
    n, v2 = q["n"], q["v2"]
    nhat = (n - mun) * invn
    nbn = kp["g2"] * nhat + kp["bb2"]
    w = nbn / n
    dout = dvo.reshape(B, N, 1, 3, d.V_out) * (1.0 / k)
    G = dout[..., 0, :] * v2[..., 0, :] + dout[..., 1, :] * v2[..., 1, :] \
        + dout[..., 2, :] * v2[..., 2, :]
    dnbn = G / n
    sums = {"dysum": _dsum(dy), "dyxh": _dsum(dy * xhat),
            "dnbsum": _dsum(dnbn), "dnbnh": _dsum(dnbn * nhat)}
    s1, s2, s3, s4 = [(sums[n] / M).float()
                      for n in ("dysum", "dyxh", "dnbsum", "dnbnh")]
    g = {n: v.float() for n, v in sums.items()}

    dh = (kp["g1"] * inv1) * ((dy - s1) - xhat * s2)
    dhr = dh * kp["scale1"]
    g["scale1"] = (dh * q["hr"]).sum((0, 1, 2))
    dx = dhr @ kp["w1t"]
    g["w1"] = q["xq"].reshape(-1, d.IN1).t() @ dhr.reshape(-1, d.S_out)
    if d.binary:
        dx = dx * (torch.abs(q["x"] + kp["beta"]) <= CLIP)
        g["beta"] = dx.sum((0, 1, 2))
    dn = (kp["g2"] * invn) * ((dnbn - s3) - nhat * s4)
    dn = dn - (G * nbn) / (n * n)
    fac = (dn / q["sq"]) * (q["nsq"] > NSQ_FLOOR)
    dv2 = dout * w[..., None, :] + fac[..., None, :] * v2
    dv2r = dv2 * kp["scale2"]
    g["scale2"] = (dv2 * q["v2r"]).sum((0, 1, 2, 3))
    ve = q["ve"]
    dve = dv2r @ kp["w2t"]  # (B, N, k, 3, 2V)
    g["w2"] = ve.reshape(-1, d.twoV).t() @ dv2r.reshape(-1, d.V_out)

    kk = idx.shape[-1]
    dsv = dx[..., d.SX:].reshape(B, N, kk, 3, d.twoV)  # [j][c]
    dz = torch.einsum("bnkjc,bnkic->bnkij", dsv, ve)
    dzr = dz * kp["scalez"]
    g["scalez"] = (dz * q["zr"]).sum((0, 1, 2, 3))
    g["wz"] = torch.einsum("bnkic,bnkij->cj", ve, dzr)
    dve = dve + torch.einsum("bnkjc,bnkij->bnkic", dsv, q["z"]) \
        + torch.einsum("cj,bnkij->bnkic", kp["wz"], dzr)
    if d.first:
        dsa = dx[..., :d.SX].reshape(B, N, kk, 3, d.twoV) \
            + dssum.reshape(B, 1, 1, 3, d.twoV)
        dz0 = torch.einsum("bnkjc,bnkic->bnkij", dsa, ve)
        g["wz0"] = torch.einsum("bnkic,bnkij->cj", ve, dz0)
        dve = dve + torch.einsum("bnkjc,bnkij->bnkic", dsa, q["z0"]) \
            + torch.einsum("cj,bnkij->bnkic", kp["wz0"], dz0)
        dnbr_s = dctr_s = dx[..., :0]
    else:
        S = d.S
        dsf = dx[..., :2 * S] + dssum[:, None, None, :]
        dnbr_s, dctr_s = dsf[..., :S], -dsf[..., :S] + dsf[..., S:]
    V = d.V
    dnbr = torch.cat([dnbr_s, dve[..., :V].reshape(B, N, kk, 3 * V)], dim=-1)
    dctr = torch.cat([dctr_s, (-dve[..., :V] + dve[..., V:]).reshape(
        B, N, kk, 3 * V)], dim=-1)
    rows = (idx.long() + N * torch.arange(B, device=src.device)[:, None, None])
    dsrc = dctr.sum(dim=2).reshape(B * N, C).index_add(
        0, rows.reshape(-1), dnbr.reshape(-1, C)).reshape(B, N, C)
    return dsrc, g


# ---------------------------------------------------------------------------
# kernel passes
# ---------------------------------------------------------------------------


def _nblocks(dev, d: RoundDims, B: int, N: int) -> int:
    """Rows of per-block partial sums: two per SM, at most one per tile.
    The kernel runs as many blocks as the card holds at once, at most this
    many, and zeroes the rows of the blocks it does not run."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return max(1, min(B * -(-N // TILE), 2 * sms))


def _part_width(d: RoundDims, phase: str) -> int:
    if phase in ("f1", "b1"):
        return 2 * d.S_out + 2 * d.V_out
    return (d.IN1 * d.S_out + d.twoV * d.V_out
            + d.twoV * 3 * (2 if d.first else 1) + d.IN1 + d.S_out + d.V_out + 3)


def _check_kp(kp, d: RoundDims, dev):
    shapes = {"wz": (d.twoV, 3), "scalez": (3,), "w1": (d.IN1, d.S_out),
              "w1t": (d.S_out, d.IN1), "beta": (d.IN1,), "scale1": (d.S_out,),
              "g1": (d.S_out,), "bb1": (d.S_out,), "w2": (d.twoV, d.V_out),
              "w2t": (d.V_out, d.twoV), "scale2": (d.V_out,),
              "g2": (d.V_out,), "bb2": (d.V_out,)}
    if d.first:
        shapes["wz0"] = (d.twoV, 3)
    for name, shape in shapes.items():
        _build.check_arg(kp[name], name, shape, dev)


def _launch(symbol: str, phase: str, d: RoundDims, B: int, N: int,
            nblocks: int, dev, **ptrs) -> None:
    for name, t in ptrs.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    arr = (ctypes.c_void_p * len(SLOTS))(
        *[ptrs[s].data_ptr() if ptrs.get(s) is not None else None for s in SLOTS])
    dims = (ctypes.c_int * 9)(B, N, d.k, d.S, d.V, d.S_out, d.V_out,
                              int(d.binary), nblocks)
    err = getattr(_build.lib(), symbol)(PHASE[phase], arr, dims,
                                        _build.stream_ptr(dev))
    _build.check(err, f"{symbol} {phase}")


def tile(d: RoundDims, phase: str) -> int:
    """Centre points per tile that the kernel launches ``phase`` with at
    ``d``'s widths: 16, or 8 where b2's layout would exceed the shared
    memory with 16 (0: none fits). Builds the kernels."""
    dims = (ctypes.c_int * 9)(1, d.k, d.k, d.S, d.V, d.S_out, d.V_out,
                              int(d.binary), 1)
    symbol = "sv_first_train_tile" if d.first else "sv_round3_train_tile"
    return getattr(_build.lib(), symbol)(PHASE[phase], dims)


def check_inputs(src, idx, d: RoundDims):
    """Shapes of a round's src (B, N, C) and ids (B, N, k)."""
    if src.dim() != 3 or src.shape[-1] != d.C:
        raise ValueError(f"src: shape {tuple(src.shape)}, expected (B, N, {d.C})")
    B, N, _ = src.shape
    if not 1 <= d.k <= N:
        raise ValueError(f"k={d.k} must lie in [1, N={N}]")
    if tuple(idx.shape) != (B, N, d.k):
        raise ValueError(f"idx: shape {tuple(idx.shape)}, expected {(B, N, d.k)}")


def train_fwd_kernel(symbol: str, src, idx, kp, d: RoundDims):
    """F1 + F2 on the card; the same outputs as ``train_fwd_plain``."""
    dev = require_cuda(src.device)
    B, N, _ = src.shape
    _build.check_arg(src, "src", (B, N, d.C), dev)
    if idx.dtype != torch.int32 or idx.device != dev or not idx.is_contiguous():
        raise ValueError("idx: expected a contiguous int32 tensor on the card")
    _check_kp(kp, d, dev)
    nb = _nblocks(dev, d, B, N)
    part = torch.empty((nb, _part_width(d, "f1")), device=dev, dtype=torch.float64)
    ssum = torch.empty((B, N, d.SX), device=dev)
    _launch(symbol, "f1", d, B, N, nb, dev, src=src, idx=idx, part=part,
            ssum=ssum, **kp)
    sums = part.sum(0)
    M = B * N * d.k
    So = d.S_out
    mu1, var1, inv1 = bn_stats(sums[:2 * So], M, So)
    mun, varn, invn = bn_stats(sums[2 * So:], M, d.V_out)
    s_out = torch.empty((B, N, So), device=dev)
    v_out = torch.empty((B, N, 3 * d.V_out), device=dev)
    kmax = torch.empty((B, N, So), device=dev, dtype=torch.int32)
    _launch(symbol, "f2", d, B, N, nb, dev, src=src, idx=idx, mu1=mu1,
            inv1=inv1, mun=mun, invn=invn, s_out=s_out, v_out=v_out,
            kmax=kmax, **kp)
    return (s_out, v_out, ssum.sum(1, dtype=torch.float64),
            (mu1, var1, inv1, mun, varn, invn), kmax)


def train_bwd_kernel(symbol: str, src, idx, kp, d: RoundDims, saved, dso,
                     dvo, dssum):
    """B1 + B2 on the card; the same outputs as ``train_bwd_plain``."""
    kmax, mu1, inv1, mun, invn = saved
    dev = require_cuda(src.device)
    B, N, C = src.shape
    for name, t, shape in (("dso", dso, (B, N, d.S_out)),
                           ("dvo", dvo, (B, N, 3 * d.V_out)),
                           ("dssum", dssum, (B, d.SX))):
        _build.check_arg(t, name, shape, dev)
    nb = _nblocks(dev, d, B, N)
    part = torch.empty((nb, _part_width(d, "b1")), device=dev, dtype=torch.float64)
    common = dict(src=src, idx=idx, mu1=mu1, inv1=inv1, mun=mun, invn=invn,
                  dso=dso, dvo=dvo, kmax=kmax, dssum=dssum, **kp)
    _launch(symbol, "b1", d, B, N, nb, dev, part=part, **common)
    M = B * N * d.k
    sums = part.sum(0)
    So, Vo = d.S_out, d.V_out
    g = {"dysum": sums[:So].float(), "dyxh": sums[So:2 * So].float(),
         "dnbsum": sums[2 * So:2 * So + Vo].float(),
         "dnbnh": sums[2 * So + Vo:].float()}
    red = (sums / M).float()
    part = torch.empty((nb, _part_width(d, "b2")), device=dev)
    dctr = torch.empty((B, N, C), device=dev)
    dnbr = torch.zeros((B, N, C), device=dev)
    _launch(symbol, "b2", d, B, N, nb, dev, part=part, red=red, dctr=dctr,
            dnbr=dnbr, **common)
    p = part.sum(0)
    sizes = [("w1", d.IN1 * So), ("w2", d.twoV * Vo), ("wz", d.twoV * 3)]
    if d.first:
        sizes.append(("wz0", d.twoV * 3))
    sizes += [("beta", d.IN1), ("scale1", So), ("scale2", Vo), ("scalez", 3)]
    o = 0
    for name, n in sizes:
        g[name] = p[o:o + n]
        o += n
    g["w1"] = g["w1"].reshape(d.IN1, So)
    g["w2"] = g["w2"].reshape(d.twoV, Vo)
    g["wz"] = g["wz"].reshape(d.twoV, 3)
    if d.first:
        g["wz0"] = g["wz0"].reshape(d.twoV, 3)
    return dctr + dnbr, g


def sv_round3_train_fwd(src, idx, kp, d: RoundDims):
    """Forward passes of a conv round: plain on the CPU, the kernel on the
    card."""
    check_inputs(src, idx, d)
    if src.device.type == "cpu":
        return train_fwd_plain(src, idx, kp, d)
    out = train_fwd_kernel("sv_round3_train_launch", src, idx, kp, d)
    sv_round3_train_fwd.launches += 1
    return out


def sv_round3_train_bwd(src, idx, kp, d: RoundDims, saved, dso, dvo, dssum):
    """Backward passes of a conv round: plain on the CPU, the kernel on
    the card."""
    check_inputs(src, idx, d)
    if src.device.type == "cpu":
        return train_bwd_plain(src, idx, kp, d, saved, dso, dvo, dssum)
    out = train_bwd_kernel("sv_round3_train_launch", src, idx, kp, d, saved,
                           dso, dvo, dssum)
    sv_round3_train_bwd.launches += 1
    return out


sv_round3_train_fwd.launches = 0
sv_round3_train_bwd.launches = 0


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


def param_grads(g: dict, p: dict, d: RoundDims) -> dict:
    """Kernel-order gradients -> the flax-named subtree's: linear1 rows
    un-permuted, STE masks |w| <= 1.2 on the signed weights (binary)."""
    inv = torch.argsort(torch.tensor(d.perm(), device=g["w1"].device))
    w1, beta = g["w1"][inv], g.get("beta")
    wz, w2 = g["wz"], g["w2"]
    if d.binary:
        wz = wz * (torch.abs(p["v2s"]["linear"]["kernel"]) <= CLIP)
        w1 = w1 * (torch.abs(p["linear1"]["kernel"]) <= CLIP)
        w2 = w2 * (torch.abs(p["linear2"]["kernel"]) <= CLIP)
    out = {
        "v2s.linear.kernel": wz, "linear1.kernel": w1, "linear2.kernel": w2,
        "bn1.bn.scale": g["dyxh"], "bn1.bn.bias": g["dysum"],
        "bn2.bn.scale": g["dnbnh"], "bn2.bn.bias": g["dnbsum"],
    }
    if d.binary:
        out.update({"v2s.linear.scale": g["scalez"], "linear1.beta": beta[inv],
                    "linear1.scale": g["scale1"], "linear2.scale": g["scale2"]})
    if d.first:
        out["init_scalar.linear.kernel"] = g["wz0"]
    return out


class FusedTrainRound(torch.autograd.Function):
    """One fused training round; ``ops`` is the (forward, backward) pair of
    a module (``sv_round3_train_fwd/bwd`` or the first round's)."""

    @staticmethod
    def forward(ctx, src, idx, d, ops, names, *leaves):
        p = nest(dict(zip(names, leaves)))
        kp = kernel_params(p, d)
        s_out, v_out, ssum, (mu1, var1, inv1, mun, varn, invn), kmax = \
            ops[0](src, idx, kp, d)
        B, N, _ = src.shape
        s_mean = (ssum / (N * d.k)).float()
        if d.first:  # the kernel's j-major gate scalars -> flax c-major
            s_mean = s_mean[:, first_perm()]
        ctx.d, ctx.ops, ctx.names = d, ops, names
        ctx.save_for_backward(src, idx, kmax, mu1, inv1, mun, invn, *leaves)
        ctx.mark_non_differentiable(mu1, var1, mun, varn)
        return s_out, v_out, s_mean, mu1, var1, mun, varn

    @staticmethod
    def backward(ctx, dso, dvo, dsmean, *_):
        src, idx, kmax, mu1, inv1, mun, invn, *leaves = ctx.saved_tensors
        d, names = ctx.d, ctx.names
        p = nest(dict(zip(names, leaves)))
        kp = kernel_params(p, d)
        B, N, _ = src.shape
        dssum = dsmean / (N * d.k)
        if d.first:
            perm = first_perm()
            dssum = dssum[:, sorted(range(len(perm)), key=perm.__getitem__)]
        dsrc, g = ctx.ops[1](src, idx, kp, d, (kmax, mu1, inv1, mun, invn),
                             dso.contiguous(), dvo.contiguous(),
                             dssum.contiguous())
        grads = param_grads(g, p, d)
        return (dsrc, None, None, None, None, *[grads[n] for n in names])


def fused_round_apply(ops, d: RoundDims, src, idx, params: dict):
    """Run FusedTrainRound on a flax-named subtree; returns (s_out, v_out,
    s_mean, (mu1, var1, mun, varn))."""
    flat = flatten(params)
    names = tuple(sorted(flat))
    out = FusedTrainRound.apply(src, idx, d, ops, names,
                                *[flat[n] for n in names])
    return out[0], out[1], out[2], tuple(out[3:])

