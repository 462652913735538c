#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (svnet_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from svnet_tpu_torch/csrc and drives the
port's two paths at the full model width (40 classes, k=20, seeded random
weights): binary SV-DGCNN classification serving, exact mode (B=128,
N=1024), through SVDGCNNClsEngine, and fused binary training (B=32,
N=1024) through the trainer. Phases; any failure raises and the script
exits non-zero:

  0  a CUDA device is required; print the card's name and power limit
  1  build the kernels (nvcc), print the build time
  2  each kernel against its plain PyTorch version on the card, on the
     same inputs, at the paths' shapes (plus a ragged B=8, N=1000, k=7
     case). Serving rounds: neighbour ids agree on >= 99.99% of
     (b, rank, n) and every mismatch is a near-tie (true distances within
     1e-5 relative); on centre points whose neighbour sets agree, outputs
     within rtol=1e-4, atol=1e-5. kNN (B4): the same id check.
     Training rounds (B5, B6; binary and FP): forward outputs, gate means
     and batch statistics within rtol=1e-4, atol=1e-5 (they are equal:
     both sides sum the batch statistics in double), argmax ranks equal
     on >= 99.99%; backward with seeded cotangents: the flip-tolerant bars
     of tests/test_fused_train.py (cosine >= 0.99 on d(src), >= 0.9 on
     each gradient of 8 or more entries) and, tighter than their 5e-2 /
     2e-1, all gradients together within 1e-3 relative (parameter
     gradients are summed in another order, d(src) with atomics)
  3  serve 5 requests; each launches sv_round3_first once, sv_round3
     three times and sv_point_block_cm once; logits finite, (128, 40);
     top-1 agrees with the plain-version engine on >= 99% of clouds
  4  SO(3) invariance through the kernels (FP model): logits of rotated
     and unrotated clouds within rtol=2e-2, atol=2e-3
  5  train: 1 warm-up + 10 timed steps of the binary model (Adam, --rot
     z) on seeded surface clouds through train_epoch; each step launches
     knn 4 times, the first-round passes once forward and once backward
     and the conv-round passes three times each way; the loss is finite;
     then one BN re-estimation batch and one eval batch (eager model)
  6  one train step through the kernels against the same step through
     their plain versions, from the same weights and batch: loss and new
     BN running statistics within 1e-4 relative (the forward passes are
     equal), gradients within the bars of phase 2, parameter update
     cosine >= 0.999

The last lines of output are the card line, one JSON object per kernel
(``{"kernels": [...]}``) and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
B, N, K, CLASSES = 128, 1024, 20, 40
B_TRAIN = 32  # the JAX trainer's batch (cli/flags.py, tools/bench_train_step.py)
TRAIN_STEPS = 10
RTOL, ATOL = 1e-4, 1e-5
NEAR_TIE = 1e-5
REQUESTS = 5
SEED = 0
# the least time of a kernel's work: bytes over the HBM rate; real-valued
# operations over the f32 rate outside the tensor cores, and the products of
# +-1 by +-1 (a binary round's linear1, exact in bf16, as the TPU kernels
# compute it) over the dense bf16 tensor-core rate; NVIDIA H100 SXM data
# sheet, at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12


def log(*args):
    print(*args, flush=True)


def cloud(batch: int, n: int, gen, device):
    """Seeded clouds scaled into the unit ball, as ModelNet's are."""
    import torch

    pts = torch.randn(batch, n, 3, generator=gen)
    pts = pts / pts.norm(dim=-1).amax(dim=1)[:, None, None]
    return pts.to(device)


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean device time of fn() over reps calls, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


class Report:
    """Per-kernel results of phase 2: largest compared error, and per
    timed call its ms, plain ms, bound (ms, 'bytes'/'operations') and the
    library call's ms (or None)."""

    def __init__(self):
        self.err: dict[str, float] = {}
        self.ms: dict[str, list] = {}

    def add(self, name, err, ms=None, plain_ms=None, bound=None, library_ms=None):
        self.err[name] = max(self.err.get(name, 0.0), err)
        if ms is not None:
            self.ms.setdefault(name, []).append((ms, plain_ms, bound, library_ms))


def bound(flops: float, nbytes: float, pm1_flops: float = 0.0):
    """(least ms, what bounds it) of a call moving nbytes, doing flops
    real-valued operations and pm1_flops of +-1 by +-1 products."""
    t_ops = flops / F32_FLOP_PER_S + pm1_flops / BF16_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def knn_flops(b, n, c):
    """Distances of all pairs: c multiply-adds, then 2*inner - |x|^2 - |y|^2."""
    return b * n * n * (2.0 * c + 3.0)


def edge_flops(S, V, S_out, V_out, first=False, binary=False):
    """Operations of one edge of an SV round, as (real-valued, +-1 by +-1):
    Vector2Scalar frames and invariants (two streams in the first round),
    linear1 over [scalars | invariants] (signs by signs when binary),
    linear2 over the 3 x 2V vector rows, BN, leaky, norms and pooling."""
    twoV = 2 * V
    IN1 = (3 * twoV if first else 2 * S) + 3 * twoV
    streams = 2 if first else 1
    linear1 = 2.0 * IN1 * S_out
    rest = (streams * (9 * twoV * 2 + 3 * twoV * 5) + 3 * twoV * V_out * 2
            + 6 * S_out + 14 * V_out)
    return (rest, linear1) if binary else (rest + linear1, 0.0)


def check_ids(tag, wk, wp, feats):
    """Neighbour-id agreement of kernel (wk) and plain (wp) ids (B, k, N);
    feats (B, N, C) are the features the distances were taken over.
    Returns the (B, N) mask of centre points whose neighbour sets agree."""
    import torch

    wk, wp = wk.long(), wp.long()
    eq = wk == wp
    frac = eq.float().mean().item()
    bad = (~eq).nonzero()
    worst = 0.0
    if len(bad):
        b, n = bad[:, 0], bad[:, 2]
        f = feats.double()
        ctr = f[b, n]
        dk = ((f[b, wk[b, bad[:, 1], n]] - ctr) ** 2).sum(-1)
        dp = ((f[b, wp[b, bad[:, 1], n]] - ctr) ** 2).sum(-1)
        rel = (dk - dp).abs() / torch.maximum(torch.maximum(dk, dp),
                                              torch.full_like(dk, 1e-30))
        worst = rel.max().item()
    log(f"  {tag}: ids agree {frac:.6f} ({len(bad)} mismatches, worst "
        f"relative distance gap {worst:.3g})")
    if frac < 0.9999:
        raise AssertionError(f"{tag}: neighbour ids agree on {frac} < 0.9999")
    if worst > NEAR_TIE:
        raise AssertionError(f"{tag}: a mismatch is not a near-tie ({worst})")
    same = torch.sort(wk, dim=1).values == torch.sort(wp, dim=1).values
    return same.all(dim=1)  # (B, N)


def check_close(tag, got, want, cols=None):
    """got/want (B, C, N) compared on the centre columns ``cols`` (B, N),
    or (B, C) compared as a whole. Returns the max abs error."""
    if cols is not None:
        got = got.transpose(1, 2)[cols]
        want = want.transpose(1, 2)[cols]
    err = (got - want).abs()
    over = err - (ATOL + RTOL * want.abs())
    if not bool((over <= 0).all()):
        raise AssertionError(
            f"{tag}: max abs err {err.max().item():.3g} beyond rtol={RTOL}, "
            f"atol={ATOL} ({int((over > 0).sum())} elements)")
    return err.max().item() if err.numel() else 0.0


def compare_round(rep, tag, name, kern, plain, feats, time_it, cost):
    """Kernel outputs (s, v, gate stats, wins) against the plain version's;
    cost = (flops, bytes) of the call."""
    import torch

    ko, po = kern(), plain()
    sync(ko[0].device)
    agree = check_ids(tag, ko[3], po[3], feats)
    err = max(check_close(tag + " s", ko[0], po[0], agree),
              check_close(tag + " v", ko[1], po[1], agree))
    whole = agree.all(dim=1)  # batches whose every neighbour set agrees
    if bool(whole.any()):
        err = max(err, check_close(tag + " gate stats", ko[2][whole],
                                   po[2][whole]))
    ms = plain_ms = None
    if time_it:
        ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
    log(f"  {tag}: outputs max abs err {err:.3g} on {int(agree.sum())} "
        f"of {agree.numel()} points; kernel {ms} ms, plain {plain_ms} ms, "
        f"bound {bound(*cost)}")
    rep.add(name, err, ms, plain_ms, bound(*cost))
    return po


def phase2(rep, eng, eng_fp, gen, dev, b=B, n=N, k=K, time_it=True):
    """Phase 2 at (b, n, k); the ragged case runs at (8, n - 24, 7)."""
    import torch

    from svnet_tpu_torch.infer import POINT_V_OFF, ROUNDS, se_gate
    from svnet_tpu_torch.ops.kernels import sv_point as kp
    from svnet_tpu_torch.ops.kernels import sv_round3 as kr

    def first(pts, kk, tag, time_it):
        f = eng.folded_first
        kw = dict(S_out=32, V_out=10, k=kk)
        bb, nn = pts.shape[:2]
        ef, pm1 = edge_flops(0, 1, 32, 10, True)
        cost = (knn_flops(bb, nn, 3) + bb * nn * kk * ef,
                4.0 * bb * nn * (3 + 32 + 30 + 6 + kk), bb * nn * kk * pm1)
        return compare_round(
            rep, tag, "sv_round3_first",
            lambda: kr.sv_round3_first(pts, f, emit_wins=True, **kw),
            lambda: kr.sv_round3_first_plain(pts, f, **kw), pts, time_it, cost)

    def conv(src, e, name, kk, tag, time_it):
        S, V, S_out, V_out = ROUNDS[name]
        kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=kk, binary=e.binary)
        f = e.folded[name]
        bb, C, nn = src.shape
        ef, pm1 = edge_flops(S, V, S_out, V_out, binary=e.binary)
        cost = (knn_flops(bb, nn, C) + bb * nn * kk * ef,
                4.0 * bb * nn * (C + S_out + 3 * V_out + 2 * S + kk),
                bb * nn * kk * pm1)
        return compare_round(
            rep, tag, "sv_round3",
            lambda: kr.sv_round3(src, f, emit_wins=True, **kw),
            lambda: kr.sv_round3_plain(src, f, **kw),
            src.transpose(1, 2), time_it, cost)

    def gated(p, out):
        return out[1] * se_gate(p, out[2]).repeat(1, 3)[:, :, None]

    # main shapes, inputs chained through the plain versions
    pts = cloud(b, n, gen, dev)
    po = first(pts, k, f"sv_round3_first B={b} N={n} k={k}", time_it)
    outs = [(po[0], gated(eng.p["conv1"], po))]
    for name in ROUNDS:
        src = torch.cat(outs[-1], dim=1).contiguous()
        po = conv(src, eng, name, k, f"sv_round3 {name} binary", time_it)
        conv(src, eng_fp, name, k, f"sv_round3 {name} fp", False)
        outs.append((po[0], gated(eng.p[name], po)))
    s_cm = torch.cat([o[0] for o in outs], dim=1)
    v_cm = torch.cat([o[1] for o in outs], dim=1)
    src5 = torch.cat([s_cm, v_cm], dim=1).contiguous()
    g5 = se_gate(eng.p["conv5"], s_cm.mean(dim=2)).contiguous()
    kw = dict(S=256, V=83, S_out=512, V_out=170, v_off=POINT_V_OFF,
              binary=True)
    fp_ = eng.folded_point

    def kern():
        return kp.sv_point_block_cm(src5, g5, fp_, **kw)

    def plain():
        return kp.sv_point_block_cm_plain(src5, g5, fp_, **kw)

    ko, pl = kern(), plain()
    sync(dev)
    err = max(check_close("sv_point_block_cm x", ko[0], pl[0]),
              check_close("sv_point_block_cm s5_max", ko[1], pl[1]),
              check_close("sv_point_block_cm v5_mean", ko[2], pl[2]))
    ms = plain_ms = None
    if time_it:
        ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
    log(f"  sv_point_block_cm B={b} N={n}: max abs err {err:.3g}; "
        f"kernel {ms} ms, plain {plain_ms} ms")  # bound: see the kernels line
    # linear1 (505 x 512) takes signs by signs; the rest is real-valued
    per_point = (2.0 * 3 * 83 * 170 + 9 * 83 * 2 + 3 * 83 * 5
                 + 9 * 170 * 2 + 3 * 170 * 5 + 6 * 512 + 14 * 170)
    rep.add("sv_point_block_cm", err, ms, plain_ms,
            bound(b * n * per_point, 4.0 * b * n * (505 + 1022),
                  b * n * 2.0 * 505 * 512))

    # ragged: N and k divide no tile
    n_r = n - 24
    pts = cloud(8, n_r, gen, dev)
    po = first(pts, 7, f"sv_round3_first ragged B=8 N={n_r} k=7", False)
    src = torch.cat([po[0], gated(eng.p["conv1"], po)], dim=1).contiguous()
    conv(src, eng, "conv2", 7, f"sv_round3 conv2 ragged B=8 N={n_r} k=7",
         False)


def cos(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm() + 1e-30))


def check_grads(tag, got: dict, want: dict, total: float, dsrc=None):
    """The flip-tolerant bars: cosine >= 0.99 on d(src) (a pair), >= 0.9 on
    each gradient of 8 or more entries, all together within ``total``
    relative. Returns (max abs err, relative error of all together)."""
    if dsrc is not None:
        c = cos(*dsrc)
        if c < 0.99:
            raise AssertionError(f"{tag}: d(src) cosine {c} < 0.99")
    worst = 1.0
    for name, w in want.items():
        g = got[name]
        if w.numel() >= 8 and float(w.norm() * g.norm()) > 1e-10:
            c = cos(g, w)
            worst = min(worst, c)
            if c < 0.9:
                raise AssertionError(f"{tag}: gradient {name} cosine {c} < 0.9")
    import torch

    names = sorted(want)
    a = torch.cat([got[n].flatten() for n in names])
    b = torch.cat([want[n].flatten() for n in names])
    rel = float((a - b).norm() / (b.norm() + 1e-30))
    if rel > total:
        raise AssertionError(f"{tag}: gradients relative error {rel} > {total}")
    err = float((a - b).abs().max())
    if dsrc is not None:
        err = max(err, float((dsrc[0] - dsrc[1]).abs().max()))
    log(f"  {tag}: gradients relative error {rel:.3g}, worst leaf cosine "
        f"{worst:.6f}" + (f", d(src) cosine {cos(*dsrc):.6f}" if dsrc is not None
                          else ""))
    return err, rel


def compare_knn(rep, tag, x, kk, time_it):
    """Kernel B4 against its plain version (and, timed, torch.cdist +
    torch.topk as the library yardstick) on channels-last x (B, N, C)."""
    import torch

    from svnet_tpu_torch.ops.kernels.knn import knn
    from svnet_tpu_torch.ops.knn import knn_plain

    ko, po = knn(x, kk), knn_plain(x, kk)
    sync(x.device)
    check_ids(tag, ko.transpose(1, 2), po.transpose(1, 2), x)
    if not time_it:
        rep.add("knn", 0.0)
        return po
    bb, nn, C = x.shape

    def library():
        return torch.topk(torch.cdist(x, x), kk, dim=-1, largest=False).indices

    ms, plain_ms, lib_ms = (cuda_ms(lambda: knn(x, kk)),
                            cuda_ms(lambda: knn_plain(x, kk)), cuda_ms(library))
    cost = bound(knn_flops(bb, nn, C), 4.0 * bb * nn * (C + kk))
    log(f"  {tag}: kernel {ms} ms, plain {plain_ms} ms, cdist+topk {lib_ms} ms, "
        f"bound {cost}")
    rep.add("knn", 0.0, ms, plain_ms, cost, lib_ms)
    return po


def compare_train(rep, tag, names, fwd, x, idx, kp, d, gen, time_it, total):
    """A training round's forward and backward passes (kernel wrappers
    ``fwd``/the matching bwd) against the plain versions on the same
    inputs; returns the plain forward's outputs."""
    import torch

    from svnet_tpu_torch.ops.kernels import sv_round3_train as kr

    fwd_k, bwd_k = fwd
    ko = fwd_k(x, idx, kp, d)
    po = kr.train_fwd_plain(x, idx, kp, d)
    sync(x.device)
    err = 0.0
    m = x.shape[1] * d.k  # the gate input is the mean over the N*k edges
    for label, g, w in (("s", ko[0], po[0]), ("v", ko[1], po[1]),
                        ("gate means", ko[2] / m, po[2] / m)):
        err = max(err, check_close(f"{tag} {label}", g, w))
    for label, g, w in zip(("mu1", "var1", "inv1", "mun", "varn", "invn"),
                           ko[3], po[3]):
        err = max(err, check_close(f"{tag} {label}", g, w))
    same = (ko[4] == po[4]).float().mean().item()
    if same < 0.9999:
        raise AssertionError(f"{tag}: argmax ranks agree on {same} < 0.9999")
    B_, N_, C = x.shape
    dso = torch.randn(B_, N_, d.S_out, generator=gen).to(x.device)
    dvo = torch.randn(B_, N_, 3 * d.V_out, generator=gen).to(x.device)
    dss = (torch.randn(B_, d.SX, generator=gen) / (N_ * d.k)).to(x.device)
    saved = (po[4], po[3][0], po[3][2], po[3][3], po[3][5])
    kd, kg = bwd_k(x, idx, kp, d, saved, dso, dvo, dss)
    pd, pg = kr.train_bwd_plain(x, idx, kp, d, saved, dso, dvo, dss)
    sync(x.device)
    berr, rel = check_grads(tag, kg, pg, total, (kd, pd))
    log(f"  {tag}: forward max abs err {err:.3g}, argmax ranks agree {same:.6f}")
    if not time_it:
        rep.add(names[0], err)
        rep.add(names[1], berr)
        return po
    E = B_ * N_ * d.k
    ef, pm1 = edge_flops(d.S, d.V, d.S_out, d.V_out, d.first, d.binary)
    # the backward's products take real cotangents: real-valued operations
    mm = 2.0 * d.IN1 * d.S_out + 2.0 * 3 * d.twoV * d.V_out
    fwd_cost = (E * ef, 4.0 * B_ * N_ * (C + d.k + 2 * d.S_out + 3 * d.V_out),
                E * pm1)
    bwd_cost = (E * (ef + 2 * mm),
                4.0 * B_ * N_ * (2 * C + d.k + 2 * d.S_out + 3 * d.V_out),
                E * pm1)
    t = [cuda_ms(lambda: fwd_k(x, idx, kp, d)),
         cuda_ms(lambda: kr.train_fwd_plain(x, idx, kp, d)),
         cuda_ms(lambda: bwd_k(x, idx, kp, d, saved, dso, dvo, dss)),
         cuda_ms(lambda: kr.train_bwd_plain(x, idx, kp, d, saved, dso, dvo, dss))]
    log(f"  {tag}: forward kernel {t[0]} ms, plain {t[1]} ms, bound "
        f"{bound(*fwd_cost)}; backward kernel {t[2]} ms, plain {t[3]} ms, bound "
        f"{bound(*bwd_cost)}")
    rep.add(names[0], err, t[0], t[1], bound(*fwd_cost))
    rep.add(names[1], berr, t[2], t[3], bound(*bwd_cost))
    return po


def phase2_train(rep, p_bin, p_fp, gen, dev, b=B_TRAIN, n=N, k=K, time_it=True,
                 rounds=("conv2", "conv3", "conv4")):
    """B4, B5 and B6 at the training shapes, inputs chained through the
    plain versions (binary model; FP rounds on the same inputs)."""
    import torch

    from svnet_tpu_torch.ops.kernels import sv_first_train as kf
    from svnet_tpu_torch.ops.kernels import sv_round3_train as kr
    from svnet_tpu_torch.ops.kernels.sv_round3 import first_perm
    from svnet_tpu_torch.train.fused import ROUNDS, SUB, _gate

    first_names = ("sv_first_train_fwd", "sv_first_train_bwd")
    round_names = ("sv_round3_train_fwd", "sv_round3_train_bwd")
    pts = cloud(b, n, gen, dev)
    idx = compare_knn(rep, f"knn B={b} N={n} C=3 k={k}", pts, k, time_it)
    d = kf.first_dims(32, 10, k)
    sub = {"init_scalar": p_bin["init_scalar"], **{m: p_bin["conv1"][m] for m in SUB}}
    po = compare_train(rep, f"sv_first_train B={b} N={n} k={k}", first_names,
                       (kf.sv_first_train_fwd, kf.sv_first_train_bwd), pts, idx,
                       kr.kernel_params(sub, d), d, gen, time_it, 1e-3)
    s_mean = (po[2] / (n * k)).float()[:, first_perm()]
    x = (po[0], po[1].reshape(b, n, 3, 10) * _gate(p_bin["conv1"], s_mean)[:, None, None, :])
    for name in rounds:
        S, V, So, Vo = ROUNDS[name]
        joint = torch.cat([x[0], x[1].reshape(b, n, -1)], dim=-1).contiguous()
        idx = compare_knn(rep, f"knn B={b} N={n} C={S + 3 * V} k={k} ({name})",
                          joint, k, time_it)
        ops = (kr.sv_round3_train_fwd, kr.sv_round3_train_bwd)
        for binary, p in ((True, p_bin), (False, p_fp)):
            d = kr.RoundDims(S, V, So, Vo, k, binary)
            out = compare_train(
                rep, f"sv_round3_train {name} {'binary' if binary else 'fp'} "
                f"B={b} N={n} k={k}", round_names, ops, joint, idx,
                kr.kernel_params({m: p[name][m] for m in SUB}, d), d, gen,
                time_it and binary, 1e-3)
            if binary:
                po = out
        s_mean = (po[2] / (n * k)).float()
        x = (po[0], po[1].reshape(b, n, 3, Vo) * _gate(p_bin[name], s_mean)[:, None, None, :])


def phase5(dev, gen, counters, log_card):
    """Train 1 + TRAIN_STEPS steps through train_epoch; returns the launch
    counts of the run, the median step ms and the state."""
    import numpy as np
    import torch

    from svnet_tpu_torch.data import ArrayDataset, Loader
    from svnet_tpu_torch.models.sv_dgcnn import SVDGCNNCls, init_params
    from svnet_tpu_torch.train.fused import make_fused_train_apply
    from svnet_tpu_torch.train.loop import bn_reestimate, train_epoch
    from svnet_tpu_torch.train.losses import cal_loss
    from svnet_tpu_torch.train.steps import (
        create_state,
        make_eval_step,
        make_recal_step,
        make_train_step,
    )
    from svnet_tpu_torch.utils.convert import load_tree
    from svnet_tpu_torch.utils.synth import surface_clouds

    steps = TRAIN_STEPS + 1
    clouds = surface_clouds(SEED, steps * B_TRAIN, N)
    labels = np.random.default_rng(SEED).integers(0, CLASSES, steps * B_TRAIN)
    loader = Loader(ArrayDataset(clouds, labels, train=True, seed=SEED), B_TRAIN,
                    shuffle=True, drop_last=True, seed=SEED, device=dev)
    weights = init_params(CLASSES, K, True, torch.Generator().manual_seed(SEED + 2))
    state = create_state(weights, binary=True, lr=1e-3, epochs=1,
                         steps_per_epoch=len(loader), device=dev)
    apply = make_fused_train_apply(CLASSES, K, binary=True)
    step = make_train_step(apply, cal_loss, rot="z")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in counters:
        fn.launches = 0
    out = train_epoch(state, step, loader, gen, lambda m: log("  " + m))
    launches = {fn.__name__: fn.launches for fn in counters}
    per_step = {"knn": 4, "sv_first_train_fwd": 1, "sv_first_train_bwd": 1,
                "sv_round3_train_fwd": 3, "sv_round3_train_bwd": 3}
    want = {name: per_step.get(name, 0) * steps for name in launches}
    if launches != want:
        raise AssertionError(f"phase 5: launches {launches} != {want}")
    if not np.isfinite(out["loss"]):
        raise AssertionError(f"phase 5: loss {out['loss']} not finite")
    timed = out["step_ms"][1:]
    median = float(np.median(timed))
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"phase 5: {steps} train steps of ({B_TRAIN}, {N}, 3), binary, Adam, "
        f"rot z; launches {launches}; loss {out['loss']:.6f}")
    log(f"phase 5: step time (CUDA events, ms) median of {len(timed)} "
        f"{median:.3f}, all {[round(t, 3) for t in timed]}; warm-up "
        f"{out['step_ms'][0]:.3f}; peak device memory {peak / 2**30:.3f} GiB | "
        f"{log_card}")

    for fn in counters:
        fn.launches = 0
    state.batch_stats = bn_reestimate(make_recal_step(apply, "z"), state, loader,
                                      gen, 1)
    recal = {fn.__name__: fn.launches for fn in counters}
    model = SVDGCNNCls(CLASSES, K, True).to(dev).eval()
    load_tree(model, state.tree())
    for fn in counters:
        fn.launches = 0
    loss, preds = make_eval_step(model, cal_loss, "so3")(next(iter(loader)), gen)
    evals = {fn.__name__: fn.launches for fn in counters}
    torch.cuda.synchronize()
    if not bool(torch.isfinite(loss)) or preds.shape != (B_TRAIN,):
        raise AssertionError(f"phase 5: eval loss {loss} / preds {preds.shape}")
    want_recal = {n: {"knn": 4, "sv_first_train_fwd": 1,
                      "sv_round3_train_fwd": 3}.get(n, 0) for n in recal}
    if recal != want_recal or evals["knn"] != 4:
        raise AssertionError(f"phase 5: recal launches {recal}, eval {evals}")
    log(f"phase 5: BN re-estimation batch launches {recal}; eval batch (eager "
        f"model) loss {loss.item():.6f}, knn launches {evals['knn']}")
    return launches, median, peak, loader


def phase6(dev, loader):
    """One train step through the kernels against the plain twin."""
    import torch

    from svnet_tpu_torch.models.sv_dgcnn import init_params
    from svnet_tpu_torch.train.fused import make_fused_train_apply
    from svnet_tpu_torch.train.losses import cal_loss
    from svnet_tpu_torch.train.steps import create_state, make_train_step, tree_map
    from svnet_tpu_torch.utils.convert import flatten as flat
    from svnet_tpu_torch.utils.convert import to_flax

    weights = init_params(CLASSES, K, True, torch.Generator().manual_seed(SEED + 3))
    batch = next(iter(loader))
    res = []
    for oracle in (False, True):
        state = create_state(weights, binary=True, lr=1e-3, epochs=1,
                             steps_per_epoch=1, device=dev)
        step = make_train_step(make_fused_train_apply(CLASSES, K, True, oracle=oracle),
                               cal_loss, rot="z")
        loss, _ = step(state, batch, torch.Generator().manual_seed(SEED + 4))
        res.append((loss.item(), tree_map(lambda t: t.grad, state.params),
                    state.batch_stats, tree_map(lambda t: t.detach(), state.params)))
    (lk, gk, sk, pk), (lp, gp, sp, pp) = res

    worst = max(float((flat(sk)[n] - w).norm() / (w.norm() + 1e-30))
                for n, w in flat(sp).items())
    w0 = flat(to_flax(weights["params"]))
    du = torch.cat([(v.cpu() - torch.from_numpy(w0[n])).flatten()
                    for n, v in sorted(flat(pk).items())])
    dw = torch.cat([(v.cpu() - torch.from_numpy(w0[n])).flatten()
                    for n, v in sorted(flat(pp).items())])
    c = cos(du, dw)
    log(f"phase 6: one step, kernels vs plain twin: loss {lk:.6f} vs {lp:.6f}; "
        f"BN running stats worst relative error {worst:.3g}; parameter update "
        f"cosine {c:.6f}")
    if abs(lk - lp) > 1e-4 * abs(lp):
        raise AssertionError(f"phase 6: loss {lk} vs plain {lp}")
    check_grads("phase 6 gradients", flat(gk), flat(gp), 1e-3)
    if worst > 1e-4:
        raise AssertionError(f"phase 6: BN running stats off by {worst}")
    if c < 0.999:
        raise AssertionError(f"phase 6: parameter update cosine {c} < 0.999")


def main() -> int:
    import torch

    # phase 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    if not (ROOT / "svnet_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: svnet_tpu_torch not found beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from svnet_tpu_torch import config
    from svnet_tpu_torch.infer import SVDGCNNClsEngine
    from svnet_tpu_torch.models.sv_dgcnn import init_params
    from svnet_tpu_torch.ops import rotations
    from svnet_tpu_torch.ops.kernels import _build
    from svnet_tpu_torch.ops.kernels import knn as kk
    from svnet_tpu_torch.ops.kernels import sv_first_train as kf
    from svnet_tpu_torch.ops.kernels import sv_point as kp
    from svnet_tpu_torch.ops.kernels import sv_round3 as kr
    from svnet_tpu_torch.ops.kernels import sv_round3_train as krt
    from svnet_tpu_torch.train.steps import tree_map

    dev = config.require_cuda("cuda")
    config.set_full_fp32()  # every oracle on the card runs in full f32
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[dev.index]
    log(f"phase 0: {torch.cuda.get_device_name(dev)} | {card} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    # phase 1
    t0 = time.perf_counter()
    _build.lib()
    log(f"phase 1: kernels built in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds} s) -> {_build.library_path().name}")

    gen = torch.Generator().manual_seed(SEED)
    w_bin = init_params(CLASSES, K, True, torch.Generator().manual_seed(SEED))
    w_fp = init_params(CLASSES, K, False,
                       torch.Generator().manual_seed(SEED + 1))
    eng = SVDGCNNClsEngine(w_bin, CLASSES, K, True, device=dev)
    eng_fp = SVDGCNNClsEngine(w_fp, CLASSES, K, False, device=dev)
    oracle = SVDGCNNClsEngine(w_bin, CLASSES, K, True, device=dev,
                              oracle=True)

    # phase 2
    log("phase 2: kernels vs plain versions")
    rep = Report()
    phase2(rep, eng, eng_fp, gen, dev)
    p_bin = tree_map(lambda t: t.to(dev), w_bin["params"])
    p_fp = tree_map(lambda t: t.to(dev), w_fp["params"])
    phase2_train(rep, p_bin, p_fp, gen, dev)
    phase2_train(rep, p_bin, p_fp, gen, dev, b=8, n=N - 24, k=7, time_it=False,
                 rounds=("conv2",))

    # phase 3
    counters = (kr.sv_round3_first, kr.sv_round3, kp.sv_point_block_cm, kk.knn,
                kf.sv_first_train_fwd, kf.sv_first_train_bwd,
                krt.sv_round3_train_fwd, krt.sv_round3_train_bwd)
    requests = [cloud(B, N, gen, dev) for _ in range(REQUESTS)]
    eng(requests[0])  # warm-up, outside the counted run
    torch.cuda.synchronize()
    for fn in counters:
        fn.launches = 0
    logits, lat = [], []
    for pts in requests:
        before = [fn.launches for fn in counters]
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = eng(pts)
        e1.record()
        torch.cuda.synchronize()
        lat.append(e0.elapsed_time(e1))
        per = [fn.launches - b0 for fn, b0 in zip(counters, before)]
        if per != [1, 3, 1, 0, 0, 0, 0, 0]:
            raise AssertionError(f"phase 3: launches per request {per} != "
                                 "[1, 3, 1] serving, 0 training")
        logits.append(out)
    launches = {fn.__name__: fn.launches for fn in counters}
    got = torch.cat(logits)
    if got.shape != (REQUESTS * B, CLASSES) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"phase 3: logits {tuple(got.shape)} not finite "
                             f"({REQUESTS * B}, {CLASSES})")
    want, plain_lat = [], []
    for pts in requests:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        want.append(oracle(pts))
        e1.record()
        torch.cuda.synchronize()
        plain_lat.append(e0.elapsed_time(e1))
    want = torch.cat(want)
    top1 = (got.argmax(1) == want.argmax(1)).float().mean().item()
    dmax = (got - want).abs().max().item()
    log(f"phase 3: {REQUESTS} requests of ({B}, {N}, 3); launches {launches}; "
        f"top-1 agreement with the plain engine {top1:.4f}; max |dlogit| "
        f"{dmax:.4g} (logit scale {want.abs().max().item():.4g})")
    log(f"phase 3: latency per request (CUDA events, ms) kernels "
        f"{[round(t, 3) for t in lat]} plain {[round(t, 3) for t in plain_lat]}"
        f" | {card}")
    if top1 < 0.99:
        raise AssertionError(f"phase 3: top-1 agreement {top1} < 0.99")

    # phase 4
    pts = cloud(16, N, gen, dev)
    rot = rotations.random_rotations(16, gen).to(dev)
    out = eng_fp(pts)
    out_r = eng_fp(rotations.rotate_points(pts, rot))
    err = (out_r - out).abs().max().item()
    log(f"phase 4: SO(3) invariance (FP engine, kernels): max |dlogit| "
        f"{err:.3g} (logit scale {out.abs().max().item():.3g})")
    if not torch.allclose(out_r, out, rtol=2e-2, atol=2e-3):
        raise AssertionError("phase 4: logits not rotation invariant")

    # phase 5
    train_launches, step_ms, peak, loader = phase5(dev, gen, counters, card)
    # each kernel's launches are those of the path that runs it
    launches.update({fn.__name__: train_launches[fn.__name__]
                     for fn in counters[3:]})

    # phase 6
    phase6(dev, loader)

    src_of = {"sv_round3_first": ("svnet_tpu_torch/csrc/sv_round3_first.cu",
                                  "svnet_tpu/ops/pallas/sv_round3.py:1462"),
              "sv_round3": ("svnet_tpu_torch/csrc/sv_round3.cu",
                            "svnet_tpu/ops/pallas/sv_round3.py:996"),
              "sv_point_block_cm": ("svnet_tpu_torch/csrc/sv_point.cu",
                                    "svnet_tpu/ops/pallas/sv_point.py:199"),
              "knn": ("svnet_tpu_torch/csrc/knn.cu",
                      "svnet_tpu/ops/pallas/knn.py:99"),
              "sv_first_train_fwd": ("svnet_tpu_torch/csrc/sv_first_train.cu",
                                     "svnet_tpu/ops/pallas/sv_first_train.py:442"),
              "sv_first_train_bwd": ("svnet_tpu_torch/csrc/sv_first_train.cu",
                                     "svnet_tpu/ops/pallas/sv_first_train.py:442"),
              "sv_round3_train_fwd": ("svnet_tpu_torch/csrc/sv_round3_train.cu",
                                      "svnet_tpu/ops/pallas/sv_round3_train.py:522"),
              "sv_round3_train_bwd": ("svnet_tpu_torch/csrc/sv_round3_train.cu",
                                      "svnet_tpu/ops/pallas/sv_round3_train.py:522")}
    kernels = []
    for name, (source, replaces) in src_of.items():
        times = rep.ms[name]
        lib = [t[3] for t in times if t[3] is not None]

        def mean(vals):
            return sum(vals) / len(vals)

        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": rep.err[name],
            # per launch, averaged over the main path's shapes of the kernel
            "ms": mean([t[0] for t in times]),
            "plain_ms": mean([t[1] for t in times]),
            "bound_ms": mean([t[2][0] for t in times]),
            "bound_by": max((t[2][1] for t in times),
                            key=[t[2][1] for t in times].count),
            "library_ms": mean(lib) if lib else None,
        })
    log(f"train step median {step_ms:.3f} ms (B={B_TRAIN}, N={N}, k={K}), peak "
        f"device memory {peak / 2**30:.3f} GiB")
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
