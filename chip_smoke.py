#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (svnet_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from svnet_tpu_torch/csrc and drives the
port's serving path -- binary SV-DGCNN classification, exact mode, at the
full model width (B=128, N=1024, k=20, 40 classes, seeded random
weights) -- through SVDGCNNClsEngine. Phases; any failure raises and the
script exits non-zero:

  0  a CUDA device is required; print the card's name and power limit
  1  build the kernels (nvcc), print the build time
  2  each kernel against its plain PyTorch version on the card, on the
     same inputs, at the main path's shapes (plus a ragged N=1000, k=7
     case): neighbour ids agree on >= 99.99% of (b, rank, n) and every
     mismatch is a near-tie (true distances within 1e-5 relative); on
     centre points whose neighbour sets agree, outputs agree within
     rtol=1e-4, atol=1e-5
  3  serve 5 requests; each launches sv_round3_first once, sv_round3
     three times and sv_point_block_cm once; logits finite, (128, 40);
     top-1 agrees with the plain-version engine on >= 99% of clouds
  4  SO(3) invariance through the kernels (FP model): logits of rotated
     and unrotated clouds within rtol=2e-2, atol=2e-3

The last two lines of output are one JSON object per kernel run
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
RTOL, ATOL = 1e-4, 1e-5
NEAR_TIE = 1e-5
REQUESTS = 5
SEED = 0


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
    """Per-kernel results of phase 2: largest compared error and times."""

    def __init__(self):
        self.err: dict[str, float] = {}
        self.ms: dict[str, list] = {}

    def add(self, name, err, ms=None, plain_ms=None):
        self.err[name] = max(self.err.get(name, 0.0), err)
        if ms is not None:
            self.ms.setdefault(name, []).append((ms, plain_ms))


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


def compare_round(rep, tag, name, kern, plain, feats, time_it):
    """Kernel outputs (s, v, gate stats, wins) against the plain version's."""
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
        f"of {agree.numel()} points; kernel {ms} ms, plain {plain_ms} ms")
    rep.add(name, err, ms, plain_ms)
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
        return compare_round(
            rep, tag, "sv_round3_first",
            lambda: kr.sv_round3_first(pts, f, emit_wins=True, **kw),
            lambda: kr.sv_round3_first_plain(pts, f, **kw), pts, time_it)

    def conv(src, e, name, kk, tag, time_it):
        S, V, S_out, V_out = ROUNDS[name]
        kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=kk, binary=e.binary)
        f = e.folded[name]
        return compare_round(
            rep, tag, "sv_round3",
            lambda: kr.sv_round3(src, f, emit_wins=True, **kw),
            lambda: kr.sv_round3_plain(src, f, **kw),
            src.transpose(1, 2), time_it)

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
        f"kernel {ms} ms, plain {plain_ms} ms")
    rep.add("sv_point_block_cm", err, ms, plain_ms)

    # ragged: N and k divide no tile
    n_r = n - 24
    pts = cloud(8, n_r, gen, dev)
    po = first(pts, 7, f"sv_round3_first ragged B=8 N={n_r} k=7", False)
    src = torch.cat([po[0], gated(eng.p["conv1"], po)], dim=1).contiguous()
    conv(src, eng, "conv2", 7, f"sv_round3 conv2 ragged B=8 N={n_r} k=7",
         False)


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
    from svnet_tpu_torch.ops.kernels import sv_point as kp
    from svnet_tpu_torch.ops.kernels import sv_round3 as kr

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

    # phase 3
    counters = (kr.sv_round3_first, kr.sv_round3, kp.sv_point_block_cm)
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
        if per != [1, 3, 1]:
            raise AssertionError(f"phase 3: launches per request {per} != [1, 3, 1]")
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

    src_of = {"sv_round3_first": ("svnet_tpu_torch/csrc/sv_round3_first.cu",
                                  "svnet_tpu/ops/pallas/sv_round3.py:1462"),
              "sv_round3": ("svnet_tpu_torch/csrc/sv_round3.cu",
                            "svnet_tpu/ops/pallas/sv_round3.py:996"),
              "sv_point_block_cm": ("svnet_tpu_torch/csrc/sv_point.cu",
                                    "svnet_tpu/ops/pallas/sv_point.py:199")}
    kernels = []
    for name, (source, replaces) in src_of.items():
        times = rep.ms[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": rep.err[name],
            # per launch, averaged over the main path's shapes of the kernel
            "ms": sum(t[0] for t in times) / len(times),
            "plain_ms": sum(t[1] for t in times) / len(times),
        })
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
