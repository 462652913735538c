"""Where the block kernels spend their time, stage by stage.

    python -m svnet_tpu_torch.utils.stage_split [--csrc DIR] [--kernels rounds,point,first]

Needs the card and nvcc. Builds, beside the kernel library and never into
it (in ``build/stage_split/``), one copy of a group's sources from DIR
(default: this package's ``csrc``) as they are and one per stage with
that stage's statement compiled out, and times each on the same inputs
(CUDA events, two rounds in turns, the smaller reading kept). A stage's
time is the whole kernel's minus the kernel's without it; what the stages
leave over ("rest") is barriers, tile set-up and the outputs. A stage
removed leaves its buffers unwritten, which changes no control flow that
costs time. (``clock64()`` marks after each barrier were tried first and
misplaced time between stages that share warps: the differences are what
the card saves without the stage.)

Three groups. ``rounds``: the serving conv-round block
(``sv_round_block_kernel``: B2, B10a, B10b, B10c; binary, random ids and
weights) at cls conv2 and conv4 and partseg conv4, and B6's forward (F1 +
F2) and backward (B1 + B2) passes (``sv_train_kernel``) at conv4 of the
training shape (B=32, N=1024, k=20). ``point``: the per-point blocks,
binary, random weights: B8 (``sv_block_point_launch``) at the SV-PointNet
classifier's conv_fuse and conv3 (B=128, N=1024) and the part segmenter's
conv5 (B=32, N=2048); B3 (``sv_point_launch``, channel-major) and B3r
(``sv_point_rm_launch``) at SV-DGCNN cls conv5 (B=128, N=1024).
``first``: the first-round block (``sv_first_block``: B1, B1 cross, B10a
and B10b first, B10d) on random ids at B10d's cls shape (row-major, two
edge channels), B1's and B1 cross's (channel-major, two and three) and
partseg's (V_out = 16; cross at N = 2048, k = 40); it also prints, per
instantiation, the registers and spill bytes ``nvcc -Xptxas -v`` reports
for sv_round3_first.cu and sv_edge.cu. Where a register-resident stage is
compiled out, a cheap stand-in keeps its consumers alive (otherwise the
compiler drops them with it). Prints the card's name and power limit,
then one JSON line per kernel and shape.
Knows this revision's kernels and the ones before them (``--csrc`` of an
older checkout).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
STAGE = ROOT / "build" / "stage_split"

FIRST_LAUNCH = r"""#include "sv_rounds.cuh"
extern "C" int st_first_block(int row, const float* pts, const int* ids,
    const float* wz0, const float* wz1, const float* w1, const float* a1,
    const float* b1, const float* w2, const float* a2, const float* b2,
    float* s_out, float* v_out, float* ssum, int B, int N, int k, int V_out,
    int cross, void* st) {
  if (row)
    return sv_first_block<true>(pts, ids, wz0, wz1, w1, a1, b1, w2, a2, b2, s_out,
        v_out, ssum, B, N, k, 32, V_out, cross, (cudaStream_t)st);
  return sv_first_block<false>(pts, ids, wz0, wz1, w1, a1, b1, w2, a2, b2, s_out,
      v_out, ssum, B, N, k, 32, V_out, cross, (cudaStream_t)st);
}
"""

LAUNCH = r"""#include "sv_rounds.cuh"
#include "sv_train.cuh"
extern "C" int st_conv_block(int row, const float* src, const int* wins,
    const float* wz, const float* w1, const float* beta, const float* a1,
    const float* b1, const float* w2, const float* scale2, const float* a2,
    const float* b2, float* s_out, float* v_out, float* ssum, int B, int N,
    int S, int V, int S_out, int V_out, int k, int binary, void* st) {
  if (row)
    return sv_conv_block<true, false>(src, wins, nullptr, wz, w1, beta, a1, b1, w2, scale2,
        a2, b2, s_out, v_out, ssum, B, N, S, V, S_out, V_out, k, binary, (cudaStream_t)st);
  return sv_conv_block<false, false>(src, wins, nullptr, wz, w1, beta, a1, b1, w2, scale2,
      a2, b2, s_out, v_out, ssum, B, N, S, V, S_out, V_out, k, binary, (cudaStream_t)st);
}
extern "C" int sv_round3_train_launch(int phase, void* const* ptrs, const int* dims,
                                      void* stream) {
  return tr_run(phase, ptrs, dims, 0, stream);
}
"""

# (stage, statements compiled out): each anchor starts a statement (a loop
# or a call) that ``if (0)`` removes. "R3" and "TR_E" mark the blocks of
# the revisions before the tensor-core redesign.
SERVE_OLD = [
    ("gather", ["for (int i = tid; i < R3_E * C; i += nth) {"]),
    ("gate statistics", ["for (int i = tid; i < R3_TP * 2 * S; i += nth) {\n        const int t"]),
    ("frames", ["for (int i = tid; i < R3_E * 9; i += nth) {"]),
    ("invariants", ["for (int i = tid; i < R3_E * 3 * twoV; i += nth) {"]),
    ("sign", ["for (int i = tid; i < R3_E * IN1; i += nth)\n        X[i] = sv_sign"]),
    ("linear1", ["sv_block_gemm<4, 4>(X, IN1, R3_E, w1,"]),
    ("vector path", ["for (int i = tid; i < R3_TP * V_out; i += nth) {"]),
    ("pooling", ["for (int i = tid; i < R3_TP * S_out; i += nth) {\n      const int t = i / S_out, o = i % S_out;\n      float m"]),
]
SERVE_NEW = [
    ("gather and sign, gate statistics", ["for (int p0 = warp; p0 < npair; p0 += RB_GP * nwarp) {"]),
    ("frames", ["for (int i = tid; i < RB_E * 9; i += nth) {"]),
    ("invariants and sign", ["for (int e = warp; e < RB_E; e += nwarp) {"]),
    ("linear1 and pooling (tensor cores)", ["for (int job = tid >> 5; job < njobs; job += nth >> 5) {"]),
    ("vector path", ["for (int item = nth - 1 - tid; item < RB_TP * vg; item += nth) {"]),
]
TRAIN_OLD = [
    ("gather", ["for (int i = tid; i < TR_E * C; i += nth) {\n        const int e = i / C, c = i % C, row = rows[e];\n        const float cv"]),
    ("frames", ["for (int i = tid; i < TR_E * 9; i += nth) {\n        const int e = i / 9, i3 = (i % 9) / 3, j = i % 3;\n        const float* ve = VE + ((size_t)e * 3 + i3) * twoV;\n        float z = 0.f;"]),
    ("invariants", ["for (int i = tid; i < TR_E * 3 * twoV; i += nth) {\n        const int e = i / (3 * twoV), j"]),
    ("sign", ["for (int i = tid; i < TR_E * IN1; i += nth)\n          XQ[i] = sv_sign"]),
    ("h = linear1", ["tr_gemm<2, 4>(TR_E, IN1, S_out,"]),
    ("v2 = linear2", ["tr_gemm<2, 2>(TR_E * 3, twoV, V_out,"]),
    ("B2 BN backward per edge", ["for (int i = tid; i < TR_E * S_out; i += nth) {\n          const int e = i / S_out, o = i % S_out;\n          float dh = 0.f;"]),
    ("B2 d(x)", ["tr_gemm<2, 4>(TR_E, S_out, IN1,"]),
    ("B2 dW1", ["tr_gemm<4, 4>(IN1, TR_E, S_out,"]),
    ("B2 d(v_e)", ["tr_gemm<2, 2>(TR_E * 3, V_out, twoV,"]),
    ("B2 dW2", ["tr_gemm<2, 2>(twoV, TR_E * 3, V_out,"]),
]
TRAIN_NEW = [
    ("gather and sign", ["for (int i0 = tid; i0 < EC * C; i0 += 4 * nth) {"]),
    ("frames", ["for (int i = tid; i < EC * 9; i += nth) {\n        const int e = i / 9, i3 = (i % 9) / 3, j = i % 3;\n        const float* ve = VE + ((size_t)e * 3 + i3) * twoV;\n        float z = 0.f;"]),
    ("invariants and sign", ["for (int i = tid; i < EC * 3 * twoV; i += nth) {\n        const int e = i / (3 * twoV), jc"]),
    ("h = linear1 (tensor cores)", ["for (int job = tid >> 5; job < (EC / 16) * (So16 / 16); job += nth >> 5) {"]),
    ("v2 = linear2", ["tr_gemm<4, 2>(EC * 3, twoV, V_out,"]),
    ("B2 BN backward per edge", ["for (int i = tid; i < EC * S_out; i += nth) {\n          const int e = i / S_out, o = i % S_out;\n          float dh = 0.f;"]),
    ("B2 d(x) (tensor cores)", ["for (int job = tid >> 5; job < (EC / 16) * (K16 / 16); job += nth >> 5) {"]),
    ("B2 dW1 (tensor cores)", ["for (int job = tid >> 5; (buf == NBUF - 1 || r0 + TR_G >= k) &&"]),
    ("B2 d(v_e)", ["tr_gemm<2, 2>(EC * 3, V_out, twoV,"]),
    ("B2 dW2", ["tr_gemm<2, 2>(twoV, EC * 3, V_out,"]),
]


# The first-round block before its redesign: one thread per centre, all in
# registers. An anchor may come as (anchor, stand-in): the stand-in goes in
# front of "if (0) anchor" and keeps what the stage fed alive (a loop
# first where "#pragma unroll" precedes the anchor).
_NOOP = "for (int q = 0; q < 0; ++q) {}\n    "
FIRST_OLD = [
    ("gather (ids, neighbour coordinates, edge)",
     [("nb[i] = coord(row, i);", "nb[i] = ctr[i] * (float)(r + i); ")]),
    ("frames and invariants",
     [("for (int h = 0; h < 2; ++h) {\n      const float* wz",
       "for (int q = 0; q < NX; ++q) xc[q] = ve[q % 3][q % NCH];\n    ")]),
    ("linear1, BN, leaky and the running max",
     [("for (int o = 0; o < F_S_OUT; ++o) {\n      float h = 0.f;",
       "for (int q = 0; q < NX; ++q) sacc[q] = fmaxf(sacc[q], xc[q]);\n    ")]),
    ("linear2, VectorBN and the vector sums",
     [("for (int o = 0; o < VO; ++o) {\n      float wl[3];", _NOOP)]),
    ("ss sums", [("for (int j = 0; j < NSS; ++j) ss[j] += xc[j];", _NOOP)]),
    ("writes", [("if (valid) {\n    const float inv_k",
                 "if (valid) {\n    float t = 0.f;\n#pragma unroll\n"
                 "    for (int o = 0; o < F_S_OUT; ++o) t += sacc[o];\n#pragma unroll\n"
                 "    for (int i = 0; i < 3 * VO; ++i) t += vacc[i / VO][i % VO];\n"
                 "#pragma unroll\n    for (int j = 0; j < NSS; ++j) t += ss[j];\n"
                 "    s_out[(size_t)b * N + n] = t;\n  }\n  ")]),
]
# The redesigned block: three phases over shared memory (sv_rounds.cuh)
FIRST_NEW = [
    ("gather and the edge", ["{  // gather: the next chunk's neighbour",
                             "{  // the edge's vectors"]),
    ("frames and invariants", ["{  // frames and invariants"]),
    ("linear1, BN, leaky and the running max", ["for (int gg = 0; gg < g; ++gg) {  // linear1"]),
    ("linear2, VectorBN and the vector sums", ["for (int gg = 0; gg < g; ++gg) {  // linear2"]),
    ("ss sums", ["if (g1 == 0)  // ss sums"]),
    ("writes", ["{  // writes, coalesced"]),
]

# The per-point blocks before the tensor-core redesign (sv_block_point.cu
# and sv_point.cu alone; since then the FP mode's kernels)
B8_OLD = [
    ("staging", ["for (int i = tid; i < np * IN; i += nth) {\n    const int p = i / IN, ch = i % IN;"]),
    ("frames", ["for (int i = tid; i < np * 9; i += nth) {"]),
    ("invariants", ["for (int i = tid; i < np * V3; i += nth) {"]),
    ("sign", ["for (int i = tid; i < np * IN; i += nth)\n      X[i] = sv_sign"]),
    ("linear1, BN, leaky and s writes", ["sv_block_gemm<4, 4>(X, IN, np, w1,"]),
    ("linear2", ["sv_block_gemm<4, 4>(VV, V, 3 * np, w2,"]),
    ("VectorBN, gate and v writes", ["for (int i = tid; i < np * V_out; i += nth) {"]),
]
# The shared per-point tile routine (sv_point_tile.cuh) of B8, B3 and B3r;
# the FUSE stages save nothing in B8
TILE_NEW = [
    ("vector chunks (cp.async)", ["stage(0, 0);", "if (ch + 1 < nch) stage("]),
    ("frames", ["if (frame)  // z_i[j]"]),
    ("linear2", ["if (active)  // linear2"]),
    ("VectorBN and gate", ["if (active)\n#pragma unroll"]),
    ("v writes (B8)", ["for (int e = tid; e < np * V3o; e += nth) vo[e]"]),
    ("SVFuse frame", ["if (tid < 3 * P) {"]),
    ("SVFuse invariants and x writes (vectors)", ["for (int e = tid; e < P * V3o; e += nth) {"]),
    ("vector sums", ["for (int e = tid; e < MT * V3o; e += nth) {"]),
    ("W1 ring (cp.async)", ["if (s < nk) load_w(s, s);", "if (kc + PT_NST - 1 < nk) load_w("]),
    ("operand (signs)", ["for (int e0 = tid; e0 < nA; e0 += PT_U * nth) {"]),
    ("linear1 (tensor cores)", ["if (busy) {\n      const sv_bf16* st"]),
    ("BN, leaky, s or x writes, maxima", ["if (busy)\n#pragma unroll"]),
]
B3_OLD = [
    ("staging", ["if constexpr (ROW) {  // [s | v i-major] rows of Cin channels"]),
    ("frames", ["for (int i = tid; i < PT_P * 9; i += nth) {\n    const int p = i / 9, i3 = (i % 9) / 3, j = i % 3;\n    const float* v = VV"]),
    ("invariants", ["for (int i = tid; i < PT_P * 3 * V; i += nth) {\n    const int p = i / (3 * V), j"]),
    ("sign", ["for (int i = tid; i < PT_P * IN; i += nth)\n      X[i] = sv_sign"]),
    ("linear1, BN and leaky", ["sv_block_gemm<4, 4>(X, IN, PT_P, w1,"]),
    ("linear2", ["sv_block_gemm<4, 4>(VV, V, 3 * PT_P, w2,"]),
    ("VectorBN and gate", ["for (int i = tid; i < PT_P * V_out; i += nth) {"]),
    ("SVFuse frame", ["for (int i = tid; i < PT_P * 9; i += nth) {\n    const int p = i / 9, i3 = (i % 9) / 3, j = i % 3;\n    const float* v = WL"]),
    ("x writes (scalars)", ["for (int i = tid; i < PT_P * S_out; i += nth) {"]),
    ("SVFuse invariants and x writes (vectors)", ["for (int i = tid; i < PT_P * 3 * V_out; i += nth) {"]),
    ("pooling", ["for (int o = tid; o < S_out; o += nth) {", "for (int q = tid; q < 3 * V_out; q += nth) {"]),
]


def without(text: str, anchors) -> str:
    for a in anchors:
        a, standin = a if isinstance(a, tuple) else (a, "")
        if text.count(a) != 1:
            raise ValueError(f"anchor not found once: {a!r}")
        text = text.replace(a, standin + "if (0) " + a)
    return text


def first_stages(rounds: str) -> list:
    """The first-round block's stages of the revision whose sv_rounds.cuh
    is ``rounds``."""
    return FIRST_NEW if "FB_TP" in rounds else FIRST_OLD


def point_stages(csrc: Path) -> list:
    """(variant prefix, file, stages) of the per-point blocks of the
    revision in csrc: the shared tile routine's stages when it has one,
    else each kernel's own."""
    if (csrc / "sv_point_tile.cuh").exists():
        return [("tile:", "sv_point_tile.cuh", TILE_NEW)]
    return [("b8:", "sv_block_point.cu", B8_OLD), ("b3:", "sv_point.cu", B3_OLD)]


def variants(csrc: Path, groups) -> dict:
    """{variant: (group, {file: text})}; variants "rounds" and "point" are
    their group's kernels as they are."""
    out = {}
    if "rounds" in groups:
        rounds = (csrc / "sv_rounds.cuh").read_text()
        train = (csrc / "sv_train.cuh").read_text()
        serve = SERVE_NEW if "RB_TP" in rounds else SERVE_OLD
        trn = TRAIN_NEW if "sv_mma.cuh" in train else TRAIN_OLD
        base = {"sv_rounds.cuh": rounds, "sv_train.cuh": train, "stage.cu": LAUNCH}
        out["rounds"] = ("rounds", base)
        out.update({f"serve:{n}": ("rounds", {**base, "sv_rounds.cuh": without(rounds, a)})
                    for n, a in serve})
        out.update({f"train:{n}": ("rounds", {**base, "sv_train.cuh": without(train, a)})
                    for n, a in trn})
    if "first" in groups:
        rounds = (csrc / "sv_rounds.cuh").read_text()
        base = {"sv_rounds.cuh": rounds, "stage.cu": FIRST_LAUNCH}
        out["first"] = ("first", base)
        out.update({f"first:{n}": ("first", {**base, "sv_rounds.cuh": without(rounds, a)})
                    for n, a in first_stages(rounds)})
    if "point" in groups:
        names = ["sv_block_point.cu", "sv_point.cu", "sv_point_tile.cuh"]
        base = {n: (csrc / n).read_text() for n in names if (csrc / n).exists()}
        out["point"] = ("point", base)
        for prefix, name, stages in point_stages(csrc):
            out.update({f"{prefix}{n}": ("point", {**base, name: without(base[name], a)})
                        for n, a in stages})
    return out


def build_all(csrc: Path, groups=("rounds", "point", "first")):
    """{variant: loaded library}, every variant built by its own nvcc,
    all started together."""
    if STAGE.exists():
        shutil.rmtree(STAGE)
    jobs = {}
    for i, (name, (group, files)) in enumerate(variants(csrc, groups).items()):
        d = STAGE / f"v{i}"
        d.mkdir(parents=True)
        for fname, text in files.items():
            (d / fname).write_text(text)
        srcs = (["sv_block_point.cu", "sv_point.cu"] if group == "point"
                else ["stage.cu"])
        cmd = ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-fmad=false", "-shared",
               "-I", str(csrc), "-o", str(d / "lib.so"), *[str(d / s) for s in srcs]]
        jobs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (d, proc) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}\n{err}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        P, I = ctypes.c_void_p, ctypes.c_int
        if hasattr(lib, "st_conv_block"):
            lib.st_conv_block.argtypes = [I] + [P] * 14 + [I] * 8 + [P]
            lib.sv_round3_train_launch.argtypes = [I, P, P, P]
            lib.sv_round3_train_launch.restype = I
        if hasattr(lib, "st_first_block"):
            lib.st_first_block.argtypes = [I] + [P] * 13 + [I] * 5 + [P]
        libs[name] = lib
    return libs


def device_ms(fn, reps=3) -> float:
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def split(times: dict, base: str, prefix: str, key=lambda t: t) -> dict:
    """Base time, each stage's saving and the rest, in ms."""
    whole = key(times[base])
    out = {"kernel_ms": round(whole, 3)}
    for name, t in times.items():
        if name.startswith(prefix):
            out[name[len(prefix):]] = round(whole - key(t), 3)
    out["rest"] = round(whole - sum(v for n, v in out.items() if n != "kernel_ms"), 3)
    return out


def timed(libs: dict, names, call) -> dict:
    """{variant: least ms of call(lib)} over two rounds in turns."""
    times = {}
    for _ in range(2):
        for name in names:
            t = device_ms(lambda lib=libs[name]: call(lib))
            times[name] = min(times.get(name, t), t)
    return times


def run_rounds(libs: dict, dev, gen, rnd):
    from svnet_tpu_torch.models.sv_dgcnn import init_params
    from svnet_tpu_torch.ops.kernels import _build
    from svnet_tpu_torch.ops.kernels import sv_round3_train as kr
    from svnet_tpu_torch.train.fused import ROUNDS, SUB
    from svnet_tpu_torch.train.steps import tree_map

    serve = [n for n in libs if n == "rounds" or n.startswith("serve:")]
    stream = torch.cuda.current_stream().cuda_stream
    for tag, (B, N, k, S, V, So, Vo) in (
            ("cls conv2", (128, 1024, 20, 32, 10, 32, 10)),
            ("cls conv4", (128, 1024, 20, 64, 21, 128, 42)),
            ("partseg conv4", (32, 2048, 40, 64, 24, 128, 40))):
        C, IN1 = S + 3 * V, 2 * S + 6 * V
        src = rnd(B, N, C)
        ids = torch.randint(0, N, (B, N, k), generator=gen, dtype=torch.int32).to(dev)
        w = [rnd(2 * V, 3), torch.sign(rnd(IN1, So)), 0.3 * rnd(1, IN1), rnd(1, So),
             rnd(1, So), torch.sign(rnd(2 * V, Vo)), rnd(1, Vo).abs(), rnd(1, Vo),
             rnd(1, Vo)]
        outs = [torch.empty(B * N * n, device=dev) for n in (So, 3 * Vo, 2 * S)]

        def call(lib):
            err = lib.st_conv_block(
                1, src.data_ptr(), ids.data_ptr(), *[t.data_ptr() for t in w],
                *[o.data_ptr() for o in outs], B, N, S, V, So, Vo, k, 1, stream)
            if err != 0:
                raise RuntimeError(f"st_conv_block: error {err}")
        print(json.dumps({"kernel": "sv_round_block_kernel (binary)", "shape": tag,
                          "B": B, "N": N, "k": k,
                          "ms": split(timed(libs, serve, call), "rounds", "serve:")}),
              flush=True)

    B, N, k = 32, 1024, 20
    S, V, So, Vo = ROUNDS["conv4"]
    p = tree_map(lambda t: t.to(dev), init_params(40, k, True, gen)["params"]["conv4"])
    d = kr.RoundDims(S, V, So, Vo, k, True)
    kp = kr.kernel_params({m: p[m] for m in SUB}, d)
    x = rnd(B, N, S + 3 * V)
    idx = torch.randint(0, N, (B, N, k), generator=gen, dtype=torch.int32).to(dev)
    dso, dvo, dss = rnd(B, N, So), rnd(B, N, 3 * Vo), rnd(B, d.SX) * 1e-3
    sym = "sv_round3_train_launch"
    times = {}
    for _ in range(2):
        for name in [n for n in libs if n == "rounds" or n.startswith("train:")]:
            _build.lib = lambda lib=libs[name]: lib  # the wrappers look up their entry here
            out = kr.train_fwd_kernel(sym, x, idx, kp, d)
            saved = (out[4], out[3][0], out[3][2], out[3][3], out[3][5])
            f = device_ms(lambda: kr.train_fwd_kernel(sym, x, idx, kp, d))
            b = device_ms(lambda: kr.train_bwd_kernel(sym, x, idx, kp, d, saved, dso,
                                                      dvo, dss))
            old = times.get(name, (f, b))
            times[name] = (min(old[0], f), min(old[1], b))
    for i, label in enumerate(("forward (F1 + F2)", "backward (B1 + B2)")):
        print(json.dumps({"kernel": f"sv_train_kernel {label} (binary)",
                          "shape": "train conv4", "B": B, "N": N, "k": k,
                          "ms": split(times, "rounds", "train:",
                                      key=lambda t, i=i: t[i])}),
              flush=True)


# (label, kernel, B, N, S, V, S_out, V_out) of the per-point blocks' splits
POINT_SHAPES = (
    ("cls conv_fuse", "B8", 128, 1024, 1024, 340, 512, 170),
    ("cls conv3", "B8", 128, 1024, 64, 21, 512, 170),
    ("partseg conv5", "B8", 32, 2048, 256, 85, 1024, 341),
    ("cls conv5", "B3", 128, 1024, 256, 83, 512, 170),
    ("cls conv5", "B3r", 128, 1024, 256, 83, 512, 170),
)


def run_point(libs: dict, csrc: Path, dev, gen, rnd):
    """B8, B3 and B3r, binary, on every point variant. A revision with the
    shared tile routine takes W1's signs packed once (its launch functions
    have the packed operand after w1)."""
    from svnet_tpu_torch.infer import POINT_V_OFF
    from svnet_tpu_torch.ops.kernels.sv_point import vector_rows

    packed = (csrc / "sv_point_tile.cuh").exists()
    prefixes = [prefix for prefix, _, _ in point_stages(csrc)]
    stream = torch.cuda.current_stream().cuda_stream
    P, I = ctypes.c_void_p, ctypes.c_int
    for lib in (lib for n, lib in libs.items() if n == "point" or n.startswith(tuple(prefixes))):
        lib.sv_block_point_launch.argtypes = [P] * (13 + packed) + [I] * 7 + [P]
        lib.sv_point_launch.argtypes = [P] * (16 + packed) + [I] * 7 + [P]
        lib.sv_point_rm_launch.argtypes = [P] * (15 + packed) + [I] * 7 + [P]
        if packed:
            lib.sv_pack_bytes.argtypes = [I, I]
            lib.sv_pack_signs_launch.argtypes = [P, P, I, I, P]
    for tag, kern, B, N, S, V, So, Vo in POINT_SHAPES:
        Cin = S + 3 * V
        src = rnd(B, N, Cin) if kern != "B3" else rnd(B, Cin, N)
        gate = torch.rand(B, Vo, generator=gen).to(dev)
        w1 = torch.sign(rnd(Cin, So))
        w = [0.1 * rnd(V, 3), w1, 0.3 * rnd(1, Cin), rnd(1, So), rnd(1, So),
             torch.sign(rnd(V, Vo)), rnd(1, Vo).abs() + 0.1, rnd(1, Vo), rnd(1, Vo)]
        if kern != "B8":
            w.append(rnd(Vo, 3))
        nblk = (N + 15) // 16
        if kern == "B8":
            outs = [torch.empty(B, N, So, device=dev), torch.empty(B, N, 3 * Vo, device=dev)]
        else:
            outs = [torch.empty(B, N * (So + 3 * Vo), device=dev),
                    torch.empty(B, nblk, So, device=dev),
                    torch.empty(B, nblk, 3 * Vo, device=dev)]
        vrow = torch.tensor(vector_rows(POINT_V_OFF, S, V) if kern == "B3" else [0],
                            dtype=torch.int32, device=dev)
        packs = {}  # W1's signs, packed once by each variant's library

        def call(lib):
            ws = [t.data_ptr() for t in w]
            if packed:
                if id(lib) not in packs:
                    out = torch.empty(lib.sv_pack_bytes(Cin, So), dtype=torch.int8, device=dev)
                    err = lib.sv_pack_signs_launch(w1.data_ptr(), out.data_ptr(), Cin, So, stream)
                    if err != 0:
                        raise RuntimeError(f"sv_pack_signs_launch: error {err}")
                    packs[id(lib)] = out
                ws.insert(2, packs[id(lib)].data_ptr())
            dims = (B, N, S, V, So, Vo, 1, stream)
            ptrs = [t.data_ptr() for t in outs]
            if kern == "B8":
                err = lib.sv_block_point_launch(src.data_ptr(), gate.data_ptr(), *ws,
                                                *ptrs, *dims)
            elif kern == "B3":
                err = lib.sv_point_launch(src.data_ptr(), gate.data_ptr(), vrow.data_ptr(),
                                          *ws, *ptrs, *dims)
            else:
                err = lib.sv_point_rm_launch(src.data_ptr(), gate.data_ptr(), *ws,
                                             *ptrs, *dims)
            if err != 0:
                raise RuntimeError(f"{kern}: error {err}")
        # the tile routine's stages serve every kernel, the old ones their own
        prefix = "tile:" if packed else ("b8:" if kern == "B8" else "b3:")
        names = ["point"] + [n for n in libs if n.startswith(prefix)]
        print(json.dumps({"kernel": f"{kern} (binary)", "shape": tag, "B": B, "N": N,
                          "ms": split(timed(libs, names, call), "point", prefix)}),
              flush=True)


def ptxas_report(csrc: Path) -> list:
    """[{file, function, registers, spill_stores, spill_loads}] of each
    first-block instantiation in sv_round3_first.cu and sv_edge.cu, from
    ``nvcc -Xptxas -v`` with the kernel library's flags."""
    import re

    from svnet_tpu_torch.ops.kernels._build import NVCC_FLAGS

    STAGE.mkdir(parents=True, exist_ok=True)
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    rows = []
    for f in ("sv_round3_first.cu", "sv_edge.cu"):
        res = subprocess.run(
            ["/usr/local/cuda/bin/nvcc", *NVCC_FLAGS, "-Xptxas", "-v", "-c",
             "-o", str(STAGE / "ptxas.o"), str(csrc / f)],
            capture_output=True, text=True, check=True)
        fn = None
        for line in res.stderr.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
                rows.append({"file": f, "function": fn})
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and fn:
                rows[-1].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                rows[-1]["registers"] = int(m.group(1))
    rows = [r for r in rows if "first_block" in r["function"]]
    if Path(filt).exists():
        names = subprocess.run([filt], input="\n".join(r["function"] for r in rows),
                               capture_output=True, text=True).stdout.splitlines()
        for r, name in zip(rows, names):  # drop the parameter list
            r["function"] = name[:name.index(">(") + 1] if ">(" in name else name
    return rows


# (label, row-major, cross, B, N, k, V_out) of the first block's splits
FIRST_SHAPES = (
    ("B10d cls", 1, 0, 128, 1024, 20, 10),
    ("B1 cls", 0, 0, 128, 1024, 20, 10),
    ("B1 cross cls", 0, 1, 128, 1024, 20, 10),
    ("B1 partseg (V_out=16)", 0, 0, 32, 2048, 40, 16),
    ("B1 cross partseg", 0, 1, 32, 2048, 40, 10),
)


def run_first(libs: dict, csrc: Path, dev, gen, rnd):
    """The first-round block on random ids, every first variant."""
    for r in ptxas_report(csrc):
        print(json.dumps({"ptxas": r}), flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    names = [n for n in libs if n == "first" or n.startswith("first:")]
    for tag, row, cross, B, N, k, Vo in FIRST_SHAPES:
        nch = 3 if cross else 2
        pts = rnd(B, N, 3) if row else rnd(B, 3, N)
        ids = torch.randint(0, N, (B, N, k) if row else (B, k, N), generator=gen,
                            dtype=torch.int32).to(dev)
        w = [0.5 * rnd(nch, 3), 0.5 * rnd(nch, 3), rnd(6 * nch, 32), rnd(1, 32),
             rnd(1, 32), rnd(nch, Vo), rnd(1, Vo).abs(), rnd(1, Vo)]
        outs = [torch.empty(B * N * n, device=dev) for n in (32, 3 * Vo, 3 * nch)]

        def call(lib):
            err = lib.st_first_block(row, pts.data_ptr(), ids.data_ptr(),
                                     *[t.data_ptr() for t in w],
                                     *[o.data_ptr() for o in outs], B, N, k, Vo,
                                     cross, stream)
            if err != 0:
                raise RuntimeError(f"st_first_block: error {err}")
        print(json.dumps({"kernel": "sv_first_block", "shape": tag, "B": B, "N": N,
                          "k": k, "ms": split(timed(libs, names, call), "first",
                                              "first:")}),
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", type=Path, default=ROOT / "svnet_tpu_torch" / "csrc")
    ap.add_argument("--kernels", default="rounds,point,first",
                    help="comma-separated groups: rounds, point, first")
    args = ap.parse_args(argv)
    groups = args.kernels.split(",")
    if not set(groups) <= {"rounds", "point", "first"}:
        ap.error(f"--kernels: unknown group in {args.kernels!r}")
    if not torch.cuda.is_available():
        print("stage_split: needs a CUDA device", file=sys.stderr)
        return 1
    csrc = args.csrc.resolve()
    libs = build_all(csrc, groups)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    if "point" in groups:
        run_point(libs, csrc, dev, gen, rnd)
    if "rounds" in groups:
        run_rounds(libs, dev, gen, rnd)
    if "first" in groups:
        run_first(libs, csrc, dev, gen, rnd)
    return 0


if __name__ == "__main__":
    sys.exit(main())
