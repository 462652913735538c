"""Where the conv-round block kernels spend their time, stage by stage.

    python -m svnet_tpu_torch.utils.stage_split [--csrc DIR]

Needs the card and nvcc. Builds, beside the kernel library and never into
it (in ``build/stage_split/``), one copy of ``sv_rounds.cuh`` and
``sv_train.cuh`` from DIR (default: this package's ``csrc``) as they are
and one per stage with that stage's loop compiled out, and times each on
the same inputs (CUDA events, two
rounds in turns, the smaller reading kept). A stage's time is the whole
kernel's minus the kernel's without it; what the stages leave over
("rest") is barriers, tile set-up and the outputs. A stage removed leaves
its buffers unwritten, which changes no control flow that costs time.
(``clock64()`` marks after each barrier were tried first and misplaced
time between stages that share warps: the differences are what the card
saves without the stage.)

Runs the serving conv-round block (``sv_round_block_kernel``: B2, B10a,
B10b, B10c; binary, random ids and weights) at cls conv2 and conv4 and
partseg conv4, and B6's forward (F1 + F2) and backward (B1 + B2) passes
(``sv_train_kernel``) at conv4 of the training shape (B=32, N=1024,
k=20). Prints the card's name and power limit, then one JSON line per
kernel and shape. Knows this revision's kernels and the ones before them
(``--csrc`` of an older checkout).
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


def without(text: str, anchors) -> str:
    for a in anchors:
        if text.count(a) != 1:
            raise ValueError(f"anchor not found once: {a!r}")
        text = text.replace(a, "if (0) " + a)
    return text


def build_all(csrc: Path):
    """{variant: loaded library}; variant "" is the kernels as they are."""
    rounds = (csrc / "sv_rounds.cuh").read_text()
    train = (csrc / "sv_train.cuh").read_text()
    serve = SERVE_NEW if "RB_TP" in rounds else SERVE_OLD
    trn = TRAIN_NEW if "sv_mma.cuh" in train else TRAIN_OLD
    variants = {"": (rounds, train)}
    variants.update({f"serve:{n}": (without(rounds, a), train) for n, a in serve})
    variants.update({f"train:{n}": (rounds, without(train, a)) for n, a in trn})
    if STAGE.exists():
        shutil.rmtree(STAGE)
    jobs = {}
    for i, (name, (r, t)) in enumerate(variants.items()):
        d = STAGE / f"v{i}"
        d.mkdir(parents=True)
        (d / "sv_rounds.cuh").write_text(r)
        (d / "sv_train.cuh").write_text(t)
        (d / "stage.cu").write_text(LAUNCH)
        cmd = ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-fmad=false", "-shared",
               "-I", str(csrc), "-o", str(d / "lib.so"), str(d / "stage.cu")]
        jobs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (d, proc) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name or 'base'}:\n{out}\n{err}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.st_conv_block.argtypes = [I] + [P] * 14 + [I] * 8 + [P]
        lib.sv_round3_train_launch.argtypes = [I, P, P, P]
        lib.sv_round3_train_launch.restype = I
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


def split(times: dict, prefix: str, key=lambda t: t) -> dict:
    """Base time, each stage's saving and the rest, in ms."""
    base = key(times[""])
    out = {"kernel_ms": round(base, 3)}
    for name, t in times.items():
        if name.startswith(prefix):
            out[name[len(prefix):]] = round(base - key(t), 3)
    out["rest"] = round(base - sum(v for n, v in out.items() if n != "kernel_ms"), 3)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", type=Path, default=ROOT / "svnet_tpu_torch" / "csrc")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("stage_split: needs a CUDA device", file=sys.stderr)
        return 1
    from svnet_tpu_torch.models.sv_dgcnn import init_params
    from svnet_tpu_torch.ops.kernels import _build
    from svnet_tpu_torch.ops.kernels import sv_round3_train as kr
    from svnet_tpu_torch.train.fused import ROUNDS, SUB
    from svnet_tpu_torch.train.steps import tree_map

    libs = build_all(args.csrc.resolve())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    serve = [n for n in libs if n == "" or n.startswith("serve:")]
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
        stream = torch.cuda.current_stream().cuda_stream
        times = {}
        for _ in range(2):
            for name in serve:
                def call(lib=libs[name]):
                    err = lib.st_conv_block(
                        1, src.data_ptr(), ids.data_ptr(), *[t.data_ptr() for t in w],
                        *[o.data_ptr() for o in outs], B, N, S, V, So, Vo, k, 1, stream)
                    if err != 0:
                        raise RuntimeError(f"st_conv_block: error {err}")
                t = device_ms(call)
                times[name] = min(times.get(name, t), t)
        print(json.dumps({"kernel": "sv_round_block_kernel (binary)", "shape": tag,
                          "B": B, "N": N, "k": k,
                          "ms": split(times, "serve:")}), flush=True)

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
        for name in [n for n in libs if n == "" or n.startswith("train:")]:
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
                          "ms": split(times, "train:", key=lambda t, i=i: t[i])}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
