"""Bench: the XNOR-popcount +-1 product (kernel B9) against the library's
int8 and bf16 products (counterpart of
svnet_tpu/utils/bench_binary_matmul.py).

    python -m svnet_tpu_torch.utils.bench_binary_matmul [M K N] [--device cpu]
    python -m svnet_tpu_torch.utils.bench_binary_matmul --rates

Seeded zero-free +-1 operands x (M, K) and w (K, N), default (4096, 2048,
512): the shapes of the JAX bench, the head's largest binary product
batched over rows. Checks that the kernel equals the dense +-1 product
exactly and its plain version bitwise, then, on the card, times with CUDA
events (``median_ms``: the card's time per call, median of ``REPS``
repeats): the kernel on packed operands, the whole call with the packing, the plain version,
``torch._int_mm`` on int8 operands (N and K zero-padded to multiples of 8,
as it requires; zeros add nothing) and a bf16 ``torch.mm`` with f32
output. The two library calls are yardsticks: they answer which lowering
a +-1 linear should take, and no path of the package calls them. Prints
one JSON line; on the CPU the times are null (not measured).

``--rates`` (card and nvcc only) measures instead which warp-level
products the tensor cores take on +-1 operands, and at what rate: the
measurement behind B9's design. It builds (into ``build/mma_rates/``) one
kernel per candidate in ``MMA_CANDIDATES``, each a loop of independent
``mma.sync`` products on register operands; a candidate that ``ptxas``
refuses for ``sm_90a`` prints its error, the rest are timed with CUDA
events at 4 and 8 blocks of 256 threads an SM. The rate is in dense-product
operations (2 per multiply-add, a binary one counted as one multiply-add),
the unit of the int8 peak. Prints the card's name and power limit, then
one JSON line per candidate and grid.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import numpy as np
import torch

from svnet_tpu_torch import config
from svnet_tpu_torch.ops.kernels import _build
from svnet_tpu_torch.ops.kernels.binary_matmul import (
    pack_signs,
    xnor_popcount,
    xnor_popcount_plain,
)

REPS = 20  # timed repeats per call
SEED = 0


def operands(M: int, K: int, N: int, seed: int, device):
    """Zero-free +-1 x (M, K) and w (K, N) from ``seed``."""
    rng = np.random.default_rng(seed)
    x = np.where(rng.standard_normal((M, K)) >= 0, 1.0, -1.0)
    w = np.where(rng.standard_normal((K, N)) >= 0, 1.0, -1.0)
    return (torch.from_numpy(x).float().to(device),
            torch.from_numpy(w).float().to(device))


def median_ms(fn, reps: int, calls: int = 10) -> float:
    """Device time of one fn() call: the median over ``reps`` repeats of
    ``calls`` back-to-back calls between a pair of CUDA events, after a
    warm-up. Each repeat first queues a spin of the card
    (``torch.cuda._sleep``) so that the host has queued every call before
    the first one runs: the events then time the card, not the host's
    launch overhead."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        e0.record()
        for _ in range(calls):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / calls)
    return sorted(times)[len(times) // 2]


def _pad8(t: torch.Tensor, dim: int) -> torch.Tensor:
    pad = -t.shape[dim] % 8
    if not pad:
        return t
    shape = list(t.shape)
    shape[dim] = pad
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


def main(M: int = 4096, K: int = 2048, N: int = 512, device="cuda") -> dict:
    """Check and time one shape; returns (and prints) the result."""
    dev = config.resolve_device(device)
    if dev.type == "cuda":
        config.set_full_fp32()
    x, w = operands(M, K, N, SEED, dev)
    dense = (x.double() @ w.double()).float()  # integers: exact in f32
    xp, wp = pack_signs(x), pack_signs(w.T).contiguous()
    got = xnor_popcount(xp, wp, K)
    plain = xnor_popcount_plain(xp, wp, K)
    res = {"M": M, "K": K, "N": N, "device": str(dev),
           "max_abs_err_vs_dense": (got - dense).abs().max().item(),
           "exact_vs_dense": bool(torch.equal(got, dense)),
           "bitwise_vs_plain": bool(torch.equal(got, plain)),
           "kernel_ms": None, "call_ms": None, "plain_ms": None,
           "int8_ms": None, "bf16_ms": None}
    if not (res["exact_vs_dense"] and res["bitwise_vs_plain"]):
        raise AssertionError(f"xnor_popcount is not exact: {res}")
    if dev.type == "cuda":
        x8 = _pad8(x.to(torch.int8), 1)
        w8 = _pad8(_pad8(w.T.to(torch.int8), 0), 1)  # (N8, K8) row-major
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)

        def int8_mm():
            return torch._int_mm(x8, w8.T)  # column-major second operand

        def bf16_mm():
            return torch.mm(xb, wb, out_dtype=torch.float32)

        res["int8_exact"] = bool(torch.equal(int8_mm()[:, :N].float(), dense))
        res["bf16_exact"] = bool(torch.equal(bf16_mm(), dense))
        res["kernel_ms"] = median_ms(lambda: xnor_popcount(xp, wp, K), REPS)
        res["call_ms"] = median_ms(
            lambda: xnor_popcount(pack_signs(x), pack_signs(w.T).contiguous(), K),
            REPS)
        res["plain_ms"] = median_ms(lambda: xnor_popcount_plain(xp, wp, K), 3, 1)
        res["int8_ms"] = median_ms(int8_mm, REPS)
        res["bf16_ms"] = median_ms(bf16_mm, REPS)
        res["card"] = _card(dev.index or 0)
    print(json.dumps(res), flush=True)
    return res


RATE_ITERS = 4096  # loop trips of the rate kernel; each issues 4 products
RATE_SOURCE = r"""#include <cuda_runtime.h>
extern "C" __global__ void rate(unsigned* out, unsigned seed) {
  unsigned a0 = seed ^ threadIdx.x, a1 = a0 * 3, a2 = a0 * 5, a3 = a0 * 7;
  unsigned b0 = a0 * 11, b1 = a0 * 13;
  int c[4][4] = {};
  for (int it = 0; it < ITERS; ++it) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      asm volatile(MMA " {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                   : "+r"(c[j][0]), "+r"(c[j][1]), "+r"(c[j][2]), "+r"(c[j][3])
                   : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0 + j), "r"(b1));
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = c[0][0] + c[1][1] + c[2][2] + c[3][3];
}
extern "C" int run(unsigned* out, int blocks, int threads) {
  rate<<<blocks, threads>>>(out, 1u);
  return (int)cudaGetLastError();
}
"""
# (name, PTX instruction, multiply-adds of one product)
MMA_CANDIDATES = (
    ("b1 m16n8k256 xor.popc",
     "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.xor.popc", 16 * 8 * 256),
    ("b1 m16n8k256 and.popc",
     "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc", 16 * 8 * 256),
    ("s8 m16n8k32", "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32", 16 * 8 * 32),
)


def rates() -> list:
    """Each MMA candidate's rate (TOP/s) at 4 and 8 blocks an SM, or the
    compiler's complaint; printed as JSON lines and returned."""
    out_dir = _build.BUILD_DIR.parent / "mma_rates"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "rate.cu"
    src.write_text(RATE_SOURCE)
    jobs = []
    for name, ptx, macs in MMA_CANDIDATES:  # one nvcc each, all together
        lib = out_dir / (name.replace(" ", "_").replace(".", "_") + ".so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", f"-DMMA=\"{ptx}\"",
               f"-DITERS={RATE_ITERS}", "-o", str(lib), str(src)]
        jobs.append((name, macs, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    print(_card(0), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    buf = torch.empty(sms * 8 * 256, dtype=torch.int32, device="cuda")
    rows = []
    for name, macs, lib, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            rows.append({"mma": name, "refused": err.strip()[-600:]})
            print(json.dumps(rows[-1]), flush=True)
            continue
        handle = ctypes.CDLL(str(lib))
        handle.run.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        for per_sm in (4, 8):
            blocks = sms * per_sm

            def go():
                if handle.run(buf.data_ptr(), blocks, 256) != 0:
                    raise RuntimeError(f"{name}: launch failed")
            go()
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            go()
            e1.record()
            torch.cuda.synchronize()
            ms = e0.elapsed_time(e1)
            products = blocks * 256 // 32 * RATE_ITERS * 4
            rows.append({"mma": name, "blocks_per_sm": per_sm, "ms": ms,
                         "tops": 2.0 * products * macs / ms / 1e9})
            print(json.dumps(rows[-1]), flush=True)
    return rows


def _card(index: int) -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[index]


def cli(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("shape", nargs="*", type=int, metavar="M K N",
                   help="default 4096 2048 512")
    p.add_argument("--device", default="cuda")
    p.add_argument("--rates", action="store_true",
                   help="measure the tensor cores' +-1 product rates instead")
    a = p.parse_args(argv)
    if a.rates:
        if a.shape or not torch.cuda.is_available():
            p.error("--rates takes no shape and needs a CUDA device")
        return rates()
    if len(a.shape) not in (0, 3):
        p.error("give M K N, or nothing")
    return main(*a.shape, device=a.device)


if __name__ == "__main__":
    cli()
