"""Build ``csrc/*.cu`` with nvcc into one shared library and bind it with
ctypes.

The library exposes a plain C interface (no PyTorch headers), so one
build takes seconds. It is built at first use into ``build/kernels/`` at
the repository root, under a name keyed by a hash of the sources and the
flags, and loaded once per process. Each source compiles in its own nvcc
process, all started together, and the objects are linked into the
library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]  # svnet_tpu_torch/
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
    # every product and sum rounded on its own, as in the plain versions,
    # which accumulate in the kernels' order: kernel and plain version agree
    # bitwise, so no binarized sign can flip between them
    "-fmad=false",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signature of every entry point: (argtypes), all return an int (a
# cudaError_t, but for sv_block_point_ppb, sv_pack_bytes and the
# training rounds' *_tile queries)
SIGNATURES = {
    # pts, aa, 8 weights, s_out, v_out, ssum, wins, pts_q, tile_scale,
    # keep, ok; B N k S_out V_out cross T L W LW; stream
    "sv_round3_first_launch": [_P] * 18 + [_I] * 10 + [_P],
    # src, aa, 9 weights, s_out, v_out, ssum, wins, src_q, tile_scale, keep,
    # ok; B N S V S_out V_out k binary T L W LW; stream
    "sv_round3_launch": [_P] * 19 + [_I] * 12 + [_P],
    # src, wins, wins' batch stride, 9 weights, s_out, v_out, ssum; B N S V
    # S_out V_out k binary; stream
    "sv_round3_reuse_launch": [_P, _P, _L] + [_P] * 12 + [_I] * 8 + [_P],
    # src, gate, vrow, 10 weights and W1's packed signs (after w1), x_out,
    # smax, vsum; B N S V S_out V_out binary; stream
    "sv_point_launch": [_P] * 17 + [_I] * 7 + [_P],
    # the row-major twins: sv_round2_first_launch and sv_round2_launch as
    # the round3 entry points without the window (the last two pointers
    # and the last two ints), sv_point_rm_launch as sv_point_launch
    # without vrow
    "sv_round2_first_launch": [_P] * 16 + [_I] * 8 + [_P],
    "sv_round2_launch": [_P] * 17 + [_I] * 10 + [_P],
    "sv_point_rm_launch": [_P] * 16 + [_I] * 7 + [_P],
    # B10a, as the round2 entry points
    "sv_round_first_launch": [_P] * 16 + [_I] * 8 + [_P],
    "sv_round_launch": [_P] * 17 + [_I] * 10 + [_P],
    # pts, ids, 8 weights, s_out, v_out, ssum; B N k S_out V_out; stream
    "sv_edge_first_launch": [_P] * 13 + [_I] * 5 + [_P],
    # src, ids, gate, 9 weights, s_out, v_out; B N S V S_out V_out k
    # binary exact; stream
    "sv_edge_launch": [_P] * 14 + [_I] * 9 + [_P],
    # xp, wp, out; M N L; stream
    "xnor_popcount_launch": [_P] * 3 + [_I] * 3 + [_P],
    # src, gate, 9 weights and W1's packed signs (after w1), s_out, v_out;
    # B N S V S_out V_out binary; stream
    "sv_block_point_launch": [_P] * 14 + [_I] * 7 + [_P],
    # S V S_out V_out binary -> points per block
    "sv_block_point_ppb": [_I] * 5,
    # phase, dims (the launch's 9 ints) -> centre points per tile, 0: none
    "sv_round3_train_tile": [_I, _P],
    "sv_first_train_tile": [_I, _P],
    # K S_out -> bytes of W1's packed signs
    "sv_pack_bytes": [_I] * 2,
    # w1, out; K S_out; stream
    "sv_pack_signs_launch": [_P] * 2 + [_I] * 2 + [_P],
    # x, aa, ids, tile_scale; B N C k T L; stream
    "sv_knn_launch": [_P] * 4 + [_I] * 6 + [_P],
    # x, aa, neg_min; B N C; stream
    "sv_neg_min_launch": [_P] * 3 + [_I] * 3 + [_P],
    # x, aa, neg_min, keep, ok; B N C T W; stream
    "sv_neg_min_window_launch": [_P] * 5 + [_I] * 5 + [_P],
    # x, aa, tau; B N C k; stream
    "sv_window_tau_launch": [_P] * 3 + [_I] * 4 + [_P],
    # x, lo, hi, tau, keep; B N C T; stream
    "sv_window_keep_launch": [_P] * 5 + [_I] * 4 + [_P],
    # src, idx, out; B n_src M k C; stream
    "sv_edge_gather_fwd_launch": [_P] * 3 + [_I] * 5 + [_P],
    # g, idx, dsrc, scratch; B n_src M k C ranges cap; stream
    "sv_edge_gather_bwd_launch": [_P] * 4 + [_I] * 7 + [_P],
    # phase, pointer slots (void**), dims (int*), stream
    "sv_first_train_launch": [_I, _P, _P, _P],
    "sv_round3_train_launch": [_I, _P, _P, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsvnet_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if the hashed library is not there yet."""
    global build_seconds
    import time

    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for cmd, _, proc in jobs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{stdout}\n{stderr}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
           "-o", str(tmp), *[str(obj) for _, obj, _ in jobs]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed ({res.returncode}):\n{' '.join(cmd)}\n"
            f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    for _, obj, _ in jobs:
        obj.unlink()
    build_seconds = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def check_arg(t, name: str, shape: tuple, device) -> int:
    """Validate a float32 kernel argument; returns its data pointer."""
    import torch

    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {t.dtype}, expected torch.float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    return t.data_ptr()


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
