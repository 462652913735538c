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
# C signature of every entry point: (argtypes), all return cudaError_t (int)
SIGNATURES = {
    # pts, aa, 8 weights, s_out, v_out, ssum, wins; B N k S_out V_out; stream
    "sv_round3_first_launch": [_P] * 14 + [_I] * 5 + [_P],
    # src, aa, 9 weights, s_out, v_out, ssum, wins; B N S V S_out V_out k
    # binary; stream
    "sv_round3_launch": [_P] * 15 + [_I] * 8 + [_P],
    # src, gate, vrow, 10 weights, x_out, smax, vsum; B N S V S_out V_out
    # binary; stream
    "sv_point_launch": [_P] * 16 + [_I] * 7 + [_P],
    # x, aa, ids; B N C k; stream
    "sv_knn_launch": [_P] * 3 + [_I] * 4 + [_P],
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
