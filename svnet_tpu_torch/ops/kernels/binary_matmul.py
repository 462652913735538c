"""The bit-packed XNOR-popcount +-1 matrix product, kernel B9 (counterpart
of svnet_tpu/ops/pallas/binary_matmul.py::xnor_popcount_matmul): the
subject of ``utils/bench_binary_matmul.py``, which times it against the
library's int8 and bf16 products to choose how a +-1 linear1 should run on
the card. No model path calls it.

``pack_signs`` packs 32 signs per int32 word on the host side of the
kernel, as JAX packs them outside its kernel; ``xnor_popcount(xp, wp, K)``
is the kernel on packed operands, ``xnor_popcount_matmul(x, w)`` the JAX
function's contract on dense +-1 operands. Exact for zero-free operands
only: a 0 packs as -1.

A CPU tensor goes to the plain version; a CUDA tensor launches
csrc/binary_matmul.cu or raises. ``xnor_popcount.launches`` counts
launches.
"""

from __future__ import annotations

import torch

from svnet_tpu_torch.config import require_cuda
from svnet_tpu_torch.ops.kernels import _build


def pack_signs(x: torch.Tensor) -> torch.Tensor:
    """(M, K) +-1 -> (M, K // 32) int32: bit b of word j is
    ``x[:, 32j + b] > 0``. K must be a multiple of 32. Packed in int64 and
    cast, which wraps as JAX's ``astype`` does."""
    M, K = x.shape
    if K % 32:
        raise ValueError(f"pack_signs: K={K} is not a multiple of 32")
    bits = (x > 0).to(torch.int64).reshape(M, K // 32, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=x.device)
    return torch.sum(bits << shifts, dim=-1).to(torch.int32)


# packed words per step of the plain version: its (M, N, words) temporary
# stays near 64 MB at the bench's shape
_WORDS = 8


def xnor_popcount_plain(xp: torch.Tensor, wp: torch.Tensor,
                        K: int) -> torch.Tensor:
    """Plain version: the mismatched bits of xp (M, L) and wp (N, L)
    counted bit by bit with shifts, a few packed words at a time;
    ``K - 2 * count`` in f32 (M, N)."""
    M, L = xp.shape
    cnt = torch.zeros((M, wp.shape[0]), dtype=torch.int32, device=xp.device)
    for j0 in range(0, L, _WORDS):
        x = xp[:, None, j0:j0 + _WORDS] ^ wp[None, :, j0:j0 + _WORDS]
        for b in range(32):
            cnt += torch.sum((x >> b) & 1, dim=-1, dtype=torch.int32)
    return K - 2.0 * cnt.to(torch.float32)


def xnor_popcount(xp: torch.Tensor, wp: torch.Tensor, K: int) -> torch.Tensor:
    """Packed rows xp (M, K/32) and columns wp (N, K/32), int32 ->
    (M, N) f32 ``K - 2 * popcount(xp[m] ^ wp[n])``."""
    if xp.dim() != 2 or wp.dim() != 2 or xp.shape[1] != wp.shape[1]:
        raise ValueError(f"xp {tuple(xp.shape)}, wp {tuple(wp.shape)}: "
                         "expected (M, L) and (N, L)")
    M, L = xp.shape
    N = wp.shape[0]
    if K != 32 * L:
        raise ValueError(f"K={K} != 32 * {L} packed words")
    for name, t in (("xp", xp), ("wp", wp)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: dtype {t.dtype}, expected torch.int32")
    if xp.device.type == "cpu":
        return xnor_popcount_plain(xp, wp, K)
    dev = require_cuda(xp.device)
    for name, t in (("xp", xp), ("wp", wp)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous on {dev}")
    out = torch.empty((M, N), device=dev)
    err = _build.lib().xnor_popcount_launch(xp.data_ptr(), wp.data_ptr(),
                                            out.data_ptr(), M, N, L,
                                            _build.stream_ptr(dev))
    _build.check(err, "xnor_popcount")
    xnor_popcount.launches += 1
    return out


xnor_popcount.launches = 0


def xnor_popcount_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ w (K, N) for zero-free +-1 operands, by XNOR-popcount on
    packed signs: (M, N) f32."""
    return xnor_popcount(pack_signs(x), pack_signs(w.T).contiguous(),
                         x.shape[1])
