"""The round-1 fused rounds, kernel B10a (counterparts of
svnet_tpu/ops/pallas/sv_round.py::sv_round_first and ::sv_round): the trunk
behind the classifier's ``rounds_impl="round"``.

Row-major contract of the JAX functions: the first round takes points
(B, N, 3), the conv round ``src (B, N, S + 3V)`` = [s | v flat i-major];
both return ``s (B, N, S_out)``, ``v (B, N, 3*V_out)`` UNGATED (column
``i*V_out + c``) and the gate statistics: the first round's init-scalar
mean (B, 3*n_ch) c-major, a conv round's edge-scalar mean (B, 2S). In
exact mode this is the function of B10b (``sv_round2.py``): the plain
versions share its row-major core, the kernels (csrc/sv_round.cu) its
block templates, and the two agree bitwise.

``exact=False`` (sv_round.py:85-97, :246-253) ranks by the packed key
``q * 8192 + (8191 - col)``, q the distance on the 18-bit scale of each
key tile of ``T`` centres: at N <= 8192 that is round2's fast key, so the
selection is B10b's in fast mode, unfolded. The block reads the rows and
centres through bf16 (``quant.bf16_rows``: rounded to nearest even, read
back in f32; a self-edge is exactly 0). The key's 13 column bits hold at
most 8192 rows: both wrappers raise above that (JAX asserts it in
``sv_round`` only; its first round would corrupt its keys).

A CPU tensor goes to the plain version; a CUDA tensor launches
csrc/sv_round.cu or raises. ``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from svnet_tpu_torch.ops.kernels.fold import Folded
from svnet_tpu_torch.ops.kernels.sv_round2 import (
    check_points,
    check_src,
    key_tile,
    launch_conv,
    launch_first,
)
from svnet_tpu_torch.ops.kernels.sv_round3 import conv_round_rows, first_round_rows

MAX_N_FAST = 8192  # the packed key's 13 column bits (sv_round.py:96, :438)


def _fast_tile(exact: bool, N: int, T: int, k: int) -> int | None:
    """``exact=False``'s key tile T (None in exact mode), checked."""
    if not exact and N > MAX_N_FAST:
        raise ValueError(f"exact=False: the packed key holds at most "
                         f"{MAX_N_FAST} rows, N={N}")
    return key_tile("exact" if exact else "fast", N, T, k)


def _mode(exact: bool) -> dict:
    return dict(mode="exact" if exact else "fast", grid="bf16")


def sv_round_first_plain(points: torch.Tensor, folded: Folded, *, S_out: int,
                         V_out: int, k: int, cross: bool = False,
                         exact: bool = True, T: int = 256):
    """Plain version of the first round: the kernel's three outputs."""
    T = _fast_tile(exact, points.shape[1], T, k)
    return first_round_rows(points, folded, S_out=S_out, V_out=V_out, k=k,
                            cross=cross, T=T, **_mode(exact))[:3]


def sv_round_first(points: torch.Tensor, folded: Folded, *, S_out: int,
                   V_out: int, k: int, cross: bool = False,
                   exact: bool = True, T: int = 256):
    """points (B, N, 3) -> (s (B, N, S_out), v (B, N, 3*V_out) ungated,
    s_mean (B, 3*n_ch) c-major); n_ch = 3 with ``cross``, else 2. The
    kernel takes S_out = 32 and V_out = 10 or 16. ``exact=False``: the
    packed selection on key tiles of ``T`` and the bf16 gather (see the
    module's docstring)."""
    check_points(points, k)
    T = _fast_tile(exact, points.shape[1], T, k)
    kw = dict(S_out=S_out, V_out=V_out, k=k, cross=cross)
    if points.device.type == "cpu":
        return sv_round_first_plain(points, folded, exact=exact, T=T, **kw)
    out = launch_first("sv_round_first_launch", points, folded, T=T,
                       **_mode(exact), **kw)
    sv_round_first.launches += 1
    return out[:3]


sv_round_first.launches = 0


def sv_round_plain(src: torch.Tensor, folded: Folded, *, S: int, V: int,
                   S_out: int, V_out: int, k: int, binary: bool,
                   exact: bool = True, T: int = 128):
    """Plain version of a conv round: the kernel's three outputs."""
    T = _fast_tile(exact, src.shape[1], T, k)
    return conv_round_rows(src, folded, S=S, V=V, S_out=S_out, V_out=V_out,
                           k=k, binary=binary, T=T, **_mode(exact))[:3]


def sv_round(src: torch.Tensor, folded: Folded, *, S: int, V: int,
             S_out: int, V_out: int, k: int, binary: bool = True,
             exact: bool = True, T: int = 128):
    """src (B, N, S+3V) row-major [s | v i-major] -> (s (B, N, S_out),
    v (B, N, 3*V_out) ungated, s_edge_mean (B, 2S)); ``exact`` and ``T``
    as ``sv_round_first``'s."""
    check_src(src, S + 3 * V, k)
    T = _fast_tile(exact, src.shape[1], T, k)
    kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=k, binary=binary)
    if src.device.type == "cpu":
        return sv_round_plain(src, folded, exact=exact, T=T, **kw)
    out = launch_conv("sv_round_launch", src, folded, T=T, **_mode(exact), **kw)
    sv_round.launches += 1
    return out[:3]


sv_round.launches = 0
