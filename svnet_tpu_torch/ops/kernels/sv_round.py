"""The round-1 fused rounds, exact mode, kernel B10a (counterparts of
svnet_tpu/ops/pallas/sv_round.py::sv_round_first and ::sv_round): the trunk
behind the classifier's ``rounds_impl="round"``.

Row-major contract of the JAX functions: the first round takes points
(B, N, 3), the conv round ``src (B, N, S + 3V)`` = [s | v flat i-major];
both return ``s (B, N, S_out)``, ``v (B, N, 3*V_out)`` UNGATED (column
``i*V_out + c``) and the gate statistics: the first round's init-scalar
mean (B, 3*n_ch) c-major, a conv round's edge-scalar mean (B, 2S). In
exact mode this is the function of B10b (``sv_round2.py``): the plain
versions share its row-major core, the kernels (csrc/sv_round.cu) its
block templates, and the two agree bitwise. JAX's ``exact=False`` variant
(a bf16 gather with its own packed selection) is not ported: the wrappers
raise for it.

A CPU tensor goes to the plain version; a CUDA tensor launches
csrc/sv_round.cu or raises. ``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from svnet_tpu_torch.ops.kernels.fold import Folded
from svnet_tpu_torch.ops.kernels.sv_round2 import (
    check_points,
    check_src,
    launch_conv,
    launch_first,
)
from svnet_tpu_torch.ops.kernels.sv_round3 import conv_round_rows, first_round_rows

_NOT_EXACT = ("exact=False (sv_round.py's bf16 gather and packed selection) "
              "is not ported: only exact mode runs")


def sv_round_first_plain(points: torch.Tensor, folded: Folded, *, S_out: int,
                         V_out: int, k: int, cross: bool = False):
    """Plain version of the first round: the kernel's three outputs."""
    return first_round_rows(points, folded, S_out=S_out, V_out=V_out, k=k,
                            cross=cross)[:3]


def sv_round_first(points: torch.Tensor, folded: Folded, *, S_out: int,
                   V_out: int, k: int, cross: bool = False,
                   exact: bool = True):
    """points (B, N, 3) -> (s (B, N, S_out), v (B, N, 3*V_out) ungated,
    s_mean (B, 3*n_ch) c-major); n_ch = 3 with ``cross``, else 2. The
    kernel takes S_out = 32 and V_out = 10 or 16."""
    if not exact:
        raise NotImplementedError(f"sv_round_first: {_NOT_EXACT}")
    check_points(points, k)
    kw = dict(S_out=S_out, V_out=V_out, k=k, cross=cross)
    if points.device.type == "cpu":
        return sv_round_first_plain(points, folded, **kw)
    out = launch_first("sv_round_first_launch", points, folded, **kw)
    sv_round_first.launches += 1
    return out[:3]


sv_round_first.launches = 0


def sv_round_plain(src: torch.Tensor, folded: Folded, *, S: int, V: int,
                   S_out: int, V_out: int, k: int, binary: bool):
    """Plain version of a conv round: the kernel's three outputs."""
    return conv_round_rows(src, folded, S=S, V=V, S_out=S_out, V_out=V_out,
                           k=k, binary=binary)[:3]


def sv_round(src: torch.Tensor, folded: Folded, *, S: int, V: int,
             S_out: int, V_out: int, k: int, binary: bool = True,
             exact: bool = True):
    """src (B, N, S+3V) row-major [s | v i-major] -> (s (B, N, S_out),
    v (B, N, 3*V_out) ungated, s_edge_mean (B, 2S))."""
    if not exact:
        raise NotImplementedError(f"sv_round: {_NOT_EXACT}")
    check_src(src, S + 3 * V, k)
    kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=k, binary=binary)
    if src.device.type == "cpu":
        return sv_round_plain(src, folded, **kw)
    out = launch_conv("sv_round_launch", src, folded, **kw)
    sv_round.launches += 1
    return out[:3]


sv_round.launches = 0
