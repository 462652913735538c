"""Fast and approx mode's quantization, the port's own copy of the JAX
package's (svnet_tpu/ops/pallas/sv_round3.py and sv_round2.py).

Fast mode changes two things in a round, and both are part of its result:

  the neighbour key: the f32 negative squared distance ``neg`` (over the
  raw features) quantized to ``qbits`` bits on a per-(cloud, key tile)
  scale, packed with the row into one unique int32, larger first
  (``packed_keys``); the key tile is T centres, T from the JAX package's
  VMEM heuristic (``round3_tiles``), so T changes which rows tie;
  the gather grid: the block reads neighbours and centres through a
  per-channel symmetric fixed-point grid over the whole batch, 16 bits
  (``config.fast_gather_bits = 16``) or 8 (``grid_rows``), so a self-edge
  is exactly zero.

Approx mode takes fast's keys and folds them (``fold_width``,
``fold_keys``): a centre's N candidate keys are halved by key max down to
L <= ``config.approx_fold`` lanes, lane i the best of the rows m = i mod
L, before the top-k; its grid's bits are ``config.approx_gather_bits``
(``gb8``).

The legacy row-major trunks read none of these knobs. Round2
(sv_round2.py) keys as round3 does, on key tiles of ``auto_round_tile``,
always gathers through the 16-bit grid and folds to the fixed
``APPROX_L2``; round 1's fast variant (sv_round.py, ``exact=False``)
takes the same key unfolded and gathers bf16 rows (``bf16_rows``).

Everything here is plain tensor code, run as is on every device: the
kernels take its results (the grid's rows, the tiles' scales) as inputs.
"""

from __future__ import annotations

import torch

from svnet_tpu_torch import config

Q_BITS = 18  # the distance field's bits at N <= 8192 (sv_round2.py:57)
APPROX_L2 = 256  # round2's fixed approx fold width (sv_round2.py:58)


def idx_bits(N: int) -> int:
    """Row bits of the packed key: 13 at N <= 8192, more beyond
    (sv_round2.py:187)."""
    b = 13
    while (1 << b) < N:
        b += 1
    return b


def q_bounds(N: int) -> tuple[int, int]:
    """(lowest, highest) quantized distance of a packed key at N rows. The
    lowest is the JAX package's clamp; the highest only keeps a key that
    rounding made positive inside int32 (JAX's keys wrap there, which no
    cloud of distinct points reaches)."""
    ib = idx_bits(N)
    return -(1 << min(Q_BITS, 31 - ib)) + 1, (1 << (31 - ib)) - 1


def tile_scales(neg_min: torch.Tensor, T: int, M: int) -> torch.Tensor:
    """(B, N) least ``neg`` of each centre over all M candidates -> (B, N/T)
    f32 key scales, one per tile of T centres:
    ``-(2^qbits) / min(worst, -1e-12)``, qbits of M rows
    (sv_round3.py:199-206)."""
    B, N = neg_min.shape
    qbits = min(Q_BITS, 31 - idx_bits(M))
    worst = neg_min.reshape(B, N // T, T).amin(dim=-1)
    lim = torch.tensor(-1e-12, dtype=torch.float32, device=worst.device)
    top = torch.tensor(float(-(1 << qbits)), dtype=torch.float32,
                       device=worst.device)
    return top / torch.minimum(worst, lim)


def packed_keys(neg: torch.Tensor, scale: torch.Tensor, T: int,
                rows: torch.Tensor | None = None,
                M: int | None = None) -> torch.Tensor:
    """neg (B, N centres, M candidates), scale (B, N/T) -> int32 keys
    ``q * 2^ib + (2^ib - 1 - row)``, q = floor(neg * scale) clamped; unique
    along the candidates, larger first, ties of q to the lower row. A
    candidate window passes its candidates' absolute ``rows``
    (broadcastable to neg) and the cloud's ``M`` rows, which set ib."""
    M = M or neg.shape[-1]
    ib = idx_bits(M)
    lo, hi = q_bounds(M)
    s = scale.repeat_interleave(T, dim=1)[:, :, None]
    q = torch.floor(neg * s).clamp_(lo, hi).to(torch.int32)
    if rows is None:
        rows = torch.arange(M, device=neg.device, dtype=torch.int32)
    return q * (1 << ib) + ((1 << ib) - 1 - rows.to(torch.int32))


def key_rows(keys: torch.Tensor, M: int) -> torch.Tensor:
    """The row of each packed key (its low ``idx_bits(M)`` bits)."""
    ib = idx_bits(M)
    return ((1 << ib) - 1) - (keys & ((1 << ib) - 1))


def gb8(mode: str) -> bool:
    """True where ``mode`` gathers through the 8-bit grid (``_gb8``,
    sv_round3.py:120-127): the one source of a round's grid bits and of
    the plane count in its key tile T."""
    return ((mode == "approx" and config.approx_gather_bits == 8)
            or (mode == "fast" and config.fast_gather_bits == 8))


def gather_bits(mode: str) -> int:
    """The gather grid's bits of a fast or approx round."""
    return 8 if gb8(mode) else 16


def fold_width(N: int, k: int = 1, fold: int | None = None) -> int:
    """Approx mode's folded candidate width L (``_build_key_t``,
    sv_round3.py:209-234; round2's ``_build_key``, sv_round2.py:213-228):
    N halved while above ``fold`` (``config.approx_fold`` unless given).
    Raises where the JAX package asserts (an odd width to halve) and for
    k > L, where its top k would decode empty lanes into rows."""
    fold = config.approx_fold if fold is None else fold
    w = N
    while w > fold:
        if w % 2:
            raise ValueError(f"approx fold: width {w} (of N={N}) is odd; "
                             f"N must halve evenly to <= {fold}")
        w //= 2
    if k > w:
        raise ValueError(f"approx mode: k={k} above the folded width L={w} "
                         f"(N={N}, fold {fold})")
    return w


def fold_keys(keys: torch.Tensor, L: int) -> torch.Tensor:
    """(..., N) packed keys -> (..., L): lane i the largest key over the
    rows m = i mod L, which the repeated halving max of ``_build_key_t``
    gives; the key embeds its row, so the lane also says which row won."""
    N = keys.shape[-1]
    return keys.reshape(*keys.shape[:-1], N // L, L).amax(dim=-2)


def grid_codes(x: torch.Tensor, bits: int):
    """Channels-last x (..., C) -> (int16 codes, f32 inv (C,)) of the
    gather grid over every row of the batch: ``scale = 32704 / amax``
    (16 bits, pack_planes_fast_t) or ``127 / amax`` clipped to +-127 (8
    bits, pack_planes_q8_t), codes ``round_half_even(x * scale)``, inv the
    f32 reciprocal of the scale."""
    if bits not in (8, 16):
        raise ValueError(f"bits={bits}: the gather grid has 8 or 16 bits")
    amax = x.abs().reshape(-1, x.shape[-1]).amax(dim=0)
    top = 32704.0 if bits == 16 else 127.0
    scale = torch.tensor(top, dtype=torch.float32, device=x.device) / \
        torch.clamp(amax, min=1e-30)
    q = torch.round(x * scale)
    if bits == 8:
        q = q.clamp_(-127, 127)
    return q.to(torch.int16), torch.reciprocal(scale)


def bf16_rows(x: torch.Tensor) -> torch.Tensor:
    """Round 1's fast gather (sv_round.py:68-70, :232-233): every value
    rounded to bf16 (to nearest even) and read back in f32; a self-edge
    is exactly 0."""
    return x.to(torch.bfloat16).to(torch.float32)


def grid_rows(x: torch.Tensor, mode: str = "fast",
              grid: int | str | None = None) -> torch.Tensor:
    """x (..., C) through a gather grid, what the block reads for
    neighbours and centres alike: ``grid`` 16 or 8 bits (``float(code) *
    inv``), "bf16" (``bf16_rows``), or None for ``mode``'s bits
    (``gather_bits``)."""
    if grid == "bf16":
        return bf16_rows(x)
    q, inv = grid_codes(x, gather_bits(mode) if grid is None else grid)
    return q.to(torch.float32) * inv


def plane_stride(C: int) -> int:
    return (C + 7) // 8 * 8


def round3_tiles(N: int, C: int, mode: str) -> int:
    """The key tile T of a round over C channels: the JAX package's
    ``_round3_tiles(...)[0]`` (sv_round3.py:860-893, no graph reuse; its
    other widths do not reach T) under its ~11 MB VMEM budget, the
    gather's planes (4 exact, 2 fast or approx, 1 with 8-bit gathers,
    ``gb8``) in its fixed part; T = N where no tile of 128-512 divides N."""
    budget = 11 * 1024 * 1024
    nplanes = 4 if mode == "exact" else (1 if gb8(mode) else 2)
    fixed = N * C * 4 * 2 + N * nplanes * plane_stride(C)
    per_t = N * 4 * (5 if mode == "exact" else 4)
    T = max(128, (budget // 2 - fixed) // max(per_t, 1) // 128 * 128)
    p2 = 128
    while p2 * 2 <= T:
        p2 *= 2
    T = p2
    while N % T and T > 128:
        T //= 2
    T = min(T, 512)
    if N % T:
        T = N
    return T


def auto_round_tile(N: int, tile: int, k: int = 20, C: int = 64,
                    mode: str = "fast") -> int:
    """The legacy trunks' key tile T (``_auto_round_tile``,
    svnet_tpu/infer.py:80-101): the largest power of two at most
    ``min(max(4 * tile, 64), N, max(9e6 // (div * N), 32))``, div 20 in
    exact mode (which also caps it by k and C) and 12 otherwise, halved
    until it divides N, and at least 8. In fast and approx mode it is
    part of the result (the keys' scale is per tile)."""
    sel_div = 20 if mode == "exact" else 12
    t = min(max(tile * 4, 64), N, max(9_000_000 // (sel_div * N), 32))
    if mode == "exact":
        t = min(t, max(4_500_000 // max(16 * k * C, 1), 32))
    p2 = 1
    while p2 * 2 <= t:
        p2 *= 2
    t = p2
    while N % t:
        t //= 2
    return max(int(t), 8)
