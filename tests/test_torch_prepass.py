"""The pre-passes' kernel designs, emulated in PyTorch on the CPU.

The fast key's pre-pass (``ops.kernels.knn.neg_min``, csrc/knn.cu) takes
each 128 x 128 tile (I, J) of a cloud with I <= J once and reads its
inner products both ways: neg(n, m) for the rows of I, neg(m, n) for the
rows of J, a diagonal tile once; each row's min reaches device memory by
an integer atomic min on the float's bits, over +inf (or 0.0 on a
windowed key tile with padding). The emulation below follows that
schedule and is held with ``torch.equal`` to the plain versions, and,
through ``quant.tile_scales``, to the keys of the JAX package's
``_packed_key_t`` (sv_round3.py:199-206) on the same input. The window's
tau (``ops.window.window_tau``, csrc/window.cu) sorts each lane's 12 band
keys and takes the least head key until k are taken; that selection is
emulated on duplicated rows and held to ``window_tau_plain``'s kthvalue.
The window's block test (``ops.window.window_keep``) takes each term as
(x - clamp(x, lo, hi))^2 and folds a block for a key tile over blocks of
threads of 128 centres; the term is held bitwise to the plain version's
on adversarial values, and the schedule to ``window_keep_plain``. No JAX
kernel runs here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnet_tpu.ops.pallas import sv_round3 as jr3
from svnet_tpu_torch.ops import window
from svnet_tpu_torch.ops.kernels import quant
from svnet_tpu_torch.ops.kernels.knn import neg_min_plain, neg_min_window_plain
from svnet_tpu_torch.ops.knn import channel_sum, pairwise_neg_sqdist
from svnet_tpu_torch.utils.synth import strand_clouds

TILE = 128  # the kernel's tile rows (knn.cu, NM_T)
INF = float("inf")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's thread pool only competes with the other
    test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(b, n, c, kind, seed):
    """Seeded (B, N, C) float32: Gaussian, every other point a copy of
    its neighbour ("dup"), or one point repeated ("same")."""
    x = np.random.default_rng(seed).normal(size=(b, n, c)).astype(np.float32)
    if kind == "dup":
        x[:, 1::2] = x[:, 0::2][:, : x[:, 1::2].shape[1]]
    elif kind == "same":
        x[:] = x[:, :1]
    return torch.from_numpy(x)


def _atomic_fmin(stored: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """knn.cu's sv_atomic_fmin on the bits: a signed min where v's sign
    bit is clear, an unsigned max where it is set."""
    s = stored.view(torch.int32).long()
    w = v.view(torch.int32).long()
    smin = torch.minimum(s, w)
    umax = torch.maximum(s & 0xFFFFFFFF, w & 0xFFFFFFFF)
    out = torch.where(w >= 0, smin, torch.where(umax >= 1 << 31, umax - (1 << 32), umax))
    return out.to(torch.int32).view(torch.float32)


def _tile_min(v: torch.Tensor, dim: int) -> torch.Tensor:
    """fminf over ``dim``: NaN (a row past N) drops out."""
    return torch.where(torch.isnan(v), INF, v).amin(dim=dim)


def _neg_min_tiles(x: torch.Tensor, win=None) -> torch.Tensor:
    """The pre-pass kernel's schedule on (B, N, C) x: tiles (I, J), I <= J,
    of 128 rows, the inner product once, the row form for I's rows and
    the column form for J's (a diagonal tile once), rows past N as zeros
    with a NaN squared norm; with ``win`` = (T, W, keep, ok) a tile feeds
    I's rows where I's key tile keeps block J and J's rows where J's key
    tile keeps block I, over an initial 0.0 on key tiles with padding."""
    B, N, C = x.shape
    nt = -(-N // TILE)
    xp = torch.zeros(B, nt * TILE, C)
    xp[:, :N] = x
    aa = channel_sum(xp, xp)
    aa[:, N:] = float("nan")
    out = torch.full((B, nt * TILE), INF)
    if win is not None:
        T, W, keep, ok = win
        if bool(ok):
            kept = keep.sum(dim=-1)  # (B, N / T)
            pad = (kept * TILE < W).repeat_interleave(T, dim=1)
            out = torch.where(pad, torch.zeros_like(out), out)
    for i in range(nt):
        for j in range(i, nt):
            ri, rj = slice(i * TILE, (i + 1) * TILE), slice(j * TILE, (j + 1) * TILE)
            feed_i = torch.ones(B, dtype=torch.bool)
            feed_j = torch.full((B,), i != j)
            if win is not None and bool(win[3]):
                T, _, keep, _ = win
                feed_i = keep[:, i * TILE // T, j] != 0
                feed_j = feed_j & (keep[:, j * TILE // T, i] != 0)
            inner = channel_sum(xp[:, ri, None, :], xp[:, None, rj, :])
            two = 2.0 * inner
            rows = _tile_min((two - aa[:, ri, None]) - aa[:, None, rj], 2)
            cols = _tile_min((two - aa[:, None, rj]) - aa[:, ri, None], 1)
            out[:, ri] = torch.where(feed_i[:, None], _atomic_fmin(out[:, ri], rows),
                                     out[:, ri])
            out[:, rj] = torch.where(feed_j[:, None], _atomic_fmin(out[:, rj], cols),
                                     out[:, rj])
    return out[:, :N]


def test_atomic_fmin_is_the_float_min():
    """The integer atomic on the float's bits is the float min, over
    +inf, 0.0 and each sign."""
    vals = torch.tensor([INF, 0.0, -0.0, 1e-30, -1e-30, 3.5, -3.5, 1e30, -1e30, -INF])
    s, v = torch.meshgrid(vals, vals, indexing="ij")
    got = _atomic_fmin(s.reshape(-1), v.reshape(-1))
    assert torch.equal(got, torch.minimum(s.reshape(-1), v.reshape(-1)))
    assert _atomic_fmin(torch.tensor([0.0]), torch.tensor([-0.0])).view(torch.int32) < 0


PREPASS_SHAPES = [(2, n, c, None) for n in (50, 130, 256, 1000, 1001) for c in (1, 3, 33)]
PREPASS_SHAPES += [(2, 1000, 5, "dup"), (1, 256, 3, "same"), (2, 130, 33, "dup")]


@pytest.mark.parametrize("shape", PREPASS_SHAPES,
                         ids=[f"B{s[0]}-N{s[1]}-C{s[2]}" + (f"-{s[3]}" if s[3] else "")
                              for s in PREPASS_SHAPES])
def test_symmetric_tiles_match_plain(shape):
    """Each centre's least distance from the symmetric tile schedule,
    bitwise ``neg_min_plain``'s, edges masked at N not a multiple of 128,
    ties and a cloud of one repeated point included."""
    b, n, c, kind = shape
    x = _cloud(b, n, c, kind, seed=n + c)
    assert torch.equal(_neg_min_tiles(x), neg_min_plain(x))


@pytest.mark.parametrize("n,t", [(256, 64), (1000, 1000), (1001, 1001), (1024, 128)])
def test_symmetric_tiles_scales_match_jax(n, t):
    """The schedule's mins through ``quant.tile_scales`` give the keys that
    JAX's ``_packed_key_t`` gives on each key tile's (N, T) block of the
    same distances: the same scale."""
    x = _cloud(1, n, 3, "dup" if n == 1000 else None, seed=n)
    neg = pairwise_neg_sqdist(x)  # (1, N centres, N)
    scale = quant.tile_scales(_neg_min_tiles(x), t, n)
    got = quant.packed_keys(neg, scale, t)[0].numpy()
    rows = jnp.arange(n, dtype=jnp.int32)[:, None]
    for i in range(n // t):
        blk = neg[0, i * t:(i + 1) * t].numpy().T  # (N, T)
        want = np.asarray(jr3._packed_key_t(jnp.asarray(blk), rows, n))
        np.testing.assert_array_equal(got[i * t:(i + 1) * t].T, want)


def _keep(b, n, t, w, seed, full):
    """Random kept blocks, (B, N / T, N / 128) int32: each key tile keeps
    W / 128 blocks (``full``) or fewer, its own not always among them."""
    rng = np.random.default_rng(seed)
    nb, slots = n // TILE, w // TILE
    keep = np.zeros((b, n // t, nb), np.int32)
    for bi in range(b):
        for ti in range(n // t):
            cnt = slots if full else rng.integers(1, slots)
            keep[bi, ti, rng.choice(nb, size=cnt, replace=False)] = 1
    return torch.from_numpy(keep)


@pytest.mark.parametrize("case", ["certified", "padded", "full", "not certified"])
def test_symmetric_tiles_window_match_plain(case):
    """The windowed schedule (a tile feeds each side only where that side's
    key tile keeps the other's block) bitwise ``neg_min_window_plain``'s:
    the certificate of strand clouds, random kept blocks with padding and
    without, and ok = 0 (every block)."""
    b, n, c, t, w = 2, 1024, 5, 256, 512
    x = torch.from_numpy(strand_clouds(7, b, n, c))
    x[:, 1::2] = x[:, 0::2]  # ties
    if case == "certified":
        keep, ok = window.prune_prepass(x, 8, t, w, plain=True)
        assert bool(ok)
    else:
        keep = _keep(b, n, t, w, seed=3, full=case == "full")
        ok = torch.tensor(case != "not certified")
    win = (t, w, keep, ok.to(torch.int32))
    assert torch.equal(_neg_min_tiles(x, win), neg_min_window_plain(x, win))


def _wt_key(f: torch.Tensor) -> torch.Tensor:
    """window.cu's wt_key: float -> uint32 (held in int64) in the float's
    order."""
    u = f.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    return torch.where(u >= 1 << 31, 0xFFFFFFFF - u, u | (1 << 31))


def _wt_value(key: torch.Tensor) -> torch.Tensor:
    u = torch.where(key >= 1 << 31, key - (1 << 31), 0xFFFFFFFF - key)
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32).view(torch.float32)


def _tau_select(d2: torch.Tensor, k: int) -> torch.Tensor:
    """window.cu's selection on (..., 384) band distances: lane l holds
    rows 128 g + 4 l + j (g < 3, j < 4), sorted ascending; the least head
    key is taken from every lane holding it until k keys are taken (above
    k = 192 the (385 - k)-th of the complemented keys)."""
    top = k > 192
    rank = 385 - k if top else k
    key = _wt_key(d2)
    if top:
        key = 0xFFFFFFFF - key
    lanes = key.reshape(*key.shape[:-1], 3, 32, 4).transpose(-3, -2)
    lanes = lanes.reshape(*key.shape[:-1], 32, 12).sort(dim=-1).values
    left = torch.full(key.shape[:-1], rank)
    kth = torch.zeros(key.shape[:-1], dtype=torch.long)
    for _ in range(rank):
        m = lanes[..., 0].amin(dim=-1)
        hit = lanes[..., 0] == m[..., None]
        fresh = left > 0
        left = left - hit.sum(dim=-1)
        kth = torch.where(fresh & (left <= 0), m, kth)
        popped = torch.cat([lanes[..., 1:], torch.full_like(lanes[..., :1], 0xFFFFFFFF)], -1)
        lanes = torch.where(hit[..., None], popped, lanes)
    if top:
        kth = 0xFFFFFFFF - kth
    return _wt_value(kth)


@pytest.mark.parametrize("k", [1, 20, 40, 100, 384])
def test_tau_selection_matches_plain(k):
    """The warp selection of each centre's k-th band distance, with
    multiplicity, on duplicated rows (every distance at least twice, many
    zero), bitwise ``window_tau_plain``'s kthvalue."""
    b, n, c = 2, 512, 6
    x = _cloud(b, n, c, "dup", seed=k)
    nb = n // TILE
    xb = x.reshape(b, nb, TILE, c)
    nbhd = torch.cat([xb.roll(1, dims=1), xb, xb.roll(-1, dims=1)], dim=2)
    sq = channel_sum(xb, xb)
    sqn = torch.cat([sq.roll(1, dims=1), sq, sq.roll(-1, dims=1)], dim=2)
    inner = channel_sum(xb[:, :, :, None], nbhd[:, :, None])
    d2 = ((sq[..., None] + sqn[:, :, None, :]) - 2.0 * inner).reshape(b, n, 3 * TILE)
    assert torch.equal(_tau_select(d2, k), window.window_tau_plain(x, k))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def test_box_term_matches_plain():
    """(x - clamp(x, lo, hi))^2, the kernel's term, bitwise the plain
    version's clamp(max(lo - x, x - hi), 0)^2 for every lo <= hi: x
    inside, on a face or outside, boxes of one point, +-0.0, subnormals,
    values near the float's range."""
    vals = torch.tensor([0.0, -0.0, 1e-45, -1e-45, 1e-39, -3e-39, 1.17549435e-38,
                         0.1, -0.1, 0.30000001, 1.0, -1.0, 1.0000001, 3.4e38,
                         -3.4e38, 1e20, -7.5e-20, 2.5])
    x, a, b = torch.meshgrid(vals, vals, vals, indexing="ij")
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    e = x - torch.minimum(torch.maximum(x, lo), hi)
    d = torch.clamp(torch.maximum(lo - x, x - hi), min=0.0)
    assert torch.equal(_bits(e * e), _bits(d * d))


def _keep_schedule(x, lo, hi, tau, T):
    """window.cu's block test on (B, N, C) x: blocks of threads of 128
    centres (one Morton block) x 64 blocks, each sum in channel order from
    0.0 by the clamp term; a block is kept for the key tile where any
    centre's sum is not above its tau (an integer OR over the tile's
    blocks of threads)."""
    B, N, C = x.shape
    nb = N // TILE
    xs = x.reshape(B, N // TILE, 1, TILE, C)
    ts = tau.reshape(B, N // TILE, 1, TILE)
    acc = torch.zeros(B, N // TILE, nb, TILE)
    for c in range(C):
        lc, hc = lo[:, None, :, None, c], hi[:, None, :, None, c]
        xc = xs[..., c]
        e = xc - torch.minimum(torch.maximum(xc, lc), hc)
        acc = acc + e * e
    hit = (~(acc > ts)).any(dim=-1)  # (B, N / 128, nb)
    return hit.reshape(B, N // T, T // TILE, nb).any(dim=2).to(torch.int32)


def _keep_inputs(x, k=20):
    """lo, hi and tau of prune_prepass on (B, N, C) x."""
    B, N, C = x.shape
    tau = window.raise_tau(x, window.window_tau_plain(x, k))
    xb = x.reshape(B, N // TILE, TILE, C)
    return xb.amin(dim=2), xb.amax(dim=2), tau


KEEP_SHAPES = [(2, 1024, 3, 128), (1, 2048, 40, 256), (3, 384, 5, 128), (1, 1024, 33, 1024)]


@pytest.mark.parametrize("shape", KEEP_SHAPES,
                         ids=[f"B{s[0]}-N{s[1]}-C{s[2]}-T{s[3]}" for s in KEEP_SHAPES])
def test_keep_schedule_matches_plain(shape):
    """The block test's schedule bitwise ``window_keep_plain`` on strand
    clouds (flags mixed), a tie
    (tau on a centre's lb2 keeps the block, the next float below prunes
    it) and a NaN tau (its tile keeps every block)."""
    b, n, c, t = shape
    x = torch.from_numpy(strand_clouds(11, b, n, c))
    lo, hi, tau = _keep_inputs(x)
    if t == n:
        tau[:, 100:] = -1.0
    want = window.window_keep_plain(x, lo, hi, tau, t)
    assert 0.05 <= float(want.float().mean()) <= 0.95
    assert torch.equal(_keep_schedule(x, lo, hi, tau, t), want)
    bk = n // TILE - 1
    d = torch.clamp(torch.maximum(lo[0, bk] - x[0, 0], x[0, 0] - hi[0, bk]), min=0.0)
    lb2 = d[0] * d[0]
    for ch in range(1, c):
        lb2 = lb2 + d[ch] * d[ch]
    for v, flag in ((lb2, 1), (torch.nextafter(lb2, torch.tensor(-1.0)), 0)):
        tie = tau.clone()
        tie[0, :t] = -1.0
        tie[0, 0] = v
        got = _keep_schedule(x, lo, hi, tie, t)
        assert torch.equal(got, window.window_keep_plain(x, lo, hi, tie, t))
        assert int(got[0, 0, bk]) == flag
    nan = tau.clone()
    nan[-1, 5] = float("nan")
    got = _keep_schedule(x, lo, hi, nan, t)
    assert torch.equal(got, window.window_keep_plain(x, lo, hi, nan, t))
    assert bool((got[-1, 0] == 1).all())
