"""Fast and approx mode on the legacy row-major trunk (``rounds_impl=
"round2"``, kernel B10b) against the JAX package on the CPU: the same
seeded numpy inputs through both.

Bitwise: the key tile T (``_auto_round_tile``), the 16-bit gather grid
(``pack_planes_fast`` and its decodes), the packed keys and round2's fixed
256-lane fold (``_packed_key``, ``_build_key``). The rounds run the Pallas
``sv_round2_first`` and ``sv_round2`` in interpret mode at N = 512 with
T = 128, 256 and 512 (approx folds 512 to 256 lanes) and at N = 1000 with
T = 8 (approx: L = 250). The Pallas kernels keep their ids inside, so the
ids are held to JAX's own selection on each key tile (``_neg_dist`` and
``_build_key`` of sv_round2.py, then the top k of the unique keys). The
two sides sum the distances in different orders (ROADMAP C8): the
neighbour sets must agree and at most 1 in 1,000 ids differ; outputs are
held to RTOL 1e-5 / ATOL 1e-6 on the centres whose ids agree. Round2
decodes the grid (``q * inv``) before the edge subtraction, which XLA
contracts into an FMA on the CPU (C19), so binary rounds use seeded
nonzero beta. Then both SV-DGCNN engines through the round2 trunk against
the JAX engines, and the refusals.

The engines against the JAX engines are in
tests/test_torch_round2_modes_engines.py.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnet_tpu.infer import _auto_round_tile
from svnet_tpu_torch import config
from svnet_tpu_torch.infer import ROUNDS, SVDGCNNClsEngine, SVDGCNNPsegEngine
from svnet_tpu_torch.models.sv_dgcnn import init_params, init_params_pseg
from svnet_tpu_torch.ops.kernels import quant
from svnet_tpu_torch.ops.kernels.fold import fold_first_params
from svnet_tpu_torch.ops.kernels.sv_round2 import sv_round2, sv_round2_first

# the module (the package's __init__ exports its function under its name)
jr2 = importlib.import_module("svnet_tpu.ops.pallas.sv_round2")

RTOL, ATOL = 1e-5, 1e-6  # the kernel tests' bar (tests/test_torch_fast.py)
ID_BAR = 1e-3  # ids that may differ (C8), on identical neighbour sets
B, K = 2, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's thread pool only competes with the other
    test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jnp_tree(folded):
    return {n: jnp.asarray(t.numpy()) for n, t in folded.items()}


def _with_beta(weights, seed):
    """Weights whose binarization offsets ("beta", 0 at init) are seeded
    and nonzero, as a trained model's are (C19; tests/test_torch_fast.py)."""
    gen = torch.Generator().manual_seed(seed)

    def walk(tree):
        return {n: walk(v) if isinstance(v, dict) else
                (0.3 * torch.randn(v.shape, generator=gen) if n == "beta" else v)
                for n, v in tree.items()}

    return dict(weights, params=walk(weights["params"]))


@functools.partial(jax.jit, static_argnames=("k", "T", "mode"))
def _tile_ids(xb, t, *, k, T, mode):
    """JAX's round2 selection for key tile t of one cloud xb (N, C): the
    tile's keys by the Pallas kernel's own helpers, their top k decoded
    into rows (the keys are unique, so this is the extraction's order)."""
    N = xb.shape[0]
    ctr = jax.lax.dynamic_slice_in_dim(xb, t * T, T)
    neg = jr2._neg_dist(ctr, xb, N, False)
    cols = jax.lax.broadcasted_iota(jnp.int32, (T, N), 1)
    top = jax.lax.top_k(jr2._build_key(neg, cols, N, mode), k)[0]
    ib = np.int32(1 << jr2._idx_bits(N))
    return (ib - 1) - jnp.remainder(top, ib)


def jax_ids(x, k, T, mode):
    """(B, N, C) -> JAX's (B, N, k) ids of ``mode`` on key tiles of T."""
    xj = jnp.asarray(x)
    N = x.shape[1]
    return np.stack([np.concatenate([
        np.asarray(_tile_ids(xj[b], t, k=k, T=T, mode=mode))
        for t in range(N // T)]) for b in range(x.shape[0])])


def check_round(got, want, ids, rtol=RTOL, atol=ATOL):
    """got (the port's (s, v, gate mean, ids (B, N, k))), want (the Pallas
    kernel's three outputs), ids (JAX's selection): the neighbour sets
    agree everywhere, at most ID_BAR of the ids differ, outputs within
    rtol/atol on the centres whose ids all agree, and the gate statistics
    where every centre of the cloud does."""
    tids = got[3].numpy()
    np.testing.assert_array_equal(np.sort(tids, axis=-1), np.sort(ids, axis=-1))
    assert (tids != ids).mean() <= ID_BAR, (tids != ids).mean()
    same = (tids == ids).all(axis=-1)  # (B, N)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy()[same], np.asarray(w)[same],
                                   rtol=rtol, atol=atol)
    whole = same.all(axis=1)
    np.testing.assert_allclose(got[2].numpy()[whole], np.asarray(want[2])[whole],
                               rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# tiles, grid, keys, fold: bitwise
# ---------------------------------------------------------------------------


def test_auto_round_tile_matches_jax():
    """T over a sweep of (N, tile, k, C, mode), odd N (T = 8 floor) too."""
    for n in (8, 40, 64, 100, 128, 200, 256, 512, 1000, 1001, 1024, 2048,
              4096, 8192, 16384, 65536):
        for tile in (8, 16, 64, 128, 256):
            for k, c in ((20, 3), (20, 64), (40, 136), (4, 62), (64, 127)):
                for mode in ("exact", "fast", "approx"):
                    want = _auto_round_tile(n, tile, k, c, mode)
                    assert quant.auto_round_tile(n, tile, k, c, mode) == want, (
                        n, tile, k, c, mode)
    assert quant.auto_round_tile(1024, 64) == _auto_round_tile(1024, 64) == 256


def test_grid16_matches_pack_planes_fast():
    """The 16-bit grid over all of (B, N), a zero channel included, bitwise
    the decoded planes of pack_planes_fast: neighbours (``_decode_fast``)
    and centres (``_decode_ctr_fast``) alike, whatever
    ``config.fast_gather_bits`` says."""
    C = 13
    x = _rand(1, B, 300, C) * np.linspace(0.01, 40.0, C, dtype=np.float32)
    x[..., 5] = 0.0
    planes, inv = jr2.pack_planes_fast(jnp.asarray(x))
    nbr = np.stack([np.asarray(jr2._decode_fast(planes[b].astype(jnp.int32),
                                                inv, C)) for b in range(B)])
    ctr = np.stack([np.asarray(jr2._decode_ctr_fast(planes[b], inv, C))
                    for b in range(B)])
    was = config.fast_gather_bits
    config.set_fast_gather_bits(8)
    try:
        got = quant.grid_rows(torch.from_numpy(x), "fast", 16).numpy()
    finally:
        config.set_fast_gather_bits(was)
    np.testing.assert_array_equal(got, nbr)
    np.testing.assert_array_equal(got, ctr)


@pytest.mark.parametrize("n,t", [(512, 128), (1000, 8), (16384, 8)],
                         ids=["N512", "N1000-L250", "N16384-15bit"])
def test_packed_keys_and_fold_match_jax(n, t):
    """One (T, N) block of neg: the fast keys bitwise ``_packed_key``'s
    (scale from the block's own worst distance; rounding's small positive
    distances and ties of q included) and the approx keys bitwise
    ``_build_key``'s fixed fold to 256 lanes (``fold_width(N, fold=
    APPROX_L2)``, whatever ``config.approx_fold`` says)."""
    neg = -np.abs(_rand(n, t, n)) * 7.0
    neg[::3, ::97] = np.float32(3e-3)  # q = floor(3e-3 * scale) > 0
    neg[:, 1::50] = neg[:, 0::50][:, : neg[:, 1::50].shape[1]]  # equal q
    cols = jax.lax.broadcasted_iota(jnp.int32, (t, n), 1)
    want_fast = np.asarray(jr2._packed_key(jnp.asarray(neg), cols, n))
    want_approx = np.asarray(jr2._build_key(jnp.asarray(neg), cols, n, "approx"))
    tneg = torch.from_numpy(neg)[None]  # (1, T centres, N)
    keys = quant.packed_keys(tneg, quant.tile_scales(tneg.amin(dim=-1), t, n), t)
    np.testing.assert_array_equal(keys[0].numpy(), want_fast)
    assert (want_fast >> quant.idx_bits(n) > 0).any()
    was = config.approx_fold
    config.set_approx_fold(64)
    try:
        L = quant.fold_width(n, fold=quant.APPROX_L2)
    finally:
        config.set_approx_fold(was)
    assert L == want_approx.shape[1]
    np.testing.assert_array_equal(quant.fold_keys(keys, L)[0].numpy(),
                                  want_approx)


# ---------------------------------------------------------------------------
# B10b fast and approx
# ---------------------------------------------------------------------------

# (mode, N, key tile T): each tile shape; approx folds at N = 512 (L = 256)
# and N = 1000 (L = 250)
CASES = [(mode, n, t) for mode in ("fast", "approx")
         for n, t in ((512, 128), (512, 256), (512, 512), (1000, 8))]
CASE_IDS = [f"{m}-N{n}-T{t}" for m, n, t in CASES]


@pytest.fixture(scope="module")
def cls_folded():
    """The classifier's folds, FP and binary (beta seeded), on the port's
    seeded weights: the rounds' inputs on both sides."""
    out = {}
    for binary in (False, True):
        w = init_params(10, K, binary, torch.Generator().manual_seed(3))
        eng = SVDGCNNClsEngine(_with_beta(w, 4) if binary else w, 10, K,
                               binary, device="cpu", rounds_impl="round2")
        out[binary] = eng
    return out


@pytest.mark.parametrize("mode,n,t", CASES, ids=CASE_IDS)
def test_round2_first_modes_match_jax(cls_folded, mode, n, t):
    folded = cls_folded[False].folded_first
    pts = _rand(n + t, 1, n, 3)
    want = jr2.sv_round2_first(jnp.asarray(pts), _jnp_tree(folded), S_out=32,
                               V_out=10, k=K, T=t, mode=mode, interpret=True)
    got = sv_round2_first(torch.from_numpy(pts), folded, S_out=32, V_out=10,
                          k=K, mode=mode, T=t, emit_wins=True)
    check_round(got, want, jax_ids(pts, K, t, mode))


@pytest.mark.parametrize("binary", [False, True], ids=["fp", "binary"])
@pytest.mark.parametrize("mode,n,t", CASES, ids=CASE_IDS)
def test_round2_modes_match_jax(cls_folded, mode, n, t, binary):
    eng = cls_folded[binary]
    name = "conv2" if binary else "conv3"
    S, V, S_out, V_out = ROUNDS[name]
    src = _rand(n + S + t, 1, n, S + 3 * V)
    want = jr2.sv_round2(jnp.asarray(src), _jnp_tree(eng.folded[name]), S=S,
                         V=V, S_out=S_out, V_out=V_out, k=K, T=t,
                         binary=binary, mode=mode, interpret=True)
    got = sv_round2(torch.from_numpy(src), eng.folded[name], S=S, V=V,
                    S_out=S_out, V_out=V_out, k=K, binary=binary, mode=mode,
                    T=t, emit_wins=True)
    check_round(got, want, jax_ids(src, K, t, mode))


def test_round2_approx_at_or_below_the_fold_is_fast():
    """N <= 256: nothing folds, approx is fast bitwise (ids included)."""
    eng = SVDGCNNClsEngine(init_params(10, K, True), 10, K, True, device="cpu",
                           rounds_impl="round2")
    S, V, S_out, V_out = ROUNDS["conv3"]
    src = torch.from_numpy(_rand(9, B, 256, S + 3 * V))
    kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=K, T=64, emit_wins=True)
    for a, b in zip(sv_round2(src, eng.folded["conv3"], mode="approx", **kw),
                    sv_round2(src, eng.folded["conv3"], mode="fast", **kw)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

N_ENG, K_ENG = 128, 4


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_round2_modes_refuse_what_jax_asserts():
    """A key tile that does not divide N, an odd fold width, k above the
    folded width (C20), N above the packed key's 2^20 rows, an unknown
    mode: ValueError; exact mode reads no key tile."""
    w = init_params(10, K, False, torch.Generator().manual_seed(0))
    folded = fold_first_params(w["params"]["init_scalar"], w["params"]["conv1"],
                               w["batch_stats"]["conv1"])
    kw = dict(S_out=32, V_out=10)
    with pytest.raises(ValueError, match="divide"):
        sv_round2_first(torch.zeros(1, 200, 3), folded, k=K, mode="fast", T=64,
                        **kw)
    with pytest.raises(ValueError, match="odd"):  # 514 halves to 257
        sv_round2_first(torch.zeros(1, 514, 3), folded, k=K, mode="approx",
                        T=514, **kw)
    with pytest.raises(ValueError, match="above the folded width"):
        sv_round2_first(torch.zeros(1, 512, 3), folded, k=260, mode="approx",
                        T=128, **kw)
    with pytest.raises(ValueError, match="2\\^20|1048576"):
        sv_round2_first(torch.empty(1, 1 << 21, 3), folded, k=K, mode="fast",
                        T=128, **kw)
    with pytest.raises(ValueError):
        sv_round2_first(torch.zeros(1, 64, 3), folded, k=K, mode="turbo", **kw)
    out = sv_round2_first(torch.from_numpy(_rand(0, 1, 40, 3)), folded, k=K,
                          T=64, **kw)  # exact: T ignored, as before
    assert out[0].shape == (1, 40, 32)


@pytest.mark.parametrize("engine", ["cls", "pseg"])
def test_engines_refuse_legacy_knobs(engine):
    """C23: on the round2 trunk fast mode reads no ``fast_gather_bits``
    and approx mode no ``approx_gather_bits`` or ``approx_fold``; a
    setting that would not act raises at construction. The defaults are
    taken, and round3 takes every setting."""
    if engine == "cls":
        make = functools.partial(SVDGCNNClsEngine, init_params(10, K_ENG, True),
                                 10, K_ENG, True, device="cpu")
    else:
        make = functools.partial(SVDGCNNPsegEngine,
                                 init_params_pseg(50, K_ENG, True), 50, K_ENG,
                                 True, device="cpu")
    impls = ("round2", "round", "edge") if engine == "pseg" else ("round2", "round")
    for impl in impls:
        for mode in ("fast", "approx"):
            make(mode=mode, rounds_impl=impl)
    for setter, value, mode in ((config.set_fast_gather_bits, 8, "fast"),
                                (config.set_approx_gather_bits, 8, "approx"),
                                (config.set_approx_fold, 512, "approx")):
        fast_was, gb_was, fold_was = (config.fast_gather_bits,
                                      config.approx_gather_bits,
                                      config.approx_fold)
        setter(value)
        try:
            for impl in impls:
                with pytest.raises(ValueError, match="C23"):
                    make(mode=mode, rounds_impl=impl)
            make(mode=mode)  # round3 acts on the knob
            make(mode="exact", rounds_impl="round2")
        finally:
            config.set_fast_gather_bits(fast_was)
            config.set_approx_gather_bits(gb_was)
            config.set_approx_fold(fold_was)
