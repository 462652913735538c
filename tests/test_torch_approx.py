"""Approx mode (B1, B2, the Morton entry sort and the engines that run them)
against the JAX package on the CPU: the same seeded numpy inputs through
both.

The Morton order, the fold width, the folded keys, the approx gather grid
and the key tile T are bitwise the JAX package's. The rounds run the JAX
Pallas kernels in interpret mode with ``mode="approx"`` at 16- and 8-bit
gathers, at N = 256 with fold 64 (four rows a residue class) and key
tiles T = 64 and 128, to fast mode's bars (tests/test_torch_fast.py: the
neighbour sets agree, at most 1 in 1,000 ids differ, outputs to f32
summation order). The engines run approx mode at N = 128 with fold 64.

The engines against the JAX engines are in
tests/test_torch_approx_engines.py.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnet_tpu import config as jconfig
from svnet_tpu.ops.pallas import sv_round3 as jr3
from svnet_tpu_torch import config
from svnet_tpu_torch.infer import ROUNDS, SVDGCNNClsEngine
from svnet_tpu_torch.models import sv_pointnet
from svnet_tpu_torch.models.sv_dgcnn import init_params
from svnet_tpu_torch.ops import morton
from svnet_tpu_torch.ops.kernels import quant
from svnet_tpu_torch.ops.kernels.fold import fold_first_params
from svnet_tpu_torch.ops.kernels.sv_round3 import sv_round3, sv_round3_first
from svnet_tpu_torch.ops.knn import knn_approx_plain, knn_fast_plain

from test_torch_fast import (
    CROSS_TOL,
    RTOL,
    ATOL,
    _check_round,
    _jnp_tree,
    _rand,
    _with_beta,
)

B, K = 2, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's thread pool only competes with the other
    test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _approx(fold=256, bits=16, fast_bits=16):
    """approx_fold, approx_gather_bits (and fast_gather_bits) set in both
    packages, put back after."""
    was = (config.approx_fold, config.approx_gather_bits, config.fast_gather_bits)
    jwas = (jconfig.approx_fold, jconfig.approx_gather_bits,
            jconfig.fast_gather_bits)
    for mod in (config, jconfig):
        mod.set_approx_fold(fold)
        mod.set_approx_gather_bits(bits)
        mod.set_fast_gather_bits(fast_bits)
    try:
        yield
    finally:
        for mod, (f, b, fb) in ((config, was), (jconfig, jwas)):
            mod.set_approx_fold(f)
            mod.set_approx_gather_bits(b)
            mod.set_fast_gather_bits(fb)


# ---------------------------------------------------------------------------
# Morton order, fold, grid, tiles: bitwise
# ---------------------------------------------------------------------------


def test_morton_order_matches_jax():
    """Seeded clouds with duplicated points (equal codes keep their input
    order: a stable sort), a flat axis (hi = lo) and a cloud of one point
    repeated; ``sort_points`` and ``unsort`` undo each other."""
    pts = _rand(0, 4, 300, 3) * np.float32([1.0, 3.0, 0.2])
    pts[0, 100:150] = pts[0, 0:50]  # duplicates
    pts[1, :, 2] = 0.5  # a flat axis
    pts[2] = pts[2, 7]  # every point the same
    pts[3, ::3] = np.round(pts[3, ::3], 1)  # near-equal codes
    want = np.asarray(jr3.morton_order(jnp.asarray(pts)))
    got = morton.morton_order(torch.from_numpy(pts))
    np.testing.assert_array_equal(got.numpy(), want)
    x = torch.from_numpy(pts)
    xs, order = morton.sort_points(x)
    assert torch.equal(xs, x[torch.arange(4)[:, None], order])
    assert torch.equal(morton.unsort(xs, order), x)


@pytest.mark.parametrize("n,fold,t", [(256, 64, 64), (512, 256, 128),
                                      (1000, 256, 200)],
                         ids=["N256-L64", "N512-L256", "N1000-L250"])
def test_fold_matches_jax(n, fold, t):
    """The fold width and the folded keys of one (N, T) block bitwise
    ``_build_key_t(mode="approx")``'s; the winners' rows are distinct and
    each the best of its residue class."""
    neg = -np.abs(_rand(n, n, t)) * 7.0
    neg[::97, ::5] = np.float32(3e-3)  # q > 0
    rows = jnp.arange(n, dtype=jnp.int32)[:, None]
    with _approx(fold):
        want = np.asarray(jr3._build_key_t(jnp.asarray(neg), rows, n, "approx"))
        L = quant.fold_width(n)
        tneg = torch.from_numpy(neg.T.copy())[None]  # (1, T centres, N)
        scale = quant.tile_scales(tneg.amin(dim=-1), t, n)
        keys = quant.packed_keys(tneg, scale, t)
        got = quant.fold_keys(keys, L)[0].numpy().T
    assert want.shape == (L, t)
    np.testing.assert_array_equal(got, want)
    won = quant.key_rows(torch.from_numpy(got), n).numpy()
    assert (won % L == np.arange(L)[:, None]).all()


@pytest.mark.parametrize("bits", [16, 8], ids=["gb16", "gb8"])
def test_approx_grid_and_tiles_match_jax(bits):
    """Approx mode's grid and key tile T follow ``approx_gather_bits``, not
    ``fast_gather_bits`` (set to the other width here), as ``_gb8`` and
    ``_round3_tiles`` do."""
    x = _rand(1, B, 13, 300) * np.linspace(0.01, 40.0, 13, dtype=np.float32)[:, None]
    with _approx(bits=bits, fast_bits=24 - bits):
        assert quant.gb8("approx") == jr3._gb8("approx") == (bits == 8)
        assert quant.gb8("fast") == jr3._gb8("fast") == (bits == 16)
        pack = jr3.pack_planes_q8_t if bits == 8 else jr3.pack_planes_fast_t
        decode = jr3._decode_q8_t if bits == 8 else jr3._decode_fast_t
        planes, inv = pack(jnp.asarray(x))
        want = np.stack([np.asarray(decode(planes[b].astype(jnp.int32), inv, 13))
                         for b in range(B)])
        got = quant.grid_rows(torch.from_numpy(x).transpose(1, 2), "approx")
        np.testing.assert_array_equal(got.numpy().transpose(0, 2, 1), want)
        for n in (128, 256, 1000, 1024, 2048, 4096, 8192):
            for s, v in ((0, 1), (32, 10), (64, 21), (128, 42), (64, 24)):
                c = s + 3 * v if s else 3
                want_t = jr3._round3_tiles(n, 20, c, s, v, 64, 21, "approx")[0]
                assert quant.round3_tiles(n, c, "approx") == want_t, (n, c)


def test_knn_approx_plain_is_fast_without_a_fold():
    """L >= N folds nothing: approx ids equal fast ids; below, each winner
    is the best of its class and the ids are distinct."""
    x = torch.from_numpy(_rand(3, B, 256, 7))
    with _approx(fold=256):
        assert torch.equal(knn_approx_plain(x, K, 64), knn_fast_plain(x, K, 64))
    with _approx(fold=64):
        ids = knn_approx_plain(x, 40, 64)
    assert ((ids % 64).sort(dim=-1).values.diff(dim=-1) > 0).all()


# ---------------------------------------------------------------------------
# B1 and B2 in approx mode
# ---------------------------------------------------------------------------

# (gather bits, key tile T, cross, V_out): both tiles, both bits, each
# instantiation at N = 256 with fold 64
FIRST_CASES = [(16, 64, False, 10), (16, 128, True, 16), (8, 128, False, 16),
               (8, 64, True, 10)]


@pytest.mark.parametrize("bits,t,cross,v_out", FIRST_CASES, ids=[
    f"gb{b}-T{t}-{'cross' if c else 'xyz'}-v{v}" for b, t, c, v in FIRST_CASES])
def test_round3_first_approx_matches_jax(bits, t, cross, v_out):
    gen = torch.Generator().manual_seed(t + v_out)
    if cross:  # SV-PointNet's first round
        w = sv_pointnet.init_params(10, K, False, gen)
        p, bs = w["params"]["feat"], w["batch_stats"]["feat"]
        folded = fold_first_params(p["init_scalar"], p["conv_pos"],
                                   bs["conv_pos"], n_ch=3)
    else:
        w = init_params(10, K, False, gen)
        folded = fold_first_params(w["params"]["init_scalar"],
                                   w["params"]["conv1"], w["batch_stats"]["conv1"])
    if v_out == 16:  # a wider linear2, as SV_DGCNN_PSEG's conv1
        g = torch.Generator().manual_seed(v_out)
        folded = dict(folded, **{name: torch.randn(folded[name].shape[0], 16,
                                                   generator=g)
                                 for name in ("w2", "a2", "b2")})
    pts = _rand(t + bits, B, 256, 3)
    with _approx(fold=64, bits=bits):
        want = jr3.sv_round3_first(jnp.asarray(pts), _jnp_tree(folded), S_out=32,
                                   V_out=v_out, k=K, T=t, mode="approx",
                                   cross=cross, interpret=True, emit_wins=True,
                                   cm=True)
        got = sv_round3_first(torch.from_numpy(pts), folded, S_out=32,
                              V_out=v_out, k=K, cross=cross, mode="approx", T=t,
                              emit_wins=True)
    _check_round(got, want, *(CROSS_TOL if cross else (RTOL, ATOL)))
    assert (got[3] % 64).sort(dim=1).values.diff(dim=1).ne(0).all()


@pytest.fixture(scope="module", params=[False, True], ids=["fp", "binary"])
def conv_weights(request):
    binary = request.param
    w = init_params(10, K, binary, torch.Generator().manual_seed(3))
    eng = SVDGCNNClsEngine(_with_beta(w, 4) if binary else w, 10, K, binary,
                           device="cpu")
    return binary, eng.folded


# (gather bits, round, key tile T)
CONV_CASES = [(16, "conv2", 64), (8, "conv4", 128)]


@pytest.mark.parametrize("bits,name,t", CONV_CASES, ids=[
    f"gb{b}-{name}-T{t}" for b, name, t in CONV_CASES])
def test_round3_approx_matches_jax(conv_weights, bits, name, t):
    binary, folded = conv_weights
    S, V, S_out, V_out = ROUNDS[name]
    src = _rand(t + S, B, S + 3 * V, 256)
    with _approx(fold=64, bits=bits):
        want = jr3.sv_round3(jnp.asarray(src), _jnp_tree(folded[name]), S=S,
                             V=V, S_out=S_out, V_out=V_out, k=K, T=t,
                             binary=binary, mode="approx", interpret=True,
                             emit_wins=True, cm=True)
        got = sv_round3(torch.from_numpy(src), folded[name], S=S, V=V,
                        S_out=S_out, V_out=V_out, k=K, binary=binary,
                        mode="approx", T=t, emit_wins=True)
    _check_round(got, want)


def test_approx_refusals():
    """k above the folded width, a width that halves to an odd number,
    approx knobs on the legacy trunks and the edge trunk (which fold at a
    fixed 256 or select exactly, and gather at 16 bits or bf16; C23) and
    knobs out of range raise, while approx mode itself is taken on the
    edge trunk; a cloud at or below the fold is fast mode's round
    bitwise."""
    w = init_params(10, K, False, torch.Generator().manual_seed(0))
    folded = fold_first_params(w["params"]["init_scalar"], w["params"]["conv1"],
                               w["batch_stats"]["conv1"])
    kw = dict(S_out=32, V_out=10, mode="approx")
    with _approx(fold=64):
        with pytest.raises(ValueError):  # L = 64 < k
            sv_round3_first(torch.zeros(1, 256, 3), folded, k=65, T=64, **kw)
        with pytest.raises(ValueError):
            knn_approx_plain(torch.zeros(1, 256, 3), 65, 64)
        with pytest.raises(ValueError):  # 300 -> 150 -> 75, odd
            quant.fold_width(300)
        with pytest.raises(ValueError):
            sv_round3_first(torch.zeros(1, 300, 3), folded, k=K, T=300, **kw)
        assert quant.fold_width(64) == 64 and quant.fold_width(1024) == 64
    for impl in ("round2", "round", "edge"):
        for knobs in (dict(fold=64), dict(bits=8)):
            with _approx(**knobs), pytest.raises(ValueError):
                SVDGCNNClsEngine(w, 10, K, False, mode="approx", device="cpu",
                                 rounds_impl=impl)
    assert SVDGCNNClsEngine(w, 10, K, False, mode="approx", device="cpu",
                            rounds_impl="edge").mode == "approx"
    for bad in (62, 65, 0):
        with pytest.raises(ValueError):
            config.set_approx_fold(bad)
    with pytest.raises(ValueError):
        config.set_approx_gather_bits(12)
    pts = torch.from_numpy(_rand(9, B, 200, 3))
    assert all(torch.equal(a, f) for a, f in zip(
        sv_round3_first(pts, folded, k=K, emit_wins=True, **kw),
        sv_round3_first(pts, folded, k=K, emit_wins=True, S_out=32, V_out=10,
                        mode="fast")))


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

N_ENG, K_ENG = 128, 4


def test_morton_entry_sorts_in_exact_mode():
    """``config.morton_entry`` sorts the SV-DGCNN classifier's cloud in
    exact mode too: the logits equal those of the pre-sorted cloud."""
    weights = init_params(10, K_ENG, False, torch.Generator().manual_seed(4))
    eng = SVDGCNNClsEngine(weights, 10, K_ENG, False, device="cpu")
    pts = torch.from_numpy(_rand(10, B, N_ENG, 3))
    pre, _ = morton.sort_points(pts)
    was = config.morton_entry
    config.set_morton_entry(True)
    try:
        assert torch.equal(eng(pts), eng(pre))
        assert eng._entry_sort(pts)[1] is not None
    finally:
        config.set_morton_entry(was)
    assert eng._entry_sort(pts)[1] is None
