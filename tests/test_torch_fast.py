"""Fast mode (B1, B2 and the engines that run them) against the JAX package
on the CPU: the same seeded numpy inputs through both.

The gather grids, the packed keys and the key tile T are bitwise the JAX
package's. The rounds run the JAX Pallas kernels in interpret mode with
``mode="fast"`` at 16- and 8-bit gathers, at several key tiles a cloud
(T = 64 and 128 at N = 256) and at N = 200, where no tile divides N and
T = N. The two sides sum the distances in different orders (ROADMAP C8),
so a distance near a quantization step can land in the next bucket: the
neighbour sets must agree and at most 1 in 1,000 ids differ; outputs are
held to f32 summation order on the centres whose neighbour sets agree.

The engines against the JAX engines are in
tests/test_torch_fast_engines.py.
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
from svnet_tpu_torch.ops.kernels import quant
from svnet_tpu_torch.ops.kernels.fold import fold_first_params
from svnet_tpu_torch.ops.kernels.sv_round3 import sv_round3, sv_round3_first


RTOL, ATOL = 1e-5, 1e-6  # the kernel tests' bar (tests/test_torch_kernels.py)
CROSS_TOL = 1e-4, 1e-5  # B1 cross's (tests/test_torch_pointnet.py)
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


@pytest.fixture(params=[16, 8], ids=["gb16", "gb8"])
def bits(request):
    """The gather grid's bits, set in both packages and put back after."""
    with _gather_bits(request.param):
        yield request.param


@contextlib.contextmanager
def _gather_bits(bits):
    was, jwas = config.fast_gather_bits, jconfig.fast_gather_bits
    config.set_fast_gather_bits(bits)
    jconfig.set_fast_gather_bits(bits)
    try:
        yield
    finally:
        config.set_fast_gather_bits(was)
        jconfig.set_fast_gather_bits(jwas)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jnp_tree(folded):
    return {n: jnp.asarray(t.numpy()) for n, t in folded.items()}


def _check_round(got, want, rtol=RTOL, atol=ATOL):
    """got (port, (B, C, N) outputs and (B, k, N) ids), want (JAX): the
    neighbour sets agree everywhere, at most ID_BAR of the ids differ,
    outputs within rtol/atol on the centres whose ids all agree and the
    gate statistics where every centre of the cloud does."""
    ids, jids = got[3].numpy(), np.asarray(want[3])
    np.testing.assert_array_equal(np.sort(ids, axis=1), np.sort(jids, axis=1))
    same = (ids == jids).all(axis=1)  # (B, N)
    assert (ids != jids).mean() <= ID_BAR, (ids != jids).mean()
    for g, w in zip(got[:2], want[:2]):
        g, w = g.numpy().transpose(0, 2, 1), np.asarray(w).transpose(0, 2, 1)
        np.testing.assert_allclose(g[same], w[same], rtol=rtol, atol=atol)
    whole = same.all(axis=1)
    np.testing.assert_allclose(got[2].numpy()[whole], np.asarray(want[2])[whole],
                               rtol=rtol, atol=atol)


def _with_beta(weights, seed):
    """Weights whose binarization offsets (every linear's "beta", 0 at
    init) are seeded and nonzero, as a trained model's are. The JAX
    package on the CPU does not cancel a fast-mode self-edge exactly
    (XLA contracts the grid's decode into the edge's subtraction, an FMA,
    leaving the product's rounding error; ROADMAP C19), and at beta = 0
    the sign of that residue is +-1 where the port's, and the kernel's
    stated semantics, is 0: see test_round3_fast_self_edges_cancel."""
    gen = torch.Generator().manual_seed(seed)

    def walk(tree):
        return {n: walk(v) if isinstance(v, dict) else
                (0.3 * torch.randn(v.shape, generator=gen) if n == "beta" else v)
                for n, v in tree.items()}

    return dict(weights, params=walk(weights["params"]))


# ---------------------------------------------------------------------------
# grids, keys, tiles: bitwise
# ---------------------------------------------------------------------------


def test_gather_grid_matches_jax(bits):
    """Codes and decoded rows of the gather grid, a zero channel included,
    bitwise the decoded planes of pack_planes_fast_t / pack_planes_q8_t."""
    x = _rand(1, B, 13, 300) * np.linspace(0.01, 40.0, 13, dtype=np.float32)[:, None]
    x[:, 5] = 0.0
    if bits == 16:
        planes, inv = jr3.pack_planes_fast_t(jnp.asarray(x))
        decode = jr3._decode_fast_t
    else:
        planes, inv = jr3.pack_planes_q8_t(jnp.asarray(x))
        decode = jr3._decode_q8_t
    want = np.stack([np.asarray(decode(planes[b].astype(jnp.int32), inv, 13))
                     for b in range(B)])
    rows = torch.from_numpy(x).transpose(1, 2)
    q, tinv = quant.grid_codes(rows, bits)
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(inv)[:, 0])
    np.testing.assert_array_equal(q.numpy().transpose(0, 2, 1) * np.asarray(inv),
                                  want)
    got = quant.grid_rows(rows).numpy().transpose(0, 2, 1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,t", [(256, 64), (1000, 1000), (10000, 32)],
                         ids=["13bit", "T=N", "14bit"])
def test_packed_keys_match_jax(n, t):
    """The packed keys of one (N, T) block of ``neg`` bitwise
    ``_packed_key_t``'s, with rounding's small positive distances kept
    positive (q > 0) and ties of q broken by the row."""
    neg = -np.abs(_rand(n, n, t)) * 7.0
    neg[::97, ::5] = np.float32(3e-3)  # q = floor(3e-3 * scale) > 0
    neg[1::50, :] = neg[0::50, :][: neg[1::50, :].shape[0]]  # equal q
    rows = jnp.arange(n, dtype=jnp.int32)[:, None]
    want = np.asarray(jr3._packed_key_t(jnp.asarray(neg), rows, n))
    tneg = torch.from_numpy(neg.T.copy())[None]  # (1, T centres, N)
    scale = quant.tile_scales(tneg.amin(dim=-1), t, n)
    got = quant.packed_keys(tneg, scale, t)[0].numpy().T
    np.testing.assert_array_equal(got, want)
    assert (got >> quant.idx_bits(n) > 0).any()
    np.testing.assert_array_equal(quant.key_rows(torch.from_numpy(got), n).numpy(),
                                  np.broadcast_to(np.arange(n)[:, None], (n, t)))


def test_round3_tiles_match_jax(bits):
    """T over a grid of shapes, both modes (exact's four planes too)."""
    for n in (40, 128, 200, 256, 1000, 1001, 1024, 2048, 4096, 8192, 16384):
        for s, v in ((0, 1), (32, 10), (64, 21), (128, 42), (64, 24)):
            c = s + 3 * v if s else 3
            for mode in ("exact", "fast"):
                want = jr3._round3_tiles(n, 20, c, s, v, 64, 21, mode)[0]
                assert quant.round3_tiles(n, c, mode) == want, (n, c, mode)


# ---------------------------------------------------------------------------
# B1 and B2 in fast mode
# ---------------------------------------------------------------------------

# (gather bits, N, key tile T (None: the heuristic's, T = N at N = 200),
# cross, V_out): each instantiation and each key-tile shape at both bits
FIRST_CASES = [(16, 256, 64, False, 10), (16, 256, 128, True, 10),
               (16, 200, None, False, 16), (16, 256, 64, True, 16),
               (8, 256, 64, True, 10), (8, 256, 128, False, 16),
               (8, 200, None, True, 16), (8, 256, 128, False, 10)]


@pytest.mark.parametrize("bits,n,t,cross,v_out", FIRST_CASES, ids=[
    f"gb{b}-N{n}-T{t or n}-{'cross' if c else 'xyz'}-v{v}"
    for b, n, t, c, v in FIRST_CASES])
def test_round3_first_fast_matches_jax(bits, n, t, cross, v_out):
    with _gather_bits(bits):
        _first_case(n, t, cross, v_out)


def _first_case(n, t, cross, v_out):
    gen = torch.Generator().manual_seed(n + v_out)
    if cross:  # SV-PointNet's first round
        w = sv_pointnet.init_params(10, K, False, gen)
        p, bs = w["params"]["feat"], w["batch_stats"]["feat"]
        folded = fold_first_params(p["init_scalar"], p["conv_pos"],
                                   bs["conv_pos"], n_ch=3)
    else:
        w = init_params(10, K, False, gen)
        p, bs = w["params"], w["batch_stats"]
        folded = fold_first_params(p["init_scalar"], p["conv1"], bs["conv1"])
    if v_out == 16:  # a wider linear2, as SV_DGCNN_PSEG's conv1
        g = torch.Generator().manual_seed(v_out)
        folded = dict(folded, **{name: torch.randn(folded[name].shape[0], 16,
                                                   generator=g)
                                 for name in ("w2", "a2", "b2")})
    pts = _rand(n + t if t else n, B, n, 3)
    want = jr3.sv_round3_first(jnp.asarray(pts), _jnp_tree(folded), S_out=32,
                               V_out=v_out, k=K, T=t or 0, mode="fast",
                               cross=cross, interpret=True, emit_wins=True,
                               cm=True)
    got = sv_round3_first(torch.from_numpy(pts), folded, S_out=32,
                          V_out=v_out, k=K, cross=cross, mode="fast", T=t,
                          emit_wins=True)
    _check_round(got, want, *(CROSS_TOL if cross else (RTOL, ATOL)))


@pytest.fixture(scope="module", params=[False, True], ids=["fp", "binary"])
def conv_weights(request):
    binary = request.param
    w = init_params(10, K, binary, torch.Generator().manual_seed(3))
    eng = SVDGCNNClsEngine(_with_beta(w, 4) if binary else w, 10, K, binary,
                           device="cpu")
    return binary, eng.folded


# (gather bits, round, N, key tile T): each shape at both bits
CONV_CASES = [(16, "conv2", 256, 64), (16, "conv4", 256, 128),
              (16, "conv2", 200, None), (8, "conv4", 256, 64),
              (8, "conv2", 256, 128), (8, "conv4", 200, None)]


@pytest.mark.parametrize("bits,name,n,t", CONV_CASES, ids=[
    f"gb{b}-{name}-N{n}-T{t or n}" for b, name, n, t in CONV_CASES])
def test_round3_fast_matches_jax(conv_weights, bits, name, n, t):
    with _gather_bits(bits):
        _conv_case(*conv_weights, name, n, t)


def _conv_case(binary, folded, name, n, t):
    S, V, S_out, V_out = ROUNDS[name]
    src = _rand(n + S, B, S + 3 * V, n)
    want = jr3.sv_round3(jnp.asarray(src), _jnp_tree(folded[name]), S=S, V=V,
                         S_out=S_out, V_out=V_out, k=K, T=t or 0,
                         binary=binary, mode="fast", interpret=True,
                         emit_wins=True, cm=True)
    got = sv_round3(torch.from_numpy(src), folded[name], S=S, V=V,
                    S_out=S_out, V_out=V_out, k=K, binary=binary, mode="fast",
                    T=t, emit_wins=True)
    _check_round(got, want)


@pytest.mark.parametrize("name", ["conv2", "conv4"])
def test_round3_fast_self_edges_cancel(name):
    """Binary, beta = 0 (as initialised): the port's fast round is the JAX
    package's exact round on the grid's rows with the fast ids fed in
    (``wins_in``: bit-exact gathers, no FMA between decode and edge), so
    every self-edge cancels exactly, as the fast kernel's semantics say."""
    S, V, S_out, V_out = ROUNDS[name]
    eng = SVDGCNNClsEngine(init_params(10, K, True,
                                       torch.Generator().manual_seed(5)),
                           10, K, True, device="cpu")
    folded = eng.folded[name]
    assert not folded["beta"].any()
    src = torch.from_numpy(_rand(S, B, S + 3 * V, 256))
    got = sv_round3(src, folded, S=S, V=V, S_out=S_out, V_out=V_out, k=K,
                    mode="fast", T=64, emit_wins=True)
    rows_q = quant.grid_rows(src.transpose(1, 2)).transpose(1, 2)
    want = jr3.sv_round3(jnp.asarray(rows_q.numpy()), _jnp_tree(folded), S=S,
                         V=V, S_out=S_out, V_out=V_out, k=K, binary=True,
                         mode="exact", interpret=True, cm=True,
                         wins_in=jnp.asarray(got[3].numpy()))
    for g, w in zip(got[:3], want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def test_fast_rounds_check_arguments():
    """A key tile that does not divide N, and modes not ported, raise."""
    w = init_params(10, K, False, torch.Generator().manual_seed(0))
    folded = fold_first_params(w["params"]["init_scalar"], w["params"]["conv1"],
                               w["batch_stats"]["conv1"])
    pts = torch.zeros(1, 200, 3)
    with pytest.raises(ValueError):
        sv_round3_first(pts, folded, S_out=32, V_out=10, k=K, mode="fast", T=64)
    with pytest.raises(ValueError):
        sv_round3_first(pts, folded, S_out=32, V_out=10, k=K, mode="turbo")
    with pytest.raises(ValueError):
        config.set_fast_gather_bits(4)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

N_ENG, K_ENG = 128, 4
