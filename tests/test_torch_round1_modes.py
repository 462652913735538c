"""The classifier's round-1 trunk (``rounds_impl="round"``, kernel B10a) in
its fast variant (``exact=False``; the engine's fast and approx modes)
against the JAX package on the CPU: the same seeded numpy inputs through
both.

Bitwise: the bf16 gather (``astype(bfloat16)`` read back in f32) and the
packed key, which at N <= 8192 is round2's fast key (sv_round.py:85-97
against sv_round2.py:197-210). The rounds run the Pallas
``sv_round_first`` and ``sv_round`` in interpret mode at N = 256 (T = 64)
and N = 1000 (T = 8); their ids stay inside the kernels, so the ids are
held to JAX's own selection on each key tile (tests/
test_torch_round2_modes.py::jax_ids, fast mode) to C8's bar, and the
outputs to RTOL 1e-5 / ATOL 1e-6 on the centres whose ids agree. The bf16
gather has no multiply, so a self-edge cancels on both sides: binary
rounds run at beta = 0 as well as seeded. Then the classifier's round
trunk in fast and approx mode against the JAX engine, and the refusals.

The round trunk against the JAX engine is in
tests/test_torch_round1_modes_engines.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnet_tpu_torch import config
from svnet_tpu_torch.infer import ROUNDS, SVDGCNNClsEngine
from svnet_tpu_torch.models import sv_pointnet
from svnet_tpu_torch.models.sv_dgcnn import init_params
from svnet_tpu_torch.ops.kernels import quant
from svnet_tpu_torch.ops.kernels.fold import fold_first_params
from svnet_tpu_torch.ops.kernels.sv_round import sv_round, sv_round_first
from svnet_tpu_torch.ops.kernels.sv_round3 import conv_round_rows, first_round_rows

from test_torch_round2_modes import _jnp_tree, _with_beta, check_round, jax_ids

# the modules (the package's __init__ exports their functions by name)
jr1 = importlib.import_module("svnet_tpu.ops.pallas.sv_round")
jr2 = importlib.import_module("svnet_tpu.ops.pallas.sv_round2")

B, K, CLASSES = 2, 8, 10
CROSS_TOL = 1e-4, 1e-5  # B1 cross's (tests/test_torch_pointnet.py)


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


# ---------------------------------------------------------------------------
# the grid and the key: bitwise
# ---------------------------------------------------------------------------


def test_bf16_rows_match_jax():
    """bf16_rows bitwise ``astype(bfloat16).astype(float32)``: values at
    and beside the halfway points of bf16 (ties to even), signed zeros,
    subnormals, large values."""
    x = _rand(0, 4, 257, 7) * np.float32(30.0)
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -7)  # bf16's spacing at 1
    x[0, :6, 0] = [one + ulp / 2, one + 3 * ulp / 2, -(one + ulp / 2),
                   np.nextafter(one + ulp / 2, np.float32(2)), -0.0, 1e-40]
    x[1, :3, 1] = [3.4e38, -3.4e38, 1.17e-38]
    want = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    got = quant.bf16_rows(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert quant.grid_rows(torch.from_numpy(x), "fast", "bf16").equal(
        torch.from_numpy(want))


@pytest.mark.parametrize("n,t", [(256, 64), (1000, 8), (8192, 8)])
def test_round1_key_is_round2_fast_key(n, t):
    """sv_round.py's key ``q * 8192 + (8191 - col)``, q on the 18-bit scale
    of the (T, N) block's worst distance (sv_round.py:85-97, written out
    here in jnp), equals round2's ``_packed_key`` and the port's
    ``packed_keys`` at N <= 8192 (13 column bits)."""
    neg = -np.abs(_rand(n, t, n)) * 5.0
    neg[::2, ::31] = np.float32(2e-3)  # q > 0 after rounding
    cols = jax.lax.broadcasted_iota(jnp.int32, (t, n), 1)
    jneg = jnp.asarray(neg)
    scale = jnp.float32(-(1 << 18)) / jnp.minimum(jnp.min(jneg), -1e-12)
    q = jnp.maximum(jnp.floor(jneg * scale).astype(jnp.int32),
                    jnp.int32(-(1 << 18) + 1))
    want = np.asarray(q * 8192 + (8191 - cols))
    np.testing.assert_array_equal(np.asarray(jr2._packed_key(jneg, cols, n)), want)
    tneg = torch.from_numpy(neg)[None]
    got = quant.packed_keys(tneg, quant.tile_scales(tneg.amin(dim=-1), t, n), t)
    np.testing.assert_array_equal(got[0].numpy(), want)


# ---------------------------------------------------------------------------
# B10a, exact=False
# ---------------------------------------------------------------------------

# (N, key tile T)
SHAPES = [(256, 64), (1000, 8)]


@pytest.mark.parametrize("cross", [False, True], ids=["xyz", "cross"])
@pytest.mark.parametrize("n,t", SHAPES, ids=[f"N{n}-T{t}" for n, t in SHAPES])
def test_round_first_fast_matches_jax(n, t, cross):
    """B10a's first round, two edge channels (SV-DGCNN's conv1) and three
    with the cross product (SV-PointNet's conv_pos)."""
    if cross:
        w = sv_pointnet.init_params(CLASSES, K, False,
                                    torch.Generator().manual_seed(5))
        enc, enc_bs = w["params"]["feat"], w["batch_stats"]["feat"]
        folded = fold_first_params(enc["init_scalar"], enc["conv_pos"],
                                   enc_bs["conv_pos"], n_ch=3)
    else:
        w = init_params(CLASSES, K, False, torch.Generator().manual_seed(3))
        folded = fold_first_params(w["params"]["init_scalar"],
                                   w["params"]["conv1"], w["batch_stats"]["conv1"])
    pts = _rand(n + t, 1, n, 3)
    want = jr1.sv_round_first(jnp.asarray(pts), _jnp_tree(folded), S_out=32,
                              V_out=10, k=K, T=t, exact=False, cross=cross,
                              interpret=True)
    got = sv_round_first(torch.from_numpy(pts), folded, S_out=32, V_out=10,
                         k=K, cross=cross, exact=False, T=t)
    rows = first_round_rows(torch.from_numpy(pts), folded, S_out=32,
                            V_out=10, k=K, cross=cross, T=t, mode="fast",
                            grid="bf16")
    for a, b in zip(got, rows[:3]):  # the wrapper's core, which has the ids
        assert torch.equal(a, b)
    check_round(rows, want, jax_ids(pts, K, t, "fast"),
                *(CROSS_TOL if cross else (1e-5, 1e-6)))


@pytest.fixture(scope="module")
def engines():
    """Port engines (FP; binary with beta seeded and at beta = 0) on the
    port's seeded weights: their folds are the rounds' inputs on both
    sides."""
    w = {b: init_params(CLASSES, K, b, torch.Generator().manual_seed(3))
         for b in (False, True)}
    return {name: SVDGCNNClsEngine(weights, CLASSES, K, binary, device="cpu",
                                   rounds_impl="round")
            for name, binary, weights in (("fp", False, w[False]),
                                          ("binary", True, _with_beta(w[True], 4)),
                                          ("binary-beta0", True, w[True]))}


@pytest.mark.parametrize("kind", ["fp", "binary", "binary-beta0"])
@pytest.mark.parametrize("n,t", SHAPES, ids=[f"N{n}-T{t}" for n, t in SHAPES])
def test_round_fast_matches_jax(engines, n, t, kind):
    """B10a's conv round (conv2's widths binary, conv3's FP)."""
    eng = engines[kind]
    name = "conv3" if kind == "fp" else "conv2"
    S, V, S_out, V_out = ROUNDS[name]
    if kind == "binary-beta0":
        assert not eng.folded[name]["beta"].any()
    src = _rand(n + S + t, 1, n, S + 3 * V)
    kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=K, binary=eng.binary)
    want = jr1.sv_round(jnp.asarray(src), _jnp_tree(eng.folded[name]), T=t,
                        exact=False, interpret=True, **kw)
    got = sv_round(torch.from_numpy(src), eng.folded[name], exact=False, T=t,
                   **kw)
    rows = conv_round_rows(torch.from_numpy(src), eng.folded[name], T=t,
                           mode="fast", grid="bf16", **kw)
    for a, b in zip(got, rows[:3]):
        assert torch.equal(a, b)
    check_round(rows, want, jax_ids(src, K, t, "fast"))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_round_fast_refuses_what_jax_cannot_key():
    """exact=False above 8192 rows (the key's 13 column bits; JAX asserts
    in ``sv_round`` and corrupts its first round's keys) and a key tile
    that does not divide N raise in both wrappers; the classifier's edge
    trunk takes fast and approx mode (tests/test_torch_edge_modes.py) but
    refuses a knob that would not act there (C23)."""
    eng = SVDGCNNClsEngine(init_params(CLASSES, K, True), CLASSES, K, True,
                           device="cpu", rounds_impl="round")
    S, V, S_out, V_out = ROUNDS["conv2"]
    kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=K, exact=False)
    for n, t, match in ((8200, 8, "8192"), (200, 64, "divide")):
        with pytest.raises(ValueError, match=match):
            sv_round_first(torch.zeros(1, n, 3), eng.folded_first, S_out=32,
                           V_out=10, k=K, exact=False, T=t)
        with pytest.raises(ValueError, match=match):
            sv_round(torch.zeros(1, n, S + 3 * V), eng.folded["conv2"], T=t,
                     **kw)
    for mode in ("fast", "approx"):
        edge = SVDGCNNClsEngine(init_params(CLASSES, K, True), CLASSES, K,
                                True, device="cpu", mode=mode, rounds_impl="edge")
        assert edge.mode == mode
    was = config.fast_gather_bits
    config.fast_gather_bits = 8
    try:
        with pytest.raises(ValueError, match="edge"):
            SVDGCNNClsEngine(init_params(CLASSES, K, True), CLASSES, K, True,
                             device="cpu", mode="fast", rounds_impl="edge")
    finally:
        config.fast_gather_bits = was
