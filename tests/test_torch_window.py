"""The certified Morton candidate window (``window=``: B1, B2 and the
SV-DGCNN engines) against the JAX package on the CPU: the same seeded
numpy inputs through both.

The pre-pass's kept blocks and certificate are identical to
``_prune_prepass``'s. The rounds run the JAX Pallas kernels in interpret
mode with ``window=`` at the JAX package's own sizes (N = 512, T = 128,
k = 4, W = 384 certified and 128 not; tests/test_sv_round3.py), on strand
clouds (``utils.synth.strand_clouds``), where the window certifies at that
N. Exact mode's windowed round is bitwise the port's full scan; fast and
approx mode are another function (the key tile's scale over the kept
rows, approx's fold over the W compacted positions), held to JAX's ids at
fast mode's bar (tests/test_torch_fast.py, ROADMAP C8). The engines run at
N = 1024, the least N at which B1's key tile (T = 256) leaves room for a
window.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnet_tpu import config as jconfig
from svnet_tpu.infer import SVDGCNNClsEngine as JaxDGCNNEngine
from svnet_tpu.infer import SVDGCNNPsegEngine as JaxPsegEngine
from svnet_tpu.ops.pallas import sv_round3 as jr3
from svnet_tpu_torch import config
from svnet_tpu_torch.infer import ROUNDS, SVDGCNNClsEngine, SVDGCNNPsegEngine
from svnet_tpu_torch.models.sv_dgcnn import init_params, init_params_pseg
from svnet_tpu_torch.ops import window
from svnet_tpu_torch.ops.kernels import knn as kk
from svnet_tpu_torch.ops.kernels import quant
from svnet_tpu_torch.ops.kernels.fold import fold_first_params
from svnet_tpu_torch.ops.kernels.sv_round3 import sv_round3, sv_round3_first
from svnet_tpu_torch.ops.knn import knn_window_plain
from svnet_tpu_torch.utils.convert import to_flax
from svnet_tpu_torch.utils.synth import strand_clouds, surface_clouds

from test_torch_approx import _approx
from test_torch_fast import _check_round, _jnp_tree, _with_beta

B, N, T, K = 2, 512, 128, 4  # tests/test_sv_round3.py's sizes


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's thread pool only competes with the other
    test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """Seeded SV-DGCNN weights with nonzero binarization offsets (C19)."""
    w = init_params(10, K, True, torch.Generator().manual_seed(5))
    eng = SVDGCNNClsEngine(_with_beta(w, 6), 10, K, True, device="cpu")
    return eng.folded_first, eng.folded


# ---------------------------------------------------------------------------
# the pre-pass
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c", [3, 14], ids=["points", "C14"])
def test_prune_prepass_matches_jax(c):
    """keep and ok identical to ``_prune_prepass``'s on a strand cloud at a
    certified W (384), and on one that does not certify: a strand at k = 20
    and W = 256 (C14), a sphere's surface, where every block is kept, and
    N = 256, where each band holds the other block twice (points)."""
    cases = [(strand_clouds(1, B, N, c), K, 384, True),
             (strand_clouds(2, B, N, c), 20, 256, False)]
    if c == 3:
        cases[1] = (surface_clouds(3, B, N), K, 384, False)
        cases.append((strand_clouds(5, B, 256, c), K, 128, False))
    for x, k, W, certified in cases:
        keep, ok = window.prune_prepass(torch.from_numpy(x), k, T, W)
        jkeep, jok = jr3._prune_prepass(jnp.asarray(x), k, T, W)
        np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
        assert bool(ok) == bool(jok)
        assert certified is None or bool(ok) == certified
    x = strand_clouds(1, B, N, c)
    keep, ok = window.prune_prepass(torch.from_numpy(x), K, T, 384)
    assert bool(ok) and keep.dtype == torch.int32 and keep.shape == (B, N // T, 4)
    rows, valid = window.window_rows(keep, 384)
    for b in range(B):
        for t in range(N // T):
            kept = [r for bk in range(4) if keep[b, t, bk] for r in range(bk * 128, bk * 128 + 128)]
            assert rows[b, t][valid[b, t]].tolist() == kept
            assert int(valid[b, t].sum()) == len(kept)


# ---------------------------------------------------------------------------
# B1 and B2 with a window
# ---------------------------------------------------------------------------

# (mode, gather bits, approx fold, W): fast 16 bits; approx 8 bits at fold
# 256 (L = 192 at W = 384, no power of two). B2's cases below add 8-bit
# fast and approx at fold 64 (L = 48); exact mode is held to JAX through
# the classifier engine, whose B1 and conv2 certify, and bitwise to the
# full scan in test_window_exact_is_the_full_scan; the fallback in
# test_window_selection_modes.
FIRST_CASES = [("fast", 16, 256, 384), ("approx", 8, 256, 384)]


@pytest.mark.parametrize("mode,bits,fold,W", FIRST_CASES, ids=[
    f"{m}{b}-fold{f}-W{w}" for m, b, f, w in FIRST_CASES])
def test_round3_first_window_matches_jax(weights, mode, bits, fold, W):
    pts = strand_clouds(7, 1, N)
    kw = dict(S_out=32, V_out=10, k=K, mode=mode)
    with _approx(fold=fold, bits=bits, fast_bits=bits):
        want = jr3.sv_round3_first(jnp.asarray(pts), _jnp_tree(weights[0]),
                                   T=T, interpret=True, window=W,
                                   emit_wins=True, cm=True, **kw)
        x = torch.from_numpy(pts)
        got = sv_round3_first(x, weights[0], T=T, window=W, emit_wins=True, **kw)
        full = sv_round3_first(x, weights[0], T=T, emit_wins=True, **kw)
        keep, ok = window.prune_prepass(x, K, T, W)
    assert bool(ok)
    _check_round(got, want)
    assert not torch.equal(got[3], full[3])  # another function


# (mode, gather bits, approx fold, round, binary)
CONV_CASES = [("fast", 8, 256, "conv3", False), ("approx", 16, 64, "conv2", True)]


@pytest.mark.parametrize("mode,bits,fold,name,binary", CONV_CASES, ids=[
    f"{m}{b}-fold{f}-{n}-{'binary' if bi else 'fp'}" for m, b, f, n, bi in CONV_CASES])
def test_round3_window_matches_jax(weights, mode, bits, fold, name, binary):
    """B2 at W = 384 on strand features (certified): JAX's ids and outputs
    at fast mode's bar."""
    S, V, S_out, V_out = ROUNDS[name]
    src = strand_clouds(11, 1, N, S + 3 * V).transpose(0, 2, 1).copy()
    folded = weights[1][name]
    if not binary:
        folded = dict(folded, beta=torch.zeros_like(folded["beta"]))
    kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=K, binary=binary, mode=mode)
    with _approx(fold=fold, bits=bits, fast_bits=bits):
        want = jr3.sv_round3(jnp.asarray(src), _jnp_tree(folded), T=T,
                             interpret=True, window=384, emit_wins=True,
                             cm=True, **kw)
        x = torch.from_numpy(src)
        got = sv_round3(x, folded, T=T, window=384, emit_wins=True, **kw)
    assert bool(window.prune_prepass(x.transpose(1, 2), K, T, 384)[1])
    _check_round(got, want)


def test_window_exact_is_the_full_scan(weights):
    """Exact mode's windowed B1 and B2 (binary and FP) are bitwise the full
    scan, ids included, certified or not (W = 384, 256)."""
    pts = torch.from_numpy(strand_clouds(7, B, N))
    S, V, S_out, V_out = ROUNDS["conv2"]
    src = torch.from_numpy(strand_clouds(11, B, N, S + 3 * V)).transpose(1, 2)
    for W in (384, 256):
        kw = dict(S_out=32, V_out=10, k=K, emit_wins=True)
        got = sv_round3_first(pts, weights[0], T=T, window=W, **kw)
        assert all(torch.equal(g, f) for g, f in zip(
            got, sv_round3_first(pts, weights[0], **kw)))
        for binary in (True, False):
            kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=K, binary=binary,
                      emit_wins=True)
            got = sv_round3(src, weights[1]["conv2"], T=T, window=W, **kw)
            assert all(torch.equal(g, f) for g, f in zip(
                got, sv_round3(src, weights[1]["conv2"], **kw)))


def test_window_selection_modes():
    """The plain windowed selection: where the batch certifies, exact mode
    is the full scan's ids; one cloud that does not (shuffled) sends the
    whole batch to the full scan in every mode; approx mode's winners are
    one a residue class of the W compacted positions; the pre-pass's
    per-centre minimum (fast mode's scale) takes 0.0 where the window has
    padding."""
    x = torch.from_numpy(strand_clouds(13, B, N))
    keep, ok = window.prune_prepass(x, K, T, 384)
    assert bool(ok)
    full = knn_window_plain(x, 20, T, 384, keep, torch.tensor(False))
    assert torch.equal(knn_window_plain(x, 20, T, 384, keep, ok), full)
    mixed = x.clone()
    mixed[1] = mixed[1, torch.randperm(N, generator=torch.Generator().manual_seed(0))]
    mkeep, mok = window.prune_prepass(mixed, K, T, 384)
    assert not bool(mok) and bool((mkeep[0] == keep[0]).all())
    for mode in ("fast", "approx"):
        got = knn_window_plain(mixed, K, T, 384, mkeep, mok, mode)
        want = sv_round3_first(mixed, _first(), S_out=32, V_out=10, k=K,
                               mode=mode, T=T, emit_wins=True)[3].transpose(1, 2)
        assert torch.equal(got, want)
    with _approx(fold=64):
        ids = knn_window_plain(x, K, T, 384, keep, ok, "approx")
    rows, valid = window.window_rows(keep, 384)
    for b in range(B):
        for t in range(N // T):
            where = {int(r): p for p, r in enumerate(rows[b, t].tolist()) if valid[b, t, p]}
            for n in range(t * T, (t + 1) * T):
                lanes = [where[int(r)] % 48 for r in ids[b, n]]
                assert len(set(lanes)) == K
    nm = kk.neg_min(x, (T, 384, keep, ok.to(torch.int32))).double()
    xd = x.double()
    for b in range(B):
        for t in range(N // T):
            kept = rows[b, t][valid[b, t]]
            ctr, cand = xd[b, t * T:(t + 1) * T], xd[b, kept]
            neg = -((ctr[:, None] - cand[None]) ** 2).sum(-1)
            want = neg.amin(-1).clamp(max=0.0 if len(kept) < 384 else np.inf)
            np.testing.assert_allclose(nm[b, t * T:(t + 1) * T], want, atol=1e-4)
    assert torch.equal(kk.neg_min(x, (T, 384, keep, torch.tensor(0))),
                       kk.neg_min_plain(x))


def _first():
    """B1's folded weights."""
    w = init_params(10, K, False, torch.Generator().manual_seed(4))
    return fold_first_params(w["params"]["init_scalar"], w["params"]["conv1"],
                             w["batch_stats"]["conv1"])


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_window_refusals(weights):
    """Where JAX asserts, ``ValueError``: W not a multiple of 128, W below
    the key tile, N not a multiple of 128, k above the pre-pass's 384 band
    rows, approx k above the fold of W,
    graph reuse with a window; and the window off the round3 trunk (C22).
    A window of 0 or at least N is off."""
    pts = torch.from_numpy(strand_clouds(3, 1, N))
    f = weights[0]
    kw = dict(S_out=32, V_out=10, k=K, T=T)
    for bad in (200, 64, -128):
        with pytest.raises(ValueError):
            sv_round3_first(pts, f, window=bad, **kw)
    with pytest.raises(ValueError):  # T = 256 > W
        sv_round3_first(pts, f, S_out=32, V_out=10, k=K, T=256, window=128)
    with pytest.raises(ValueError):  # T not a multiple of 128 (C22)
        sv_round3_first(pts, f, S_out=32, V_out=10, k=K, T=64, window=256)
    with pytest.raises(ValueError):  # N = 500
        sv_round3_first(pts[:, :500], f, S_out=32, V_out=10, k=K, T=500,
                        window=256)
    with pytest.raises(ValueError):  # k above the 384 band rows
        sv_round3_first(pts, f, S_out=32, V_out=10, k=385, T=T, window=384)
    with _approx(fold=64), pytest.raises(ValueError):  # L = 48 at W = 384
        sv_round3_first(pts, f, S_out=32, V_out=10, k=49, T=T, window=384,
                        mode="approx")
    with _approx(fold=64):  # and k = 48 is taken
        sv_round3_first(pts, f, S_out=32, V_out=10, k=48, T=T, window=384,
                        mode="approx")
    for off in (0, N, 4 * N):
        assert all(torch.equal(a, b) for a, b in zip(
            sv_round3_first(pts, f, window=off, emit_wins=True, **kw),
            sv_round3_first(pts, f, emit_wins=True, **kw)))
    S, V, S_out, V_out = ROUNDS["conv2"]
    src = torch.zeros(1, S + 3 * V, N)
    wins = torch.zeros(1, K, N, dtype=torch.int32)
    with pytest.raises(ValueError):
        sv_round3(src, weights[1]["conv2"], S=S, V=V, S_out=S_out,
                  V_out=V_out, k=K, window=256, wins_in=wins)
    w = init_params(10, K, True, torch.Generator().manual_seed(0))
    for impl in ("round2", "round", "edge"):
        with pytest.raises(ValueError):
            SVDGCNNClsEngine(w, 10, K, True, device="cpu", rounds_impl=impl,
                             window=256)
    eng = SVDGCNNClsEngine(w, 10, K, True, device="cpu", window=256)
    was = config.graph_reuse
    config.set_graph_reuse("spatial")
    try:
        with pytest.raises(ValueError):
            eng(pts)
    finally:
        config.set_graph_reuse(was)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

N_ENG, W_ENG = 1024, 512


def test_dgcnn_cls_engine_window_matches_jax():
    """The binary classifier in exact mode with window=512 on one strand
    cloud (B1 certifies; the conv rounds take what their features give):
    logits against the JAX engine's, and bitwise the port's engine without
    a window and its oracle twin."""
    weights = _with_beta(init_params(10, K, True, torch.Generator().manual_seed(8)), 9)
    points = strand_clouds(17, 1, N_ENG)
    jeng = JaxDGCNNEngine(to_flax(weights), num_classes=10, k=K, binary=True,
                          mode="exact", interpret=True, window=W_ENG)
    want = np.asarray(jeng(jnp.asarray(points)))
    eng = SVDGCNNClsEngine(weights, 10, K, True, device="cpu", window=W_ENG)
    x = torch.from_numpy(points)
    got = eng(x)
    assert torch.equal(got, SVDGCNNClsEngine(weights, 10, K, True, device="cpu")(x))
    oracle = SVDGCNNClsEngine(weights, 10, K, True, device="cpu", oracle=True,
                              window=W_ENG)
    assert torch.equal(oracle(x), got)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_dgcnn_pseg_engine_window_matches_jax():
    """The FP part segmenter in approx mode (fold 256, 8-bit gathers) with
    window=512: both sort at entry; logits in the input's order against
    the JAX engine's."""
    weights = init_params_pseg(50, K, False, torch.Generator().manual_seed(10))
    points = strand_clouds(19, 1, N_ENG)
    label = np.eye(16, dtype=np.float32)[[5]]
    with _approx(fold=256, bits=8):
        jeng = JaxPsegEngine(to_flax(weights), num_part=50, k=K, binary=False,
                             mode="approx", interpret=True, window=W_ENG)
        want = np.asarray(jeng(jnp.asarray(points), jnp.asarray(label)))
        eng = SVDGCNNPsegEngine(weights, 50, K, False, mode="approx",
                                device="cpu", window=W_ENG)
        got = eng(torch.from_numpy(points), torch.from_numpy(label)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
