"""Fast and approx mode on the classifier's edge trunk (``rounds_impl=
"edge"``: B10d and B10c with ``exact=False``) and kernel B4's ``mode``
against the JAX package on the CPU: the same seeded numpy inputs through
both, the Pallas kernels in interpret mode.

B10d and B10c run on the same neighbour ids on both sides, so their
outputs are held to RTOL 1e-4 / ATOL 1e-5 (f32 sums in other orders). The
bf16 gather is a selection of bf16 values on both sides, so a self-edge
is exactly 0 (binary rounds run at seeded beta and at beta = 0). B4's
fast and approx ids are held to C8's bar: identical neighbour sets, at
most 1 in 1,000 ids different (JAX's distances come from a matmul, the
port's are summed channel by channel). Then the classifier's edge trunk
in fast and approx mode against the JAX engine, and the refusals.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnet_tpu.infer import SVDGCNNClsEngine as JaxClsEngine
from svnet_tpu.ops.pallas.knn import knn_pallas
from svnet_tpu.ops.pallas.sv_edge import sv_edge_block as jax_edge
from svnet_tpu.ops.pallas.sv_edge_first import sv_edge_first_block as jax_first
from svnet_tpu_torch import config, ops
from svnet_tpu_torch.infer import ROUNDS, SVDGCNNClsEngine
from svnet_tpu_torch.models.sv_dgcnn import init_params
from svnet_tpu_torch.ops.kernels import knn as kk
from svnet_tpu_torch.ops.kernels import quant
from svnet_tpu_torch.ops.kernels.sv_edge import sv_edge_block
from svnet_tpu_torch.ops.kernels.sv_edge_first import sv_edge_first_block
from svnet_tpu_torch.ops.knn import knn_approx_plain, knn_fast_plain
from svnet_tpu_torch.utils.convert import from_flax, to_flax

from test_torch_round2_modes import _with_beta

B, N, K, CLASSES = 2, 64, 4, 10
RTOL, ATOL = 1e-4, 1e-5
ID_BAR = 1e-3  # B4 ids that may differ (C8), on identical neighbour sets


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


def _jnp(tree):
    return {n: jnp.asarray(t.numpy()) for n, t in tree.items()}


def _close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def _weights(binary, seed=4):
    """Seeded weights; binary ones with seeded nonzero binarization offsets
    (beta, 0 at init), as a trained model's are."""
    w = init_params(CLASSES, K, binary, torch.Generator().manual_seed(seed))
    return _with_beta(w, seed + 100) if binary else w


@pytest.fixture(scope="module")
def engines():
    """Port engines (FP and binary): their folds are the kernels' inputs on
    both sides."""
    return {b: SVDGCNNClsEngine(_weights(b), CLASSES, K, b, device="cpu",
                                rounds_impl="edge", mode="fast")
            for b in (False, True)}


# ---------------------------------------------------------------------------
# B10d, B10c: exact=False on the same ids
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T", [8, 32])
def test_edge_first_fast_matches_jax(engines, T):
    """B10d with exact=False on the kNN ids of the points, at two key tiles
    of the Pallas kernel (T changes only the order of s_mean's partial
    sums): s, ungated v, s_mean; the CPU runs no kernel."""
    eng = engines[False]
    pts = _rand(8, B, N, 3)
    idx = ops.knn(torch.from_numpy(pts), K)
    want = jax_first(jnp.asarray(pts), jnp.asarray(idx.numpy()),
                     _jnp(eng.folded_first), S_out=32, V_out=10, k=K, T=T,
                     exact=False, interpret=True)
    before = sv_edge_first_block.launches
    got = sv_edge_first_block(torch.from_numpy(pts), idx, eng.folded_first,
                              S_out=32, V_out=10, k=K, exact=False)
    assert sv_edge_first_block.launches == before
    _close(got, want)
    exact = sv_edge_first_block(torch.from_numpy(pts), idx, eng.folded_first,
                                S_out=32, V_out=10, k=K)
    assert not torch.equal(got[1], exact[1])  # the bf16 points act


def _edge_case(eng, name, seed):
    S, V, S_out, V_out = ROUNDS[name]
    src = _rand(seed, B, N, S + 3 * V)
    idx = ops.knn(torch.from_numpy(src), K)
    gate = (1 / (1 + np.exp(-_rand(seed + 1, B, V_out)))).astype(np.float32)
    kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=K, binary=eng.binary)
    return src, idx, gate, eng.folded[name], kw


def _jax_edge(src, idx, gate, folded, kw, exact=False):
    return jax_edge(jnp.asarray(src), jnp.asarray(idx.numpy()), jnp.asarray(gate),
                    _jnp(folded), T=16, exact=exact, interpret=True, **kw)


@pytest.mark.parametrize("binary", [False, True], ids=["fp", "binary"])
@pytest.mark.parametrize("name", ["conv2", "conv3", "conv4"])
def test_edge_block_fast_matches_jax(engines, name, binary):
    """B10c with exact=False on the kNN ids of its source, a gate in
    (0, 1): s and gated v; the CPU runs no kernel. linear2's bf16 operands
    act: v differs from the round on the bf16 rows with an f32 linear2
    (B10a's exact=False route), and in FP mode from exact mode's."""
    src, idx, gate, f, kw = _edge_case(engines[binary], name, 20)
    want = _jax_edge(src, idx, gate, f, kw)
    before = sv_edge_block.launches
    x, g = torch.from_numpy(src), torch.from_numpy(gate)
    got = sv_edge_block(x, idx, g, f, exact=False, **kw)
    assert sv_edge_block.launches == before
    _close(got, want)
    rows_only = sv_edge_block(quant.bf16_rows(x), idx, g, f, **kw)
    assert torch.equal(got[0], rows_only[0])  # linear1's side unchanged
    assert not torch.equal(got[1], rows_only[1])


def test_edge_block_fast_rounds_linear2(engines):
    """FP conv3: exact=False's v is JAX's exact=False v and not within the
    bar of exact mode's (the bf16 w2 and edge vectors of linear2), while
    the Pallas kernel's own two modes differ as much."""
    src, idx, gate, f, kw = _edge_case(engines[False], "conv3", 30)
    x, g = torch.from_numpy(src), torch.from_numpy(gate)
    got = sv_edge_block(x, idx, g, f, exact=False, **kw)
    exact = sv_edge_block(x, idx, g, f, **kw)
    want = _jax_edge(src, idx, gate, f, kw)
    want_exact = _jax_edge(src, idx, gate, f, kw, exact=True)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(exact[1].numpy(), np.asarray(want_exact[1]),
                               rtol=RTOL, atol=ATOL)
    for a, b in ((got[1].numpy(), exact[1].numpy()),
                 (np.asarray(want[1]), np.asarray(want_exact[1]))):
        assert not np.allclose(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("binary", [False, True], ids=["fp", "binary"])
def test_edge_fast_self_edges_cancel(engines, binary):
    """Every id its own centre, binary at beta = 0 (sign(0) = 0): the
    edges' differences are exactly 0 on both sides, or a sign would flip
    to +-1; the first round and a conv round."""
    eng = engines[binary]
    self_ids = torch.arange(N, dtype=torch.int32)[None, :, None].expand(
        B, N, K).contiguous()
    pts = _rand(31, B, N, 3)
    want = jax_first(jnp.asarray(pts), jnp.asarray(self_ids.numpy()),
                     _jnp(eng.folded_first), S_out=32, V_out=10, k=K, T=16,
                     exact=False, interpret=True)
    _close(sv_edge_first_block(torch.from_numpy(pts), self_ids, eng.folded_first,
                               S_out=32, V_out=10, k=K, exact=False), want)
    src, _, gate, f, kw = _edge_case(eng, "conv2", 32)
    f = dict(f, beta=torch.zeros_like(f["beta"]))
    want = _jax_edge(src, self_ids, gate, f, kw)
    got = sv_edge_block(torch.from_numpy(src), self_ids, torch.from_numpy(gate),
                        f, exact=False, **kw)
    _close(got, want)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["fast", "approx"])
@pytest.mark.parametrize("binary", [False, True], ids=["fp", "binary"])
def test_cls_edge_engine_modes_match_jax(binary, mode):
    """The edge trunk in fast and approx mode (exact kNN x4, B10d and
    B10c with exact=False, B3r) against the JAX engine's (knn_impl="xla",
    the Pallas kernels in interpret mode, tile 16); approx is fast
    bitwise; the oracle twin equals the CPU engine."""
    weights = _weights(binary, seed=5)
    points = _rand(2, B, N, 3)
    jeng = JaxClsEngine(to_flax(weights), num_classes=CLASSES, k=K,
                        binary=binary, tile=16, knn_impl="xla", mode=mode,
                        rounds_impl="edge", interpret=True)
    want = np.asarray(jeng(jnp.asarray(points)))
    w = from_flax(to_flax(weights))
    x = torch.from_numpy(points)
    kw = dict(device="cpu", rounds_impl="edge")
    got = SVDGCNNClsEngine(w, CLASSES, K, binary, mode=mode, **kw)(x)
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    other = "fast" if mode == "approx" else "approx"
    assert torch.equal(SVDGCNNClsEngine(w, CLASSES, K, binary, mode=other,
                                        **kw)(x), got)
    oracle = SVDGCNNClsEngine(w, CLASSES, K, binary, mode=mode, oracle=True, **kw)
    assert torch.equal(oracle(x), got)


def test_check_mode_on_edge():
    """fast and approx are taken on the edge trunk; the knobs, which do not
    act there, are refused (C23), as on the legacy trunks."""
    assert config.check_mode("fast", "edge") == "fast"
    assert config.check_mode("approx", "edge") == "approx"
    w = init_params(CLASSES, K, True, torch.Generator().manual_seed(0))
    for mode, knob, value in (("fast", "fast_gather_bits", 8),
                              ("approx", "approx_gather_bits", 8),
                              ("approx", "approx_fold", 64)):
        was = getattr(config, knob)
        setattr(config, knob, value)
        try:
            with pytest.raises(ValueError, match="C23"):
                config.check_mode(mode, "edge")
            with pytest.raises(ValueError, match=knob):
                SVDGCNNClsEngine(w, CLASSES, K, True, mode=mode, device="cpu",
                                 rounds_impl="edge")
        finally:
            setattr(config, knob, was)
    with pytest.raises(ValueError):
        config.check_mode("quick", "edge")


# ---------------------------------------------------------------------------
# B4's mode
# ---------------------------------------------------------------------------


def _knn_input(b, n, c, dup, seed):
    x = _rand(seed, b, n, c)
    if dup:  # every odd row repeats an even one: exact ties of distance
        x[:, 1::2] = x[:, ::2][:, :x[:, 1::2].shape[1]]
    return x


# (B, N, C, k, tile, duplicated points): one key tile a cloud at N at the
# fold (no fold), two key tiles folded 512 -> 256, N = 384 folded to 192
# lanes (not a multiple of 128) at k above a 32-entry list, ties
KNN_CASES = [(2, 256, 3, 8, 128, False), (2, 512, 16, 20, 128, False),
             (1, 384, 16, 40, 128, False), (2, 256, 3, 8, 64, True)]


@pytest.mark.parametrize("mode", ["fast", "approx"])
@pytest.mark.parametrize("case", KNN_CASES, ids=[
    f"B{c[0]}-N{c[1]}-C{c[2]}-k{c[3]}-T{c[4]}" + ("-dup" if c[5] else "")
    for c in KNN_CASES])
def test_knn_modes_match_knn_pallas(case, mode):
    """The plain ``knn(x, k, mode, tile)`` against ``knn_pallas(...,
    mode=..., interpret=True)``: identical neighbour sets, at most 1 in
    1,000 ids different; the CPU runs no kernel and no pre-pass."""
    b, n, c, k, tile, dup = case
    x = _knn_input(b, n, c, dup, n + c)
    before = (kk.knn.launches, kk.neg_min.launches, kk.knn.neg_min_launches)
    got = kk.knn(torch.from_numpy(x), k, mode=mode, tile=tile).numpy()
    assert (kk.knn.launches, kk.neg_min.launches,
            kk.knn.neg_min_launches) == before
    want = np.asarray(knn_pallas(jnp.asarray(x), k, tile=tile, mode=mode,
                                 interpret=True))
    assert got.shape == want.shape == (b, n, k) and got.dtype == np.int32
    np.testing.assert_array_equal(np.sort(got, -1), np.sort(want, -1))
    assert (got != want).mean() <= ID_BAR, (got != want).mean()


def test_knn_modes_plain_versions():
    """The wrapper's CPU route is the named plain versions: exact mode
    ``knn_plain`` at any tile, fast ``knn_fast_plain`` on key tiles of
    ``tile``, approx ``knn_approx_plain`` at the fixed 256-lane fold
    whatever ``config.approx_fold`` says; at N <= 256 approx is fast."""
    x = torch.from_numpy(_knn_input(2, 512, 8, False, 3))
    assert torch.equal(kk.knn(x, 6, tile=100), ops.knn_plain(x, 6))
    assert torch.equal(kk.knn(x, 6, mode="fast", tile=128),
                       knn_fast_plain(x, 6, 128))
    was = config.approx_fold
    config.approx_fold = 64
    try:
        got = kk.knn(x, 6, mode="approx", tile=256)
    finally:
        config.approx_fold = was
    assert torch.equal(got, knn_approx_plain(x, 6, 256, 256))
    assert not torch.equal(got, knn_fast_plain(x, 6, 256))
    y = x[:, :256].contiguous()
    assert torch.equal(kk.knn(y, 6, mode="approx"), kk.knn(y, 6, mode="fast"))


def test_knn_modes_refuse_what_jax_asserts():
    """A key tile that does not divide N (fast and approx; JAX asserts), a
    width that halves to an odd number, k above the folded width, and an
    unknown mode raise; exact mode takes any N."""
    for mode in ("fast", "approx"):
        with pytest.raises(ValueError, match="divide"):
            kk.knn(torch.zeros(1, 200, 3), 4, mode=mode, tile=128)
    with pytest.raises(ValueError, match="odd"):  # 602 -> 301, above 256
        kk.knn(torch.zeros(1, 602, 3), 4, mode="approx", tile=7)
    with pytest.raises(ValueError, match="L=192"):  # 384 -> 192 lanes
        kk.knn(torch.zeros(1, 384, 3), 193, mode="approx", tile=128)
    assert kk.knn(torch.zeros(1, 384, 3), 193, mode="fast", tile=128).shape == (
        1, 384, 193)
    with pytest.raises(ValueError, match="mode"):
        kk.knn(torch.zeros(1, 256, 3), 4, mode="quick")
    assert kk.knn(torch.zeros(1, 200, 3), 4, tile=128).shape == (1, 200, 4)
