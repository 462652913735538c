"""Graph reuse (``config.graph_reuse``, ``reuse_k``, ``reuse_gather_window``
and ``sv_round3(wins_in=...)``) against the JAX package on the CPU: the same
seeded numpy inputs through both.

A reuse round runs the JAX Pallas kernel in interpret mode with
``wins_in`` (its take_wins branch) on the SAME neighbour ids the port gets,
in exact, fast and approx mode at 16- and 8-bit gathers: with the ids
fixed, the outputs are held to f32 summation order (RTOL 1e-5, ATOL 1e-6,
the fast and approx round tests' bar) everywhere. Binary rounds run with
seeded nonzero beta (ROADMAP C19). The engines run at N = 128, k = 4 with
``reuse_k`` = 2, logits to the engine tests' bar (rtol 1e-4), and the ids
the reuse rounds consume (the first round's, or conv2's) to C8's bar:
the same neighbour sets, at most 1 in 1,000 ids differ.

The engines against the JAX engines are in
tests/test_torch_reuse_engines.py.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnet_tpu import config as jconfig
from svnet_tpu import infer as jinfer
from svnet_tpu.ops.pallas import sv_round3 as jr3
from svnet_tpu_torch import config, ops
from svnet_tpu_torch.infer import ROUNDS, SVDGCNNClsEngine, SVDGCNNPsegEngine
from svnet_tpu_torch.models.sv_dgcnn import init_params, init_params_pseg
from svnet_tpu_torch.ops.kernels import sv_round3 as kr
from svnet_tpu_torch.ops.kernels.sv_round3 import sv_round3, sv_round3_plain

from test_torch_approx import _approx
from test_torch_fast import (
    ATOL,
    ID_BAR,
    RTOL,
    _gather_bits,
    _jnp_tree,
    _rand,
    _with_beta,
)

B, N, K = 2, 128, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's thread pool only competes with the other
    test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _reuse(name="none", r=0, window=0):
    """graph_reuse, reuse_k and reuse_gather_window set in both packages,
    put back after."""
    was = (config.graph_reuse, config.reuse_k, config.reuse_gather_window)
    jwas = (jconfig.graph_reuse, jconfig.reuse_k, jconfig.reuse_gather_window)
    for mod in (config, jconfig):
        mod.set_graph_reuse(name)
        mod.set_reuse_k(r)
        mod.set_reuse_gather_window(window)
    try:
        yield
    finally:
        for mod, (g, rk, w) in ((config, was), (jconfig, jwas)):
            mod.set_graph_reuse(g)
            mod.set_reuse_k(rk)
            mod.set_reuse_gather_window(w)


@contextlib.contextmanager
def _mode_bits(mode, bits):
    """``mode``'s gather grid at ``bits`` in both packages (approx at fold
    64); exact mode sets nothing."""
    if mode == "fast":
        with _gather_bits(bits):
            yield
    elif mode == "approx":
        with _approx(fold=64, bits=bits):
            yield
    else:
        yield


@pytest.fixture(scope="module", params=[False, True], ids=["fp", "binary"])
def conv_weights(request):
    binary = request.param
    w = init_params(10, K, binary, torch.Generator().manual_seed(3))
    eng = SVDGCNNClsEngine(_with_beta(w, 4) if binary else w, 10, K, binary,
                           device="cpu")
    return binary, eng.folded


def _knn_wins(src_cm: np.ndarray, k: int) -> torch.Tensor:
    """Exact neighbour ids (B, k, N) int32 of channel-major features, rank
    0 the point itself: the ids a selecting round would emit."""
    x = torch.from_numpy(src_cm).transpose(1, 2)
    return ops.knn_plain(x, k).transpose(1, 2).contiguous()


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# the reuse round
# ---------------------------------------------------------------------------

# (mode, gather bits, round, ranks r taken of the K ids)
REUSE_CASES = [("exact", 16, "conv2", K), ("exact", 16, "conv4", 3),
               ("fast", 16, "conv2", 5), ("fast", 8, "conv3", K),
               ("approx", 16, "conv3", K), ("approx", 8, "conv2", 4)]


@pytest.mark.parametrize("mode,bits,name,r", REUSE_CASES, ids=[
    f"{m}{b}-{n}-r{r}" for m, b, n, r in REUSE_CASES])
def test_reuse_round_matches_jax(conv_weights, mode, bits, name, r):
    """The round on given ids (``wins_in``; a rank prefix ``wins[:, :r]``
    where r < K) against JAX's take_wins round on the same ids: every
    output within RTOL/ATOL, the ids being identical."""
    binary, folded = conv_weights
    S, V, S_out, V_out = ROUNDS[name]
    src = _rand(S + r + bits, B, S + 3 * V, N)
    wins = _knn_wins(src, K)
    with _mode_bits(mode, bits):
        want = jr3.sv_round3(jnp.asarray(src), _jnp_tree(folded[name]), S=S,
                             V=V, S_out=S_out, V_out=V_out, k=r,
                             binary=binary, mode=mode, interpret=True,
                             wins_in=jnp.asarray(wins[:, :r].numpy()), cm=True)
        got = sv_round3(torch.from_numpy(src), folded[name], S=S, V=V,
                        S_out=S_out, V_out=V_out, k=r, binary=binary,
                        mode=mode, wins_in=wins[:, :r])
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["exact", "fast", "approx"])
def test_graph_reuse_wins_roundtrip(conv_weights, mode):
    """``emit_wins`` -> ``wins_in`` on the same input reproduces the
    selecting round bitwise (tests/test_sv_round3.py's roundtrip); exact
    ids are the kNN's neighbour sets."""
    binary, folded = conv_weights
    S, V, S_out, V_out = ROUNDS["conv2"]
    src = torch.from_numpy(_rand(21, B, S + 3 * V, N))
    kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=K, binary=binary,
              mode=mode)
    with _mode_bits(mode, 16):
        *base, wins = sv_round3(src, folded["conv2"], emit_wins=True, **kw)
        assert wins.shape == (B, K, N) and wins.dtype == torch.int32
        _equal(sv_round3(src, folded["conv2"], wins_in=wins, **kw), base)
        _equal(sv_round3_plain(src, folded["conv2"], wins_in=wins, **kw), base)
    if mode == "exact":
        idx = ops.knn_plain(src.transpose(1, 2), K)
        assert torch.equal(wins.transpose(1, 2).sort(-1).values,
                           idx.sort(-1).values)


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_reuse_k_prefix_equals_small_k(conv_weights, mode):
    """The first r ranks of a k = K emit are the k = r emit, and a reuse
    round on that prefix (a strided view) is bitwise a fresh round at
    k = r (tests/test_sv_round3.py::test_reuse_k_prefix_equals_small_k)."""
    binary, folded = conv_weights
    S, V, S_out, V_out = ROUNDS["conv3"]
    R = 3
    src = torch.from_numpy(_rand(11, B, S + 3 * V, N))
    kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, binary=binary, mode=mode)
    wins_k = sv_round3(src, folded["conv3"], k=K, emit_wins=True, **kw)[3]
    *base_r, wins_r = sv_round3(src, folded["conv3"], k=R, emit_wins=True, **kw)
    assert torch.equal(wins_k[:, :R], wins_r)
    assert not wins_k[:, :R].is_contiguous()
    _equal(sv_round3(src, folded["conv3"], k=R, wins_in=wins_k[:, :R], **kw),
           base_r)


def test_gather_window_matches_jax(conv_weights):
    """``gather_window`` is the full gather: on ids that stay inside each
    centre's 128-row block (JAX takes its compacted branch) and on the
    cloud's own kNN ids (they span both blocks: its lax.cond fallback) the
    port's round with W = 128 is bitwise its round without, and both match
    JAX's compacted and fallback rounds
    (tests/test_sv_round3.py::test_reuse_gather_window_bitwise)."""
    binary, folded = conv_weights
    S, V, S_out, V_out = ROUNDS["conv2"]
    n, k = 256, 4
    kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=k, binary=binary)
    src = _rand(30, B, S + 3 * V, n)
    local = torch.cat([_knn_wins(src[:, :, :128], k),
                       _knn_wins(src[:, :, 128:], k) + 128], dim=2)
    for wins, is_local in ((local, True), (_knn_wins(src, k), False)):
        blk = wins.numpy() // 128
        assert is_local == bool((blk[:, :, :128] == 0).all()
                                and (blk[:, :, 128:] == 1).all())
        full = sv_round3(torch.from_numpy(src), folded["conv2"], wins_in=wins, **kw)
        cmp_ = sv_round3(torch.from_numpy(src), folded["conv2"], wins_in=wins,
                         gather_window=128, **kw)
        _equal(cmp_, full)
        jfull, jcmp = (jr3.sv_round3(
            jnp.asarray(src), _jnp_tree(folded["conv2"]), T=128, mode="exact",
            interpret=True, wins_in=jnp.asarray(wins.numpy()), cm=True,
            gather_window=gw, **kw) for gw in (0, 128))
        for a, b in zip(jfull, jcmp):  # JAX's own contract: bitwise
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        for g, w in zip(cmp_, jcmp):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                       atol=ATOL)


def test_reuse_refusals(conv_weights):
    """``wins_in`` with ``emit_wins``, ``gather_window`` without ``wins_in``
    or off the 128-row grid, ids outside [0, N) (C17), of the wrong shape
    or dtype, and knob values JAX asserts against all raise; the other
    trunks raise under graph reuse, and the port's own plain round runs on
    given ids without a selection."""
    binary, folded = conv_weights
    S, V, S_out, V_out = ROUNDS["conv2"]
    src = torch.from_numpy(_rand(40, B, S + 3 * V, N))
    wins = _knn_wins(src.numpy(), K)
    kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=K, binary=binary)
    with pytest.raises(ValueError):
        sv_round3(src, folded["conv2"], wins_in=wins, emit_wins=True, **kw)
    with pytest.raises(ValueError):
        sv_round3(src, folded["conv2"], gather_window=128, **kw)
    with pytest.raises(ValueError):
        sv_round3(src, folded["conv2"], wins_in=wins, gather_window=64, **kw)
    for bad in (-1, N):
        w = wins.clone()
        w[1, 3, 7] = bad
        with pytest.raises(ValueError):
            sv_round3(src, folded["conv2"], wins_in=w, **kw)
    with pytest.raises(ValueError):
        sv_round3(src, folded["conv2"], wins_in=wins[:, :K - 1], **kw)
    with pytest.raises(TypeError):
        sv_round3(src, folded["conv2"], wins_in=wins.long(), **kw)
    with pytest.raises(ValueError):
        config.set_graph_reuse("all")
    with pytest.raises(ValueError):
        config.set_reuse_k(-1)
    for bad in (64, 100, -128, 200):
        with pytest.raises(ValueError):
            config.set_reuse_gather_window(bad)
    assert (config.graph_reuse, config.reuse_k,
            config.reuse_gather_window) == ("none", 0, 0)
    w = init_params(10, 4, False, torch.Generator().manual_seed(0))
    pts = torch.from_numpy(_rand(41, B, 64, 3))
    with _reuse("spatial", 2):
        for impl in ("round2", "round", "edge"):
            for oracle in (False, True):
                with pytest.raises(ValueError):
                    SVDGCNNClsEngine(w, 10, 4, False, device="cpu",
                                     oracle=oracle, rounds_impl=impl)(pts)
        with pytest.raises(ValueError):
            SVDGCNNPsegEngine(init_params_pseg(50, 4, False), 50, 4, False,
                              device="cpu", rounds_impl="round2")(
                pts, torch.eye(16)[[0, 1]])
    # a reuse round runs no selection
    calls = []
    orig = kr._select
    kr._select = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        sv_round3(src, folded["conv2"], wins_in=wins, mode="fast", **kw)
    finally:
        kr._select = orig
    assert not calls


def test_engine_reuse_rounds_skip_the_range_sync(conv_weights, monkeypatch):
    """The engines' reuse rounds get ids an earlier round emitted and skip
    the range check (``emitted``; on the card it waits for the device);
    the public wrapper runs it, and ``emitted`` still checks the ids'
    shape and dtype."""
    binary, folded = conv_weights
    S, V, S_out, V_out = ROUNDS["conv2"]
    src = torch.from_numpy(_rand(42, B, S + 3 * V, N))
    wins = _knn_wins(src.numpy(), K)
    kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=K, binary=binary)
    calls = []
    aminmax = torch.aminmax
    monkeypatch.setattr(torch, "aminmax",
                        lambda *a, **k: calls.append(1) or aminmax(*a, **k))
    w = init_params(10, 4, binary, torch.Generator().manual_seed(5))
    with _reuse("spatial", 2):
        SVDGCNNClsEngine(w, 10, 4, binary, device="cpu")(
            torch.from_numpy(_rand(43, B, 64, 3)))
    assert not calls
    _equal(sv_round3(src, folded["conv2"], wins_in=wins, emitted=True, **kw),
           sv_round3(src, folded["conv2"], wins_in=wins, **kw))
    assert len(calls) == 1
    with pytest.raises(TypeError):
        sv_round3(src, folded["conv2"], wins_in=wins.long(), emitted=True, **kw)
    with pytest.raises(ValueError):
        sv_round3(src, folded["conv2"], wins_in=wins[:, :K - 1], emitted=True, **kw)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

N_ENG, K_ENG, R_ENG = 128, 4, 2


class _Ids:
    """Records the ids a port engine's selecting rounds return (the first
    round's, then conv2's, ...) and those JAX's rounds emit for reuse
    (through ``jax.debug.callback``, inside the JAX engine's jit)."""

    def __init__(self, eng, monkeypatch):
        self.port, self.jax = [], []
        for attr in ("_first", "_round"):
            setattr(eng, attr, self._port(getattr(eng, attr)))
        for attr in ("sv_round3_first", "sv_round3"):
            monkeypatch.setattr(jinfer, attr, self._jax(getattr(jinfer, attr)))

    def _port(self, fn):
        def run(*a, **kw):
            out = fn(*a, **kw)
            self.port += [w.numpy() for w in out[2:]]
            return out
        return run

    def _jax(self, fn):
        def run(*a, **kw):
            out = fn(*a, **kw)
            if kw.get("emit_wins"):
                jax.debug.callback(lambda w: self.jax.append(np.asarray(w)),
                                   out[3])
            return out
        return run

    def check(self, reuse):
        """The ids the reuse rounds consume (the first round's with
        "spatial", conv2's with "conv2") agree to C8's bar."""
        (jw,) = self.jax
        pw = self.port[0 if reuse == "spatial" else 1]
        np.testing.assert_array_equal(np.sort(pw, axis=1), np.sort(jw, axis=1))
        assert (pw != jw).mean() <= ID_BAR, (pw != jw).mean()
