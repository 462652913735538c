"""The classifier's edge trunk of the port (``rounds_impl="edge"``): the
plain versions of kernels B10d (``sv_edge_first_block``) and B10c
(``sv_edge_block``) against the Pallas kernels in interpret mode on the
same neighbour ids, the host gate ``svblock_gate`` against JAX's, and the
engine's edge trunk against the JAX engine's (CPU, B=2, N=64, k=4).

Bars: outputs within rtol=1e-4, atol=1e-5; engines within 1e-4.

The engine's edge trunk against the JAX engine's is in
tests/test_torch_edge_engines.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnet_tpu.ops.pallas.sv_edge import sv_edge_block as jax_edge
from svnet_tpu.ops.pallas.sv_edge import svblock_gate as jax_gate
from svnet_tpu.ops.pallas.sv_edge_first import sv_edge_first_block as jax_first
from svnet_tpu_torch import ops
from svnet_tpu_torch.infer import ROUNDS, SVDGCNNClsEngine
from svnet_tpu_torch.models.sv_dgcnn import init_params
from svnet_tpu_torch.ops.kernels.sv_edge import sv_edge_block, svblock_gate
from svnet_tpu_torch.ops.kernels.sv_edge_first import sv_edge_first_block

B, N, K, CLASSES = 2, 64, 4, 10
RTOL, ATOL = 1e-4, 1e-5


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
    return {n: _jnp(t) if isinstance(t, dict) else jnp.asarray(t.numpy())
            for n, t in tree.items()}


def _close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def engines():
    """Port engines (FP and binary) on seeded weights: their folds are the
    kernels' inputs on both sides."""
    return {b: SVDGCNNClsEngine(init_params(CLASSES, K, b,
                                            torch.Generator().manual_seed(4)),
                                CLASSES, K, b, device="cpu", rounds_impl="edge")
            for b in (False, True)}


def test_edge_first_plain_matches_jax(engines):
    """B10d on the kNN ids of the points: s, ungated v, s_mean (B, 6)."""
    eng = engines[False]
    pts = _rand(8, B, N, 3)
    idx = ops.knn(torch.from_numpy(pts), K)
    want = jax_first(jnp.asarray(pts), jnp.asarray(idx.numpy()),
                     _jnp(eng.folded_first), S_out=32, V_out=10, k=K, T=8,
                     exact=True, interpret=True)
    before = sv_edge_first_block.launches
    got = sv_edge_first_block(torch.from_numpy(pts), idx, eng.folded_first,
                              S_out=32, V_out=10, k=K)
    assert sv_edge_first_block.launches == before  # the CPU runs no kernel
    assert got[2].shape == (B, 6)
    _close(got, want)


@pytest.mark.parametrize("binary", [False, True], ids=["fp", "binary"])
@pytest.mark.parametrize("name", ["conv2", "conv4"])
def test_edge_block_plain_matches_jax(engines, name, binary):
    """B10c on the kNN ids of its source, with a gate in (0, 1): s and
    gated v."""
    eng = engines[binary]
    S, V, S_out, V_out = ROUNDS[name]
    src = _rand(S + V, B, N, S + 3 * V)
    idx = ops.knn(torch.from_numpy(src), K)
    gate = (1 / (1 + np.exp(-_rand(V_out, B, V_out)))).astype(np.float32)
    want = jax_edge(jnp.asarray(src), jnp.asarray(idx.numpy()),
                    jnp.asarray(gate), _jnp(eng.folded[name]), S=S, V=V,
                    S_out=S_out, V_out=V_out, k=K, T=16, binary=binary,
                    exact=True, interpret=True)
    before = sv_edge_block.launches
    got = sv_edge_block(torch.from_numpy(src), idx, torch.from_numpy(gate),
                        eng.folded[name], S=S, V=V, S_out=S_out, V_out=V_out,
                        k=K, binary=binary)
    assert sv_edge_block.launches == before
    _close(got, want)


@pytest.mark.parametrize("ids", ["knn", "hub"])
def test_svblock_gate_matches_jax(engines, ids):
    """The host gate from the ids' in-degrees: on kNN ids, and on ids
    where one hub point is every point's neighbour (in-degree N >> k)."""
    p = engines[True].p["conv3"]
    S = ROUNDS["conv3"][0]
    s = torch.from_numpy(_rand(9, B, N, S))
    if ids == "knn":
        idx = ops.knn(s, K)
    else:
        idx = torch.from_numpy(np.random.default_rng(10).integers(
            0, N, (B, N, K)).astype(np.int32))
        idx[:, :, 1] = 5
    want = jax_gate(_jnp(p), jnp.asarray(s.numpy()), jnp.asarray(idx.numpy()))
    got = svblock_gate(p, s, idx)
    assert got.shape == (B, ROUNDS["conv3"][3])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_edge_wrappers_check_ids(engines):
    """Ids of another shape, type or range raise before any work: the
    kernel must never read outside the source."""
    eng = engines[True]
    S, V, S_out, V_out = ROUNDS["conv2"]
    src = torch.zeros(B, 16, S + 3 * V)
    gate = torch.ones(B, V_out)
    kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=K)
    good = torch.zeros(B, 16, K, dtype=torch.int32)
    sv_edge_block(src, good, gate, eng.folded["conv2"], **kw)
    for bad, err in ((good.long(), TypeError), (good[:, :8], ValueError),
                     (good + 16, ValueError), (good - 1, ValueError)):
        with pytest.raises(err):
            sv_edge_block(src, bad, gate, eng.folded["conv2"], **kw)
        with pytest.raises(err):
            sv_edge_first_block(torch.zeros(B, 16, 3), bad, eng.folded_first,
                                S_out=32, V_out=10, k=K)
