"""The legacy row-major trunk of the port (``rounds_impl="round2"``): the
plain versions of kernels B10b (``sv_round2_first``, ``sv_round2``) and B3r
(``sv_point_block``) against the Pallas kernels in interpret mode, and the
classification engine's round2 trunk against the JAX engine's and against
the port's own round3 trunk (CPU, B=2, N=64, k=4; T divides N).

Bars: neighbour ids identical (the Pallas round2 kernels keep theirs
inside, so the ids are held to ``knn_pallas``, the same exact ordering);
kernel outputs within rtol=1e-4, atol=1e-5; engines within 1e-4. The two
trunks of the port compute the same function with the same arithmetic,
so their plain versions agree bitwise.

The engine's round2 trunk against the JAX engine's and the round3 trunk is
in tests/test_torch_round2_engines.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnet_tpu.ops.pallas.knn import knn_pallas
from svnet_tpu.ops.pallas.sv_point import sv_point_block as jax_point
from svnet_tpu.ops.pallas.sv_round2 import sv_round2 as jax_round2
from svnet_tpu.ops.pallas.sv_round2 import sv_round2_first as jax_first2
from svnet_tpu_torch.infer import (
    PSEG_TRUNK,
    ROUNDS,
    SVDGCNNClsEngine,
    SVDGCNNPsegEngine,
    dgcnn_rounds,
)
from svnet_tpu_torch.models.sv_dgcnn import init_params, init_params_pseg
from svnet_tpu_torch.ops.kernels.sv_point import (
    sv_point_block,
    sv_point_block_cm,
)
from svnet_tpu_torch.ops.kernels.sv_round2 import sv_round2, sv_round2_first
from svnet_tpu_torch.ops.kernels.sv_round3 import sv_round3, sv_round3_first


B, N, K, CLASSES, PARTS = 2, 64, 4, 10, 50
RTOL, ATOL = 1e-4, 1e-5
PSEG_ROUNDS = dgcnn_rounds(PSEG_TRUNK)


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


def _jnp(folded):
    return {n: jnp.asarray(t.numpy()) for n, t in folded.items()}


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module", params=["cls", "pseg"])
def engines(request):
    """Port engines (binary and FP) of one model: their folds are the
    kernels' inputs on both sides."""
    kind = request.param
    out = {}
    for binary in (False, True):
        if kind == "cls":
            w = init_params(CLASSES, K, binary, torch.Generator().manual_seed(1))
            out[binary] = SVDGCNNClsEngine(w, CLASSES, K, binary, device="cpu",
                                           rounds_impl="round2")
        else:
            w = init_params_pseg(PARTS, K, binary, torch.Generator().manual_seed(1))
            out[binary] = SVDGCNNPsegEngine(w, PARTS, K, binary, device="cpu",
                                            rounds_impl="round2")
    return kind, out


@pytest.mark.parametrize("n,k", [(N, K), (40, 7)], ids=["N64", "ragged"])
def test_round2_first_plain_matches_jax(engines, n, k):
    """B10b's first round (V_out 10 for cls, 16 for partseg): ids equal to
    knn_pallas, outputs to sv_round2_first in interpret mode."""
    _, engs = engines
    eng = engs[True]
    S1, V1 = eng.dims["conv1"]
    pts = _rand(n + k, B, n, 3)
    want = jax_first2(jnp.asarray(pts), _jnp(eng.folded_first), S_out=S1,
                      V_out=V1, k=k, T=8, mode="exact", interpret=True)
    before = sv_round2_first.launches
    got = sv_round2_first(torch.from_numpy(pts), eng.folded_first, S_out=S1,
                          V_out=V1, k=k, emit_wins=True)
    assert sv_round2_first.launches == before  # the CPU runs no kernel
    ids = knn_pallas(jnp.asarray(pts), k, tile=8, interpret=True)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ids))
    assert got[1].shape == (B, n, 3 * V1)
    _close(got[:3], want)


@pytest.mark.parametrize("binary", [False, True], ids=["fp", "binary"])
@pytest.mark.parametrize("name", ["conv2", "conv3", "conv4"])
def test_round2_plain_matches_jax(engines, name, binary):
    """B10b's conv round at each round's widths (cls or partseg)."""
    _, engs = engines
    eng = engs[binary]
    S, V, S_out, V_out = eng.rounds[name]
    src = _rand(S + V, B, N, S + 3 * V)
    want = jax_round2(jnp.asarray(src), _jnp(eng.folded[name]), S=S, V=V,
                      S_out=S_out, V_out=V_out, k=K, T=16, binary=binary,
                      mode="exact", interpret=True)
    got = sv_round2(torch.from_numpy(src), eng.folded[name], S=S, V=V,
                    S_out=S_out, V_out=V_out, k=K, binary=binary,
                    emit_wins=True)
    ids = knn_pallas(jnp.asarray(src), K, tile=16, interpret=True)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ids))
    _close(got[:3], want)


@pytest.mark.parametrize("binary", [False, True], ids=["fp", "binary"])
def test_point_block_plain_matches_jax(engines, binary):
    """B3r: x (SVFuse j-major), s5_max and v5_mean against sv_point_block
    in interpret mode, at (256, 83) -> (512, 170) or (256, 96) -> (512, 168)."""
    _, engs = engines
    eng = engs[binary]
    S, V, S_out, V_out = eng.S_c, eng.V_c, eng.S5, eng.V5
    rng = np.random.default_rng(S_out + V_out)
    src = rng.standard_normal((B, N, S + 3 * V)).astype(np.float32)
    gate = (1 / (1 + np.exp(-rng.standard_normal((B, V_out))))).astype(np.float32)
    want = jax_point(jnp.asarray(src), jnp.asarray(gate), _jnp(eng.folded_point),
                     S=S, V=V, S_out=S_out, V_out=V_out, T=N // 2,
                     binary=binary, exact=True, interpret=True)
    before = sv_point_block.launches
    got = sv_point_block(torch.from_numpy(src), torch.from_numpy(gate),
                         eng.folded_point, S=S, V=V, S_out=S_out, V_out=V_out,
                         binary=binary)
    assert sv_point_block.launches == before
    _close(got, want)


def test_row_major_plain_equals_channel_major(engines):
    """Both layouts' plain versions, on the same values: bitwise equal
    outputs and ids (B10b vs B1/B2, B3r vs B3), N ragged for the point
    block's blocks of 16."""
    _, engs = engines
    eng = engs[True]
    S1, V1 = eng.dims["conv1"]
    pts = torch.from_numpy(_rand(3, B, 40, 3))
    rm = sv_round2_first(pts, eng.folded_first, S_out=S1, V_out=V1, k=5,
                         emit_wins=True)
    cm = sv_round3_first(pts, eng.folded_first, S_out=S1, V_out=V1, k=5,
                         emit_wins=True)
    for a, b in zip(rm, cm):
        assert torch.equal(a, b.transpose(1, 2) if a.dim() == 3 else b)
    S, V, S_out, V_out = eng.rounds["conv3"]
    src = torch.from_numpy(_rand(4, B, 40, S + 3 * V))
    kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=5, binary=True,
              emit_wins=True)
    rm = sv_round2(src, eng.folded["conv3"], **kw)
    cm = sv_round3(src.transpose(1, 2).contiguous(), eng.folded["conv3"], **kw)
    for a, b in zip(rm, cm):
        assert torch.equal(a, b.transpose(1, 2) if a.dim() == 3 else b)
    S, V, S_out, V_out = eng.S_c, eng.V_c, eng.S5, eng.V5
    src = torch.from_numpy(_rand(5, B, 40, S + 3 * V))
    gate = torch.rand(B, V_out, generator=torch.Generator().manual_seed(0))
    kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, binary=True)
    rm = sv_point_block(src, gate, eng.folded_point, **kw)
    cm = sv_point_block_cm(src.transpose(1, 2).contiguous(), gate,
                           eng.folded_point, v_off=((S, V),), **kw)
    assert torch.equal(rm[0], cm[0].transpose(1, 2))
    assert torch.equal(rm[1], cm[1]) and torch.equal(rm[2], cm[2])


# ---------------------------------------------------------------------------
# the classification engine's round2 trunk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["round", "edge", "bogus"])
def test_unported_rounds_impl_raises(impl):
    """An unknown trunk raises ValueError for both engines (stricter than
    the JAX engines, which run another trunk for it). "round" and "edge":
    the part segmenter runs the round2 trunk for them, as the JAX engine
    does, and equals its round2 output; the classifier's "round" (B10a,
    B10b's function) equals its round2 output."""
    w = init_params(CLASSES, K, True, torch.Generator().manual_seed(0))
    wp = init_params_pseg(PARTS, K, True, torch.Generator().manual_seed(0))
    if impl == "bogus":
        with pytest.raises(ValueError, match="rounds_impl"):
            SVDGCNNClsEngine(w, CLASSES, K, True, device="cpu", rounds_impl=impl)
        with pytest.raises(ValueError, match="rounds_impl"):
            SVDGCNNPsegEngine(wp, PARTS, K, True, device="cpu",
                              rounds_impl=impl)
        return
    x = torch.from_numpy(_rand(11, B, 32, 3))
    label = torch.nn.functional.one_hot(torch.tensor([2, 9]), 16).float()
    pseg = SVDGCNNPsegEngine(wp, PARTS, K, True, device="cpu",
                             rounds_impl=impl)
    assert pseg.trunk == "round2"
    assert torch.equal(pseg(x, label), SVDGCNNPsegEngine(
        wp, PARTS, K, True, device="cpu", rounds_impl="round2")(x, label))
    if impl == "round":
        assert torch.equal(
            SVDGCNNClsEngine(w, CLASSES, K, True, device="cpu",
                             rounds_impl="round")(x),
            SVDGCNNClsEngine(w, CLASSES, K, True, device="cpu",
                             rounds_impl="round2")(x))


def test_round2_wrappers_check_arguments():
    eng = SVDGCNNClsEngine(init_params(CLASSES, K, True), CLASSES, K, True,
                           device="cpu", rounds_impl="round2")
    S, V, S_out, V_out = ROUNDS["conv2"]
    kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=K)
    with pytest.raises(ValueError):  # channel-major input
        sv_round2(torch.zeros(1, S + 3 * V, 16), eng.folded["conv2"], **kw)
    with pytest.raises(ValueError):
        sv_round2(torch.zeros(1, 3, S + 3 * V), eng.folded["conv2"], **kw)
    with pytest.raises(ValueError):
        sv_round2_first(torch.zeros(1, 16, 2), eng.folded_first, S_out=32,
                        V_out=10, k=K)
    with pytest.raises(ValueError):
        sv_point_block(torch.zeros(1, 505, 16), torch.zeros(1, 170),
                       eng.folded_point, S=256, V=83, S_out=512, V_out=170)
    before = (sv_round2_first.launches, sv_round2.launches,
              sv_point_block.launches)
    eng(torch.zeros(1, 16, 3))
    assert (sv_round2_first.launches, sv_round2.launches,
            sv_point_block.launches) == before
