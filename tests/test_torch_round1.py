"""The classifier's round-1 trunk of the port (``rounds_impl="round"``):
the plain versions of kernel B10a (``sv_round_first``, ``sv_round``)
against the Pallas ``sv_round_first``/``sv_round`` in interpret mode, and
the engine's round trunk against the JAX engine's (CPU, B=2, N=64, k=4;
T divides N).

Bars: kernel outputs within rtol=1e-4, atol=1e-5 (the Pallas round
kernels keep their ids inside); engines within 1e-4. In exact mode B10a
is B10b's function (tests/test_sv_round2.py holds the two JAX kernels
within 1e-5), and the port's plain versions share one core: round equals
round2 bitwise (tests/test_torch_round2.py).

The engine's round trunk against the JAX engine's is in
tests/test_torch_round1_engines.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnet_tpu.ops.pallas.sv_round import sv_round as jax_round
from svnet_tpu.ops.pallas.sv_round import sv_round_first as jax_first
from svnet_tpu_torch.infer import ROUNDS, SVDGCNNClsEngine
from svnet_tpu_torch.models import sv_pointnet
from svnet_tpu_torch.models.sv_dgcnn import init_params
from svnet_tpu_torch.ops.kernels.fold import fold_first_params
from svnet_tpu_torch.ops.kernels.sv_round import sv_round, sv_round_first

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


def _jnp(folded):
    return {n: jnp.asarray(t.numpy()) for n, t in folded.items()}


def _close(got, want):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def engines():
    """Port engines (FP and binary) on seeded weights: their folds are the
    kernels' inputs on both sides."""
    return {b: SVDGCNNClsEngine(init_params(CLASSES, K, b,
                                            torch.Generator().manual_seed(3)),
                                CLASSES, K, b, device="cpu", rounds_impl="round")
            for b in (False, True)}


@pytest.mark.parametrize("cross", [False, True], ids=["xyz", "cross"])
def test_round_first_plain_matches_jax(engines, cross):
    """B10a's first round on two edge channels (SV-DGCNN's conv1) and on
    three with the cross product (SV-PointNet's conv_pos)."""
    if cross:
        w = sv_pointnet.init_params(CLASSES, K, False,
                                    torch.Generator().manual_seed(5))
        enc, enc_bs = w["params"]["feat"], w["batch_stats"]["feat"]
        folded = fold_first_params(enc["init_scalar"], enc["conv_pos"],
                                   enc_bs["conv_pos"], n_ch=3)
    else:
        folded = engines[False].folded_first
    pts = _rand(7, B, N, 3)
    want = jax_first(jnp.asarray(pts), _jnp(folded), S_out=32, V_out=10, k=K,
                     T=16, exact=True, cross=cross, interpret=True)
    before = sv_round_first.launches
    got = sv_round_first(torch.from_numpy(pts), folded, S_out=32, V_out=10,
                         k=K, cross=cross)
    assert sv_round_first.launches == before  # the CPU runs no kernel
    assert got[2].shape == (B, 9 if cross else 6)
    _close(got, want)


@pytest.mark.parametrize("binary", [False, True], ids=["fp", "binary"])
@pytest.mark.parametrize("name", ["conv2", "conv4"])
def test_round_plain_matches_jax(engines, name, binary):
    """B10a's conv round at the narrowest and the widest round."""
    eng = engines[binary]
    S, V, S_out, V_out = ROUNDS[name]
    src = _rand(S + V, B, N, S + 3 * V)
    want = jax_round(jnp.asarray(src), _jnp(eng.folded[name]), S=S, V=V,
                     S_out=S_out, V_out=V_out, k=K, T=16, binary=binary,
                     exact=True, interpret=True)
    before = sv_round.launches
    got = sv_round(torch.from_numpy(src), eng.folded[name], S=S, V=V,
                   S_out=S_out, V_out=V_out, k=K, binary=binary)
    assert sv_round.launches == before
    _close(got, want)


def test_round_wrappers_refuse_fast_mode_and_bad_shapes(engines):
    """exact=False (the fast variant, tests/test_torch_round1_modes.py)
    refuses what its packed key cannot hold, N above 8192, and a key tile
    that does not divide N; exact mode reads no key tile; bad shapes
    raise."""
    eng = engines[True]
    S, V, S_out, V_out = ROUNDS["conv2"]
    kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=K)
    src = torch.zeros(1, 16, S + 3 * V)
    with pytest.raises(ValueError, match="8192"):
        sv_round(torch.zeros(1, 8448, S + 3 * V), eng.folded["conv2"],
                 exact=False, **kw)
    with pytest.raises(ValueError, match="8192"):
        sv_round_first(torch.zeros(1, 8448, 3), eng.folded_first, S_out=32,
                       V_out=10, k=K, exact=False)
    with pytest.raises(ValueError, match="divide"):  # T = 128 by default
        sv_round(src, eng.folded["conv2"], exact=False, **kw)
    with pytest.raises(ValueError, match="divide"):  # T = 256 by default
        sv_round_first(torch.zeros(1, 16, 3), eng.folded_first, S_out=32,
                       V_out=10, k=K, exact=False)
    assert sv_round(src, eng.folded["conv2"], exact=False, T=8,
                    **kw)[0].shape == (1, 16, S_out)
    assert sv_round(src, eng.folded["conv2"], **kw)[0].shape == (1, 16, S_out)
    with pytest.raises(ValueError):  # channel-major input
        sv_round(src.transpose(1, 2).contiguous(), eng.folded["conv2"], **kw)
    with pytest.raises(ValueError):
        sv_round_first(torch.zeros(1, 16, 2), eng.folded_first, S_out=32,
                       V_out=10, k=K)
    with pytest.raises(ValueError):  # k > N
        sv_round(src, eng.folded["conv2"], **dict(kw, k=17))
