"""The port's SV-DGCNN part segmentation serving slice against the JAX
package (CPU, B=2, N=64, k=4, 50 parts): the eager ``SVDGCNNPseg`` against
flax ``SV_DGCNN_PSEG.apply``, the folds and head permutations against the
JAX engine's, kernel B1 at partseg's V_out=16 and B3 at its (256, 96) ->
(512, 168) widths against the Pallas kernels in interpret mode, and
``SVDGCNNPsegEngine`` (round3 and round2 trunks) against the JAX engine.

Weights come from the port's seeded ``init_params_pseg`` and go to flax as
numpy (the tree test holds them to flax's ``init`` by ``jax.eval_shape``);
``apply`` runs under ``jax.jit``. Tolerances: FP within 1e-4; binary part
segmentation at random init is held to the flip-tolerant bar of
tests/test_torch_pointnet.py (``_flip_tolerant``): ulp-level differences of
summation order cross sign() boundaries and cascade.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnet_tpu import models
from svnet_tpu.infer import SVDGCNNPsegEngine as JaxPsegEngine
from svnet_tpu.ops.pallas.sv_point import sv_point_block_cm as jax_point
from svnet_tpu.ops.pallas.sv_round3 import sv_round3 as jax_round
from svnet_tpu_torch import config, ops
from svnet_tpu_torch.infer import SVDGCNNPsegEngine
from svnet_tpu_torch.models.sv_dgcnn import SVDGCNNPseg, init_params_pseg
from svnet_tpu_torch.ops.kernels.sv_point import sv_point_block_cm
from svnet_tpu_torch.ops.kernels.sv_round3 import sv_round3
from svnet_tpu_torch.utils.convert import to_flax

from test_torch_pointnet import _flip_tolerant

B, N, K, PARTS = 2, 64, 4, 50
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


def _labels():
    return np.eye(16, dtype=np.float32)[np.arange(B) * 5 % 16]


def _check(got, want, binary):
    if binary:
        _flip_tolerant(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-4)


@pytest.fixture(scope="module", params=[False, True], ids=["fp", "binary"])
def setup(request):
    binary = request.param
    weights = init_params_pseg(PARTS, K, binary, torch.Generator().manual_seed(1))
    var = to_flax(weights)
    points, label = _rand(0, B, N, 3), _labels()
    model = models.SV_DGCNN_PSEG(num_part=PARTS, k=K, binary=binary)
    want = np.asarray(jax.jit(model.apply)(var, jnp.asarray(points),
                                           jnp.asarray(label)))
    return binary, weights, var, points, label, want


@pytest.fixture(scope="module")
def jax_engines(setup):
    """The JAX engine's two trunks (interpret mode) on the setup's weights:
    the engines and their outputs."""
    binary, _, var, points, label, _ = setup
    out = {}
    for impl in ("round3", "round2"):
        jeng = JaxPsegEngine(var, num_part=PARTS, k=K, binary=binary,
                             exact=True, rounds_impl=impl, interpret=True)
        out[impl] = (jeng, np.asarray(jeng(jnp.asarray(points),
                                           jnp.asarray(label))))
    return out


@pytest.mark.parametrize("binary", [False, True], ids=["fp", "binary"])
def test_init_params_pseg_tree_matches_flax(binary):
    """Keys and shapes of flax's init (conv8's ``bn`` is flax's own
    BatchNorm: ``conv8/bn/scale``, not ``bn7/bn/scale``'s wrapper); the
    eager model loads the tree with strict=True."""
    model = models.SV_DGCNN_PSEG(num_part=PARTS, k=K, binary=binary)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 3)), jnp.zeros((1, 16)))
    tree = init_params_pseg(PARTS, K, binary, torch.Generator().manual_seed(0))
    SVDGCNNPseg.from_tree(tree, PARTS, K, binary)
    want = {jax.tree_util.keystr(p): tuple(a.shape)
            for p, a in jax.tree_util.tree_leaves_with_path(dict(shapes))}
    got = {jax.tree_util.keystr(p): tuple(a.shape)
           for p, a in jax.tree_util.tree_leaves_with_path(tree)}
    assert got == want


def test_eager_pseg_matches_flax(setup):
    binary, weights, _, points, label, want = setup
    model = SVDGCNNPseg.from_tree(weights, PARTS, K, binary)
    with torch.no_grad():
        got = model(torch.from_numpy(points), torch.from_numpy(label)).numpy()
    assert got.shape == (B, N, PARTS)
    _check(got, want, binary)


def test_folds_and_head_permutations_match_jax(setup, jax_engines):
    """Every fold (conv5 + svfuse3 at S=256, V=96 among them), the c-major
    ``fuse3_perm`` and conv8's ``head8`` rows, as the JAX engine has them."""
    binary, weights, *_ = setup
    jeng = jax_engines["round3"][0]
    teng = SVDGCNNPsegEngine(weights, PARTS, K, binary, device="cpu")
    assert (teng.S_c, teng.V_c, teng.S5, teng.V5) == (256, 96, 512, 168)
    pairs = [(teng.folded_first, jeng.folded_first),
             (teng.folded_point, jeng.folded_point)]
    pairs += [(teng.folded[n], jeng.folded[n]) for n in jeng.rounds]
    for got, want in pairs:
        assert set(got) == set(want)
        for name in want:
            np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                       rtol=1e-6, atol=0, err_msg=name)
    np.testing.assert_array_equal(teng.fuse3_perm.numpy(),
                                  np.asarray(jeng.fuse3_perm))
    for name in jeng.head8:
        np.testing.assert_array_equal(teng.head8[name].numpy(),
                                      np.asarray(jeng.head8[name]))


@pytest.mark.parametrize("impl", ["round3", "round2"])
def test_pseg_engine_matches_jax_engine(setup, jax_engines, impl):
    binary, weights, _, points, label, _ = setup
    eng = SVDGCNNPsegEngine(weights, PARTS, K, binary, device="cpu",
                            rounds_impl=impl)
    got = eng(torch.from_numpy(points), torch.from_numpy(label)).numpy()
    assert got.shape == (B, N, PARTS)
    _check(got, jax_engines[impl][1], binary)


def test_pseg_engine_matches_eager_model(setup):
    """The fused path (folds, j-major layouts, head8) against the un-fused
    oracle on the same weights, and the oracle twin equal to the engine."""
    binary, weights, _, points, label, _ = setup
    pts, lab = torch.from_numpy(points), torch.from_numpy(label)
    with torch.no_grad():
        want = SVDGCNNPseg.from_tree(weights, PARTS, K, binary)(pts, lab)
    eng = SVDGCNNPsegEngine(weights, PARTS, K, binary, device="cpu")
    got = eng(pts, lab)
    _check(got.numpy(), want.numpy(), binary)
    oracle = SVDGCNNPsegEngine(weights, PARTS, K, binary, device="cpu",
                               oracle=True)
    assert torch.equal(oracle(pts, lab), got)


def test_round2_engine_against_round3_engine(setup):
    """The two trunks of the port, both plain. The kernels' functions agree
    bitwise (tests/test_torch_round2.py). The tails keep the JAX engine's
    two layouts: the round3 tail multiplies conv8's rows permuted
    (``head8``) in channel-major einsums and takes svfuse1's frame by an
    einsum over (B, C, N), the round2 tail the c-major rows and a matmul.
    The binary engine's logits agree bitwise here (its +-1 products are
    exact in any order); the FP engine's differ by that summation order.
    On the card the library orders of the two Vector2Scalar frames differ
    too, and a binary point in 327,680 may flip (chip_smoke.py phase 13)."""
    binary, weights, _, points, label, _ = setup
    pts, lab = torch.from_numpy(points), torch.from_numpy(label)
    r3 = SVDGCNNPsegEngine(weights, PARTS, K, binary, device="cpu")(pts, lab)
    r2 = SVDGCNNPsegEngine(weights, PARTS, K, binary, device="cpu",
                           rounds_impl="round2")(pts, lab)
    if binary:
        assert torch.equal(r2, r3)
    else:
        torch.testing.assert_close(r2, r3, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [N, 40], ids=["N64", "ragged"])
def test_round3_kernels_at_partseg_widths_match_jax(setup, jax_engines, n):
    """B2 at conv4's (64, 24) -> (128, 40) and B3 at (256, 96) -> (512, 168)
    with partseg's ``v_off``, against the Pallas kernels in interpret mode;
    B3's pooled outputs, which the engine feeds to conv6, included."""
    binary, weights, *_ = setup
    jeng = jax_engines["round3"][0]
    teng = SVDGCNNPsegEngine(weights, PARTS, K, binary, device="cpu")
    S, V, S_out, V_out = teng.rounds["conv4"]
    src = _rand(n + 7, B, S + 3 * V, n)
    want = jax_round(jnp.asarray(src), jeng.folded["conv4"], S=S, V=V,
                     S_out=S_out, V_out=V_out, k=K, binary=binary,
                     mode="exact", interpret=True, emit_wins=True, cm=True)
    got = sv_round3(torch.from_numpy(src), teng.folded["conv4"], S=S, V=V,
                    S_out=S_out, V_out=V_out, k=K, binary=binary,
                    emit_wins=True)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
    if n != N:
        return  # the Pallas point block needs its tile to divide N
    rng = np.random.default_rng(5)
    src = rng.standard_normal((B, 256 + 3 * 96, n)).astype(np.float32)
    gate = (1 / (1 + np.exp(-rng.standard_normal((B, 168))))).astype(np.float32)
    want = jax_point(jnp.asarray(src), jnp.asarray(gate), jeng.folded_point,
                     S=256, V=96, S_out=512, V_out=168, v_off=teng.v_off,
                     T=n // 2, binary=binary, exact=True, interpret=True)
    got = sv_point_block_cm(torch.from_numpy(src), torch.from_numpy(gate),
                            teng.folded_point, S=256, V=96, S_out=512,
                            V_out=168, v_off=teng.v_off, binary=binary)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def test_pseg_engine_rotation_invariant():
    """SO(3) invariance of the per-point logits through the fused path, FP
    model (the bar of tests/test_infer_engine.py)."""
    gen = torch.Generator().manual_seed(2)
    eng = SVDGCNNPsegEngine(init_params_pseg(PARTS, K, False, gen), PARTS, K,
                            False, device="cpu")
    points = torch.randn(B, N, 3, generator=gen)
    label = torch.from_numpy(_labels())
    rot = ops.random_rotations(B, gen)
    out = eng(points, label)
    out_r = eng(ops.rotate_points(points, rot), label)
    np.testing.assert_allclose(out_r.numpy(), out.numpy(), rtol=2e-2, atol=2e-3)


def test_pseg_engine_checks_arguments():
    """The card by default, never a fallback; points and label checked."""
    w = init_params_pseg(PARTS, K, True, torch.Generator().manual_seed(0))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            SVDGCNNPsegEngine(w)
    eng = SVDGCNNPsegEngine(w, PARTS, K, True, device="cpu")
    with pytest.raises(ValueError):
        eng(torch.zeros(1, 16, 3), torch.zeros(1, 15))
    with pytest.raises(ValueError):
        eng(torch.zeros(1, 16, 3), torch.zeros(1, 16, dtype=torch.float64))
    with pytest.raises(ValueError):
        eng(torch.zeros(1, 16, 3, dtype=torch.float64), torch.zeros(1, 16))
    with pytest.raises(ValueError):
        SVDGCNNPsegEngine(w, PARTS, K, True, mode="turbo", device="cpu")
    # fast and approx run round2 for all three, whose fixed grid and fold
    # refuse the knobs that would not act (C23)
    was = (config.fast_gather_bits, config.approx_fold)
    try:
        config.set_fast_gather_bits(8)
        config.set_approx_fold(512)
        for impl in ("round2", "round", "edge"):
            for mode in ("fast", "approx"):
                with pytest.raises(ValueError):
                    SVDGCNNPsegEngine(w, PARTS, K, True, mode=mode,
                                      device="cpu", rounds_impl=impl)
    finally:
        config.set_fast_gather_bits(was[0])
        config.set_approx_fold(was[1])
