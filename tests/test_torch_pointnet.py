"""The port's SV-PointNet slice against the JAX package (CPU, B=2, N=64,
k=4): the cross edge features, ``Vector2Scalar``/``SVFuse`` with
``trans_back``, ``SV_STNkd``, the point-like fold, kernel B8's and B1-cross's
plain versions against the Pallas kernels in interpret mode, the eager
models against flax ``model.apply`` and both engines against the JAX
engines.

Weights are made by the port's seeded ``init_params`` (flax's own ``init``
takes tens of seconds on the CPU) and handed to flax as numpy; the tree
test holds their keys and shapes to flax's ``init`` by ``jax.eval_shape``.
``apply`` runs under ``jax.jit``: one compile instead of one per op.
Tolerances: f32 summed in another order, rtol=1e-4, atol=1e-5 (1e-5 / 1e-6
for single layers); binary part segmentation is held to the flip-tolerant
bar of tests/test_infer_pointnet_pseg.py (see ``_flip_tolerant``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnet_tpu import models
from svnet_tpu import ops as jops
from svnet_tpu.infer import SVPointNetClsEngine as JaxClsEngine
from svnet_tpu.infer import SVPointNetPsegEngine as JaxPsegEngine
from svnet_tpu.nn import sv_layers as jsvl
from svnet_tpu.ops.pallas.sv_block_point import fold_point_like_params as jax_fold
from svnet_tpu.ops.pallas.sv_block_point import sv_block_point as jax_block
from svnet_tpu.ops.pallas.sv_round3 import sv_round3_first as jax_first
from svnet_tpu_torch import ops
from svnet_tpu_torch.infer import SVPointNetClsEngine, SVPointNetPsegEngine
from svnet_tpu_torch.models.sv_pointnet import (
    SVPointNetCls,
    SVPointNetPseg,
    init_params,
    init_params_pseg,
)
from svnet_tpu_torch.nn import sv_layers as svl
from svnet_tpu_torch.ops.kernels.fold import fold_first_params, fold_point_like_params
from svnet_tpu_torch.ops.kernels.sv_block_point import sv_block_point
from svnet_tpu_torch.ops.kernels.sv_round3 import sv_round3_first
from svnet_tpu_torch.utils.convert import from_flax, load_tree, module_tree, to_flax

B, N, K, CLASSES, PARTS = 2, 64, 4, 10, 50
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
    return np.eye(16, dtype=np.float32)[np.arange(B) % 16]


def _tree(module: torch.nn.Module) -> dict:
    """A port module's weights with the test suite's non-trivial BN running
    stats (x + 0.3|x| + 0.05), as a flax variables dict of numpy arrays."""
    tree = to_flax(module_tree(module))
    tree["batch_stats"] = jax.tree.map(lambda a: a + 0.3 * np.abs(a) + 0.05,
                                       tree["batch_stats"])
    return tree


def _layer_check(flax_module, torch_module, x, rtol=1e-5, atol=1e-6):
    """The same weights (the port's, seeded) and input through both."""
    var = _tree(torch_module)
    want = jax.jit(flax_module.apply)(var, jax.tree.map(jnp.asarray, x))
    load_tree(torch_module, from_flax(var))
    with torch.no_grad():
        got = torch_module(jax.tree.map(torch.from_numpy, x))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol, atol=atol)


def _flip_tolerant(got, want):
    """Binary part segmentation at random init: ulp-level differences of
    summation order cross sign() boundaries in the 11 sequential binary
    blocks and cascade, so per-point 50-way argmaxes differ where flax's own
    decision margin is a near-tie. The bar of
    tests/test_infer_pointnet_pseg.py: >= 80% of points agree, 95% of the
    disagreeing points sit below the median margin, logits within 0.5."""
    top2 = np.sort(want, -1)
    margin = top2[..., -1] - top2[..., -2]
    bad = np.argmax(got, -1) != np.argmax(want, -1)
    assert 1.0 - bad.mean() >= 0.80, bad.mean()
    if bad.any():
        assert np.quantile(margin[bad], 0.95) < np.quantile(margin, 0.5)
    np.testing.assert_allclose(got, want, rtol=0.5, atol=0.5)


# ---------------------------------------------------------------------------
# graph ops and layers
# ---------------------------------------------------------------------------


def test_graph_feature_cross_and_svpool_match_jax():
    pts = _rand(0, B, 32, 3)
    want = np.asarray(jops.get_graph_feature_cross(jnp.asarray(pts), 5))
    got = ops.get_graph_feature_cross(torch.from_numpy(pts), 5).numpy()
    # edges equal; the cross product within an ulp of the coordinates (XLA
    # may fuse a product into the subtraction, the port rounds both)
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=1e-6, atol=1e-6)
    s, v = _rand(1, B, 32, 5), _rand(2, B, 32, 3, 4)
    for spool in ("max", "mean"):
        want = jops.svpool((jnp.asarray(s), jnp.asarray(v)), axis=1,
                           keepdims=True, spool=spool)
        got = ops.svpool((torch.from_numpy(s), torch.from_numpy(v)), dim=1,
                         keepdim=True, spool=spool)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)
    with pytest.raises(ValueError):
        ops.svpool((torch.from_numpy(s), torch.from_numpy(v)), spool="min")


@pytest.mark.parametrize("bw", [False, True])
def test_vector2scalar_trans_back_matches_flax(bw):
    _layer_check(jsvl.Vector2Scalar(3, bw=bw, trans_back=True),
                 svl.Vector2Scalar(6, 3, bw=bw, trans_back=True),
                 _rand(3, B, 16, 3, 6))


@pytest.mark.parametrize("binary", [False, True])
def test_svfuse_trans_back_matches_flax(binary):
    x = (_rand(4, B, 16, 12), _rand(5, B, 16, 3, 8))
    _layer_check(jsvl.SVFuse(3, binary, trans_back=True),
                 svl.SVFuse(8, 3, binary, trans_back=True), x)


@pytest.mark.parametrize("binary", [False, True])
def test_sv_stnkd_matches_flax(binary):
    x = (_rand(6, B, 16, 32), _rand(7, B, 16, 3, 10))
    _layer_check(jsvl.SV_STNkd(32, 10, binary),
                 svl.SV_STNkd(32, 10, binary, torch.Generator().manual_seed(0)),
                 x, RTOL, ATOL)


# ---------------------------------------------------------------------------
# the fold, B8 and B1-cross against the JAX kernels (interpret mode)
# ---------------------------------------------------------------------------


def _block_weights(S, V, S_out, V_out, binary, seed=0):
    blk = svl.SVBlock(S, V, S_out, V_out, binary,
                      torch.Generator().manual_seed(seed))
    return _tree(blk)


def _to_torch_tree(tree):
    return {n: _to_torch_tree(a) if isinstance(a, dict)
            else torch.from_numpy(np.asarray(a, dtype=np.float32))
            for n, a in tree.items()}


@pytest.mark.parametrize("binary", [False, True])
def test_fold_point_like_matches_jax(binary):
    var = _block_weights(64, 21, 512, 170, binary)
    want = jax_fold(var["params"], var["batch_stats"], 64, 21, binary)
    got = fold_point_like_params(_to_torch_tree(var["params"]),
                                 _to_torch_tree(var["batch_stats"]), 64, 21,
                                 binary)
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(w), rtol=1e-6,
                                   atol=0, err_msg=name)


# narrow, 512-wide, conv_fuse-wide
BLOCK_WIDTHS = [(32, 10, 32, 10), (64, 21, 512, 170), (1024, 340, 512, 170)]


@pytest.mark.parametrize("binary", [False, True], ids=["fp", "binary"])
@pytest.mark.parametrize("widths", BLOCK_WIDTHS, ids=["narrow", "512", "conv_fuse"])
def test_block_point_plain_matches_jax(widths, binary):
    """B8's plain version (what a CPU tensor gets) against
    sv_block_point in interpret mode."""
    S, V, S_out, V_out = widths
    var = _block_weights(S, V, S_out, V_out, binary, seed=S)
    folded = fold_point_like_params(_to_torch_tree(var["params"]),
                                    _to_torch_tree(var["batch_stats"]), S, V,
                                    binary)
    src = _rand(S + V, B, N, S + 3 * V)
    gate = 1 / (1 + np.exp(-_rand(V_out, B, V_out)))
    want = jax_block(jnp.asarray(src), jnp.asarray(gate),
                     jax.tree.map(lambda t: jnp.asarray(t.numpy()), folded),
                     S=S, V=V, S_out=S_out, V_out=V_out, T=N, binary=binary,
                     exact=True, interpret=True)
    before = sv_block_point.launches
    got = sv_block_point(torch.from_numpy(src), torch.from_numpy(gate), folded,
                         S=S, V=V, S_out=S_out, V_out=V_out, binary=binary)
    assert sv_block_point.launches == before  # the CPU runs no kernel
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,k", [(64, K), (40, 7)], ids=["N64", "ragged"])
def test_round3_first_cross_matches_jax(n, k):
    """B1 with cross=True: identical neighbour ids, outputs within
    rtol=1e-4, atol=1e-5."""
    w = init_params(CLASSES, k, False, torch.Generator().manual_seed(5))
    enc, enc_bs = w["params"]["feat"], w["batch_stats"]["feat"]
    folded = fold_first_params(enc["init_scalar"], enc["conv_pos"],
                               enc_bs["conv_pos"], n_ch=3)
    pts = _rand(n, B, n, 3)
    want = jax_first(jnp.asarray(pts), {m: jnp.asarray(t.numpy())
                                        for m, t in folded.items()},
                     S_out=32, V_out=10, k=k, mode="exact", cross=True,
                     interpret=True, emit_wins=True, cm=True)
    before = sv_round3_first.launches
    got = sv_round3_first(torch.from_numpy(pts), folded, S_out=32, V_out=10,
                          k=k, cross=True, emit_wins=True)
    assert sv_round3_first.launches == before
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert got[2].shape == (B, 9)
    for g, wt in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(wt), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# models and engines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[False, True], ids=["fp", "binary"])
def cls_setup(request):
    binary = request.param
    weights = init_params(CLASSES, K, binary, torch.Generator().manual_seed(1))
    var = to_flax(weights)
    points = _rand(0, B, N, 3)
    model = models.SV_PointNet_CLS(num_classes=CLASSES, k=K, binary=binary)
    want = np.asarray(jax.jit(model.apply)(var, jnp.asarray(points)))
    jeng = JaxClsEngine(var, num_classes=CLASSES, k=K, binary=binary,
                        exact=True, interpret=True)
    return binary, weights, points, want, np.asarray(jeng(jnp.asarray(points)))


@pytest.fixture(scope="module", params=[False, True], ids=["fp", "binary"])
def pseg_setup(request):
    binary = request.param
    weights = init_params_pseg(PARTS, K, binary, torch.Generator().manual_seed(1))
    var = to_flax(weights)
    points, label = _rand(0, B, N, 3), _labels()
    model = models.SV_PointNet_PSEG(num_part=PARTS, k=K, binary=binary)
    want = np.asarray(jax.jit(model.apply)(var, jnp.asarray(points),
                                           jnp.asarray(label)))
    jeng = JaxPsegEngine(var, num_part=PARTS, k=K, binary=binary, exact=True,
                         interpret=True)
    return (binary, weights, points, label, want,
            np.asarray(jeng(jnp.asarray(points), jnp.asarray(label))))


def test_eager_cls_matches_flax(cls_setup):
    binary, weights, points, want, _ = cls_setup
    model = SVPointNetCls.from_tree(weights, CLASSES, K, binary)
    with torch.no_grad():
        got = model(torch.from_numpy(points)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_cls_engine_matches_jax_engine(cls_setup):
    """FP and binary within rtol=1e-4, atol=1e-5 (binary holds: no sign
    flips at this size)."""
    binary, weights, points, _, want = cls_setup
    eng = SVPointNetClsEngine(weights, CLASSES, K, binary, device="cpu")
    got = eng(torch.from_numpy(points))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    oracle = SVPointNetClsEngine(weights, CLASSES, K, binary, device="cpu",
                                 oracle=True)
    assert torch.equal(oracle(torch.from_numpy(points)), got)


def test_eager_pseg_matches_flax(pseg_setup):
    binary, weights, points, label, want, _ = pseg_setup
    model = SVPointNetPseg.from_tree(weights, PARTS, K, binary)
    with torch.no_grad():
        got = model(torch.from_numpy(points), torch.from_numpy(label)).numpy()
    if binary:
        _flip_tolerant(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-4)


def test_pseg_engine_matches_jax_engine(pseg_setup):
    """FP within 1e-4; binary to the flip-tolerant bar (``_flip_tolerant``):
    sign flips cascade through the binary blocks at random init."""
    binary, weights, points, label, _, want = pseg_setup
    eng = SVPointNetPsegEngine(weights, PARTS, K, binary, device="cpu")
    got = eng(torch.from_numpy(points), torch.from_numpy(label)).numpy()
    assert got.shape == (B, N, PARTS)
    if binary:
        _flip_tolerant(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-4)


@pytest.mark.parametrize("kind", ["cls", "pseg"])
@pytest.mark.parametrize("binary", [False, True], ids=["fp", "binary"])
def test_init_params_trees_match_flax(kind, binary):
    """Keys and shapes of flax's init (nested ``feat/fstn/...`` included);
    the eager models load them with strict=True."""
    pts = jnp.zeros((1, 16, 3))
    if kind == "cls":
        model = models.SV_PointNet_CLS(num_classes=CLASSES, k=K, binary=binary)
        shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), pts)
        tree = init_params(CLASSES, K, binary, torch.Generator().manual_seed(0))
        SVPointNetCls.from_tree(tree, CLASSES, K, binary)
    else:
        model = models.SV_PointNet_PSEG(num_part=PARTS, k=K, binary=binary)
        shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), pts,
                                jnp.zeros((1, 16)))
        tree = init_params_pseg(PARTS, K, binary, torch.Generator().manual_seed(0))
        SVPointNetPseg.from_tree(tree, PARTS, K, binary)
    want = {jax.tree_util.keystr(p): tuple(a.shape)
            for p, a in jax.tree_util.tree_leaves_with_path(dict(shapes))}
    got = {jax.tree_util.keystr(p): tuple(a.shape)
           for p, a in jax.tree_util.tree_leaves_with_path(tree)}
    assert got == want


def test_cls_engine_rotation_invariant():
    """SO(3) invariance through the fused path, FP model (the bar of
    tests/test_infer_engine.py)."""
    gen = torch.Generator().manual_seed(2)
    eng = SVPointNetClsEngine(init_params(CLASSES, K, False, gen), CLASSES, K,
                              False, device="cpu")
    points = torch.randn(B, N, 3, generator=gen)
    rot = ops.random_rotations(B, gen)
    out = eng(points)
    out_r = eng(ops.rotate_points(points, rot))
    np.testing.assert_allclose(out_r.numpy(), out.numpy(), rtol=2e-2, atol=2e-3)


def test_wrappers_and_engines_check_arguments():
    """B8's argument checks; engines take the card unless asked for the
    CPU, and check their inputs."""
    S, V, S_out, V_out = BLOCK_WIDTHS[0]
    folded = fold_point_like_params(
        _to_torch_tree(_block_weights(S, V, S_out, V_out, True)["params"]),
        _to_torch_tree(_block_weights(S, V, S_out, V_out, True)["batch_stats"]),
        S, V, True)
    kw = dict(S=S, V=V, S_out=S_out, V_out=V_out)
    with pytest.raises(ValueError):
        sv_block_point(torch.zeros(1, 16, S + 3 * V - 1), torch.zeros(1, V_out),
                       folded, **kw)
    with pytest.raises(ValueError):
        sv_block_point(torch.zeros(1, 16, S + 3 * V), torch.zeros(2, V_out),
                       folded, **kw)
    w = init_params(CLASSES, K, True, torch.Generator().manual_seed(0))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            SVPointNetClsEngine(w)  # the card by default, never a fallback
    eng = SVPointNetClsEngine(w, CLASSES, K, True, device="cpu")
    with pytest.raises(ValueError):
        eng(torch.zeros(1, 16, 3, dtype=torch.float64))
    with pytest.raises(ValueError):
        SVPointNetClsEngine(w, CLASSES, K, True, mode="turbo", device="cpu")
    pseg = SVPointNetPsegEngine(init_params_pseg(PARTS, K, True), PARTS, K,
                                True, device="cpu")
    with pytest.raises(ValueError):
        pseg(torch.zeros(1, 16, 3), torch.zeros(1, 15))
