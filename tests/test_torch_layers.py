"""The PyTorch port's eager layers, kNN, graph ops and init against the JAX
package (CPU, small shapes). Inputs are made with numpy from a seed and
handed to both sides."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnet_tpu import models, ops as jops
from svnet_tpu.nn import sv_layers as jsvl
from svnet_tpu_torch import config, ops
from svnet_tpu_torch.models.sv_dgcnn import init_params
from svnet_tpu_torch.nn import sv_layers as svl
from svnet_tpu_torch.utils.convert import from_flax, load_tree

RTOL, ATOL = 1e-5, 1e-6  # f32, summation order differs between frameworks


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's thread pool only competes with the other
    test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _check(flax_module, torch_module, x):
    """Same input and weights through the flax layer (init, with the test
    suite's non-trivial BN running stats) and the port's layer."""
    xj = jax.tree.map(jnp.asarray, x)
    var = jax.tree.map(np.asarray, dict(
        flax_module.init(jax.random.PRNGKey(0), xj)))
    var["batch_stats"] = jax.tree.map(
        lambda a: a + 0.3 * np.abs(a) + 0.05, var.get("batch_stats", {}))
    want = flax_module.apply(var, xj)
    load_tree(torch_module, from_flax(var))
    with torch.no_grad():
        got = torch_module(jax.tree.map(torch.from_numpy, x))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bw,ba", [(False, False), (True, False), (True, True)])
def test_linear_matches_flax(bw, ba):
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 16, 24)
    flax_m = jsvl.Linear(12, use_bias=True, bw=bw, ba=ba)
    _check(flax_m, svl.Linear(24, 12, True, bw, ba), x)


def test_linear_binary_sign_zero_is_zero():
    """jnp.sign(0) = 0: a zero activation contributes nothing."""
    lin = svl.Linear(4, 3, use_bias=False, bw=True, ba=True)
    with torch.no_grad():
        lin.kernel.fill_(1.0)
        lin.scale.fill_(1.0)
        y = lin(torch.tensor([[0.0, 0.0, 1.0, -1.0]]))
    assert torch.equal(y, torch.zeros(1, 3))


def test_vector_bn_matches_flax():
    rng = np.random.default_rng(1)
    _check(jsvl.VectorBN(), svl.VectorBN(7), _rand(rng, 2, 16, 3, 7))


@pytest.mark.parametrize("bw", [False, True])
def test_vector2scalar_matches_flax(bw):
    rng = np.random.default_rng(2)
    _check(jsvl.Vector2Scalar(3, bw=bw), svl.Vector2Scalar(5, 3, bw=bw),
           _rand(rng, 2, 16, 4, 3, 5))


@pytest.mark.parametrize("binary", [False, True])
def test_svblock_matches_flax(binary):
    rng = np.random.default_rng(3)
    s, v = _rand(rng, 2, 16, 4, 12), _rand(rng, 2, 16, 4, 3, 8)
    _check(jsvl.SVBlock(10, 6, binary), svl.SVBlock(12, 8, 10, 6, binary),
           (s, v))


@pytest.mark.parametrize("binary", [False, True])
def test_svfuse_matches_flax(binary):
    rng = np.random.default_rng(4)
    s, v = _rand(rng, 2, 16, 12), _rand(rng, 2, 16, 3, 8)
    _check(jsvl.SVFuse(3, binary), svl.SVFuse(8, 3, binary), (s, v))


@pytest.mark.parametrize("C", [3, 24])
def test_knn_matches_jax(C):
    rng = np.random.default_rng(5)
    x = _rand(rng, 2, 64, C)
    want = np.asarray(jops.knn(jnp.asarray(x), 6))
    got = ops.knn(torch.from_numpy(x), 6).numpy()
    np.testing.assert_array_equal(got, want)


def test_knn_ties_go_to_min_row():
    """Duplicated points force exact distance ties: both sides rank the
    tied rows by increasing row id (the exact-mode key)."""
    rng = np.random.default_rng(6)
    x = np.round(_rand(rng, 2, 64, 6) * 2.0) / 2.0
    x[:, 32:] = x[:, :32]
    want = np.asarray(jops.knn(jnp.asarray(x), 8))
    got = ops.knn(torch.from_numpy(x), 8).numpy()
    np.testing.assert_array_equal(got, want)
    # each point's duplicate ties with it at distance 0: min row first
    assert (got[:, 32:, 0] == np.arange(32)).all()


def test_pairwise_self_distance_is_zero():
    rng = np.random.default_rng(7)
    d = ops.pairwise_neg_sqdist(torch.from_numpy(_rand(rng, 2, 32, 17)))
    assert torch.equal(torch.diagonal(d, dim1=1, dim2=2), torch.zeros(2, 32))


def test_graph_features_and_pooling_match_jax():
    rng = np.random.default_rng(8)
    pts = _rand(rng, 2, 32, 3)
    s, v = _rand(rng, 2, 32, 5), _rand(rng, 2, 32, 3, 4)
    k = 5
    np.testing.assert_allclose(
        ops.get_graph_feature(torch.from_numpy(pts), k).numpy(),
        np.asarray(jops.get_graph_feature(jnp.asarray(pts), k)), rtol=0, atol=0)
    want = jops.get_graph_feature_sv((jnp.asarray(s), jnp.asarray(v)), k)
    got = ops.get_graph_feature_sv((torch.from_numpy(s), torch.from_numpy(v)), k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(ops.svpool(got), jops.svpool(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
    x = [(torch.from_numpy(s), torch.from_numpy(v))] * 2
    xj = [(jnp.asarray(s), jnp.asarray(v))] * 2
    for g, w in zip(ops.svcat(x), jops.svcat(xj)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("binary", [False, True])
def test_init_params_tree_matches_flax(binary):
    model = models.SV_DGCNN_CLS(num_classes=10, k=4, binary=binary)
    # the tree's shapes only: nothing is computed
    var = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 3)))
    want = {jax.tree_util.keystr(p): np.shape(a)
            for p, a in jax.tree_util.tree_leaves_with_path(dict(var))}
    tree = init_params(10, 4, binary, torch.Generator().manual_seed(0))
    got = {jax.tree_util.keystr(p): tuple(a.shape)
           for p, a in jax.tree_util.tree_leaves_with_path(tree)}
    assert got == want
    assert tuple(tree["params"]["conv2"]["linear1"]["kernel"].shape) == (124, 32)
    # running stats follow the x + 0.3|x| + 0.05 recipe (var 1 -> 1.35)
    assert torch.allclose(tree["batch_stats"]["bn1"]["bn"]["var"],
                          torch.full((512,), 1.35))


def test_rotations_are_rotations():
    r = ops.random_rotations(8, torch.Generator().manual_seed(0))
    eye = torch.eye(3).expand(8, 3, 3)
    assert torch.allclose(r @ r.transpose(1, 2), eye, atol=1e-5)
    assert torch.allclose(torch.linalg.det(r), torch.ones(8), atol=1e-5)


@pytest.mark.parametrize("trunk", ["round2", "round", "edge"])
def test_config_accepts_only_exact_and_requires_cuda(trunk):
    """The legacy row-major trunks and the edge trunk take fast and approx
    mode at the knobs' defaults and refuse a knob that would not act
    there (C23); a CUDA device is required."""
    assert config.check_mode("exact", trunk) == "exact"
    for mode in ("fast", "approx"):
        assert config.check_mode(mode, trunk) == mode
    was = (config.fast_gather_bits, config.approx_gather_bits,
           config.approx_fold)
    try:
        for setter, value, mode in ((config.set_fast_gather_bits, 8, "fast"),
                                    (config.set_approx_gather_bits, 8, "approx"),
                                    (config.set_approx_fold, 128, "approx")):
            setter(value)
            with pytest.raises(ValueError, match="C23"):
                config.check_mode(mode, trunk)
            assert config.check_mode(mode) == mode  # round3 reads it
            assert config.check_mode("exact", trunk) == "exact"
    finally:
        config.set_fast_gather_bits(was[0])
        config.set_approx_gather_bits(was[1])
        config.set_approx_fold(was[2])
    with pytest.raises(RuntimeError):
        config.require_cuda("cpu")


def test_config_accepts_fast_on_round3_only():
    assert config.check_mode("fast") == config.check_mode("fast", "round3") == "fast"
    assert config.check_mode("approx") == "approx"
    with pytest.raises(ValueError):
        config.check_mode("turbo")
    with pytest.raises(ValueError):
        config.set_fast_gather_bits(12)


def test_package_imports_no_jax():
    """The port and chip_smoke.py import neither JAX, flax nor the JAX
    package: the machine with the card has none of them."""
    root = Path(__file__).resolve().parents[1]
    files = [*(root / "svnet_tpu_torch").rglob("*.py"), root / "chip_smoke.py"]
    for path in files:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                mod = words[1].split(".")[0]
                assert mod not in ("jax", "flax", "svnet_tpu"), (path, line)
