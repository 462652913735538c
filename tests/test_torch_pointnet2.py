"""The port's PointNet++ modules (``svnet_tpu_torch/nn/pointnet2.py``)
against the JAX package's (svnet_tpu/nn/pointnet2.py; CPU, B=2, N=128,
32 centres, groups of 8, narrow MLPs).

The weights are flax ``init``'s, carried through ``from_flax``, the
running statistics bumped by the suite's recipe (x + 0.3|x| + 0.05).
Eval mode in float32 (rtol 1e-4, atol 1e-5 of the largest |value|: the
same products summed in another order); train mode in float64 (JAX with
x64 enabled; 1e-9, feature propagation from 32 points 1e-5: JAX's
distances stay float32), the new running statistics included. The ids under
each module are compared exactly: the FPS centres and ball-query groups
(``ops/sampling.py``) and the 3-NN of feature propagation, with tied
distances (duplicated sparse points: ``jax.lax.top_k`` takes the lower
id, and so does the port's stable sort).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnet_tpu.nn import pointnet2 as jp2
from svnet_tpu.ops import sampling as jsamp
from svnet_tpu_torch.nn import pointnet2 as p2
from svnet_tpu_torch.nn.scope import Scope
from svnet_tpu_torch.ops import sampling
from svnet_tpu_torch.train.steps import tree_map
from svnet_tpu_torch.utils.convert import flatten, from_flax

B, N, S, K = 2, 128, 32, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, rtol, atol_rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * (np.abs(want).max() + 1e-300),
                               err_msg=what)


def check_module(jmod, port_fn, inputs, train_tol=(1e-9, 1e-9), **kw):
    """``port_fn(scope, *inputs, **kw)`` against ``jmod`` on flax init's
    weights: eval in float32, train in float64 (``train_tol``: rtol and
    atol of the largest |value|) with the new running statistics.
    Returns the eval outputs."""
    args = [None if a is None else jnp.asarray(a) for a in inputs]
    var = jax.tree.map(np.asarray, dict(jmod.init(jax.random.PRNGKey(4), *args)))
    var["batch_stats"] = jax.tree.map(lambda a: a + 0.3 * np.abs(a) + 0.05,
                                      var["batch_stats"])
    out = None
    for train in (False, True):
        dt = np.float64 if train else np.float32
        with jax.enable_x64(train):
            v = jax.tree.map(lambda a: np.asarray(a, dt), var)
            a = [None if x is None else jnp.asarray(x.astype(dt)) for x in inputs]
            if train:
                want, upd = jmod.apply(v, *a, True, mutable=["batch_stats"])
            else:
                want, upd = jmod.apply(v, *a, False), None
        tree = tree_map(lambda t: t.to(torch.float64 if train else torch.float32),
                        from_flax(var))
        s = Scope(tree, train=train)
        got = port_fn(s, *[None if x is None else torch.from_numpy(x.astype(dt))
                           for x in inputs], **kw)
        tol = train_tol if train else (1e-4, 1e-5)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            _close(g.numpy(), np.asarray(w), *tol, f"train={train}")
        if train:
            want_st = flatten(jax.tree.map(np.asarray, dict(upd["batch_stats"])))
            got_st = flatten(s.new)
            assert set(got_st) == set(want_st)
            for path, w in want_st.items():
                _close(got_st[path].numpy(), w, *tol, path)
        else:
            out = got
    return out


@pytest.mark.parametrize("features", [False, True])
def test_set_abstraction(features):
    """SA(32, 0.8, 8, [16, 32]) on xyz with and without 5 features: the
    FPS centres and the ball-query groups bitwise JAX's, the module's
    outputs."""
    xyz, pts = _rand(0, B, N, 3), _rand(1, B, N, 5) if features else None
    xt = torch.from_numpy(xyz)
    fps = sampling.farthest_point_sample(xt, S)
    np.testing.assert_array_equal(fps.numpy(),
                                  np.asarray(jsamp.farthest_point_sample(xyz, S)))
    centres = sampling.index_points(xt, fps)
    idx = sampling.query_ball_point(0.8, K, xt, centres)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jsamp.query_ball_point(
        0.8, K, jnp.asarray(xyz), jnp.asarray(centres.numpy()))))
    new_xyz, _ = check_module(jp2.PointNetSetAbstraction(S, 0.8, K, [16, 32]),
                              p2.set_abstraction, (xyz, pts), npoint=S, radius=0.8,
                              nsample=K, mlp=[16, 32])
    np.testing.assert_array_equal(new_xyz.numpy(), centres.numpy())


def test_set_abstraction_group_all():
    """SA with ``group_all`` (one group of every point about the origin,
    xyz then the features), MLP [16, 32], with and without 5 features:
    (B, 1, 3) zeros and (B, 1, 32)."""
    for features in (False, True):
        xyz, pts = _rand(2, B, N, 3), _rand(3, B, N, 5) if features else None
        new_xyz, feats = check_module(
            jp2.PointNetSetAbstraction(None, None, None, [16, 32], group_all=True),
            p2.set_abstraction, (xyz, pts), npoint=None, radius=None, nsample=None,
            mlp=[16, 32], group_all=True)
        assert new_xyz.shape == (B, 1, 3) and not new_xyz.any()
        assert feats.shape == (B, 1, 32)


def test_set_abstraction_msg():
    """SA-Msg(32, [0.4, 0.8, 1.6], [4, 8, 16], [[8, 16], [16, 16], [16, 24]])
    with 5 features (each group: the features, then the relative xyz):
    every radius's ball-query ids bitwise JAX's, the (B, 32, 56) output."""
    xyz, pts = _rand(4, B, N, 3), _rand(5, B, N, 5)
    radii, counts = [0.4, 0.8, 1.6], [4, 8, 16]
    mlps = [[8, 16], [16, 16], [16, 24]]
    xt = torch.from_numpy(xyz)
    centres = sampling.index_points(xt, sampling.farthest_point_sample(xt, S))
    for r, k in zip(radii, counts):
        np.testing.assert_array_equal(
            sampling.query_ball_point(r, k, xt, centres).numpy(),
            np.asarray(jsamp.query_ball_point(r, k, jnp.asarray(xyz),
                                              jnp.asarray(centres.numpy()))))
    new_xyz, feats = check_module(
        jp2.PointNetSetAbstractionMsg(S, radii, counts, mlps),
        p2.set_abstraction_msg, (xyz, pts), npoint=S, radius_list=radii,
        nsample_list=counts, mlp_list=mlps)
    np.testing.assert_array_equal(new_xyz.numpy(), centres.numpy())
    assert feats.shape == (B, S, 56)


@pytest.mark.parametrize("sparse", ["ties", "one"])
def test_feature_propagation(sparse):
    """FP([24, 16]) from 32 sparse points (a third of them duplicated, so
    distances tie exactly: the 3-NN ids bitwise ``jax.lax.top_k``'s) or
    from one (S == 1: broadcast), beside 6 dense features."""
    xyz1, pts1 = _rand(6, B, N, 3), _rand(7, B, N, 6)
    if sparse == "ties":
        base = _rand(8, B, 22, 3)
        xyz2 = np.concatenate([base, base[:, :10]], axis=1)[:, np.random.default_rng(
            9).permutation(32)]
    else:
        xyz2 = _rand(8, B, 1, 3)
    pts2 = _rand(10, B, xyz2.shape[1], 7)
    if sparse == "ties":
        d, idx = p2.three_nn(torch.from_numpy(xyz1), torch.from_numpy(xyz2))
        neg, want_idx = jax.lax.top_k(-jsamp.square_distance(jnp.asarray(xyz1),
                                                             jnp.asarray(xyz2)), 3)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
        np.testing.assert_allclose(d.numpy(), -np.asarray(neg), rtol=1e-5, atol=1e-6)
        # some point's 3 nearest hold a duplicated pair, at an exact tie
        ids = idx.numpy()
        assert any(np.array_equal(xyz2[b, ids[b, n, i]], xyz2[b, ids[b, n, i + 1]])
                   for b in range(B) for n in range(N) for i in range(2))
    # JAX's squared distances are float32 even with x64 enabled (its
    # einsum's preferred_element_type), and 2<x, y> - |x|^2 - |y|^2 cancels
    # for a near pair: the weights 1 / (d + 1e-8) agree to float32's
    # rounding of the three terms, 1e-5 of the largest output
    out = check_module(jp2.PointNetFeaturePropagation([24, 16]),
                       p2.feature_propagation, (xyz1, xyz2, pts1, pts2),
                       train_tol=(0.0, 1e-5) if sparse == "ties" else (1e-9, 1e-9),
                       mlp=[24, 16])
    assert out.shape == (B, N, 16)
