"""The port's VN layers, graph ops for the VN and original DGCNNs,
PointNet++ sampling and the T-Net losses against the JAX package (CPU,
small shapes; no Pallas kernel lies on these paths).

Weights are drawn by the port (``nn.scope.init_tree``), the running
statistics moved off their init by the suite's recipe (x + 0.3|x| +
0.05), and handed to flax as numpy; each layer runs in eval mode and in
train mode (``mutable=["batch_stats"]``), outputs and new statistics
compared, train mode in float64. Tolerances: float32 summed in another
order, rtol 1e-4 and atol 1e-5 (1e-6 where no sum over channels lies in
between); float64 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnet_tpu import ops as jops
from svnet_tpu.nn import vn_layers as jvn
from svnet_tpu.ops import sampling as jsamp
from svnet_tpu.train import losses as jlosses
from svnet_tpu_torch import ops
from svnet_tpu_torch.nn import vn_layers as vnl
from svnet_tpu_torch.nn.scope import Scope, ScopedModel, init_tree
from svnet_tpu_torch.ops import sampling
from svnet_tpu_torch.train import losses
from svnet_tpu_torch.train.steps import tree_map
from svnet_tpu_torch.utils.convert import flatten, from_flax, module_tree, to_flax

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _bumped(tree):
    """The suite's non-trivial running statistics on a drawn tree."""
    return {"params": tree["params"], "batch_stats": tree_map(
        lambda t: t + 0.3 * torch.abs(t) + 0.05, tree["batch_stats"])}


def _check_layer(flax_mod, port_fn, x, has_train=True, **kw):
    """``port_fn(scope, x, **kw)`` against ``flax_mod`` on the same drawn
    weights: eval mode in float32 (RTOL, ATOL); with ``has_train`` train
    mode in float64 (JAX with x64 enabled, 1e-9), where a BatchNorm over
    few samples does not magnify the rounding of another summation order,
    new running statistics included."""
    tree = _bumped(init_tree(port_fn, (torch.from_numpy(x),), kw,
                             torch.Generator().manual_seed(7)))
    var = to_flax(tree)
    for train in ((False, True) if has_train else (False,)):
        dt, tol = (np.float64, (1e-9, 1e-9)) if train else (np.float32, (RTOL, ATOL))
        with jax.enable_x64(train):
            v = jax.tree.map(lambda a: np.asarray(a, dt), var)
            args = (jnp.asarray(x.astype(dt)),) + ((train,) if has_train else ())
            if train:
                want, upd = flax_mod.apply(v, *args, mutable=["batch_stats"])
            else:
                want, upd = flax_mod.apply(v, *args), None
        s = Scope(tree_map(lambda t: t.to(torch.float64 if train else torch.float32),
                           from_flax(var)), train=train)
        got = port_fn(s, torch.from_numpy(x.astype(dt)), **kw)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                       rtol=tol[0], atol=tol[1])
        if upd is not None:
            want_st = flatten(jax.tree.map(np.asarray, dict(upd["batch_stats"])))
            got_st = flatten(s.new)
            assert set(got_st) == set(want_st)
            for path, w in want_st.items():
                np.testing.assert_allclose(got_st[path].numpy(), w, rtol=tol[0],
                                           atol=tol[1])


def test_vn_layers_match_flax():
    """Every VN layer: VNLinear, VNLeakyReLU (per channel and shared),
    VNBatchNorm, VNLinearLeakyReLU, VNLinearAndLeakyReLU (with and
    without BN), VNMaxPool over k and over the points (ties to the first),
    mean_pool, VNStdFeature (both frames) and VN_STNkd (mean and max)."""
    v = _rand(0, 4, 16, 3, 6)  # (B, N, 3, C)
    e = _rand(1, 4, 16, 5, 3, 6)  # (B, N, k, 3, C)
    _check_layer(jvn.VNLinear(8), lambda s, x: vnl.vn_linear(s, x, 8), v,
                 has_train=False)
    for share in (False, True):
        _check_layer(jvn.VNLeakyReLU(share_nonlinearity=share),
                     lambda s, x, share=share: vnl.vn_leaky_relu(s, x, share=share),
                     v, has_train=False)
        _check_layer(jvn.VNLinearLeakyReLU(8, share_nonlinearity=share),
                     lambda s, x, share=share: vnl.vn_linear_leaky_relu(
                         s, x, 8, share=share), e)
    _check_layer(jvn.VNBatchNorm(), vnl.vn_batch_norm, v)
    for bn in ("norm", "none"):
        _check_layer(jvn.VNLinearAndLeakyReLU(8, use_batchnorm=bn),
                     lambda s, x, bn=bn: vnl.vn_linear_and_leaky_relu(
                         s, x, 8, use_batchnorm=bn), v)
    tied = e.copy()
    tied[:, :, 1] = tied[:, :, 0]  # two neighbours tie: the first wins
    for x, axis in ((e, 2), (tied, 2), (v, 1)):
        _check_layer(jvn.VNMaxPool(axis=axis),
                     lambda s, x, axis=axis: vnl.vn_max_pool(s, x, axis), x,
                     has_train=False)
    np.testing.assert_allclose(vnl.mean_pool(torch.from_numpy(e), 2).numpy(),
                               np.asarray(jvn.mean_pool(jnp.asarray(e), 2)),
                               rtol=1e-6, atol=1e-7)
    w = _rand(2, 4, 16, 3, 12)
    for frame in (False, True):
        _check_layer(jvn.VNStdFeature(normalize_frame=frame),
                     lambda s, x, frame=frame: vnl.vn_std_feature(
                         s, x, normalize_frame=frame), w)
    for pooling in ("mean", "max"):
        _check_layer(jvn.VN_STNkd(d=6, pooling=pooling),
                     lambda s, x, pooling=pooling: vnl.vn_stnkd(s, x, 6, pooling),
                     _rand(3, 8, 16, 3, 6))


def test_vn_and_scalar_graph_features_match_jax():
    """``vn_graph_feature`` and ``scalar_graph_feature`` on the CPU (the
    plain kNN and gather): the same neighbour ids as JAX's ``knn`` and the
    same edges; the gather's gradient reaches the features (B7's plain
    backward), the ids none."""
    v = _rand(4, 2, 32, 3, 5)
    x = _rand(5, 2, 32, 7)
    for port_fn, jax_fn, inp, flat in (
            (ops.vn_graph_feature, jops.vn_graph_feature, v, v.reshape(2, 32, -1)),
            (ops.scalar_graph_feature, jops.scalar_graph_feature, x, x)):
        np.testing.assert_array_equal(
            ops.knn(torch.from_numpy(flat), 6).numpy(),
            np.asarray(jops.knn(jnp.asarray(flat), 6)))
        want = np.asarray(jax_fn(jnp.asarray(inp), 6))
        t = torch.from_numpy(inp).requires_grad_(True)
        got = port_fn(t, 6)
        np.testing.assert_array_equal(got.detach().numpy(), want)
        g = _rand(6, *got.shape)
        got.backward(torch.from_numpy(g))
        _, vjp = jax.vjp(lambda a: jax_fn(a, 6), jnp.asarray(inp))
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                                   rtol=1e-5, atol=1e-5)
        assert port_fn(t, 6, plain=True).shape == want.shape


def test_sampling_matches_jax():
    """``ops/sampling.py`` against svnet_tpu/ops/sampling.py: the FPS ids
    (from point 0) and the ball query's ids equal; square distances,
    index_points and both groupings within float32 rounding."""
    xyz = _rand(7, 2, 64, 3)
    feats = _rand(8, 2, 64, 5)
    xt, ft = torch.from_numpy(xyz), torch.from_numpy(feats)
    np.testing.assert_allclose(
        sampling.square_distance(xt, xt[:, :10]).numpy(),
        np.asarray(jsamp.square_distance(jnp.asarray(xyz), jnp.asarray(xyz[:, :10]))),
        rtol=1e-5, atol=1e-5)
    fps = sampling.farthest_point_sample(xt, 16)
    want_fps = np.asarray(jsamp.farthest_point_sample(jnp.asarray(xyz), 16))
    np.testing.assert_array_equal(fps.numpy(), want_fps)
    assert fps.dtype == torch.int32
    np.testing.assert_array_equal(
        sampling.index_points(xt, fps).numpy(),
        np.asarray(jsamp.index_points(jnp.asarray(xyz), jnp.asarray(want_fps))))
    centres = xyz[:, :12]
    for radius in (0.3, 1.0):  # most slots repeat the first / few do
        np.testing.assert_array_equal(
            sampling.query_ball_point(radius, 8, xt, torch.from_numpy(centres)).numpy(),
            np.asarray(jsamp.query_ball_point(radius, 8, jnp.asarray(xyz),
                                              jnp.asarray(centres))))
    for points in (None, feats):
        got = sampling.sample_and_group(12, 0.8, 8, xt, None if points is None
                                        else ft, return_fps=True)
        want = jsamp.sample_and_group(12, 0.8, 8, jnp.asarray(xyz), None if points
                                      is None else jnp.asarray(points),
                                      return_fps=True)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
        got = sampling.sample_and_group_all(xt, None if points is None else ft)
        want = jsamp.sample_and_group_all(jnp.asarray(xyz), None if points is None
                                          else jnp.asarray(points))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_tnet_losses_match_jax():
    """``feature_transform_regularizer`` (the reference's ``T (T^t - I)``)
    and ``cal_pointnet_loss`` within 1e-6 relative; ``model_loss`` takes
    ``cal_loss`` on plain logits and the regularized loss on a pair."""
    trans = _rand(9, 4, 8, 8)
    logits, target = _rand(10, 4, 15), np.array([1, 14, 3, 0])
    np.testing.assert_allclose(
        losses.feature_transform_regularizer(torch.from_numpy(trans)).item(),
        float(jlosses.feature_transform_regularizer(jnp.asarray(trans))), rtol=1e-6)
    got = losses.cal_pointnet_loss((torch.from_numpy(logits), torch.from_numpy(trans)),
                                   torch.from_numpy(target))
    want = jlosses.cal_pointnet_loss((jnp.asarray(logits), jnp.asarray(trans)),
                                     jnp.asarray(target))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    pair = (torch.from_numpy(logits), torch.from_numpy(trans))
    assert losses.model_loss(pair, torch.from_numpy(target)).item() == got.item()
    assert losses.model_loss(pair[0], torch.from_numpy(target)).item() == \
        losses.cal_loss(pair[0], torch.from_numpy(target)).item()


def test_scoped_model_registers_the_flax_tree():
    """A ``ScopedModel``'s parameters and buffers are its function's tree,
    dotted; ``forward`` and ``make_train_apply`` run the same function."""

    def fn(s, points, k=2):
        return vnl.vn_linear_leaky_relu(s.child("conv"), points[..., None], 4)

    class Tiny(ScopedModel):
        forward_fn = fn

    model = Tiny(torch.Generator().manual_seed(0), k=2)
    assert sorted(n for n, _ in model.named_parameters()) == [
        "conv.batchnorm.bn.bias", "conv.batchnorm.bn.scale",
        "conv.map_to_dir.kernel", "conv.map_to_feat.kernel"]
    assert sorted(n for n, _ in model.named_buffers()) == [
        "conv.batchnorm.bn.mean", "conv.batchnorm.bn.var"]
    pts = torch.from_numpy(_rand(11, 2, 5, 3))
    t = module_tree(model)
    out, new = model.make_train_apply()(t["params"], t["batch_stats"], pts)
    assert out.shape == (2, 5, 3, 4)
    assert sorted(flatten(new)) == ["conv.batchnorm.bn.mean", "conv.batchnorm.bn.var"]
    with torch.no_grad():
        assert model(pts).shape == (2, 5, 3, 4)
