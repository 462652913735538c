"""The SV-DGCNN and SV-PointNet engines in approx mode against the JAX
engines on the CPU (the Pallas kernels in interpret mode), to the bars of
tests/test_torch_approx.py, whose helpers and autouse ``_one_torch_thread``
this file imports.

At most six tests a file: pytest-xdist's ``--dist loadfile`` queues files
by their number of tests, largest first, so these long JAX references run
beside tests/test_sharded_infer.py, the suite's longest file, instead of
ahead of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from svnet_tpu import models
from svnet_tpu.infer import SVDGCNNClsEngine as JaxDGCNNEngine
from svnet_tpu.infer import SVDGCNNPsegEngine as JaxPsegEngine
from svnet_tpu.infer import SVPointNetClsEngine as JaxPointNetEngine
from svnet_tpu_torch.infer import (
    SVDGCNNClsEngine,
    SVDGCNNPsegEngine,
    SVPointNetClsEngine,
)
from svnet_tpu_torch.models import sv_pointnet
from svnet_tpu_torch.models.sv_dgcnn import init_params_pseg
from svnet_tpu_torch.utils.convert import from_flax, to_flax

from test_torch_fast import _rand, _with_beta
from test_torch_train import compile_once
from test_torch_approx import B, K_ENG, N_ENG, _approx, _one_torch_thread


def _shuffled(points, seed):
    perm = np.random.default_rng(seed).permutation(points.shape[1])
    return points[:, perm], perm


def test_dgcnn_cls_engine_approx_matches_jax():
    """The binary classifier, fold 64 (L = 64 at N = 128), both sorting at
    entry; shuffled points give the same logits."""
    model = models.SV_DGCNN_CLS(num_classes=10, k=K_ENG, binary=True)
    points = _rand(7, B, N_ENG, 3)
    # one compile of init instead of its eager ops (bitwise the same tree)
    init_args = (jax.random.PRNGKey(1), jnp.asarray(points))
    var = compile_once(model.init, *init_args)(*init_args)
    weights = _with_beta(from_flax(jax.tree.map(np.asarray, {
        "params": var["params"], "batch_stats": jax.tree.map(
            lambda x: x + 0.3 * jnp.abs(x) + 0.05, var["batch_stats"])})), 6)
    with _approx(fold=64):
        jeng = JaxDGCNNEngine(to_flax(weights), num_classes=10, k=K_ENG,
                              binary=True, mode="approx", interpret=True)
        want = np.asarray(jeng(jnp.asarray(points)))
        eng = SVDGCNNClsEngine(weights, 10, K_ENG, True, mode="approx",
                               device="cpu")
        got = eng(torch.from_numpy(points))
        shuffled, _ = _shuffled(points, 1)
        got_sh = eng(torch.from_numpy(shuffled))
        oracle = SVDGCNNClsEngine(weights, 10, K_ENG, True, mode="approx",
                                  device="cpu", oracle=True)
        assert torch.equal(oracle(torch.from_numpy(points)), got)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_sh.numpy(), got.numpy(), rtol=1e-4, atol=1e-5)


def test_dgcnn_pseg_engine_approx_matches_jax():
    """The FP part segmenter, fold 64, 8-bit gathers: logits against the
    JAX engine's in the input's order (both un-permute the sort), and
    shuffled points give the shuffled logits."""
    weights = init_params_pseg(50, K_ENG, False, torch.Generator().manual_seed(2))
    points = _rand(8, B, N_ENG, 3)
    label = np.eye(16, dtype=np.float32)[[3, 11]]
    with _approx(fold=64, bits=8):
        jeng = JaxPsegEngine(to_flax(weights), num_part=50, k=K_ENG,
                             binary=False, mode="approx", interpret=True)
        want = np.asarray(jeng(jnp.asarray(points), jnp.asarray(label)))
        eng = SVDGCNNPsegEngine(weights, 50, K_ENG, False, mode="approx",
                                device="cpu")
        got = eng(torch.from_numpy(points), torch.from_numpy(label)).numpy()
        shuffled, perm = _shuffled(points, 2)
        got_sh = eng(torch.from_numpy(shuffled), torch.from_numpy(label)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_sh, got[:, perm], rtol=1e-4, atol=1e-4)


def test_pointnet_cls_engine_approx_matches_jax():
    """SV-PointNet in approx mode at 8-bit gathers, no entry sort on
    either side."""
    weights = sv_pointnet.init_params(10, K_ENG, False,
                                      torch.Generator().manual_seed(1))
    points = _rand(8, B, N_ENG, 3)
    with _approx(fold=64, bits=8):
        jeng = JaxPointNetEngine(to_flax(weights), num_classes=10, k=K_ENG,
                                 binary=False, mode="approx", interpret=True)
        want = np.asarray(jeng(jnp.asarray(points)))
        got = SVPointNetClsEngine(weights, 10, K_ENG, False, mode="approx",
                                  device="cpu")(torch.from_numpy(points))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
