"""The port's AOT artifact against JAX's (svnet_tpu/serve.py), on the CPU:
the SV-DGCNN classifier exported by both packages on the same weights
(flax ``model.init``, carried across by ``from_flax``), and
``python -m svnet_tpu_torch.serve`` end to end on a port checkpoint, as
tests/test_serve.py::test_serve_cli_exports_checkpoint runs JAX's.

The bar is the live engines' (tests/test_torch_engine.py: rtol 1e-4, atol
1e-5). The other engines are held through a chain of checks: the port's
artifact equals its live engine bitwise (tests/test_torch_serve.py), the
live engine is held to JAX's (tests/test_torch_*engine*.py), and JAX's
artifact equals JAX's live engine (tests/test_serve.py). One JAX export
(the interpreter program of its Pallas kernels) serves both tests here.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnet_tpu import models
from svnet_tpu.infer import SVDGCNNClsEngine as JaxEngine
from svnet_tpu.serve import export_engine as jax_export
from svnet_tpu.serve import load_engine as jax_load
from svnet_tpu_torch.infer import SVDGCNNClsEngine
from svnet_tpu_torch.serve import export_engine, load_engine
from svnet_tpu_torch.utils.convert import from_flax

from test_torch_engine import ATOL, RTOL, _one_torch_thread  # noqa: F401

B, N, K, CLASSES = 2, 128, 8, 10


@pytest.fixture(scope="module")
def jax_artifact():
    """Seeded points, the flax variables (batch stats moved off their
    init), and JAX's loaded artifact's logits on the points."""
    model = models.SV_DGCNN_CLS(num_classes=CLASSES, k=K, binary=True)
    points = np.random.default_rng(0).standard_normal((B, N, 3)).astype(np.float32)
    var = jax.jit(model.init)(jax.random.PRNGKey(1), jnp.asarray(points))
    var = {"params": var["params"], "batch_stats": jax.tree.map(
        lambda x: x + 0.3 * jnp.abs(x) + 0.05, var["batch_stats"])}
    eng = JaxEngine(var, num_classes=CLASSES, k=K, binary=True, tile=32,
                    mode="exact", interpret=True)
    call = jax_load(bytes(jax_export(eng, jnp.asarray(points))))
    want = np.asarray(call(jnp.asarray(points)))
    return points, from_flax(jax.tree.map(np.asarray, var)), want


def test_artifact_matches_jax_artifact(jax_artifact):
    """Both packages' exported SV-DGCNN classifiers on the same weights."""
    points, weights, want = jax_artifact
    eng = SVDGCNNClsEngine(weights, CLASSES, K, True, device="cpu")
    pts = torch.from_numpy(points)
    got = load_engine(export_engine(eng, pts))(pts)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_serve_cli_exports_checkpoint(tmp_path, jax_artifact):
    """python -m svnet_tpu_torch.serve: a port checkpoint -> an artifact
    whose logits equal the live engine's bitwise and JAX's artifact's to
    the bar."""
    points, weights, want = jax_artifact
    ckpt = tmp_path / "model_best.ckpt"
    torch.save({"epoch": 3, **weights, "best_metric": 0.5}, ckpt)
    out = tmp_path / "engine.pt2"
    r = subprocess.run(
        [sys.executable, "-m", "svnet_tpu_torch.serve", "--ckpt", str(ckpt),
         "--out", str(out), "--batch", str(B), "--num-points", str(N),
         "--k", str(K), "--num-classes", str(CLASSES), "--mode", "exact",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert f"exported cls/dgcnn mode=exact B={B} N={N} -> {out}" in r.stdout
    pts = torch.from_numpy(points)
    got = load_engine(out.read_bytes())(pts)
    live = SVDGCNNClsEngine(weights, CLASSES, K, True, device="cpu")(pts)
    assert torch.equal(got, live)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
