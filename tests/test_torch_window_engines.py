"""Both SV-DGCNN engines with the certified Morton candidate window against
the JAX engines on the CPU (the Pallas kernels in interpret mode), to the
bars of tests/test_torch_window.py, whose helpers and autouse
``_one_torch_thread`` this file imports.

At most six tests a file: pytest-xdist's ``--dist loadfile`` queues files
by their number of tests, largest first, so these long JAX references run
beside tests/test_sharded_infer.py, the suite's longest file, instead of
ahead of it.
"""

import jax.numpy as jnp
import numpy as np
import torch

from svnet_tpu.infer import SVDGCNNClsEngine as JaxDGCNNEngine
from svnet_tpu.infer import SVDGCNNPsegEngine as JaxPsegEngine
from svnet_tpu_torch.infer import SVDGCNNClsEngine, SVDGCNNPsegEngine
from svnet_tpu_torch.models.sv_dgcnn import init_params, init_params_pseg
from svnet_tpu_torch.utils.convert import to_flax
from svnet_tpu_torch.utils.synth import strand_clouds

from test_torch_approx import _approx
from test_torch_fast import _with_beta
from test_torch_window import K, N_ENG, W_ENG, _one_torch_thread, weights


def test_dgcnn_cls_engine_window_matches_jax():
    """The binary classifier in exact mode with window=512 on one strand
    cloud (B1 certifies; the conv rounds take what their features give):
    logits against the JAX engine's, and bitwise the port's engine without
    a window and its oracle twin."""
    weights = _with_beta(init_params(10, K, True, torch.Generator().manual_seed(8)), 9)
    points = strand_clouds(17, 1, N_ENG)
    jeng = JaxDGCNNEngine(to_flax(weights), num_classes=10, k=K, binary=True,
                          mode="exact", interpret=True, window=W_ENG)
    want = np.asarray(jeng(jnp.asarray(points)))
    eng = SVDGCNNClsEngine(weights, 10, K, True, device="cpu", window=W_ENG)
    x = torch.from_numpy(points)
    got = eng(x)
    assert torch.equal(got, SVDGCNNClsEngine(weights, 10, K, True, device="cpu")(x))
    oracle = SVDGCNNClsEngine(weights, 10, K, True, device="cpu", oracle=True,
                              window=W_ENG)
    assert torch.equal(oracle(x), got)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_dgcnn_pseg_engine_window_matches_jax():
    """The FP part segmenter in approx mode (fold 256, 8-bit gathers) with
    window=512: both sort at entry; logits in the input's order against
    the JAX engine's."""
    weights = init_params_pseg(50, K, False, torch.Generator().manual_seed(10))
    points = strand_clouds(19, 1, N_ENG)
    label = np.eye(16, dtype=np.float32)[[5]]
    with _approx(fold=256, bits=8):
        jeng = JaxPsegEngine(to_flax(weights), num_part=50, k=K, binary=False,
                             mode="approx", interpret=True, window=W_ENG)
        want = np.asarray(jeng(jnp.asarray(points), jnp.asarray(label)))
        eng = SVDGCNNPsegEngine(weights, 50, K, False, mode="approx",
                                device="cpu", window=W_ENG)
        got = eng(torch.from_numpy(points), torch.from_numpy(label)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
