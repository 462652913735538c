"""The port's kernel modules against the JAX kernels (CPU, small shapes).

On the CPU each wrapper runs its kernel's plain PyTorch version; the JAX
side runs the Pallas kernel in interpret mode, exact mode, channel-major,
with its neighbour ids (``emit_wins``). Neighbour ids must be identical
and outputs agree to f32 summation order. The kernels themselves run
only on the card: tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnet_tpu import models
from svnet_tpu.infer import SVDGCNNClsEngine as JaxEngine
from svnet_tpu.ops.pallas.sv_point import sv_point_block_cm as jax_point
from svnet_tpu.ops.pallas.sv_round3 import sv_round3 as jax_round
from svnet_tpu.ops.pallas.sv_round3 import sv_round3_first as jax_first
from svnet_tpu_torch.infer import POINT_V_OFF, ROUNDS
from svnet_tpu_torch.infer import SVDGCNNClsEngine as TorchEngine
from svnet_tpu_torch.ops.kernels.sv_point import sv_point_block_cm, vector_rows
from svnet_tpu_torch.ops.kernels.sv_round3 import sv_round3, sv_round3_first
from svnet_tpu_torch.utils.convert import from_flax

RTOL, ATOL = 1e-5, 1e-6  # f32; the two sides sum in different orders
B, K = 2, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's thread pool only competes with the other
    test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _variables(binary):
    model = models.SV_DGCNN_CLS(num_classes=10, k=K, binary=binary)
    var = model.init(jax.random.PRNGKey(1), jnp.zeros((1, 16, 3)))
    return {"params": var["params"], "batch_stats": jax.tree.map(
        lambda x: x + 0.3 * jnp.abs(x) + 0.05, var["batch_stats"])}


@pytest.fixture(scope="module", params=[False, True], ids=["fp", "binary"])
def engines(request):
    """JAX and port engines on the same flax weights: their folded weight
    dicts are the kernels' inputs on both sides."""
    var = _variables(request.param)
    jeng = JaxEngine(var, num_classes=10, k=K, binary=request.param,
                     knn_impl="xla", exact=True, interpret=True)
    teng = TorchEngine(from_flax(jax.tree.map(np.asarray, var)), 10, K,
                       request.param)
    return jeng, teng


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def _same_ids(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fold_matches_jax(engines):
    jeng, teng = engines
    pairs = [(teng.folded_first, jeng.folded_first),
             (teng.folded_point, jeng.folded_point)]
    pairs += [(teng.folded[n], jeng.folded[n]) for n in ROUNDS]
    for got, want in pairs:
        assert set(got) == set(want)
        for name in want:
            np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                       rtol=1e-6, atol=0, err_msg=name)
    np.testing.assert_array_equal(teng.head1["kernel"].numpy(),
                                  np.asarray(jeng.head1["kernel"]))


@pytest.mark.parametrize("N", [64, 40])
def test_round3_first_matches_jax(engines, N):
    jeng, teng = engines
    pts = np.random.default_rng(N).standard_normal((B, N, 3)).astype(np.float32)
    want = jax_first(jnp.asarray(pts), jeng.folded_first, S_out=32, V_out=10,
                     k=K, mode="exact", interpret=True, emit_wins=True, cm=True)
    got = sv_round3_first(torch.from_numpy(pts), teng.folded_first,
                          S_out=32, V_out=10, k=K, emit_wins=True)
    _same_ids(got[3], want[3])
    _close(got[:3], want[:3])


@pytest.mark.parametrize("name,N", [("conv2", 64), ("conv4", 64), ("conv3", 40)])
def test_round3_matches_jax(engines, name, N):
    jeng, teng = engines
    S, V, S_out, V_out = ROUNDS[name]
    src = np.random.default_rng(N + S).standard_normal(
        (B, S + 3 * V, N)).astype(np.float32)
    want = jax_round(jnp.asarray(src), jeng.folded[name], S=S, V=V,
                     S_out=S_out, V_out=V_out, k=K, binary=teng.binary,
                     mode="exact", interpret=True, emit_wins=True, cm=True)
    got = sv_round3(torch.from_numpy(src), teng.folded[name], S=S, V=V,
                    S_out=S_out, V_out=V_out, k=K, binary=teng.binary,
                    emit_wins=True)
    _same_ids(got[3], want[3])
    _close(got[:3], want[:3])


def test_point_block_matches_jax(engines):
    jeng, teng = engines
    rng = np.random.default_rng(9)
    N = 64
    src = rng.standard_normal((B, 256 + 3 * 83, N)).astype(np.float32)
    gate = (1 / (1 + np.exp(-rng.standard_normal((B, 170))))).astype(np.float32)
    want = jax_point(jnp.asarray(src), jnp.asarray(gate), jeng.folded_point,
                     S=256, V=83, S_out=512, V_out=170, v_off=POINT_V_OFF,
                     T=N, binary=teng.binary, exact=True, interpret=True)
    got = sv_point_block_cm(torch.from_numpy(src), torch.from_numpy(gate),
                            teng.folded_point, S=256, V=83, S_out=512,
                            V_out=170, v_off=POINT_V_OFF, binary=teng.binary)
    _close(got, want)


def test_ragged_k_and_ties(engines):
    """k that divides nothing, on a cloud with duplicated points (exact
    distance ties, resolved to the minimum row on both sides)."""
    jeng, teng = engines
    rng = np.random.default_rng(3)
    pts = np.round(rng.standard_normal((B, 40, 3)) * 2.0) / 2.0
    pts[:, 20:] = pts[:, :20]
    pts = pts.astype(np.float32)
    want = jax_first(jnp.asarray(pts), jeng.folded_first, S_out=32, V_out=10,
                     k=7, mode="exact", interpret=True, emit_wins=True, cm=True)
    got = sv_round3_first(torch.from_numpy(pts), teng.folded_first,
                          S_out=32, V_out=10, k=7, emit_wins=True)
    _same_ids(got[3], want[3])
    _close(got[:3], want[:3])


def test_wrappers_check_arguments_and_count_no_cpu_launch():
    teng = TorchEngine(from_flax(jax.tree.map(np.asarray, _variables(True))),
                       10, K, True)
    before = (sv_round3_first.launches, sv_round3.launches,
              sv_point_block_cm.launches)
    teng(torch.zeros(1, 16, 3))
    assert (sv_round3_first.launches, sv_round3.launches,
            sv_point_block_cm.launches) == before
    with pytest.raises(ValueError):
        sv_round3(torch.zeros(1, 61, 16), teng.folded["conv2"], S=32, V=10,
                  S_out=32, V_out=10, k=K)
    with pytest.raises(ValueError):
        sv_round3_first(torch.zeros(1, 16, 2), teng.folded_first,
                        S_out=32, V_out=10, k=K)
    with pytest.raises(ValueError):
        sv_round3_first(torch.zeros(1, 3, 3), teng.folded_first,
                        S_out=32, V_out=10, k=K)
    # a v_off that is not based at S would read scalar rows as vectors
    bad = ((0, 10),) + POINT_V_OFF[1:]
    with pytest.raises(ValueError):
        vector_rows(bad, 256, 83)
    rows = vector_rows(POINT_V_OFF, 256, 83)
    assert sorted(rows) == list(range(256, 256 + 3 * 83))
    with pytest.raises(ValueError):
        teng(torch.zeros(1, 16, 3, dtype=torch.float64))
