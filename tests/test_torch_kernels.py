"""The port's kernel modules against the JAX kernels (CPU, small shapes):
the serving rounds B1-B3 and the training kernels B4-B6.

On the CPU each wrapper runs its kernel's plain PyTorch version; the JAX
side runs the Pallas kernel in interpret mode, exact mode, channel-major,
with its neighbour ids (``emit_wins``). Neighbour ids must be identical
and outputs agree to f32 summation order. The kernels themselves run
only on the card: tests/test_torch_cuda.py and chip_smoke.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnet_tpu import models
from svnet_tpu import ops as jops
from svnet_tpu.infer import SVDGCNNClsEngine as JaxEngine
from svnet_tpu.nn import sv_layers as jsvl
from svnet_tpu.ops.pallas.knn import knn_pallas
from svnet_tpu.ops.pallas.sv_first_train import make_fused_first_round as jax_first_train
from svnet_tpu.ops.pallas.sv_round3_train import make_fused_round as jax_round_train
from svnet_tpu.ops.pallas.sv_point import sv_point_block_cm as jax_point
from svnet_tpu.ops.pallas.sv_round3 import sv_round3 as jax_round
from svnet_tpu.ops.pallas.sv_round3 import sv_round3_first as jax_first
from svnet_tpu_torch.infer import POINT_V_OFF, ROUNDS
from svnet_tpu_torch.infer import SVDGCNNClsEngine as TorchEngine
from svnet_tpu_torch.ops.kernels.sv_point import sv_point_block_cm, vector_rows
from svnet_tpu.train.fused import _v2s_train
from svnet_tpu_torch.ops.kernels.knn import knn
from svnet_tpu_torch.ops.kernels import sv_first_train as kf
from svnet_tpu_torch.ops.kernels.sv_round3 import sv_round3, sv_round3_first
from svnet_tpu_torch.ops.kernels.sv_round3_train import (
    RoundDims,
    fused_round_apply,
    sv_round3_train_bwd,
    sv_round3_train_fwd,
)
from svnet_tpu_torch.models.sv_dgcnn import init_params_pseg
from svnet_tpu_torch.ops.kernels.fold import fold_first_params
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


@functools.lru_cache(maxsize=None)
def _variables(binary):
    """The flax weights, made once per model: one compile of init instead
    of its eager ops (bitwise the same tree)."""
    model = models.SV_DGCNN_CLS(num_classes=10, k=K, binary=binary)
    var = jax.jit(model.init)(jax.random.PRNGKey(1), jnp.zeros((1, 16, 3)))
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
                       request.param, device="cpu")
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


@pytest.mark.parametrize("N,V_out", [(64, 10), (40, 10), (64, 16), (40, 16)],
                         ids=["64", "40", "64-v16", "40-v16"])
def test_round3_first_matches_jax(engines, N, V_out):
    """V_out=10 on the classifier's weights; V_out=16 on SV_DGCNN_PSEG's
    conv1 (make_divisible widths), folded by the port for both sides."""
    jeng, teng = engines
    if V_out == 10:
        folded, jfolded = teng.folded_first, jeng.folded_first
    else:
        w = init_params_pseg(50, K, teng.binary, torch.Generator().manual_seed(N))
        p, bs = w["params"], w["batch_stats"]
        folded = fold_first_params(p["init_scalar"], p["conv1"], bs["conv1"])
        jfolded = {n: jnp.asarray(t.numpy()) for n, t in folded.items()}
    pts = np.random.default_rng(N).standard_normal((B, N, 3)).astype(np.float32)
    want = jax_first(jnp.asarray(pts), jfolded, S_out=32, V_out=V_out,
                     k=K, mode="exact", interpret=True, emit_wins=True, cm=True)
    got = sv_round3_first(torch.from_numpy(pts), folded,
                          S_out=32, V_out=V_out, k=K, emit_wins=True)
    assert got[1].shape == (B, 3 * V_out, N)
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
                       10, K, True, device="cpu")
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


# ---------------------------------------------------------------------------
# training kernels: B4 (kNN), B5 (first round), B6 (conv round)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("C,ties", [(3, False), (24, False), (6, True)])
def test_knn_plain_matches_knn_pallas(C, ties):
    """B4's plain version (what a CPU tensor gets) against knn_pallas in
    interpret mode: identical ids, ties to the minimum row."""
    rng = np.random.default_rng(C)
    x = rng.standard_normal((B, 64, C)).astype(np.float32)
    if ties:
        x = np.round(x * 2.0) / 2.0
        x[:, 32:] = x[:, :32]
    want = knn_pallas(jnp.asarray(x), 6, tile=64, interpret=True)
    got = knn(torch.from_numpy(x), 6)
    assert got.dtype == torch.int32
    _same_ids(got, want)


TRAIN_SUB = ("v2s", "linear1", "bn1", "linear2", "bn2")


@pytest.fixture(scope="module", params=["first", "binary", "fp"])
def train_round(request):
    """One fused training round through both packages on the same inputs,
    weights and output cotangents: the JAX custom VJP in interpret mode
    and the port's autograd Function (plain versions on the CPU)."""
    kind = request.param
    rng = np.random.default_rng(11)
    N, S, V, S_out, V_out = 64, 8, 5, 16, 10
    if kind == "first":
        src = rng.standard_normal((B, N, 3)).astype(np.float32)
        init_p = {"linear": {"kernel": (rng.standard_normal((2, 3)) * 0.5
                                        ).astype(np.float32)}}
        v_e = jops.get_graph_feature(jnp.asarray(src), K)
        block_in = (_v2s_train(init_p, v_e, False), v_e)
        binary, n_gate = False, 6
    else:
        src = rng.standard_normal((B, N, S + 3 * V)).astype(np.float32)
        s, v = jnp.asarray(src[..., :S]), jnp.asarray(src[..., S:]).reshape(B, N, 3, V)
        block_in = jops.get_graph_feature_sv((s, v), K)
        binary, n_gate = kind == "binary", 2 * S
    block = jsvl.SVBlock(S_out, V_out, binary=binary)
    var = jax.jit(block.init, static_argnums=2)(jax.random.PRNGKey(2), block_in, True)
    params = {n: var["params"][n] for n in TRAIN_SUB}
    if kind == "first":
        params["init_scalar"] = init_p
    # away from init: BN scales and biases off 1 and 0
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(
        np.shape(a)).astype(np.float32), params)
    idx = np.asarray(jops.knn(jnp.asarray(src), K)).astype(np.int32)
    cts = [rng.standard_normal(sh).astype(np.float32)
           for sh in ((B, N, S_out), (B, N, 3 * V_out), (B, n_gate))]
    if kind == "first":
        jfn = jax_first_train(S_out, V_out, K, interpret=True)
        ops = (kf.sv_first_train_fwd, kf.sv_first_train_bwd)
        d = kf.first_dims(S_out, V_out, K)
    else:
        jfn = jax_round_train(S, V, S_out, V_out, K, binary=binary, interpret=True)
        ops = (sv_round3_train_fwd, sv_round3_train_bwd)
        d = RoundDims(S, V, S_out, V_out, K, binary)

    def jloss(p, x):
        so, vo, sm, st = jfn(x, jnp.asarray(idx), p)
        return (jnp.sum(so * cts[0]) + jnp.sum(vo * cts[1])
                + jnp.sum(sm * cts[2])), (so, vo, sm) + tuple(st)

    (_, want), (wgp, wgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(src))
    tp = jax.tree.map(lambda a: torch.tensor(a, requires_grad=True), params)
    x = torch.tensor(src, requires_grad=True)
    so, vo, sm, st = fused_round_apply(ops, d, x, torch.from_numpy(idx), tp)
    loss = sum((t * torch.from_numpy(c)).sum() for t, c in zip((so, vo, sm), cts))
    loss.backward()
    got = [t.detach() for t in (so, vo, sm) + tuple(st)]
    got_grads = {jax.tree_util.keystr(p): leaf.grad
                 for p, leaf in jax.tree_util.tree_leaves_with_path(tp)}
    want_grads = {jax.tree_util.keystr(p): leaf
                  for p, leaf in jax.tree_util.tree_leaves_with_path(wgp)}
    return got, want, (x.grad, got_grads), (wgx, want_grads)


def test_train_round_forward_matches_jax(train_round):
    """Outputs, gate means and batch statistics: the bars of
    tests/test_fused_train.py (rtol=atol=2e-4 on outputs)."""
    got, want, _, _ = train_round
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4)


def test_train_round_grads_match_jax(train_round):
    """d(src) and every parameter gradient, named as flax names them:
    rtol=2e-3, atol=2e-4 (tests/test_fused_train.py)."""
    _, _, (gx, gp), (wx, wp) = train_round
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=2e-3, atol=2e-4)
    assert set(gp) == set(wp)
    for path, w in wp.items():
        np.testing.assert_allclose(gp[path].numpy(), np.asarray(w), rtol=2e-3,
                                   atol=2e-4, err_msg=path)


def test_train_wrappers_check_arguments():
    d = RoundDims(32, 10, 32, 10, K, True)
    src = torch.zeros(1, 16, 62)
    with pytest.raises(ValueError):
        sv_round3_train_fwd(torch.zeros(1, 16, 61), torch.zeros(1, 16, K,
                            dtype=torch.int32), {}, d)
    with pytest.raises(ValueError):
        sv_round3_train_fwd(src, torch.zeros(1, 16, K + 1, dtype=torch.int32), {}, d)
    with pytest.raises(ValueError):
        knn(torch.zeros(1, 3, 3), 4)
    before = (knn.launches, sv_round3_train_fwd.launches,
              sv_round3_train_bwd.launches)
    knn(torch.zeros(1, 16, 3), 4)
    assert (knn.launches, sv_round3_train_fwd.launches,
            sv_round3_train_bwd.launches) == before
