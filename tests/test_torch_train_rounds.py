"""The fused training rounds (B5, B6) through the port's autograd Functions
against the JAX custom VJPs in interpret mode: outputs and gradients on the
same inputs, weights and cotangents, as in tests/test_torch_kernels.py,
whose helpers and autouse ``_one_torch_thread`` this file imports.

At most six tests a file: pytest-xdist's ``--dist loadfile`` queues files
by their number of tests, largest first, so these long JAX references run
beside tests/test_sharded_infer.py, the suite's longest file, instead of
ahead of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnet_tpu import ops as jops
from svnet_tpu.nn import sv_layers as jsvl
from svnet_tpu.ops.pallas.sv_first_train import (
    make_fused_first_round as jax_first_train,
)
from svnet_tpu.ops.pallas.sv_round3_train import make_fused_round as jax_round_train
from svnet_tpu.train.fused import _v2s_train
from svnet_tpu_torch.ops.kernels import sv_first_train as kf
from svnet_tpu_torch.ops.kernels.sv_round3_train import (
    RoundDims,
    fused_round_apply,
    sv_round3_train_bwd,
    sv_round3_train_fwd,
)

from test_torch_kernels import B, K, _one_torch_thread


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
