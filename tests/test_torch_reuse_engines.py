"""Both SV-DGCNN engines with graph reuse against the JAX engines on the
CPU (the Pallas kernels in interpret mode), to the bars of
tests/test_torch_reuse.py, whose helpers and autouse ``_one_torch_thread``
this file imports.

At most six tests a file: pytest-xdist's ``--dist loadfile`` queues files
by their number of tests, largest first, so these long JAX references run
beside tests/test_sharded_infer.py, the suite's longest file, instead of
ahead of it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnet_tpu.infer import SVDGCNNClsEngine as JaxDGCNNEngine
from svnet_tpu.infer import SVDGCNNPsegEngine as JaxPsegEngine
from svnet_tpu_torch.infer import SVDGCNNClsEngine, SVDGCNNPsegEngine
from svnet_tpu_torch.models.sv_dgcnn import init_params, init_params_pseg
from svnet_tpu_torch.utils.convert import to_flax

from test_torch_fast import _rand, _with_beta
from test_torch_reuse import (
    B,
    K_ENG,
    N_ENG,
    R_ENG,
    _Ids,
    _mode_bits,
    _one_torch_thread,
    _reuse,
)


def _weights(task, binary):
    """Seeded engine weights with nontrivial batch statistics; binary ones
    with seeded nonzero beta (C19)."""
    gen = torch.Generator().manual_seed(2)
    w = (init_params(10, K_ENG, binary, gen) if task == "cls"
         else init_params_pseg(50, K_ENG, binary, gen))

    def walk(tree):
        return {n: walk(v) if isinstance(v, dict) else v + 0.3 * v.abs() + 0.05
                for n, v in tree.items()}

    w = dict(w, batch_stats=walk(w["batch_stats"]))
    return _with_beta(w, 6) if binary else w


# (engine, graph_reuse, mode, gather bits, binary, reuse_gather_window)
ENGINE_CASES = [("cls", "spatial", "approx", 8, True, 0),
                ("cls", "conv2", "exact", 16, True, 128),
                ("pseg", "spatial", "fast", 16, False, 0),
                ("pseg", "conv2", "approx", 16, False, 128)]


@pytest.mark.parametrize("task,reuse,mode,bits,binary,window", ENGINE_CASES,
                         ids=[f"{t}-{r}-{m}{b}-{'bin' if bb else 'fp'}-W{w}"
                              for t, r, m, b, bb, w in ENGINE_CASES])
def test_engine_reuse_matches_jax(monkeypatch, task, reuse, mode, bits, binary,
                                  window):
    """Both SV-DGCNN engines with graph reuse and reuse_k = 2 of k = 4
    against the JAX engines: the ids the reuse rounds consume to C8's bar,
    logits to
    rtol 1e-4 (partseg in the input's order: both un-permute the entry
    sort, which a gather window forces in exact mode too), the port's
    engine bitwise its plain twin, and shuffled points give the same
    logits (cls) or the same per-point logits, shuffled (partseg)."""
    points = _rand(7, B, N_ENG, 3)
    label = np.eye(16, dtype=np.float32)[[3, 11]]
    weights = _weights(task, binary)
    if task == "cls":
        jeng = JaxDGCNNEngine(to_flax(weights), num_classes=10, k=K_ENG,
                              binary=binary, mode=mode, interpret=True)
        args, jargs = (torch.from_numpy(points),), (jnp.asarray(points),)
        engine = SVDGCNNClsEngine
        cfg = (10, K_ENG, binary)
    else:
        jeng = JaxPsegEngine(to_flax(weights), num_part=50, k=K_ENG,
                             binary=binary, mode=mode, interpret=True)
        args = (torch.from_numpy(points), torch.from_numpy(label))
        jargs = (jnp.asarray(points), jnp.asarray(label))
        engine = SVDGCNNPsegEngine
        cfg = (50, K_ENG, binary)
    with _mode_bits(mode, bits), _reuse(reuse, R_ENG, window):
        eng = engine(weights, *cfg, mode=mode, device="cpu")
        ids = _Ids(eng, monkeypatch)
        want = np.asarray(jeng(*jargs))
        got = eng(*args)
        ids.check(reuse)
        oracle = engine(weights, *cfg, mode=mode, device="cpu", oracle=True)
        assert torch.equal(oracle(*args), got)
        sorts = mode == "approx" or window > 0
        assert (eng._entry_sort(args[0])[1] is not None) == sorts
        perm = np.random.default_rng(3).permutation(N_ENG)
        got_sh = eng(torch.from_numpy(points[:, perm]), *args[1:])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    if sorts:  # the sorted cloud does not depend on the points' order
        want_sh = got if task == "cls" else got[:, perm]
        np.testing.assert_allclose(got_sh.numpy(), want_sh.numpy(), rtol=1e-4,
                                   atol=1e-4)
