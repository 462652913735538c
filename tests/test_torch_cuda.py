"""The port's CUDA kernels against their plain versions on the card, at a
small size (chip_smoke.py does this at the full size). Imports no JAX, so
it runs on the GPU machine:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest.py imports JAX.) Skips without a
CUDA device.
"""

import pytest
import torch

from svnet_tpu_torch.infer import POINT_V_OFF
from svnet_tpu_torch.infer import SVDGCNNClsEngine as TorchEngine
from svnet_tpu_torch.ops.kernels.sv_point import (
    sv_point_block_cm,
    sv_point_block_cm_plain,
)
from svnet_tpu_torch.ops.kernels.sv_round3 import (
    sv_round3,
    sv_round3_first,
    sv_round3_first_plain,
    sv_round3_plain,
)


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """Each kernel bitwise against its plain version, ragged N and k."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from svnet_tpu_torch.models.sv_dgcnn import init_params

    dev = torch.device("cuda", torch.cuda.current_device())
    eng = TorchEngine(init_params(40, 7, True, torch.Generator().manual_seed(0)),
                      40, 7, True, device=dev)
    gen = torch.Generator().manual_seed(1)
    pts = torch.randn(2, 200, 3, generator=gen).to(dev)
    kw = dict(S_out=32, V_out=10, k=7)
    got = sv_round3_first(pts, eng.folded_first, emit_wins=True, **kw)
    want = sv_round3_first_plain(pts, eng.folded_first, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    src = torch.cat([want[0], want[1]], dim=1).contiguous()
    kw = dict(S=32, V=10, S_out=32, V_out=10, k=7, binary=True)
    got = sv_round3(src, eng.folded["conv2"], emit_wins=True, **kw)
    want = sv_round3_plain(src, eng.folded["conv2"], **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    src5 = torch.randn(2, 505, 200, generator=gen).to(dev)
    gate = torch.rand(2, 170, generator=gen).to(dev)
    kw = dict(S=256, V=83, S_out=512, V_out=170, v_off=POINT_V_OFF, binary=True)
    got = sv_point_block_cm(src5, gate, eng.folded_point, **kw)
    want = sv_point_block_cm_plain(src5, gate, eng.folded_point, **kw)
    assert torch.equal(got[0], want[0])


def _cos(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm() + 1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("binary", [True, False], ids=["binary", "fp"])
def test_train_kernels_match_plain_on_card(binary):
    """B4 ids bitwise; B5/B6 forward within f32 rounding (batch statistics
    are summed in another order), first-argmax ranks equal, gradients
    within the flip-tolerant bars of tests/test_fused_train.py."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from svnet_tpu_torch import config
    from svnet_tpu_torch.models.sv_dgcnn import init_params
    from svnet_tpu_torch.ops.kernels import sv_first_train as kf
    from svnet_tpu_torch.ops.kernels import sv_round3_train as kr
    from svnet_tpu_torch.ops.kernels.knn import knn
    from svnet_tpu_torch.ops.knn import knn_plain
    from svnet_tpu_torch.train.steps import tree_map

    dev = torch.device("cuda", torch.cuda.current_device())
    config.set_full_fp32()
    gen = torch.Generator().manual_seed(3)
    p = tree_map(lambda t: t.to(dev), init_params(40, 7, binary, gen)["params"])
    B, N, k = 2, 200, 7
    pts = torch.randn(B, N, 3, generator=gen).to(dev)
    cases = [(pts, kf.first_dims(32, 10, k),
              {"init_scalar": p["init_scalar"], **p["conv1"]}, "sv_first_train_launch")]
    src = torch.randn(B, N, 62, generator=gen).to(dev)
    cases.append((src, kr.RoundDims(32, 10, 32, 10, k, binary), p["conv2"],
                  "sv_round3_train_launch"))
    for x, d, sub, symbol in cases:
        idx = knn(x, k)
        assert torch.equal(idx, knn_plain(x, k))
        kp = kr.kernel_params(sub, d)
        got = kr.train_fwd_kernel(symbol, x, idx, kp, d)
        want = kr.train_fwd_plain(x, idx, kp, d)
        for g, w in zip(got[:3] + got[3], want[:3] + want[3]):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
        assert torch.equal(got[4], want[4])
        So, Vo = d.S_out, d.V_out
        dso = torch.randn(B, N, So, generator=gen).to(dev)
        dvo = torch.randn(B, N, 3 * Vo, generator=gen).to(dev)
        dss = torch.randn(B, d.SX, generator=gen).to(dev) * 1e-3
        saved = (want[4], want[3][0], want[3][2], want[3][3], want[3][5])
        gd, gg = kr.train_bwd_kernel(symbol, x, idx, kp, d, saved, dso, dvo, dss)
        wd, wg = kr.train_bwd_plain(x, idx, kp, d, saved, dso, dvo, dss)
        assert _cos(gd, wd) >= 0.99
        for name, w in wg.items():
            if w.numel() >= 8 and w.norm() > 1e-10:
                assert _cos(gg[name], w) >= 0.9, name
        a = torch.cat([gg[n].flatten() for n in wg])
        b = torch.cat([wg[n].flatten() for n in wg])
        assert float((a - b).norm() / b.norm()) <= 1e-3
