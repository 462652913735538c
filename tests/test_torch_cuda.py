"""The port's CUDA kernels against their plain versions on the card, at a
small size (chip_smoke.py does this at the full size). Imports no JAX, so
it runs on the GPU machine:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest.py imports JAX.) The ``cuda``
tests skip without a CUDA device; the unmarked ones at the end check the
block kernels' host-side helpers and run everywhere.
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


@pytest.mark.cuda
@pytest.mark.parametrize("binary", [True, False], ids=["binary", "fp"])
def test_pointnet_kernels_match_plain_on_card(binary):
    """B1 with cross (ids and outputs) and B8 bitwise against their plain
    versions: B8 at a narrow, a 512-wide and the conv_fuse-wide shape
    (binary: tensor-core tiles of 128 points at the narrow shape, 64 at
    the others; FP: 8 points per block at conv_fuse, 16 elsewhere), N
    ragged for every block size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from svnet_tpu_torch import config
    from svnet_tpu_torch.infer import SVPointNetClsEngine
    from svnet_tpu_torch.models.sv_pointnet import init_params
    from svnet_tpu_torch.ops.kernels.sv_block_point import (
        points_per_block,
        sv_block_point,
        sv_block_point_plain,
    )

    dev = torch.device("cuda", torch.cuda.current_device())
    config.set_full_fp32()
    gen = torch.Generator().manual_seed(4)
    eng = SVPointNetClsEngine(init_params(40, 7, binary, gen), 40, 7, binary,
                              device=dev)
    pts = torch.randn(2, 203, 3, generator=gen).to(dev)
    kw = dict(S_out=32, V_out=10, k=7, cross=True)
    got = sv_round3_first(pts, eng.folded_first, emit_wins=True, **kw)
    want = sv_round3_first_plain(pts, eng.folded_first, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for name, ppb in (("conv1", (128, 16)), ("conv3", (64, 16)),
                      ("conv_fuse", (64, 8))):
        (S, V, S_out, V_out), folded, _ = eng.blocks[name]
        assert points_per_block(S, V, S_out, V_out, binary) == ppb[0 if binary else 1]
        src = torch.randn(2, 203, S + 3 * V, generator=gen).to(dev)
        gate = torch.rand(2, V_out, generator=gen).to(dev)
        kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, binary=binary)
        got = sv_block_point(src, gate, folded, **kw)
        want = sv_block_point_plain(src, gate, folded, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w), name


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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 200, 7, 3), (3, 1001, 20, 62),
                                   (2, 100, 8, 5), (2, 100, 8, 1),
                                   (2, 200, 7, 64)],
                         ids=["xyz", "joint", "hub", "c1", "c64"])
def test_edge_gather_matches_plain_on_card(shape):
    """B7 forward and scatter-add backward bitwise against their plain
    versions; two backward launches identical; ragged N, and a hub point
    with an in-degree of 400; ``gather_neighbors`` launches the kernel on
    a CUDA tensor, forward and backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from svnet_tpu_torch import ops
    from svnet_tpu_torch.ops.kernels import edge_gather as eg

    dev = torch.device("cuda", torch.cuda.current_device())
    b, n, k, c = shape
    gen = torch.Generator().manual_seed(5)
    src = torch.randn(b, n, c, generator=gen).to(dev)
    idx = torch.randint(0, n, (b, n, k), generator=gen, dtype=torch.int32)
    if n == 100:
        idx[:, :, : k // 2] = 5
    idx = idx.to(dev)
    g = torch.randn(b, n, k, c, generator=gen).to(dev)
    assert torch.equal(eg.edge_gather_fwd(src, idx),
                       eg.edge_gather_fwd_plain(src, idx))
    first = eg.edge_gather_bwd(g, idx, n)
    assert torch.equal(first, eg.edge_gather_bwd_plain(g, idx, n))
    assert torch.equal(first, eg.edge_gather_bwd(g, idx, n))
    before = (eg.edge_gather_fwd.launches, eg.edge_gather_bwd.launches)
    x = src.clone().requires_grad_(True)
    ops.gather_neighbors(x, idx).backward(g)
    assert (eg.edge_gather_fwd.launches, eg.edge_gather_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(x.grad, first)


@pytest.mark.cuda
@pytest.mark.parametrize("binary", [True, False], ids=["binary", "fp"])
def test_row_major_kernels_match_plain_on_card(binary):
    """B10b (first round at V_out 10 and 16, a conv round at partseg's
    conv4 widths) and B3r bitwise against their plain versions and against
    the channel-major kernels B1/B2/B3 on the same values; N and k ragged;
    B3's pooled outputs bitwise (the partseg engine reads them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from svnet_tpu_torch import config
    from svnet_tpu_torch.infer import SVDGCNNPsegEngine
    from svnet_tpu_torch.models.sv_dgcnn import init_params_pseg
    from svnet_tpu_torch.ops.kernels import sv_round2 as k2
    from svnet_tpu_torch.ops.kernels.sv_point import (
        sv_point_block,
        sv_point_block_plain,
    )

    dev = torch.device("cuda", torch.cuda.current_device())
    config.set_full_fp32()
    gen = torch.Generator().manual_seed(6)
    eng = SVDGCNNPsegEngine(init_params_pseg(50, 7, binary, gen), 50, 7,
                            binary, device=dev)
    from svnet_tpu_torch.models.sv_dgcnn import init_params

    cls = TorchEngine(init_params(40, 7, binary, gen), 40, 7, binary,
                      device=dev)
    pts = torch.randn(2, 203, 3, generator=gen).to(dev)
    for v_out, folded in ((16, eng.folded_first), (10, cls.folded_first)):
        kw = dict(S_out=32, V_out=v_out, k=7)
        rm = k2.sv_round2_first(pts, folded, emit_wins=True, **kw)
        for g, w in zip(rm, k2.sv_round2_first_plain(pts, folded, **kw)):
            assert torch.equal(g, w)
        cm = sv_round3_first(pts, folded, emit_wins=True, **kw)
        for g, w in zip(cm, sv_round3_first_plain(pts, folded, **kw)):
            assert torch.equal(g, w)
        assert torch.equal(rm[0], cm[0].transpose(1, 2))
        assert torch.equal(rm[3], cm[3].transpose(1, 2))
    S, V, S_out, V_out = eng.rounds["conv4"]
    src = torch.randn(2, 203, S + 3 * V, generator=gen).to(dev)
    kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=7, binary=binary)
    rm = k2.sv_round2(src, eng.folded["conv4"], emit_wins=True, **kw)
    for g, w in zip(rm, k2.sv_round2_plain(src, eng.folded["conv4"], **kw)):
        assert torch.equal(g, w)
    cm = sv_round3(src.transpose(1, 2).contiguous(), eng.folded["conv4"],
                   emit_wins=True, **kw)
    assert torch.equal(rm[1], cm[1].transpose(1, 2))
    S, V, S_out, V_out = eng.S_c, eng.V_c, eng.S5, eng.V5
    src = torch.randn(2, 203, S + 3 * V, generator=gen).to(dev)
    gate = torch.rand(2, V_out, generator=gen).to(dev)
    kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, binary=binary)
    got = sv_point_block(src, gate, eng.folded_point, **kw)
    for g, w in zip(got, sv_point_block_plain(src, gate, eng.folded_point, **kw)):
        assert torch.equal(g, w)
    src_cm = src.transpose(1, 2).contiguous()
    got = sv_point_block_cm(src_cm, gate, eng.folded_point, v_off=((S, V),), **kw)
    want = sv_point_block_cm_plain(src_cm, gate, eng.folded_point,
                                   v_off=((S, V),), **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_pseg_engines_on_card():
    """SV-DGCNN partseg on the card, both trunks: the kernels' launches per
    request, logits bitwise those of the plain twin, and round2 equal to
    round3 (binary)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from svnet_tpu_torch.infer import SVDGCNNPsegEngine
    from svnet_tpu_torch.models.sv_dgcnn import init_params_pseg
    from svnet_tpu_torch.ops.kernels import sv_round2 as k2
    from svnet_tpu_torch.ops.kernels.sv_point import sv_point_block

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator().manual_seed(7)
    w = init_params_pseg(50, 10, True, gen)
    pts = torch.randn(2, 300, 3, generator=gen).to(dev)
    label = torch.eye(16)[[3, 9]].to(dev)
    outs = {}
    for impl, fns in (("round3", (sv_round3_first, sv_round3, sv_point_block_cm)),
                      ("round2", (k2.sv_round2_first, k2.sv_round2,
                                  sv_point_block))):
        before = [f.launches for f in fns]
        eng = SVDGCNNPsegEngine(w, 50, 10, True, device=dev, rounds_impl=impl)
        outs[impl] = eng(pts, label)
        assert [f.launches - b for f, b in zip(fns, before)] == [1, 3, 1]
        oracle = SVDGCNNPsegEngine(w, 50, 10, True, device=dev,
                                   rounds_impl=impl, oracle=True)
        assert torch.equal(outs[impl], oracle(pts, label))
    assert torch.equal(outs["round2"], outs["round3"])


@pytest.mark.cuda
@pytest.mark.parametrize("binary", [True, False], ids=["binary", "fp"])
def test_round_and_edge_kernels_match_plain_on_card(binary):
    """B10a (first and conv round) bitwise against its plain version and
    against B10b; B10d and B10c on the ids of B4 bitwise against their
    plain versions on the same ids; N and k ragged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from svnet_tpu_torch import config, ops
    from svnet_tpu_torch.models.sv_dgcnn import init_params
    from svnet_tpu_torch.ops.kernels import sv_edge as ke
    from svnet_tpu_torch.ops.kernels import sv_edge_first as kf
    from svnet_tpu_torch.ops.kernels import sv_round as k1
    from svnet_tpu_torch.ops.kernels import sv_round2 as k2

    dev = torch.device("cuda", torch.cuda.current_device())
    config.set_full_fp32()
    gen = torch.Generator().manual_seed(8)
    eng = TorchEngine(init_params(40, 7, binary, gen), 40, 7, binary,
                      device=dev, rounds_impl="edge")
    pts = torch.randn(2, 203, 3, generator=gen).to(dev)
    kw = dict(S_out=32, V_out=10, k=7)
    got = k1.sv_round_first(pts, eng.folded_first, **kw)
    for g, w, r2 in zip(got, k1.sv_round_first_plain(pts, eng.folded_first, **kw),
                        k2.sv_round2_first(pts, eng.folded_first, **kw)):
        assert torch.equal(g, w) and torch.equal(g, r2)
    idx = ops.knn(pts, 7)
    got = kf.sv_edge_first_block(pts, idx, eng.folded_first, **kw)
    for g, w in zip(got, kf.sv_edge_first_block_plain(
            pts, idx, eng.folded_first, **kw)):
        assert torch.equal(g, w)
    S, V, S_out, V_out = eng.rounds["conv4"]
    src = torch.randn(2, 203, S + 3 * V, generator=gen).to(dev)
    kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=7, binary=binary)
    f = eng.folded["conv4"]
    got = k1.sv_round(src, f, **kw)
    for g, w, r2 in zip(got, k1.sv_round_plain(src, f, **kw),
                        k2.sv_round2(src, f, **kw)):
        assert torch.equal(g, w) and torch.equal(g, r2)
    idx = ops.knn(src, 7)
    gate = ke.svblock_gate(eng.p["conv4"], src[..., :S], idx)
    got = ke.sv_edge_block(src, idx, gate, f, **kw)
    for g, w in zip(got, ke.sv_edge_block_plain(src, idx, gate, f, **kw)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        ke.sv_edge_block(src, idx + 203, gate, f, **kw)


@pytest.mark.cuda
def test_cls_round_and_edge_engines_on_card():
    """The classifier's round and edge trunks on the card: the kernels'
    launches per request, logits bitwise those of the plain twin, round
    equal to round2 (binary)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from svnet_tpu_torch.models.sv_dgcnn import init_params
    from svnet_tpu_torch.ops.kernels import knn as kk
    from svnet_tpu_torch.ops.kernels import sv_edge as ke
    from svnet_tpu_torch.ops.kernels import sv_edge_first as kf
    from svnet_tpu_torch.ops.kernels import sv_round as k1
    from svnet_tpu_torch.ops.kernels.sv_point import sv_point_block

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator().manual_seed(9)
    w = init_params(40, 10, True, gen)
    pts = torch.randn(2, 300, 3, generator=gen).to(dev)
    outs = {}
    for impl, fns, want in (
            ("round", (k1.sv_round_first, k1.sv_round, sv_point_block), [1, 3, 1]),
            ("edge", (kk.knn, kf.sv_edge_first_block, ke.sv_edge_block,
                      sv_point_block), [4, 1, 3, 1])):
        eng = TorchEngine(w, 40, 10, True, device=dev, rounds_impl=impl)
        before = [f.launches for f in fns]
        outs[impl] = eng(pts)
        assert [f.launches - b for f, b in zip(fns, before)] == want
        oracle = TorchEngine(w, 40, 10, True, device=dev, rounds_impl=impl,
                             oracle=True)
        before = [f.launches for f in fns]
        assert torch.equal(outs[impl], oracle(pts))
        assert [f.launches for f in fns] == before
    assert torch.equal(outs["round"], TorchEngine(
        w, 40, 10, True, device=dev, rounds_impl="round2")(pts))


# (M, K, N) of B9: even; then M and N off the MMA tiles (16 x 8) and the
# block's 64 x 64 and 128 x 128, with L = K/32 words 3, 1, 7 (odd), 10
# (not a multiple of the MMA depth, 8 words) and 33 (three 16-word chunks,
# the last ragged); the last on the 128 x 128 tile (289 blocks of it)
XNOR_SHAPES = [(128, 64, 128), (1000, 96, 77), (130, 32, 9), (257, 224, 129),
               (17, 320, 250), (300, 1056, 131), (2100, 320, 2100)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", XNOR_SHAPES, ids=[f"M{s[0]}-K{s[1]}-N{s[2]}"
                                                    for s in XNOR_SHAPES])
def test_xnor_popcount_matches_plain_on_card(shape):
    """B9 exact against the dense +-1 product and bitwise against its plain
    version; M, N and the word count ragged to its tiles, sign words with
    bit 31 set on both sides."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from svnet_tpu_torch.ops.kernels import binary_matmul as kb
    from svnet_tpu_torch.utils.bench_binary_matmul import operands

    M, K, N = shape
    dev = torch.device("cuda", torch.cuda.current_device())
    x, w = operands(M, K, N, 0, dev)
    xp, wp = kb.pack_signs(x), kb.pack_signs(w.T).contiguous()
    assert bool((xp < 0).any()) and bool((wp < 0).any())  # bit 31 set
    before = kb.xnor_popcount.launches
    got = kb.xnor_popcount(xp, wp, K)
    assert kb.xnor_popcount.launches == before + 1
    assert torch.equal(got, (x.double() @ w.double()).float())
    assert torch.equal(got, kb.xnor_popcount_plain(xp, wp, K))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(200, 256, 72), (2100, 128, 2100)],
                         ids=["tile64", "tile128"])
def test_xnor_popcount_offset_operands_on_card(shape):
    """B9 on packed operands that start 4 bytes past a 16-byte boundary
    (contiguous views at a storage offset of one word) with L a multiple of
    4: the kernel takes its 4-byte copies and stays exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from svnet_tpu_torch.ops.kernels import binary_matmul as kb
    from svnet_tpu_torch.utils.bench_binary_matmul import operands

    M, K, N = shape
    dev = torch.device("cuda", torch.cuda.current_device())
    x, w = operands(M, K, N, 1, dev)
    xp, wp = kb.pack_signs(x), kb.pack_signs(w.T).contiguous()
    xo, wo = (torch.empty(t.numel() + 1, dtype=torch.int32, device=dev)[1:]
              .view(t.shape).copy_(t) for t in (xp, wp))
    assert xo.is_contiguous() and xo.data_ptr() % 16 and wo.data_ptr() % 16
    got = kb.xnor_popcount(xo, wo, K)
    torch.cuda.synchronize()
    assert torch.equal(got, (x.double() @ w.double()).float())
    assert torch.equal(got, kb.xnor_popcount_plain(xp, wp, K))


# (B, N, C, k, duplicated points) for the selection: N off the block's 64
# centres and the tile's 128 candidates (1000, 1001, 130), k = 1, k = N,
# lists of 33-64 entries, two rounds of 64 ranks (k = 100), exact ties
SELECT_SHAPES = [(2, 1000, 3, 20, False), (2, 1001, 62, 7, False),
                 (1, 50, 5, 1, False), (1, 50, 5, 50, False),
                 (2, 1001, 127, 33, False), (2, 1000, 80, 40, False),
                 (2, 1001, 3, 64, False), (1, 130, 3, 100, False),
                 (2, 300, 62, 20, True), (2, 301, 3, 40, True)]


def _select_input(b, n, c, dup, seed):
    x = torch.randn(b, n, c, generator=torch.Generator().manual_seed(seed))
    if dup:  # every odd row repeats an even one: ties to the minimum row
        h = x[:, 1::2].shape[1]
        x[:, 1::2] = x[:, ::2][:, :h]
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SELECT_SHAPES,
                         ids=[f"N{s[1]}-C{s[2]}-k{s[3]}{'-dup' if s[4] else ''}"
                              for s in SELECT_SHAPES])
def test_knn_selection_shape_forced_on_card(shape):
    """B4's ids (channel-major source, point-major ids) bitwise those of
    ``knn_plain`` where no tile or list size divides N or k."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from svnet_tpu_torch.ops.kernels.knn import knn
    from svnet_tpu_torch.ops.knn import knn_plain

    b, n, c, k, dup = shape
    x = _select_input(b, n, c, dup, 9).to(torch.device("cuda"))
    assert torch.equal(knn(x, k), knn_plain(x, k))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1001, 33, False), (1000, 64, True),
                                   (130, 100, False)],
                         ids=["N1001-k33", "N1000-k64-dup", "N130-k100"])
def test_round_selection_shape_forced_on_card(shape):
    """The selection inside the rounds, both layouts and both id orders:
    B1 and B2 (channel-major, rank-major wins) and B10b (row-major,
    point-major wins), first round and conv2, bitwise their plain
    versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from svnet_tpu_torch import config
    from svnet_tpu_torch.models.sv_dgcnn import init_params
    from svnet_tpu_torch.ops.kernels import sv_round2 as k2

    n, k, dup = shape
    dev = torch.device("cuda", torch.cuda.current_device())
    config.set_full_fp32()
    eng = TorchEngine(init_params(40, 7, True, torch.Generator().manual_seed(10)),
                      40, 7, True, device=dev)
    pts = _select_input(2, n, 3, dup, 11).to(dev)
    kw = dict(S_out=32, V_out=10, k=k)
    for kern, plain in ((sv_round3_first, sv_round3_first_plain),
                        (k2.sv_round2_first, k2.sv_round2_first_plain)):
        got = kern(pts, eng.folded_first, emit_wins=True, **kw)
        for g, w in zip(got, plain(pts, eng.folded_first, **kw)):
            assert torch.equal(g, w)
    src = _select_input(2, n, 62, dup, 12).to(dev)
    kw = dict(S=32, V=10, S_out=32, V_out=10, k=k, binary=True)
    f = eng.folded["conv2"]
    got = k2.sv_round2(src, f, emit_wins=True, **kw)
    for g, w in zip(got, k2.sv_round2_plain(src, f, **kw)):
        assert torch.equal(g, w)
    src = src.transpose(1, 2).contiguous()
    got = sv_round3(src, f, emit_wins=True, **kw)
    for g, w in zip(got, sv_round3_plain(src, f, **kw)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [4, 62, 64])
def test_edge_gather_unaligned_rows_on_card(c):
    """B7's forward bitwise its plain version on a source that starts 4
    bytes off a 16-byte boundary (a contiguous view into a larger buffer),
    where the float4 and float2 copies must not be taken, and NaN rows for
    ids outside [0, n_src)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from svnet_tpu_torch.ops.kernels import edge_gather as eg

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator().manual_seed(13)
    b, n, k = 2, 300, 9
    buf = torch.randn(b * n * c + 1, generator=gen).to(dev)
    src = buf[1:].view(b, n, c)
    assert src.data_ptr() % 16 != 0 and src.is_contiguous()
    idx = torch.randint(0, n, (b, n, k), generator=gen, dtype=torch.int32).to(dev)
    assert torch.equal(eg.edge_gather_fwd(src, idx),
                       eg.edge_gather_fwd_plain(src, idx))
    idx[0, 3, 2], idx[1, 7, 0] = n, -1
    out = eg.edge_gather_fwd(src, idx)
    assert bool(out[0, 3, 2].isnan().all()) and bool(out[1, 7, 0].isnan().all())
    keep = torch.ones(b, n, k, dtype=torch.bool, device=dev)
    keep[0, 3, 2] = keep[1, 7, 0] = False
    idx[0, 3, 2], idx[1, 7, 0] = 0, 0
    assert torch.equal(out[keep], eg.edge_gather_fwd_plain(src, idx)[keep])


def _round_weights(S, V, S_out, V_out, binary, gen, point=False):
    """Seeded folded weights of a conv round at any widths (signs when
    binary, as the fold gives them); ``point``: of a per-point block (B8,
    B3: S + 3V inputs, V vectors, and B3's wzf)."""
    IN1, Vi = (S + 3 * V, V) if point else (2 * S + 6 * V, 2 * V)

    def r(*shape):
        return torch.randn(*shape, generator=gen)

    w1, w2 = r(IN1, S_out), r(Vi, V_out)
    if binary:
        w1, w2 = torch.sign(w1), torch.sign(w2)
    f = {"wz": r(Vi, 3), "w1": w1,
         "beta": 0.3 * r(1, IN1) if binary else torch.zeros(1, IN1),
         "a1": r(1, S_out), "b1": r(1, S_out), "w2": w2,
         "scale2": r(1, V_out).abs() + 0.1, "a2": r(1, V_out),
         "b2": r(1, V_out)}
    if point:
        f["wzf"] = r(V_out, 3)
    return f


# (B, N, k) of the first-round block: N off its 128-centre tile (1000,
# 1001) and below one tile (50), k off its 2-rank chunk (1, 7, 33) and
# even (40)
FIRST_FORCED = [(2, 1000, 1), (2, 1001, 7), (1, 1000, 33), (1, 1001, 40), (3, 50, 33)]


def _first_weights(n_ch, V_out, gen):
    """Seeded folded weights of a first round with n_ch edge channels."""
    def r(*shape):
        return torch.randn(*shape, generator=gen)

    return {"wz0": r(n_ch, 3), "wz1": r(n_ch, 3), "w1": r(6 * n_ch, 32),
            "a1": r(1, 32), "b1": r(1, 32), "w2": r(n_ch, V_out),
            "a2": r(1, V_out), "b2": r(1, V_out)}


@pytest.mark.cuda
@pytest.mark.parametrize("V_out", [10, 16])
@pytest.mark.parametrize("cross", [False, True], ids=["xyz", "cross"])
@pytest.mark.parametrize("shape", FIRST_FORCED,
                         ids=[f"B{s[0]}-N{s[1]}-k{s[2]}" for s in FIRST_FORCED])
def test_first_block_shape_forced_on_card(shape, cross, V_out):
    """The first-round block at every instantiation (edge channels 2 and
    3, V_out 10 and 16, both layouts) bitwise against the plain versions
    where no centre tile or rank chunk divides N or k: B1 (channel-major)
    and B10b (row-major) with their own selection, ids included, and B10d
    on B4's ids."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from svnet_tpu_torch.ops.kernels import sv_edge_first as kf
    from svnet_tpu_torch.ops.kernels import sv_round2 as k2
    from svnet_tpu_torch.ops.kernels.knn import knn

    b, n, k = shape
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator().manual_seed(17)
    f = {name: t.to(dev) for name, t in _first_weights(3 if cross else 2, V_out,
                                                       gen).items()}
    pts = torch.randn(b, n, 3, generator=gen).to(dev)
    kw = dict(S_out=32, V_out=V_out, k=k, cross=cross)
    got = sv_round3_first(pts, f, emit_wins=True, **kw)
    for g, w in zip(got, sv_round3_first_plain(pts, f, **kw)):
        assert torch.equal(g, w)
    got = k2.sv_round2_first(pts, f, emit_wins=True, **kw)
    for g, w in zip(got, k2.sv_round2_first_plain(pts, f, **kw)):
        assert torch.equal(g, w)
    if not cross:
        idx = knn(pts, k)
        kw.pop("cross")
        for g, w in zip(kf.sv_edge_first_block(pts, idx, f, **kw),
                        kf.sv_edge_first_block_plain(pts, idx, f, **kw)):
            assert torch.equal(g, w)


# (B, N, k, S, V, S_out, V_out): IN1 = 2S + 6V = 28 and S_out = 13 divide
# no MMA tile (16) and N, k no edge tile (32 centres x 2 ranks); then the
# cls conv4 and partseg conv3 widths at ragged N and k
CONV_FORCED = [(2, 1000, 7, 5, 3, 13, 7), (2, 1001, 33, 5, 3, 13, 7),
               (2, 1001, 7, 64, 21, 128, 42), (1, 1000, 33, 32, 16, 64, 24)]


@pytest.mark.cuda
@pytest.mark.parametrize("binary", [True, False], ids=["binary", "fp"])
@pytest.mark.parametrize("shape", CONV_FORCED,
                         ids=[f"N{s[1]}-k{s[2]}-S{s[3]}-V{s[4]}-So{s[5]}-Vo{s[6]}"
                              for s in CONV_FORCED])
def test_conv_block_shape_forced_on_card(shape, binary):
    """The conv-round block kernel bitwise against the plain versions where
    neither the MMA tile nor the edge tile divides the widths, N or k: B2
    (channel-major), B10b and B10a (row-major) with their own selection,
    B10c (gated) on B4's ids."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from svnet_tpu_torch import config
    from svnet_tpu_torch.ops.kernels import sv_edge as ke
    from svnet_tpu_torch.ops.kernels import sv_round as k1
    from svnet_tpu_torch.ops.kernels import sv_round2 as k2
    from svnet_tpu_torch.ops.kernels.knn import knn

    b, n, k, S, V, S_out, V_out = shape
    dev = torch.device("cuda", torch.cuda.current_device())
    config.set_full_fp32()
    gen = torch.Generator().manual_seed(14)
    f = {name: t.to(dev) for name, t in
         _round_weights(S, V, S_out, V_out, binary, gen).items()}
    src = torch.randn(b, n, S + 3 * V, generator=gen).to(dev)
    kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=k, binary=binary)
    src_cm = src.transpose(1, 2).contiguous()
    got = sv_round3(src_cm, f, emit_wins=True, **kw)
    for g, w in zip(got, sv_round3_plain(src_cm, f, **kw)):
        assert torch.equal(g, w)
    got = k2.sv_round2(src, f, emit_wins=True, **kw)
    for g, w in zip(got, k2.sv_round2_plain(src, f, **kw)):
        assert torch.equal(g, w)
    for g, w in zip(k1.sv_round(src, f, **kw), k1.sv_round_plain(src, f, **kw)):
        assert torch.equal(g, w)
    idx = knn(src, k)
    gate = torch.rand(b, V_out, generator=gen).to(dev)
    got = ke.sv_edge_block(src, idx, gate, f, **kw)
    for g, w in zip(got, ke.sv_edge_block_plain(src, idx, gate, f, **kw)):
        assert torch.equal(g, w)


# fast mode: (B, N, k, key tile T (None: the heuristic's, T = N where no
# tile divides N), duplicated points): N and k that no tile or list of the
# selection divides, several key tiles a cloud, exact ties of distance
FAST_FORCED = [(2, 1000, 7, None, False), (2, 1001, 33, None, False),
               (2, 1024, 20, 128, False), (1, 2048, 40, None, True),
               (3, 256, 64, 64, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [16, 8], ids=["gb16", "gb8"])
@pytest.mark.parametrize("shape", FAST_FORCED,
                         ids=[f"B{s[0]}-N{s[1]}-k{s[2]}-T{s[3] or 'auto'}"
                              + ("-dup" if s[4] else "") for s in FAST_FORCED])
def test_fast_rounds_match_plain_on_card(shape, bits):
    """Fast mode at 16- and 8-bit gathers: the pre-pass (each centre's
    farthest candidate) bitwise its plain version; B1 (xyz and cross,
    V_out 10 and 16) and B2 ((5, 3) -> (13, 7) and (32, 10) -> (32, 10),
    binary and FP), ids and outputs bitwise their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from svnet_tpu_torch import config
    from svnet_tpu_torch.ops.kernels.knn import neg_min, neg_min_plain

    b, n, k, t, dup = shape
    dev = torch.device("cuda", torch.cuda.current_device())
    config.set_full_fp32()
    gen = torch.Generator().manual_seed(19)
    was = config.fast_gather_bits
    config.set_fast_gather_bits(bits)
    try:
        pts = _select_input(b, n, 3, dup, 19).to(dev)
        assert torch.equal(neg_min(pts), neg_min_plain(pts))
        for cross in (False, True):
            for V_out in (10, 16):
                f = {name: w.to(dev) for name, w in
                     _first_weights(3 if cross else 2, V_out, gen).items()}
                kw = dict(S_out=32, V_out=V_out, k=k, cross=cross,
                          mode="fast", T=t)
                got = sv_round3_first(pts, f, emit_wins=True, **kw)
                for g, w in zip(got, sv_round3_first_plain(pts, f, **kw)):
                    assert torch.equal(g, w)
        for S, V, S_out, V_out in ((5, 3, 13, 7), (32, 10, 32, 10)):
            rows = _select_input(b, n, S + 3 * V, dup, 20).to(dev)
            assert torch.equal(neg_min(rows), neg_min_plain(rows))
            src = rows.transpose(1, 2).contiguous()
            for binary in (True, False):
                f = {name: w.to(dev) for name, w in
                     _round_weights(S, V, S_out, V_out, binary, gen).items()}
                kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=k,
                          binary=binary, mode="fast", T=t)
                got = sv_round3(src, f, emit_wins=True, **kw)
                for g, w in zip(got, sv_round3_plain(src, f, **kw)):
                    assert torch.equal(g, w)
    finally:
        config.set_fast_gather_bits(was)


# (B, N, k, fold, key tile T or None): L = 250 (N = 1000; no multiple of
# the selection's 128-lane tile), L = 64 with four rows a class and several
# key tiles, N at the fold (approx is fast), k at and near small L,
# duplicated points
APPROX_FORCED = [(2, 1000, 20, 256, None, False), (3, 256, 40, 64, 64, True),
                 (2, 200, 7, 256, None, False), (1, 1024, 64, 64, 128, False),
                 (2, 2048, 40, 512, 128, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [16, 8], ids=["gb16", "gb8"])
@pytest.mark.parametrize("shape", APPROX_FORCED,
                         ids=[f"B{s[0]}-N{s[1]}-k{s[2]}-L{s[3]}-T{s[4] or 'auto'}"
                              + ("-dup" if s[5] else "") for s in APPROX_FORCED])
def test_approx_rounds_match_plain_on_card(shape, bits):
    """Approx mode at 16- and 8-bit gathers: B1 (xyz and cross) and B2
    ((5, 3) -> (13, 7), binary and FP), the folded selection's ids and the
    outputs bitwise their plain versions; at N <= fold the ids are fast
    mode's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from svnet_tpu_torch import config

    b, n, k, fold, t, dup = shape
    dev = torch.device("cuda", torch.cuda.current_device())
    config.set_full_fp32()
    gen = torch.Generator().manual_seed(23)
    was = config.approx_fold, config.approx_gather_bits
    config.set_approx_fold(fold)
    config.set_approx_gather_bits(bits)
    try:
        pts = _select_input(b, n, 3, dup, 23).to(dev)
        for cross in (False, True):
            f = {name: w.to(dev) for name, w in
                 _first_weights(3 if cross else 2, 10, gen).items()}
            kw = dict(S_out=32, V_out=10, k=k, cross=cross, T=t)
            got = sv_round3_first(pts, f, emit_wins=True, mode="approx", **kw)
            for g, w in zip(got, sv_round3_first_plain(pts, f, mode="approx", **kw)):
                assert torch.equal(g, w)
            if n <= fold:
                assert torch.equal(got[3], sv_round3_first(
                    pts, f, emit_wins=True, mode="fast", **kw)[3])
        src = _select_input(b, n, 14, dup, 24).to(dev).transpose(1, 2).contiguous()
        for binary in (True, False):
            f = {name: w.to(dev) for name, w in
                 _round_weights(5, 3, 13, 7, binary, gen).items()}
            kw = dict(S=5, V=3, S_out=13, V_out=7, k=k, binary=binary,
                      mode="approx", T=t)
            got = sv_round3(src, f, emit_wins=True, **kw)
            for g, w in zip(got, sv_round3_plain(src, f, **kw)):
                assert torch.equal(g, w)
    finally:
        config.set_approx_fold(was[0])
        config.set_approx_gather_bits(was[1])


# graph reuse: (B, N, k, r) -- the ids of a k selection, their first r
# ranks taken as a strided view at B >= 2 (r < k: a batch stride of k * N,
# not r * N), N and k that no edge tile (32 centres x 2 ranks) divides
REUSE_FORCED = [(2, 1000, 20, 7), (2, 1001, 33, 33), (3, 256, 40, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [16, 8], ids=["gb16", "gb8"])
@pytest.mark.parametrize("shape", REUSE_FORCED,
                         ids=[f"B{s[0]}-N{s[1]}-k{s[2]}-r{s[3]}" for s in REUSE_FORCED])
def test_reuse_rounds_match_plain_on_card(shape, bits):
    """B2 on given ids (``wins_in``) in exact, fast and approx mode at 16-
    and 8-bit gathers, (5, 3) -> (13, 7) binary and FP and cls conv4's
    widths binary: bitwise its plain version on the same strided rank
    prefix, on its contiguous copy and on point-major ids; one launch, no
    pre-pass; on the selecting round's own ids (r = k) bitwise that
    round."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from svnet_tpu_torch import config
    from svnet_tpu_torch.ops.kernels import knn as kk
    from svnet_tpu_torch.ops.kernels import sv_round3 as kr

    b, n, k, r = shape
    dev = torch.device("cuda", torch.cuda.current_device())
    config.set_full_fp32()
    gen = torch.Generator().manual_seed(31)
    was = (config.fast_gather_bits, config.approx_gather_bits)
    config.set_fast_gather_bits(bits)
    config.set_approx_gather_bits(bits)
    try:
        for S, V, S_out, V_out, modes in ((5, 3, 13, 7, (True, False)),
                                          (64, 21, 128, 42, (True,))):
            src = _select_input(b, n, S + 3 * V, False, 32).to(dev)
            src = src.transpose(1, 2).contiguous()
            for binary in modes:
                f = {name: w.to(dev) for name, w in
                     _round_weights(S, V, S_out, V_out, binary, gen).items()}
                kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, binary=binary)
                *sel, wins = sv_round3(src, f, k=k, emit_wins=True, **kw)
                view = wins[:, :r]
                for mode in ("exact", "fast", "approx"):
                    before = (kr.sv_round3_reuse.launches, kr.sv_round3.launches,
                              kk.neg_min.launches)
                    got = sv_round3(src, f, k=r, mode=mode, wins_in=view, **kw)
                    assert (kr.sv_round3_reuse.launches - before[0],
                            kr.sv_round3.launches - before[1],
                            kk.neg_min.launches - before[2]) == (1, 1, 0)
                    want = sv_round3_plain(src, f, k=r, mode=mode, wins_in=view, **kw)
                    dense = sv_round3(src, f, k=r, mode=mode,
                                      wins_in=view.contiguous(), **kw)
                    # point-major storage: copied, not read in place
                    pm = wins.transpose(1, 2).contiguous().transpose(1, 2)[:, :r]
                    copied = sv_round3(src, f, k=r, mode=mode, wins_in=pm, **kw)
                    for g, w, d, c in zip(got, want, dense, copied):
                        assert torch.equal(g, w) and torch.equal(g, d)
                        assert torch.equal(g, c)
                    if mode == "exact" and r == k:
                        for g, w in zip(got, sel):
                            assert torch.equal(g, w)
    finally:
        config.set_fast_gather_bits(was[0])
        config.set_approx_gather_bits(was[1])


# (kernel, B, N, S, V, S_out, V_out): Cin = 14 and S_out = 13 divide no K
# chunk (32) and no MMA tile; conv_fuse's and partseg conv5's widths (the
# 64- and 32-point tiles) at ragged N; B3 channel-major with two vector
# blocks (v_off) and its pooled outputs, B3r at N = 1000
POINT_FORCED = [("B8", 2, 1001, 5, 3, 13, 7), ("B8", 1, 1001, 1024, 340, 512, 170),
                ("B8", 1, 1000, 256, 85, 1024, 341), ("B3", 2, 1001, 5, 3, 13, 7),
                ("B3", 1, 1001, 256, 96, 512, 168), ("B3r", 2, 1000, 5, 3, 13, 7),
                ("B3r", 1, 1000, 256, 96, 512, 168)]


def two_blocks(S, V):
    """A v_off of two vector blocks tiling [S, S + 3V)."""
    V1 = max(1, V // 2)
    return ((S, V1), (S + 3 * V1, V - V1))


@pytest.mark.cuda
@pytest.mark.parametrize("binary", [True, False], ids=["binary", "fp"])
@pytest.mark.parametrize("shape", POINT_FORCED,
                         ids=[f"{s[0]}-N{s[2]}-S{s[3]}-V{s[4]}-So{s[5]}-Vo{s[6]}"
                              for s in POINT_FORCED])
def test_point_block_shape_forced_on_card(shape, binary):
    """B8, B3 and B3r bitwise against their plain versions (pooled outputs
    included) where no K chunk, MMA tile or point tile divides the widths
    and N."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from svnet_tpu_torch import config
    from svnet_tpu_torch.ops.kernels import sv_block_point as kb
    from svnet_tpu_torch.ops.kernels import sv_point as kp

    kern, b, n, S, V, S_out, V_out = shape
    dev = torch.device("cuda", torch.cuda.current_device())
    config.set_full_fp32()
    gen = torch.Generator().manual_seed(15)
    f = {name: t.to(dev) for name, t in
         _round_weights(S, V, S_out, V_out, binary, gen, point=True).items()}
    gate = torch.rand(b, V_out, generator=gen).to(dev)
    kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, binary=binary)
    if kern == "B3":
        src = torch.randn(b, S + 3 * V, n, generator=gen).to(dev)
        kw["v_off"] = two_blocks(S, V)
        got = kp.sv_point_block_cm(src, gate, f, **kw)
        want = kp.sv_point_block_cm_plain(src, gate, f, **kw)
    else:
        src = torch.randn(b, n, S + 3 * V, generator=gen).to(dev)
        fn, plain = ((kb.sv_block_point, kb.sv_block_point_plain) if kern == "B8"
                     else (kp.sv_point_block, kp.sv_point_block_plain))
        got, want = fn(src, gate, f, **kw), plain(src, gate, f, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _round_params(S, V, S_out, V_out, binary, gen):
    """The flax-named subtree of an edge round's SVBlock (2S scalars, 2V
    vectors in) at any widths, initialised as the model initialises it."""
    from svnet_tpu_torch.nn.sv_layers import SVBlock
    from svnet_tpu_torch.utils.convert import module_tree

    return module_tree(SVBlock(2 * S, 2 * V, S_out, V_out, binary, gen))["params"]


TRAIN_FORCED = [(8, 1000, 7, 5, 3, 13, 7), (8, 1000, 7, 64, 21, 128, 42)]


@pytest.mark.cuda
@pytest.mark.parametrize("binary", [True, False], ids=["binary", "fp"])
@pytest.mark.parametrize("shape", TRAIN_FORCED,
                         ids=[f"N{s[1]}-k{s[2]}-S{s[3]}-V{s[4]}-So{s[5]}-Vo{s[6]}"
                              for s in TRAIN_FORCED])
def test_train_round_shape_forced_on_card(shape, binary):
    """B6 at a ragged (8, 1000, 7) where neither the MMA tile nor the edge
    tile divides IN1 or S_out, and at conv4's widths, and B5 at the same
    B, N, k: forward within rtol 1e-4, atol 1e-5 (equal in fact), argmax
    ranks equal, gradients within the bars of phase 2 (all together 1e-3
    relative, cosines 0.99 on d(src) and 0.9 per gradient)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from svnet_tpu_torch import config
    from svnet_tpu_torch.models.sv_dgcnn import init_params
    from svnet_tpu_torch.ops.kernels import sv_first_train as kf
    from svnet_tpu_torch.ops.kernels import sv_round3_train as kr
    from svnet_tpu_torch.ops.kernels.knn import knn
    from svnet_tpu_torch.train.steps import tree_map

    b, n, k, S, V, S_out, V_out = shape
    dev = torch.device("cuda", torch.cuda.current_device())
    config.set_full_fp32()
    gen = torch.Generator().manual_seed(15)
    to = lambda t: t.to(dev)  # noqa: E731
    x = torch.randn(b, n, S + 3 * V, generator=gen).to(dev)
    model = tree_map(to, init_params(40, k, binary, gen)["params"])
    # the model's own conv4 at its widths, seeded weights at the odd ones
    sub = {m: model["conv4"][m] for m in ("v2s", "linear1", "bn1", "linear2", "bn2")} \
        if (S, V, S_out, V_out) == (64, 21, 128, 42) else \
        tree_map(to, _round_params(S, V, S_out, V_out, binary, gen))
    cases = [(x, kr.RoundDims(S, V, S_out, V_out, k, binary), sub,
              "sv_round3_train_launch")]
    p = tree_map(to, init_params(40, k, False, gen)["params"])
    cases.append((torch.randn(b, n, 3, generator=gen).to(dev),
                  kf.first_dims(32, 10, k),
                  {"init_scalar": p["init_scalar"], **p["conv1"]},
                  "sv_first_train_launch"))
    for x, d, sub, symbol in cases:
        idx = knn(x, k)
        kp = kr.kernel_params(sub, d)
        got = kr.train_fwd_kernel(symbol, x, idx, kp, d)
        want = kr.train_fwd_plain(x, idx, kp, d)
        for g, w in zip(got[:3] + got[3], want[:3] + want[3]):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
        assert torch.equal(got[4], want[4])
        dso = torch.randn(b, n, d.S_out, generator=gen).to(dev)
        dvo = torch.randn(b, n, 3 * d.V_out, generator=gen).to(dev)
        dss = torch.randn(b, d.SX, generator=gen).to(dev) * 1e-3
        saved = (want[4], want[3][0], want[3][2], want[3][3], want[3][5])
        gd, gg = kr.train_bwd_kernel(symbol, x, idx, kp, d, saved, dso, dvo, dss)
        wd, wg = kr.train_bwd_plain(x, idx, kp, d, saved, dso, dvo, dss)
        assert _cos(gd, wd) >= 0.99
        for name, w in wg.items():
            if w.numel() >= 8 and w.norm() > 1e-10:
                assert _cos(gg[name], w) >= 0.9, name
        a = torch.cat([gg[name].flatten() for name in wg])
        w = torch.cat([wg[name].flatten() for name in wg])
        assert float((a - w).norm() / w.norm()) <= 1e-3


# ---------------------------------------------------------------------------
# host-side helpers of the block kernels: no card needed, run everywhere
# ---------------------------------------------------------------------------


def _split3(x: torch.Tensor):
    """csrc/sv_mma.cuh::sv_split3 in PyTorch: bf16 pieces hi, mid, lo of
    f32 x, each rounded to nearest even from what the previous left."""
    hi = x.to(torch.bfloat16)
    r1 = x - hi.float()
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


@pytest.mark.parametrize("scale", [1e-25, 1e-6, 1.0, 1e6, 1e30])
def test_bf16_three_pieces_carry_f32_exactly(scale):
    """B6's backward multiplies a real cotangent split into three bf16
    pieces by signs on the tensor cores: the pieces must add back to the
    f32 value exactly (in any order), so that each product is exact."""
    gen = torch.Generator().manual_seed(16)
    x = torch.randn(4096, generator=gen) * scale
    x[:4] = torch.tensor([0.0, -0.0, 1.0 + 2.0 ** -23, -(2.0 - 2.0 ** -23)])
    hi, mid, lo = _split3(x)
    d = x.double()
    assert torch.equal(hi.double() + mid.double() + lo.double(), d)
    assert torch.equal((hi.float() + mid.float()) + lo.float(), x)


def test_stage_split_anchors_track_the_kernels():
    """Every stage the stage-split tool compiles out is found exactly once
    in this revision's block kernels (the conv-round blocks and the
    per-point tile routine), and ``if (0)`` lands in front of it; each
    group's variants carry their group's files; the split is base minus
    variant, the rest what the stages leave."""
    from pathlib import Path

    from svnet_tpu_torch.utils import stage_split as ss

    csrc = Path(ss.ROOT) / "svnet_tpu_torch" / "csrc"
    rounds = (csrc / "sv_rounds.cuh").read_text()
    train = (csrc / "sv_train.cuh").read_text()
    tile = (csrc / "sv_point_tile.cuh").read_text()
    assert "RB_TP" in rounds and "sv_mma.cuh" in train  # this revision's
    assert ss.point_stages(csrc) == [("tile:", "sv_point_tile.cuh", ss.TILE_NEW)]
    assert ss.first_stages(rounds) is ss.FIRST_NEW
    for text, stages in ((rounds, ss.SERVE_NEW), (train, ss.TRAIN_NEW),
                         (tile, ss.TILE_NEW), (rounds, ss.FIRST_NEW)):
        for _, anchors in stages:
            out = ss.without(text, anchors)
            assert out.count("if (0) ") == text.count("if (0) ") + len(anchors)
    with pytest.raises(ValueError):
        ss.without(rounds, ["no such statement"])
    # an anchor with a stand-in (the register-resident parent kernel's):
    # the stand-in lands in front of the statement compiled out
    assert ss.without("a; b; c;", [("b;", "s; ")]) == "a; s; if (0) b; c;"
    var = ss.variants(csrc, ["first"])
    assert set(var) == {"first"} | {f"first:{n}" for n, _ in ss.FIRST_NEW}
    assert all(group == "first" and set(files) == {"sv_rounds.cuh", "stage.cu"}
               for group, files in var.values())
    var = ss.variants(csrc, ["point"])
    assert set(var) == {"point"} | {f"tile:{n}" for n, _ in ss.TILE_NEW}
    assert all(group == "point" and "if (0) " not in files["sv_block_point.cu"]
               for group, files in var.values())
    got = ss.split({"rounds": 10.0, "serve:a": 7.0, "serve:b": 9.5, "train:c": 1.0},
                   "rounds", "serve:")
    assert got == {"kernel_ms": 10.0, "a": 3.0, "b": 0.5, "rest": 6.5}


# the candidate window: (B, N, k, W, approx fold, input, key tile T) on
# strand clouds (utils/synth.py), which certify at these N: k = 33 above a
# 32-entry list; duplicated points (every odd row repeats an even one) at
# a W that certifies (384) and one that does not (256); approx W = 384 at
# fold 64 (L = 48 at W, 64 at N); one cloud of the batch shuffled
# ("mixed"), so the whole batch falls back to the full scan; T = 256, two
# blocks a tile
WINDOW_FORCED = [(2, 1024, 33, 384, 256, None, 128), (3, 512, 20, 256, 256, "dup", 128),
                 (3, 512, 20, 384, 256, "dup", 128), (2, 1024, 20, 384, 64, None, 128),
                 (2, 1024, 20, 384, 256, "mixed", 128), (2, 2048, 20, 768, 256, None, 256)]


def _window_input(b, n, c, kind, seed):
    """Strand clouds (B, N, C), duplicated or with the last cloud
    shuffled as ``kind`` says."""
    from svnet_tpu_torch.utils.synth import strand_clouds

    x = torch.from_numpy(strand_clouds(seed, b, n, c))
    if kind == "dup":
        h = x[:, 1::2].shape[1]
        x[:, 1::2] = x[:, ::2][:, :h]
    elif kind == "mixed":
        x[-1] = x[-1, torch.randperm(n, generator=torch.Generator().manual_seed(seed))]
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [16, 8], ids=["gb16", "gb8"])
@pytest.mark.parametrize("shape", WINDOW_FORCED,
                         ids=[f"B{s[0]}-N{s[1]}-k{s[2]}-W{s[3]}-fold{s[4]}-T{s[6]}"
                              + (f"-{s[5]}" if s[5] else "") for s in WINDOW_FORCED])
def test_window_rounds_match_plain_on_card(shape, bits):
    """The candidate window in exact, fast and approx mode at 16- and 8-bit
    gathers: the pre-pass's kernels (window_tau, window_keep) and the
    scale pre-pass over the window bitwise their plain versions (tau also
    at N = 256, where the band holds the other block twice); B1
    (xyz) and B2 ((5, 3) -> (13, 7), binary and FP), ids and outputs
    bitwise their plain versions, with ``ok`` read on the card true and
    false; exact mode bitwise the full scan; one windowed launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from svnet_tpu_torch import config
    from svnet_tpu_torch.ops.kernels import knn as kk
    from svnet_tpu_torch.ops.kernels import sv_round3 as kr
    from svnet_tpu_torch.ops.window import (
        prune_prepass,
        window_tau,
        window_tau_plain,
    )

    b, n, k, W, fold, kind, T = shape
    dev = torch.device("cuda", torch.cuda.current_device())
    config.set_full_fp32()
    gen = torch.Generator().manual_seed(41)
    was = (config.fast_gather_bits, config.approx_gather_bits, config.approx_fold)
    config.set_fast_gather_bits(bits)
    config.set_approx_gather_bits(bits)
    config.set_approx_fold(fold)
    try:
        pts = _window_input(b, n, 3, kind, 41).to(dev)
        rows = _window_input(b, n, 14, kind, 42).to(dev)
        for x in (pts, rows):
            keep, ok = prune_prepass(x, k, T, W)
            assert bool(ok) == (kind is None or (kind == "dup" and W == 384))
            pkeep, pok = prune_prepass(x, k, T, W, plain=True)
            assert torch.equal(keep, pkeep) and bool(pok) == bool(ok)
            assert torch.equal(window_tau(x, k), window_tau_plain(x, k))
            win = (T, W, keep, ok.to(torch.int32))
            assert torch.equal(kk.neg_min(x, win), kk.neg_min_window_plain(x, win))
        small = _window_input(2, 256, 14, kind, 43).to(dev)
        assert torch.equal(window_tau(small, k), window_tau_plain(small, k))
        src = rows.transpose(1, 2).contiguous()
        f1 = {name: w.to(dev) for name, w in _first_weights(2, 10, gen).items()}
        for mode in ("exact", "fast", "approx"):
            kw = dict(S_out=32, V_out=10, k=k, mode=mode, T=T, window=W)
            before = kr.sv_round3_first.window_launches
            got = sv_round3_first(pts, f1, emit_wins=True, **kw)
            assert kr.sv_round3_first.window_launches == before + 1
            for g, w in zip(got, sv_round3_first_plain(pts, f1, **kw)):
                assert torch.equal(g, w)
            if mode == "exact":
                full = sv_round3_first(pts, f1, S_out=32, V_out=10, k=k,
                                       emit_wins=True)
                assert all(torch.equal(g, w) for g, w in zip(got, full))
            for binary in (True, False):
                f = {name: w.to(dev) for name, w in
                     _round_weights(5, 3, 13, 7, binary, gen).items()}
                kw = dict(S=5, V=3, S_out=13, V_out=7, k=k, binary=binary,
                          mode=mode, T=T, window=W)
                before = kr.sv_round3.window_launches
                got = sv_round3(src, f, emit_wins=True, **kw)
                assert kr.sv_round3.window_launches == before + 1
                for g, w in zip(got, sv_round3_plain(src, f, **kw)):
                    assert torch.equal(g, w)
                if mode == "exact":
                    full = sv_round3(src, f, S=5, V=3, S_out=13, V_out=7, k=k,
                                     binary=binary, emit_wins=True)
                    assert all(torch.equal(g, w) for g, w in zip(got, full))
    finally:
        config.set_fast_gather_bits(was[0])
        config.set_approx_gather_bits(was[1])
        config.set_approx_fold(was[2])


# fast mode's pre-pass (csrc/knn.cu, the symmetric 128 x 128 tiles): (B, N,
# C, input): N off the tile (1000, 1001, 130, 50), C off the 16-channel
# stage and below it, duplicated points, one point repeated
PREPASS_FORCED = [(2, 1000, 5, None), (2, 1001, 33, None), (3, 130, 1, None),
                  (1, 50, 127, None), (2, 1024, 62, "dup"), (1, 256, 3, "same")]


def _prepass_input(b, n, c, kind, seed):
    x = torch.randn(b, n, c, generator=torch.Generator().manual_seed(seed))
    if kind == "dup":
        x[:, 1::2] = x[:, 0::2][:, : x[:, 1::2].shape[1]]
    elif kind == "same":
        x[:] = x[:, :1]
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PREPASS_FORCED,
                         ids=[f"B{s[0]}-N{s[1]}-C{s[2]}" + (f"-{s[3]}" if s[3] else "")
                              for s in PREPASS_FORCED])
def test_prepass_shape_forced_on_card(shape):
    """The pre-pass bitwise neg_min_plain, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from svnet_tpu_torch.ops.kernels import knn as kk

    b, n, c, kind = shape
    x = _prepass_input(b, n, c, kind, 45).to(torch.device("cuda"))
    before = kk.neg_min.launches
    got = kk.neg_min(x)
    assert kk.neg_min.launches == before + 1
    assert torch.equal(got, kk.neg_min_plain(x))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", WINDOW_FORCED,
                         ids=[f"B{s[0]}-N{s[1]}-k{s[2]}-W{s[3]}-T{s[6]}"
                              + (f"-{s[5]}" if s[5] else "") for s in WINDOW_FORCED])
def test_window_prepasses_forced_on_card(shape):
    """window_tau bitwise window_tau_plain at k = 1, 20, 40, 100, 384 on
    duplicated rows; the windowed pre-pass bitwise its plain version with
    the batch's certificate and with ok forced to 0 (all rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from svnet_tpu_torch.ops.kernels import knn as kk
    from svnet_tpu_torch.ops.window import prune_prepass, window_tau, window_tau_plain

    b, n, k, W, _, kind, T = shape
    dev = torch.device("cuda")
    rows = _window_input(b, n, 14, kind, 46).to(dev)
    dup = _window_input(b, n, 5, "dup", 47).to(dev)
    for kk_ in (1, 20, 40, 100, 384):
        assert torch.equal(window_tau(dup, kk_), window_tau_plain(dup, kk_))
    keep, ok = prune_prepass(rows, k, T, W)
    for okv in {int(ok), 0}:
        win = (T, W, keep, torch.tensor(okv, dtype=torch.int32, device=dev))
        assert torch.equal(kk.neg_min(rows, win), kk.neg_min_window_plain(rows, win))


# the legacy trunks' fast and approx mode: (B, N, k, key tile T, duplicated
# points): T = 8 at N = 1000 (approx L = 250, no multiple of the
# selection's 128-lane tile), k = 33 above a 32-entry list at one key tile
# of 256, N at the fold (approx is fast) with ties, k = 64 with several
# key tiles, one key tile a cloud (T = N = 512, L = 256)
LEGACY_FORCED = [(2, 1000, 7, 8, False), (2, 1024, 33, 256, False),
                 (3, 256, 40, 64, True), (1, 2048, 64, 128, False),
                 (2, 512, 20, 512, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fast", "approx"])
@pytest.mark.parametrize("shape", LEGACY_FORCED,
                         ids=[f"B{s[0]}-N{s[1]}-k{s[2]}-T{s[3]}"
                              + ("-dup" if s[4] else "") for s in LEGACY_FORCED])
def test_legacy_modes_match_plain_on_card(shape, mode):
    """B10b in fast and approx mode (16-bit grid, fold 256) and B10a with
    exact=False (bf16 gather; fast only, once): the first round (xyz and
    cross, V_out 10 and 16) and the conv round ((5, 3) -> (13, 7) and
    (32, 10) -> (32, 10), binary and FP), ids and outputs bitwise their
    plain versions; at N <= 256 approx's ids are fast's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from svnet_tpu_torch import config
    from svnet_tpu_torch.ops.kernels import sv_round as k1
    from svnet_tpu_torch.ops.kernels import sv_round2 as k2

    b, n, k, t, dup = shape
    dev = torch.device("cuda", torch.cuda.current_device())
    config.set_full_fp32()
    gen = torch.Generator().manual_seed(29)
    pts = _select_input(b, n, 3, dup, 29).to(dev)
    for cross in (False, True):
        for V_out in (10, 16):
            f = {name: w.to(dev) for name, w in
                 _first_weights(3 if cross else 2, V_out, gen).items()}
            kw = dict(S_out=32, V_out=V_out, k=k, cross=cross, T=t)
            got = k2.sv_round2_first(pts, f, emit_wins=True, mode=mode, **kw)
            for g, w in zip(got, k2.sv_round2_first_plain(pts, f, mode=mode, **kw)):
                assert torch.equal(g, w)
            if mode == "approx" and n <= 256:
                assert torch.equal(got[3], k2.sv_round2_first(
                    pts, f, emit_wins=True, mode="fast", **kw)[3])
            if mode == "fast":
                for g, w in zip(k1.sv_round_first(pts, f, exact=False, **kw),
                                k1.sv_round_first_plain(pts, f, exact=False, **kw)):
                    assert torch.equal(g, w)
    for S, V, S_out, V_out in ((5, 3, 13, 7), (32, 10, 32, 10)):
        src = _select_input(b, n, S + 3 * V, dup, 30).to(dev)
        for binary in (True, False):
            f = {name: w.to(dev) for name, w in
                 _round_weights(S, V, S_out, V_out, binary, gen).items()}
            kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=k, binary=binary,
                      T=t)
            got = k2.sv_round2(src, f, emit_wins=True, mode=mode, **kw)
            for g, w in zip(got, k2.sv_round2_plain(src, f, mode=mode, **kw)):
                assert torch.equal(g, w)
            if mode == "fast":
                for g, w in zip(k1.sv_round(src, f, exact=False, **kw),
                                k1.sv_round_plain(src, f, exact=False, **kw)):
                    assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("impl,mode", [("round2", "fast"), ("round2", "approx"),
                                       ("round", "fast")])
def test_legacy_mode_engines_on_card(impl, mode):
    """The classifier's round2 trunk in fast and approx mode and its round
    trunk in fast mode at N = 512 (key tiles of 256): the kernels' launches
    per request (the pre-pass once a round), logits bitwise the plain
    twin's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from svnet_tpu_torch.models.sv_dgcnn import init_params
    from svnet_tpu_torch.ops.kernels import knn as kk
    from svnet_tpu_torch.ops.kernels import sv_round as k1
    from svnet_tpu_torch.ops.kernels import sv_round2 as k2
    from svnet_tpu_torch.ops.kernels.sv_point import sv_point_block

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator().manual_seed(31)
    w = init_params(40, 10, True, gen)
    pts = torch.randn(2, 512, 3, generator=gen).to(dev)
    first, rnd = ((k2.sv_round2_first, k2.sv_round2) if impl == "round2"
                  else (k1.sv_round_first, k1.sv_round))
    fns = (first, rnd, kk.neg_min, sv_point_block)
    eng = TorchEngine(w, 40, 10, True, device=dev, rounds_impl=impl, mode=mode)
    before = [f.launches for f in fns]
    out = eng(pts)
    assert [f.launches - b for f, b in zip(fns, before)] == [1, 3, 4, 1]
    oracle = TorchEngine(w, 40, 10, True, device=dev, rounds_impl=impl,
                         mode=mode, oracle=True)
    before = [f.launches for f in fns]
    assert torch.equal(out, oracle(pts))
    assert [f.launches for f in fns] == before


# the edge trunk's fast and approx mode (exact=False): B10c's conv block
# at CONV_FORCED, B10d's first round at FIRST_FORCED
@pytest.mark.cuda
@pytest.mark.parametrize("binary", [True, False], ids=["binary", "fp"])
@pytest.mark.parametrize("shape", CONV_FORCED,
                         ids=[f"N{s[1]}-k{s[2]}-S{s[3]}-V{s[4]}-So{s[5]}-Vo{s[6]}"
                              for s in CONV_FORCED])
def test_edge_block_fast_shape_forced_on_card(shape, binary):
    """B10c with exact=False (sv_round_block_kernel<true, true, true>: the
    bf16 rows, linear2 through bf16) bitwise its plain version on B4's
    ids where neither the MMA tile nor the edge tile divides the widths, N
    or k; exact mode's instantiation on the same input stays bitwise its
    own, and the two differ."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from svnet_tpu_torch import config
    from svnet_tpu_torch.ops.kernels import sv_edge as ke
    from svnet_tpu_torch.ops.kernels.knn import knn

    b, n, k, S, V, S_out, V_out = shape
    dev = torch.device("cuda", torch.cuda.current_device())
    config.set_full_fp32()
    gen = torch.Generator().manual_seed(41)
    f = {name: t.to(dev) for name, t in
         _round_weights(S, V, S_out, V_out, binary, gen).items()}
    src = torch.randn(b, n, S + 3 * V, generator=gen).to(dev)
    kw = dict(S=S, V=V, S_out=S_out, V_out=V_out, k=k, binary=binary)
    idx = knn(src, k)
    gate = torch.rand(b, V_out, generator=gen).to(dev)
    before = ke.sv_edge_block.launches
    got = ke.sv_edge_block(src, idx, gate, f, exact=False, **kw)
    assert ke.sv_edge_block.launches == before + 1
    for g, w in zip(got, ke.sv_edge_block_plain(src, idx, gate, f, exact=False,
                                                **kw)):
        assert torch.equal(g, w)
    exact = ke.sv_edge_block(src, idx, gate, f, **kw)
    for g, w in zip(exact, ke.sv_edge_block_plain(src, idx, gate, f, **kw)):
        assert torch.equal(g, w)
    assert not torch.equal(got[1], exact[1])


@pytest.mark.cuda
@pytest.mark.parametrize("V_out", [10, 16])
@pytest.mark.parametrize("shape", FIRST_FORCED,
                         ids=[f"B{s[0]}-N{s[1]}-k{s[2]}" for s in FIRST_FORCED])
def test_edge_first_fast_shape_forced_on_card(shape, V_out):
    """B10d with exact=False (the first-round block on the bf16 points)
    bitwise its plain version on B4's ids at FIRST_FORCED."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from svnet_tpu_torch import config
    from svnet_tpu_torch.ops.kernels import sv_edge_first as kf
    from svnet_tpu_torch.ops.kernels.knn import knn

    b, n, k = shape
    dev = torch.device("cuda", torch.cuda.current_device())
    config.set_full_fp32()
    gen = torch.Generator().manual_seed(42)
    f = {name: w.to(dev) for name, w in _first_weights(2, V_out, gen).items()}
    pts = torch.randn(b, n, 3, generator=gen).to(dev)
    idx = knn(pts, k)
    kw = dict(S_out=32, V_out=V_out, k=k, exact=False)
    for g, w in zip(kf.sv_edge_first_block(pts, idx, f, **kw),
                    kf.sv_edge_first_block_plain(pts, idx, f, **kw)):
        assert torch.equal(g, w)


# B4's fast and approx mode: (B, N, C, k, key tile, duplicated points):
# one key tile a cloud; several, folded 2048 -> 256 at k = 64; N = 384
# folded to 192 lanes at k = 40; ties on key tiles of 64; C off the
# selection's 32-channel chunk
KNN_MODES_FORCED = [(2, 256, 3, 8, 256, False), (2, 2048, 127, 64, 128, False),
                    (1, 384, 16, 40, 128, False), (3, 512, 62, 33, 64, True),
                    (2, 1024, 3, 20, 128, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fast", "approx"])
@pytest.mark.parametrize("shape", KNN_MODES_FORCED,
                         ids=[f"B{s[0]}-N{s[1]}-C{s[2]}-k{s[3]}-T{s[4]}"
                              + ("-dup" if s[5] else "") for s in KNN_MODES_FORCED])
def test_knn_modes_match_plain_on_card(shape, mode):
    """B4 with mode= (the pre-pass, then the selection on the key tiles'
    scales, folded in approx mode) bitwise its plain version; one kernel
    launch and one pre-pass a call, counted on knn.neg_min_launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from svnet_tpu_torch.ops.kernels import knn as kk

    b, n, c, k, tile, dup = shape
    x = _select_input(b, n, c, dup, 43).to(torch.device("cuda"))
    before = (kk.knn.launches, kk.neg_min.launches, kk.knn.neg_min_launches)
    got = kk.knn(x, k, mode=mode, tile=tile)
    assert (kk.knn.launches, kk.neg_min.launches, kk.knn.neg_min_launches) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    assert torch.equal(got, kk.knn_mode_plain(x, k, mode, tile))


@pytest.mark.cuda
@pytest.mark.parametrize("binary", [True, False], ids=["binary", "fp"])
def test_cls_edge_mode_engines_on_card(binary):
    """The classifier's edge trunk in fast and approx mode: per request
    knn x4 (exact: no pre-pass), B10d x1, B10c x3, B3r x1; logits bitwise
    the plain twin's; approx equal to fast."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from svnet_tpu_torch.models.sv_dgcnn import init_params
    from svnet_tpu_torch.ops.kernels import knn as kk
    from svnet_tpu_torch.ops.kernels import sv_edge as ke
    from svnet_tpu_torch.ops.kernels import sv_edge_first as kf
    from svnet_tpu_torch.ops.kernels.sv_point import sv_point_block

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator().manual_seed(44)
    w = init_params(40, 10, binary, gen)
    pts = torch.randn(2, 300, 3, generator=gen).to(dev)
    fns = (kk.knn, kf.sv_edge_first_block, ke.sv_edge_block, sv_point_block,
           kk.neg_min)
    outs = {}
    for mode in ("fast", "approx"):
        eng = TorchEngine(w, 40, 10, binary, device=dev, rounds_impl="edge",
                          mode=mode)
        before = [f.launches for f in fns]
        outs[mode] = eng(pts)
        assert [f.launches - b for f, b in zip(fns, before)] == [4, 1, 3, 1, 0]
        oracle = TorchEngine(w, 40, 10, binary, device=dev, rounds_impl="edge",
                             mode=mode, oracle=True)
        assert torch.equal(outs[mode], oracle(pts))
    assert torch.equal(outs["fast"], outs["approx"])


# the window's block test (csrc/window.cu): (B, N, C, key tile T, input):
# C = 1, 3, 5 below and off the 16-channel stage, 127 off it; T = 128 and
# T = N; N = 384 (3 blocks, under the 8 of a warp); strand clouds and
# Morton-sorted surface clouds
KEEP_FORCED = [(2, 1024, 1, 128, "strand"), (2, 1024, 3, 1024, "strand"),
               (3, 384, 5, 128, "strand"), (1, 2048, 127, 256, "strand"),
               (2, 1024, 127, 1024, "strand"), (2, 2048, 3, 128, "surface"),
               (1, 384, 127, 384, "strand")]


def _keep_inputs(b, n, c, kind, seed):
    """x (B, N, C) on the card, its blocks' boxes, and tau as
    prune_prepass raises it (k = 20)."""
    from svnet_tpu_torch.ops import morton
    from svnet_tpu_torch.ops.window import raise_tau, window_tau_plain
    from svnet_tpu_torch.utils.synth import strand_clouds, surface_clouds

    dev = torch.device("cuda")
    if kind == "surface":
        x = morton.sort_points(torch.from_numpy(surface_clouds(seed, b, n)).to(dev))[0]
    else:
        x = torch.from_numpy(strand_clouds(seed, b, n, c)).to(dev)
    x = x.contiguous()
    tau = raise_tau(x, window_tau_plain(x, 20))
    xb = x.reshape(b, n // 128, 128, x.shape[-1])
    return x, xb.amin(dim=2).contiguous(), xb.amax(dim=2).contiguous(), tau


@pytest.mark.cuda
@pytest.mark.parametrize("shape", KEEP_FORCED,
                         ids=[f"B{s[0]}-N{s[1]}-C{s[2]}-T{s[3]}-{s[4]}"
                              for s in KEEP_FORCED])
def test_window_keep_shape_forced_on_card(shape):
    """window_keep bitwise window_keep_plain, one launch a call, the
    flags mixed (5-95% kept: at T = N, where
    every block holds centres that keep it, the centres past the first
    100 of each cloud get tau = -1 and the first 100 at most 0.5); a tie
    (tau set
    to a centre's lb2 in the plain version's rounding) keeps the block and
    the next float below prunes it; a NaN tau keeps every block of its
    tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from svnet_tpu_torch.ops import window as win

    b, n, c, T, kind = shape
    x, lo, hi, tau = _keep_inputs(b, n, c, kind, 48)
    if T == n:
        tau[:, :100] = tau[:, :100].clamp(max=0.5)
        tau[:, 100:] = -1.0
    tau = tau.contiguous()
    before = win.window_keep.launches
    got = win.window_keep(x, lo, hi, tau, T)
    assert win.window_keep.launches == before + 1
    want = win.window_keep_plain(x, lo, hi, tau, T)
    assert torch.equal(got, want)
    assert 0.05 <= float(want.float().mean()) <= 0.95
    # a tie: the tile's only live centre n sits exactly on its lb2 to the
    # last block, in the plain version's rounding
    n0, bk = 0, n // 128 - 1
    d = torch.clamp(torch.maximum(lo[0, bk] - x[0, n0], x[0, n0] - hi[0, bk]), min=0.0)
    lb2 = d[0] * d[0]
    for ch in range(1, d.shape[0]):
        lb2 = lb2 + d[ch] * d[ch]
    assert float(lb2) > 0.0
    for t, flag in ((lb2, 1), (torch.nextafter(lb2, lb2.new_tensor(-1.0)), 0)):
        tie = tau.clone()
        tie[0, :T] = -1.0
        tie[0, n0] = t
        got = win.window_keep(x, lo, hi, tie, T)
        assert torch.equal(got, win.window_keep_plain(x, lo, hi, tie, T))
        assert int(got[0, 0, bk]) == flag
    nan = tau.clone()
    nan[-1, 5] = float("nan")
    got = win.window_keep(x, lo, hi, nan, T)
    assert torch.equal(got, win.window_keep_plain(x, lo, hi, nan, T))
    assert bool((got[-1, 5 // T] == 1).all())


# B7's backward (csrc/edge_gather.cu): (B, M, k, C, ids), as chip_smoke.py's
# GATHER_FORCED: a hub every centre names (in-degree M); partseg's cloud
# (2048, 40); a cloud's ids on 64 targets (one target range, several
# shared-memory windows of it); every id one target (a segment above the
# shared-memory list: the device-memory spill); ids outside [0, n_src),
# ignored, on M k = 7007 ids (no int4 loads); n_src = 2 M; C = 1, 62, 127
BWD_FORCED = [(2, 1024, 20, 62, "hub"), (2, 2048, 40, 8, None),
              (1, 2048, 40, 1, "narrow"), (1, 1024, 20, 127, "one"),
              (2, 1001, 7, 5, "out"), (3, 500, 9, 3, "wide"),
              (2, 1000, 7, 127, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BWD_FORCED,
                         ids=[f"B{s[0]}-M{s[1]}-k{s[2]}-C{s[3]}" + (f"-{s[4]}" if s[4] else "")
                              for s in BWD_FORCED])
def test_edge_gather_bwd_forced_on_card(shape):
    """B7's backward bitwise its plain version (ids outside [0, n_src)
    sent to target 0 with rows of +0.0, which leave every sum as it is),
    one launch a call, two launches identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from svnet_tpu_torch.ops.kernels import edge_gather as eg

    b, n, k, c, kind = shape
    gen = torch.Generator().manual_seed(49)
    n_src = 2 * n if kind == "wide" else n
    idx = torch.randint(0, n_src, (b, n, k), generator=gen, dtype=torch.int32)
    if kind == "hub":
        idx[:, :, 0] = 7
    elif kind == "narrow":
        idx = torch.randint(0, 64, (b, n, k), generator=gen, dtype=torch.int32)
    elif kind == "one":
        idx[:] = 5
    elif kind == "out":
        idx[:, ::3, 1] = n_src
        idx[:, 1::5, 2] = -1
        idx[0, 0, 0] = -(2 ** 31)
    dev = torch.device("cuda")
    g = torch.randn(b, n, k, c, generator=gen).to(dev)
    idx = idx.to(dev)
    before = eg.edge_gather_bwd.launches
    got = eg.edge_gather_bwd(g, idx, n_src)
    assert eg.edge_gather_bwd.launches == before + 1
    bad = (idx < 0) | (idx >= n_src)
    want = eg.edge_gather_bwd_plain(torch.where(bad[..., None], torch.zeros_like(g), g),
                                    torch.where(bad, torch.zeros_like(idx), idx), n_src)
    assert torch.equal(got, want)
    assert torch.equal(got, eg.edge_gather_bwd(g, idx, n_src))
