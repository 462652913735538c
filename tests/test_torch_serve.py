"""AOT export of the port's engines (svnet_tpu_torch/serve.py), on the CPU:
the loaded artifact equals the live engine bitwise for every engine, trunk
and mode that the JAX ``export_engine`` takes, and its graph calls the
serving kernels by their ``svnet::`` op names (on the CPU each op runs its
plain version). The bytes round-trip through a file, and a fresh process
that imports only ``svnet_tpu_torch.serve`` reproduces the logits.

The cases run in files of at most 6 tests (ROADMAP, "Tier-1 verify"): the
round3 classifier's here, the other trunks and the part segmenters in
tests/test_torch_serve_trunks.py, the ops' registrations and the
certification CLI in tests/test_torch_serve_ops.py.

Classification at (2, 128, 8), part segmentation at (2, 128, 16); the
candidate window at N = 1024, the least N where a window narrower than the
key tile's heuristic T is certified.
"""

import contextlib
import subprocess
import sys

import pytest
import torch

from svnet_tpu_torch import config, infer
from svnet_tpu_torch.models import sv_dgcnn, sv_pointnet
from svnet_tpu_torch.serve import export_engine, export_program, load_engine

B, N, K, K_PSEG = 2, 128, 8, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def knobs(**kw):
    """``config`` knobs set through their setters, restored after."""
    was = {name: getattr(config, name) for name in kw}
    try:
        for name, value in kw.items():
            getattr(config, "set_" + name)(value)
        yield
    finally:
        for name, value in was.items():
            setattr(config, name, value)


def _points(n=N, seed=0):
    return torch.randn(B, n, 3, generator=torch.Generator().manual_seed(seed))


def _label():
    return torch.nn.functional.one_hot(torch.tensor([1, 5]), 16).float()


def _gen(seed=1):
    return torch.Generator().manual_seed(seed)


def _dgcnn_cls(binary=True, **kw):
    return infer.SVDGCNNClsEngine(sv_dgcnn.init_params(10, K, binary, _gen()),
                                  10, K, binary, device="cpu", **kw)


def _dgcnn_pseg(binary=True, **kw):
    return infer.SVDGCNNPsegEngine(
        sv_dgcnn.init_params_pseg(50, K_PSEG, binary, _gen()), 50, K_PSEG,
        binary, device="cpu", **kw)


def _pointnet_cls(binary=True, **kw):
    return infer.SVPointNetClsEngine(
        sv_pointnet.init_params(10, K, binary, _gen()), 10, K, binary,
        device="cpu", **kw)


def _pointnet_pseg(binary=True, **kw):
    return infer.SVPointNetPsegEngine(
        sv_pointnet.init_params_pseg(50, K_PSEG, binary, _gen()), 50, K_PSEG,
        binary, device="cpu", **kw)


R3 = ["sv_round3_first", "sv_round3", "sv_point_block_cm"]
# name -> (a function making the engine, its args, config knobs, the
# svnet:: ops the exported graph must call)
CASES = {
    "dgcnn_cls_exact": (_dgcnn_cls, {}, {}, R3),
    "dgcnn_cls_fp_fast8": (lambda: _dgcnn_cls(False, mode="fast"), {},
                           {"fast_gather_bits": 8}, R3),
    "dgcnn_cls_serving_pick": (
        lambda: _dgcnn_cls(mode="approx"), {},
        {"approx_fold": 64, "approx_gather_bits": 8, "graph_reuse": "spatial"},
        ["sv_round3_first", "sv_round3_reuse", "sv_point_block_cm"]),
    "dgcnn_cls_conv2_reuse_k": (
        _dgcnn_cls, {}, {"graph_reuse": "conv2", "reuse_k": 4,
                         "reuse_gather_window": 128},
        R3 + ["sv_round3_reuse"]),
    "dgcnn_cls_window": (lambda: _dgcnn_cls(mode="fast", window=512),
                         {"n": 1024}, {"morton_entry": True}, R3),
}
# the other trunks and the part segmenters (tests/test_torch_serve_trunks.py
# and, for the last, tests/test_torch_serve_ops.py)
OTHER_CASES = {
    "dgcnn_cls_round2_approx": (
        lambda: _dgcnn_cls(mode="approx", rounds_impl="round2"), {}, {},
        ["sv_round2_first", "sv_round2", "sv_point_block"]),
    "dgcnn_cls_round_fast": (
        lambda: _dgcnn_cls(mode="fast", rounds_impl="round"), {}, {},
        ["sv_round_first", "sv_round", "sv_point_block"]),
    "dgcnn_cls_edge_fast": (
        lambda: _dgcnn_cls(mode="fast", rounds_impl="edge"), {}, {},
        ["knn", "sv_edge_first_block", "sv_edge_block", "sv_point_block"]),
    "dgcnn_pseg_approx": (lambda: _dgcnn_pseg(mode="approx"), {"label": True},
                          {"approx_fold": 64}, R3),
    "dgcnn_pseg_round2": (lambda: _dgcnn_pseg(rounds_impl="round2"),
                          {"label": True}, {},
                          ["sv_round2_first", "sv_round2", "sv_point_block"]),
    "pointnet_cls_fast": (lambda: _pointnet_cls(mode="fast"), {}, {},
                          ["sv_round3_first", "sv_block_point"]),
    "pointnet_pseg_fp": (lambda: _pointnet_pseg(False), {"label": True}, {},
                         ["sv_round3_first", "sv_block_point"]),
}


def _args(n=N, label=False):
    return (_points(n),) + ((_label(),) if label else ())


def _svnet_ops(program) -> set:
    return {n.target.name().split("::")[1] for n in program.graph.nodes
            if n.op == "call_function" and str(n.target).startswith("svnet.")}


def check_artifact(build, arg_kw, knob_kw, ops):
    """export_engine -> bytes -> load_engine: the same logits as the live
    engine, bitwise, under the knobs it was exported with; the graph calls
    the trunk's kernels by their svnet:: names."""
    args = _args(**arg_kw)
    with knobs(**knob_kw):
        eng = build()
        want = eng(*args)
        assert set(ops) <= _svnet_ops(export_program(eng, *args))
        blob = export_engine(eng, *args)
    assert isinstance(blob, bytes) and blob
    got = load_engine(blob)(*args)
    assert got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("case", list(CASES))
def test_artifact_equals_live_engine(case):
    """The round3 classifier's artifact equals its live engine
    (``check_artifact``)."""
    check_artifact(*CASES[case])


def test_artifact_roundtrips_through_a_file_and_a_fresh_process(tmp_path):
    """The bytes written to a file load back to the same program, and a
    fresh ``python -c`` process that imports only svnet_tpu_torch.serve
    (which registers the ops) reproduces the logits bitwise."""
    eng = _dgcnn_cls()
    pts = _points(seed=3)
    want = eng(pts)
    art = tmp_path / "engine.pt2"
    art.write_bytes(export_engine(eng, pts))
    torch.save(pts, tmp_path / "points.pt")
    assert torch.equal(load_engine(art.read_bytes())(pts), want)
    code = (
        "import sys, torch\n"
        "from svnet_tpu_torch.serve import load_engine\n"
        "d = sys.argv[1]\n"
        "call = load_engine(open(d + '/engine.pt2', 'rb').read())\n"
        "torch.save(call(torch.load(d + '/points.pt')), d + '/logits.pt')\n"
        "assert 'svnet_tpu_torch.infer' not in sys.modules\n")
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert torch.equal(torch.load(tmp_path / "logits.pt"), want)
