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
