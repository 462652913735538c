"""The port's complexity analyzer (svnet_tpu_torch/utils/analysis.py): the
three tests of tests/test_analysis.py, mirrored, the kNN's inner products
counted as JAX's einsum counts them, ``flop_cost`` and the CLI.

``analyze_model``'s every number against JAX's, for each (task, backbone,
model) that JAX's ``analyze_model`` builds, binary and FP, at N = 64,
k = 8, is in tests/test_torch_analysis_{dgcnn,pointnet,zoo}.py (six
cases a file: each traces a JAX model, which takes seconds); ``parity``
is their check.
"""

import numpy as np
import pytest
import torch

from svnet_tpu_torch.ops.knn import knn_plain
from svnet_tpu_torch.utils.analysis import (
    analyze_model,
    count_params,
    flop_cost,
    main,
    op_counts,
)

N_PARITY, K_PARITY = 64, 8


def parity(task: str, backbone: str, model: str, binary: bool) -> None:
    """Every number of the port's ``analyze_model`` equal to JAX's."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from svnet_tpu.utils.analysis import analyze_model as jax_analyze

    kw = dict(binary=binary, num_points=N_PARITY, k=K_PARITY)
    want = jax_analyze(task, backbone, model, **kw)
    got = analyze_model(task, backbone, model, **kw)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-12, abs=0), key


def test_count_params_binary_weighting():
    params = {
        "fp": {"kernel": np.zeros((10, 10)), "bias": np.zeros(10)},
        "bin": {"kernel": torch.zeros((10, 10)), "scale": torch.zeros(10)},
    }
    res = count_params(params)
    assert abs(res["params_m"] * 1e6 - 220) < 1e-6
    assert abs(res["binarized_m"] * 1e6 - 100) < 1e-6
    # 120 fp32 params * 32 bits + 100 binary * 1 bit
    assert abs(res["size_mbit"] * 1e6 - (120 * 32 + 100)) < 1e-3


def test_op_counts_classification():
    w = torch.ones((8, 16))

    def fp(x):
        return x @ w

    def bin_both(x):
        return torch.sign(x) @ torch.sign(w)

    def bin_w(x):
        return x @ torch.sign(w)

    def bin_scaled(x):  # provenance through a mul and a transpose
        return torch.sign(x) @ (torch.sign(w.T) * 0.5).T

    x = torch.ones((4, 8))
    assert op_counts(fp, x)["macs"] * 1e6 == 4 * 8 * 16
    assert op_counts(bin_both, x)["bops"] * 1e6 == 4 * 8 * 16
    assert op_counts(bin_w, x)["adds"] * 1e6 == 4 * 8 * 16
    assert op_counts(bin_scaled, x)["bops"] * 1e6 == 4 * 8 * 16


def test_analyze_sv_dgcnn_binary_moves_ops_to_bops():
    fp = analyze_model("cls", "dgcnn", "svnet", binary=False, num_points=64, k=8)
    bi = analyze_model("cls", "dgcnn", "svnet", binary=True, num_points=64, k=8)
    assert bi["bops_m_per_cloud"] > 0
    assert bi["macs_m_per_cloud"] < fp["macs_m_per_cloud"]
    assert bi["size_mbit"] < fp["size_mbit"] / 5  # 1-bit weights dominate


def test_knn_inner_products_count_as_macs():
    """The kNN's inner products (``svnet::pair_inner``) count B*N*N*C MACs,
    as JAX's einsum does, and the ids are knn_plain's."""
    x = torch.randn(2, 50, 5, generator=torch.Generator().manual_seed(0))
    assert op_counts(lambda t: knn_plain(t, 4), x)["macs"] * 1e6 == 2 * 50 * 50 * 5


def test_flop_cost_and_cli(capsys):
    """flop_cost: a matmul's 2*M*K*N flops and its operands' and output's
    bytes; the CLI prints JAX's three lines."""
    a, b = torch.ones((4, 8)), torch.ones((8, 16))
    cost = flop_cost(lambda x, y: x @ y, a, b)
    assert cost["flops"] == 2 * 4 * 8 * 16
    assert cost["bytes_accessed"] == 4 * (4 * 8 + 8 * 16 + 4 * 16)
    res = main(["--model", "vn", "--backbone", "pointnet", "--num-points", "32",
                "--k", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "vn-pointnet-cls @ N=32, k=4:"
    assert out[1].startswith("  Params: ") and out[2].startswith("  per cloud: MACs")
    assert res["macs_m_per_cloud"] > 0
