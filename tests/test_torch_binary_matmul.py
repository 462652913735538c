"""Kernel B9 of the port: ``pack_signs`` and the XNOR-popcount product's
plain version against the JAX package's (``xnor_popcount_matmul`` in
interpret mode, at tests/test_binary_matmul.py's shapes), exactly, the
kernel's AND-only identity against the plain version, and the bench's
``main`` on the CPU. Operands are zero-free +-1 from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnet_tpu.ops.pallas.binary_matmul import pack_signs as jax_pack
from svnet_tpu.ops.pallas.binary_matmul import xnor_popcount_matmul as jax_xnor
from svnet_tpu_torch.ops.kernels.binary_matmul import (
    pack_signs,
    xnor_popcount,
    xnor_popcount_matmul,
    xnor_popcount_plain,
)
from svnet_tpu_torch.utils import bench_binary_matmul


def _pm1(seed, *shape):
    rng = np.random.default_rng(seed)
    return np.where(rng.standard_normal(shape) >= 0, 1.0, -1.0).astype(np.float32)


def test_pack_signs_matches_jax():
    """Bit for bit, compared as uint32 (the top bit wraps the int32)."""
    x = _pm1(0, 8, 128)
    x[:, 31::32] = 1.0  # every word's top bit set: a negative int32
    got = pack_signs(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_pack(jnp.asarray(x)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    with pytest.raises(ValueError):
        pack_signs(torch.ones(2, 48))


@pytest.mark.parametrize("M,K,N", [(128, 64, 128), (256, 128, 64), (384, 96, 32)])
def test_xnor_plain_matches_jax(M, K, N):
    x, w = _pm1(M, M, K), _pm1(N, K, N)
    want = np.asarray(jax_xnor(jnp.asarray(x), jnp.asarray(w), interpret=True))
    before = xnor_popcount.launches
    got = xnor_popcount_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert xnor_popcount.launches == before  # the CPU runs no kernel
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), x @ w)


def _popc(x: torch.Tensor) -> torch.Tensor:
    """Bits set per int32 word."""
    return sum((x >> b) & 1 for b in range(32))


def xnor_by_and(xp: torch.Tensor, wp: torch.Tensor, K: int) -> torch.Tensor:
    """csrc/binary_matmul.cu's arithmetic in PyTorch: words zero-padded to
    the MMA depth of 8, agreements popc(x & w) + popc(~x & ~w) summed over
    every word (a padding word adds 32), out = 2 * c - (64 * Lp - 32 * L)."""
    M, L = xp.shape
    Lp = -(-L // 8) * 8
    xq = torch.cat([xp, xp.new_zeros(M, Lp - L)], 1)[:, None, :]
    wq = torch.cat([wp, wp.new_zeros(wp.shape[0], Lp - L)], 1)[None, :, :]
    c = (_popc(xq & wq) + _popc(~xq & ~wq)).sum(-1)
    return (2 * c - (64 * Lp - 32 * L)).to(torch.float32)


@pytest.mark.parametrize("M,K,N", [(130, 32, 9), (57, 224, 129), (17, 320, 50),
                                   (40, 1056, 31)])
def test_and_popcount_identity_matches_plain(M, K, N):
    """The kernel's identity K - 2 popc(x ^ w) = 2 (popc(x & w) + popc(~x &
    ~w)) - K, with its zero padding to 8 words, bitwise the plain version
    at word counts 1, 7, 10 and 33, sign words with bit 31 set."""
    x, w = _pm1(M + K, M, K), _pm1(N + K, K, N)
    x[:, 31::32] = 1.0
    w[31::32, :2] = 1.0
    xp = pack_signs(torch.from_numpy(x))
    wp = pack_signs(torch.from_numpy(w).T.contiguous())
    assert bool((xp < 0).any()) and bool((wp < 0).any())
    want = xnor_popcount_plain(xp, wp, K)
    assert torch.equal(xnor_by_and(xp, wp, K), want)
    np.testing.assert_array_equal(want.numpy(), x @ w)


def test_bench_main_on_cpu(capsys):
    """The bench at a ragged tiny shape: exact against the dense product,
    no times off the card, one JSON line."""
    res = bench_binary_matmul.cli(["40", "96", "13", "--device", "cpu"])
    assert res["exact_vs_dense"] and res["bitwise_vs_plain"]
    assert res["kernel_ms"] is None and res["int8_ms"] is None
    assert capsys.readouterr().out.count("\n") == 1
