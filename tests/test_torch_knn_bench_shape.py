"""C8: how far the port's exact kNN ranking (``knn_plain``, which kernel
B4 matches bitwise on the card) stands from the JAX package's at the
bench shape: seeded normal features (2, 1024, C), k=20, at the widths of
the training path (C = 3, 62, 127), against ``knn_pallas`` in interpret
mode and against ``svnet_tpu.ops.knn.knn`` (CPU).

Bars: each centre's neighbour set is identical; at most 1 in 1,000 of the
(centre, rank) ids differ, and every difference is two adjacent ranks
swapped. The reason: the port sums each distance channel by channel with
every product and sum rounded on its own (so that self-distances are
exactly 0 and the card's kernels agree with it bitwise), while JAX sums
it in its own matmul order; two candidates whose distances lie within a
rounding step of each other can then change places, and only with their
neighbouring rank. A set that differs would change what a round pools
over; a swap changes only the order of the mean's sum.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnet_tpu.ops.knn import knn as jax_knn
from svnet_tpu.ops.pallas.knn import knn_pallas
from svnet_tpu_torch.ops.knn import knn_plain

K = 20
MAX_SHARE = 1e-3


def _adjacent_swaps_only(got: np.ndarray, want: np.ndarray) -> bool:
    """Every rank where got and want differ is one of two adjacent ranks
    whose ids are swapped."""
    for b, n, r in zip(*np.nonzero(got != want)):
        g, w = got[b, n], want[b, n]
        lo = r - 1 if r > 0 and g[r] == w[r - 1] and g[r - 1] == w[r] else r
        if lo + 1 >= len(g) or not (g[lo] == w[lo + 1] and g[lo + 1] == w[lo]):
            return False
    return True


@pytest.mark.parametrize("C", [3, 62, 127])
def test_knn_plain_at_bench_shape(C):
    x = np.random.default_rng(C).standard_normal((2, 1024, C)).astype(np.float32)
    got = knn_plain(torch.from_numpy(x), K).numpy()
    for name, want in (
        ("knn_pallas", knn_pallas(jnp.asarray(x), K, tile=128, interpret=True)),
        ("ops.knn", jax_knn(jnp.asarray(x), K)),
    ):
        want = np.asarray(want)
        assert want.shape == got.shape == (2, 1024, K), name
        np.testing.assert_array_equal(np.sort(got, -1), np.sort(want, -1),
                                      err_msg=f"{name}: neighbour sets differ")
        differ = int((got != want).sum())
        assert differ <= MAX_SHARE * got.size, (name, differ)
        assert _adjacent_swaps_only(got, want), name
