"""B7's backward kernel design (csrc/edge_gather.cu), emulated on the CPU.

The kernel builds each cloud's inverse adjacency in blocks that each own a
range of targets (``edge_gather.adjacency_plan`` picks how many ranges and
how many edge ids a block ranks in shared memory at once): every block
counts the cloud's edges below its range and into each of its targets,
scans the counts, fills windows of whole segments (at most ``cap`` ids,
or one longer segment in device memory) in whatever order its atomics
give, and writes each id at its rank within its segment. The emulation
below follows that schedule, the fill in a shuffled order, and sums each
target's rows in the list's order: bitwise ``edge_gather_bwd_plain``,
with the windows and the spill taken where the forced ids intend. No JAX
runs here.
"""

import numpy as np
import pytest
import torch

from svnet_tpu_torch.ops.kernels import edge_gather as eg

SMEM_LIMIT = 48 * 1024  # the launcher's bound on a block's shared memory


def _adjacency(idx: np.ndarray, n_src: int, ranges: int, cap: int, seed: int):
    """eg_adj_kernel on ids (B, M, k): (beg (B, n_src), deg (B, n_src), list
    (B, M k), windows, spilled windows)."""
    B = idx.shape[0]
    ids = idx.reshape(B, -1).astype(np.int64)
    ek = ids.shape[1]
    beg = np.zeros((B, n_src), np.int64)
    deg = np.zeros((B, n_src), np.int64)
    out = np.full((B, ek), -1, np.int64)
    rng = np.random.default_rng(seed)
    windows = spilled = 0
    for b in range(B):
        m_all = ids[b]
        for r in range(ranges):
            m0, m1 = r * n_src // ranges, (r + 1) * n_src // ranges
            nt = m1 - m0
            before = int(((m_all >= 0) & (m_all < m0)).sum())
            inr = (m_all >= m0) & (m_all < m1)
            cnt = np.bincount(m_all[inr] - m0, minlength=nt)
            loc = np.concatenate([[0], np.cumsum(cnt)])
            beg[b, m0:m1], deg[b, m0:m1] = before + loc[:-1], cnt
            w0 = 0
            while w0 < nt:
                w1, hi = w0 + 1, nt
                while w1 < hi:
                    mid = (w1 + hi + 1) >> 1
                    if loc[mid] - loc[w0] <= cap:
                        w1 = mid
                    else:
                        hi = mid - 1
                p0, np_ = loc[w0], loc[w1] - loc[w0]
                windows += 1
                spilled += int(np_ > cap)
                edges = np.nonzero((m_all - m0 >= w0) & (m_all - m0 < w1))[0]
                edges = edges[rng.permutation(len(edges))]  # the atomics' order
                m = m_all[edges] - m0
                order = np.argsort(m, kind="stable")
                seg = np.empty(np_, np.int64)
                seg[np.arange(np_)] = -1
                pos = np.empty(len(edges), np.int64)
                pos[order] = loc[m[order]] - p0 + (np.arange(len(edges))
                                                   - (loc[m[order]] - p0))
                seg[pos] = edges
                mq = m_all[seg] - m0  # each element's segment
                rank = np.empty(np_, np.int64)
                by = np.lexsort((seg, mq))  # ascending id within each segment
                rank[by] = np.arange(np_) - (loc[mq[by]] - p0)
                out[b, before + loc[mq] + rank] = seg
                w0 = w1
    return beg, deg, out, windows, spilled


def _sum(g: torch.Tensor, beg, deg, lst, n_src: int) -> torch.Tensor:
    """eg_sum_kernel: each target's rows in its segment's order, from 0."""
    B, M, k, C = g.shape
    rows = g.reshape(B, M * k, C)
    acc = torch.zeros(B, n_src, C)
    deg = torch.from_numpy(deg)
    beg = torch.from_numpy(beg)
    lst = torch.from_numpy(lst)
    bidx = torch.arange(B)[:, None].expand(B, n_src)
    for r in range(int(deg.max()) if deg.numel() else 0):
        on = deg > r
        e = torch.gather(lst, 1, torch.where(on, beg + r, 0))
        add = rows[bidx, torch.where(on, e, 0)]
        acc = torch.where(on[..., None], acc + add, acc)
    return acc


# (B, M, k, n_src, ids, windows > the ranges, spill): kNN-like ids; a hub
# every centre names; every id on 64 targets (one range, several windows);
# every id one target (a segment above cap: the spill); ids outside
# [0, n_src); n_src = 2 M
ADJ_CASES = [(3, 256, 8, 256, None), (2, 256, 20, 256, "hub"),
             (1, 512, 40, 512, "narrow"), (1, 150, 20, 150, "one"),
             (2, 300, 7, 300, "out"), (3, 200, 9, 400, None)]


@pytest.mark.parametrize("case", ADJ_CASES,
                         ids=[f"B{c[0]}-M{c[1]}-k{c[2]}-n{c[3]}" + (f"-{c[4]}" if c[4] else "")
                              for c in ADJ_CASES])
def test_adjacency_sum_matches_plain(case):
    """The emulated adjacency lists every target's edges in ascending
    order, and the sum over it is bitwise ``edge_gather_bwd_plain``'s
    (out-of-range ids sent to target 0 with +0.0 rows there); the plan's
    cap (shrunk to 2048 ids so that small clouds reach it) takes several
    windows on the narrow ids and the spill on one target."""
    B, M, k, n_src, kind = case
    rng = np.random.default_rng(M + k)
    idx = rng.integers(0, n_src, size=(B, M, k)).astype(np.int32)
    if kind == "hub":
        idx[:, :, 0] = 7
    elif kind == "narrow":
        idx = rng.integers(0, 64, size=(B, M, k)).astype(np.int32)
    elif kind == "one":
        idx[:] = 5
    elif kind == "out":
        idx[:, ::3, 1] = n_src
        idx[:, 1::5, 2] = -1
        idx[0, 0, 0] = -(2 ** 31)
    ranges, cap = eg.adjacency_plan(B, n_src, M * k)
    cap = min(cap, 2048)
    beg, deg, lst, windows, spilled = _adjacency(idx, n_src, ranges, cap, seed=k)
    valid = (idx >= 0) & (idx < n_src)
    flat = idx.reshape(B, -1).astype(np.int64)
    for b in range(B):
        e = np.nonzero(valid[b].reshape(-1))[0]
        want = e[np.lexsort((e, flat[b, e]))]
        np.testing.assert_array_equal(lst[b, :len(e)], want)
    if kind is None or kind in ("out",):
        assert windows == B * ranges
    if kind == "narrow":
        assert windows >= B * ranges + 5
    assert spilled == (kind == "one")
    g = torch.from_numpy(rng.normal(size=(B, M, k, 5)).astype(np.float32))
    bad = torch.from_numpy(~valid)
    want = eg.edge_gather_bwd_plain(torch.where(bad[..., None], torch.zeros_like(g), g),
                                    torch.from_numpy(np.where(valid, idx, 0)), n_src)
    assert torch.equal(_sum(g, beg, deg, lst, n_src), want)


@pytest.mark.parametrize("B,n_src,ek", [(32, 1024, 20480), (32, 2048, 81920),
                                        (8, 1000, 7000), (1, 1, 5), (2, 100, 800),
                                        (300, 50000, 10), (1, 200000, 4000000)])
def test_adjacency_plan_fits(B, n_src, ek):
    """The plan fills the card (about ADJ_BLOCKS blocks where the clouds'
    targets allow), keeps 1 <= ranges <= n_src, and its shared memory
    (the range's scan, cursors and cap ids, beside the 32 warp sums)
    stays within the launcher's bound of 48 KB, so it needs no larger
    allowance."""
    ranges, cap = eg.adjacency_plan(B, n_src, ek)
    assert 1 <= ranges <= n_src and 1 <= cap <= max(ek, 1)
    nt = -(-n_src // ranges)
    assert 4 * (2 * nt + 1 + cap + 32) <= SMEM_LIMIT
    if n_src >= 128 * -(-eg.ADJ_BLOCKS // B):
        assert B * ranges >= eg.ADJ_BLOCKS
