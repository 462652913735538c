"""Edge features and SV-pair pooling (counterpart of svnet_tpu/ops/graph.py).

Layouts are channels-last, as in the JAX package:
  scalars s: (B, N, [k,] S)    vectors v: (B, N, [k,] 3, V)    points: (B, N, 3)
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from svnet_tpu_torch.ops.kernels.edge_gather import edge_gather
from svnet_tpu_torch.ops.knn import knn, knn_plain

SVPair = Tuple[torch.Tensor, torch.Tensor]


def gather_neighbors(x: torch.Tensor, idx: torch.Tensor,
                     plain: bool = False) -> torch.Tensor:
    """x (B, N, ...), idx (B, N, k) -> (B, N, k, ...), differentiable in x.

    Every gather goes through ``ops.kernels.edge_gather`` (kernel B7,
    forward and scatter-add backward): on a CPU tensor its plain versions,
    on a CUDA tensor the kernel, on any other device an error.
    ``plain=True`` takes the plain versions on any device, as the kernels'
    plain versions and the ``oracle`` twins do."""
    B, N = x.shape[:2]
    out = edge_gather(x.reshape(B, N, -1), idx, plain)
    return out.reshape(idx.shape + x.shape[2:])


def _ids(x, k, idx, plain):
    """idx, or the kNN ids of x (which carry no gradient)."""
    if idx is not None:
        return idx
    return (knn_plain if plain else knn)(x.detach(), k)


def get_graph_feature(points: torch.Tensor, k: int,
                      idx: torch.Tensor | None = None,
                      plain: bool = False) -> torch.Tensor:
    """First-round edges ``[nbr - ctr, ctr]``: (B, N, 3) -> (B, N, k, 3, 2).
    ``plain`` runs the kNN and the gather's plain versions on any device."""
    idx = _ids(points, k, idx, plain)
    nbr = gather_neighbors(points, idx, plain)
    ctr = points[:, :, None, :].expand_as(nbr)
    return torch.stack([nbr - ctr, ctr], dim=-1)


def _cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a x b`` over the last axis (size 3), each component two rounded
    products and one subtraction, as kernel B1 computes it with ``cross``
    (``torch.linalg.cross`` may contract or reorder and differ by an ulp)."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def get_graph_feature_cross(points: torch.Tensor, k: int,
                            idx: torch.Tensor | None = None,
                            plain: bool = False) -> torch.Tensor:
    """First-round edges with a cross-product channel
    ``[nbr - ctr, ctr, nbr x ctr]``: (B, N, 3) -> (B, N, k, 3, 3)."""
    idx = _ids(points, k, idx, plain)
    nbr = gather_neighbors(points, idx, plain)
    ctr = points[:, :, None, :].expand_as(nbr)
    return torch.stack([nbr - ctr, ctr, _cross3(nbr, ctr)], dim=-1)


def vn_graph_feature(v: torch.Tensor, k: int, idx: torch.Tensor | None = None,
                     plain: bool = False) -> torch.Tensor:
    """Vector-neuron edges ``[nbr - ctr, ctr]`` over a vector field
    (B, N, 3, V) -> (B, N, k, 3, 2V), the kNN in the flattened 3V space."""
    B, N = v.shape[:2]
    idx = _ids(v.reshape(B, N, -1), k, idx, plain)
    nbr = gather_neighbors(v, idx, plain)
    ctr = v[:, :, None].expand_as(nbr)
    return torch.cat([nbr - ctr, ctr], dim=-1)


def scalar_graph_feature(x: torch.Tensor, k: int,
                         idx: torch.Tensor | None = None,
                         plain: bool = False) -> torch.Tensor:
    """DGCNN's scalar edges ``[nbr - ctr, ctr]``: (B, N, C) -> (B, N, k, 2C)."""
    idx = _ids(x, k, idx, plain)
    nbr = gather_neighbors(x, idx, plain)
    ctr = x[:, :, None].expand_as(nbr)
    return torch.cat([nbr - ctr, ctr], dim=-1)


def get_graph_feature_sv(x: SVPair, k: int, idx: torch.Tensor | None = None,
                         plain: bool = False) -> SVPair:
    """Edges over an (s, v) pair, kNN in the joint [s, flat(v)] space.

    Returns s_feat (B, N, k, 2S) = [nbr - ctr, ctr] and
    v_feat (B, N, k, 3, 2V) = [nbr - ctr, ctr].
    """
    s, v = x
    B, N, S = s.shape
    V = v.shape[-1]
    joint = torch.cat([s, v.reshape(B, N, -1)], dim=-1)
    idx = _ids(joint, k, idx, plain)
    nbr = gather_neighbors(joint, idx, plain)  # (B, N, k, S + 3V)
    ctr = joint[:, :, None, :].expand_as(nbr)
    s_feat = torch.cat([nbr[..., :S] - ctr[..., :S], ctr[..., :S]], dim=-1)
    kk = idx.shape[-1]
    v_nbr = nbr[..., S:].reshape(B, N, kk, 3, V)
    v_ctr = ctr[..., S:].reshape(B, N, kk, 3, V)
    return s_feat, torch.cat([v_nbr - v_ctr, v_ctr], dim=-1)


def svpool(x: SVPair, dim: int = 2, keepdim: bool = False,
           spool: str = "max") -> SVPair:
    """Scalar max (or mean, ``spool="mean"``) and vector mean over ``dim``
    (the k axis by default; ``dim=1`` pools over the points)."""
    s, v = x
    if spool == "max":
        s = torch.amax(s, dim=dim, keepdim=keepdim)
    elif spool == "mean":
        s = torch.mean(s, dim=dim, keepdim=keepdim)
    else:
        raise ValueError(f"unrecognized scalar pooling {spool!r}")
    return s, torch.mean(v, dim=dim, keepdim=keepdim)


def svexpand(x: SVPair, like: SVPair) -> SVPair:
    """An SV pair with size-1 axes (a pooled token) broadcast to like's."""
    return tuple(t.expand_as(r) for t, r in zip(x, like))


def svcat(xlist: Sequence[SVPair]) -> SVPair:
    """Channel-concat SV pairs."""
    return (torch.cat([x[0] for x in xlist], dim=-1),
            torch.cat([x[1] for x in xlist], dim=-1))
