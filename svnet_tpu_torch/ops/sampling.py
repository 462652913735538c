"""PointNet++ sampling and grouping (counterpart of
svnet_tpu/ops/sampling.py): plain PyTorch on the tensor's device, with
static shapes.
"""

from __future__ import annotations

import torch

from svnet_tpu_torch.ops.knn import pairwise_neg_sqdist


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """(B, N, C) x (B, M, C) -> (B, N, M) squared distances."""
    return -pairwise_neg_sqdist(src, dst)


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of each cloud: points (B, N, C), idx (B, ...) -> (B, ..., C)."""
    batch = torch.arange(points.shape[0], device=points.device)
    return points[batch.reshape((-1,) + (1,) * (idx.dim() - 1)), idx.long()]


def farthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Iterative farthest-point sampling, (B, N, 3) -> (B, npoint) int32:
    from point 0, each next point the farthest from those taken (the
    first index on ties, as ``jnp.argmax`` and ``torch.argmax``). Each
    squared distance is ``(dx*dx + dy*dy) + dz*dz``, one rounded operation
    at a time, so the card and the CPU pick the same points."""
    B, N, _ = xyz.shape
    dists = torch.full((B, N), float("inf"), dtype=xyz.dtype, device=xyz.device)
    out = torch.zeros((B, npoint), dtype=torch.int32, device=xyz.device)
    last = torch.zeros((B,), dtype=torch.long, device=xyz.device)
    batch = torch.arange(B, device=xyz.device)
    for i in range(1, npoint):
        diff = xyz - xyz[batch, last][:, None, :]
        sq = diff * diff
        d = sq[..., 0] + sq[..., 1] + sq[..., 2]
        dists = torch.minimum(dists, d)
        last = torch.argmax(dists, dim=-1)
        out[:, i] = last.to(torch.int32)
    return out


def query_ball_point(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor) -> torch.Tensor:
    """(B, S, nsample) ids of the points within ``radius`` of each centre,
    in index order; the slots past the last such point repeat the first."""
    N = xyz.shape[1]
    inside = square_distance(new_xyz, xyz) <= radius ** 2
    order = torch.where(inside, 0, N) + torch.arange(N, device=xyz.device)
    keys, idx = torch.sort(order, dim=-1)
    keys, idx = keys[..., :nsample], idx[..., :nsample]
    return torch.where(keys < N, idx, idx[..., :1]).to(torch.int32)


def sample_and_group(npoint: int, radius: float, nsample: int,
                     xyz: torch.Tensor, points: torch.Tensor | None,
                     return_fps: bool = False):
    """FPS centres, a ball query around each, the grouped coordinates
    relative to their centre (and the grouped features after them)."""
    fps_idx = farthest_point_sample(xyz, npoint)
    new_xyz = index_points(xyz, fps_idx)  # (B, S, 3)
    idx = query_ball_point(radius, nsample, xyz, new_xyz)
    grouped_xyz = index_points(xyz, idx)  # (B, S, nsample, 3)
    new_points = grouped_xyz - new_xyz[:, :, None, :]
    if points is not None:
        new_points = torch.cat([new_points, index_points(points, idx)], dim=-1)
    if return_fps:
        return new_xyz, new_points, grouped_xyz, fps_idx
    return new_xyz, new_points


def sample_and_group_all(xyz: torch.Tensor, points: torch.Tensor | None):
    """One group of every point around the origin."""
    new_xyz = torch.zeros((xyz.shape[0], 1, 3), dtype=xyz.dtype, device=xyz.device)
    new_points = xyz[:, None]
    if points is not None:
        new_points = torch.cat([new_points, points[:, None]], dim=-1)
    return new_xyz, new_points
