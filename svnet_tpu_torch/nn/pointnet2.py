"""PointNet++ set abstraction and feature propagation (counterpart of
svnet_tpu/nn/pointnet2.py), functions of their flax-named weights
(``nn/scope.py``), channels last, on the sampling of ``ops/sampling.py``.
Each MLP layer is ``<name>_conv<i>`` (a full-precision linear with bias)
and ``<name>_bn<i>`` (flax BatchNorm) and a ReLU. No model of the zoo uses
them; no kernel lies on them (FPS, the ball query and the 3-NN are plain
PyTorch, as they are XLA in the JAX package).
"""

from __future__ import annotations

from typing import Sequence

import torch

from svnet_tpu_torch.nn.scope import Scope, batch_norm, linear
from svnet_tpu_torch.ops.sampling import (
    farthest_point_sample,
    index_points,
    query_ball_point,
    sample_and_group,
    sample_and_group_all,
    square_distance,
)


def mlp_stack(s: Scope, x: torch.Tensor, widths: Sequence[int],
              name: str) -> torch.Tensor:
    for i, w in enumerate(widths):
        x = linear(s.child(f"{name}_conv{i}"), x, w)
        x = torch.relu(batch_norm(s, x, name=f"{name}_bn{i}"))
    return x


def set_abstraction(s: Scope, xyz: torch.Tensor, points: torch.Tensor | None,
                    npoint: int, radius: float, nsample: int, mlp: Sequence[int],
                    group_all: bool = False):
    """PointNetSetAbstraction: xyz (B, N, 3), points (B, N, D) or None ->
    (new_xyz (B, S, 3), features (B, S, mlp[-1])): FPS centres, a ball
    query of ``nsample`` around each (relative xyz, then the features),
    the MLP and the max over each group; ``group_all``: one group of every
    point around the origin."""
    if group_all:
        new_xyz, grouped = sample_and_group_all(xyz, points)
    else:
        new_xyz, grouped = sample_and_group(npoint, radius, nsample, xyz, points)
    return new_xyz, torch.amax(mlp_stack(s, grouped, mlp, "mlp"), dim=2)


def set_abstraction_msg(s: Scope, xyz: torch.Tensor, points: torch.Tensor | None,
                        npoint: int, radius_list: Sequence[float],
                        nsample_list: Sequence[int],
                        mlp_list: Sequence[Sequence[int]]):
    """PointNetSetAbstractionMsg: one FPS, then a ball query, MLP
    (``branch<i>``) and max per radius, concatenated. A branch's groups
    are the features first, then the relative xyz (the reverse of
    ``sample_and_group``'s order)."""
    new_xyz = index_points(xyz, farthest_point_sample(xyz, npoint))
    outs = []
    for i, radius in enumerate(radius_list):
        idx = query_ball_point(radius, nsample_list[i], xyz, new_xyz)
        grouped = index_points(xyz, idx) - new_xyz[:, :, None, :]
        if points is not None:
            grouped = torch.cat([index_points(points, idx), grouped], dim=-1)
        grouped = mlp_stack(s, grouped, mlp_list[i], f"branch{i}")
        outs.append(torch.amax(grouped, dim=2))
    return new_xyz, torch.cat(outs, dim=-1)


def three_nn(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """(squared distances (B, N, 3), ids (B, N, 3)) of each dense point's
    3 nearest sparse points, nearest first; a tie goes to the lower id,
    as ``jax.lax.top_k`` gives it (a stable sort)."""
    d, idx = torch.sort(square_distance(xyz1, xyz2), dim=-1, stable=True)
    return d[..., :3], idx[..., :3]


def feature_propagation(s: Scope, xyz1: torch.Tensor, xyz2: torch.Tensor,
                        points1: torch.Tensor | None, points2: torch.Tensor,
                        mlp: Sequence[int]) -> torch.Tensor:
    """PointNetFeaturePropagation: points2 (B, S, D2) at xyz2 carried to
    xyz1 (B, N, 3) by the inverse-distance weights 1 / (d + 1e-8) of the
    3 nearest (S == 1: broadcast), beside points1 (B, N, D1) if given,
    then the MLP."""
    B, n = xyz1.shape[:2]
    if xyz2.shape[1] == 1:
        interpolated = points2.expand(B, n, points2.shape[-1])
    else:
        d3, idx = three_nn(xyz1, xyz2)
        recip = 1.0 / (d3 + 1e-8)
        weight = recip / torch.sum(recip, dim=2, keepdim=True)
        interpolated = torch.sum(index_points(points2, idx) * weight[..., None],
                                 dim=2)
    x = interpolated if points1 is None else torch.cat([points1, interpolated],
                                                        dim=-1)
    return mlp_stack(s, x, mlp, "mlp")
