"""Random SO(3) rotations (counterpart of svnet_tpu/ops/rotations.py)."""

from __future__ import annotations

import torch


def random_rotations(n: int, generator: torch.Generator,
                     dtype=torch.float32) -> torch.Tensor:
    """(n, 3, 3) rotations, uniform on SO(3): QR of a Gaussian matrix with
    the sign fix that makes the distribution Haar, then det forced to +1."""
    a = torch.randn(n, 3, 3, generator=generator, dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[:, None, :]
    det = torch.linalg.det(q)
    q[:, :, 0] = q[:, :, 0] * det[:, None]
    return q.to(dtype)


def rotate_points(points: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """points (B, N, 3) @ rot (B, 3, 3): the row-vector convention of
    svnet_tpu/ops/rotations.py:65."""
    return torch.bmm(points, rot.to(points.dtype))
