"""Random rotations and the rotation augmentation (counterpart of
svnet_tpu/ops/rotations.py). Random numbers come from an explicit CPU
``torch.Generator``; the rotations move to the points' device."""

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


def random_z_rotations(n: int, generator: torch.Generator,
                       dtype=torch.float32) -> torch.Tensor:
    """(n, 3, 3) rotations about the z axis by a uniform angle."""
    theta = torch.rand(n, generator=generator, dtype=dtype) * (2.0 * torch.pi)
    c, s = torch.cos(theta), torch.sin(theta)
    zeros, ones = torch.zeros_like(c), torch.ones_like(c)
    m = torch.stack([c, -s, zeros, s, c, zeros, zeros, zeros, ones], dim=-1)
    return m.reshape(n, 3, 3)


def apply_rotation_aug(points: torch.Tensor, mode: str,
                       generator: torch.Generator) -> torch.Tensor:
    """Rotation augmentation of (B, N, 3) points: 'aligned' (none), 'z' or
    'so3', one random rotation per cloud."""
    if mode == "aligned":
        return points
    B = points.shape[0]
    if mode == "z":
        rot = random_z_rotations(B, generator)
    elif mode == "so3":
        rot = random_rotations(B, generator)
    else:
        raise ValueError(f"unrecognized rotation mode {mode!r}")
    return rotate_points(points, rot.to(points.device))
