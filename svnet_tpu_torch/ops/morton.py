"""The Morton entry sort (counterpart of
svnet_tpu/ops/pallas/sv_round3.py::morton_order and svnet_tpu/infer.py:56-77).

Plain tensor code on any device: the JAX package computes it in XLA,
outside any kernel. Its result is an order of the input points, so it
must be the JAX package's exactly: the same f32 quantization, the same
bit interleave and a stable sort (``jnp.argsort`` is stable: points with
equal codes keep their input order).
"""

from __future__ import annotations

import torch


# bit b of a 10-bit value to bit 3b, in four shift-and-mask steps
_SPREAD = ((16, 0x030000FF), (8, 0x0300F00F), (4, 0x030C30C3), (2, 0x09249249))


def morton_order(points: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) -> (B, N) int64 permutation sorting each cloud by the
    30-bit Morton code of its points: each coordinate quantized to 10 bits
    over the cloud's bounding box, ``(p - lo) / max(hi - lo, 1e-9) *
    1023`` in f32, truncated; bit b of coordinate c goes to bit 3b + c of
    the code (the JAX loop over bits, as a few whole-tensor passes)."""
    lo = points.amin(dim=1, keepdim=True)
    hi = points.amax(dim=1, keepdim=True)
    q = ((points - lo) / torch.clamp(hi - lo, min=1e-9) * 1023).to(torch.int64)
    for shift, mask in _SPREAD:
        q = (q | (q << shift)) & mask
    code = q[..., 0] | (q[..., 1] << 1) | (q[..., 2] << 2)
    return torch.argsort(code, dim=1, stable=True)


def sort_points(points: torch.Tensor):
    """(B, N, 3) -> (the points in Morton order, the order (B, N))."""
    order = morton_order(points)
    return torch.take_along_dim(points, order[:, :, None], dim=1), order


def unsort(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Per-point outputs (B, N, ...) of sorted points back in the input's
    order: ``x[b, argsort(order)[b, n]]``, as the JAX partseg engine takes
    them (svnet_tpu/infer.py:768-770)."""
    rows = torch.arange(order.shape[1], device=order.device).expand_as(order)
    inv = torch.empty_like(order).scatter_(1, order, rows)  # argsort(order)
    return torch.take_along_dim(x, inv.reshape(inv.shape + (1,) * (x.dim() - 2)),
                                dim=1)
