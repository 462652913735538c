"""Deformed-sphere surface clouds (counterpart of
svnet_tpu/utils/synth.py::surface_clouds): unit-sphere samples pushed by
three random Gaussian bump fields, clustered like real surfaces. The same
seed gives the same clouds as the JAX package's generator."""

from __future__ import annotations

import numpy as np


def surface_clouds(seed: int, B: int, N: int) -> np.ndarray:
    """(B, N, 3) float32 deformed-sphere surface clouds."""
    rng = np.random.default_rng(seed)
    clouds = []
    for _ in range(B):
        p = rng.normal(size=(N, 3))
        p /= np.linalg.norm(p, axis=1, keepdims=True)
        for _ in range(3):
            c = rng.normal(size=3)
            c /= np.linalg.norm(c)
            p += 0.15 * np.exp(-np.sum((p - c) ** 2, 1) / 0.3)[:, None] * (p - c)
        clouds.append(p.astype(np.float32))
    return np.stack(clouds)
