"""Deformed-sphere surface clouds (counterpart of
svnet_tpu/utils/synth.py::surface_clouds): unit-sphere samples pushed by
three random Gaussian bump fields, clustered like real surfaces. The same
seed gives the same clouds as the JAX package's generator. Strand clouds
(``strand_clouds``): elongated inputs on which the candidate window
certifies at small N. Shape clouds (``shape_clouds``): the three classes
of the JAX package's learning test (tests/test_learning.py), told apart
by shape alone. Band rooms (``band_rooms``): S3DIS-shaped rooms of 9
channels whose 13 labels are height bands."""

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


def strand_clouds(seed: int, B: int, N: int, C: int = 3,
                  length: float = 4.0) -> np.ndarray:
    """(B, N, C) float32 clouds strung along a strand ``length`` long on
    the first axis, centred on 0: the points in order along it (already
    Morton-coherent), 0.02 of Gaussian jitter about it, channels past the
    third smooth functions (amplitude 0.5) of the position along it. Each
    point's neighbours lie in its own stretch of the strand, so the
    candidate window (ops/window.py) certifies on them where it does not
    on a compact surface of the same N."""
    rng = np.random.default_rng(seed)
    u = np.sort(rng.uniform(0.0, 1.0, size=(B, N)), axis=1)
    x = rng.normal(scale=0.02, size=(B, N, C))
    x[..., 0] += length * (u - 0.5)
    if C > 3:
        x[..., 3:] += 0.5 * np.sin(u[..., None] * np.arange(1, C - 2))
    return x.astype(np.float32)


def shape_clouds(rng: np.random.Generator, n_per_class: int, N: int):
    """(3 n_per_class, N, 3) float32 clouds and int64 labels, cycling a
    sphere's surface (0), a cube's surface (1) and a thin disk (2), drawn
    from ``rng`` in the order of tests/test_learning.py::_clouds."""
    clouds, labels = [], []
    for _ in range(n_per_class):
        v = rng.standard_normal((N, 3))
        clouds.append(v / np.linalg.norm(v, axis=1, keepdims=True))
        u = rng.uniform(-1, 1, (N, 3))
        ax = rng.integers(0, 3, N)
        u[np.arange(N), ax] = rng.choice([-1.0, 1.0], N)
        clouds.append(u)
        clouds.append(rng.standard_normal((N, 3)) * np.array([1.0, 1.0, 0.02]))
        labels += [0, 1, 2]
    return np.stack(clouds).astype(np.float32), np.asarray(labels, dtype=np.int64)


def band_rooms(seed: int, M: int, N: int):
    """(M, N, 9) float32 rooms in S3DIS's channel layout (xyz in a 4 x 4
    x 3 box, rgb in [0, 1], xyz over the box's size) and (M, N) int64
    labels: 13 bands of equal height, 0 at the floor."""
    rng = np.random.default_rng(seed)
    box = np.array([4.0, 4.0, 3.0])
    xyz = rng.uniform(0.0, 1.0, (M, N, 3)) * box
    rgb = rng.uniform(0.0, 1.0, (M, N, 3))
    rooms = np.concatenate([xyz, rgb, xyz / box], axis=-1).astype(np.float32)
    labels = np.minimum((xyz[..., 2] / box[2] * 13).astype(np.int64), 12)
    return rooms, labels
