"""Per-cloud host augmentation (counterpart of
svnet_tpu/data/augment.py::translate_pointcloud). Rotation augmentation
runs batched on the device inside the train step."""

from __future__ import annotations

import numpy as np


def translate_pointcloud(pointcloud: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Anisotropic scale U(2/3, 3/2) and shift U(-0.2, 0.2) per axis."""
    xyz1 = rng.uniform(low=2.0 / 3.0, high=3.0 / 2.0, size=(3,))
    xyz2 = rng.uniform(low=-0.2, high=0.2, size=(3,))
    return (pointcloud * xyz1 + xyz2).astype("float32")
