"""Classification datasets (counterpart of svnet_tpu/data/datasets.py):
indexable objects over in-memory numpy arrays, items ``(points (n, 3)
float32, label int)``. Batching, and the move to the device, is the
Loader's.

``ModelNet40`` reads the standard HDF5 packaging
(``<data_dir>/modelnet40*hdf5_2048/*{partition}*.h5``) and applies the
train-time augmentation; ``h5py`` is imported only when a file is read.
``ArrayDataset`` serves clouds already in memory (synthetic or loaded by
the caller) with the same item contract.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from svnet_tpu_torch.data.augment import translate_pointcloud


def load_data_cls(data_dir: str, partition: str):
    """Concatenate the ModelNet40 HDF5 files of one partition."""
    try:
        import h5py
    except ImportError as e:
        raise RuntimeError(
            "reading ModelNet40's HDF5 files needs h5py, which is not "
            "installed; use ArrayDataset for clouds already in memory") from e
    pattern = os.path.join(data_dir, "modelnet40*hdf5_2048", f"*{partition}*.h5")
    data, label = [], []
    for name in sorted(glob.glob(pattern)):
        with h5py.File(name, "r") as f:
            data.append(f["data"][:].astype("float32"))
            label.append(f["label"][:].astype("int64"))
    if not data:
        raise FileNotFoundError(f"no ModelNet40 h5 files match {pattern}")
    return np.concatenate(data), np.concatenate(label)


class ArrayDataset:
    """Clouds (M, n, 3) and labels (M,) in memory; ``train=True`` applies
    the train-time augmentation (translate, then shuffle the points)."""

    def __init__(self, points: np.ndarray, labels: np.ndarray,
                 num_points: int | None = None, train: bool = False,
                 seed: int = 0):
        self.data = np.asarray(points, dtype=np.float32)
        self.label = np.asarray(labels).reshape(-1)
        self.num_points = num_points or self.data.shape[1]
        self.train = train
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return self.data.shape[0]

    def __getitem__(self, item):
        pointcloud = self.data[item][: self.num_points]
        if self.train:
            pointcloud = translate_pointcloud(pointcloud, self.rng)
            pointcloud = pointcloud[self.rng.permutation(pointcloud.shape[0])]
        return pointcloud, int(self.label[item])


class ModelNet40(ArrayDataset):
    num_classes = 40

    def __init__(self, num_points: int, data_dir: str,
                 partition: str = "train", seed: int = 0):
        data, label = load_data_cls(data_dir, partition)
        super().__init__(data, label, num_points, partition == "train", seed)
        self.partition = partition
