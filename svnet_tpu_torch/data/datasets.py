"""Classification and part-segmentation datasets (counterpart of
svnet_tpu/data/datasets.py): indexable objects over in-memory numpy
arrays, items ``(points (n, 3) float32, label int)`` or, for part
segmentation, ``(points, category int, seg (n,) int64)``. Batching, and
the move to the device, is the Loader's.

``ModelNet40`` and ``ShapeNetPart`` read the standard HDF5 packagings
(``<data_dir>/modelnet40*hdf5_2048/*{partition}*.h5``,
``<data_dir>/shapenet*hdf5*/*{partition}*.h5``); ``h5py`` is imported
only when a file is read. ``ArrayDataset`` and ``PartArrayDataset`` serve
clouds already in memory (synthetic or loaded by the caller) with the
same item contracts.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from svnet_tpu_torch.data.augment import translate_pointcloud
from svnet_tpu_torch.train.metrics import INDEX_START, SEG_NUM


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise RuntimeError(
            "reading the HDF5 datasets needs h5py, which is not installed; "
            "use ArrayDataset or PartArrayDataset for clouds already in "
            "memory") from e
    return h5py


def load_data_cls(data_dir: str, partition: str):
    """Concatenate the ModelNet40 HDF5 files of one partition."""
    h5py = _h5py()
    pattern = os.path.join(data_dir, "modelnet40*hdf5_2048", f"*{partition}*.h5")
    data, label = [], []
    for name in sorted(glob.glob(pattern)):
        with h5py.File(name, "r") as f:
            data.append(f["data"][:].astype("float32"))
            label.append(f["label"][:].astype("int64"))
    if not data:
        raise FileNotFoundError(f"no ModelNet40 h5 files match {pattern}")
    return np.concatenate(data), np.concatenate(label)


def load_data_partseg(data_dir: str, partition: str):
    """Concatenate the ShapeNetPart HDF5 files (data, label, pid) of one
    partition; "trainval" is the train files, then the val files."""
    h5py = _h5py()
    root = os.path.join(data_dir, "shapenet*hdf5*")
    parts = ("train", "val") if partition == "trainval" else (partition,)
    files = [f for part in parts
             for f in sorted(glob.glob(os.path.join(root, f"*{part}*.h5")))]
    if not files:
        raise FileNotFoundError(f"no ShapeNetPart h5 files in {data_dir}")
    data, label, seg = [], [], []
    for name in files:
        with h5py.File(name, "r") as f:
            data.append(f["data"][:].astype("float32"))
            label.append(f["label"][:].astype("int64"))
            seg.append(f["pid"][:].astype("int64"))
    return np.concatenate(data), np.concatenate(label), np.concatenate(seg)


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


class PartArrayDataset:
    """Clouds (M, n, 3), categories (M,) and per-point part ids (M, n) in
    memory, items ``(points, category, seg)``; ``shuffle=True`` permutes
    each item's points and part ids together (ShapeNetPart's "trainval"
    augmentation)."""

    def __init__(self, points: np.ndarray, labels: np.ndarray, seg: np.ndarray,
                 num_points: int | None = None, shuffle: bool = False,
                 seed: int = 0):
        self.data = np.asarray(points, dtype=np.float32)
        self.label = np.asarray(labels).reshape(-1)
        self.seg = np.asarray(seg, dtype=np.int64)
        self.num_points = num_points or self.data.shape[1]
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return self.data.shape[0]

    def __getitem__(self, item):
        pointcloud = self.data[item][: self.num_points]
        seg = self.seg[item][: self.num_points]
        if self.shuffle:
            idx = self.rng.permutation(pointcloud.shape[0])
            pointcloud, seg = pointcloud[idx], seg[idx]
        return pointcloud, int(self.label[item]), seg


class ShapeNetPart(PartArrayDataset):
    """ShapeNetPart's HDF5 files; ``class_choice`` keeps one category."""

    num_classes = 16
    num_parts = 50
    cat2id = {
        "airplane": 0, "bag": 1, "cap": 2, "car": 3, "chair": 4,
        "earphone": 5, "guitar": 6, "knife": 7, "lamp": 8, "laptop": 9,
        "motor": 10, "mug": 11, "pistol": 12, "rocket": 13,
        "skateboard": 14, "table": 15,
    }

    def __init__(self, num_points: int, data_dir: str,
                 partition: str = "train", class_choice: str | None = None,
                 seed: int = 0):
        data, label, seg = load_data_partseg(data_dir, partition)
        label = label.reshape(-1)
        if class_choice is not None:
            cid = self.cat2id[class_choice]
            keep = label == cid
            data, label, seg = data[keep], label[keep], seg[keep]
            self.seg_num_all = SEG_NUM[cid]
            self.seg_start_index = INDEX_START[cid]
        else:
            self.seg_num_all, self.seg_start_index = 50, 0
        super().__init__(data, label, seg, num_points,
                         shuffle=partition == "trainval", seed=seed)
        self.partition = partition
        self.class_choice = class_choice
