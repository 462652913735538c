"""Classification, part- and semantic-segmentation datasets (counterpart
of svnet_tpu/data/datasets.py): indexable objects over in-memory numpy
arrays, items ``(points (n, 3) float32, label int)``, for part
segmentation ``(points, category int, seg (n,) int64)``, for semantic
segmentation ``(points (n, 9), seg (n,) int64)``. Batching, and the move
to the device, is the Loader's.

``ModelNet40``, ``ShapeNetPart`` and ``ScanObjectNNCls`` read the
standard HDF5 packagings (``<data_dir>/modelnet40*hdf5_2048/*{partition}*.h5``,
``<data_dir>/shapenet*hdf5*/*{partition}*.h5``,
``<data_dir>/h5_files/main_split/<subset file>``), and ``S3DIS`` its
rooms (``<data_dir>/indoor3d_sem_seg_hdf5_data``); ``h5py`` is imported
only when a file is read. ``ArrayDataset``, ``ScanArrayDataset``,
``PartArrayDataset`` and ``RoomArrayDataset`` serve clouds already in
memory (synthetic or loaded by the caller) with the same item contracts.
``ModelNet40_v2`` reads the raw-text packaging, optionally sampled by
farthest-point sampling on a device.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from svnet_tpu_torch import config
from svnet_tpu_torch.data.augment import translate_pointcloud
from svnet_tpu_torch.ops.sampling import farthest_point_sample
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


def pc_normalize(pc: np.ndarray) -> np.ndarray:
    """Centred on the centroid, scaled into the unit sphere."""
    pc = pc - pc.mean(axis=0)
    return pc / np.max(np.sqrt((pc ** 2).sum(axis=1)))


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


# ScanObjectNN's main split: (partition, subset) -> file
SCANOBJECTNN_FILES = {
    ("train", "easy"): "training_objectdataset.h5",
    ("train", "hard"): "training_objectdataset_augmentedrot_scale75.h5",
    ("test", "easy"): "test_objectdataset.h5",
    ("test", "hard"): "test_objectdataset_augmentedrot_scale75.h5",
}


def load_data_scanobjectnn(data_dir: str, partition: str, subset: str):
    """ScanObjectNN's clouds (M, 2048, 3) and labels of one partition and
    subset ('easy': the object dataset; 'hard': augmentedrot_scale75)."""
    try:
        name = SCANOBJECTNN_FILES[(partition, subset)]
    except KeyError:
        raise ValueError(f"unrecognized partition/subset {partition!r}/"
                         f"{subset!r}") from None
    with _h5py().File(os.path.join(data_dir, "h5_files", "main_split", name),
                      "r") as f:
        return (np.array(f["data"]).astype("float32"),
                np.array(f["label"]).astype("int64"))


class ScanArrayDataset:
    """Clouds (M, n, 3) and labels (M,) in memory, ScanObjectNN's item
    draw: a fresh permutation of each cloud's points, its first
    ``num_points`` taken, then (train) the translation. The draws come
    from one numpy generator in this order, as the JAX package's do."""

    num_classes = 15

    def __init__(self, points: np.ndarray, labels: np.ndarray,
                 num_points: int, train: bool = False, seed: int = 0):
        self.points = np.asarray(points, dtype=np.float32)
        self.labels = np.asarray(labels).reshape(-1)
        self.num_points = num_points
        self.train = train
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return self.points.shape[0]

    def __getitem__(self, idx):
        pt_idxs = self.rng.permutation(self.points.shape[1])[: self.num_points]
        pointcloud = self.points[idx, pt_idxs].copy()
        if self.train:
            pointcloud = translate_pointcloud(pointcloud, self.rng)
        return pointcloud, int(self.labels[idx])


class ScanObjectNNCls(ScanArrayDataset):
    """ScanObjectNN classification (15 classes) from its HDF5 files."""

    def __init__(self, num_points: int, data_dir: str, partition: str = "train",
                 subset: str = "easy", seed: int = 0):
        data, label = load_data_scanobjectnn(data_dir, partition, subset)
        super().__init__(data, label, num_points, partition == "train", seed)
        self.partition, self.subset = partition, subset


class ModelNet40_v2:
    """ModelNet40's raw text clouds (``<data_dir>/<class>/<id>.txt``, rows
    ``x,y,z[,nx,ny,nz]``; ``modelnet40_shape_names.txt`` and
    ``modelnet40_{partition}.txt`` list the classes and ids), items
    ``(points (num_points, 3 or 6), label)``: the first ``num_points``
    rows, or with ``uniform`` that many by farthest-point sampling on
    ``device`` (the card unless the caller asks for the CPU), the
    coordinates through ``pc_normalize``; the first ``cache_size`` items
    read are kept."""

    num_classes = 40

    def __init__(self, data_dir: str, num_points: int = 1024,
                 partition: str = "train", uniform: bool = False,
                 normal_channel: bool = False, cache_size: int = 15000,
                 device="cuda"):
        assert partition in ("train", "test")
        self.root, self.npoints = data_dir, num_points
        self.uniform, self.normal_channel = uniform, normal_channel
        self.device = config.resolve_device(device) if uniform else None
        with open(os.path.join(data_dir, "modelnet40_shape_names.txt")) as f:
            self.cat = [line.rstrip() for line in f]
        self.classes = dict(zip(self.cat, range(len(self.cat))))
        with open(os.path.join(data_dir, f"modelnet40_{partition}.txt")) as f:
            ids = [line.rstrip() for line in f]
        names = ["_".join(x.split("_")[0:-1]) for x in ids]
        self.datapath = [(name, os.path.join(data_dir, name, i) + ".txt")
                         for name, i in zip(names, ids)]
        self.cache_size = cache_size
        self.cache: dict = {}

    def __len__(self):
        return len(self.datapath)

    def __getitem__(self, index):
        if index in self.cache:
            return self.cache[index]
        name, path = self.datapath[index]
        pts = np.loadtxt(path, delimiter=",").astype(np.float32)
        if self.uniform:
            xyz = torch.from_numpy(pts[None, :, :3]).to(self.device)
            pts = pts[farthest_point_sample(xyz, self.npoints)[0].cpu().numpy()]
        else:
            pts = pts[: self.npoints]
        pts[:, 0:3] = pc_normalize(pts[:, 0:3])
        if not self.normal_channel:
            pts = pts[:, 0:3]
        item = (pts, int(self.classes[name]))
        if len(self.cache) < self.cache_size:
            self.cache[index] = item
        return item


class RoomArrayDataset:
    """S3DIS rooms (M, n, 9) and per-point labels (M, n) in memory, items
    ``(points (num_points, 9) float32, seg (num_points,) int64)``: each
    room's first ``num_points`` points, and (train) a permutation of them
    and their labels together, drawn from one numpy generator."""

    num_classes = 13

    def __init__(self, data: np.ndarray, seg: np.ndarray, num_points: int,
                 train: bool = False, seed: int = 0):
        self.data = np.asarray(data, dtype=np.float32)
        self.seg = np.asarray(seg)
        self.num_points = num_points
        self.train = train
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return self.data.shape[0]

    def __getitem__(self, item):
        pointcloud = self.data[item][: self.num_points]
        seg = self.seg[item][: self.num_points]
        if self.train:
            idx = self.rng.permutation(pointcloud.shape[0])
            pointcloud, seg = pointcloud[idx], seg[idx]
        return pointcloud, seg.astype("int64")


class S3DIS(RoomArrayDataset):
    """S3DIS semantic segmentation from the HDF5 packaging
    (``<data_dir>/indoor3d_sem_seg_hdf5_data/all_files.txt`` lists the
    files, relative to ``data_dir``; ``room_filelist.txt`` names each
    room): the rooms of ``Area_<test_area>`` are the test partition, the
    others the train one."""

    def __init__(self, num_points: int = 4096, data_dir: str = "data",
                 partition: str = "train", test_area: str = "1", seed: int = 0):
        h5py = _h5py()
        d = os.path.join(data_dir, "indoor3d_sem_seg_hdf5_data")
        with open(os.path.join(d, "all_files.txt")) as f:
            all_files = [line.rstrip() for line in f]
        with open(os.path.join(d, "room_filelist.txt")) as f:
            rooms = [line.rstrip() for line in f]
        data, seg = [], []
        for fpath in all_files:
            with h5py.File(os.path.join(data_dir, fpath), "r") as f:
                data.append(f["data"][:])
                seg.append(f["label"][:])
        area = f"Area_{test_area}"
        idx = [i for i, r in enumerate(rooms) if (area in r) != (partition == "train")]
        super().__init__(np.concatenate(data)[idx], np.concatenate(seg)[idx],
                         num_points, partition == "train", seed)
        self.partition = partition
