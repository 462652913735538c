"""Batched loader (counterpart of svnet_tpu/data/loader.py) that hands
batches to the device: ``points`` (B, n, 3) float32 and ``target`` (B,)
int64 tensors on ``device`` (the card unless the caller asks for the
CPU), plus ``pad`` and ``size``. A part-segmentation dataset's batch
(items ``(points, category, seg)``) also holds ``label``, the (B, 16)
float32 one-hot of the category, and ``category`` (B,); its ``target`` is
the per-point part ids ``seg`` (B, n). A semantic-segmentation batch
(items ``(points (n, 9), seg (n,))``) has ``points`` (B, n, 9) and the
per-point ``target`` (B, n), and no ``label`` or ``category``.
``num_workers > 0`` assembles batches in one producer thread ahead of the
consumer; the order and the random draws are the same either way."""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from svnet_tpu_torch import config

PREFETCH = 3  # batches the producer thread may run ahead of the consumer
NUM_CATEGORIES = 16  # ShapeNet part's categories: the width of ``label``


class Loader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, pad_last: bool = False,
                 num_workers: int = 0, device="cuda"):
        """``pad_last`` repeats items to fill the last batch (``size``
        excludes them); ``drop_last`` drops a short last batch."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle, self.drop_last, self.pad_last = shuffle, drop_last, pad_last
        self.num_workers = num_workers
        self.rng = np.random.default_rng(seed)
        self.device = config.resolve_device(device)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self):
        n = len(self.dataset)
        order = self.rng.permutation(n) if self.shuffle else np.arange(n)
        bs = self.batch_size
        for start in range(0, n, bs):
            idx = order[start:start + bs]
            pad = 0
            if len(idx) < bs:
                if self.drop_last:
                    return
                if self.pad_last:
                    pad = bs - len(idx)
                    idx = np.concatenate([idx, idx[:1].repeat(pad)])
            yield idx, pad

    def _collate(self, items, pad):
        points = np.stack([it[0] for it in items]).astype("float32")
        # a class per item, or (semantic segmentation) a label per point
        target = np.asarray([it[1] for it in items], dtype=np.int64)
        batch = {"points": points, "target": target, "pad": pad,
                 "size": len(items) - pad}
        if len(items[0]) == 3:  # part segmentation: (points, category, seg)
            label = np.zeros((len(items), NUM_CATEGORIES), dtype=np.float32)
            label[np.arange(len(items)), target] = 1.0
            batch["label"], batch["category"] = label, target
            batch["target"] = batch["seg"] = np.stack(
                [it[2] for it in items]).astype(np.int64)
        return {n: torch.from_numpy(v).to(self.device)
                if isinstance(v, np.ndarray) else v for n, v in batch.items()}

    def __iter__(self) -> Iterator[dict]:
        if self.num_workers <= 0:
            for idx, pad in self._index_batches():
                yield self._collate([self.dataset[int(i)] for i in idx], pad)
            return
        yield from self._iter_prefetch()

    def _iter_prefetch(self) -> Iterator[dict]:
        # items are fetched in ONE producer thread: a dataset's augmentation
        # draws from one numpy Generator, which is not thread-safe
        q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()
        done = object()

        def produce():
            try:
                for idx, pad in self._index_batches():
                    if stop.is_set():
                        return
                    q.put(self._collate([self.dataset[int(i)] for i in idx], pad))
                q.put(done)
            except BaseException as e:  # surfaced to the consumer
                q.put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                got = q.get()
                if got is done:
                    return
                if isinstance(got, BaseException):
                    raise got
                yield got
        finally:
            stop.set()
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(timeout=0.1)
