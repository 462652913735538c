"""Exact kNN, kernel B4 (counterpart of svnet_tpu/ops/pallas/knn.py::knn_pallas).

``knn(x, k)`` maps channels-last features (B, N, C) to (B, N, k) int32
neighbour ids, nearest first, ties to the minimum row. A CPU tensor goes
to the plain version ``ops.knn.knn_plain``; a CUDA tensor launches
csrc/knn.cu (the serving rounds' selection, sv_common.cuh, writing the
ids point-major) or raises. ``knn.launches`` counts kernel launches.

Both rank by the sortable-int key of the f32 distance, summed channel by
channel with every product and sum rounded on its own, so their ids are
identical on any device.
"""

from __future__ import annotations

import torch

from svnet_tpu_torch.config import require_cuda
from svnet_tpu_torch.ops.kernels import _build
from svnet_tpu_torch.ops.knn import knn_plain


def knn(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N, C) float32 -> (B, N, k) int32 neighbour ids (self included)."""
    if x.dim() != 3:
        raise ValueError(f"x: shape {tuple(x.shape)}, expected (B, N, C)")
    B, N, C = x.shape
    if not 1 <= k <= N:
        raise ValueError(f"k={k} must lie in [1, N={N}]")
    if x.device.type == "cpu":
        return knn_plain(x, k)
    dev = require_cuda(x.device)
    if x.dtype != torch.float32:
        raise TypeError(f"x: dtype {x.dtype}, expected torch.float32")
    xt = x.detach().transpose(1, 2).contiguous()  # (B, C, N)
    aa = torch.empty((B, N), device=dev)
    ids = torch.empty((B, N, k), device=dev, dtype=torch.int32)
    err = _build.lib().sv_knn_launch(xt.data_ptr(), aa.data_ptr(),
                                     ids.data_ptr(), B, N, C, k,
                                     _build.stream_ptr(dev))
    _build.check(err, "knn")
    knn.launches += 1
    return ids


knn.launches = 0
