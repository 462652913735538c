"""Settings the port reads, and the device/precision helpers.

Only exact mode is ported: f32-exact neighbour ordering (sortable-int key
of the f32 distance, ties to the minimum row id) and f32 arithmetic
throughout. The JAX package's fast/approx modes and serving knobs
(svnet_tpu/config.py) are not ported yet.
"""

from __future__ import annotations

import torch

EPS = 1e-6  # VectorBN norm epsilon (svnet_tpu/nn/sv_layers.py:34)
BN_EPS = 1e-5  # BatchNorm epsilon (torch BN1d default)
MODES = ("exact",)


def check_mode(mode: str) -> str:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not ported; supported: {MODES}")
    return mode


def require_cuda(device) -> torch.device:
    """Return ``device`` as an indexed CUDA torch.device (``cuda`` becomes
    ``cuda:<current>``), or raise if there is none."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"a CUDA device is required, got {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA device is required, but none is available")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def set_full_fp32() -> None:
    """Full-f32 matmuls and convolutions on the card.

    TF32 keeps ~3 decimal digits, enough to flip the sign of a value near
    zero that a binarized layer then turns into a ±1 difference. The
    engine and every on-card oracle call this before running.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
