"""Settings the port reads, and the device/precision helpers.

The JAX package's three serving modes are ported. "exact": f32-exact
neighbour ordering (sortable-int key of the f32 distance, ties to the
minimum row id) and f32 arithmetic throughout. "fast", on the round3
trunk only (B1, B2): 18-bit packed distance keys per key tile and a
fixed-point gather grid of ``fast_gather_bits`` (ops/kernels/quant.py).
"approx", on the round3 trunk only: fast's keys folded to
``approx_fold`` candidate lanes by key max before the top-k, a gather
grid of ``approx_gather_bits``, and the SV-DGCNN engines' Morton entry
sort (``morton_entry`` forces the sort in any mode). The other serving
knobs (svnet_tpu/config.py) are not ported yet.
"""

from __future__ import annotations

import torch

EPS = 1e-6  # VectorBN norm epsilon (svnet_tpu/nn/sv_layers.py:34)
BN_EPS = 1e-5  # BatchNorm epsilon (torch BN1d default)
MODES = ("exact", "fast", "approx")
fast_gather_bits: int = 16  # fast mode's gather grid: 16 or 8 bits
approx_fold: int = 256  # approx mode's folded candidate width
approx_gather_bits: int = 16  # approx mode's gather grid: 16 or 8 bits
morton_entry: bool = False  # SV-DGCNN engines Morton-sort at entry


def set_fast_gather_bits(bits: int) -> None:
    """Fast mode's gather grid (svnet_tpu/config.py::set_fast_gather_bits):
    16 bits (scale 32704 / amax) or 8 (127 / amax); it also moves the key
    tile T (quant.round3_tiles)."""
    global fast_gather_bits
    if bits not in (8, 16):
        raise ValueError(f"fast_gather_bits must be 8 or 16, got {bits}")
    fast_gather_bits = bits


def set_approx_fold(width: int) -> None:
    """Approx mode's fold width (svnet_tpu/config.py::set_approx_fold):
    the candidate keys are halved by key max while wider than ``width``
    (quant.fold_width); at least 64 and even."""
    global approx_fold
    if width < 64 or width % 2:
        raise ValueError(f"approx_fold must be even and >= 64, got {width}")
    approx_fold = width


def set_approx_gather_bits(bits: int) -> None:
    """Approx mode's gather grid, 16 or 8 bits, as fast mode's
    (set_fast_gather_bits); it also moves the key tile T."""
    global approx_gather_bits
    if bits not in (8, 16):
        raise ValueError(f"approx_gather_bits must be 8 or 16, got {bits}")
    approx_gather_bits = bits


def set_morton_entry(on: bool) -> None:
    """Morton-sort the cloud at the SV-DGCNN engines' entry on the round3
    trunk in every mode, not only in approx mode
    (svnet_tpu/config.py::set_morton_entry)."""
    global morton_entry
    morton_entry = bool(on)


def check_mode(mode: str, trunk: str = "round3") -> str:
    """``mode`` if it is ported on ``trunk``: exact everywhere, fast and
    approx on the round3 trunk (B1, B2) only."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not ported; supported: {MODES}")
    if mode != "exact" and trunk != "round3":
        raise ValueError(f"mode {mode!r} is ported on the round3 trunk only, "
                         f"not on {trunk!r}")
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


def resolve_device(device="cuda") -> torch.device:
    """An entry point's device: a CUDA device (``require_cuda``) unless the
    caller asks for the CPU; never a fallback."""
    device = torch.device(device)
    if device.type == "cpu":
        return device
    return require_cuda(device)


def set_full_fp32() -> None:
    """Full-f32 matmuls and convolutions on the card.

    TF32 keeps ~3 decimal digits, enough to flip the sign of a value near
    zero that a binarized layer then turns into a ±1 difference. The
    engine and every on-card oracle call this before running.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
