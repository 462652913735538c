"""Settings the port reads, and the device/precision helpers.

The JAX package's three serving modes are ported. "exact": f32-exact
neighbour ordering (sortable-int key of the f32 distance, ties to the
minimum row id) and f32 arithmetic throughout. "fast", on the round3
trunk (B1, B2): 18-bit packed distance keys per key tile and a
fixed-point gather grid of ``fast_gather_bits`` (ops/kernels/quant.py).
"approx", on the round3 trunk: fast's keys folded to ``approx_fold``
candidate lanes by key max before the top-k, a gather grid of
``approx_gather_bits``, and the SV-DGCNN engines' Morton entry sort
(``morton_entry`` forces the sort in any mode). The legacy row-major
trunks "round2" (B10b) and "round" (B10a) take fast and approx mode
with their own fixed grids and fold, and the classifier's "edge" trunk
(B10c, B10d) with its bf16 gather and exact kNN; none of them reads
these knobs (``check_mode`` refuses the knobs there, C23). Graph reuse, on
the round3 trunk of the SV-DGCNN engines in every mode: ``graph_reuse``
("spatial": every conv round takes the first round's xyz neighbour ids;
"conv2": conv3 and conv4 take conv2's), ``reuse_k`` (reuse rounds take
the nearest r ranks and run at k = r) and ``reuse_gather_window`` (a
gather-compaction width on the TPU; here the full gather, which it
equals bitwise, and a reason to Morton-sort at entry). The candidate
window is an argument of the SV-DGCNN engines and of B1 and B2
(``window=``, ops/window.py), as in JAX. Training: ``train_knobs``
(knob-aware finetuning: the binary SV-DGCNN train and eval forwards
simulate ``graph_reuse``, ``reuse_k`` and an 8-bit ``approx_gather_bits``;
``train_knob_state`` resolves it once, for a caller that passes it on) and
``fused_train`` (which SV-DGCNN train forward the trainer takes). The
other knobs of svnet_tpu/config.py are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

EPS = 1e-6  # VectorBN norm epsilon (svnet_tpu/nn/sv_layers.py:34)
BN_EPS = 1e-5  # BatchNorm epsilon (torch BN1d default)
MODES = ("exact", "fast", "approx")
fast_gather_bits: int = 16  # fast mode's gather grid: 16 or 8 bits
approx_fold: int = 256  # approx mode's folded candidate width
approx_gather_bits: int = 16  # approx mode's gather grid: 16 or 8 bits
morton_entry: bool = False  # SV-DGCNN engines Morton-sort at entry
GRAPH_REUSE = ("none", "conv2", "spatial")
graph_reuse: str = "none"  # which neighbour ids the later conv rounds reuse
reuse_k: int = 0  # 0: off; reuse rounds take the nearest reuse_k ranks
reuse_gather_window: int = 0  # 0: off; rows of the TPU's gather compaction
train_knobs: bool = False  # binary SV-DGCNN forwards simulate the serving knobs
FUSED_TRAIN = ("auto", "on", "off")
fused_train: str = "auto"  # "auto": the fused train forward on the card


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


def set_graph_reuse(name: str) -> None:
    """Graph reuse on the SV-DGCNN engines' round3 trunk
    (svnet_tpu/config.py::set_graph_reuse): "none" (every round selects
    its own neighbours), "conv2" (conv3 and conv4 take conv2's ids) or
    "spatial" (conv2..conv4 take the first round's xyz ids). The other
    trunks raise when it is not "none"."""
    global graph_reuse
    if name not in GRAPH_REUSE:
        raise ValueError(f"graph_reuse must be one of {GRAPH_REUSE}, got {name!r}")
    graph_reuse = name


def set_reuse_k(r: int) -> None:
    """Reuse rounds take the nearest ``r`` of the k ranks they are given
    (the ids are rank-major) and run at k = r; 0 (or r >= k) takes all
    (svnet_tpu/config.py::set_reuse_k)."""
    global reuse_k
    if r < 0:
        raise ValueError(f"reuse_k must be >= 0, got {r}")
    reuse_k = r


def set_reuse_gather_window(width: int) -> None:
    """The reuse rounds' gather-compaction width W: 0, or a multiple of 128
    of at least 128 (svnet_tpu/config.py::set_reuse_gather_window). The
    TPU gathers from a compaction of the winners' 128-row blocks, bitwise
    the full gather; on the card a neighbour is one indexed row read, so
    the port runs the full gather. With graph reuse on, W > 0 also
    Morton-sorts the cloud at the engines' entry, as in JAX."""
    global reuse_gather_window
    if width != 0 and (width < 128 or width % 128):
        raise ValueError(f"reuse_gather_window must be 0 or a multiple of 128 "
                         f">= 128, got {width}")
    reuse_gather_window = width


def set_train_knobs(on: bool) -> None:
    """Knob-aware training (svnet_tpu/config.py::set_train_knobs): the
    binary SV-DGCNN train forwards, and the eval forward of the eager
    models a trainer builds, simulate the serving knobs set here --
    ``graph_reuse`` (later rounds take the cached round's ids),
    ``reuse_k`` (reuse rounds take the nearest r ranks) and
    ``approx_gather_bits`` 8 (each binary round's input through
    ``nn.sv_train.ste_quant8``); the selection stays exact. Read once,
    by ``train_knob_state``."""
    global train_knobs
    train_knobs = bool(on)


def set_fused_train(name: str) -> None:
    """The SV-DGCNN trainers' train forward (svnet_tpu/config.py::
    set_fused_train): "on" the fused one (train/fused.py, kernels B5/B6),
    "off" the un-fused one (train/dgcnn.py, B7), "auto" the fused one on
    the card, as JAX's on the TPU."""
    global fused_train
    if name not in FUSED_TRAIN:
        raise ValueError(f"fused_train must be one of {FUSED_TRAIN}, got {name!r}")
    fused_train = name


def use_fused_train(device) -> bool:
    """Whether an SV-DGCNN trainer on ``device`` takes the fused train
    forward (svnet_tpu/train/loop.py:356-372)."""
    return fused_train == "on" or (fused_train == "auto"
                                   and torch.device(device).type == "cuda")


@dataclass(frozen=True)
class TrainKnobs:
    """Resolved knob-aware training (svnet_tpu/train/fused.py::_train_knobs,
    svnet_tpu/models/sv_dgcnn.py::_knob_state): ``reuse`` ("none", "conv2",
    "spatial"), ``reuse_k`` (0: all ranks) and ``q8`` (each binary round's
    input on the 8-bit gather grid, straight-through)."""

    reuse: str = "none"
    reuse_k: int = 0
    q8: bool = False

    def reuses(self, name: str) -> bool:
        """Whether round ``name`` takes a cached round's ids."""
        return self.reuse == "spatial" or (self.reuse == "conv2"
                                           and name != "conv2")

    def round_k(self, name: str, k: int) -> int:
        """The neighbours round ``name`` runs at: reuse_k in a reuse round
        where 0 < reuse_k < k, else k."""
        rk = self.reuse_k
        return rk if self.reuses(name) and 0 < rk < k else k


def train_knob_state(binary: bool) -> TrainKnobs | None:
    """The knobs a binary SV-DGCNN forward simulates, read from this
    module once; None where ``train_knobs`` is off or the model is FP (a
    teacher never takes them)."""
    if not (train_knobs and binary):
        return None
    return TrainKnobs(graph_reuse, reuse_k, approx_gather_bits == 8)


def check_mode(mode: str, trunk: str = "round3") -> str:
    """``mode`` if it is ported on ``trunk``: exact, fast and approx on
    every trunk (round3, round2, round and edge).

    The legacy trunks gather through a fixed grid (round2: 16 bits; round
    and edge: bf16), round2 folds to a fixed 256 lanes and the edge trunk
    selects by its exact kNN in every mode (svnet_tpu/ops/pallas/
    sv_round2.py:58, :95-120; sv_round.py:68-70; sv_edge.py:63-84;
    svnet_tpu/infer.py:303-310), whatever the knobs say.
    JAX ignores the knobs there; the port refuses a setting that would
    not act (C23), as it refuses graph reuse and the window off round3:
    ``fast_gather_bits`` 8 in fast mode, ``approx_gather_bits`` 8 or an
    ``approx_fold`` other than 256 in approx mode."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not ported; supported: {MODES}")
    if mode == "exact" or trunk == "round3":
        return mode
    if trunk not in ("round2", "round", "edge"):
        raise ValueError(f"unknown trunk {trunk!r}")
    knobs = ({"fast_gather_bits": (fast_gather_bits, 16)} if mode == "fast"
             else {"approx_gather_bits": (approx_gather_bits, 16),
                   "approx_fold": (approx_fold, 256)})
    for name, (value, fixed) in knobs.items():
        if value != fixed:
            raise ValueError(f"{name}={value} does not act on the {trunk!r} "
                             f"trunk ({mode} mode there reads no knob); only "
                             f"the default {fixed} is taken (C23)")
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
