"""Optimizer and LR schedule of the DGCNN recipe (counterpart of
svnet_tpu/train/optim.py::make_optimizer, recipe 'dgcnn').

Binary: Adam with L2 weight decay added to the gradient before the
moments (torch ``Adam(weight_decay=...)``, optax ``add_decayed_weights``
before ``scale_by_adam``) and a per-epoch cosine from lr to 0. FP: SGD
with momentum 0.9, lr x 100, cosine to ``eta_min = lr``. ``opt`` forces
'adam' or 'sgd' ('auto' keeps the recipe's choice). The schedule is a
function of the optimizer step, applied by the train step.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch


def cosine_schedule(lr0: float, epochs: int, steps_per_epoch: int,
                    eta_min: float = 0.0) -> Callable[[int], float]:
    """torch CosineAnnealingLR stepped per epoch, as a function of the step."""

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return eta_min + (lr0 - eta_min) * 0.5 * (1 + math.cos(math.pi * epoch / epochs))

    return schedule


def make_optimizer(params: Iterable[torch.Tensor], *, binary: bool, lr: float,
                   epochs: int, steps_per_epoch: int, momentum: float = 0.9,
                   weight_decay: float = 1e-4, recipe: str = "dgcnn",
                   opt: str = "auto"):
    """Returns (optimizer, schedule(step) -> lr)."""
    if recipe != "dgcnn":
        raise NotImplementedError(f"optimizer recipe {recipe!r} is not ported")
    if opt not in ("auto", "adam", "sgd"):
        raise ValueError(f"unknown optimizer {opt!r}")
    use_adam = binary if opt == "auto" else opt == "adam"
    if use_adam:
        sched = cosine_schedule(lr, epochs, steps_per_epoch, eta_min=0.0)
        return torch.optim.Adam(params, lr=sched(0), weight_decay=weight_decay), sched
    sched = cosine_schedule(lr * 100, epochs, steps_per_epoch, eta_min=lr)
    return torch.optim.SGD(params, lr=sched(0), momentum=momentum,
                           weight_decay=weight_decay), sched
