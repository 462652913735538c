"""Optimizers and LR schedules of the DGCNN and SV-PointNet recipes
(counterpart of svnet_tpu/train/optim.py::make_optimizer, recipes 'dgcnn',
'pointnet_cls' and 'pointnet_partseg').

Adam adds the L2 weight decay to the gradient before the moments (torch
``Adam(weight_decay=...)``, optax ``add_decayed_weights`` before
``scale_by_adam``). 'dgcnn': binary, Adam and a per-epoch cosine from lr
to 0; FP, SGD with momentum 0.9, lr x 100, cosine to ``eta_min = lr``;
``opt`` forces 'adam' or 'sgd' ('auto' keeps the recipe's choice).
'pointnet_cls': always Adam and StepLR(20, 0.7) per epoch;
'pointnet_partseg': Adam and lr * 0.5 ** (epoch // 20), at least 1e-5
(``manual_clip_schedule``). The schedule
is a function of the optimizer step, applied by the train step.
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


def step_schedule(lr0: float, steps_per_epoch: int, step_size: int = 20,
                  gamma: float = 0.7) -> Callable[[int], float]:
    """torch StepLR stepped per epoch, as a function of the step."""

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return lr0 * gamma ** (epoch // step_size)

    return schedule


def manual_clip_schedule(lr0: float, steps_per_epoch: int, gamma: float = 0.5,
                         step_size: int = 20,
                         floor: float = 1e-5) -> Callable[[int], float]:
    """lr0 * gamma ** (epoch // step_size), at least ``floor``, stepped per
    epoch, as a function of the step."""

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return max(lr0 * gamma ** (epoch // step_size), floor)

    return schedule


def make_optimizer(params: Iterable[torch.Tensor], *, binary: bool, lr: float,
                   epochs: int, steps_per_epoch: int, momentum: float = 0.9,
                   weight_decay: float = 1e-4, recipe: str = "dgcnn",
                   opt: str = "auto"):
    """Returns (optimizer, schedule(step) -> lr)."""
    if opt not in ("auto", "adam", "sgd"):
        raise ValueError(f"unknown optimizer {opt!r}")
    if recipe in ("pointnet_cls", "pointnet_partseg"):
        sched = (step_schedule if recipe == "pointnet_cls"
                 else manual_clip_schedule)(lr, steps_per_epoch)
        return torch.optim.Adam(params, lr=sched(0), weight_decay=weight_decay), sched
    if recipe != "dgcnn":
        raise ValueError(f"unknown recipe {recipe!r}")
    use_adam = binary if opt == "auto" else opt == "adam"
    if use_adam:
        sched = cosine_schedule(lr, epochs, steps_per_epoch, eta_min=0.0)
        return torch.optim.Adam(params, lr=sched(0), weight_decay=weight_decay), sched
    sched = cosine_schedule(lr * 100, epochs, steps_per_epoch, eta_min=lr)
    return torch.optim.SGD(params, lr=sched(0), momentum=momentum,
                           weight_decay=weight_decay), sched
