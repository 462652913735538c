"""Train, BN re-estimation and eval steps (counterpart of
svnet_tpu/train/steps.py).

The JAX ``TrainState`` becomes the weight trees plus a torch optimizer:
``params`` is the flax-named tree of leaf tensors that require grad,
``batch_stats`` the tree of running statistics, and the optimizer holds
the moments. The step updates both trees in place of the JAX step's new
state, and leaves each parameter's gradient of the step in ``.grad``.
Rotation augmentation draws from the step's explicit ``torch.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from svnet_tpu_torch import config
from svnet_tpu_torch.ops.rotations import apply_rotation_aug
from svnet_tpu_torch.train.optim import make_optimizer
from svnet_tpu_torch.utils.convert import flatten


def tree_map(fn, tree: dict) -> dict:
    return {n: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for n, v in tree.items()}


@dataclass
class TrainState:
    params: dict
    batch_stats: dict
    opt: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0

    def tree(self) -> dict:
        """The weights as a detached ``{'params', 'batch_stats'}`` tree."""
        return {"params": tree_map(lambda t: t.detach(), self.params),
                "batch_stats": self.batch_stats}


def create_state(weights: dict, *, binary: bool, lr: float, epochs: int,
                 steps_per_epoch: int, momentum: float = 0.9,
                 weight_decay: float = 1e-4, opt: str = "auto",
                 device="cuda") -> TrainState:
    """A train state from a weight tree (``init_params``, ``from_flax`` or a
    checkpoint), on the card unless ``device="cpu"``."""
    dev = config.resolve_device(device)
    if dev.type == "cuda":
        config.set_full_fp32()
    params = tree_map(lambda t: t.detach().to(dev, torch.float32).clone()
                      .requires_grad_(True), weights["params"])
    stats = tree_map(lambda t: t.detach().to(dev, torch.float32).clone(),
                     weights["batch_stats"])
    leaves = [leaf for _, leaf in sorted(flatten(params).items())]
    optimizer, sched = make_optimizer(
        leaves, binary=binary, lr=lr, epochs=epochs,
        steps_per_epoch=steps_per_epoch, momentum=momentum,
        weight_decay=weight_decay, opt=opt)
    return TrainState(params, stats, optimizer, sched)


def make_train_step(apply, loss_fn, rot: str = "aligned"):
    """``step(state, batch, generator) -> (loss, preds)``: rotation
    augmentation, the fused train forward, the loss, its gradients and one
    optimizer update at the schedule's rate for this step."""

    def step(state: TrainState, batch: dict, generator: torch.Generator):
        points = apply_rotation_aug(batch["points"], rot, generator)
        for group in state.opt.param_groups:
            group["lr"] = state.schedule(state.step)
        logits, new_stats = apply(state.params, state.batch_stats, points,
                                  generator)
        loss = loss_fn(logits, batch["target"])
        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        state.opt.step()
        state.batch_stats = new_stats
        state.step += 1
        return loss.detach(), logits.detach().argmax(dim=-1)

    return step


def make_recal_step(apply, rot: str = "aligned"):
    """``step(params, batch_stats, batch, generator) -> new batch_stats``:
    a train-mode forward at fixed weights that only moves the running
    statistics (BN re-estimation before eval)."""

    @torch.no_grad()
    def step(params, batch_stats, batch, generator):
        points = apply_rotation_aug(batch["points"], rot, generator)
        return apply(params, batch_stats, points, generator)[1]

    return step


def make_eval_step(model, loss_fn, rot_test: str = "so3"):
    """``step(batch, generator) -> (loss, preds)`` through the eager eval
    model (``models.sv_dgcnn.SVDGCNNCls``, whose kNN launches kernel B4 on
    the card); load the weights into ``model`` first."""

    @torch.no_grad()
    def step(batch, generator):
        points = apply_rotation_aug(batch["points"], rot_test, generator)
        logits = model(points)
        return loss_fn(logits, batch["target"]), logits.argmax(dim=-1)

    return step
