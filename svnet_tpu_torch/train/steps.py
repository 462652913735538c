"""Train, BN re-estimation and eval steps (counterpart of
svnet_tpu/train/steps.py).

The JAX ``TrainState`` becomes the weight trees plus a torch optimizer:
``params`` is the flax-named tree of leaf tensors that require grad,
``batch_stats`` the tree of running statistics, and the optimizer holds
the moments. The step updates both trees in place of the JAX step's new
state, and leaves each parameter's gradient of the step in ``.grad``.
Rotation augmentation draws from the step's explicit ``torch.Generator``.
``with_label=True`` (part segmentation) hands the batch's one-hot
category ``label`` to the forward after the points.
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
                 recipe: str = "dgcnn", device="cuda") -> TrainState:
    """A train state from a weight tree (``init_params``, ``from_flax`` or a
    checkpoint) and the optimizer ``recipe`` ('dgcnn', 'pointnet_cls',
    'pointnet_partseg'), on the card unless ``device="cpu"``."""
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
        weight_decay=weight_decay, recipe=recipe, opt=opt)
    return TrainState(params, stats, optimizer, sched)


def _inputs(batch: dict, rot: str, generator, with_label: bool) -> tuple:
    points = apply_rotation_aug(batch["points"], rot, generator)
    return (points, batch["label"]) if with_label else (points,)


class Distiller:
    """Knowledge distillation (svnet_tpu/train/loop.py::_Distiller): a
    frozen teacher's logits guide the student through the Hinton term
    ``T^2 * CE(softmax(teacher / T), log_softmax(student / T))``, mean
    over the leading axes. ``model`` is the teacher's eager eval model
    (the FP model, never knob-aware) with its weights loaded, on the
    student's device; its forward runs under ``torch.no_grad()``."""

    def __init__(self, model, temperature: float = 4.0):
        self.model = model.eval()
        self.T = temperature

    def loss(self, student_logits: torch.Tensor, *inputs) -> torch.Tensor:
        """The KD term for the student's logits on ``inputs`` (the rotated
        points, and the one-hot label for part segmentation)."""
        with torch.no_grad():
            teacher = self.model(*inputs)
        T = self.T
        p_t = torch.softmax(teacher / T, dim=-1)
        log_p_s = torch.log_softmax(student_logits / T, dim=-1)
        return -(p_t * log_p_s).sum(dim=-1).mean() * (T * T)


def make_train_step(apply, loss_fn, rot: str = "aligned",
                    with_label: bool = False, distiller: Distiller | None = None,
                    alpha: float = 0.5):
    """``step(state, batch, generator) -> (loss, preds)``: rotation
    augmentation, the train forward ``apply`` (``make_fused_train_apply``,
    ``train.dgcnn.make_train_apply_cls`` or
    ``train.pointnet.make_train_apply_cls``; with a label, their partseg
    twins), the loss, its gradients and one optimizer update at the
    schedule's rate for this step. With a ``distiller`` the loss is
    ``(1 - alpha) * loss + alpha * distiller.loss`` on the same rotated
    inputs (svnet_tpu/train/loop.py::_make_kd_train_step)."""

    def step(state: TrainState, batch: dict, generator: torch.Generator):
        inputs = _inputs(batch, rot, generator, with_label)
        for group in state.opt.param_groups:
            group["lr"] = state.schedule(state.step)
        logits, new_stats = apply(state.params, state.batch_stats, *inputs,
                                  generator)
        loss = loss_fn(logits, batch["target"])
        if distiller is not None:
            loss = (1 - alpha) * loss + alpha * distiller.loss(logits, *inputs)
        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        state.opt.step()
        state.batch_stats = new_stats
        state.step += 1
        return loss.detach(), logits.detach().argmax(dim=-1)

    return step


def make_recal_step(apply, rot: str = "aligned", with_label: bool = False):
    """``step(params, batch_stats, batch, generator) -> new batch_stats``:
    a train-mode forward at fixed weights that only moves the running
    statistics (BN re-estimation before eval)."""

    @torch.no_grad()
    def step(params, batch_stats, batch, generator):
        inputs = _inputs(batch, rot, generator, with_label)
        return apply(params, batch_stats, *inputs, generator)[1]

    return step


def make_eval_step(model, loss_fn, rot_test: str = "so3",
                   with_label: bool = False):
    """``step(batch, generator) -> (loss, preds)`` through the eager eval
    model (``models.sv_dgcnn.SVDGCNNCls`` or
    ``models.sv_pointnet.SVPointNetCls``; with a label ``SVDGCNNPseg`` or
    ``SVPointNetPseg``, whose kNN and neighbour gathers launch kernels B4
    and B7 on the card; load the weights into ``model`` first) or through
    a serving engine (``--fused`` eval: ``infer.SVDGCNNClsEngine``,
    ``SVPointNetClsEngine`` or ``SVDGCNNPsegEngine``, built from the
    state's tree; svnet_tpu/train/loop.py::_fused_cls_eval_step)."""

    @torch.no_grad()
    def step(batch, generator):
        logits = model(*_inputs(batch, rot_test, generator, with_label))
        return loss_fn(logits, batch["target"]), logits.argmax(dim=-1)

    return step
