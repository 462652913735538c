"""Losses (counterpart of svnet_tpu/train/losses.py): cross-entropy with
label smoothing and the T-Net regularizer of the original PointNet."""

from __future__ import annotations

import torch


def cal_loss(logits: torch.Tensor, target: torch.Tensor,
             smoothing: bool = True) -> torch.Tensor:
    """Cross-entropy, by default with label smoothing eps=0.2: 1 - eps on
    the target and eps / (C - 1) on each other class (not eps / C)."""
    n_class = logits.shape[-1]
    logits = logits.reshape(-1, n_class)
    target = target.reshape(-1).long()
    log_prb = torch.log_softmax(logits, dim=-1)
    if smoothing:
        eps = 0.2
        one_hot = torch.nn.functional.one_hot(target, n_class).to(logits.dtype)
        soft = one_hot * (1 - eps) + (1 - one_hot) * eps / (n_class - 1)
        return -(soft * log_prb).sum(dim=-1).mean()
    return -log_prb.gather(1, target[:, None]).mean()


def feature_transform_regularizer(trans: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of ``|| T (T^t - I) ||_F``: the reference's
    operator precedence (``bmm(T, T^t - I)``), kept as the JAX package
    keeps it."""
    eye = torch.eye(trans.shape[1], dtype=trans.dtype, device=trans.device)
    prod = torch.einsum("bij,bjk->bik", trans, trans.transpose(1, 2) - eye)
    return torch.sqrt(torch.sum(prod * prod, dim=(1, 2))).mean()


def cal_pointnet_loss(outputs, target: torch.Tensor,
                      smoothing: bool = True) -> torch.Tensor:
    """``cal_loss`` of the logits plus 0.001 times the T-Net regularizer of
    ``outputs = (logits, trans_feat)``."""
    logits, trans_feat = outputs
    return cal_loss(logits, target, smoothing) + \
        0.001 * feature_transform_regularizer(trans_feat)


def model_loss(outputs, target: torch.Tensor, smoothing: bool = True) -> torch.Tensor:
    """The trainers' loss: ``cal_pointnet_loss`` for a model that returns
    (logits, trans_feat) (the original PointNet), ``cal_loss`` for one that
    returns logits (every other model, the original DGCNN included:
    ROADMAP C26)."""
    if isinstance(outputs, tuple):
        return cal_pointnet_loss(outputs, target, smoothing)
    return cal_loss(outputs, target, smoothing)
