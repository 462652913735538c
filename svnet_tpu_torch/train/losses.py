"""Classification loss (counterpart of svnet_tpu/train/losses.py::cal_loss)."""

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
