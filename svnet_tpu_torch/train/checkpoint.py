"""Checkpoints with the reference's file management (counterpart of
svnet_tpu/train/checkpoint.py), written with ``torch.save``.

Files land in <save_dir>/save_models/ as checkpoint_%03d.ckpt; latest.txt
names the newest; model_best.ckpt is a copy made when the metric
improves; the previous checkpoint is deleted unless (save_id + 1) % 20 ==
0. Load precedence: test > resume_from > resume (through latest.txt). The
payload is a dict of plain values and tensors (epoch, params and
batch_stats trees, the optimizer's state_dict, best metric).
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

import torch

from svnet_tpu_torch import config


def save_checkpoint(state: dict, epoch: int, save_dir: str, is_best: bool,
                    save_id: Optional[int], save_freq: int = 20) -> int:
    model_dir = os.path.join(save_dir, "save_models")
    os.makedirs(model_dir, exist_ok=True)
    filename = os.path.join(model_dir, f"checkpoint_{epoch:03d}.ckpt")
    torch.save(state, filename)
    with open(os.path.join(model_dir, "latest.txt"), "w") as f:
        f.write(filename)
    if is_best:
        shutil.copyfile(filename, os.path.join(model_dir, "model_best.ckpt"))
    if save_id is not None and (save_id + 1) % save_freq > 0:
        old = os.path.join(model_dir, f"checkpoint_{save_id:03d}.ckpt")
        if os.path.exists(old) and old != filename:
            os.remove(old)
    return epoch


def load_checkpoint(save_dir: str, test: Optional[str] = None,
                    resume_from: Optional[str] = None, resume: bool = False,
                    device="cuda") -> Optional[dict]:
    """The saved dict, tensors on ``device`` (the card unless the caller
    asks for the CPU); None if nothing to load."""
    latest = os.path.join(save_dir, "save_models", "latest.txt")
    path = ""
    if test is not None:
        path = test
    elif resume_from is not None:
        path = resume_from
    elif resume and os.path.exists(latest):
        with open(latest) as f:
            path = f.readline().strip()
    if not path or not os.path.exists(path):
        return None
    return torch.load(path, map_location=config.resolve_device(device),
                      weights_only=True)
