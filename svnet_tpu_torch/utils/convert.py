"""The one bridge from the JAX package's weights to the port's.

A weight tree is ``{'params': ..., 'batch_stats': ...}`` of nested dicts
keyed like flax's, with torch float32 tensors as leaves. A module of
``svnet_tpu_torch.nn`` names its parameters and buffers after the same
paths, so ``params``/``batch_stats`` map onto ``named_parameters`` /
``named_buffers`` by joining the keys with dots.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, val in flat.items():
        node = out
        *heads, leaf = path.split(".")
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = val
    return out


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for name, val in tree.items():
        path = f"{prefix}{name}"
        if isinstance(val, dict):
            out.update(_flatten(val, path + "."))
        else:
            out[path] = val
    return out


def module_tree(module: nn.Module) -> dict:
    """A module's weights as a detached ``{'params', 'batch_stats'}`` tree."""
    return {
        "params": _nest({n: p.detach().clone()
                         for n, p in module.named_parameters()}),
        "batch_stats": _nest({n: b.detach().clone()
                              for n, b in module.named_buffers()}),
    }


def load_tree(module: nn.Module, tree: dict) -> None:
    """Copy a weight tree into ``module``; every key must match."""
    flat = _flatten(tree["params"])
    flat.update(_flatten(tree["batch_stats"]))
    module.load_state_dict(flat, strict=True)


def from_flax(variables: dict) -> dict:
    """flax ``{'params', 'batch_stats'}`` (numpy or array-like leaves) ->
    the port's weight tree of float32 CPU tensors."""

    def conv(d):
        return {
            n: conv(v) if isinstance(v, dict)
            else torch.tensor(np.asarray(v, dtype=np.float32))
            for n, v in d.items()
        }

    return {"params": conv(variables["params"]),
            "batch_stats": conv(variables["batch_stats"])}
