"""Models written once as functions of their flax-named weight trees.

The VN and original model families (``models/vn_pointnet.py``,
``vn_dgcnn.py``, ``pointnet.py``, ``dgcnn.py``) are functions
``fn(scope, *inputs, **config)`` that read their weights through a
``Scope``, as a flax ``@nn.compact`` module does: ``scope.child(name)`` is
the submodule ``name``, ``scope.param`` a parameter leaf. One function
serves three modes:

- init (``init_tree``): the leaves are drawn from a ``torch.Generator``
  as they are first asked for, shaped from the inputs, on a tiny input or
  on the caller's batch (``ScopedModel.init_on``: a leaf drawn from the
  data it sees, BiPointNet's LSR ``scale``), BatchNorm on its initial
  running statistics, as flax ``init`` runs;
- eval (``ScopedModel.forward``): BatchNorm reads the running statistics;
- train (``ScopedModel.make_train_apply``): BatchNorm normalizes with the
  batch statistics and records the new running statistics (``BN_MOM`` of
  ``nn/sv_train.py``, flax's momentum 0.9), dropout draws from the step's
  generator.

``plain`` (the oracle twins) takes the plain versions of kernels B4 and B7
in the graph ops on any device.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from svnet_tpu_torch.config import BN_EPS
from svnet_tpu_torch.nn import sv_train as svt
from svnet_tpu_torch.utils.convert import load_tree, nest


class Scope:
    """A path into ``{'params', 'batch_stats'}`` and the mode of the pass.
    In train mode the new running statistics collect in ``new`` (the
    batch_stats tree's paths, shared by every child)."""

    def __init__(self, tree: dict, *, train: bool = False,
                 generator: torch.Generator | None = None, plain: bool = False,
                 init: torch.Generator | None = None, path: tuple = (),
                 new: dict | None = None, like: torch.Tensor | None = None):
        self.tree, self.train, self.generator = tree, train, generator
        self.plain, self.init, self.path = plain, init, path
        self.new = {} if new is None else new
        self.like = like  # init: the drawn leaves take its device and dtype

    def child(self, name: str) -> "Scope":
        return Scope(self.tree, train=self.train, generator=self.generator,
                     plain=self.plain, init=self.init, path=self.path + (name,),
                     new=self.new, like=self.like)

    def _node(self, root: dict) -> dict:
        for name in self.path:
            root = root.setdefault(name, {}) if self.init is not None else root[name]
        return root

    def _leaf(self, value: torch.Tensor) -> torch.Tensor:
        if self.like is None:
            return value
        return value.to(self.like.device, self.like.dtype)

    def param(self, name: str, shape: tuple, draw) -> torch.Tensor:
        """The leaf ``name``; in init mode ``draw(shape, generator)`` first
        (a leaf already in the tree is kept)."""
        node = self._node(self.tree["params"])
        if self.init is not None and name not in node:
            node[name] = self._leaf(draw(shape, self.init))
        return node[name]

    def stat(self, name: str, fill: float, size: int | tuple) -> torch.Tensor:
        """The running statistic ``name`` of ``size`` (a width or a shape),
        ``fill`` at init."""
        node = self._node(self.tree["batch_stats"])
        if self.init is not None and name not in node:
            shape = size if isinstance(size, tuple) else (size,)
            node[name] = self._leaf(torch.full(shape, float(fill)))
        return node[name]

    def record(self, stats: dict) -> None:
        node = self.new
        for name in self.path:
            node = node.setdefault(name, {})
        node.update(stats)


def torch_linear_init(d_in: int):
    """U(-1/sqrt(d_in), 1/sqrt(d_in)), torch nn.Linear's default."""
    bound = 1.0 / math.sqrt(d_in)
    return lambda shape, g: (torch.rand(shape, generator=g) * 2.0 - 1.0) * bound


def linear(s: Scope, x: torch.Tensor, features: int,
           use_bias: bool = True) -> torch.Tensor:
    """svl.Linear, full precision: ``x @ kernel (+ bias)``."""
    d_in = x.shape[-1]
    y = x @ s.param("kernel", (d_in, features), torch_linear_init(d_in))
    if use_bias:
        y = y + s.param("bias", (features,), torch_linear_init(d_in))
    return y


def batch_norm(s: Scope, x: torch.Tensor, affine: bool = True,
               name: str = "bn") -> torch.Tensor:
    """svl.BatchNorm (flax ``nn.BatchNorm`` named ``name`` under ``s``,
    momentum 0.9, epsilon 1e-5) over the last axis, statistics over all
    leading axes. ``affine=False``: no ``scale`` or ``bias`` leaf
    (``use_scale``/``use_bias`` False)."""
    s = s.child(name)
    c = x.shape[-1]
    p = {"scale": 1.0, "bias": 0.0}
    if affine:
        p = {"scale": s.param("scale", (c,), lambda shape, g: torch.ones(shape)),
             "bias": s.param("bias", (c,), lambda shape, g: torch.zeros(shape))}
    st = {"mean": s.stat("mean", 0.0, c), "var": s.stat("var", 1.0, c)}
    if s.train:
        y, new = svt.bn_train(p, st, x)
        s.record(new)
        return y
    mul = torch.rsqrt(st["var"] + BN_EPS) * p["scale"]
    return (x - st["mean"]) * mul + p["bias"]


def dropout(s: Scope, x: torch.Tensor, rate: float) -> torch.Tensor:
    """Dropout at ``rate`` in train mode when the step hands a generator
    (none: the identity, as in eval)."""
    if s.train and s.generator is not None and rate > 0.0:
        return svt.dropout(x, rate, s.generator)
    return x


def init_tree(fn, inputs: tuple, config: dict,
              generator: torch.Generator | None, tree: dict | None = None) -> dict:
    """``fn``'s weight tree, drawn from ``generator`` on ``inputs`` (the
    leaves on the first input's device and in its dtype): BatchNorm scale
    1, bias 0, running mean 0, var 1. The leaves of a given ``tree`` are
    kept and only the missing ones drawn."""
    tree = {"params": {}, "batch_stats": {}} if tree is None else tree
    with torch.no_grad():
        fn(Scope(tree, init=generator or torch.Generator().manual_seed(0),
                 like=inputs[0]), *inputs, **config)
    return tree


def _register(module: nn.Module, params: dict, stats: dict) -> None:
    for name in sorted(set(params) | set(stats)):
        p, st = params.get(name), stats.get(name)
        if isinstance(p, dict) or isinstance(st, dict):
            child = nn.Module()
            module.add_module(name, child)
            _register(child, p or {}, st or {})
        elif p is not None:
            module.register_parameter(name, nn.Parameter(p))
        else:
            module.register_buffer(name, st)


class ScopedModel(nn.Module):
    """The eager eval model of a function ``forward_fn(scope, points[,
    label], **config)``: its parameters and buffers are named after the
    flax tree's paths (``load_tree``/``module_tree`` read and write them),
    and ``forward`` runs the function on them in eval mode. ``with_label``
    models (part segmentation) take the (B, 16) one-hot category; with
    ``oracle`` set the forward takes the plain kNN and gather on any device
    (the on-card reference of the kernel path)."""

    forward_fn = None
    with_label = False
    in_channels = 3  # the width of a point (S3DIS rooms: 9)
    data_init = False  # True: a leaf is drawn from the data (init_on)
    oracle = False  # True: the plain kNN and gather on any device

    def __init__(self, generator: torch.Generator | None = None, **config):
        super().__init__()
        self.config = config
        # the widths do not depend on N or k: a tiny cloud draws the tree
        n, c = max(config.get("k", 1), 2), self.in_channels
        inputs = (torch.linspace(0, 1, c * n).reshape(1, n, c).expand(2, n, c),)
        if self.with_label:
            inputs += (torch.eye(16)[:2],)
        tree = init_tree(type(self).forward_fn, inputs, config, generator)
        _register(self, tree["params"], tree["batch_stats"])

    def init_on(self, *inputs, generator: torch.Generator | None = None) -> None:
        """Redraw the weights on the caller's batch (points[, label]), as
        flax ``init`` on it: the same draws from ``generator`` (seed it as
        the constructor's was), and the leaves drawn from the data
        (``data_init`` models) from what each layer sees there. The
        JAX trainers init on their first test batch."""
        tree = init_tree(type(self).forward_fn, inputs, self.config, generator)
        load_tree(self, tree)

    def forward(self, *inputs):
        tree = {"params": nest(dict(self.named_parameters())),
                "batch_stats": nest(dict(self.named_buffers()))}
        return type(self).forward_fn(Scope(tree, plain=self.oracle), *inputs,
                                     **self.config)

    def make_train_apply(self, oracle: bool = False):
        """``apply(params, batch_stats, points[, label], generator=None) ->
        (outputs, new_batch_stats)``: this model's function and config in
        train mode on the caller's trees (the signature of
        ``train.pointnet.make_train_apply_cls``, so ``train.steps`` drives
        it). ``oracle=True`` takes the plain kNN and gather on any device:
        the reference the kernel path is held against on the card."""
        fn, config = type(self).forward_fn, dict(self.config)

        def run(params, batch_stats, inputs, generator):
            s = Scope({"params": params, "batch_stats": batch_stats}, train=True,
                      generator=generator, plain=oracle)
            return fn(s, *inputs, **config), s.new

        if self.with_label:
            return lambda params, batch_stats, points, label, generator=None: \
                run(params, batch_stats, (points, label), generator)
        return lambda params, batch_stats, points, generator=None: \
            run(params, batch_stats, (points,), generator)
