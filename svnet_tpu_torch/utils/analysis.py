"""Complexity analysis: Params / MACs / ADDs / BOPs from the traced program
(counterpart of svnet_tpu/utils/analysis.py).

The counts come from the model's own traced aten graph (``make_fx`` with
fake tensors: nothing is computed), one source of truth that cannot drift
from models/.

Classification convention (the reference's params_macs/macs.py:20-122):
  * a product whose BOTH operands pass through ``sign`` -> BOPs (the
    XNOR-popcount-mappable 1-bit ops of the binarized scalar stream);
  * ONE operand signed (weights-only binarization, the vector stream)
    -> ADDs (multiplies by ±1 degenerate to additions);
  * otherwise -> MACs.

The products are the matmul family (``mm``, ``bmm``, ``addmm``,
``baddbmm``, ``convolution``; einsum and matmul as they decompose) and the
kNN's inner products (``svnet::pair_inner``, ops/knn.py), which JAX takes
as an einsum. An operand's provenance passes through views, permutes,
expands, copies and casts, and through mul, add, sub, maximum, minimum,
clamp and cat on any signed input, to depth 12, as JAX's passes through
its counterparts.

Param size: binarized kernels (identified by a sibling per-channel
``scale``, which only binarized Linears create) weigh 1 bit vs 32
(params_macs/macs.py:6-17).

``flop_cost`` stands in for JAX's ``hlo_cost``: flops from
``torch.utils.flop_counter.FlopCounterMode`` and bytes summed over every
aten op's inputs and outputs, run eagerly. It is not XLA's count of a
fused program: every intermediate is counted as read and written.

CLI:  python -m svnet_tpu_torch.utils.analysis --model svnet --backbone dgcnn \\
        --task cls --binary [--num-points 1024] [--k 20]
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

_PASSTHROUGH = {
    "view", "_unsafe_view", "reshape", "permute", "transpose", "t",
    "expand", "unsqueeze", "squeeze", "clone", "_to_copy", "alias",
    "detach", "contiguous", "lift_fresh_copy",
}
_ANY_INPUT = {"mul", "add", "sub", "maximum", "minimum", "clamp", "cat"}
_PRODUCTS = {"mm", "bmm", "addmm", "baddbmm", "convolution", "pair_inner"}


def count_params(params, binary_bit: int = 1) -> Dict[str, float]:
    """Parameter count (M) and storage (Mbit) with 1-bit binarized kernels."""
    total = 0
    binarized = 0

    def walk(tree):
        nonlocal total, binarized
        if not isinstance(tree, dict):
            return
        leaves = {k: v for k, v in tree.items() if not isinstance(v, dict)}
        for v in leaves.values():
            total += int(np.prod(np.shape(v)))
        if "kernel" in leaves and "scale" in leaves:
            binarized += int(np.prod(np.shape(leaves["kernel"])))
        for v in tree.values():
            if isinstance(v, dict):
                walk(v)

    walk(params)
    size_mbit = ((total - binarized) * 32 + binarized * binary_bit) / 1e6
    return {
        "params_m": total / 1e6,
        "binarized_m": binarized / 1e6,
        "size_mbit": size_mbit,
        "size_equiv_m32": size_mbit / 32,
    }


def _name(node) -> str:
    """An aten node's op name without its overload (``mm``, ``view``)."""
    target = node.target
    if hasattr(target, "_opname"):
        return target._opname
    return str(getattr(target, "__name__", target)).split(".")[0]


def _shape(node) -> tuple:
    return tuple(node.meta["val"].shape)


def _product_macs(node, name: str) -> int:
    """A product node's multiply-accumulates (not 2x)."""
    out = int(np.prod(_shape(node)))
    if name in ("mm", "bmm", "pair_inner"):
        return out * _shape(node.args[0])[-1]
    if name in ("addmm", "baddbmm"):
        return out * _shape(node.args[1])[-1]
    w = _shape(node.args[1])  # convolution: (out, in / groups, *kernel)
    return out * int(np.prod(w[1:]))


def _operands(node, name: str) -> list:
    if name in ("addmm", "baddbmm"):
        return [node.args[1], node.args[2]]
    return [node.args[0], node.args[1]]


def _signed(node, depth: int = 0) -> bool:
    if depth > 12 or not isinstance(node, torch.fx.Node):
        return False
    if node.op != "call_function":
        return False
    name = _name(node)
    if name == "sign":
        return True
    if name in _PASSTHROUGH:
        return _signed(node.args[0], depth + 1)
    if name in _ANY_INPUT:
        args = node.args[0] if name == "cat" else node.args
        return any(_signed(a, depth + 1) for a in args)
    return False


def op_counts(fn, *args) -> Dict[str, float]:
    """Trace ``fn`` into an aten graph and classify every product into
    MACs/ADDs/BOPs; in millions."""
    from torch.fx.experimental.proxy_tensor import make_fx

    with torch.no_grad():
        gm = make_fx(fn, tracing_mode="fake",
                     _allow_non_fake_inputs=True)(*args)
    totals = {"macs": 0, "adds": 0, "bops": 0}
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        name = _name(node)
        if name not in _PRODUCTS:
            continue
        macs = _product_macs(node, name)
        l, r = (_signed(a) for a in _operands(node, name))
        if l and r:
            totals["bops"] += macs
        elif l or r:
            totals["adds"] += macs
        else:
            totals["macs"] += macs
    return {k: v / 1e6 for k, v in totals.items()}  # in millions (M ops)


def flop_cost(fn, *args) -> Dict[str, float]:
    """Flops of ``fn`` on ``args`` (``FlopCounterMode``) and the bytes its
    aten ops read and write, each op on its own (no fusion: this is not
    XLA's count of a fused program)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten
    from torch.utils.flop_counter import FlopCounterMode

    class _Bytes(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_flatten((args, kwargs, out))[0]:
                if isinstance(t, torch.Tensor):
                    self.total += t.numel() * t.element_size()
            return out

    flops = FlopCounterMode(display=False)
    with torch.no_grad(), flops, _Bytes() as nbytes:
        fn(*args)
    return {"flops": float(flops.get_total_flops()),
            "bytes_accessed": float(nbytes.total)}


def analyze_model(task: str, backbone: str, model_name: str, *, binary: bool,
                  num_points: int, k: int, batch: int = 2) -> Dict[str, float]:
    """Params of the model's tree and its per-cloud MACs/ADDs/BOPs at
    (batch, num_points), as JAX's ``analyze_model`` counts them (zero
    weights; the counts do not depend on them)."""
    from svnet_tpu_torch import models
    from svnet_tpu_torch.utils.convert import module_tree

    kw = {"k": k}
    if model_name == "svnet":
        kw["binary"] = binary
    if task == "cls":
        m = models.get_model("cls", backbone, model_name, num_classes=40, **kw)
        args = (torch.zeros((batch, num_points, 3)),)
    else:
        m = models.get_model("partseg", backbone, model_name, num_part=50,
                             **kw)
        args = (torch.zeros((batch, num_points, 3)), torch.zeros((batch, 16)))
    m.eval()
    out = count_params(module_tree(m)["params"])
    ops_m = op_counts(m, *args)
    # per-cloud numbers
    out.update({f"{kk}_m_per_cloud": vv / batch for kk, vv in ops_m.items()})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--task", default="cls", choices=["cls", "partseg"])
    ap.add_argument("--backbone", default="dgcnn", choices=["dgcnn", "pointnet"])
    ap.add_argument("--model", default="svnet")
    ap.add_argument("--binary", action="store_true")
    ap.add_argument("--num-points", type=int, default=None)
    ap.add_argument("--k", type=int, default=None)
    args = ap.parse_args(argv)
    num_points = args.num_points or (1024 if args.task == "cls" else 2048)
    k = args.k or (20 if args.task == "cls" else 40)
    res = analyze_model(args.task, args.backbone, args.model,
                        binary=args.binary, num_points=num_points, k=k)
    print(f"{args.model}-{args.backbone}-{args.task}"
          f"{' (binary)' if args.binary else ''} @ N={num_points}, k={k}:")
    print(f"  Params: {res['params_m']:.4f}M ({res['binarized_m']:.4f}M "
          f"binarized, {res['size_mbit']:.2f} Mbit = "
          f"{res['size_equiv_m32']:.4f}M fp32-equiv)")
    print(f"  per cloud: MACs {res['macs_m_per_cloud']:.1f}M | "
          f"ADDs {res['adds_m_per_cloud']:.1f}M | "
          f"BOPs {res['bops_m_per_cloud']:.1f}M")
    return res


if __name__ == "__main__":
    main()
