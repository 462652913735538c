"""The port's weight trees, and the two bridges into them: from the JAX
package's weights (``from_flax``) and from the reference's released
PyTorch ``.pth`` checkpoints (``convert_state_dict``, ``load_pth``,
``convert_file``; counterpart of svnet_tpu/utils/convert.py).

A weight tree is ``{'params': ..., 'batch_stats': ...}`` of nested dicts
keyed like flax's, with torch float32 tensors as leaves. A module of
``svnet_tpu_torch.nn`` names its parameters and buffers after the same
paths, so ``params``/``batch_stats`` map onto ``named_parameters`` /
``named_buffers`` by joining the keys with dots.

The ``.pth`` mechanics, as the JAX converter's:
  * strip the DataParallel ``module.`` prefix (reference checkpoints carry
    it)
  * linear weights (out, in) -> kernel (in, out) transposed; 1x1 conv
    weights (out, in, 1[, 1]) squeezed, then transposed
  * binarization params: beta (1, in[, 1]) -> (in,), scale (1, out[, 1])
    -> (out,); BiLinearLSR's 0-dim scale keeps its shape
  * batchnorm: weight/bias -> scale/bias params; running_mean/var ->
    batch_stats mean/var; num_batches_tracked dropped; plain BN modules
    gain a trailing /bn level, modules already ending in .bn map as they
    are
  * an unknown leaf is kept under its own name
  * model-family rename tables (``MODEL_RULES``) for the structural
    differences, and ``POST_HOOKS``' row permutations for the VN read-outs
    that the reference flattens c-major
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn


def nest(flat: dict) -> dict:
    """{'a.b.c': leaf} -> {'a': {'b': {'c': leaf}}}."""
    out: dict = {}
    for path, val in flat.items():
        node = out
        *heads, leaf = path.split(".")
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = val
    return out


def flatten(tree: dict, prefix: str = "") -> dict:
    """Nested dicts -> {'a.b.c': leaf}, the inverse of ``nest``."""
    out = {}
    for name, val in tree.items():
        path = f"{prefix}{name}"
        if isinstance(val, dict):
            out.update(flatten(val, path + "."))
        else:
            out[path] = val
    return out


def module_tree(module: nn.Module) -> dict:
    """A module's weights as a detached ``{'params', 'batch_stats'}`` tree."""
    return {
        "params": nest({n: p.detach().clone()
                        for n, p in module.named_parameters()}),
        "batch_stats": nest({n: b.detach().clone()
                             for n, b in module.named_buffers()}),
    }


def load_tree(module: nn.Module, tree: dict) -> None:
    """Copy a weight tree into ``module``; every key must match."""
    flat = flatten(tree["params"])
    flat.update(flatten(tree["batch_stats"]))
    module.load_state_dict(flat, strict=True)


def from_flax(variables) -> dict:
    """flax ``{'params', 'batch_stats'}`` (numpy or array-like leaves), or a
    JAX ``TrainState`` (its ``.params`` and ``.batch_stats``) -> the port's
    weight tree of float32 CPU tensors, the trainer's starting state."""
    if not isinstance(variables, dict):
        variables = {"params": variables.params,
                     "batch_stats": variables.batch_stats}

    def conv(d):
        return {
            n: conv(v) if isinstance(v, dict)
            else torch.tensor(np.asarray(v, dtype=np.float32))
            for n, v in d.items()
        }

    return {"params": conv(variables["params"]),
            "batch_stats": conv(variables["batch_stats"])}


def to_flax(tree: dict) -> dict:
    """A tree of tensors (weights, or gradients such as ``tree_map(lambda
    p: p.grad, state.params)``) -> nested dicts of numpy arrays keyed like
    flax's, to compare leaf by leaf with a flax tree."""
    return {n: to_flax(v) if isinstance(v, dict)
            else v.detach().cpu().numpy().copy() for n, v in tree.items()}


# rename rules applied to every SV-family key (regex, replacement)
_COMMON_RULES = [
    (r"(^|\.)gate\.0\.", r"\1gate_fc1."),
    (r"(^|\.)gate\.2\.", r"\1gate_fc2."),
]

# per-model structural renames (applied after common rules)
MODEL_RULES: Dict[str, list] = {
    "sv_dgcnn_cls": [],
    "sv_dgcnn_partseg": [
        # label branch: Sequential(Conv1d, BN, LReLU) -> Linear conv7 + bn7
        (r"^conv7\.0\.", "conv7."),
        (r"^conv7\.1\.", "bn7."),
        # head stacks: Sequential(Conv1d, BN, LReLU) -> _ConvBNLReLU(conv, bn)
        (r"^conv(8|9|10)\.0\.", r"conv\1.conv."),
        (r"^conv(8|9|10)\.1\.", r"conv\1.bn."),
    ],
    "sv_pointnet_cls": [],
    "sv_pointnet_partseg": [
        (r"^(conv_fuse1|conv_fuse2|convs1|convs2|convs3)\.0\.", r"\1_conv."),
        (r"^(conv_fuse1|conv_fuse2|convs1|convs2|convs3)\.1\.", r"\1_bn."),
    ],
    "vn_dgcnn_cls": [],
    "vn_dgcnn_partseg": [
        (r"^conv7\.0\.", "conv7."),
        (r"^conv7\.1\.", "bn7."),
        (r"^conv(8|9|10)\.0\.", r"conv\1."),
        (r"^conv(8|9|10)\.1\.", r"bn\1."),
    ],
    # classic PointNet: torch STNkd/encoder number their BNs bn1..bn5; our
    # _lin_bn_relu names them after the linear they normalize
    "pointnet_cls": [
        (r"(^|\.)(stn|fstn)\.bn([123])\.", r"\1\2.bn_conv\3."),
        (r"(^|\.)(stn|fstn)\.bn4\.", r"\1\2.bn_fc1."),
        (r"(^|\.)(stn|fstn)\.bn5\.", r"\1\2.bn_fc2."),
        (r"^feat\.bn([123])\.", r"feat.bn_conv\1."),
    ],
    "pointnet_partseg": [
        (r"(^|\.)(stn|fstn)\.bn([123])\.", r"\1\2.bn_conv\3."),
        (r"(^|\.)(stn|fstn)\.bn4\.", r"\1\2.bn_fc1."),
        (r"(^|\.)(stn|fstn)\.bn5\.", r"\1\2.bn_fc2."),
        (r"^bn([1-5])\.", r"bn_conv\1."),
        (r"^bns([1-3])\.", r"bn_convs\1."),
    ],
    # classic DGCNN: Sequential(conv, shared-bn, lrelu) stacks — the conv is
    # index .0, the (duplicated) shared BN appears both as .1 and as bnX
    "dgcnn_cls": [
        (r"^conv([0-9]+)\.0\.", r"conv\1."),
        (r"^conv([0-9]+)\.1\.", r"bn_conv\1."),
        (r"^bn([1-5])\.", r"bn_conv\1."),
    ],
    "dgcnn_partseg": [
        (r"^(transform_net\.)conv([123])\.0\.", r"\1conv\2."),
        (r"^(transform_net\.)conv([123])\.1\.", r"\1bn_conv\2."),
        (r"^(transform_net\.)bn([12])\.", r"\1bn_conv\2."),
        (r"^conv7\.0\.", "conv7."),
        (r"^conv7\.1\.", "bn7."),
        (r"^conv([0-9]+)\.0\.", r"conv\1."),
        (r"^conv([0-9]+)\.1\.", r"bn_conv\1."),
        # bn7 is the label-branch BN and keeps its name; the rest follow
        # the bn_convX convention
        (r"^bn(1|2|3|4|5|6|8|9|10)\.", r"bn_conv\1."),
    ],
    # BiPointNet (LSR + ema-max exports): torch wraps pointwise convs as
    # Conv1d(.lin) with separately-registered BNs; our _ConvBNHt nests
    # lin/bn (FP first convs nest one level deeper through _FPLinear).
    # Order matters: BN renames run before the fc-weight renames so the
    # fcX.bn paths they create are not rewritten again.
    "bipointnet_cls": [
        (r"(^|\.)(stn|fstn)\.bn1\.", r"\1\2.conv1.bn."),
        (r"(^|\.)(stn|fstn)\.bn2\.", r"\1\2.conv2.bn."),
        (r"(^|\.)(stn|fstn)\.bn3\.", r"\1\2.conv3_bn."),
        (r"(^|\.)(stn|fstn)\.bn4\.", r"\1\2.fc1.bn."),
        (r"(^|\.)(stn|fstn)\.bn5\.", r"\1\2.fc2.bn."),
        (r"(^|\.)stn\.conv1\.lin\.", r"\1stn.conv1.lin.lin."),
        (r"(^|\.)fstn\.conv1\.lin\.", r"\1fstn.conv1.lin."),
        (r"(^|\.)(stn|fstn)\.conv2\.lin\.", r"\1\2.conv2.lin."),
        (r"(^|\.)(stn|fstn)\.conv3\.lin\.", r"\1\2.conv3_lin."),
        (r"(^|\.)(stn|fstn)\.fc([12])\.(weight|scale)$", r"\1\2.fc\3.lin.\4"),
        (r"^feat\.bn1\.", "feat.conv1.bn."),
        (r"^feat\.bn2\.", "feat.conv2.bn."),
        (r"^feat\.bn3\.", "feat.conv3_bn."),
        (r"^feat\.conv1\.lin\.", "feat.conv1.lin.lin."),
        (r"^feat\.conv2\.lin\.", "feat.conv2.lin."),
        (r"^feat\.conv3\.lin\.", "feat.conv3_lin."),
        (r"^bn1\.", "fc1.bn."),
        (r"^bn2\.", "fc2.bn."),
        (r"^fc([12])\.(weight|scale)$", r"fc\1.lin.\2"),
    ],
    "bipointnet_partseg": [
        (r"(^|\.)(stn|fstn)\.bn1\.", r"\1\2.conv1.bn."),
        (r"(^|\.)(stn|fstn)\.bn2\.", r"\1\2.conv2.bn."),
        (r"(^|\.)(stn|fstn)\.bn3\.", r"\1\2.conv3_bn."),
        (r"(^|\.)(stn|fstn)\.bn4\.", r"\1\2.fc1.bn."),
        (r"(^|\.)(stn|fstn)\.bn5\.", r"\1\2.fc2.bn."),
        (r"(^|\.)stn\.conv1\.lin\.", r"\1stn.conv1.lin.lin."),
        (r"(^|\.)fstn\.conv1\.lin\.", r"\1fstn.conv1.lin."),
        (r"(^|\.)(stn|fstn)\.conv2\.lin\.", r"\1\2.conv2.lin."),
        (r"(^|\.)(stn|fstn)\.conv3\.lin\.", r"\1\2.conv3_lin."),
        (r"(^|\.)(stn|fstn)\.fc([12])\.(weight|scale)$", r"\1\2.fc\3.lin.\4"),
        (r"^conv1\.lin\.", "conv1.lin.lin."),
        (r"^conv([2-4])\.lin\.", r"conv\1.lin."),
        (r"^conv5\.lin\.", "conv5_lin."),
        (r"^bn([1-4])\.", r"conv\1.bn."),
        (r"^bn5\.", "conv5_bn."),
        (r"^convs([1-3])\.lin\.", r"convs\1.lin."),
        (r"^convs4\.lin\.", "convs4."),
        (r"^bns([1-3])\.", r"convs\1.bn."),
    ],
    # standalone torch VNLinear modules wrap the weight as .map_to_feat;
    # our standalone VNLinear stores the kernel directly
    "vn_pointnet_cls": [
        (r"^feat\.conv3\.map_to_feat\.", "feat.conv3."),
        (r"^feat\.fstn\.fc3\.map_to_feat\.", "feat.fstn.fc3."),
    ],
    "vn_pointnet_partseg": [
        (r"^conv5\.map_to_feat\.", "conv5."),
        (r"^fstn\.fc3\.map_to_feat\.", "fstn.fc3."),
    ],
}

# VN layers: torch nn.Linear submodules inside VN wrappers keep their names
# (map_to_feat/map_to_dir/vn_lin); our VNLinear stores the kernel directly,
# so `<name>.weight` -> `<name>.kernel`(T) falls out of the generic rule.
#
# VN flatten-order fixups: the reference flattens invariant read-outs from
# channels-first (B, C, 3, N) as c-major/i-minor; our channels-last layout
# flattens i-major/c-minor. Linears that consume such flattened features
# get their input rows permuted per block below.


def _vn_flat_perm(C: int) -> np.ndarray:
    """perm such that new_rows[i*C + c] = old_rows[c*3 + i]."""
    p = np.empty(3 * C, dtype=np.int64)
    for i in range(3):
        for c in range(C):
            p[i * C + c] = c * 3 + i
    return p


def _permute_rows(params: dict, path: list, blocks) -> None:
    """Permute kernel input rows blockwise: blocks = [(offset, C_or_None)].

    C given -> apply _vn_flat_perm within [offset, offset+3C); None -> leave.
    """
    node = params
    for seg in path[:-1]:
        node = node[seg]
    w = np.asarray(node[path[-1]])
    perm = np.arange(w.shape[0])
    for offset, C in blocks:
        if C is not None:
            perm[offset : offset + 3 * C] = offset + _vn_flat_perm(C)
    node[path[-1]] = w[perm, :]


def _post_vn_dgcnn_cls(params: dict) -> None:
    C = (1024 // 3) * 2  # 682 invariant channels per pool half
    _permute_rows(params, ["linear1", "kernel"], [(0, C), (3 * C, C)])


def _post_vn_pointnet_cls(params: dict) -> None:
    C = (1024 // 3) * 2
    _permute_rows(params, ["fc1", "kernel"], [(0, C)])


def _post_vn_dgcnn_partseg(params: dict) -> None:
    C_std = (1024 // 3) * 2  # 682: x read-out
    C_123 = (64 // 3) * 3  # 63: projected skip features
    _permute_rows(
        params, ["conv8", "kernel"],
        [(0, C_std), (3 * C_std + 64, C_123)],
    )


def _post_vn_pointnet_partseg(params: dict) -> None:
    C_std = (2048 // 3) * 2  # 1364
    C_1234 = 64 // 3 + 128 // 3 + 128 // 3 + 512 // 3  # 275
    off = 3 * C_std + 16
    _permute_rows(
        params, ["convs1", "kernel"],
        [(0, C_std), (off, C_1234), (off + 3 * C_1234, C_std)],
    )


POST_HOOKS = {
    "vn_dgcnn_cls": _post_vn_dgcnn_cls,
    "vn_pointnet_cls": _post_vn_pointnet_cls,
    "vn_dgcnn_partseg": _post_vn_dgcnn_partseg,
    "vn_pointnet_partseg": _post_vn_pointnet_partseg,
}


def _strip_module(key: str) -> str:
    return key[len("module."):] if key.startswith("module.") else key


def _apply_rules(key: str, rules) -> str:
    for pat, rep in rules:
        key = re.sub(pat, rep, key)
    return key


def _nest(tree: dict, path, leaf):
    node = tree
    for seg in path[:-1]:
        node = node.setdefault(seg, {})
    node[path[-1]] = leaf


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _tensors(tree: dict) -> dict:
    return {n: _tensors(v) if isinstance(v, dict)
            else torch.tensor(np.asarray(v, dtype=np.float32))
            for n, v in tree.items()}


def convert_state_dict(state_dict: Mapping, model: str = "sv_dgcnn_cls"
                       ) -> Dict[str, dict]:
    """A reference state_dict (tensors or numpy arrays) -> the port's weight
    tree ``{'params', 'batch_stats'}`` of float32 CPU tensors, keyed like
    flax's; the rules are the module docstring's."""
    rules = _COMMON_RULES + MODEL_RULES.get(model, [])
    sd = {_apply_rules(_strip_module(k), rules): _numpy(v)
          for k, v in state_dict.items()}

    # group by module path to find the batchnorm modules
    modules: Dict[str, Dict[str, np.ndarray]] = {}
    for k, v in sd.items():
        path, _, leaf = k.rpartition(".")
        modules.setdefault(path, {})[leaf] = v

    params: dict = {}
    batch_stats: dict = {}
    for path, leaves in modules.items():
        segs = path.split(".") if path else []
        if "running_mean" in leaves:  # batchnorm module
            if not segs or segs[-1] != "bn":
                segs = segs + ["bn"]
            if "weight" in leaves:
                _nest(params, segs + ["scale"], leaves["weight"])
            if "bias" in leaves:
                _nest(params, segs + ["bias"], leaves["bias"])
            _nest(batch_stats, segs + ["mean"], leaves["running_mean"])
            _nest(batch_stats, segs + ["var"], leaves["running_var"])
            continue
        for leaf, v in leaves.items():
            if leaf == "num_batches_tracked":
                continue
            if leaf == "weight":
                if v.ndim == 4:  # 1x1 Conv2d (out, in, 1, 1)
                    v = v[:, :, 0, 0]
                elif v.ndim == 3:  # 1x1 Conv1d (out, in, 1)
                    v = v[:, :, 0]
                if v.ndim == 2:
                    v = v.T  # (out, in) -> (in, out)
                _nest(params, segs + ["kernel"], v)
            elif leaf in ("beta", "scale"):
                # BiLinearLSR's scale is a 0-dim scalar; keep its shape
                _nest(params, segs + [leaf], v.reshape(-1) if v.ndim else v)
            elif leaf == "bias":
                _nest(params, segs + ["bias"], v)
            else:  # unknown leaf: keep under its own name
                _nest(params, segs + [leaf], v)
    hook = POST_HOOKS.get(model)
    if hook is not None:
        hook(params)
    return {"params": _tensors(params), "batch_stats": _tensors(batch_stats)}


def load_pth(path: str, model: str = "sv_dgcnn_cls") -> Dict[str, dict]:
    """Read a reference .pth checkpoint (on the CPU: its ``state_dict``, or
    the file's dict itself) and convert it."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return convert_state_dict(ckpt.get("state_dict", ckpt), model=model)


def convert_file(pth_path: str, out_path: str, model: str) -> None:
    """Convert a reference .pth checkpoint into the port's checkpoint
    payload (train/checkpoint.py), which ``--test`` reads."""
    payload = {"epoch": 0, **load_pth(pth_path, model=model),
               "best_metric": 0.0}
    torch.save(payload, out_path)


def main(argv=None):
    """python -m svnet_tpu_torch.utils.convert PTH OUT --model NAME"""
    import argparse

    ap = argparse.ArgumentParser(
        description="Convert a reference .pth checkpoint to the port's "
                    "checkpoint")
    ap.add_argument("pth")
    ap.add_argument("out")
    ap.add_argument("--model", default="sv_dgcnn_cls",
                    choices=sorted(MODEL_RULES))
    args = ap.parse_args(argv)
    convert_file(args.pth, args.out, args.model)
    print(f"wrote {args.out}")


def check_structure(converted: dict, reference: dict) -> Tuple[list, list, list]:
    """Compare a converted tree against a port model's tree (e.g.
    ``module_tree(model)``): (missing, unexpected, shape mismatches), each a
    list of paths."""
    got = {tuple(k.split(".")): tuple(np.shape(_numpy(v)))
           for k, v in flatten(converted).items()}
    want = {tuple(k.split(".")): tuple(np.shape(_numpy(v)))
            for k, v in flatten(reference).items()}
    missing = sorted("/".join(p) for p in want.keys() - got.keys())
    unexpected = sorted("/".join(p) for p in got.keys() - want.keys())
    mismatched = sorted("/".join(p) + f": {got[p]} vs {want[p]}"
                        for p in got.keys() & want.keys() if got[p] != want[p])
    return missing, unexpected, mismatched


if __name__ == "__main__":
    main()
