"""Train-mode forwards of SV-PointNet classification and part
segmentation (counterparts of
``svnet_tpu/models/sv_pointnet.py::SV_PointNet_CLS.apply(..., train=True,
mutable=["batch_stats"])`` and of ``SV_PointNet_PSEG``'s, the flax path of
svnet_tpu/train/steps.py).

``apply(params, batch_stats, points, generator=None) -> (logits,
new_batch_stats)`` on the flax-named trees, the signature of
``train.fused.make_fused_train_apply``, so ``train.steps`` drives either.
One kNN graph over the coordinates (kernel B4 on the card) and one gather
of the neighbours (kernel B7, ``ops.kernels.edge_gather``) build the cross
edges; everything after them is torch with autograd through the train-mode
layers of ``nn/sv_train.py``: the FP conv_pos on the B*N*k edges (its
BatchNorm reduces over all of them), the pool over k, conv1, the SV_STNkd
token, conv2, conv3, the global-mean concat, conv_fuse, the pool over the
points, SVFuse and the head ``relu(bn1(fc1))``, ``relu(bn2(dropout(fc2)))``,
fc3 (the part segmenter: ``make_train_apply_pseg``). The pools are
``torch.amax``, whose gradient is split evenly among
tied entries, as JAX's ``max`` splits it.

The gradient is taken with respect to the weights only, as the JAX step
takes it: the points carry none, so the neighbour gather runs forward only
and its scatter-add backward is not needed on this path.
"""

from __future__ import annotations

import torch

from svnet_tpu_torch.nn import sv_train as svt
from svnet_tpu_torch.ops.graph import (
    get_graph_feature_cross,
    svcat,
    svexpand,
    svpool,
)


def make_train_apply_cls(num_classes: int, k: int, binary: bool,
                         dropout: float = 0.4, oracle: bool = False):
    """Returns ``apply(params, batch_stats, points, generator=None) ->
    (logits, new_batch_stats)`` of ``SV_PointNet_CLS`` in train mode. The
    FP model's head dropout (rate ``dropout``; flax fixes 0.4) draws from
    ``generator`` when one is given (none: no dropout); the binary model
    has none. ``oracle=True`` runs the kNN and the gather's plain versions
    on any device: the reference the kernel path is held against on the
    card (chip_smoke.py). It is never chosen for the caller."""
    del num_classes  # the head's width comes from the weights

    def apply(params, batch_stats, points, generator=None):
        p, bs = params["feat"], batch_stats["feat"]
        new = {}
        v = get_graph_feature_cross(points, k, plain=oracle)  # (B, N, k, 3, 3)
        x = (svt.v2s_train(p["init_scalar"], v), v)
        x, new["conv_pos"] = svt.svblock_train(p["conv_pos"], bs["conv_pos"],
                                               x, False)  # always FP
        x, new["conv1"] = svt.svblock_train(p["conv1"], bs["conv1"], svpool(x),
                                            binary)
        tok, new["fstn"] = svt.stn_train(p["fstn"], bs["fstn"], x, binary)
        x = svcat([x, svexpand((tok[0][:, None], tok[1][:, None]), x)])
        for name in ("conv2", "conv3"):
            x, new[name] = svt.svblock_train(p[name], bs[name], x, binary)
        x = svcat([x, svexpand(svpool(x, dim=1, keepdim=True), x)])
        x, new["conv_fuse"] = svt.svblock_train(p["conv_fuse"], bs["conv_fuse"],
                                                x, binary)
        s, v = svpool(x, dim=1)
        x = torch.cat([s, svt.v2s_train(p["svfuse"]["v2s"], v)], dim=-1)

        out = {"feat": new}
        x, out["bn1"] = _bn(params, batch_stats, "bn1",
                            svt.linear_train(params["fc1"], x, binary, binary))
        x = svt.linear_train(params["fc2"], torch.relu(x), binary, binary)
        if not binary and generator is not None and dropout > 0.0:
            x = svt.dropout(x, dropout, generator)
        x, out["bn2"] = _bn(params, batch_stats, "bn2", x)
        logits = svt.linear_train(params["fc3"], torch.relu(x), False, False)
        return logits, out

    return apply


def _bn(params, batch_stats, name, x):
    y, st = svt.bn_train(params[name]["bn"], batch_stats[name]["bn"], x)
    return y, {"bn": st}


def make_train_apply_pseg(num_part: int, k: int, binary: bool,
                          oracle: bool = False):
    """Returns ``apply(params, batch_stats, points, label, generator=None)
    -> (logits (B, N, num_part), new_batch_stats)`` of ``SV_PointNet_PSEG``
    in train mode; ``label`` is the (B, 16) one-hot category. The cross
    edges, conv_pos and the pool over k as in the classifier; conv1-3, the
    SV_STNkd token on conv3, conv4 and conv5; SVFuse with its frame on
    [conv5 | its mean over the points]; the conv_fuse bottleneck pooled
    over the points (mean when binary, max when FP) beside the label; the
    skip vectors of conv1-5 un-projected through the frame; convs1-3 and
    the FP convs4. The model has no dropout: ``generator`` is unused.
    ``oracle`` as in ``make_train_apply_cls``."""
    del num_part  # the head's width comes from the weights

    def apply(params, batch_stats, points, label, generator=None):
        p, bs, new = params, batch_stats, {}
        B, N = points.shape[:2]

        def block(name, x, blk_binary=binary):
            y, new[name] = svt.svblock_train(p[name], bs[name], x, blk_binary)
            return y

        def conv_bn_relu(name, x):
            y, new[f"{name}_bn"] = _bn(p, bs, f"{name}_bn", svt.linear_train(
                p[f"{name}_conv"], x, binary, binary))
            return torch.relu(y)

        v = get_graph_feature_cross(points, k, plain=oracle)  # (B, N, k, 3, 3)
        x = svpool(block("conv_pos", (svt.v2s_train(p["init_scalar"], v), v),
                         False))  # always FP
        out1 = block("conv1", x)
        out2 = block("conv2", out1)
        out3 = block("conv3", out2)
        tok, new["fstn"] = svt.stn_train(p["fstn"], bs["fstn"], out3, binary)
        out4 = block("conv4", svcat([out3, svexpand((tok[0][:, None],
                                                     tok[1][:, None]), out3)]))
        out5 = block("conv5", out4)
        s, v = svcat([out5, svexpand(svpool(out5, dim=1, keepdim=True,
                                            spool="mean"), out5)])
        sv, trans = svt.v2s_train(p["svfuse"]["v2s"], v, trans_back=True)
        x = conv_bn_relu("conv_fuse2", conv_bn_relu("conv_fuse1",
                                                    torch.cat([s, sv], dim=-1)))
        x = torch.mean(x, dim=1) if binary else torch.amax(x, dim=1)
        x_l = torch.cat([x, label], dim=-1)[:, None, :].expand(B, N, -1)
        cs, cv = svcat([out1, out2, out3, out4, out5])
        concat_v = torch.einsum("bnic,bnik->bnck", cv, trans).reshape(B, N, -1)
        net = torch.cat([x_l, cs, concat_v], dim=-1)
        for name in ("convs1", "convs2", "convs3"):
            net = conv_bn_relu(name, net)
        return svt.linear_train(p["convs4"], net, False, False), new

    return apply
