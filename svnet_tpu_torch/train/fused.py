"""Fused train-mode forwards of SV-DGCNN classification and part
segmentation (counterpart of svnet_tpu/train/fused.py::
make_fused_train_apply and make_fused_train_apply_pseg, train knobs off).

``apply(params, batch_stats, points, [label,] generator=None) ->
(logits, new_batch_stats)`` is the train-mode forward of the model on the
flax trees: kNN (kernel B4 on the card) for the xyz graph and each conv
round, the fused first round (B5) and the three fused conv rounds (B6) as
``torch.autograd.Function``s, and everything after them -- conv5, the
SVFuse taps, the pooling, the label branch and the head -- as plain torch
with autograd, the twins of the flax layers (``nn/sv_train.py``).
BatchNorm normalizes with biased batch statistics and returns running
statistics moved by ``1 - BN_MOM`` toward them.

The k-max pool's gradient goes to the FIRST argmax rank (the JAX fused
path's documented choice; the flax path splits it among exact ties).
"""

from __future__ import annotations

import torch

from svnet_tpu_torch.models.sv_dgcnn import PSEG_DIMS
from svnet_tpu_torch.nn import sv_train as svt
from svnet_tpu_torch.ops.graph import svpool
from svnet_tpu_torch.ops.knn import knn, knn_plain
from svnet_tpu_torch.ops.kernels import sv_first_train as kf
from svnet_tpu_torch.ops.kernels import sv_round3_train as kr

# (S_in, V_in, S_out, V_out) of the fused conv rounds of SV_DGCNN_CLS
ROUNDS = {
    "conv2": (64 // 2, 64 // 6, 64 // 2, 64 // 6),
    "conv3": (64 // 2, 64 // 6, 128 // 2, 128 // 6),
    "conv4": (128 // 2, 128 // 6, 256 // 2, 256 // 6),
}
# and of SV_DGCNN_PSEG, at its make_divisible widths
PSEG_ROUNDS = {name: (*PSEG_DIMS[prev], *PSEG_DIMS[name]) for prev, name in
               (("conv1", "conv2"), ("conv2", "conv3"), ("conv3", "conv4"))}
SUB = ("v2s", "linear1", "bn1", "linear2", "bn2")


def make_trunk(rounds: dict, k: int, binary: bool, oracle: bool):
    """``trunk(params, batch_stats, points) -> (outs, new)``: kNN of the
    points, the fused first round (B5) to the first round's widths
    ``rounds["conv2"][:2]``, then kNN of each round's joint [s, flat(v)]
    and the fused conv round (B6) of ``rounds``. ``outs`` holds the four
    rounds' gated (s, v); ``new`` their new running statistics."""
    if oracle:
        nn_ids = knn_plain
        first_ops = (kr.train_fwd_plain, kr.train_bwd_plain)
        round_ops = first_ops
    else:
        nn_ids = knn
        first_ops = (kf.sv_first_train_fwd, kf.sv_first_train_bwd)
        round_ops = (kr.sv_round3_train_fwd, kr.sv_round3_train_bwd)
    S1, V1 = rounds["conv2"][0], rounds["conv2"][1]
    d_first = kf.first_dims(S1, V1, k)
    d_rounds = {name: kr.RoundDims(S, V, So, Vo, k, binary)
                for name, (S, V, So, Vo) in rounds.items()}

    def stats(st, mu, var, mun, varn):
        return {"bn1": {"bn": svt.stats_update(st["bn1"]["bn"], mu, var)},
                "bn2": {"bn": svt.stats_update(st["bn2"]["bn"], mun, varn)}}

    def trunk(p, bs, points):
        B, N = points.shape[0], points.shape[1]
        idx0 = nn_ids(points.detach(), k)
        sub1 = {"init_scalar": p["init_scalar"], **{n: p["conv1"][n] for n in SUB}}
        s1, v1, s_mean1, st1 = kr.fused_round_apply(
            first_ops, d_first, points.contiguous(), idx0, sub1)
        x1 = (s1, v1.reshape(B, N, 3, V1)
              * svt.gate(p["conv1"], s_mean1)[:, None, None, :])
        new = {"conv1": stats(bs["conv1"], *st1)}
        outs = [x1]
        for name, d in d_rounds.items():
            s_in, v_in = outs[-1]
            joint = torch.cat([s_in, v_in.reshape(B, N, -1)], dim=-1)
            idx = nn_ids(joint.detach(), k)
            so, vo, s_mean, st = kr.fused_round_apply(
                round_ops, d, joint, idx, {n: p[name][n] for n in SUB})
            vo = (vo.reshape(B, N, 3, d.V_out)
                  * svt.gate(p[name], s_mean)[:, None, None, :])
            new[name] = stats(bs[name], *st)
            outs.append((so, vo))
        return outs, new

    return trunk


def make_fused_train_apply(num_classes: int, k: int, binary: bool = True,
                           dropout: float = 0.5, oracle: bool = False):
    """Returns ``apply(params, batch_stats, points, generator=None) ->
    (logits, new_batch_stats)``. The FP model's head dropout draws from
    ``generator`` when one is given (none: no dropout); the binary model
    has none. Knob-aware training is not ported (the CLI's
    ``--train-knobs`` raises). ``oracle=True`` runs the kernels' plain
    versions on any device: the reference the kernel path is held against
    on the card (chip_smoke.py). It is never chosen for the caller."""
    del num_classes  # the head's width comes from the weights
    trunk = make_trunk(ROUNDS, k, binary, oracle)

    def apply(params, batch_stats, points, generator=None):
        outs, new = trunk(params, batch_stats, points)
        return tail(params, batch_stats, new, outs, binary, dropout, generator)

    return apply


def make_fused_train_apply_pseg(num_part: int, k: int, binary: bool = True,
                                dropout: float = 0.5, oracle: bool = False):
    """Returns ``apply(params, batch_stats, points, label, generator=None)
    -> (logits (B, N, num_part), new_batch_stats)``, the train-mode forward
    of SV_DGCNN_PSEG (counterpart of
    svnet_tpu/train/fused.py::make_fused_train_apply_pseg): the trunk of
    ``make_trunk`` at PSEG_ROUNDS, then ``tail_pseg``. ``label`` is the
    (B, 16) one-hot category. Dropout and ``oracle`` as in
    ``make_fused_train_apply``: the FP head's dropout after conv8 and
    conv9 draws from ``generator``."""
    del num_part  # the head's width comes from the weights
    trunk = make_trunk(PSEG_ROUNDS, k, binary, oracle)

    def apply(params, batch_stats, points, label, generator=None):
        outs, new = trunk(params, batch_stats, points)
        return tail_pseg(params, batch_stats, new, outs, label, binary, dropout,
                         generator)

    return apply


def tail(p, bs, new, outs, binary, dropout, generator):
    """After the four rounds: conv5 on their concatenated (s, v), SVFuse,
    max and mean over the points, the head. ``new`` collects the running
    statistics; returns (logits, new)."""
    s_c = torch.cat([o[0] for o in outs], dim=-1)
    v_c = torch.cat([o[1] for o in outs], dim=-1)
    (s5, v5), new["conv5"] = svt.svblock_train(p["conv5"], bs["conv5"],
                                               (s_c, v_c), binary)
    x = torch.cat([s5, svt.v2s_train(p["svfuse"]["v2s"], v5)], dim=-1)
    x = torch.cat([torch.amax(x, dim=1), torch.mean(x, dim=1)], dim=-1)
    drop = (not binary) and generator is not None and dropout > 0.0
    for i, name in enumerate(("linear1", "linear2")):
        x, n_st = svt.bn_train(p[f"bn{i + 1}"]["bn"], bs[f"bn{i + 1}"]["bn"],
                               svt.linear_train(p[name], x, binary, binary))
        new[f"bn{i + 1}"] = {"bn": n_st}
        x = svt.leaky(x)
        if drop:
            x = svt.dropout(x, dropout, generator)
    return svt.linear_train(p["linear3"], x, False, False), new


def tail_pseg(p, bs, new, outs, label, binary, dropout, generator):
    """After the four rounds of SV_DGCNN_PSEG: the per-point fine features
    (svfuse1 on the rounds' concatenated (s, v)); conv5, pooled over the
    points, conv6 and svfuse2; svfuse3 on conv5, max over the points; the
    label branch conv7, bn7, leaky; then per point [max | pooled | label |
    fine] through conv8-10 (binarizable linear, BatchNorm, leaky) and the
    FP conv11. Returns (logits, new)."""
    B, N = outs[0][0].shape[:2]
    s_c = torch.cat([o[0] for o in outs], dim=-1)
    v_c = torch.cat([o[1] for o in outs], dim=-1)
    x_fine = torch.cat([s_c, svt.v2s_train(p["svfuse1"]["v2s"], v_c)], dim=-1)
    x5, new["conv5"] = svt.svblock_train(p["conv5"], bs["conv5"], (s_c, v_c),
                                         binary)
    (s6, v6), new["conv6"] = svt.svblock_train(
        p["conv6"], bs["conv6"], svpool(x5, dim=1, keepdim=True), binary)
    x_pool = torch.cat([s6, svt.v2s_train(p["svfuse2"]["v2s"], v6)], dim=-1)
    x_max = torch.amax(torch.cat(
        [x5[0], svt.v2s_train(p["svfuse3"]["v2s"], x5[1])], dim=-1),
        dim=1, keepdim=True)
    lab, n7 = svt.bn_train(p["bn7"]["bn"], bs["bn7"]["bn"],
                           svt.linear_train(p["conv7"], label, False, False))
    new["bn7"] = {"bn": n7}
    g = torch.cat([x_max, x_pool, svt.leaky(lab)[:, None, :]], dim=-1)
    x = torch.cat([g.expand(B, N, -1), x_fine], dim=-1)
    drop = (not binary) and generator is not None and dropout > 0.0
    for i, name in enumerate(("conv8", "conv9", "conv10")):
        x, n_st = svt.bn_train(p[name]["bn"], bs[name]["bn"],
                               svt.linear_train(p[name]["conv"], x, binary, binary))
        new[name] = {"bn": n_st}
        x = svt.leaky(x)
        if drop and i < 2:
            x = svt.dropout(x, dropout, generator)
    return svt.linear_train(p["conv11"], x, False, False), new
