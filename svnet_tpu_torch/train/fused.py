"""Fused train-mode forward of SV-DGCNN classification (counterpart of
svnet_tpu/train/fused.py::make_fused_train_apply, cls, train knobs off).

``apply(params, batch_stats, points, generator=None) -> (logits,
new_batch_stats)`` is the train-mode forward of the model on the flax
trees: kNN (kernel B4 on the card) for the xyz graph and each conv round,
the fused first round (B5) and the three fused conv rounds (B6) as
``torch.autograd.Function``s, and everything after them -- conv5, SVFuse,
the pooling and the head -- as plain torch with autograd, the twins of
the flax layers below. BatchNorm normalizes with biased batch statistics
and returns running statistics moved by ``1 - BN_MOM`` toward them.

The k-max pool's gradient goes to the FIRST argmax rank (the JAX fused
path's documented choice; the flax path splits it among exact ties).
"""

from __future__ import annotations

import torch

from svnet_tpu_torch.config import BN_EPS, EPS
from svnet_tpu_torch.nn.sv_layers import ste_sign
from svnet_tpu_torch.ops.knn import knn, knn_plain
from svnet_tpu_torch.ops.kernels import sv_first_train as kf
from svnet_tpu_torch.ops.kernels import sv_round3_train as kr

BN_MOM = 0.9
# (S_in, V_in, S_out, V_out) of the fused conv rounds of SV_DGCNN_CLS
ROUNDS = {
    "conv2": (64 // 2, 64 // 6, 64 // 2, 64 // 6),
    "conv3": (64 // 2, 64 // 6, 128 // 2, 128 // 6),
    "conv4": (128 // 2, 128 // 6, 256 // 2, 256 // 6),
}
SUB = ("v2s", "linear1", "bn1", "linear2", "bn2")


def _stats_update(st: dict, mu: torch.Tensor, var: torch.Tensor) -> dict:
    return {"mean": BN_MOM * st["mean"] + (1 - BN_MOM) * mu.detach(),
            "var": BN_MOM * st["var"] + (1 - BN_MOM) * var.detach()}


def _bn_train(p: dict, st: dict, x: torch.Tensor):
    """BatchNorm over all leading axes with biased batch statistics;
    returns (y, new running stats)."""
    red = tuple(range(x.dim() - 1))
    mu = x.mean(dim=red)
    var = torch.clamp((x * x).mean(dim=red) - mu * mu, min=0.0)
    y = (x - mu) * (1.0 / torch.sqrt(var + BN_EPS)) * p["scale"] + p["bias"]
    return y, _stats_update(st, mu, var)


def _linear_train(p: dict, x: torch.Tensor, bw: bool, ba: bool) -> torch.Tensor:
    if not (bw or ba):
        y = x @ p["kernel"]
    else:
        if ba:
            x = ste_sign(x + p["beta"])
        w = ste_sign(p["kernel"]) if bw else p["kernel"]
        y = (x @ w) * p["scale"]
    return y + p["bias"] if "bias" in p else y


def _v2s_train(p: dict, v: torch.Tensor) -> torch.Tensor:
    """Vector2Scalar; its frame is binarized iff the layer has a scale."""
    lp = p["linear"]
    z = v @ (ste_sign(lp["kernel"]) if "scale" in lp else lp["kernel"])
    if "scale" in lp:
        z = z * lp["scale"]
    s = sum(v[..., i, :, None] * z[..., i, None, :] for i in range(3))
    return s.reshape(s.shape[:-2] + (-1,))


def _vector_bn_train(p: dict, st: dict, v: torch.Tensor):
    nsq = torch.clamp(torch.sum(v * v, dim=-2), min=1e-12)
    norm = torch.sqrt(nsq) + EPS
    nbn, new = _bn_train(p["bn"], st["bn"], norm)
    return v / norm[..., None, :] * nbn[..., None, :], {"bn": new}


def _gate(p: dict, s_mean: torch.Tensor) -> torch.Tensor:
    g = torch.relu(s_mean @ p["gate_fc1"]["kernel"])
    return torch.sigmoid(g @ p["gate_fc2"]["kernel"])


def _svblock_train(p: dict, st: dict, x, binary: bool):
    """SVBlock in train mode on per-point features (conv5)."""
    s, v = x
    B = s.shape[0]
    g = _gate(p, torch.mean(s.reshape(B, -1, s.shape[-1]), dim=1))
    g = g.reshape((B,) + (1,) * (v.dim() - 2) + (g.shape[-1],))
    s = torch.cat([s, _v2s_train(p["v2s"], v)], dim=-1)
    s, new1 = _bn_train(p["bn1"]["bn"], st["bn1"]["bn"],
                        _linear_train(p["linear1"], s, binary, binary))
    s = torch.nn.functional.leaky_relu(s, 0.2)
    v, new2 = _vector_bn_train(p["bn2"], st["bn2"],
                               _linear_train(p["linear2"], v, binary, False))
    return (s, v * g), {"bn1": {"bn": new1}, "bn2": new2}


def _dropout(x: torch.Tensor, rate: float, generator: torch.Generator):
    keep = torch.rand(x.shape, generator=generator).to(x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


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
    if oracle:
        nn_ids = knn_plain
        first_ops = (kr.train_fwd_plain, kr.train_bwd_plain)
        round_ops = first_ops
    else:
        nn_ids = knn
        first_ops = (kf.sv_first_train_fwd, kf.sv_first_train_bwd)
        round_ops = (kr.sv_round3_train_fwd, kr.sv_round3_train_bwd)
    S1, V1 = ROUNDS["conv2"][0], ROUNDS["conv2"][1]
    d_first = kf.first_dims(S1, V1, k)
    d_rounds = {name: kr.RoundDims(S, V, So, Vo, k, binary)
                for name, (S, V, So, Vo) in ROUNDS.items()}

    def apply(params, batch_stats, points, generator=None):
        p, bs = params, batch_stats
        B, N = points.shape[0], points.shape[1]
        new = {}
        idx0 = nn_ids(points.detach(), k)
        sub1 = {"init_scalar": p["init_scalar"], **{n: p["conv1"][n] for n in SUB}}
        s1, v1, s_mean1, (mu1, var1, mun1, varn1) = kr.fused_round_apply(
            first_ops, d_first, points.contiguous(), idx0, sub1)
        x1 = (s1, v1.reshape(B, N, 3, V1) * _gate(p["conv1"], s_mean1)[:, None, None, :])
        new["conv1"] = {
            "bn1": {"bn": _stats_update(bs["conv1"]["bn1"]["bn"], mu1, var1)},
            "bn2": {"bn": _stats_update(bs["conv1"]["bn2"]["bn"], mun1, varn1)}}
        outs = [x1]
        for name, d in d_rounds.items():
            s_in, v_in = outs[-1]
            joint = torch.cat([s_in, v_in.reshape(B, N, -1)], dim=-1)
            idx = nn_ids(joint.detach(), k)
            so, vo, s_mean, (mu, var, mun, varn) = kr.fused_round_apply(
                round_ops, d, joint, idx, {n: p[name][n] for n in SUB})
            vo = vo.reshape(B, N, 3, d.V_out) * _gate(p[name], s_mean)[:, None, None, :]
            new[name] = {
                "bn1": {"bn": _stats_update(bs[name]["bn1"]["bn"], mu, var)},
                "bn2": {"bn": _stats_update(bs[name]["bn2"]["bn"], mun, varn)}}
            outs.append((so, vo))

        s_c = torch.cat([o[0] for o in outs], dim=-1)
        v_c = torch.cat([o[1] for o in outs], dim=-1)
        (s5, v5), new["conv5"] = _svblock_train(p["conv5"], bs["conv5"],
                                                (s_c, v_c), binary)
        x = torch.cat([s5, _v2s_train(p["svfuse"]["v2s"], v5)], dim=-1)
        x = torch.cat([torch.amax(x, dim=1), torch.mean(x, dim=1)], dim=-1)
        drop = (not binary) and generator is not None and dropout > 0.0
        lrelu = torch.nn.functional.leaky_relu
        for i, name in enumerate(("linear1", "linear2")):
            x, n_st = _bn_train(p[f"bn{i + 1}"]["bn"], bs[f"bn{i + 1}"]["bn"],
                                _linear_train(p[name], x, binary, binary))
            new[f"bn{i + 1}"] = {"bn": n_st}
            x = lrelu(x, 0.2)
            if drop:
                x = _dropout(x, dropout, generator)
        return _linear_train(p["linear3"], x, False, False), new

    return apply
