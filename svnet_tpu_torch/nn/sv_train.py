"""SV layers in train mode, as functions of the flax-named weight trees
(counterparts of the ``train=True`` semantics of svnet_tpu/nn/sv_layers.py).

Each layer takes its parameter subtree ``p`` and, where it has BatchNorm,
its running-statistics subtree ``st``, and returns its output and the new
running statistics. BatchNorm normalizes over all leading axes with the
biased batch statistics and moves the running statistics by ``1 - BN_MOM``
toward them (flax ``momentum=0.9``; the unbiased variance of torch's own
BatchNorm is not used). Binarized layers sign through the straight-through
``ste_sign``. Used by the fused SV-DGCNN train forwards (train/fused.py)
and the SV-PointNet train forwards (train/pointnet.py).
"""

from __future__ import annotations

import torch

from svnet_tpu_torch.config import BN_EPS, EPS
from svnet_tpu_torch.nn.sv_layers import ste_sign
from svnet_tpu_torch.ops.graph import svpool

BN_MOM = 0.9


def stats_update(st: dict, mu: torch.Tensor, var: torch.Tensor) -> dict:
    return {"mean": BN_MOM * st["mean"] + (1 - BN_MOM) * mu.detach(),
            "var": BN_MOM * st["var"] + (1 - BN_MOM) * var.detach()}


def bn_train(p: dict, st: dict, x: torch.Tensor):
    """BatchNorm over all leading axes with biased batch statistics;
    returns (y, new running stats)."""
    red = tuple(range(x.dim() - 1))
    mu = x.mean(dim=red)
    var = torch.clamp((x * x).mean(dim=red) - mu * mu, min=0.0)
    y = (x - mu) * (1.0 / torch.sqrt(var + BN_EPS)) * p["scale"] + p["bias"]
    return y, stats_update(st, mu, var)


def linear_train(p: dict, x: torch.Tensor, bw: bool, ba: bool) -> torch.Tensor:
    if not (bw or ba):
        y = x @ p["kernel"]
    else:
        if ba:
            x = ste_sign(x + p["beta"])
        w = ste_sign(p["kernel"]) if bw else p["kernel"]
        y = (x @ w) * p["scale"]
    return y + p["bias"] if "bias" in p else y


def v2s_train(p: dict, v: torch.Tensor, trans_back: bool = False):
    """Vector2Scalar; its frame is binarized iff the layer has a scale.
    ``trans_back`` also returns the frame z (..., 3, multi), as
    ``SVFuse(trans_back=True)`` does."""
    lp = p["linear"]
    z = v @ (ste_sign(lp["kernel"]) if "scale" in lp else lp["kernel"])
    if "scale" in lp:
        z = z * lp["scale"]
    s = sum(v[..., i, :, None] * z[..., i, None, :] for i in range(3))
    s = s.reshape(s.shape[:-2] + (-1,))
    return (s, z) if trans_back else s


def vector_bn_train(p: dict, st: dict, v: torch.Tensor):
    nsq = torch.clamp(torch.sum(v * v, dim=-2), min=1e-12)
    norm = torch.sqrt(nsq) + EPS
    nbn, new = bn_train(p["bn"], st["bn"], norm)
    return v / norm[..., None, :] * nbn[..., None, :], {"bn": new}


def gate(p: dict, s_mean: torch.Tensor) -> torch.Tensor:
    g = torch.relu(s_mean @ p["gate_fc1"]["kernel"])
    return torch.sigmoid(g @ p["gate_fc2"]["kernel"])


def leaky(x: torch.Tensor) -> torch.Tensor:
    """Leaky ReLU, slope 0.2, as ``jax.nn.leaky_relu``: its gradient at
    exactly 0 is 1 (torch's ``leaky_relu`` gives 0.2 there). A binary
    layer's outputs take few distinct values, so a BatchNorm over a few
    samples puts exact zeros here."""
    return torch.where(x >= 0, x, 0.2 * x)


def svblock_train(p: dict, st: dict, x, binary: bool):
    """SVBlock in train mode on any leading axes (B, [N, [k,]]): the gate
    from the mean scalars over all but B, BatchNorm over all but the
    channels."""
    s, v = x
    B = s.shape[0]
    g = gate(p, torch.mean(s.reshape(B, -1, s.shape[-1]), dim=1))
    g = g.reshape((B,) + (1,) * (v.dim() - 2) + (g.shape[-1],))
    s = torch.cat([s, v2s_train(p["v2s"], v)], dim=-1)
    s, new1 = bn_train(p["bn1"]["bn"], st["bn1"]["bn"],
                       linear_train(p["linear1"], s, binary, binary))
    s = leaky(s)
    v, new2 = vector_bn_train(p["bn2"], st["bn2"],
                              linear_train(p["linear2"], v, binary, False))
    return (s, v * g), {"bn1": {"bn": new1}, "bn2": new2}


def stn_train(p: dict, st: dict, x, binary: bool):
    """SV_STNkd in train mode: three per-point blocks, a pool over the
    points (scalar max, vector mean), three blocks on the (B, .) token,
    whose BatchNorm reduces over B only. Returns the token and the new
    running statistics."""
    new = {}
    for name in ("conv1", "conv2", "conv3"):
        x, new[name] = svblock_train(p[name], st[name], x, binary)
    x = svpool(x, dim=1)
    for name in ("fc1", "fc2", "fc3"):
        x, new[name] = svblock_train(p[name], st[name], x, binary)
    return x, new


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator):
    keep = torch.rand(x.shape, generator=generator).to(x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
