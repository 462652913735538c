"""Fused eval engine for SV-DGCNN classification, exact mode (counterpart
of svnet_tpu/infer.py:227-412, the round3 path).

Activations stay channel-major (B, C, N) between rounds:

  sv_round3_first -> gate -> sv_round3 x3 (conv2..conv4, gate after each)
  -> sv_point_block_cm (conv5 + SVFuse) -> max+mean pool -> head

The SE gates and the head run as plain tensor code on the host side of the
kernels, as in the JAX engine. On a CUDA device every fused stage launches
its kernel; on the CPU the kernels' plain versions run.
"""

from __future__ import annotations

from typing import Dict

import torch

from svnet_tpu_torch import config
from svnet_tpu_torch.config import BN_EPS
from svnet_tpu_torch.nn.sv_layers import binary_matmul
from svnet_tpu_torch.ops.kernels.fold import (
    fold_first_params,
    fold_point_params,
    fold_svblock_params,
    head_perm,
)
from svnet_tpu_torch.ops.kernels.sv_point import (
    sv_point_block_cm,
    sv_point_block_cm_plain,
)
from svnet_tpu_torch.ops.kernels.sv_round3 import (
    sv_round3,
    sv_round3_first,
    sv_round3_first_plain,
    sv_round3_plain,
)

# (S_in, V_in, S_out, V_out) per fused conv round of SV_DGCNN_CLS
ROUNDS = {
    "conv2": (64 // 2, 64 // 6, 64 // 2, 64 // 6),
    "conv3": (64 // 2, 64 // 6, 128 // 2, 128 // 6),
    "conv4": (128 // 2, 128 // 6, 256 // 2, 256 // 6),
}


def _point_v_off() -> tuple:
    """(row offset, V_r) of each round's j-major vector block in the
    conv5 input [s (256) | v1 | v2 | v3 | v4]."""
    v_off, o = [], 256
    for Vr in (64 // 6, 64 // 6, 128 // 6, 256 // 6):
        v_off.append((o, Vr))
        o += 3 * Vr
    return tuple(v_off)


POINT_V_OFF = _point_v_off()


def _to(tree, device):
    return {n: _to(v, device) if isinstance(v, dict)
            else v.to(device=device, dtype=torch.float32).contiguous()
            for n, v in tree.items()}


def _contig(folded: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: t.contiguous() for n, t in folded.items()}


def _bn_eval(p: dict, st: dict, x: torch.Tensor) -> torch.Tensor:
    inv = p["scale"] / torch.sqrt(st["var"] + BN_EPS)
    return x * inv + (p["bias"] - st["mean"] * inv)


def _linear_eval(p: dict, x: torch.Tensor, bw: bool, ba: bool) -> torch.Tensor:
    if not (bw or ba):
        y = x @ p["kernel"]
    else:
        if ba:
            x = torch.sign(x + p["beta"])
        w = torch.sign(p["kernel"]) if bw else p["kernel"]
        y = (binary_matmul(x, w) if bw and ba else x @ w) * p["scale"]
    return y + p["bias"] if "bias" in p else y


def se_gate(p: dict, s_mean: torch.Tensor) -> torch.Tensor:
    """SVBlock's SE gate from the mean input scalars: (B, S) -> (B, V_out)."""
    g = torch.relu(s_mean @ p["gate_fc1"]["kernel"])
    return torch.sigmoid(g @ p["gate_fc2"]["kernel"])


class SVDGCNNClsEngine:
    """Build from a weight tree ({'params', 'batch_stats'}, e.g. from
    ``init_params`` or ``utils.convert.from_flax``); call on (B, N, 3)
    float32 points on ``device``.

    ``oracle=True`` runs the kernels' plain PyTorch versions in their place
    on any device: the reference the kernel path is held against on the
    card (chip_smoke.py). It is never chosen for the caller."""

    def __init__(self, weights: dict, num_classes: int = 40, k: int = 20,
                 binary: bool = True, mode: str = "exact", device="cpu",
                 oracle: bool = False):
        self.mode = config.check_mode(mode)
        if oracle:
            self._first, self._round, self._point = (
                sv_round3_first_plain, sv_round3_plain, sv_point_block_cm_plain)
        else:
            self._first, self._round, self._point = (
                sv_round3_first, sv_round3, sv_point_block_cm)
        self.device = torch.device(device)
        if self.device.type == "cuda":
            self.device = config.require_cuda(self.device)
            # full-f32 matmuls: TF32 would flip binarization signs (C7)
            config.set_full_fp32()
        self.num_classes, self.k, self.binary = num_classes, k, binary
        p = self.p = _to(weights["params"], self.device)
        bs = self.bs = _to(weights["batch_stats"], self.device)
        self.folded = {
            name: _contig(fold_svblock_params(p[name], bs[name], S, V, binary))
            for name, (S, V, _, _) in ROUNDS.items()
        }
        self.folded_first = _contig(
            fold_first_params(p["init_scalar"], p["conv1"], bs["conv1"]))
        # conv5 + svfuse tail: S_c = 256, V_c = 83 -> (512, 170)
        self.folded_point = _contig(fold_point_params(
            p["conv5"], bs["conv5"], p["svfuse"], S=256, V=83, binary=binary))
        # the tail emits SVFuse channels j-major; permute the head's first
        # linear (and its beta) to consume that layout
        perm = head_perm(1024 // 2, 1024 // 6).to(self.device)
        h1 = dict(p["linear1"])
        h1["kernel"] = h1["kernel"][perm, :]
        if "beta" in h1:
            h1["beta"] = h1["beta"][perm]
        self.head1 = h1

    def _trunk(self, points: torch.Tensor):
        """Returns s_cm (B, 256, N) and v_cm (B, 249, N), the latter as
        per-round j-major blocks, each round's v gated."""
        p, k = self.p, self.k
        s1, v1, s_mean = self._first(
            points, self.folded_first, S_out=64 // 2, V_out=64 // 6, k=k)[:3]
        v1 = v1 * se_gate(p["conv1"], s_mean).repeat(1, 3)[:, :, None]
        outs = [(s1, v1)]
        for name, (S, V, S_out, V_out) in ROUNDS.items():
            joint = torch.cat(outs[-1], dim=1)  # (B, S + 3V, N)
            so, vo, se_mean = self._round(
                joint, self.folded[name], S=S, V=V, S_out=S_out,
                V_out=V_out, k=k, binary=self.binary)[:3]
            vo = vo * se_gate(p[name], se_mean).repeat(1, 3)[:, :, None]
            outs.append((so, vo))
        return (torch.cat([o[0] for o in outs], dim=1),
                torch.cat([o[1] for o in outs], dim=1))

    def _tail(self, s_cm: torch.Tensor, v_cm: torch.Tensor) -> torch.Tensor:
        p, bs = self.p, self.bs
        g5 = se_gate(p["conv5"], torch.mean(s_cm, dim=2))  # (B, 170)
        x, _, _ = self._point(
            torch.cat([s_cm, v_cm], dim=1), g5, self.folded_point,
            S=256, V=83, S_out=512, V_out=170, v_off=POINT_V_OFF,
            binary=self.binary)  # (B, 1022, N), SVFuse channels j-major
        x = torch.cat([torch.amax(x, dim=2), torch.mean(x, dim=2)], dim=-1)
        lrelu = torch.nn.functional.leaky_relu
        x = _linear_eval(self.head1, x, self.binary, self.binary)
        x = lrelu(_bn_eval(p["bn1"]["bn"], bs["bn1"]["bn"], x), 0.2)
        x = _linear_eval(p["linear2"], x, self.binary, self.binary)
        x = lrelu(_bn_eval(p["bn2"]["bn"], bs["bn2"]["bn"], x), 0.2)
        return _linear_eval(p["linear3"], x, False, False)

    @torch.no_grad()
    def __call__(self, points: torch.Tensor) -> torch.Tensor:
        """(B, N, 3) float32 points -> (B, num_classes) logits."""
        if points.device != self.device or points.dtype != torch.float32:
            raise ValueError(
                f"points must be float32 on {self.device}, got "
                f"{points.dtype} on {points.device}")
        return self._tail(*self._trunk(points.contiguous()))
