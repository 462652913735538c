"""Fused eval engines, exact mode: SV-DGCNN classification (counterpart of
svnet_tpu/infer.py:227-412, the round3 path) and SV-PointNet
classification and part segmentation (svnet_tpu/infer.py:857-1167).

SVDGCNNClsEngine keeps activations channel-major (B, C, N) between rounds:

  sv_round3_first -> gate -> sv_round3 x3 (conv2..conv4, gate after each)
  -> sv_point_block_cm (conv5 + SVFuse) -> max+mean pool -> head

The SV-PointNet engines run row-major (B, N, C) after the first round:

  sv_round3_first(cross=True) -> conv_pos gate -> sv_block_point per
  SVBlock (conv1.., the SV_STNkd trunk, conv_fuse / conv4-5) with the SE
  gate computed here -> the (B, 1) STN token blocks, pools, concats, SVFuse
  and the head (partseg: the frame un-projection and pointwise convs)

The SE gates, token path and heads run as plain tensor code on the host
side of the kernels, as in the JAX engines. On a CUDA device every fused
stage launches its kernel; on the CPU the kernels' plain versions run.
"""

from __future__ import annotations

from typing import Dict

import torch

from svnet_tpu_torch import config, ops
from svnet_tpu_torch.config import BN_EPS, EPS
from svnet_tpu_torch.nn.sv_layers import binary_matmul
from svnet_tpu_torch.ops.kernels.fold import (
    fold_first_params,
    fold_point_like_params,
    fold_point_params,
    fold_svblock_params,
    head_perm,
)
from svnet_tpu_torch.ops.kernels.sv_block_point import (
    sv_block_point,
    sv_block_point_plain,
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


def _v2s_eval(p: dict, v: torch.Tensor, bw: bool) -> torch.Tensor:
    """Vector2Scalar: v (..., 3, V) -> invariants (..., 3V) c-major."""
    z = _linear_eval(p["linear"], v, bw, False)
    s = torch.einsum("...ic,...ij->...cj", v, z)
    return s.reshape(s.shape[:-2] + (-1,))


def _vector_bn_eval(p: dict, st: dict, v: torch.Tensor) -> torch.Tensor:
    n = torch.sqrt(torch.sum(v * v, dim=-2)) + EPS
    nbn = _bn_eval(p["bn"], st["bn"], n)
    return v / n[..., None, :] * nbn[..., None, :]


def _svblock_eval(p: dict, st: dict, s: torch.Tensor, v: torch.Tensor,
                  binary: bool):
    """An SVBlock on the host (any layout, with or without a k axis)."""
    B = s.shape[0]
    g = se_gate(p, torch.mean(s.reshape(B, -1, s.shape[-1]), dim=1))
    g = g.reshape((B,) + (1,) * (v.ndim - 2) + (g.shape[-1],))
    s = torch.cat([s, _v2s_eval(p["v2s"], v, binary)], dim=-1)
    s = _bn_eval(p["bn1"]["bn"], st["bn1"]["bn"],
                 _linear_eval(p["linear1"], s, binary, binary))
    s = torch.nn.functional.leaky_relu(s, 0.2)
    v = _vector_bn_eval(p["bn2"], st["bn2"],
                        _linear_eval(p["linear2"], v, binary, False))
    return s, v * g


class SVDGCNNClsEngine:
    """Build from a weight tree ({'params', 'batch_stats'}, e.g. from
    ``init_params`` or ``utils.convert.from_flax``); call on (B, N, 3)
    float32 points on ``device``: the card unless the caller passes
    ``device="cpu"``.

    ``oracle=True`` runs the kernels' plain PyTorch versions in their place
    on any device: the reference the kernel path is held against on the
    card (chip_smoke.py). It is never chosen for the caller."""

    def __init__(self, weights: dict, num_classes: int = 40, k: int = 20,
                 binary: bool = True, mode: str = "exact", device="cuda",
                 oracle: bool = False):
        self.mode = config.check_mode(mode)
        if oracle:
            self._first, self._round, self._point = (
                sv_round3_first_plain, sv_round3_plain, sv_point_block_cm_plain)
        else:
            self._first, self._round, self._point = (
                sv_round3_first, sv_round3, sv_point_block_cm)
        self.device = config.resolve_device(device)
        if self.device.type == "cuda":
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


# the SV-PointNet engines' per-point SVBlocks, in call order:
# name -> (S_in, V_in, S_out, V_out)
POINTNET_CLS_BLOCKS = {
    "conv1": (32, 10, 32, 10),
    "fstn/conv1": (32, 10, 32, 10),
    "fstn/conv2": (32, 10, 64, 21),
    "fstn/conv3": (64, 21, 512, 170),
    "conv2": (64, 20, 64, 21),
    "conv3": (64, 21, 512, 170),
    "conv_fuse": (1024, 340, 512, 170),
}
POINTNET_PSEG_BLOCKS = {
    "conv1": (32, 10, 32, 10),
    "conv2": (32, 10, 64, 21),
    "conv3": (64, 21, 64, 21),
    "fstn/conv1": (64, 21, 32, 10),
    "fstn/conv2": (32, 10, 64, 21),
    "fstn/conv3": (64, 21, 512, 170),
    "conv4": (128, 42, 256, 85),
    "conv5": (256, 85, 1024, 341),
}


def _node(tree: dict, path: str) -> dict:
    for seg in path.split("/"):
        tree = tree[seg]
    return tree


class _PointNetEngine:
    """What the two SV-PointNet engines share: the device, the folds, the
    cross first round, the per-point blocks and the SV_STNkd token.
    ``enc``/``enc_bs`` name the encoder's weights, ``specs`` its blocks."""

    def __init__(self, weights: dict, enc_key: str | None, specs: dict,
                 k: int, binary: bool, mode: str, device, oracle: bool):
        self.mode = config.check_mode(mode)
        self._first = sv_round3_first_plain if oracle else sv_round3_first
        self._block = sv_block_point_plain if oracle else sv_block_point
        self.device = config.resolve_device(device)
        if self.device.type == "cuda":
            # full-f32 matmuls: TF32 would flip binarization signs (C7)
            config.set_full_fp32()
        self.k, self.binary = k, binary
        self.p = _to(weights["params"], self.device)
        self.bs = _to(weights["batch_stats"], self.device)
        enc = self.enc = self.p[enc_key] if enc_key else self.p
        enc_bs = self.enc_bs = self.bs[enc_key] if enc_key else self.bs
        self.folded_first = _contig(fold_first_params(
            enc["init_scalar"], enc["conv_pos"], enc_bs["conv_pos"], n_ch=3))
        self.blocks = {
            name: (dims, _contig(fold_point_like_params(
                _node(enc, name), _node(enc_bs, name), *dims[:2], binary)),
                _node(enc, name))
            for name, dims in specs.items()
        }

    def _check(self, points: torch.Tensor) -> None:
        if points.device != self.device or points.dtype != torch.float32:
            raise ValueError(
                f"points must be float32 on {self.device}, got "
                f"{points.dtype} on {points.device}")

    def _first_round(self, points: torch.Tensor):
        """Cross edges, conv_pos and the pool over k, gated: (B, N, 32),
        (B, N, 3, 10)."""
        B, N, _ = points.shape
        s, v, s_mean = self._first(points.contiguous(), self.folded_first,
                                   S_out=32, V_out=10, k=self.k,
                                   cross=True)[:3]
        g = se_gate(self.enc["conv_pos"], s_mean)
        # contiguous on both paths (the kernel's s is channel-major, the
        # plain version's a transposed view), so that the next gate's mean
        # over N reduces in one order and the engine equals its plain twin
        return (s.transpose(1, 2).contiguous(),
                v.transpose(1, 2).reshape(B, N, 3, 10) * g[:, None, None, :])

    def _run_block(self, name: str, s: torch.Tensor, v: torch.Tensor):
        """A per-point SVBlock through kernel B8; the gate from the mean of
        the block's input scalars."""
        (S, V, S_out, V_out), folded, node = self.blocks[name]
        B, N = s.shape[:2]
        g = se_gate(node, torch.mean(s, dim=1))
        src = torch.cat([s, v.reshape(B, N, -1)], dim=-1)
        so, vo = self._block(src, g, folded, S=S, V=V, S_out=S_out,
                             V_out=V_out, binary=self.binary)
        return so, vo.reshape(B, N, 3, V_out)

    def _with_stn_token(self, s: torch.Tensor, v: torch.Tensor):
        """SV_STNkd: three blocks, pool over N, the (B, 1) token through
        fc1-fc3 here; returns [s | token], [v | token] per point."""
        ts, tv = self._run_block("fstn/conv1", s, v)
        ts, tv = self._run_block("fstn/conv2", ts, tv)
        ts, tv = self._run_block("fstn/conv3", ts, tv)
        tok_s, tok_v = ops.svpool((ts, tv), dim=1)
        tok_s, tok_v = tok_s[:, None], tok_v[:, None]
        for fc in ("fc1", "fc2", "fc3"):
            tok_s, tok_v = _svblock_eval(self.enc["fstn"][fc],
                                         self.enc_bs["fstn"][fc], tok_s,
                                         tok_v, self.binary)
        return (torch.cat([s, tok_s.expand_as(s)], dim=-1),
                torch.cat([v, tok_v.expand_as(v)], dim=-1))


class SVPointNetClsEngine(_PointNetEngine):
    """SV-PointNet classification, exact mode. Build from a weight tree
    (``models.sv_pointnet.init_params`` or ``utils.convert.from_flax``);
    call on (B, N, 3) float32 points on ``device``, the card unless the
    caller passes ``device="cpu"``. ``oracle=True`` runs the kernels' plain
    versions on any device (the reference on the card)."""

    def __init__(self, weights: dict, num_classes: int = 40, k: int = 20,
                 binary: bool = True, mode: str = "exact", device="cuda",
                 oracle: bool = False):
        super().__init__(weights, "feat", POINTNET_CLS_BLOCKS, k, binary, mode,
                         device, oracle)
        self.num_classes = num_classes

    @torch.no_grad()
    def __call__(self, points: torch.Tensor) -> torch.Tensor:
        """(B, N, 3) float32 points -> (B, num_classes) logits."""
        self._check(points)
        s, v = self._run_block("conv1", *self._first_round(points))
        s, v = self._with_stn_token(s, v)
        s, v = self._run_block("conv2", s, v)
        s, v = self._run_block("conv3", s, v)
        sm, vm = ops.svpool((s, v), dim=1, keepdim=True)
        s, v = self._run_block("conv_fuse", torch.cat([s, sm.expand_as(s)], -1),
                               torch.cat([v, vm.expand_as(v)], -1))
        s, v = ops.svpool((s, v), dim=1)
        x = torch.cat([s, _v2s_eval(self.enc["svfuse"]["v2s"], v, self.binary)],
                      dim=-1)
        p, bs, b = self.p, self.bs, self.binary
        x = torch.relu(_bn_eval(p["bn1"]["bn"], bs["bn1"]["bn"],
                                _linear_eval(p["fc1"], x, b, b)))
        x = torch.relu(_bn_eval(p["bn2"]["bn"], bs["bn2"]["bn"],
                                _linear_eval(p["fc2"], x, b, b)))
        return _linear_eval(p["fc3"], x, False, False)


class SVPointNetPsegEngine(_PointNetEngine):
    """SV-PointNet part segmentation, exact mode; built and placed as
    ``SVPointNetClsEngine``. Call on (B, N, 3) points and the (B, 16)
    one-hot object category; returns (B, N, num_part) logits."""

    def __init__(self, weights: dict, num_part: int = 50, k: int = 40,
                 binary: bool = True, mode: str = "exact", device="cuda",
                 oracle: bool = False):
        super().__init__(weights, None, POINTNET_PSEG_BLOCKS, k, binary, mode,
                         device, oracle)
        self.num_part = num_part

    def _conv_bn_relu(self, name: str, x: torch.Tensor) -> torch.Tensor:
        p, bs = self.p, self.bs
        x = _linear_eval(p[f"{name}_conv"], x, self.binary, self.binary)
        return torch.relu(_bn_eval(p[f"{name}_bn"]["bn"], bs[f"{name}_bn"]["bn"], x))

    @torch.no_grad()
    def __call__(self, points: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        self._check(points)
        B, N, _ = points.shape
        if label.device != self.device or tuple(label.shape) != (B, 16):
            raise ValueError(f"label: expected (B, 16) on {self.device}, got "
                             f"{tuple(label.shape)} on {label.device}")
        s1, v1 = self._run_block("conv1", *self._first_round(points))
        s2, v2 = self._run_block("conv2", s1, v1)
        s3, v3 = self._run_block("conv3", s2, v2)
        s4, v4 = self._run_block("conv4", *self._with_stn_token(s3, v3))
        s5, v5 = self._run_block("conv5", s4, v4)
        s = torch.cat([s5, torch.mean(s5, dim=1, keepdim=True).expand_as(s5)], -1)
        v = torch.cat([v5, torch.mean(v5, dim=1, keepdim=True).expand_as(v5)], -1)

        # SVFuse(trans_back): the invariants and the learned frame
        lp = self.p["svfuse"]["v2s"]["linear"]
        trans = v @ (torch.sign(lp["kernel"]) if self.binary else lp["kernel"])
        if "scale" in lp:
            trans = trans * lp["scale"]
        sv = torch.einsum("bnic,bnij->bncj", v, trans)
        x = torch.cat([s, sv.reshape(B, N, -1)], dim=-1)
        x = self._conv_bn_relu("conv_fuse2", self._conv_bn_relu("conv_fuse1", x))
        x = torch.mean(x, dim=1) if self.binary else torch.amax(x, dim=1)
        x_l = torch.cat([x, label], dim=-1)[:, None, :].expand(B, N, -1)

        cs = torch.cat([s1, s2, s3, s4, s5], dim=-1)
        cv = torch.cat([v1, v2, v3, v4, v5], dim=-1)
        concat_v = torch.einsum("bnic,bnik->bnck", cv, trans).reshape(B, N, -1)
        net = torch.cat([x_l, cs, concat_v], dim=-1)
        for name in ("convs1", "convs2", "convs3"):
            net = self._conv_bn_relu(name, net)
        return _linear_eval(self.p["convs4"], net, False, False)
