"""Fused eval engines, exact, fast and approx mode: SV-DGCNN classification
and part segmentation (counterparts of svnet_tpu/infer.py:227-855) and
SV-PointNet classification and part segmentation
(svnet_tpu/infer.py:857-1167).

The SV-DGCNN engines run one of four trunks, chosen by ``rounds_impl``:

  "round3" (the default) keeps activations channel-major (B, C, N):
  sv_round3_first -> gate -> sv_round3 x3 (conv2..conv4, gate after each)
  -> sv_point_block_cm (conv5 + SVFuse)
  "round2", the legacy row-major trunk, keeps them (B, N, C):
  sv_round2_first -> gate -> sv_round2 x3 -> sv_point_block
  "round" (classifier): sv_round_first -> gate -> sv_round x3, each gated
  here, as round2 -> sv_point_block
  "edge" (classifier): knn -> sv_edge_first_block -> gate, then per conv
  round knn over the joint features -> svblock_gate -> sv_edge_block (the
  gate applied inside) -> sv_point_block; the kNN (B4) is exact in every
  mode

(the part segmenter runs round2 for "round" and "edge", as the JAX
engine does; an unknown name raises)

then the head: classification pools max+mean over the points into the MLP
head; part segmentation adds the fine per-point features (svfuse1), the
pooled token (conv6 + svfuse2), the max of the embedding and the label
branch, and runs the pointwise conv8-conv11 head. The two trunks compute
the same function with the same arithmetic: on the same weights their
kernels' outputs agree bitwise.

The SV-PointNet engines run row-major (B, N, C) after the first round:

  sv_round3_first(cross=True) -> conv_pos gate -> sv_block_point per
  SVBlock (conv1.., the SV_STNkd trunk, conv_fuse / conv4-5) with the SE
  gate computed here -> the (B, 1) STN token blocks, pools, concats, SVFuse
  and the head (partseg: the frame un-projection and pointwise convs)

The SE gates, token path and heads run as plain tensor code on the host
side of the kernels, as in the JAX engines. On a CUDA device every fused
stage launches its kernel; on the CPU the kernels' plain versions run.

``mode="fast"`` (the JAX engines' default) changes the first round and
the conv rounds (B1, B2: packed distance keys per key tile, the gather
grid; ops/kernels/sv_round3.py) and nothing else, so it is taken on the
round3 trunk and by the SV-PointNet engines. ``mode="approx"`` (JAX's
certified serving pick) also folds each centre's candidates before the
top k (``config.approx_fold``), gathers through
``config.approx_gather_bits``' grid, and on the SV-DGCNN engines' round3
trunk Morton-sorts the cloud at entry (ops/morton.py;
``config.morton_entry`` sorts in every mode), as svnet_tpu/infer.py:56-77
does: the classifier's pooling does not see the order, and the part
segmenter puts its per-point logits back in the input's order. The
SV-PointNet engines never sort, as the JAX engines do not.

The legacy trunks take fast and approx mode too, as the JAX engines do
(svnet_tpu/infer.py:416-470, :774-792), with their own fixed grids and no
Morton sort: "round2" (B10b) at the 16-bit grid, approx folding to 256
lanes; "round" (B10a, ``exact=False`` for both) at the bf16 gather with
fast's key unfolded, so approx is fast there. Their key tile is
``quant.auto_round_tile(N, tile, k, C, mode)`` for each round's C, from
the engines' ``tile`` (64, as JAX's), and it is part of the result. The
knobs of fast and approx mode do not act there, and are refused (C23,
``config.check_mode``). The classifier's "edge" trunk takes fast and
approx mode too (svnet_tpu/infer.py:430-482): both are ``exact=False``
on B10d and B10c (the bf16 gather, and B10c's linear2 through bf16), on
the exact kNN of B4, with no Morton sort and no pre-pass, so approx is
fast there; the knobs are refused as on the legacy trunks.

Graph reuse (``config.graph_reuse``, ``reuse_k``, ``reuse_gather_window``;
svnet_tpu/infer.py:315-365, :640-690) is read at each call, on the
SV-DGCNN engines' round3 trunk in every mode: conv2..conv4 take the
first round's ids ("spatial"), or conv3 and conv4 take conv2's
("conv2"), and select nothing (``sv_round3(wins_in=...)``); a gather
window also Morton-sorts at entry. The other trunks raise.

The candidate window (``window=``, svnet_tpu/infer.py:242-246, :554-567)
goes to B1 and every selecting B2 of the SV-DGCNN engines' round3 trunk
in every mode (ops/window.py); it excludes graph reuse, and the other
trunks refuse it, where the JAX engines ignore it (ROADMAP C22).
"""

from __future__ import annotations

import functools
from typing import Dict

import torch

from svnet_tpu_torch import config, ops
from svnet_tpu_torch.config import BN_EPS, EPS
from svnet_tpu_torch.nn.sv_layers import binary_matmul
from svnet_tpu_torch.models.sv_dgcnn import PSEG_DIMS
from svnet_tpu_torch.ops import morton
from svnet_tpu_torch.ops.kernels import quant
from svnet_tpu_torch.ops.kernels.fold import (
    fold_first_params,
    fold_point_like_params,
    fold_point_params,
    fold_svblock_params,
    fuse3_perm,
    head8_rows,
    head_perm,
)
from svnet_tpu_torch.ops.kernels.sv_block_point import (
    sv_block_point,
    sv_block_point_plain,
)
from svnet_tpu_torch.ops.kernels.sv_point import (
    sv_point_block,
    sv_point_block_cm,
    sv_point_block_cm_plain,
    sv_point_block_plain,
)
from svnet_tpu_torch.ops.kernels.sv_edge import (
    svblock_gate,
    sv_edge_block,
    sv_edge_block_plain,
)
from svnet_tpu_torch.ops.kernels.sv_edge_first import (
    sv_edge_first_block,
    sv_edge_first_block_plain,
)
from svnet_tpu_torch.ops.kernels.sv_round import (
    sv_round,
    sv_round_first,
    sv_round_first_plain,
    sv_round_plain,
)
from svnet_tpu_torch.ops.kernels.sv_round2 import (
    sv_round2,
    sv_round2_first,
    sv_round2_first_plain,
    sv_round2_plain,
)
from svnet_tpu_torch.ops.kernels.sv_round3 import (
    sv_round3,
    sv_round3_first,
    sv_round3_first_plain,
    sv_round3_plain,
)

# (S, V) of the SV-DGCNN trunk's blocks conv1..conv4
CLS_DIMS = {"conv1": (64 // 2, 64 // 6), "conv2": (64 // 2, 64 // 6),
            "conv3": (128 // 2, 128 // 6), "conv4": (256 // 2, 256 // 6)}
PSEG_TRUNK = {n: PSEG_DIMS[n] for n in CLS_DIMS}


def dgcnn_rounds(dims: dict) -> dict:
    """(S_in, V_in, S_out, V_out) of the fused conv rounds conv2..conv4."""
    names = list(dims)
    return {n: (*dims[prev], *dims[n]) for prev, n in zip(names, names[1:])}


def point_v_off(base: int, vdims) -> tuple:
    """(row offset, V_r) of each round's j-major vector block in a
    channel-major stack whose first block starts at row ``base`` (the conv5
    input [s (S_c) | v1 | v2 | v3 | v4] has base S_c)."""
    v_off, o = [], base
    for Vr in vdims:
        v_off.append((o, Vr))
        o += 3 * Vr
    return tuple(v_off)


ROUNDS = dgcnn_rounds(CLS_DIMS)
POINT_V_OFF = point_v_off(256, [V for _, V in CLS_DIMS.values()])

ROUNDS_IMPLS = ("round3", "round2", "round", "edge")


def _host_gated(rnd, rm: bool = True):
    """A round that returns (s, ungated v, gate mean[, ids]), with its v
    gated here by the SE gate of that mean: (x, folded, p, **kw) -> (s,
    gated v[, ids])."""
    def run(x, folded, p, **kw):
        s, v, mean, *ids = rnd(x, folded, **kw)
        g = se_gate(p, mean).repeat(1, 3)
        return (s, v * (g[:, None, :] if rm else g[:, :, None]), *ids)
    return run


def _with_ids(rnd):
    """A round3 kernel wrapper under its plain version's contract: a round
    that selects returns its neighbour ids last (``emit_wins``, at no
    cost: the kernel writes them anyway), a graph-reuse round does not.
    The ids a reuse round gets are those an earlier round emitted
    (``emitted``: no range check, no device sync)."""
    def run(x, folded, wins_in=None, **kw):
        return rnd(x, folded, wins_in=wins_in, emit_wins=wins_in is None,
                   emitted=wins_in is not None, **kw)
    return run


def _gated_trunk(first, rnd, point, rm: bool = True):
    """A trunk of fused rounds (kNN inside), each gated here; first, rnd
    and point are (kernel, plain) pairs."""
    def build(oracle: bool):
        return (_host_gated(first[oracle], rm), _host_gated(rnd[oracle], rm),
                point[oracle])
    return build


def _edge_trunk(oracle: bool):
    """The edge trunk: each round on its own kNN ids (B4, or ``knn_plain``
    with ``oracle``); the first round gated here from its s_mean, a conv
    round's gate computed from the ids (``svblock_gate``) and applied
    inside the block."""
    knn = ops.knn_plain if oracle else ops.knn
    first = (sv_edge_first_block, sv_edge_first_block_plain)[oracle]
    block = (sv_edge_block, sv_edge_block_plain)[oracle]

    def first_round(points, folded, **kw):
        return first(points, knn(points, kw["k"]), folded, **kw)

    def conv_round(joint, folded, p, *, S, k, **kw):
        idx = knn(joint, k)
        gate = svblock_gate(p, joint[..., :S].contiguous(), idx)
        return block(joint, idx, gate, folded, S=S, k=k, **kw)

    return (_host_gated(first_round), conv_round,
            (sv_point_block, sv_point_block_plain)[oracle])


# trunk -> build(oracle) -> (first round, conv round, point block); a round
# is (x, folded, p, **dims) -> (s, gated v[, ids]); round3's rounds return
# their ids (B, k, N), and its conv round takes ``wins_in``
TRUNKS = {
    "round3": _gated_trunk((functools.partial(sv_round3_first, emit_wins=True),
                            sv_round3_first_plain),
                           (_with_ids(sv_round3), sv_round3_plain),
                           (sv_point_block_cm, sv_point_block_cm_plain),
                           rm=False),
    "round2": _gated_trunk((sv_round2_first, sv_round2_first_plain),
                           (sv_round2, sv_round2_plain),
                           (sv_point_block, sv_point_block_plain)),
    "round": _gated_trunk((sv_round_first, sv_round_first_plain),
                          (sv_round, sv_round_plain),
                          (sv_point_block, sv_point_block_plain)),
    "edge": _edge_trunk,
}


def check_rounds_impl(rounds_impl: str) -> str:
    if rounds_impl not in ROUNDS_IMPLS:
        raise ValueError(f"rounds_impl {rounds_impl!r}; expected one of "
                         f"{ROUNDS_IMPLS}")
    return rounds_impl


def _to(tree, device, dtype=torch.float32):
    return {n: _to(v, device, dtype) if isinstance(v, dict)
            else v.to(device=device, dtype=dtype).contiguous()
            for n, v in tree.items()}


def _contig(folded: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: t.contiguous() for n, t in folded.items()}


def _take_rows(p: dict, rows: torch.Tensor) -> dict:
    """A linear's weights for an input whose channels come in another
    order, ``x[..., rows]``: ``x[..., rows] @ W[rows] == x @ W`` (its beta
    permuted too)."""
    rows = rows.to(p["kernel"].device)
    out = dict(p, kernel=p["kernel"][rows, :])
    if "beta" in p:
        out["beta"] = p["beta"][rows]
    return out


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


def _linear_eval_cm(p: dict, x: torch.Tensor, bw: bool, ba: bool) -> torch.Tensor:
    """Channel-major ``_linear_eval``: x (B, C, N) -> (B, O, N), per-channel
    affines broadcast along the points."""
    if not (bw or ba):
        y = torch.einsum("co,bcn->bon", p["kernel"], x)
    else:
        if ba:
            x = torch.sign(x + p["beta"][:, None])
        w = torch.sign(p["kernel"]) if bw else p["kernel"]
        y = torch.einsum("co,bcn->bon", w, x) * p["scale"][:, None]
    return y + p["bias"][:, None] if "bias" in p else y


def _bn_eval_cm(p: dict, st: dict, x: torch.Tensor) -> torch.Tensor:
    inv = p["scale"] / torch.sqrt(st["var"] + BN_EPS)
    return x * inv[:, None] + (p["bias"] - st["mean"] * inv)[:, None]


def _v2s_eval_cm(p: dict, v_cm: torch.Tensor, v_off: tuple,
                 bw: bool) -> torch.Tensor:
    """Channel-major Vector2Scalar over a per-round j-major (B, 3V_c, N)
    stack (blocks at ``v_off``): (B, 3V_c, N) invariants j-outer (row
    j*V_c + c, c in the reference's round order); the consumer's weight
    rows take that order (``fold.head8_rows``)."""
    w = torch.sign(p["linear"]["kernel"]) if bw else p["linear"]["kernel"]
    v = [torch.cat([v_cm[:, o + i * Vr:o + (i + 1) * Vr] for o, Vr in v_off],
                   dim=1) for i in range(3)]  # (B, V_c, N) x3
    z = [torch.einsum("cj,bcn->bjn", w, vi) for vi in v]  # (B, 3, N)
    if bw:
        z = [zi * p["linear"]["scale"][:, None] for zi in z]
    return torch.cat([v[0] * z[0][:, j:j + 1] + v[1] * z[1][:, j:j + 1]
                      + v[2] * z[2][:, j:j + 1] for j in range(3)], dim=1)


def _mean_points(x_cm: torch.Tensor) -> torch.Tensor:
    """Mean over the points of channel-major x (B, C, N), always reduced
    along a contiguous last axis: the two trunks (and an engine and its
    plain twin) then sum in one order and agree bitwise."""
    return torch.mean(x_cm.contiguous(), dim=2)


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


class _DGCNNEngine:
    """What the two SV-DGCNN engines share: the device, the folds, the
    trunk (``trunk``, from the caller's ``rounds_impl``) and conv5 + the
    SVFuse at ``fuse_key``. ``oracle`` runs every kernel's plain version,
    the kNN's included; only then may ``dtype`` be float64 (the kernels
    take float32)."""

    def __init__(self, weights: dict, dims: dict, emb: tuple, fuse_key: str,
                 k: int, binary: bool, mode: str, device, oracle: bool,
                 trunk: str, window: int = 0, tile: int = 64,
                 dtype: torch.dtype = torch.float32):
        if dtype != torch.float32 and not (oracle and dtype == torch.float64):
            raise ValueError(f"dtype {dtype}: float32, or float64 with "
                             "oracle=True (the kernels take float32)")
        self.dtype = dtype
        self.mode = config.check_mode(mode, trunk)
        self.trunk, self.tile = trunk, tile
        self.row_major = trunk != "round3"
        if window and trunk != "round3":  # C22: JAX ignores it there
            raise ValueError(f"window={window} is ported on the round3 trunk "
                             f"only, not on {trunk!r}")
        self.window = window
        self._first, self._round, self._point = TRUNKS[trunk](oracle)
        # the rounds' mode: round3's also takes the window, round (B10a)
        # and edge (B10d, B10c) take exact=...
        kw = {"round3": dict(mode=self.mode, window=window),
              "round2": dict(mode=self.mode)}.get(
                  trunk, dict(exact=self.mode == "exact"))
        self._first = functools.partial(self._first, **kw)
        self._round = functools.partial(self._round, **kw)
        self.device = config.resolve_device(device)
        if self.device.type == "cuda":
            # full-f32 matmuls: TF32 would flip binarization signs (C7)
            config.set_full_fp32()
        self.k, self.binary = k, binary
        p = self.p = _to(weights["params"], self.device, dtype)
        bs = self.bs = _to(weights["batch_stats"], self.device, dtype)
        self.dims, self.rounds = dims, dgcnn_rounds(dims)
        self.folded = {
            name: _contig(fold_svblock_params(p[name], bs[name], S, V, binary))
            for name, (S, V, _, _) in self.rounds.items()
        }
        self.folded_first = _contig(
            fold_first_params(p["init_scalar"], p["conv1"], bs["conv1"]))
        self.S_c = sum(S for S, _ in dims.values())
        self.V_c = sum(V for _, V in dims.values())
        self.S5, self.V5 = emb
        self.v_off = point_v_off(self.S_c, [V for _, V in dims.values()])
        self.folded_point = _contig(fold_point_params(
            p["conv5"], bs["conv5"], p[fuse_key], S=self.S_c, V=self.V_c,
            binary=binary))

    def _check(self, points: torch.Tensor) -> None:
        if points.device != self.device or points.dtype != self.dtype:
            raise ValueError(
                f"points must be {self.dtype} on {self.device}, got "
                f"{points.dtype} on {points.device}")

    def _entry_sort(self, points: torch.Tensor):
        """(points, order): the cloud Morton-sorted on the round3 trunk in
        approx mode, with ``config.morton_entry``, or with graph reuse and a
        ``config.reuse_gather_window`` (svnet_tpu/infer.py:56-77, :410,
        :765), else as given with order None."""
        if self.trunk != "round3" or not (
                self.mode == "approx" or config.morton_entry
                or (config.reuse_gather_window
                    and config.graph_reuse != "none")):
            return points, None
        return morton.sort_points(points)

    def _key_tile(self, N: int, C: int) -> dict:
        """A legacy round's key tile over C channels (``T``; JAX's
        ``_auto_round_tile``); round3's rounds pick their own, the edge
        trunk's take none."""
        if self.trunk not in ("round2", "round"):
            return {}
        return {"T": quant.auto_round_tile(N, self.tile, self.k, C, self.mode)}

    def _trunk(self, points: torch.Tensor):
        """The four rounds, each round's v gated. round3: s (B, S_c, N) and
        v (B, 3V_c, N) as per-round j-major blocks; the row-major trunks:
        s (B, N, S_c) and v (B, N, 3, V_c).

        Graph reuse (round3 only, svnet_tpu/infer.py:315-365): "spatial"
        feeds the first round's ids to conv2..conv4, "conv2" conv2's to
        conv3 and conv4; with 0 < ``config.reuse_k`` < k a reuse round
        takes the nearest reuse_k ranks and runs at k = reuse_k."""
        p, k, rm = self.p, self.k, self.row_major
        reuse, rk = config.graph_reuse, config.reuse_k
        if reuse != "none" and self.trunk != "round3":
            raise ValueError(f"graph_reuse={reuse!r} is ported on the round3 "
                             f"trunk only, not on {self.trunk!r}")
        if reuse != "none" and self.window:
            raise ValueError(f"graph_reuse={reuse!r} excludes the window "
                             f"(window={self.window})")
        B, N, _ = points.shape
        dim = -1 if rm else 1  # the channel axis
        S1, V1 = self.dims["conv1"]
        s, v, *ids = self._first(points, self.folded_first, p["conv1"],
                                 S_out=S1, V_out=V1, k=k,
                                 **self._key_tile(N, 3))
        wins = ids[0] if reuse == "spatial" else None
        outs = [(s, v)]
        for name, (S, V, S_out, V_out) in self.rounds.items():
            joint = torch.cat(outs[-1], dim=dim)
            kk, kw = k, self._key_tile(N, S + 3 * V)
            if wins is not None:
                kk = rk if 0 < rk < k else k
                kw = dict(wins_in=wins[:, :kk],  # rank-major: the nearest kk
                          gather_window=config.reuse_gather_window)
            s, v, *ids = self._round(joint, self.folded[name], p[name], S=S,
                                     V=V, S_out=S_out, V_out=V_out, k=kk,
                                     binary=self.binary, **kw)
            if reuse == "conv2" and name == "conv2":
                wins = ids[0]
            outs.append((s, v))
        s = torch.cat([o[0] for o in outs], dim=dim)
        if rm:
            return s, torch.cat([o[1].reshape(B, N, 3, -1) for o in outs], -1)
        return s, torch.cat([o[1] for o in outs], dim=1)

    def _conv5(self, s: torch.Tensor, v: torch.Tensor):
        """conv5 + SVFuse through B3 (round3) or B3r (round2): x with its
        SVFuse channels j-major, s5_max (B, S5), v5_mean (B, 3V5)."""
        kw = dict(S=self.S_c, V=self.V_c, S_out=self.S5, V_out=self.V5,
                  binary=self.binary)
        if self.row_major:
            g5 = se_gate(self.p["conv5"], _mean_points(s.transpose(1, 2)))
            src5 = torch.cat([s, v.flatten(2)], dim=-1)
            return self._point(src5, g5, self.folded_point, **kw)
        g5 = se_gate(self.p["conv5"], _mean_points(s))
        return self._point(torch.cat([s, v], dim=1), g5, self.folded_point,
                           v_off=self.v_off, **kw)


class SVDGCNNClsEngine(_DGCNNEngine):
    """Build from a weight tree ({'params', 'batch_stats'}, e.g. from
    ``init_params`` or ``utils.convert.from_flax``); call on (B, N, 3)
    float32 points on ``device``: the card unless the caller passes
    ``device="cpu"``. ``rounds_impl`` picks the trunk: "round3" (the
    default), the legacy row-major "round2", "round" (kernel B10a) or
    "edge" (a separate kNN, kernels B10d and B10c). ``mode``: "exact",
    "fast" or "approx" (on round3 approx Morton-sorts the cloud first; on
    the edge trunk both are exact=False on B10d and B10c, on the exact
    kNN; see the module's docstring); ``tile``:
    the legacy trunks' key-tile parameter (``quant.auto_round_tile``).
    ``window`` (round3 only; 0 = off): the certified Morton
    candidate window of B1 and every selecting B2 (ops/window.py): each
    key tile ranks at most that many rows of the 128-row blocks a pre-pass
    keeps, or all N where the batch does not certify. It does not sort the
    cloud: the caller does, or sets ``config.morton_entry``. It excludes
    graph reuse, and another trunk refuses it (ROADMAP C22).

    ``oracle=True`` runs the kernels' plain PyTorch versions in their place
    on any device: the reference the kernel path is held against on the
    card (chip_smoke.py). It is never chosen for the caller. With it,
    ``dtype=torch.float64`` runs the plain versions in float64 on float64
    points, where no binarization sign lies within rounding of 0: the
    engine's function held to the eager model's without flips."""

    def __init__(self, weights: dict, num_classes: int = 40, k: int = 20,
                 binary: bool = True, mode: str = "exact", device="cuda",
                 oracle: bool = False, rounds_impl: str = "round3",
                 window: int = 0, tile: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__(weights, CLS_DIMS, (1024 // 2, 1024 // 6), "svfuse",
                         k, binary, mode, device, oracle,
                         check_rounds_impl(rounds_impl), window, tile, dtype)
        self.num_classes = num_classes
        # the tail emits SVFuse channels j-major; the head's first linear
        # takes its rows in that order
        self.head1 = _take_rows(self.p["linear1"], head_perm(self.S5, self.V5))

    def _tail(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, 1022, N), or (B, N, 1022) from the row-major trunk ->
        logits: max and mean over the points, the MLP head."""
        p, bs = self.p, self.bs
        x_cm = x.transpose(1, 2) if self.row_major else x
        x = torch.cat([torch.amax(x_cm, dim=2), _mean_points(x_cm)], dim=-1)
        lrelu = torch.nn.functional.leaky_relu
        x = _linear_eval(self.head1, x, self.binary, self.binary)
        x = lrelu(_bn_eval(p["bn1"]["bn"], bs["bn1"]["bn"], x), 0.2)
        x = _linear_eval(p["linear2"], x, self.binary, self.binary)
        x = lrelu(_bn_eval(p["bn2"]["bn"], bs["bn2"]["bn"], x), 0.2)
        return _linear_eval(p["linear3"], x, False, False)

    @torch.no_grad()
    def __call__(self, points: torch.Tensor) -> torch.Tensor:
        """(B, N, 3) float32 points -> (B, num_classes) logits."""
        self._check(points)
        points, _ = self._entry_sort(points.contiguous())  # pooling: order-free
        return self._tail(self._conv5(*self._trunk(points))[0])


class SVDGCNNPsegEngine(_DGCNNEngine):
    """SV-DGCNN part segmentation (svnet_tpu/infer.py:533-855); built,
    placed and switched (``rounds_impl``, ``mode``, ``oracle``) as
    ``SVDGCNNClsEngine``, but for "round" and "edge", which run the round2
    trunk, as the JAX engine does. Call on (B, N, 3) float32 points and the
    (B, 16) one-hot object category; returns (B, N, num_part) logits.

    The round3 tail stays channel-major: the fine features' j-outer and the
    embedding's j-major SVFuse channels are folded into conv8's rows
    (``head8``). The round2 tail permutes the embedding back to the
    reference's c-major order (``fuse3_perm``) and uses conv8 as it is."""

    def __init__(self, weights: dict, num_part: int = 50, k: int = 40,
                 binary: bool = True, mode: str = "exact", device="cuda",
                 oracle: bool = False, rounds_impl: str = "round3",
                 window: int = 0, tile: int = 64,
                 dtype: torch.dtype = torch.float32):
        trunk = check_rounds_impl(rounds_impl)
        super().__init__(weights, PSEG_TRUNK, PSEG_DIMS["conv5"], "svfuse3",
                         k, binary, mode, device, oracle,
                         "round3" if trunk == "round3" else "round2", window,
                         tile, dtype)
        self.num_part = num_part
        p = self.p
        self.v_off0 = point_v_off(0, [V for _, V in self.dims.values()])
        self.fuse3_perm = fuse3_perm(self.S5, self.V5).to(self.device)
        # x_pool (conv6 + svfuse2) and the label branch, c-major
        mid = (p["conv6"]["linear1"]["kernel"].shape[1]
               + 3 * p["conv6"]["linear2"]["kernel"].shape[1]
               + p["conv7"]["kernel"].shape[1])
        self.head8 = _take_rows(p["conv8"]["conv"], head8_rows(
            self.S5, self.V5, mid, self.S_c, self.V_c))

    def _token_and_label(self, s5_max, v5_mean, label):
        """The pooled token through conv6 + svfuse2, (B, 1, ·) c-major, and
        the label branch (B, 64)."""
        p, bs, b = self.p, self.bs, self.binary
        B = s5_max.shape[0]
        sp, vp = _svblock_eval(p["conv6"], bs["conv6"], s5_max[:, None, :],
                               v5_mean.reshape(B, 1, 3, self.V5), b)
        x_pool = torch.cat([sp, _v2s_eval(p["svfuse2"]["v2s"], vp, b)], dim=-1)
        lab = _bn_eval(p["bn7"]["bn"], bs["bn7"]["bn"],
                       _linear_eval(p["conv7"], label, False, False))
        return x_pool, torch.nn.functional.leaky_relu(lab, 0.2)

    def _tail_cm(self, label, s_cm, v_cm):
        p, bs, b = self.p, self.bs, self.binary
        B, _, N = s_cm.shape
        lrelu = torch.nn.functional.leaky_relu
        x_fine = torch.cat(
            [s_cm, _v2s_eval_cm(p["svfuse1"]["v2s"], v_cm, self.v_off0, b)],
            dim=1)  # (B, S_c + 3V_c, N)
        x, s5_max, v5_mean = self._conv5(s_cm, v_cm)  # (B, S5 + 3V5, N)
        x_pool, lab = self._token_and_label(s5_max, v5_mean, label)
        gcat = torch.cat([torch.amax(x, dim=2, keepdim=True),
                          x_pool.transpose(1, 2), lab[:, :, None]], dim=1)
        net = torch.cat([gcat.expand(B, -1, N), x_fine], dim=1)
        net = lrelu(_bn_eval_cm(p["conv8"]["bn"], bs["conv8"]["bn"],
                                _linear_eval_cm(self.head8, net, b, b)), 0.2)
        for name in ("conv9", "conv10"):
            net = _linear_eval_cm(p[name]["conv"], net, b, b)
            net = lrelu(_bn_eval_cm(p[name]["bn"], bs[name]["bn"], net), 0.2)
        return _linear_eval_cm(p["conv11"], net, False, False).transpose(1, 2)

    def _tail_rows(self, label, s_c, v_c):
        p, bs, b = self.p, self.bs, self.binary
        B, N, _ = s_c.shape
        lrelu = torch.nn.functional.leaky_relu
        x_fine = torch.cat([s_c, _v2s_eval(p["svfuse1"]["v2s"], v_c, b)], -1)
        x, s5_max, v5_mean = self._conv5(s_c, v_c)  # (B, N, S5 + 3V5)
        x = x[..., self.fuse3_perm]  # SVFuse channels back to c-major
        x_pool, lab = self._token_and_label(s5_max, v5_mean, label)
        gcat = torch.cat([torch.amax(x, dim=1, keepdim=True), x_pool,
                          lab[:, None, :]], dim=-1)
        net = torch.cat([gcat.expand(B, N, -1), x_fine], dim=-1)
        for name in ("conv8", "conv9", "conv10"):
            net = _linear_eval(p[name]["conv"], net, b, b)
            net = lrelu(_bn_eval(p[name]["bn"], bs[name]["bn"], net), 0.2)
        return _linear_eval(p["conv11"], net, False, False)

    @torch.no_grad()
    def __call__(self, points: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        """(B, N, 3) points, (B, 16) one-hot category -> (B, N, num_part)."""
        self._check(points)
        B = points.shape[0]
        if (label.device != self.device or label.dtype != self.dtype
                or tuple(label.shape) != (B, 16)):
            raise ValueError(f"label: expected (B, 16) {self.dtype} on "
                             f"{self.device}, got {tuple(label.shape)} "
                             f"{label.dtype} on {label.device}")
        if self.row_major:
            return self._tail_rows(label, *self._trunk(points.contiguous()))
        points, order = self._entry_sort(points.contiguous())
        out = self._tail_cm(label, *self._trunk(points))
        return out if order is None else morton.unsort(out, order)


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
        self._first = functools.partial(
            sv_round3_first_plain if oracle else sv_round3_first, mode=mode)
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
    """SV-PointNet classification, exact, fast or approx mode (no entry
    sort, as in the JAX engine). Build from a weight tree
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
    """SV-PointNet part segmentation, exact, fast or approx mode; built and
    placed as ``SVPointNetClsEngine``. Call on (B, N, 3) points and the (B, 16)
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
