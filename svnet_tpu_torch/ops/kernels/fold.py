"""Host-side weight folding for the fused kernels (counterparts of
svnet_tpu/ops/pallas/sv_edge.py:230-283, sv_edge_first.py:169-208,
sv_point.py:332-391 and sv_block_point.py:135-179), and the channel
permutations of the engines' heads (svnet_tpu/infer.py:323-330, :606-632).

Each fold turns one block's weight tree into the kernel's constants:
BatchNorm and the binarized layers' scales become per-channel affines,
and linear1's rows are permuted from the reference's c-major order of
the Vector2Scalar invariants (row c*3 + j) to the kernels' j-major order
(row j*V + c). Shapes keep the JAX package's orientation, ``(in, out)``
kernels and ``(1, C)`` affines.
"""

from __future__ import annotations

import weakref
from typing import Dict, List

import torch

from svnet_tpu_torch.config import BN_EPS

Folded = Dict[str, torch.Tensor]


# id(w1) -> (weak reference to w1, its version, the packed signs)
_PACKED: dict = {}


def packed_signs(w1: torch.Tensor, S_out: int) -> torch.Tensor:
    """W1's signs (the folded ``(K, S_out)`` sign weights on the card)
    packed once as int8 rows for the per-point tile kernels
    (csrc/sv_point_tile.cuh), kept while ``w1`` lives and rebuilt if it
    is changed in place: the folded dict keeps its keys, and a serving
    call reuses the copy."""
    from svnet_tpu_torch.ops.kernels import _build

    key = id(w1)
    hit = _PACKED.get(key)
    if hit is not None and hit[0]() is w1 and hit[1] == w1._version:
        return hit[2]
    lib = _build.lib()
    K = w1.shape[0]
    out = torch.empty(lib.sv_pack_bytes(K, S_out), dtype=torch.int8,
                      device=w1.device)
    _build.check(lib.sv_pack_signs_launch(w1.data_ptr(), out.data_ptr(), K,
                                          S_out, _build.stream_ptr(w1.device)),
                 "sv_pack_signs")
    _PACKED[key] = (weakref.ref(w1, lambda _, k=key: _PACKED.pop(k, None)),
                    w1._version, out)
    return out


def _jmajor(offset: int, n: int) -> List[int]:
    """Rows ``offset + c*3 + j`` listed j-major: j outer, c inner."""
    return [offset + c * 3 + j for j in range(3) for c in range(n)]


def _bn_affine(p: dict, st: dict):
    inv = p["scale"] / torch.sqrt(st["var"] + BN_EPS)
    return inv, p["bias"] - st["mean"] * inv


def _fold_block(p: dict, st: dict, perm: List[int], binary: bool) -> Folded:
    """Shared fold of an SVBlock's linear1/bn1/linear2/bn2/v2s."""
    w1 = p["linear1"]["kernel"][perm, :]
    if binary:
        beta = p["linear1"]["beta"][perm][None, :]
        w1 = torch.sign(w1)
        scale1 = p["linear1"]["scale"]
    else:
        beta = torch.zeros((1, w1.shape[0]), dtype=w1.dtype, device=w1.device)
        scale1 = torch.ones(w1.shape[1], dtype=w1.dtype, device=w1.device)
    inv1, shift1 = _bn_affine(p["bn1"]["bn"], st["bn1"]["bn"])

    w2 = p["linear2"]["kernel"]
    if binary:
        scale2 = p["linear2"]["scale"][None, :]
        w2 = torch.sign(w2)
    else:
        scale2 = torch.ones((1, w2.shape[1]), dtype=w2.dtype, device=w2.device)
    inv2, shift2 = _bn_affine(p["bn2"]["bn"], st["bn2"]["bn"])

    wz = p["v2s"]["linear"]["kernel"]
    if binary:
        wz = torch.sign(wz) * p["v2s"]["linear"]["scale"][None, :]
    return {
        "wz": wz, "w1": w1, "beta": beta,
        "a1": (scale1 * inv1)[None, :], "b1": shift1[None, :],
        "w2": w2, "scale2": scale2, "a2": inv2[None, :], "b2": shift2[None, :],
    }


def fold_svblock_params(params: dict, stats: dict, S: int, V: int,
                        binary: bool) -> Folded:
    """An edge round's SVBlock. linear1 consumes [s_e (2S) | v2s (6V)]:
    the first 2S rows stay, the 3*2V invariant rows go j-major."""
    perm = list(range(2 * S)) + _jmajor(2 * S, 2 * V)
    return _fold_block(params, stats, perm, binary)


def fold_first_params(init_scalar: dict, conv1: dict, stats_conv1: dict,
                      n_ch: int = 2) -> Folded:
    """init_scalar + conv1 (always full precision). linear1's rows are
    [init_scalar (3*n_ch) | v2s (3*n_ch)], each half permuted j-major;
    linear2 has no scale."""
    perm = _jmajor(0, n_ch) + _jmajor(3 * n_ch, n_ch)
    inv1, shift1 = _bn_affine(conv1["bn1"]["bn"], stats_conv1["bn1"]["bn"])
    inv2, shift2 = _bn_affine(conv1["bn2"]["bn"], stats_conv1["bn2"]["bn"])
    return {
        "wz0": init_scalar["linear"]["kernel"],
        "wz1": conv1["v2s"]["linear"]["kernel"],
        "w1": conv1["linear1"]["kernel"][perm, :],
        "a1": inv1[None, :], "b1": shift1[None, :],
        "w2": conv1["linear2"]["kernel"],
        "a2": inv2[None, :], "b2": shift2[None, :],
    }


def fold_point_like_params(params: dict, stats: dict, S: int, V: int,
                           binary: bool) -> Folded:
    """A per-point SVBlock (no edge doubling): linear1 consumes
    [s (S) | v2s (3V)], the invariant rows permuted j-major."""
    return _fold_block(params, stats, list(range(S)) + _jmajor(S, V), binary)


def fold_point_params(conv5_p: dict, conv5_bs: dict, svfuse_p: dict, S: int,
                      V: int, binary: bool) -> Folded:
    """conv5 + SVFuse: ``fold_point_like_params`` of conv5 plus ``wzf``,
    SVFuse's frame."""
    out = fold_point_like_params(conv5_p, conv5_bs, S, V, binary)
    wzf = svfuse_p["v2s"]["linear"]["kernel"]
    if binary:
        wzf = torch.sign(wzf) * svfuse_p["v2s"]["linear"]["scale"][None, :]
    out["wzf"] = wzf
    return out


def head_perm(S_out: int, V_out: int) -> torch.Tensor:
    """Rows of the head's first linear for [max(x), mean(x)] whose SVFuse
    channels come j-major: ``x_jmajor @ W[perm] == x_cmajor @ W``."""
    block = list(range(S_out)) + _jmajor(S_out, V_out)
    width = S_out + 3 * V_out
    return torch.tensor(block + [width + r for r in block], dtype=torch.int64)


def fuse3_perm(S: int, V: int) -> torch.Tensor:
    """Columns of a j-major [s (S) | SVFuse (3V)] output in the reference's
    c-major order: ``x_jmajor[..., perm] == x_cmajor`` (the part
    segmentation engine's row-major tail)."""
    inv = [0] * (3 * V)
    for j in range(3):
        for c in range(V):
            inv[c * 3 + j] = j * V + c
    return torch.tensor(list(range(S)) + [S + i for i in inv],
                        dtype=torch.int64)


def head8_rows(S5: int, V5: int, mid: int, S_c: int, V_c: int) -> torch.Tensor:
    """Rows of the part segmentation head's conv8 for the channel-major
    tail's input [x_max (S5 + 3V5, SVFuse j-major) | x_pool and the label
    (mid, c-major) | x_fine (S_c + 3V_c, Vector2Scalar j-outer)]:
    ``net_cm @ W[rows] == net_reference @ W``."""
    rows = list(range(S5)) + _jmajor(S5, V5)
    off = S5 + 3 * V5
    rows += [off + i for i in range(mid)]
    off += mid
    rows += [off + i for i in range(S_c)] + _jmajor(off + S_c, V_c)
    return torch.tensor(rows, dtype=torch.int64)
