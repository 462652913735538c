"""The serving kernels as ``torch.library`` custom ops (namespace
``svnet::``), so that ``torch.export`` traces an engine through them and
an exported program calls each kernel by name (serve.py).

Each op wraps one public wrapper, not its raw launch: the host code around
a launch (the fast and approx key tiles, the pre-pass, the window's
certificate, the ids' range check) runs inside the op, where no tracer
sees it. The op has two implementations, one for each device: on a CUDA
tensor the wrapper launches its kernel (and counts the launch on its
``launches``, as an eager call does), on a CPU tensor it runs its plain
version. Its fake implementation gives the output shapes and dtypes (ids
int32) for tracing.

A custom op takes no dict: a folded weight dict goes as a ``Tensor[]`` in
the fixed key order kept beside the op (``FIRST_KEYS``, ``CONV_KEYS``,
``POINT_KEYS``). A selecting round's op also takes the
``config`` knobs its wrapper reads (``KNOBS``), as they stood when it was
called or traced, and runs the wrapper under them. It returns a fixed number of outputs,
each contiguous and none an input or a view of one: the selecting rounds
always return their ids (the kernels write them anyway), and the Python
functions below, the engines' entry points, drop them where the wrapper
would. Every output is contiguous where the kernel's already is, so a
call on the card is the wrapper's, bitwise and launch for launch.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import torch
from torch import Tensor

from svnet_tpu_torch import config

from svnet_tpu_torch.ops.kernels import knn as _knn
from svnet_tpu_torch.ops.kernels import sv_block_point as _bp
from svnet_tpu_torch.ops.kernels import sv_edge as _edge
from svnet_tpu_torch.ops.kernels import sv_edge_first as _edge_first
from svnet_tpu_torch.ops.kernels import sv_point as _point
from svnet_tpu_torch.ops.kernels import sv_round as _r1
from svnet_tpu_torch.ops.kernels import sv_round2 as _r2
from svnet_tpu_torch.ops.kernels import sv_round3 as _r3
from svnet_tpu_torch.ops.kernels.fold import Folded

NS = "svnet"
DEVICES = ("cpu", "cuda")
# the folded dicts' keys, in the order of the ops' Tensor[] weights
FIRST_KEYS = ("wz0", "wz1", "w1", "a1", "b1", "w2", "a2", "b2")
CONV_KEYS = ("wz", "w1", "beta", "a1", "b1", "w2", "scale2", "a2", "b2")
POINT_KEYS = CONV_KEYS + ("wzf",)
# the config knobs a selecting round reads inside its wrapper (the gather
# grids, the key tile, the fold): passed to its op as ``knobs``, read when
# the call is traced, so an exported program keeps the composition it was
# exported under
KNOBS = ("fast_gather_bits", "approx_gather_bits", "approx_fold")


def _knobs() -> List[int]:
    return [getattr(config, name) for name in KNOBS]


@contextlib.contextmanager
def _knob_scope(values: List[int]):
    """``config``'s knobs at ``values`` for one op call, restored after."""
    was = _knobs()
    try:
        for name, value in zip(KNOBS, values):
            setattr(config, name, value)
        yield
    finally:
        for name, value in zip(KNOBS, was):
            setattr(config, name, value)


def _flat(folded: Folded, keys: tuple) -> List[Tensor]:
    return [folded[k] for k in keys]


def _fresh(outs, inputs) -> tuple:
    """The outputs contiguous, and copied where one shares an input's
    storage: a custom op returns no input and no view of one."""
    held = {t.untyped_storage().data_ptr() for t in inputs
            if isinstance(t, Tensor)}
    res = []
    for t in outs:
        t = t.contiguous()
        if t.untyped_storage().data_ptr() in held:
            t = t.clone()
        res.append(t)
    return tuple(res)


def _op(name: str, fake):
    """Register ``fn`` as ``svnet::name`` on the CPU and CUDA, with the
    fake implementation ``fake``."""
    def register(fn):
        op = torch.library.custom_op(f"{NS}::{name}", fn, mutates_args=(),
                                     device_types=DEVICES)
        op.register_fake(fake)
        return op
    return register


def _empty(like: Tensor, *shape, dtype=torch.float32) -> Tensor:
    return like.new_empty(shape, dtype=dtype)


# ---------------------------------------------------------------------------
# B1 and B2 (round3 trunk; B1 also the SV-PointNet engines' first round)
# ---------------------------------------------------------------------------


def _first_fake(points, w, S_out, V_out, k, cross, mode, T, window, knobs):
    B, N, _ = points.shape
    return (_empty(points, B, S_out, N), _empty(points, B, 3 * V_out, N),
            _empty(points, B, 9 if cross else 6),
            _empty(points, B, k, N, dtype=torch.int32))


@_op("sv_round3_first", _first_fake)
def _sv_round3_first(points: Tensor, w: List[Tensor], S_out: int, V_out: int,
                     k: int, cross: bool, mode: str, T: Optional[int],
                     window: int, knobs: List[int]
                     ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    with _knob_scope(knobs):
        out = _r3.sv_round3_first(points, dict(zip(FIRST_KEYS, w)),
                                  S_out=S_out, V_out=V_out, k=k, cross=cross,
                                  mode=mode, T=T, emit_wins=True,
                                  window=window)
    return _fresh(out, [points, *w])


def _conv_fake(src, w, S, V, S_out, V_out, k, binary, mode, T, window, knobs):
    B, _, N = src.shape
    return (_empty(src, B, S_out, N), _empty(src, B, 3 * V_out, N),
            _empty(src, B, 2 * S), _empty(src, B, k, N, dtype=torch.int32))


@_op("sv_round3", _conv_fake)
def _sv_round3(src: Tensor, w: List[Tensor], S: int, V: int, S_out: int,
               V_out: int, k: int, binary: bool, mode: str, T: Optional[int],
               window: int, knobs: List[int]
               ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    with _knob_scope(knobs):
        out = _r3.sv_round3(src, dict(zip(CONV_KEYS, w)), S=S, V=V,
                            S_out=S_out, V_out=V_out, k=k, binary=binary,
                            mode=mode, T=T, emit_wins=True, window=window)
    return _fresh(out, [src, *w])


def _reuse_fake(src, wins, w, S, V, S_out, V_out, k, binary, mode, emitted,
                knobs):
    B, _, N = src.shape
    return (_empty(src, B, S_out, N), _empty(src, B, 3 * V_out, N),
            _empty(src, B, 2 * S))


@_op("sv_round3_reuse", _reuse_fake)
def _sv_round3_reuse(src: Tensor, wins: Tensor, w: List[Tensor], S: int,
                     V: int, S_out: int, V_out: int, k: int, binary: bool,
                     mode: str, emitted: bool, knobs: List[int]
                     ) -> Tuple[Tensor, Tensor, Tensor]:
    with _knob_scope(knobs):
        out = _r3.sv_round3_reuse(src, wins, dict(zip(CONV_KEYS, w)), S=S,
                                  V=V, S_out=S_out, V_out=V_out, k=k,
                                  binary=binary, mode=mode, emitted=emitted)
    return _fresh(out, [src, wins, *w])


def sv_round3_first(points: Tensor, folded: Folded, *, S_out: int, V_out: int,
                    k: int, cross: bool = False, mode: str = "exact",
                    T: int | None = None, emit_wins: bool = False,
                    window: int = 0):
    """``sv_round3.sv_round3_first`` through ``svnet::sv_round3_first``."""
    out = torch.ops.svnet.sv_round3_first(points, _flat(folded, FIRST_KEYS),
                                          S_out, V_out, k, cross, mode, T,
                                          window, _knobs())
    return out if emit_wins else out[:3]


def sv_round3(src: Tensor, folded: Folded, *, S: int, V: int, S_out: int,
              V_out: int, k: int, binary: bool = True, mode: str = "exact",
              T: int | None = None, emit_wins: bool = False,
              wins_in: Tensor | None = None, gather_window: int = 0,
              emitted: bool = False, window: int = 0):
    """``sv_round3.sv_round3`` through ``svnet::sv_round3``, or, given
    ``wins_in``, ``svnet::sv_round3_reuse``; the same refusals."""
    if gather_window < 0 or gather_window % 128:
        raise ValueError(f"gather_window={gather_window}: 0 or a multiple of 128")
    w = _flat(folded, CONV_KEYS)
    if wins_in is not None:
        if emit_wins or window:
            raise ValueError("wins_in (graph reuse) excludes emit_wins and "
                             "the window")
        return torch.ops.svnet.sv_round3_reuse(src, wins_in, w, S, V, S_out,
                                               V_out, k, binary, mode, emitted,
                                               _knobs())
    if gather_window:
        raise ValueError("gather_window requires wins_in (a graph-reuse round)")
    out = torch.ops.svnet.sv_round3(src, w, S, V, S_out, V_out, k, binary,
                                    mode, T, window, _knobs())
    return out if emit_wins else out[:3]


# ---------------------------------------------------------------------------
# B3 and B3r (the SV-DGCNN tails), B8 (the SV-PointNet blocks)
# ---------------------------------------------------------------------------


def _point_cm_fake(src, gate, w, S, V, S_out, V_out, v_off, binary):
    B, _, N = src.shape
    return (_empty(src, B, S_out + 3 * V_out, N), _empty(src, B, S_out),
            _empty(src, B, 3 * V_out))


@_op("sv_point_block_cm", _point_cm_fake)
def _sv_point_block_cm(src: Tensor, gate: Tensor, w: List[Tensor], S: int,
                       V: int, S_out: int, V_out: int, v_off: List[int],
                       binary: bool) -> Tuple[Tensor, Tensor, Tensor]:
    pairs = tuple(zip(v_off[0::2], v_off[1::2]))
    out = _point.sv_point_block_cm(src, gate, dict(zip(POINT_KEYS, w)), S=S,
                                   V=V, S_out=S_out, V_out=V_out,
                                   v_off=pairs, binary=binary)
    return _fresh(out, [src, gate, *w])


def _point_fake(src, gate, w, S, V, S_out, V_out, binary):
    B, N, _ = src.shape
    return (_empty(src, B, N, S_out + 3 * V_out), _empty(src, B, S_out),
            _empty(src, B, 3 * V_out))


@_op("sv_point_block", _point_fake)
def _sv_point_block(src: Tensor, gate: Tensor, w: List[Tensor], S: int,
                    V: int, S_out: int, V_out: int,
                    binary: bool) -> Tuple[Tensor, Tensor, Tensor]:
    out = _point.sv_point_block(src, gate, dict(zip(POINT_KEYS, w)), S=S,
                                V=V, S_out=S_out, V_out=V_out, binary=binary)
    return _fresh(out, [src, gate, *w])


def _block_point_fake(src, gate, w, S, V, S_out, V_out, binary):
    B, N, _ = src.shape
    return _empty(src, B, N, S_out), _empty(src, B, N, 3 * V_out)


@_op("sv_block_point", _block_point_fake)
def _sv_block_point(src: Tensor, gate: Tensor, w: List[Tensor], S: int,
                    V: int, S_out: int, V_out: int,
                    binary: bool) -> Tuple[Tensor, Tensor]:
    out = _bp.sv_block_point(src, gate, dict(zip(CONV_KEYS, w)), S=S, V=V,
                             S_out=S_out, V_out=V_out, binary=binary)
    return _fresh(out, [src, gate, *w])


def sv_point_block_cm(src: Tensor, gate: Tensor, folded: Folded, *, S: int,
                      V: int, S_out: int, V_out: int, v_off: tuple,
                      binary: bool = True):
    """``sv_point.sv_point_block_cm`` through ``svnet::sv_point_block_cm``."""
    flat = [int(x) for pair in v_off for x in pair]
    return torch.ops.svnet.sv_point_block_cm(src, gate,
                                             _flat(folded, POINT_KEYS), S, V,
                                             S_out, V_out, flat, binary)


def sv_point_block(src: Tensor, gate: Tensor, folded: Folded, *, S: int,
                   V: int, S_out: int, V_out: int, binary: bool = True):
    """``sv_point.sv_point_block`` through ``svnet::sv_point_block``."""
    return torch.ops.svnet.sv_point_block(src, gate, _flat(folded, POINT_KEYS),
                                          S, V, S_out, V_out, binary)


def sv_block_point(src: Tensor, gate: Tensor, folded: Folded, *, S: int,
                   V: int, S_out: int, V_out: int, binary: bool = True):
    """``sv_block_point.sv_block_point`` through ``svnet::sv_block_point``."""
    return torch.ops.svnet.sv_block_point(src, gate, _flat(folded, CONV_KEYS),
                                          S, V, S_out, V_out, binary)


# ---------------------------------------------------------------------------
# B10b and B10a (the legacy row-major trunks)
# ---------------------------------------------------------------------------


def _rm_first_fake(points, w, S_out, V_out, k, cross, mode, T, knobs):
    B, N, _ = points.shape
    return (_empty(points, B, N, S_out), _empty(points, B, N, 3 * V_out),
            _empty(points, B, 9 if cross else 6),
            _empty(points, B, N, k, dtype=torch.int32))


def _rm_conv_fake(src, w, S, V, S_out, V_out, k, binary, mode, T, knobs):
    B, N, _ = src.shape
    return (_empty(src, B, N, S_out), _empty(src, B, N, 3 * V_out),
            _empty(src, B, 2 * S), _empty(src, B, N, k, dtype=torch.int32))


@_op("sv_round2_first", _rm_first_fake)
def _sv_round2_first(points: Tensor, w: List[Tensor], S_out: int, V_out: int,
                     k: int, cross: bool, mode: str, T: int, knobs: List[int]
                     ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    with _knob_scope(knobs):
        out = _r2.sv_round2_first(points, dict(zip(FIRST_KEYS, w)),
                                  S_out=S_out, V_out=V_out, k=k, cross=cross,
                                  mode=mode, T=T, emit_wins=True)
    return _fresh(out, [points, *w])


@_op("sv_round2", _rm_conv_fake)
def _sv_round2(src: Tensor, w: List[Tensor], S: int, V: int, S_out: int,
               V_out: int, k: int, binary: bool, mode: str, T: int,
               knobs: List[int]) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    with _knob_scope(knobs):
        out = _r2.sv_round2(src, dict(zip(CONV_KEYS, w)), S=S, V=V,
                            S_out=S_out, V_out=V_out, k=k, binary=binary,
                            mode=mode, T=T, emit_wins=True)
    return _fresh(out, [src, *w])


@_op("sv_round_first", lambda *a: _rm_first_fake(*a)[:3])
def _sv_round_first(points: Tensor, w: List[Tensor], S_out: int, V_out: int,
                    k: int, cross: bool, exact: bool, T: int,
                    knobs: List[int]) -> Tuple[Tensor, Tensor, Tensor]:
    with _knob_scope(knobs):
        out = _r1.sv_round_first(points, dict(zip(FIRST_KEYS, w)),
                                 S_out=S_out, V_out=V_out, k=k, cross=cross,
                                 exact=exact, T=T)
    return _fresh(out, [points, *w])


@_op("sv_round", lambda *a: _rm_conv_fake(*a)[:3])
def _sv_round(src: Tensor, w: List[Tensor], S: int, V: int, S_out: int,
              V_out: int, k: int, binary: bool, exact: bool, T: int,
              knobs: List[int]) -> Tuple[Tensor, Tensor, Tensor]:
    with _knob_scope(knobs):
        out = _r1.sv_round(src, dict(zip(CONV_KEYS, w)), S=S, V=V,
                           S_out=S_out, V_out=V_out, k=k, binary=binary,
                           exact=exact, T=T)
    return _fresh(out, [src, *w])


def sv_round2_first(points: Tensor, folded: Folded, *, S_out: int, V_out: int,
                    k: int, cross: bool = False, mode: str = "exact",
                    T: int = 128, emit_wins: bool = False):
    """``sv_round2.sv_round2_first`` through ``svnet::sv_round2_first``."""
    out = torch.ops.svnet.sv_round2_first(points, _flat(folded, FIRST_KEYS),
                                          S_out, V_out, k, cross, mode, T,
                                          _knobs())
    return out if emit_wins else out[:3]


def sv_round2(src: Tensor, folded: Folded, *, S: int, V: int, S_out: int,
              V_out: int, k: int, binary: bool = True, mode: str = "exact",
              T: int = 128, emit_wins: bool = False):
    """``sv_round2.sv_round2`` through ``svnet::sv_round2``."""
    out = torch.ops.svnet.sv_round2(src, _flat(folded, CONV_KEYS), S, V,
                                    S_out, V_out, k, binary, mode, T, _knobs())
    return out if emit_wins else out[:3]


def sv_round_first(points: Tensor, folded: Folded, *, S_out: int, V_out: int,
                   k: int, cross: bool = False, exact: bool = True,
                   T: int = 256):
    """``sv_round.sv_round_first`` through ``svnet::sv_round_first``."""
    return torch.ops.svnet.sv_round_first(points, _flat(folded, FIRST_KEYS),
                                          S_out, V_out, k, cross, exact, T,
                                          _knobs())


def sv_round(src: Tensor, folded: Folded, *, S: int, V: int, S_out: int,
             V_out: int, k: int, binary: bool = True, exact: bool = True,
             T: int = 128):
    """``sv_round.sv_round`` through ``svnet::sv_round``."""
    return torch.ops.svnet.sv_round(src, _flat(folded, CONV_KEYS), S, V, S_out,
                                    V_out, k, binary, exact, T, _knobs())


# ---------------------------------------------------------------------------
# B10d, B10c and B4 (the classifier's edge trunk)
# ---------------------------------------------------------------------------


def _edge_first_fake(points, idx, w, S_out, V_out, k, exact):
    B, N, _ = points.shape
    return (_empty(points, B, N, S_out), _empty(points, B, N, 3 * V_out),
            _empty(points, B, 6))


@_op("sv_edge_first_block", _edge_first_fake)
def _sv_edge_first_block(points: Tensor, idx: Tensor, w: List[Tensor],
                         S_out: int, V_out: int, k: int,
                         exact: bool) -> Tuple[Tensor, Tensor, Tensor]:
    out = _edge_first.sv_edge_first_block(points, idx,
                                          dict(zip(FIRST_KEYS, w)),
                                          S_out=S_out, V_out=V_out, k=k,
                                          exact=exact)
    return _fresh(out, [points, idx, *w])


def _edge_fake(src, idx, gate, w, S, V, S_out, V_out, k, binary, exact):
    B, N, _ = src.shape
    return _empty(src, B, N, S_out), _empty(src, B, N, 3 * V_out)


@_op("sv_edge_block", _edge_fake)
def _sv_edge_block(src: Tensor, idx: Tensor, gate: Tensor, w: List[Tensor],
                   S: int, V: int, S_out: int, V_out: int, k: int,
                   binary: bool, exact: bool) -> Tuple[Tensor, Tensor]:
    out = _edge.sv_edge_block(src, idx, gate, dict(zip(CONV_KEYS, w)), S=S,
                              V=V, S_out=S_out, V_out=V_out, k=k,
                              binary=binary, exact=exact)
    return _fresh(out, [src, idx, gate, *w])


def _knn_fake(x, k, mode, tile):
    B, N, _ = x.shape
    return _empty(x, B, N, k, dtype=torch.int32)


@_op("knn", _knn_fake)
def _knn_op(x: Tensor, k: int, mode: str, tile: int) -> Tensor:
    return _fresh([_knn.knn(x, k, mode, tile)], [x])[0]


def sv_edge_first_block(points: Tensor, idx: Tensor, folded: Folded, *,
                        S_out: int, V_out: int, k: int, exact: bool = True):
    """``sv_edge_first.sv_edge_first_block`` through
    ``svnet::sv_edge_first_block``."""
    return torch.ops.svnet.sv_edge_first_block(
        points, idx, _flat(folded, FIRST_KEYS), S_out, V_out, k, exact)


def sv_edge_block(src: Tensor, idx: Tensor, gate: Tensor, folded: Folded, *,
                  S: int, V: int, S_out: int, V_out: int, k: int,
                  binary: bool = True, exact: bool = True):
    """``sv_edge.sv_edge_block`` through ``svnet::sv_edge_block``."""
    return torch.ops.svnet.sv_edge_block(src, idx, gate,
                                         _flat(folded, CONV_KEYS), S, V, S_out,
                                         V_out, k, binary, exact)


def knn(x: Tensor, k: int, mode: str = "exact", tile: int = 128) -> Tensor:
    """``kernels.knn.knn`` through ``svnet::knn``."""
    return torch.ops.svnet.knn(x, k, mode, tile)
