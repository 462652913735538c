"""Un-fused train-mode forwards of SV-DGCNN classification and part
segmentation (counterparts of ``svnet_tpu/models/sv_dgcnn.py::
SV_DGCNN_CLS`` and ``SV_DGCNN_PSEG.apply(..., train=True,
mutable=["batch_stats"])``, the flax path the JAX trainer takes where its
fused train forward is off, ``config.fused_train``).

``apply(params, batch_stats, points, [label,] generator=None) -> (logits,
new_batch_stats)``, the signatures of ``train.fused``'s applies.
Every round builds its (B, N, k, ...) edges: kNN (kernel B4 on the card)
and the neighbour gather (kernel B7) of the points, then of each round's
joint [s, flat(v)] features. The joint features depend on the weights, so
the gathers of conv2-4 run B7's scatter-add backward in every step; the
gather of the points runs forward only. The SVBlocks are the train-mode
layers of ``nn/sv_train.py`` on the edges, and the pool over k is
``torch.amax``, whose gradient is split evenly among tied entries, as
flax's ``max`` splits it; conv5, SVFuse and the head are the fused path's
(``train.fused.tail`` and ``tail_pseg``). Knob-aware training
(``knobs``) builds the rounds' edges as the eager models do
(``models.sv_dgcnn.knob_graph``).

The fused path (``train/fused.py``, kernels B5/B6) is the trainer's on
the card: it keeps the edges out of device memory. This path is the flax
semantics it departs from (ROADMAP C5, C11), at the cost of the edges in
memory.
"""

from __future__ import annotations

from svnet_tpu_torch.models.sv_dgcnn import knob_graph, trunk_edges
from svnet_tpu_torch.nn import sv_train as svt
from svnet_tpu_torch.ops.graph import svpool
from svnet_tpu_torch.train.fused import ROUNDS, tail, tail_pseg


def make_trunk(k: int, binary: bool, oracle: bool, knobs=None):
    """``trunk(params, batch_stats, points) -> (outs, new)``: the four
    rounds' pooled (s, v), their widths from the weights, and their new
    running statistics."""

    def trunk(p, bs, points):
        new = {}
        v, idx0 = trunk_edges(points, k, knobs, oracle)  # (B, N, k, 3, 2)
        x = (svt.v2s_train(p["init_scalar"], v), v)
        x, new["conv1"] = svt.svblock_train(p["conv1"], bs["conv1"], x, False)
        outs, wins = [svpool(x)], None
        for name in ROUNDS:
            e, wins = knob_graph(outs[-1], k, idx0, wins, name, knobs, oracle)
            x, new[name] = svt.svblock_train(p[name], bs[name], e, binary)
            outs.append(svpool(x))
        return outs, new

    return trunk


def make_train_apply_cls(num_classes: int, k: int, binary: bool,
                         dropout: float = 0.5, oracle: bool = False,
                         knobs=None):
    """Returns ``apply(params, batch_stats, points, generator=None) ->
    (logits, new_batch_stats)`` of ``SV_DGCNN_CLS`` in train mode. The FP
    model's head dropout draws from ``generator`` when one is given (none:
    no dropout). ``knobs``: the resolved ``config.TrainKnobs``, None for
    none. ``oracle=True`` runs the kNN and the gather's plain versions on
    any device; it is never chosen for the caller."""
    del num_classes  # the head's width comes from the weights
    trunk = make_trunk(k, binary, oracle, knobs)

    def apply(params, batch_stats, points, generator=None):
        outs, new = trunk(params, batch_stats, points)
        return tail(params, batch_stats, new, outs, binary, dropout, generator)

    return apply


def make_train_apply_pseg(num_part: int, k: int, binary: bool,
                          dropout: float = 0.5, oracle: bool = False,
                          knobs=None):
    """Returns ``apply(params, batch_stats, points, label, generator=None)
    -> (logits (B, N, num_part), new_batch_stats)`` of ``SV_DGCNN_PSEG`` in
    train mode: the trunk of ``make_train_apply_cls`` at the part
    segmenter's widths (B4 x4, B7 forward x4 and backward x3 on the card),
    then ``train.fused.tail_pseg`` with the (B, 16) one-hot ``label``.
    Dropout, ``knobs`` and ``oracle`` as there."""
    del num_part  # the head's width comes from the weights
    trunk = make_trunk(k, binary, oracle, knobs)

    def apply(params, batch_stats, points, label, generator=None):
        outs, new = trunk(params, batch_stats, points)
        return tail_pseg(params, batch_stats, new, outs, label, binary, dropout,
                         generator)

    return apply
