"""Un-fused train-mode forward of SV-DGCNN classification (counterpart of
``svnet_tpu/models/sv_dgcnn.py::SV_DGCNN_CLS.apply(..., train=True,
mutable=["batch_stats"])``, the flax path the JAX trainer takes where its
fused train forward is off; train knobs off).

``apply(params, batch_stats, points, generator=None) -> (logits,
new_batch_stats)``, the signature of ``train.fused.make_fused_train_apply``.
Every round builds its (B, N, k, ...) edges: kNN (kernel B4 on the card)
and the neighbour gather (kernel B7) of the points, then of each round's
joint [s, flat(v)] features. The joint features depend on the weights, so
the gathers of conv2-4 run B7's scatter-add backward in every step; the
gather of the points runs forward only. The SVBlocks are the train-mode
layers of ``nn/sv_train.py`` on the edges, and the pool over k is
``torch.amax``, whose gradient is split evenly among tied entries, as
flax's ``max`` splits it; conv5, SVFuse and the head are the fused path's
(``train.fused.tail``).

The fused path (``train/fused.py``, kernels B5/B6) is the trainer's: it
keeps the edges out of device memory. This path is the flax semantics it
departs from (ROADMAP C5, C11), at the cost of the edges in memory.
"""

from __future__ import annotations

from svnet_tpu_torch.nn import sv_train as svt
from svnet_tpu_torch.ops.graph import get_graph_feature, get_graph_feature_sv, svpool
from svnet_tpu_torch.train.fused import ROUNDS, tail


def make_train_apply_cls(num_classes: int, k: int, binary: bool,
                         dropout: float = 0.5, oracle: bool = False):
    """Returns ``apply(params, batch_stats, points, generator=None) ->
    (logits, new_batch_stats)`` of ``SV_DGCNN_CLS`` in train mode. The FP
    model's head dropout draws from ``generator`` when one is given (none:
    no dropout). ``oracle=True`` runs the kNN and the gather's plain
    versions on any device; it is never chosen for the caller."""
    del num_classes  # the head's width comes from the weights

    def apply(params, batch_stats, points, generator=None):
        p, bs = params, batch_stats
        new = {}
        v = get_graph_feature(points, k, plain=oracle)  # (B, N, k, 3, 2)
        x = (svt.v2s_train(p["init_scalar"], v), v)
        x, new["conv1"] = svt.svblock_train(p["conv1"], bs["conv1"], x, False)
        outs = [svpool(x)]
        for name in ROUNDS:
            e = get_graph_feature_sv(outs[-1], k, plain=oracle)
            x, new[name] = svt.svblock_train(p[name], bs[name], e, binary)
            outs.append(svpool(x))
        return tail(p, bs, new, outs, binary, dropout, generator)

    return apply
