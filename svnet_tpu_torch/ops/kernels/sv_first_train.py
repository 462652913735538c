"""Differentiable fused first round (FP) for training, kernel B5
(counterpart of svnet_tpu/ops/pallas/sv_first_train.py::make_fused_first_round).

``fused_round_apply((sv_first_train_fwd, sv_first_train_bwd),
first_dims(S_out, V_out, k), points, idx, params)`` returns ``(s_out (B,
N, S_out), v_out (B, N, 3*V_out) ungated, s_mean (B, 6) c-major,
(bn1_mean, bn1_var, bnn_mean, bnn_var))``, differentiable
in ``points`` and in the leaves of ``params`` = ``{"init_scalar", "v2s",
"linear1", "bn1", "linear2", "bn2"}`` (conv1's subtree without the gate,
plus init_scalar). ``idx`` (B, N, k) int32 carries no gradient.

It is the conv round of ``sv_round3_train`` with S = 0, V = 1 (the three
coordinates) and init_scalar's six invariants in the place of the edge
scalars: the same passes, plain versions and autograd, launched through
csrc/sv_first_train.cu (``sv_first_train_fwd`` / ``sv_first_train_bwd``,
each with a ``.launches`` counter) on a CUDA tensor, the plain versions
on a CPU tensor.
"""

from __future__ import annotations

from svnet_tpu_torch.ops.kernels.sv_round3_train import (
    RoundDims,
    check_inputs,
    fused_round_apply,
    train_bwd_kernel,
    train_bwd_plain,
    train_fwd_kernel,
    train_fwd_plain,
)


def sv_first_train_fwd(points, idx, kp, d: RoundDims):
    """Forward passes of the first round: plain on the CPU, the kernel on
    the card."""
    check_inputs(points, idx, d)
    if points.device.type == "cpu":
        return train_fwd_plain(points, idx, kp, d)
    out = train_fwd_kernel("sv_first_train_launch", points, idx, kp, d)
    sv_first_train_fwd.launches += 1
    return out


def sv_first_train_bwd(points, idx, kp, d: RoundDims, saved, dso, dvo, dssum):
    """Backward passes of the first round: plain on the CPU, the kernel on
    the card."""
    check_inputs(points, idx, d)
    if points.device.type == "cpu":
        return train_bwd_plain(points, idx, kp, d, saved, dso, dvo, dssum)
    out = train_bwd_kernel("sv_first_train_launch", points, idx, kp, d, saved,
                           dso, dvo, dssum)
    sv_first_train_bwd.launches += 1
    return out


sv_first_train_fwd.launches = 0
sv_first_train_bwd.launches = 0


def first_dims(S_out: int, V_out: int, k: int) -> RoundDims:
    return RoundDims(0, 1, S_out, V_out, k, binary=False, first=True)

