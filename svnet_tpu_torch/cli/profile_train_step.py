"""Where a train step's device time goes, on the card:

    python -m svnet_tpu_torch.cli.profile_train_step --path pointnet [--task partseg]

Builds the binary model of ``--path`` (pointnet: SV-PointNet through
``train/pointnet.py``; fused: SV-DGCNN through ``train/fused.py``;
unfused: SV-DGCNN through ``train/dgcnn.py``) from seeded weights,
trains it on seeded surface clouds (cls: B=32, N=1024, k=20; partseg:
B=32, N=2048, k=40, 50 parts, random categories and part ids inside each
category's range; rot z, the recipe's Adam). After 3 warm-up steps it
times 5 steps with CUDA events,
then traces 5 more with ``torch.profiler``. Prints
the untraced step time, the device time per step of the kernels by group
(this package's kNN B4, gather B7 and training rounds B5/B6, the matrix
products, everything else PyTorch runs) and by name, their sum, the
device idle share (1 - kernel time / untraced step time; one stream, so
kernels do not overlap), the peak device memory, and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import functools
import subprocess

import numpy as np
import torch

from svnet_tpu_torch import config


WARMUP, STEPS, TOP = 3, 5, 40
# kernel-name substring -> group, first match wins (B7's kernels are
# (anonymous namespace)::eg_*; "::eg_" keeps at::native::neg_kernel out)
_GROUPS = (("sv_knn", "kNN (B4)"), ("sv_sqnorm", "kNN (B4)"), ("::eg_", "gather (B7)"),
           ("sv_train_kernel", "training rounds (B5/B6)"),
           ("gemm", "matrix products"))


def _build(path: str, task: str):
    from svnet_tpu_torch.models import sv_dgcnn, sv_pointnet
    from svnet_tpu_torch.train import dgcnn, fused, pointnet

    gen = torch.Generator().manual_seed(0)
    if task == "partseg":
        if path == "pointnet":
            return (sv_pointnet.init_params_pseg(50, 40, True, gen),
                    pointnet.make_train_apply_pseg(50, 40, True), "pointnet_partseg")
        make = {"fused": fused.make_fused_train_apply_pseg,
                "unfused": dgcnn.make_train_apply_pseg}[path]
        return sv_dgcnn.init_params_pseg(50, 40, True, gen), make(50, 40, True), "dgcnn"
    if path == "pointnet":
        return (sv_pointnet.init_params(40, 20, True, gen),
                pointnet.make_train_apply_cls(40, 20, True), "pointnet_cls")
    make = {"fused": fused.make_fused_train_apply,
            "unfused": dgcnn.make_train_apply_cls}[path]
    return sv_dgcnn.init_params(40, 20, True, gen), make(40, 20, True), "dgcnn"


def _dataset(task: str, m: int, N: int):
    from svnet_tpu_torch.data import ArrayDataset, PartArrayDataset
    from svnet_tpu_torch.train.metrics import INDEX_START, SEG_NUM
    from svnet_tpu_torch.utils.synth import surface_clouds

    rng = np.random.default_rng(0)
    if task == "cls":
        return ArrayDataset(surface_clouds(0, m, N), rng.integers(0, 40, m),
                            train=True, seed=0)
    cat = rng.integers(0, 16, m)
    seg = np.stack([INDEX_START[c] + rng.integers(0, SEG_NUM[c], N) for c in cat])
    return PartArrayDataset(surface_clouds(0, m, N), cat, seg, shuffle=True, seed=0)


def main(argv=None) -> dict:
    from svnet_tpu_torch.data import Loader
    from svnet_tpu_torch.train.losses import cal_loss
    from svnet_tpu_torch.train.steps import create_state, make_train_step

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--path", choices=["pointnet", "fused", "unfused"],
                   default="pointnet")
    p.add_argument("--task", choices=["cls", "partseg"], default="cls")
    args = p.parse_args(argv)
    dev = config.require_cuda("cuda")
    pseg = args.task == "partseg"
    B, N, k = (32, 2048, 40) if pseg else (32, 1024, 20)
    n = WARMUP + 2 * STEPS
    loader = Loader(_dataset(args.task, n * B, N), B, shuffle=True,
                    drop_last=True, seed=0, device=dev)
    weights, apply, recipe = _build(args.path, args.task)
    state = create_state(weights, binary=True, lr=1e-3, epochs=1,
                         steps_per_epoch=n, recipe=recipe, device=dev)
    # partseg: no label smoothing (the CLI's default), the category handed on
    step = make_train_step(apply, functools.partial(cal_loss, smoothing=not pseg),
                           rot="z", with_label=pseg)
    gen = torch.Generator().manual_seed(1)
    batches = list(loader)
    for batch in batches[:WARMUP]:
        step(state, batch, gen)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for batch in batches[WARMUP:WARMUP + STEPS]:
        step(state, batch, gen)
    t1.record()
    torch.cuda.synchronize(dev)
    step_ms = t0.elapsed_time(t1) / STEPS
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for batch in batches[WARMUP + STEPS:]:
            step(state, batch, gen)
        torch.cuda.synchronize(dev)
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if (dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)):
            rows.append((dev_us / 1e3 / STEPS, ev.count // STEPS, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    groups = {}
    for ms, _, name in rows:
        group = next((g for key, g in _GROUPS if key in name), "other (PyTorch)")
        groups[group] = groups.get(group, 0.0) + ms
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    print(f"{args.path} {args.task} train step (binary, B={B}, N={N}, k={k}): "
          f"{step_ms:.3f} ms "
          f"per step (CUDA events, {STEPS} untraced steps after {WARMUP}); "
          f"kernel time {busy:.3f} ms per step ({STEPS} traced steps); device "
          f"idle share "
          f"{1 - busy / step_ms:.3f}; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB | "
          f"{card[dev.index] if card else 'nvidia-smi: no output'}")
    print("  ".join(f"{g} {ms:.3f} ms" for g, ms in
                    sorted(groups.items(), key=lambda kv: -kv[1])))
    print(f"{'ms/step':>9} {'calls':>6}  kernel")
    for ms, calls, name in rows[:TOP]:
        print(f"{ms:9.3f} {calls:6d}  {name[:110]}")
    rest = sum(r[0] for r in rows[TOP:])
    print(f"{rest:9.3f} {'':>6}  ({len(rows) - TOP} other kernels)"
          if len(rows) > TOP else "")
    return {"step_ms": step_ms, "kernel_ms": busy, "groups": groups, "rows": rows}


if __name__ == "__main__":
    main()
