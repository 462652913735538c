"""A/B of the pre-pass kernels and B7's backward on the card:
chip_smoke.py's own comparisons, run on the package of one checkout.

    python svnet_tpu_torch/utils/bench_prepass.py [--root DIR]

On seeded Gaussian inputs (the pre-passes do the same work on any input)
it runs chip_smoke.py's ``compare_neg_min`` at the serving paths' round
inputs (cls (128, 1024, C), C = 3 / 62 / 127; partseg (32, 2048, C), C =
3 / 80 / 136), its ``compare_prepass`` (``window_tau`` and
``window_keep``, k = 20; names ending " gauss") and
``compare_neg_min_window`` (no window certifies such input: ok = 0,
every row) at (16, 8192, C), C = 3 / 62 / 127; ``compare_prepass`` on
the windowed rounds' own inputs (names ending " path": the four rounds
of the exact SV-DGCNN classifier with the window on Morton-sorted
surface clouds (16, 8192)); ``compare_edge_gather`` (B7 at (32, 1024,
20), C = 3 / 62 / 127); and ``request_median`` of the SV-DGCNN
classifier's fast-mode request (binary, 16-bit gathers, (128, 1024, 20),
20 requests). ``window_keep`` and B7's backward are also split by
kernel, in device time (torch.profiler): at C = 3 a wrapper's time is
the host's. Each comparison holds the kernel bitwise its plain version
and logs its times; the last line is one JSON object: the card's name
and power limit, the revision, the request's median ms, every Report
entry (kernel ms, plain ms, bound, library ms) and the splits.

``--root DIR`` takes ``svnet_tpu_torch`` from another checkout whose
wrappers take the same arguments (an older revision unpacked with ``git
archive``), so that two revisions are timed in turns in one call on one
card (parent, change, change, parent). Needs the card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CLS = [(128, 1024, c) for c in (3, 62, 127)]
PSEG = [(32, 2048, c) for c in (3, 80, 136)]
LONG = [(16, 8192, c) for c in (3, 62, 127)]
K, T, W = 20, 256, 4096  # the long cloud's k, key tile and window


def window_inputs(w, cs, dev):
    """The inputs (B, N, C) of the four windowed rounds of one exact
    SV-DGCNN cls request (weights ``w``) on Morton-sorted surface clouds
    (16, 8192), read where each round calls its pre-pass (chip_smoke.py's
    ``window_stats``), at the W that chip_smoke.py's phase 2 finds for B1."""
    import torch

    from svnet_tpu_torch.infer import SVDGCNNClsEngine
    from svnet_tpu_torch.ops.kernels import quant

    pts = cs.surface(cs.B_LONG, cs.N_LONG, cs.SEED + 40, dev)
    W = cs.window_for(pts, K, quant.round3_tiles(cs.N_LONG, 3, "exact"))
    eng = SVDGCNNClsEngine(w, cs.CLASSES, K, True, device=dev, window=W)
    seen = []
    with cs.window_stats([], seen):
        eng(pts)
        torch.cuda.synchronize()
    return seen


def device_split(fn, reps: int = 20) -> dict:
    """Device ms a call of fn() by kernel (and memset) name, from
    torch.profiler over reps calls after one warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if us > 0:
            out[e.key] = us / reps / 1e3
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=REPO)
    root = ap.parse_args(argv).root.resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    from svnet_tpu_torch import config
    from svnet_tpu_torch.infer import SVDGCNNClsEngine
    from svnet_tpu_torch.models.sv_dgcnn import init_params
    from svnet_tpu_torch.ops import window as win
    from svnet_tpu_torch.ops.kernels import edge_gather as eg
    from svnet_tpu_torch.ops.kernels import quant

    if not torch.cuda.is_available():
        print("bench_prepass: no CUDA device", file=sys.stderr)
        return 1
    dev = config.require_cuda("cuda")
    config.set_full_fp32()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    gen = torch.Generator().manual_seed(cs.SEED)
    rep = cs.Report()
    for tag, shapes in (("cls", CLS), ("pseg", PSEG)):
        for shape in shapes:
            x = torch.randn(*shape, generator=gen).to(dev)
            cs.compare_neg_min(rep, f"neg_min {tag}", x, True)
    split = {}

    def record_split(name, fn):
        split[name] = device_split(fn)
        print(f"{name} split (ms a call): {split[name]}", flush=True)

    for shape in LONG:
        x = torch.randn(*shape, generator=gen).to(dev)
        boxes = cs.compare_prepass(rep, x, K, T, W, " gauss")
        record_split(f"window_keep gauss C={shape[-1]}",
                     lambda: win.window_keep(x, *boxes, T))
        if shape[-1] > 3:
            cs.compare_neg_min_window(rep, "neg_min window", x, K, T, W)
    w = init_params(cs.CLASSES, K, True, torch.Generator().manual_seed(cs.SEED))
    for i, x in enumerate(window_inputs(w, cs, dev)):
        t = quant.round3_tiles(x.shape[1], x.shape[-1], "exact")
        boxes = cs.compare_prepass(rep, x, K, t, W, " path")
        record_split(f"window_keep path round {i + 1} C={x.shape[-1]}",
                     lambda: win.window_keep(x, *boxes, t))
    for c in (3, 62, 127):
        g, idx = cs.compare_edge_gather(rep, cs.B_TRAIN, cs.N, K, c, gen, dev)
        record_split(f"edge_gather_bwd C={c}",
                     lambda: eg.edge_gather_bwd(g, idx, cs.N))
    eng = SVDGCNNClsEngine(w, cs.CLASSES, K, True, device=dev, mode="fast")
    requests = [(cs.cloud(cs.B, cs.N, gen, dev),) for _ in range(20)]
    print(json.dumps({"card": card.splitlines()[dev.index], "rev": root.name,
                      "request_ms": cs.request_median(eng, requests),
                      "kernels": rep.ms, "split": split}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
