"""A/B of the two pre-pass kernels on the card: chip_smoke.py's own
comparisons, run on the package of one checkout.

    python svnet_tpu_torch/utils/bench_prepass.py [--root DIR]

On seeded Gaussian inputs (the pre-passes do the same work on any input)
it runs chip_smoke.py's ``compare_neg_min`` at the serving paths' round
inputs (cls (128, 1024, C), C = 3 / 62 / 127; partseg (32, 2048, C), C =
3 / 80 / 136), its ``compare_prepass`` (``window_tau`` and
``window_keep``, k = 20) and ``compare_neg_min_window`` (no window
certifies such input: ok = 0, every row) at (16, 8192, C), C = 3 / 62 /
127, and its ``request_median`` of the SV-DGCNN classifier's fast-mode
request (binary, 16-bit gathers, (128, 1024, 20), 20 requests). Each
comparison holds the kernel bitwise its plain version and logs its times;
the last line is one JSON object: the card's name and power limit, the
revision, the request's median ms and every Report entry (kernel ms,
plain ms, bound, library ms).

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
    for shape in LONG:
        x = torch.randn(*shape, generator=gen).to(dev)
        cs.compare_prepass(rep, x, K, T, W)
        if shape[-1] > 3:
            cs.compare_neg_min_window(rep, "neg_min window", x, K, T, W)
    w = init_params(cs.CLASSES, K, True, torch.Generator().manual_seed(cs.SEED))
    eng = SVDGCNNClsEngine(w, cs.CLASSES, K, True, device=dev, mode="fast")
    requests = [(cs.cloud(cs.B, cs.N, gen, dev),) for _ in range(20)]
    print(json.dumps({"card": card.splitlines()[dev.index], "rev": root.name,
                      "request_ms": cs.request_median(eng, requests),
                      "kernels": rep.ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
