"""Trained-checkpoint certification of the serving knob ladder (counterpart
of tools/certify_serving.sh): one checkpoint evaluated through the fused
engine at each serving configuration, leg by leg, printing each leg's
test acc or IoU line.

    python -m svnet_tpu_torch.cli.certify_serving {cls|partseg} CKPT DATADIR \\
        [trainer flags, e.g. --device cpu --num-points 64 --k 4]

Each leg runs ``main_cls_dgcnn`` / ``main_partseg_dgcnn`` with ``--model
svnet --binary --test CKPT --fused`` and the leg's knobs (``CERT_LEGS``:
``R`` is k / 2, and part segmentation's approx legs fold to 512), in this
process; the extra flags go to every leg. A leg that fails prints its log
to stderr and stops the run with exit code 1, as the script's ``set -e``
does.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import re
import sys

# tools/certify_serving.sh's legs, in its order (--reuse-k R is k / 2; fold
# 512 on part segmentation's approx legs)
CERT_LEGS = ([["--engine-mode", "exact"], ["--engine-mode", "fast"],
              ["--engine-mode", "approx"],
              ["--engine-mode", "approx", "--approx-gather-bits", "8"]]
             + [["--engine-mode", "approx"] + bits + ["--graph-reuse", reuse] + rk
                for bits, rk in (([], []), (["--approx-gather-bits", "8"], []),
                                 (["--approx-gather-bits", "8"], ["--reuse-k", "R"]))
                for reuse in ("conv2", "spatial")])
K_DEFAULT = {"cls": 20, "partseg": 40}
_RESULT = re.compile(r"test.*(acc|iou)", re.IGNORECASE)


def leg_argv(task: str, leg: list, k: int) -> list:
    """A leg's knobs for ``task`` at ``k``: ``R`` made k / 2, and
    ``--approx-fold 512`` on part segmentation's approx legs."""
    leg = [str(k // 2) if a == "R" else a for a in leg]
    if task == "partseg" and "approx" in leg:
        leg = leg + ["--approx-fold", "512"]
    return leg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("task", choices=sorted(K_DEFAULT))
    ap.add_argument("ckpt")
    ap.add_argument("data_dir")
    ap.add_argument("--k", type=int, default=0,
                    help="neighbours (default 20 for cls, 40 for partseg)")
    ap.add_argument("--save-dir", default=None,
                    help="the legs' logs (default results/certify_TASK)")
    args, extra = ap.parse_known_args(argv)
    if not os.path.exists(args.ckpt):
        print(f"checkpoint not found: {args.ckpt}", file=sys.stderr)
        return 2
    if args.task == "cls":
        from svnet_tpu_torch.cli.main_cls_dgcnn import main as trainer_main
    else:
        from svnet_tpu_torch.cli.main_partseg_dgcnn import main as trainer_main
    k = args.k or K_DEFAULT[args.task]
    save_dir = args.save_dir or os.path.join("results", f"certify_{args.task}")
    base = ["--model", "svnet", "--binary", "--data-dir", args.data_dir,
            "--save-dir", save_dir, "--test", args.ckpt, "--fused",
            "--k", str(k)]
    for leg in CERT_LEGS:
        leg = leg_argv(args.task, leg, k)
        print("=== " + " ".join(leg), flush=True)
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out):
                trainer_main(base + leg + extra)
        except Exception as e:  # noqa: BLE001  (the leg's failure, reported)
            sys.stderr.write(out.getvalue())
            print(f"leg {' '.join(leg)} failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
            return 1
        for line in [l for l in out.getvalue().splitlines()
                     if _RESULT.search(l)][-2:]:
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
