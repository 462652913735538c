"""The cls/dgcnn flag surface of the JAX CLI (counterpart of
svnet_tpu/cli/flags.py::build_parser('cls', 'dgcnn')) plus ``--device``.

Every flag of the JAX surface parses; ``check_ported`` raises for a flag
whose feature the port does not have yet (KD, the mesh, profiling, the
fused eval engine, the serving knobs, other models and datasets).
"""

from __future__ import annotations

import argparse

# flag -> value that means "off"; any other value is not ported yet
_NOT_PORTED = {
    "model": "svnet", "dataset": "modelnet40", "preload": None,
    "distill": False, "profile_dir": None, "debug_nans": False,
    "engine_mode": "exact", "approx_fold": 0, "approx_gather_bits": 0,
    "fast_gather_bits": 0, "graph_reuse": "none", "reuse_k": 0,
    "train_knobs": False, "morton_entry": False, "fused": False, "dp": 1,
    "tp": 1,
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Point cloud classification using the DGCNN backbone "
                    "(PyTorch / CUDA)")
    p.add_argument("--model", type=str, default="svnet",
                   choices=["original", "vn", "svnet"])
    p.add_argument("--binary", action="store_true", help="build binary nn")
    p.add_argument("--dataset", type=str, default="modelnet40",
                   choices=["modelnet40", "scanobjectnn"])
    p.add_argument("--subset", type=str, default="hard", choices=["easy", "hard"],
                   help="only for scanobjectnn")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=250)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--wd", type=float, default=1e-4)
    p.add_argument("--num-points", type=int, default=1024)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--opt", choices=["auto", "adam", "sgd"], default="auto",
                   help="'auto': Adam if --binary, SGD lr x 100 otherwise")
    p.add_argument("--emb-dims", type=int, default=1024)
    p.add_argument("--k", type=int, default=20)
    p.add_argument("--rot", type=str, default="z", choices=["aligned", "z", "so3"])
    p.add_argument("--rot-test", type=str, default="so3",
                   choices=["aligned", "z", "so3"])
    p.add_argument("--pooling", type=str, default="mean", choices=["mean", "max"],
                   help="VNN only: pooling method")
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--smoothing", action="store_true", default=True,
                   help="label smoothing in the train loss")
    p.add_argument("--test", metavar="PATH", default=None)
    p.add_argument("--resume-from", metavar="PATH", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--data-dir", metavar="DATADIR", type=str, default="data")
    p.add_argument("--save-dir", metavar="SAVEDIR", type=str, default="results")
    p.add_argument("--checkinfo", action="store_true")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--preload", metavar="PATH", default=None)
    p.add_argument("--distill", action="store_true")
    p.add_argument("--kd-t", type=float, default=4.0)
    p.add_argument("--kd-alpha", type=float, default=0.5)
    p.add_argument("--no-kd-init", dest="kd_init", action="store_false")
    p.add_argument("--bn-reestimate", type=int, default=-1, metavar="N",
                   help="re-estimate BN running stats over N train batches "
                        "at fixed weights before each eval; -1 = 60 when "
                        "--binary, else 0 (off)")
    p.add_argument("--profile-dir", metavar="DIR", default=None)
    p.add_argument("--debug-nans", action="store_true")
    p.add_argument("--engine-mode", choices=["exact", "fast", "approx"],
                   default="exact")
    p.add_argument("--approx-fold", type=int, default=0, metavar="L")
    p.add_argument("--approx-gather-bits", type=int, default=0, choices=[0, 8, 16])
    p.add_argument("--fast-gather-bits", type=int, default=0, choices=[0, 8, 16])
    p.add_argument("--graph-reuse", choices=["none", "conv2", "spatial"],
                   default="none")
    p.add_argument("--reuse-k", type=int, default=0, metavar="R")
    p.add_argument("--train-knobs", action="store_true")
    p.add_argument("--morton-entry", action="store_true")
    p.add_argument("--fused", action="store_true")
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default: the card, required) or 'cpu'")
    p.set_defaults(backbone="dgcnn")
    return p


def check_ported(args) -> None:
    """Raise for every flag set to a feature the port does not have."""
    for name, off in _NOT_PORTED.items():
        if getattr(args, name) != off:
            raise NotImplementedError(
                f"--{name.replace('_', '-')}={getattr(args, name)!r} is not "
                "ported to svnet_tpu_torch")
