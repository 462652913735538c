"""The flag surface of the JAX CLIs (counterpart of
svnet_tpu/cli/flags.py::build_parser(task, backbone)) plus ``--device``.

Every flag of the JAX surface parses; ``check_ported`` raises
``NotImplementedError`` for a flag whose feature the port does not have
yet (other models, the mesh, profiling, NaN debugging, other datasets)
and ``ValueError`` for a ported flag that would not act where it is given
(``check_acts``, ROADMAP C24), where the JAX CLI ignores it. The ported
datasets are ModelNet40 for classification and ShapeNetPart for part
segmentation.
"""

from __future__ import annotations

import argparse

# flag -> value that means "off"; any other value is not ported yet
_NOT_PORTED = {"model": "svnet", "profile_dir": None, "debug_nans": False,
               "dp": 1, "tp": 1}
# the serving knobs, which act through --fused eval's engines (and three of
# them through --train-knobs): flag -> value that means "not given"
SERVING_KNOBS = {"engine_mode": "exact", "approx_fold": 0,
                 "approx_gather_bits": 0, "fast_gather_bits": 0,
                 "graph_reuse": "none", "reuse_k": 0, "morton_entry": False}
# the ones knob-aware training reads (svnet_tpu/train/fused.py:39-59)
TRAIN_KNOBS = ("graph_reuse", "reuse_k", "approx_gather_bits")
# the dataset each task's port reads
PORTED_DATASET = {"cls": "modelnet40", "partseg": "shapenetpart"}


def build_parser(task: str = "cls", backbone: str = "dgcnn") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=f"Point cloud {task} using the {backbone.upper()} "
                    "backbone (PyTorch / CUDA)")
    if backbone == "dgcnn":
        model_choices = ["original", "vn", "svnet"]
    else:
        model_choices = ["original", "vn", "svnet", "bipointnet"]
    p.add_argument("--model", type=str, default="svnet", choices=model_choices)
    p.add_argument("--binary", action="store_true", help="build binary nn")
    if task == "cls":
        p.add_argument("--dataset", type=str, default="modelnet40",
                       choices=["modelnet40", "scanobjectnn"])
        p.add_argument("--subset", type=str, default="hard",
                       choices=["easy", "hard"], help="only for scanobjectnn")
    else:
        p.add_argument("--dataset", type=str, default="shapenetpart")
        p.add_argument("--class-choice", type=str, default=None)
        p.add_argument("--subset", type=str, default="hard")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=250 if task == "cls" else 200)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--wd", type=float, default=1e-4)
    p.add_argument("--num-points", type=int,
                   default=1024 if task == "cls" else 2048)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--opt", choices=["auto", "adam", "sgd"], default="auto",
                   help="DGCNN: 'auto' is Adam if --binary, SGD lr x 100 "
                        "otherwise; the PointNet recipes always take Adam")
    p.add_argument("--emb-dims", type=int, default=1024)
    p.add_argument("--k", type=int, default=20 if task == "cls" else 40)
    p.add_argument("--rot", type=str, default="z", choices=["aligned", "z", "so3"])
    p.add_argument("--rot-test", type=str, default="so3",
                   choices=["aligned", "z", "so3"])
    p.add_argument("--pooling", type=str, default="mean", choices=["mean", "max"],
                   help="VNN only: pooling method")
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--smoothing", action="store_true", default=(task == "cls"),
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
    p.set_defaults(backbone=backbone, task=task)
    return p


def _flag(name: str) -> str:
    return "--" + name.replace("_", "-")


def _knob_acts(name: str, args) -> bool:
    """Whether the serving knob ``name`` acts: through ``--fused`` eval's
    engine (its mode's knobs; graph reuse and the Morton entry on
    SV-DGCNN only) or through ``--train-knobs``."""
    if name == "reuse_k" and args.graph_reuse == "none":
        return False
    if not args.fused:
        return args.train_knobs and name in TRAIN_KNOBS
    if name in ("graph_reuse", "reuse_k", "morton_entry"):
        return args.backbone == "dgcnn"
    if name in ("approx_fold", "approx_gather_bits"):
        return args.engine_mode == "approx"
    if name == "fast_gather_bits":
        return args.engine_mode == "fast"
    return True


def check_acts(args) -> None:
    """C24: raise ``ValueError`` for a flag that would not act where it is
    given (the JAX CLI ignores it there): ``--fused`` off ``--test`` or on
    SV-PointNet part segmentation; ``--train-knobs`` off binary SV-DGCNN
    or with no knob it reads, or with ``--fused`` (the engines read the
    serving knobs, not it); a
    serving knob that neither ``--fused`` eval nor ``--train-knobs``
    reads (``_knob_acts``); ``--distill`` without ``--preload`` or with
    ``--test``; ``--preload`` without ``--distill``, or ``--distill``'s
    student init, beside ``--test`` or ``--resume-from``, which overwrite
    what it loaded."""
    dgcnn = args.backbone == "dgcnn"
    if args.fused and args.test is None:
        raise ValueError("--fused evaluates a checkpoint: give it with --test")
    if args.fused and not dgcnn and args.task == "partseg":
        raise ValueError("--fused is ported for SV-DGCNN part segmentation "
                         "only (the JAX CLI evaluates SV-PointNet eagerly)")
    if args.train_knobs and not (dgcnn and args.binary):
        raise ValueError("--train-knobs acts on binary SV-DGCNN only")
    if args.train_knobs and args.graph_reuse == "none" and \
            args.approx_gather_bits != 8:
        raise ValueError("--train-knobs reads --graph-reuse and "
                         "--approx-gather-bits 8, and neither is given")
    if args.train_knobs and args.fused:
        raise ValueError("--train-knobs does not act on --fused eval: the "
                         "engines read the serving knobs themselves")
    for name, off in SERVING_KNOBS.items():
        if getattr(args, name) != off and not _knob_acts(name, args):
            raise ValueError(
                f"{_flag(name)}={getattr(args, name)!r} does not act here "
                f"(--fused {args.fused}, --train-knobs {args.train_knobs}, "
                f"--engine-mode {args.engine_mode}, {args.backbone}; C24)")
    if args.distill and args.preload is None:
        raise ValueError("--distill needs its teacher: --preload TEACHER")
    if args.distill and args.test is not None:
        raise ValueError("--distill does not act on --test")
    overwrite = args.test is not None or args.resume_from is not None
    if args.preload is not None and overwrite and (
            not args.distill or args.kd_init):
        what = "--distill's student init" if args.distill else "--preload"
        raise ValueError(f"{what} is overwritten by --test/--resume-from: "
                         "give --no-kd-init, or drop one")


def check_ported(args) -> None:
    """Raise for every flag set to a feature the port does not have, and
    for a ported one that would not act (``check_acts``)."""
    offs = {**_NOT_PORTED, "dataset": PORTED_DATASET[getattr(args, "task", "cls")]}
    for name, off in offs.items():
        if getattr(args, name) != off:
            raise NotImplementedError(
                f"{_flag(name)}={getattr(args, name)!r} is not ported to "
                "svnet_tpu_torch")
    check_acts(args)
