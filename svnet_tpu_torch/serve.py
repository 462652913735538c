"""Ahead-of-time engine serialization for serving (counterpart of
svnet_tpu/serve.py), through ``torch.export``.

``export_engine`` traces an engine's forward (infer.py) at the example
arguments' fixed shapes, with its weights baked in, through the serving
kernels' ``svnet::`` custom ops (ops/kernels/library.py), and returns the
saved program's bytes. ``load_engine`` gives back a callable that needs
no model code: the program calls each kernel by its op's name, and the
op launches it on the card (or runs its plain version on the CPU) as an
eager call does, launch for launch.

Notes
- Shapes and dtypes are fixed at export: export one artifact per (B, N)
  serving configuration.
- The ``config`` knobs (graph reuse, reuse_k, gather bits, fold, Morton
  entry) are read when the engine is traced, as JAX reads them at trace
  time: the artifact keeps the composition it was exported under.
- The artifact holds its tensors on the device the engine was built on: a
  CUDA artifact serves on the card and raises where there is none; a CPU
  artifact runs the kernels' plain versions (for tests).
"""

from __future__ import annotations

import io

import torch

from svnet_tpu_torch.ops.kernels import library  # noqa: F401  (registers the ops)


class _Served(torch.nn.Module):
    """An engine as a module: every tensor the engine holds (its weight
    trees, folds, head permutations) is a buffer, swapped into the
    engine's own containers for the call, so a trace reads the buffers
    and the exported program carries them."""

    def __init__(self, engine):
        super().__init__()
        self._engine = engine
        self._slots = []  # (container, key, buffer name)
        names: dict = {}  # id(tensor) -> buffer name
        seen: set = set()

        def walk(obj, where: str):
            if id(obj) in seen:
                return
            seen.add(id(obj))
            if isinstance(obj, dict):
                items = list(obj.items())
            elif isinstance(obj, list):
                items = list(enumerate(obj))
            elif isinstance(obj, tuple):
                if any(isinstance(v, torch.Tensor) for v in obj):
                    raise TypeError(f"{where}: a tensor in a tuple cannot "
                                    "be swapped for a buffer")
                for i, v in enumerate(obj):
                    walk(v, f"{where}[{i}]")
                return
            else:
                return
            for key, val in items:
                if isinstance(val, torch.Tensor):
                    name = names.get(id(val))
                    if name is None:
                        name = names[id(val)] = f"t{len(names)}"
                        self.register_buffer(name, val)
                    self._slots.append((obj, key, name))
                else:
                    walk(val, f"{where}[{key!r}]")

        walk(vars(engine), "engine")

    def forward(self, *args):
        held = [(c, k, c[k]) for c, k, _ in self._slots]
        try:
            for c, k, name in self._slots:
                c[k] = getattr(self, name)
            return self._engine(*args)
        finally:
            for c, k, t in held:
                c[k] = t


def export_program(engine, *example_args) -> torch.export.ExportedProgram:
    """The engine's forward traced for the example args' shapes and dtypes
    (``torch.export.export``, non-strict, under ``torch.no_grad()``)."""
    with torch.no_grad():
        return torch.export.export(_Served(engine), tuple(example_args),
                                   strict=False)


def export_engine(engine, *example_args) -> bytes:
    """Serialize an engine's forward for the example args' shapes/dtypes.

    ``engine``: any infer.py engine, any trunk and mode. Returns the saved
    program's bytes (``torch.export.save``); write them wherever the
    deployment stores binaries."""
    buf = io.BytesIO()
    torch.export.save(export_program(engine, *example_args), buf)
    return buf.getvalue()


def load_engine(blob: bytes):
    """Deserialize an exported engine; returns a callable(points[, label]).

    A CUDA artifact sets full-f32 matmuls first (``config.set_full_fp32``:
    TF32 in the heads would flip binarization signs, C7), as the engine
    does when it is built; it raises where there is no card."""
    from svnet_tpu_torch import config

    ep = torch.export.load(io.BytesIO(bytes(blob)))
    if any(t.device.type == "cuda" for t in ep.state_dict.values()):
        config.set_full_fp32()
    return ep.module()


def _main():
    """Export a trained checkpoint's fused engine to an AOT artifact.

    python -m svnet_tpu_torch.serve --ckpt results/save_models/model_best.ckpt \\
        --task cls --backbone dgcnn --batch 8 --num-points 1024 --k 20 \\
        --mode fast --out engine.pt2
    """
    import argparse

    from svnet_tpu_torch import config, infer
    from svnet_tpu_torch.train.checkpoint import load_checkpoint

    ap = argparse.ArgumentParser(description=_main.__doc__)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--task", choices=["cls", "partseg"], default="cls")
    ap.add_argument("--backbone", choices=["dgcnn", "pointnet"],
                    default="dgcnn")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--num-points", type=int, default=1024)
    ap.add_argument("--k", type=int, default=0)
    ap.add_argument("--num-classes", type=int, default=40)
    ap.add_argument("--num-part", type=int, default=50)
    ap.add_argument("--num-shape-classes", type=int, default=16,
                    help="partseg one-hot label width")
    ap.add_argument("--mode", choices=["exact", "fast", "approx"],
                    default="fast")
    ap.add_argument("--approx-fold", type=int, default=0)
    ap.add_argument("--fast-gather-bits", type=int, default=0,
                    choices=[0, 8, 16])
    ap.add_argument("--approx-gather-bits", type=int, default=0,
                    choices=[0, 8, 16])
    ap.add_argument("--graph-reuse", default="none",
                    choices=["none", "conv2", "spatial"])
    ap.add_argument("--fp", action="store_true",
                    help="full-precision weights (default binary)")
    ap.add_argument("--device", default="cuda",
                    help="the engine's device: the card unless 'cpu' (a "
                         "CPU artifact runs the kernels' plain versions)")
    args = ap.parse_args()
    if args.approx_fold:
        config.set_approx_fold(args.approx_fold)
    if args.approx_gather_bits:
        config.set_approx_gather_bits(args.approx_gather_bits)
    if args.fast_gather_bits:
        config.set_fast_gather_bits(args.fast_gather_bits)
    if args.graph_reuse != "none":
        config.set_graph_reuse(args.graph_reuse)

    device = config.resolve_device(args.device)
    k = args.k or (20 if args.task == "cls" else 40)
    binary = not args.fp
    B, N = args.batch, args.num_points
    state = load_checkpoint("", test=args.ckpt, device=device)
    if state is None:
        raise SystemExit(f"no checkpoint at {args.ckpt}")
    # extra stored keys (epoch, the optimizer's state) are ignored
    payload = {"params": state["params"], "batch_stats": state["batch_stats"]}
    eng_cls = {
        ("cls", "dgcnn"): infer.SVDGCNNClsEngine,
        ("cls", "pointnet"): infer.SVPointNetClsEngine,
        ("partseg", "dgcnn"): infer.SVDGCNNPsegEngine,
        ("partseg", "pointnet"): infer.SVPointNetPsegEngine,
    }[(args.task, args.backbone)]
    kw = {"k": k, "binary": binary, "mode": args.mode, "device": device}
    if args.task == "cls":
        kw["num_classes"] = args.num_classes
    else:
        kw["num_part"] = args.num_part
    eng = eng_cls(payload, **kw)
    example = (torch.zeros((B, N, 3), device=device),)
    if args.task == "partseg":
        example += (torch.zeros((B, args.num_shape_classes), device=device),)
    blob = export_engine(eng, *example)
    with open(args.out, "wb") as f:
        f.write(blob)
    print(f"exported {args.task}/{args.backbone} mode={args.mode} "
          f"B={B} N={N} -> {args.out} ({len(blob)} bytes)")


if __name__ == "__main__":
    _main()
