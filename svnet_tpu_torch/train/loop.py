"""Classification training driver (counterpart of
svnet_tpu/train/loop.py::run_cls, SV-DGCNN and SV-PointNet on ModelNet40,
train path).

Epochs of train steps (SV-DGCNN: the fused train forward; SV-PointNet:
the flax-equivalent train forward of ``train/pointnet.py``); before each
eval, BN re-estimation over ``--bn-reestimate`` train batches (60 by
default for binary nets, whose running statistics lag the weight-sign
flips); eval through the eager model with ``--rot-test``; checkpoints
with the reference's file management. ``train_epoch`` is the epoch body
on its own, so a caller can drive it with any dataset the Loader accepts.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from svnet_tpu_torch import config
from svnet_tpu_torch.cli.flags import check_ported
from svnet_tpu_torch.data import Loader, ModelNet40
from svnet_tpu_torch.models.sv_dgcnn import SVDGCNNCls
from svnet_tpu_torch.models.sv_pointnet import SVPointNetCls
from svnet_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from svnet_tpu_torch.train.fused import make_fused_train_apply
from svnet_tpu_torch.train.logs import configure_logging
from svnet_tpu_torch.train.losses import cal_loss
from svnet_tpu_torch.train.metrics import accuracy, balanced_accuracy
from svnet_tpu_torch.train.pointnet import make_train_apply_cls
from svnet_tpu_torch.train.steps import (
    create_state,
    make_eval_step,
    make_recal_step,
    make_train_step,
)
from svnet_tpu_torch.utils.convert import flatten, load_tree, module_tree, nest


def _weighted_loss(losses, counts) -> float:
    w = torch.tensor(counts, dtype=torch.float32)
    return float((torch.stack(losses).float().cpu() * w).sum() / w.sum())


def _build_cls_model(args, num_classes: int):
    """(seeded eager eval model, train forward, optimizer recipe) of
    ``args.backbone``."""
    gen = torch.Generator().manual_seed(args.seed)
    if args.backbone == "pointnet":
        model = SVPointNetCls(num_classes, args.k, args.binary, gen)
        return (model, make_train_apply_cls(num_classes, args.k, args.binary),
                "pointnet_cls")
    model = SVDGCNNCls(num_classes, args.k, args.binary, gen)
    return (model, make_fused_train_apply(num_classes, args.k, binary=args.binary,
                                          dropout=args.dropout), "dgcnn")


def train_epoch(state, train_step, loader, generator, log_string=print,
                epoch: int = 0, epochs: int = 1) -> dict:
    """One pass of train steps over ``loader``. Returns the epoch's
    loss, accuracy, balanced accuracy, wall seconds and the time of each
    step in ms (CUDA events on the card, the host clock on the CPU)."""
    t0 = time.time()
    cuda = loader.device.type == "cuda"
    true, pred, losses, counts, marks = [], [], [], [], []
    print_freq = max(len(loader) // 10, 1)
    for i, batch in enumerate(loader):
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        else:
            marks.append(time.perf_counter())
        loss, preds = train_step(state, batch, generator)
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        else:
            marks.append(time.perf_counter())
        losses.append(loss)
        counts.append(batch["size"])
        true.append(batch["target"])
        pred.append(preds)
        if (i + 1) % print_freq == 0:
            log_string(f"EPOCH {epoch:03d}/{epochs:03d} Batch {i:05d}/"
                       f"{len(loader):05d}: Loss {_weighted_loss(losses, counts):.8f}")
    if cuda:
        torch.cuda.synchronize(loader.device)
        step_ms = [a.elapsed_time(b) for a, b in zip(marks[::2], marks[1::2])]
    else:
        step_ms = [(b - a) * 1e3 for a, b in zip(marks[::2], marks[1::2])]
    y_true = torch.cat(true).cpu().numpy()
    y_pred = torch.cat(pred).cpu().numpy()
    out = {"loss": _weighted_loss(losses, counts),
           "acc": accuracy(y_true, y_pred),
           "avg_acc": balanced_accuracy(y_true, y_pred),
           "seconds": time.time() - t0, "step_ms": step_ms}
    log_string(f"TRAIN: loss {out['loss']:.6f}, acc {out['acc']:.6f}, avg acc "
               f"{out['avg_acc']:.6f} ({out['seconds']:.1f}s, median step "
               f"{float(np.median(step_ms)):.3f} ms)")
    return out


def resolve_recal_n(args) -> int:
    n = getattr(args, "bn_reestimate", -1)
    if n < 0:
        n = 60 if getattr(args, "binary", False) else 0
    return n


def bn_reestimate(recal_step, state, loader, generator, n: int) -> dict:
    """Running statistics re-estimated at fixed weights: the mean of the
    per-batch statistics of n train batches, each recovered from one
    momentum step off the same base (new = 0.9 old + 0.1 batch)."""
    base = state.batch_stats
    acc, done = None, 0
    while done < n:
        for batch in loader:
            if done >= n:
                break
            new = flatten(recal_step(state.params, base, batch, generator))
            one = {p: 10.0 * new[p] - 9.0 * old for p, old in flatten(base).items()}
            acc = one if acc is None else {p: acc[p] + one[p] for p in acc}
            done += 1
    return nest({p: v / done for p, v in acc.items()})


def eval_cls(eval_step, model, state, loader, generator, log_string=print):
    """Eval through the eager model with the state's current weights."""
    load_tree(model, state.tree())
    true, pred, losses, counts = [], [], [], []
    for batch in loader:
        loss, preds = eval_step(batch, generator)
        size = batch["size"]
        losses.append(loss)
        counts.append(size)
        true.append(batch["target"][:size])
        pred.append(preds[:size])
    y_true = torch.cat(true).cpu().numpy()
    y_pred = torch.cat(pred).cpu().numpy()
    loss = _weighted_loss(losses, counts)
    acc, avg = accuracy(y_true, y_pred), balanced_accuracy(y_true, y_pred)
    log_string(f"TEST: loss {loss:.6f}, acc {acc:.6f}, avg acc {avg:.6f}")
    return acc, avg, loss


def run_cls(args) -> Optional[float]:
    """Classification driver: ModelNet40, binary or FP SV-DGCNN or
    SV-PointNet (``args.backbone``)."""
    check_ported(args)
    dev = config.resolve_device(args.device)
    log_string = configure_logging(args.save_dir, "cls")
    epoch_string = configure_logging(args.save_dir, "cls", "log")
    epoch_string(str(vars(args)))
    num_classes = 40
    model, apply, recipe = _build_cls_model(args, num_classes)
    if args.checkinfo:
        n = sum(p.numel() for p in model.parameters())
        print(f"Number of Parameters: {n / 1e6:.6f}M")
        return None
    weights = module_tree(model)
    model = model.to(dev).eval()

    train_set = ModelNet40(args.num_points, args.data_dir, "train", seed=args.seed)
    test_set = ModelNet40(args.num_points, args.data_dir, "test", seed=args.seed + 1)
    train_loader = Loader(train_set, args.batch_size, shuffle=True, drop_last=True,
                          seed=args.seed, num_workers=args.num_workers, device=dev)
    test_loader = Loader(test_set, args.batch_size, shuffle=False, pad_last=True,
                         device=dev)
    log_string(f"trainloader: {len(train_set)}, test_loader: {len(test_set)}")

    state = create_state(weights, binary=args.binary, lr=args.lr,
                         epochs=args.epochs, steps_per_epoch=len(train_loader),
                         momentum=args.momentum, weight_decay=args.wd,
                         opt=args.opt, recipe=recipe, device=dev)
    train_step = make_train_step(apply, cal_loss, rot=args.rot)
    eval_step = make_eval_step(model, cal_loss, rot_test=args.rot_test)
    recal_n = resolve_recal_n(args)
    recal_step = make_recal_step(apply, rot=args.rot) if recal_n else None
    if recal_n:
        log_string(f"BN re-estimation before eval: {recal_n} train batches")

    start_epoch, best_acc = 0, 0.0
    ckpt = load_checkpoint(args.save_dir, test=args.test,
                           resume_from=args.resume_from, resume=args.resume,
                           device=dev)
    if ckpt is not None:
        saved = flatten(ckpt["params"])
        with torch.no_grad():
            for path, leaf in flatten(state.params).items():
                leaf.copy_(saved[path])
        state.batch_stats = ckpt["batch_stats"]
        if args.test is None:
            state.opt.load_state_dict(ckpt["opt_state"])
            state.step = ckpt["step"]
            start_epoch = ckpt["epoch"] + 1
            best_acc = ckpt["best_metric"]
        log_string("checkpoint loaded successfully")
    else:
        log_string("no checkpoint loaded")

    generator = torch.Generator().manual_seed(args.seed + 123)
    if args.test is not None:
        return eval_cls(eval_step, model, state, test_loader, generator,
                        log_string)[0]

    save_id = None
    for epoch in range(start_epoch, args.epochs):
        tr = train_epoch(state, train_step, train_loader, generator, log_string,
                         epoch, args.epochs)
        if recal_step is not None:
            state.batch_stats = bn_reestimate(recal_step, state, train_loader,
                                              generator, recal_n)
        test_acc, test_avg, test_loss = eval_cls(eval_step, model, state,
                                                 test_loader, generator, log_string)
        is_best = test_acc >= best_acc
        best_acc = max(best_acc, test_acc)
        tree = state.tree()
        save_id = save_checkpoint(
            {"epoch": epoch, "params": tree["params"],
             "batch_stats": tree["batch_stats"],
             "opt_state": state.opt.state_dict(), "step": state.step,
             "best_metric": best_acc},
            epoch, args.save_dir, is_best, save_id)
        epoch_string(
            f"EPOCH {epoch:03d}/{args.epochs:03d} | Test: loss {test_loss:.6f}, "
            f"acc {test_acc:.6f}, avg acc {test_avg:.6f} | Train: loss "
            f"{tr['loss']:.6f}, acc {tr['acc']:.6f}, avg acc {tr['avg_acc']:.6f} | "
            f"{time.strftime('%Y-%m-%d-%H-%M-%S')}")
    return best_acc
