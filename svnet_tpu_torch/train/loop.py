"""Classification and part-segmentation training loops (counterpart of
svnet_tpu/train/loop.py::run_cls and run_partseg, SV-DGCNN and
SV-PointNet on ModelNet40 and ShapeNetPart, train path).

Epochs of train steps (SV-DGCNN: the fused train forward; SV-PointNet:
the flax-equivalent train forward of ``train/pointnet.py``); before each
eval, BN re-estimation over ``--bn-reestimate`` train batches (60 by
default for binary nets, whose running statistics lag the weight-sign
flips); eval through the eager model with ``--rot-test``; checkpoints
with the reference's file management. ``train_epoch`` is the epoch body
on its own, so a caller can drive it with any dataset the Loader accepts.
"""

from __future__ import annotations

import functools
import time
from typing import Optional

import numpy as np
import torch

from svnet_tpu_torch import config
from svnet_tpu_torch.cli.flags import check_ported
from svnet_tpu_torch.data import Loader, ModelNet40, ShapeNetPart
from svnet_tpu_torch.models.sv_dgcnn import SVDGCNNCls, SVDGCNNPseg
from svnet_tpu_torch.models.sv_pointnet import SVPointNetCls, SVPointNetPseg
from svnet_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from svnet_tpu_torch.train.fused import (
    make_fused_train_apply,
    make_fused_train_apply_pseg,
)
from svnet_tpu_torch.train.logs import configure_logging
from svnet_tpu_torch.train.losses import cal_loss
from svnet_tpu_torch.train.metrics import accuracy, balanced_accuracy, shape_iou
from svnet_tpu_torch.train.pointnet import make_train_apply_cls, make_train_apply_pseg
from svnet_tpu_torch.train.steps import (
    create_state,
    make_eval_step,
    make_recal_step,
    make_train_step,
)
from svnet_tpu_torch.utils.convert import flatten, load_tree, module_tree, nest

NUM_PARTS = 50  # ShapeNetPart's part labels


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


def _build_pseg_model(args, num_part: int):
    """As ``_build_cls_model``, for part segmentation."""
    gen = torch.Generator().manual_seed(args.seed)
    if args.backbone == "pointnet":
        model = SVPointNetPseg(num_part, args.k, args.binary, gen)
        return (model, make_train_apply_pseg(num_part, args.k, args.binary),
                "pointnet_partseg")
    model = SVDGCNNPseg(num_part, args.k, args.binary, gen)
    return (model, make_fused_train_apply_pseg(num_part, args.k, binary=args.binary,
                                               dropout=args.dropout), "dgcnn")


def train_epoch(state, train_step, loader, generator, log_string=print,
                epoch: int = 0, epochs: int = 1) -> dict:
    """One pass of train steps over ``loader``. Returns the epoch's
    loss, accuracy (per point, for part segmentation), balanced accuracy
    (classification only), wall seconds and the time of each step in ms
    (CUDA events on the card, the host clock on the CPU)."""
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
    out = {"loss": _weighted_loss(losses, counts), "acc": accuracy(y_true, y_pred),
           "seconds": time.time() - t0, "step_ms": step_ms}
    median = f"{out['seconds']:.1f}s, median step {float(np.median(step_ms)):.3f} ms"
    if y_true.ndim > 1:
        log_string(f"TRAIN: loss {out['loss']:.6f}, point acc {out['acc']:.6f} "
                   f"({median})")
        return out
    out["avg_acc"] = balanced_accuracy(y_true, y_pred)
    log_string(f"TRAIN: loss {out['loss']:.6f}, acc {out['acc']:.6f}, avg acc "
               f"{out['avg_acc']:.6f} ({median})")
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


def _eval_batches(eval_step, model, state, loader, generator):
    """Eval through the eager model with the state's current weights:
    (loss, truth, predictions, categories), the pad of the last batch
    dropped."""
    load_tree(model, state.tree())
    true, pred, cats, losses, counts = [], [], [], [], []
    for batch in loader:
        loss, preds = eval_step(batch, generator)
        size = batch["size"]
        losses.append(loss)
        counts.append(size)
        true.append(batch["target"][:size])
        pred.append(preds[:size])
        if "category" in batch:
            cats.append(batch["category"][:size])
    cat = torch.cat(cats).cpu().numpy() if cats else None
    return (_weighted_loss(losses, counts), torch.cat(true).cpu().numpy(),
            torch.cat(pred).cpu().numpy(), cat)


def eval_cls(eval_step, model, state, loader, generator, log_string=print):
    """Eval through the eager model with the state's current weights."""
    loss, y_true, y_pred, _ = _eval_batches(eval_step, model, state, loader,
                                            generator)
    acc, avg = accuracy(y_true, y_pred), balanced_accuracy(y_true, y_pred)
    log_string(f"TEST: loss {loss:.6f}, acc {acc:.6f}, avg acc {avg:.6f}")
    return acc, avg, loss


def eval_pseg(eval_step, model, state, loader, generator, log_string=print):
    """Part-segmentation eval through the eager model: the mean over
    shapes of ``shape_iou``, the point accuracy and the loss."""
    loss, seg, pred, cat = _eval_batches(eval_step, model, state, loader,
                                         generator)
    iou = float(np.mean(shape_iou(pred, seg, cat)))
    acc = accuracy(seg, pred)
    log_string(f"TEST: loss {loss:.6f}, iou {iou:.6f}, point acc {acc:.6f}")
    return iou, acc, loss


class _Run:
    """What both trainers share: the device, the two logs, the eager model,
    the train state, the steps, BN re-estimation, checkpoint restore and
    save."""

    def __init__(self, args, task: str):
        check_ported(args)
        self.args, self.task = args, task
        self.dev = config.resolve_device(args.device)
        self.log = configure_logging(args.save_dir, task)
        self.epoch_log = configure_logging(args.save_dir, task, "log")
        self.epoch_log(str(vars(args)))

    def prepare(self, built, loss_fn, train_set, test_set) -> None:
        """The loaders, the train state from the built model's weights,
        and the steps."""
        args = self.args
        model, apply, recipe = built
        weights = module_tree(model)
        self.model = model.to(self.dev).eval()
        with_label = self.task == "partseg"
        self.train_loader = Loader(train_set, args.batch_size, shuffle=True,
                                   drop_last=True, seed=args.seed,
                                   num_workers=args.num_workers, device=self.dev)
        self.test_loader = Loader(test_set, args.batch_size, shuffle=False,
                                  pad_last=True, device=self.dev)
        self.log(f"trainloader: {len(train_set)}, test_loader: {len(test_set)}")
        self.state = create_state(
            weights, binary=args.binary, lr=args.lr, epochs=args.epochs,
            steps_per_epoch=len(self.train_loader), momentum=args.momentum,
            weight_decay=args.wd, opt=args.opt, recipe=recipe, device=self.dev)
        self.train_step = make_train_step(apply, loss_fn, rot=args.rot,
                                          with_label=with_label)
        self.eval_step = make_eval_step(self.model, loss_fn, rot_test=args.rot_test,
                                        with_label=with_label)
        self.recal_n = resolve_recal_n(args)
        self.recal_step = (make_recal_step(apply, rot=args.rot, with_label=with_label)
                           if self.recal_n else None)
        if self.recal_n:
            self.log(f"BN re-estimation before eval: {self.recal_n} train batches")
        self.generator = torch.Generator().manual_seed(args.seed + 123)
        self.save_id = None

    def restore(self):
        """(first epoch, best metric) after loading the checkpoint that
        --test, --resume-from or --resume names, if any."""
        args, state = self.args, self.state
        ckpt = load_checkpoint(args.save_dir, test=args.test,
                               resume_from=args.resume_from, resume=args.resume,
                               device=self.dev)
        if ckpt is None:
            self.log("no checkpoint loaded")
            return 0, 0.0
        saved = flatten(ckpt["params"])
        with torch.no_grad():
            for path, leaf in flatten(state.params).items():
                leaf.copy_(saved[path])
        state.batch_stats = ckpt["batch_stats"]
        self.log("checkpoint loaded successfully")
        if args.test is not None:
            return 0, 0.0
        state.opt.load_state_dict(ckpt["opt_state"])
        state.step = ckpt["step"]
        return ckpt["epoch"] + 1, ckpt["best_metric"]

    def train(self, epoch: int) -> dict:
        tr = train_epoch(self.state, self.train_step, self.train_loader,
                         self.generator, self.log, epoch, self.args.epochs)
        if self.recal_step is not None:
            self.state.batch_stats = bn_reestimate(
                self.recal_step, self.state, self.train_loader, self.generator,
                self.recal_n)
        return tr

    def evaluate(self, eval_fn):
        return eval_fn(self.eval_step, self.model, self.state, self.test_loader,
                       self.generator, self.log)

    def save(self, epoch: int, is_best: bool, best: float) -> None:
        tree = self.state.tree()
        self.save_id = save_checkpoint(
            {"epoch": epoch, "params": tree["params"],
             "batch_stats": tree["batch_stats"],
             "opt_state": self.state.opt.state_dict(), "step": self.state.step,
             "best_metric": best},
            epoch, self.args.save_dir, is_best, self.save_id)


def _param_count(model) -> None:
    n = sum(p.numel() for p in model.parameters())
    print(f"Number of Parameters: {n / 1e6:.6f}M")


def run_cls(args) -> Optional[float]:
    """Classification trainer: ModelNet40, binary or FP SV-DGCNN or
    SV-PointNet (``args.backbone``)."""
    run = _Run(args, "cls")
    built = _build_cls_model(args, 40)
    if args.checkinfo:
        return _param_count(built[0])
    run.prepare(built, cal_loss,
                ModelNet40(args.num_points, args.data_dir, "train", seed=args.seed),
                ModelNet40(args.num_points, args.data_dir, "test", seed=args.seed + 1))
    start_epoch, best_acc = run.restore()
    if args.test is not None:
        return run.evaluate(eval_cls)[0]
    for epoch in range(start_epoch, args.epochs):
        tr = run.train(epoch)
        test_acc, test_avg, test_loss = run.evaluate(eval_cls)
        is_best = test_acc >= best_acc
        best_acc = max(best_acc, test_acc)
        run.save(epoch, is_best, best_acc)
        run.epoch_log(
            f"EPOCH {epoch:03d}/{args.epochs:03d} | Test: loss {test_loss:.6f}, "
            f"acc {test_acc:.6f}, avg acc {test_avg:.6f} | Train: loss "
            f"{tr['loss']:.6f}, acc {tr['acc']:.6f}, avg acc {tr['avg_acc']:.6f} | "
            f"{time.strftime('%Y-%m-%d-%H-%M-%S')}")
    return best_acc


def run_partseg(args) -> Optional[float]:
    """Part-segmentation trainer: ShapeNetPart (trainval for training, test
    for eval; ``--class-choice`` keeps one category), binary or FP
    SV-DGCNN or SV-PointNet (``args.backbone``); reports the mean shape
    IoU."""
    run = _Run(args, "partseg")
    built = _build_pseg_model(args, NUM_PARTS)
    if args.checkinfo:
        return _param_count(built[0])
    sets = [ShapeNetPart(args.num_points, args.data_dir, part, args.class_choice,
                         seed) for part, seed in (("trainval", args.seed),
                                                  ("test", args.seed + 1))]
    run.prepare(built, functools.partial(cal_loss, smoothing=args.smoothing),
                *sets)
    start_epoch, best_iou = run.restore()
    if args.test is not None:
        return run.evaluate(eval_pseg)[0]
    for epoch in range(start_epoch, args.epochs):
        tr = run.train(epoch)
        test_iou, test_acc, test_loss = run.evaluate(eval_pseg)
        is_best = test_iou >= best_iou
        best_iou = max(best_iou, test_iou)
        run.save(epoch, is_best, best_iou)
        run.epoch_log(
            f"EPOCH {epoch:03d}/{args.epochs:03d} | Test: loss {test_loss:.6f}, "
            f"iou {test_iou:.6f}, acc {test_acc:.6f} | Train: loss "
            f"{tr['loss']:.6f} | {time.strftime('%Y-%m-%d-%H-%M-%S')}")
    return best_iou
