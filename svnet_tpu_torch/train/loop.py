"""Classification, part- and semantic-segmentation training loops
(counterpart of svnet_tpu/train/loop.py::run_cls, run_partseg and
run_semseg: the SV, VN, original and BiPointNet families of PointNet and
DGCNN on ModelNet40 or ScanObjectNN and on ShapeNetPart, BiPointNet's
semantic segmenter on S3DIS, train path).

Epochs of train steps (SV-DGCNN: the fused train forward on the card, the
un-fused one elsewhere, ``config.fused_train``; SV-PointNet: the
flax-equivalent train forward of ``train/pointnet.py``; the VN, original
and BiPointNet models: their one function of the weights,
``nn/scope.py``, BiPointNet's weights drawn on the first test batch, as
JAX's ``model.init`` on it); the loss is ``model_loss`` (the T-Net
regularizer for the original PointNet and BiPointNet, whose models
return it; ROADMAP C26); the class count comes from ``--dataset``; before
each
eval, BN re-estimation over ``--bn-reestimate`` train batches (60 by
default for binary nets, whose running statistics lag the weight-sign
flips); eval through the eager model with ``--rot-test``, or with
``--test --fused`` through the serving engine in ``--engine-mode`` and
the serving knobs; checkpoints with the reference's file management.
``--profile-dir`` (classification) traces one train step with
``torch.profiler``; ``--debug-nans`` (classification and part
segmentation) checks each train step for NaNs. ``--preload`` starts the
student from a checkpoint (its own tree, or an FP teacher's overlapping
leaves); with ``--distill`` it is the teacher of
a KD term. ``--train-knobs`` (binary SV-DGCNN) trains and evaluates in
the serving knobs' world. The CLI's knobs are set in ``config`` for the
run's length only (``knob_scope``), and the training knobs are resolved
once (``config.train_knob_state``) and handed to the model and the train
forward. ``train_epoch`` is the epoch body on its own, so a caller can
drive it with any dataset the Loader accepts.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Optional

import numpy as np
import torch

from svnet_tpu_torch import config
from svnet_tpu_torch.cli.flags import SERVING_KNOBS, check_ported
from svnet_tpu_torch.data import (
    S3DIS,
    Loader,
    ModelNet40,
    ScanObjectNNCls,
    ShapeNetPart,
)
from svnet_tpu_torch.infer import (
    SVDGCNNClsEngine,
    SVDGCNNPsegEngine,
    SVPointNetClsEngine,
)
from svnet_tpu_torch.models import BiPointNetSemseg, get_model
from svnet_tpu_torch.train import dgcnn, pointnet
from svnet_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from svnet_tpu_torch.train.fused import (
    make_fused_train_apply,
    make_fused_train_apply_pseg,
)
from svnet_tpu_torch.train.logs import configure_logging
from svnet_tpu_torch.train.losses import model_loss
from svnet_tpu_torch.train.metrics import accuracy, balanced_accuracy, shape_iou
from svnet_tpu_torch.train.steps import (
    Distiller,
    create_state,
    make_eval_step,
    make_recal_step,
    make_train_step,
    tree_map,
)
from svnet_tpu_torch.utils.convert import flatten, load_tree, module_tree, nest

NUM_PARTS = 50  # ShapeNetPart's part labels
NUM_SEMSEG = 13  # S3DIS's classes
NUM_CLASSES = {"modelnet40": 40, "scanobjectnn": 15}  # --dataset -> classes
# config's knobs that the CLI sets (svnet_tpu/train/loop.py::
# _apply_approx_knobs), each through ``config.set_<name>``
_KNOBS = tuple(n for n in SERVING_KNOBS if n != "engine_mode") + ("train_knobs",)


@contextlib.contextmanager
def knob_scope(args):
    """The CLI's serving and training knobs set in ``config`` (a knob left
    at its flag's default keeps config's value, as in JAX), and config
    restored on the way out."""
    was = {name: getattr(config, name) for name in _KNOBS}
    try:
        for name in _KNOBS:
            value = getattr(args, name, None)
            if value not in (None, 0, False, "none"):
                getattr(config, "set_" + name)(value)
        yield
    finally:
        for name in _KNOBS:
            getattr(config, "set_" + name)(was[name])


def _weighted_loss(losses, counts) -> float:
    w = torch.tensor(counts, dtype=torch.float32)
    return float((torch.stack(losses).float().cpu() * w).sum() / w.sum())


def out_width(args, task: str) -> int:
    """The head's width: the classes of ``--dataset``, or the parts."""
    return NUM_CLASSES[args.dataset] if task == "cls" else NUM_PARTS


def eager_model(args, task: str, binary: bool, knobs=None):
    """The seeded eager eval model of ``args.model`` and ``args.backbone``
    for ``task`` (svnet_tpu/train/loop.py::_build_cls_model,
    _build_pseg_model: ``binary`` and the knobs for the SV models,
    ``pooling`` for VN)."""
    kw = {"k": args.k, "generator": torch.Generator().manual_seed(args.seed),
          ("num_classes" if task == "cls" else "num_part"): out_width(args, task)}
    if args.model == "svnet":
        kw["binary"] = binary
        if args.backbone == "dgcnn":
            kw["knobs"] = knobs
    elif args.model == "vn":
        kw["pooling"] = args.pooling
    return get_model(task, args.backbone, args.model, **kw)


def optimizer_recipe(args, task: str) -> str:
    """The optimizer recipe (svnet_tpu/train/loop.py::_recipe)."""
    if args.backbone == "pointnet":
        return "pointnet_cls" if task == "cls" else "pointnet_partseg"
    return "dgcnn"


def build_model(args, task: str, device, knobs=None, log_string=print):
    """(seeded eager eval model, train forward, optimizer recipe) of
    ``args.model`` and ``args.backbone`` for ``task``: the VN, original
    and BiPointNet models' ``make_train_apply``; SV-PointNet's ``train/pointnet.py``;
    SV-DGCNN's fused forward where ``config.use_fused_train(device)``,
    else the un-fused ``train/dgcnn.py`` (svnet_tpu/train/loop.py:356-372,
    :778-795). ``knobs`` (``config.train_knob_state``) go to both the
    SV-DGCNN model and its train forward."""
    model = eager_model(args, task, args.binary, knobs)
    cls = task == "cls"
    width = out_width(args, task)
    if args.model != "svnet":
        return model, model.make_train_apply(), optimizer_recipe(args, task)
    if args.backbone == "pointnet":
        make = pointnet.make_train_apply_cls if cls else pointnet.make_train_apply_pseg
        return model, make(width, args.k, args.binary), optimizer_recipe(args, task)
    if config.use_fused_train(device):
        make = make_fused_train_apply if cls else make_fused_train_apply_pseg
        log_string("fused train forward enabled")
    else:
        make = dgcnn.make_train_apply_cls if cls else dgcnn.make_train_apply_pseg
    if knobs is not None:
        log_string(f"knob-aware training: {knobs}")
    return model, make(width, args.k, binary=args.binary, dropout=args.dropout,
                       knobs=knobs), optimizer_recipe(args, task)


def tree_shapes(tree: dict) -> dict:
    """{'params.<path>' / 'batch_stats.<path>': shape} of a weight tree."""
    return {path: tuple(leaf.shape) for path, leaf in flatten(
        {"params": tree["params"], "batch_stats": tree["batch_stats"]}).items()}


def merge_overlap(student: dict, teacher: dict):
    """(student tree with the teacher's leaves where path and shape match,
    hits, student leaves) (svnet_tpu/train/loop.py::_merge_overlap). The
    binary student's extra leaves (beta, scale) keep their own values."""
    s, t = flatten(student), flatten(teacher)
    hits = 0
    for path, val in s.items():
        t_val = t.get(path)
        if t_val is not None and tuple(t_val.shape) == tuple(val.shape):
            s[path] = t_val.to(device=val.device, dtype=val.dtype)
            hits += 1
    return nest(s), hits, len(s)


def assign_weights(state, tree: dict) -> None:
    """The state's parameters (in place: the optimizer holds them) and
    running statistics from a weight tree of the same paths."""
    saved = flatten(tree["params"])
    with torch.no_grad():
        for path, leaf in flatten(state.params).items():
            leaf.copy_(saved[path])
    state.batch_stats = tree_map(lambda t: t.detach().to(leaf.device, torch.float32)
                                 .clone(), tree["batch_stats"])


def read_weights(path: str, device) -> dict:
    """A checkpoint's ``{'params', 'batch_stats'}`` on ``device``; a
    missing file raises, as a corrupt one does (``torch.load``)."""
    ckpt = load_checkpoint("", test=path, device=device)
    if ckpt is None:
        raise FileNotFoundError(f"--preload {path} not found")
    return {"params": ckpt["params"], "batch_stats": ckpt["batch_stats"]}


def preload_weights(state, path: str, teacher_shapes: dict, device,
                    log_string=print) -> str:
    """``--preload`` without ``--distill`` (svnet_tpu/train/loop.py::
    _preload_weights), with its tree test made explicit (ROADMAP C3): a
    checkpoint whose paths and shapes are the student's loads whole
    ("same"); one that is the FP teacher's (``teacher_shapes``) merges
    its overlapping leaves into the student ("merge"); any other tree
    raises, as a missing or corrupt file does."""
    ckpt = read_weights(path, device)
    shapes = tree_shapes(ckpt)
    if shapes == tree_shapes(state.tree()):
        assign_weights(state, ckpt)
        log_string(f"preloaded weights from {path}")
        return "same"
    if shapes != teacher_shapes:
        raise ValueError(f"--preload {path}: its tree is neither the student's "
                         "nor the FP teacher's")
    _merge_into(state, ckpt, "preloaded weights from " + path, log_string)
    return "merge"


def _merge_into(state, teacher: dict, what: str, log_string) -> None:
    student = state.tree()
    params, hp, tp = merge_overlap(student["params"], teacher["params"])
    stats, hb, tb = merge_overlap(student["batch_stats"], teacher["batch_stats"])
    assign_weights(state, {"params": params, "batch_stats": stats})
    log_string(f"{what} (overlap merge: {hp}/{tp} params, {hb}/{tb} "
               "batch_stats leaves)")


def make_fused_eval_step(tree: dict, args, task: str, loss_fn, device):
    """``--test --fused``: the eval step through the serving engine of
    ``args.backbone`` (svnet_tpu/train/loop.py::_fused_cls_eval_step,
    _fused_pseg_eval_step), built from the weight tree in
    ``args.engine_mode``; the serving knobs are read from ``config`` (see
    ``knob_scope``) when the engine runs."""
    kw = dict(k=args.k, binary=args.binary, mode=args.engine_mode, device=device)
    width = out_width(args, task)
    if task == "partseg":
        eng = SVDGCNNPsegEngine(tree, width, **kw)
    elif args.backbone == "dgcnn":
        eng = SVDGCNNClsEngine(tree, width, **kw)
    else:
        eng = SVPointNetClsEngine(tree, width, **kw)
    return make_eval_step(eng, loss_fn, rot_test=args.rot_test,
                          with_label=task == "partseg")


def profiled_step(train_step, state, batch, generator, profile_dir: str,
                  cuda: bool, log_string=print):
    """``--profile-dir``: one train step under ``torch.profiler`` (CPU
    activity, and CUDA on the card), its trace written into
    ``profile_dir`` as a Chrome trace (svnet_tpu/train/loop.py:440-446
    traces with jax.profiler); the step trains as any other."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        out = train_step(state, batch, generator)
        if cuda:
            torch.cuda.synchronize()
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "train_step.json"))
    log_string(f"profiler trace written to {profile_dir}")
    return out


def nan_checked(train_step):
    """``--debug-nans`` (JAX's ``jax_debug_nans``): the train step, then
    one check of its loss, gradients and updated weights (one device sync a
    step); a NaN raises ``FloatingPointError`` naming the first leaf that
    holds one."""

    def step(state, batch, generator):
        loss, preds = train_step(state, batch, generator)
        params = flatten(state.params)
        leaves = [("loss", loss)]
        leaves += [(f"gradient of {n}", p.grad) for n, p in params.items()]
        leaves += [(f"params {n}", p) for n, p in params.items()]
        leaves += [(f"batch_stats {n}", t)
                   for n, t in flatten(state.batch_stats).items()]
        leaves = [(n, t.detach()) for n, t in leaves if t is not None]
        if bool(torch.stack([torch.isnan(t).any() for _, t in leaves]).any()):
            first = next(n for n, t in leaves if bool(torch.isnan(t).any()))
            raise FloatingPointError(
                f"--debug-nans: NaN in {first} after train step {state.step}")
        return loss, preds

    return step


def train_epoch(state, train_step, loader, generator, log_string=print,
                epoch: int = 0, epochs: int = 1,
                profile_dir: Optional[str] = None) -> dict:
    """One pass of train steps over ``loader``. Returns the epoch's
    loss, accuracy (per point, for part segmentation), balanced accuracy
    (classification only), wall seconds and the time of each step in ms
    (CUDA events on the card, the host clock on the CPU). With
    ``profile_dir``, step index 2 runs under the profiler
    (``profiled_step``) and, as in JAX's loop, enters neither the metrics
    nor the step times; ``profiled`` says whether it ran."""
    t0 = time.time()
    cuda = loader.device.type == "cuda"
    true, pred, losses, counts, marks = [], [], [], [], []
    print_freq = max(len(loader) // 10, 1)
    profiled = False
    for i, batch in enumerate(loader):
        if profile_dir and i == 2:
            profiled_step(train_step, state, batch, generator, profile_dir,
                          cuda, log_string)
            profiled = True
            continue
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
           "seconds": time.time() - t0, "step_ms": step_ms,
           "profiled": profiled}
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


def eval_batches(eval_step, loader, generator):
    """(loss, truth, predictions, categories) of ``eval_step`` over
    ``loader``, the pad of the last batch dropped."""
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


def eval_cls(eval_step, loader, generator, log_string=print):
    """Accuracy, balanced accuracy and loss of ``eval_step``."""
    loss, y_true, y_pred, _ = eval_batches(eval_step, loader, generator)
    acc, avg = accuracy(y_true, y_pred), balanced_accuracy(y_true, y_pred)
    log_string(f"TEST: loss {loss:.6f}, acc {acc:.6f}, avg acc {avg:.6f}")
    return acc, avg, loss


def semseg_miou(pred: np.ndarray, seg: np.ndarray) -> float:
    """The mean over the classes present in ``seg`` of each class's IoU
    (a union of 0 reads 1.0)."""
    ious = []
    for c in np.unique(seg):
        inter = np.logical_and(pred == c, seg == c).sum()
        union = np.logical_or(pred == c, seg == c).sum()
        ious.append(inter / union if union else 1.0)
    return float(np.mean(ious))


def eval_semseg(eval_step, loader, generator, log_string=print):
    """Semantic segmentation: the point accuracy, ``semseg_miou`` and the
    loss."""
    loss, seg, pred, _ = eval_batches(eval_step, loader, generator)
    acc, miou = float((pred == seg).mean()), semseg_miou(pred, seg)
    log_string(f"TEST: loss {loss:.6f}, point acc {acc:.6f}, mIoU {miou:.6f}")
    return acc, miou, loss


def eval_pseg(eval_step, loader, generator, log_string=print):
    """Part segmentation: the mean over shapes of ``shape_iou``, the point
    accuracy and the loss."""
    loss, seg, pred, cat = eval_batches(eval_step, loader, generator)
    iou = float(np.mean(shape_iou(pred, seg, cat)))
    acc = accuracy(seg, pred)
    log_string(f"TEST: loss {loss:.6f}, iou {iou:.6f}, point acc {acc:.6f}")
    return iou, acc, loss


class _Run:
    """What both trainers share: the device, the two logs, the knob state,
    the eager model, the train state, preload and KD, the steps, BN
    re-estimation, checkpoint restore, eval (eager or ``--fused``) and
    save."""

    def __init__(self, args, task: str):
        check_ported(args)
        self.args, self.task = args, task
        self.dev = config.resolve_device(args.device)
        self.log = configure_logging(args.save_dir, task)
        self.epoch_log = configure_logging(args.save_dir, task, "log")
        self.epoch_log(str(vars(args)))
        self.knobs = config.train_knob_state(args.binary)

    def build(self):
        return build_model(self.args, self.task, self.dev, self.knobs, self.log)

    def prepare(self, built, loss_fn, train_set, test_set) -> None:
        """The loaders, the train state from the built model's weights (or
        the preloaded ones), the teacher, and the steps."""
        args = self.args
        model, apply, recipe = built
        self.model = model.to(self.dev).eval()
        self.loss_fn = loss_fn
        with_label = self.task == "partseg"
        self.train_loader = Loader(train_set, args.batch_size, shuffle=True,
                                   drop_last=True, seed=args.seed,
                                   num_workers=args.num_workers, device=self.dev)
        self.test_loader = Loader(test_set, args.batch_size, shuffle=False,
                                  pad_last=True, device=self.dev)
        self.log(f"trainloader: {len(train_set)}, test_loader: {len(test_set)}")
        if getattr(model, "data_init", False):
            # the JAX trainers' model.init on the first test batch
            batch = next(iter(self.test_loader))
            inputs = (batch["points"], batch["label"]) if with_label \
                else (batch["points"],)
            model.init_on(*inputs, generator=torch.Generator().manual_seed(args.seed))
        weights = module_tree(model)
        self.state = create_state(
            weights, binary=args.binary, lr=args.lr, epochs=args.epochs,
            steps_per_epoch=len(self.train_loader), momentum=args.momentum,
            weight_decay=args.wd, opt=args.opt, recipe=recipe, device=self.dev)
        distiller = self.preload() if args.preload is not None else None
        self.train_step = make_train_step(apply, loss_fn, rot=args.rot,
                                          with_label=with_label,
                                          distiller=distiller,
                                          alpha=args.kd_alpha)
        if args.debug_nans:
            self.train_step = nan_checked(self.train_step)
        self.profile_dir = args.profile_dir
        self.eval_step = make_eval_step(self.model, loss_fn, rot_test=args.rot_test,
                                        with_label=with_label)
        self.recal_n = resolve_recal_n(args)
        self.recal_step = (make_recal_step(apply, rot=args.rot, with_label=with_label)
                           if self.recal_n else None)
        if self.recal_n:
            self.log(f"BN re-estimation before eval: {self.recal_n} train batches")
        self.generator = torch.Generator().manual_seed(args.seed + 123)
        self.save_id = None

    def preload(self) -> Optional[Distiller]:
        """``--preload``: the student from the checkpoint (its own tree or
        the FP teacher's overlap); with ``--distill`` the FP teacher of
        the KD term, and (``--kd-init``) the student from its overlap."""
        args = self.args
        teacher = eager_model(args, self.task, False)  # FP: never knob-aware
        t_shapes = tree_shapes(module_tree(teacher))
        if not args.distill:
            preload_weights(self.state, args.preload, t_shapes, self.dev, self.log)
            return None
        t_tree = read_weights(args.preload, self.dev)
        if tree_shapes(t_tree) != t_shapes:
            raise ValueError(f"--preload {args.preload}: not the FP teacher's tree")
        load_tree(teacher, t_tree)
        distiller = Distiller(teacher.to(self.dev), args.kd_t)
        self.log(f"KD teacher loaded from {args.preload} (T={distiller.T}, "
                 f"alpha={args.kd_alpha})")
        if args.kd_init:
            _merge_into(self.state, t_tree, "KD student initialized from teacher",
                        self.log)
        return distiller

    def restore(self):
        """(first epoch, best metric) after loading the checkpoint that
        --test, --resume-from or --resume names, if any; with --test
        --fused, the eval step through the engine built from it."""
        args, state = self.args, self.state
        ckpt = load_checkpoint(args.save_dir, test=args.test,
                               resume_from=args.resume_from, resume=args.resume,
                               device=self.dev)
        start = (0, 0.0)
        if ckpt is None:
            self.log("no checkpoint loaded")
        else:
            assign_weights(state, ckpt)
            self.log("checkpoint loaded successfully")
            if args.test is None:
                state.opt.load_state_dict(ckpt["opt_state"])
                state.step = ckpt["step"]
                start = (ckpt["epoch"] + 1, ckpt["best_metric"])
        if args.test is not None and args.fused:
            self.eval_step = make_fused_eval_step(state.tree(), args, self.task,
                                                  self.loss_fn, self.dev)
            self.log(f"evaluating through the {args.engine_mode} engine")
        return start

    def train(self, epoch: int) -> dict:
        tr = train_epoch(self.state, self.train_step, self.train_loader,
                         self.generator, self.log, epoch, self.args.epochs,
                         self.profile_dir)
        if tr["profiled"]:  # one trace a run, as JAX's
            self.profile_dir = None
        if self.recal_step is not None:
            self.state.batch_stats = bn_reestimate(
                self.recal_step, self.state, self.train_loader, self.generator,
                self.recal_n)
        return tr

    def evaluate(self, eval_fn):
        """``eval_fn`` (``eval_cls``, ``eval_pseg``) through the eval step:
        the eager model with the state's current weights, or the engine."""
        if not (self.args.test is not None and self.args.fused):
            load_tree(self.model, self.state.tree())
        return eval_fn(self.eval_step, self.test_loader, self.generator, self.log)

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


def cls_datasets(args):
    """(train, test) of ``--dataset``: ModelNet40, or ScanObjectNN's
    ``--subset`` (hard unless given)."""
    if args.dataset == "scanobjectnn":
        return [ScanObjectNNCls(args.num_points, args.data_dir, part,
                                args.subset or "hard", seed)
                for part, seed in (("train", args.seed), ("test", args.seed + 1))]
    return [ModelNet40(args.num_points, args.data_dir, part, seed=seed)
            for part, seed in (("train", args.seed), ("test", args.seed + 1))]


def run_cls(args, datasets=None) -> Optional[float]:
    """Classification trainer: ModelNet40 or ScanObjectNN (``--dataset``;
    or the caller's ``datasets``, (train, test) of any kind the Loader
    takes, with ``--dataset``'s class count), the SV, VN or original model
    (``args.model``) of ``args.backbone``."""
    with knob_scope(args):
        run = _Run(args, "cls")
        built = run.build()
        if args.checkinfo:
            return _param_count(built[0])
        run.prepare(built, model_loss, *(datasets or cls_datasets(args)))
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


def run_partseg(args, datasets=None) -> Optional[float]:
    """Part-segmentation trainer: ShapeNetPart (trainval for training, test
    for eval; ``--class-choice`` keeps one category) or the caller's
    ``datasets``, binary or FP SV-DGCNN or SV-PointNet
    (``args.backbone``); reports the mean shape IoU."""
    with knob_scope(args):
        run = _Run(args, "partseg")
        built = run.build()
        if args.checkinfo:
            return _param_count(built[0])
        sets = datasets or [
            ShapeNetPart(args.num_points, args.data_dir, part, args.class_choice,
                         seed) for part, seed in (("trainval", args.seed),
                                                  ("test", args.seed + 1))]
        run.prepare(built, functools.partial(model_loss, smoothing=args.smoothing),
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


def run_semseg(args, datasets=None) -> Optional[float]:
    """Semantic-segmentation trainer: S3DIS's rooms (``--test-area`` is the
    test partition) or the caller's ``datasets``, BiPointNet_SEMSEG of 13
    classes, the loss ``cal_loss`` (``--smoothing``) plus 0.001 times the
    T-Net regularizer, the dgcnn recipe's Adam (``args.binary``, set by
    the CLI); ``--rot``/``--rot-test`` aligned only. Training returns the
    best point accuracy, ``--test`` the mIoU."""
    args.task = "semseg"
    if args.rot != "aligned" or args.rot_test != "aligned":
        # whole-room rotation of S3DIS's 9 features is not meaningful
        raise ValueError("semseg supports --rot/--rot-test aligned only")
    with knob_scope(args):
        run = _Run(args, "semseg")
        model = BiPointNetSemseg(NUM_SEMSEG,
                                 generator=torch.Generator().manual_seed(args.seed))
        sets = datasets or [
            S3DIS(args.num_points, args.data_dir, part, args.test_area, seed)
            for part, seed in (("train", args.seed), ("test", args.seed + 1))]
        run.prepare((model, model.make_train_apply(), "dgcnn"),
                    functools.partial(model_loss, smoothing=args.smoothing), *sets)
        start_epoch, best_acc = run.restore()
        if args.test is not None:
            return run.evaluate(eval_semseg)[1]
        for epoch in range(start_epoch, args.epochs):
            tr = run.train(epoch)
            acc, miou, test_loss = run.evaluate(eval_semseg)
            is_best = acc >= best_acc
            best_acc = max(best_acc, acc)
            run.save(epoch, is_best, best_acc)
            run.epoch_log(
                f"EPOCH {epoch:03d}/{args.epochs:03d} | Test: loss {test_loss:.6f}, "
                f"acc {acc:.6f}, miou {miou:.6f} | Train: loss {tr['loss']:.6f} | "
                f"{time.strftime('%Y-%m-%d-%H-%M-%S')}")
        return best_acc
