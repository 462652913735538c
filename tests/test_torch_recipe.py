"""The port's KD, --preload and --fused eval pieces, the knobs' scope and
``ste_quant8`` against the JAX package, and the serving pick's recipe
through the CLIs (CPU, tiny sizes; the knob-aware forwards and the KD
step are tests/test_torch_knobs.py).

``ste_quant8`` bitwise JAX's in value and straight-through in gradient,
and its gap to the serving engines' 8-bit grid; ``config.train_knob_state``
and ``loop.knob_scope``; ``Distiller.loss``, ``merge_overlap`` and both
branches of ``preload_weights`` against JAX's ``_Distiller``,
``_merge_overlap`` and ``_preload_weights`` on the same trees, a corrupt
or foreign checkpoint raising in the port (C3); ``--test --fused``
against JAX's ``_fused_cls_eval_step`` at ``--rot-test aligned``; the
recipe's three commands through both SV-DGCNN CLIs at a tiny size; the
flags (C24).

``--test --fused`` against JAX and the recipe through the CLIs are in
tests/test_torch_recipe_cli.py.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from svnet_tpu.nn.sv_layers import ste_quant8 as jax_ste_quant8
from svnet_tpu.train import loop as jax_loop
from svnet_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from svnet_tpu.train.steps import TrainState
from svnet_tpu_torch import config
from svnet_tpu_torch.cli import flags
from svnet_tpu_torch.nn.sv_train import ste_quant8
from svnet_tpu_torch.ops.kernels import quant
from svnet_tpu_torch.train import loop
from svnet_tpu_torch.train.steps import Distiller, create_state
from svnet_tpu_torch.utils.convert import flatten, from_flax, to_flax

from test_torch_knobs import B, CLASSES, LR, N, PARTS, _weights
from test_torch_train import _flat

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape", [(2, 64, 7), (2, 64, 3, 5)],
                         ids=["scalars", "vectors"])
def test_ste_quant8_matches_jax(shape):
    """Bitwise JAX's value, an identity gradient; against the engines'
    8-bit grid (``quant.grid_codes(x, 8)`` on the flattened channels):
    the same codes, values at most 1 ulp apart (``code / scale`` against
    ``code * (1 / scale)``)."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(shape) * 5.0).astype(np.float32)
    x[0, 0] = 0.0
    want = np.asarray(jax_ste_quant8(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    got = ste_quant8(xt)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    (got * 3.0).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.full(shape, 3.0, np.float32))
    flat = torch.from_numpy(x).reshape(B, N, -1)
    codes, inv = quant.grid_codes(flat, 8)
    grid = (codes.float() * inv).reshape(shape).numpy()
    scale = 127.0 / np.abs(x).reshape(B * N, -1).max(0)
    np.testing.assert_array_equal(
        codes.numpy(), np.clip(np.round(flat.numpy() * scale.astype(np.float32)),
                               -127, 127))
    ulp = np.spacing(np.abs(grid).astype(np.float32))
    assert np.all(np.abs(got.detach().numpy() - grid) <= ulp)


def test_knobs_resolved_once_and_scoped():
    """``config.train_knob_state`` reads the knobs once (None off or FP);
    ``loop.knob_scope`` sets the CLI's knobs for a run and restores them."""
    assert config.train_knob_state(True) is None
    args = flags.build_parser().parse_args(
        ["--binary", "--train-knobs", "--graph-reuse", "spatial", "--reuse-k",
         "4", "--approx-gather-bits", "8"])
    with loop.knob_scope(args):
        assert config.train_knob_state(True) == config.TrainKnobs("spatial", 4, True)
        assert config.train_knob_state(False) is None
        assert config.TrainKnobs("spatial", 4, True).round_k("conv3", 8) == 4
        assert config.TrainKnobs("conv2", 4, False).round_k("conv2", 8) == 8
    assert (config.train_knobs, config.graph_reuse, config.reuse_k,
            config.approx_gather_bits) == (False, "none", 0, 16)
    for bad in ("fast", ""):
        with pytest.raises(ValueError):
            config.set_fused_train(bad)
    assert config.use_fused_train("cuda") and not config.use_fused_train("cpu")


def _stub_teachers(logits):
    """A flax-like and an eager teacher that return ``logits``."""
    return (types.SimpleNamespace(apply=lambda *a, **kw: jnp.asarray(logits)),
            types.SimpleNamespace(eval=lambda: lambda *a: torch.from_numpy(
                logits.astype(np.float32))))


@pytest.mark.parametrize("pseg", [False, True], ids=["cls", "pseg"])
def test_distiller_loss_matches_jax(pseg):
    """``Distiller.loss`` against ``_Distiller.loss`` on the same teacher
    and student logits (a stub teacher), T = 2 and 4; its gradient."""
    rng = np.random.default_rng(2)
    shape = (B, N, PARTS) if pseg else (B, CLASSES)
    teacher, student = rng.standard_normal(shape), rng.standard_normal(shape)
    for T in (2.0, 4.0):
        jax_teacher, teacher_model = _stub_teachers(teacher)
        jd = jax_loop._Distiller(jax_teacher, None, pseg, T)
        want, want_g = jax.jit(jax.value_and_grad(
            lambda s: jd.loss(s, None, None)))(jnp.asarray(student, jnp.float32))
        st = torch.tensor(student, dtype=torch.float32, requires_grad=True)
        got = Distiller(teacher_model, T).loss(st, None)
        got.backward()
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
        np.testing.assert_allclose(st.grad.numpy(), np.asarray(want_g), rtol=1e-5,
                                   atol=1e-8)


def test_merge_overlap_matches_jax():
    """An FP teacher's tree into a binary student's: the same leaves and
    hit counts as ``_merge_overlap`` (the student's beta and scale keep
    their values)."""
    student, teacher = to_flax(_weights(False)), to_flax(_weights(False, False, 9))
    for part in ("params", "batch_stats"):
        want, hits, total = jax_loop._merge_overlap(student[part], teacher[part])
        got, g_hits, g_total = loop.merge_overlap(
            from_flax({"params": student[part], "batch_stats": {}})["params"],
            from_flax({"params": teacher[part], "batch_stats": {}})["params"])
        assert (g_hits, g_total) == (hits, total) and 0 < hits <= total
        assert part == "batch_stats" or hits < total  # beta, scale: binary only
        w = traverse_util.flatten_dict(want, sep=".")
        g = flatten(got)
        assert set(g) == set(w)
        for path, val in w.items():
            np.testing.assert_array_equal(g[path].numpy(), np.asarray(val))


def _jax_state(tree):
    """A JAX TrainState of the tree (``_preload_weights`` reads and
    replaces only its params and batch_stats: no optimizer state)."""
    return TrainState(step=0, params=tree["params"],
                      batch_stats=tree["batch_stats"], opt_state=(), tx=None)


@pytest.mark.parametrize("source", ["binary", "fp"])
def test_preload_weights_matches_jax(tmp_path, source):
    """``--preload`` of the student's own tree (loaded whole) and of an FP
    teacher's (the overlap merge): the student's weights as JAX's
    ``_preload_weights`` leaves them, the same log line."""
    student = to_flax(_weights(False))
    saved = to_flax(_weights(False, source == "binary", 9))
    jax_path, path = tmp_path / "jax.ckpt", tmp_path / "port.ckpt"
    jax_save_checkpoint({"epoch": 0, **saved, "best_metric": 0.0}, 0,
                        str(tmp_path / "j"), False, None)
    (tmp_path / "j" / "save_models" / "checkpoint_000.ckpt").rename(jax_path)
    torch.save({"epoch": 0, **from_flax(saved)}, path)
    fp = to_flax(_weights(False, False, 3))
    t_template = {"epoch": 0, **fp, "best_metric": 0.0}
    jlog, plog = [], []
    want = jax_loop._preload_weights(
        _jax_state(student), types.SimpleNamespace(save_dir=str(tmp_path),
                                                   preload=str(jax_path)),
        t_template, jlog.append)
    state = create_state(from_flax(student), binary=True, lr=LR, epochs=1,
                         steps_per_epoch=1, device="cpu")
    branch = loop.preload_weights(state, str(path),
                                  loop.tree_shapes(from_flax(fp)), "cpu",
                                  plog.append)
    assert branch == ("same" if source == "binary" else "merge")
    assert [m.replace(str(jax_path), "P") for m in jlog] == \
        [m.replace(str(path), "P") for m in plog]
    got = state.tree()
    for part in ("params", "batch_stats"):
        w = _flat(getattr(want, part))
        g = _flat(to_flax(got[part]))
        assert set(g) == set(w)
        for p in w:
            np.testing.assert_array_equal(g[p], w[p])


def test_preload_refuses_what_jax_would_merge(tmp_path):
    """C3: a missing file, a corrupt one and a tree that is neither the
    student's nor the FP teacher's raise, where JAX's broad ``except``
    would take the teacher template's path."""
    state = create_state(_weights(False), binary=True, lr=LR, epochs=1,
                         steps_per_epoch=1, device="cpu")
    fp_shapes = loop.tree_shapes(_weights(False, False))
    with pytest.raises(FileNotFoundError):
        loop.preload_weights(state, str(tmp_path / "none.ckpt"), fp_shapes, "cpu")
    bad = tmp_path / "bad.ckpt"
    bad.write_bytes(b"not a checkpoint")
    with pytest.raises(Exception) as err:
        loop.preload_weights(state, str(bad), fp_shapes, "cpu")
    assert not isinstance(err.value, (ValueError, KeyError, TypeError))
    other = tmp_path / "other.ckpt"
    torch.save(_weights(True), other)  # the part segmenter's tree
    with pytest.raises(ValueError):
        loop.preload_weights(state, str(other), fp_shapes, "cpu")


def test_flags_act_or_raise():
    """Each newly accepted flag parses and reaches ``config`` through
    ``knob_scope``; each flag that would not act raises (C24)."""
    parser = flags.build_parser()
    pn = flags.build_parser("cls", "pointnet")
    ok = [["--binary", "--train-knobs", "--graph-reuse", "conv2", "--reuse-k", "4"],
          ["--binary", "--train-knobs", "--approx-gather-bits", "8"],
          ["--binary", "--test", "c", "--train-knobs", "--graph-reuse", "spatial"],
          ["--test", "c", "--fused", "--engine-mode", "approx", "--approx-fold",
           "128", "--approx-gather-bits", "8", "--graph-reuse", "spatial",
           "--reuse-k", "2", "--morton-entry"],
          ["--test", "c", "--fused", "--engine-mode", "fast",
           "--fast-gather-bits", "8"],
          ["--preload", "p"], ["--preload", "p", "--distill", "--kd-t", "2"],
          ["--resume-from", "r", "--preload", "p", "--distill", "--no-kd-init"]]
    for argv in ok:
        args = parser.parse_args(argv)
        flags.check_ported(args)
        with loop.knob_scope(args):
            for name in ("approx_fold", "approx_gather_bits", "fast_gather_bits",
                         "graph_reuse", "reuse_k", "morton_entry", "train_knobs"):
                if getattr(args, name) not in (0, False, "none"):
                    assert getattr(config, name) == getattr(args, name), name
    flags.check_ported(pn.parse_args(["--test", "c", "--fused", "--engine-mode",
                                      "approx", "--approx-gather-bits", "8"]))
    bad = [(parser, ["--fused"]), (parser, ["--train-knobs", "--graph-reuse",
                                            "spatial"]),
           (parser, ["--binary", "--train-knobs"]),
           (parser, ["--binary", "--test", "c", "--fused", "--train-knobs",
                     "--graph-reuse", "spatial"]),
           (parser, ["--engine-mode", "fast"]), (parser, ["--graph-reuse", "conv2"]),
           (parser, ["--test", "c", "--fused", "--approx-fold", "128"]),
           (parser, ["--test", "c", "--fused", "--engine-mode", "approx",
                     "--fast-gather-bits", "8"]),
           (parser, ["--binary", "--train-knobs", "--approx-gather-bits", "8",
                     "--reuse-k", "2"]),
           (parser, ["--distill"]), (parser, ["--test", "c", "--preload", "p"]),
           (parser, ["--test", "c", "--preload", "p", "--distill"]),
           (parser, ["--resume-from", "r", "--preload", "p", "--distill"]),
           (pn, ["--binary", "--train-knobs", "--graph-reuse", "spatial"]),
           (pn, ["--test", "c", "--fused", "--graph-reuse", "spatial"]),
           (flags.build_parser("partseg", "pointnet"), ["--test", "c", "--fused"])]
    for p, argv in bad:
        with pytest.raises(ValueError):
            flags.check_ported(p.parse_args(argv))
