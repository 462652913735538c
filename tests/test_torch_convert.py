"""The port's ``.pth`` converter (svnet_tpu_torch/utils/convert.py) against
JAX's (svnet_tpu/utils/convert.py) on synthetic reference state dicts:
the same tree, path for path, every leaf ``np.array_equal``.

The dicts cover every ``MODEL_RULES`` key and every rule pattern (each
pattern is asserted to match a key), each ``POST_HOOKS`` model at its real
row counts, the DataParallel ``module.`` prefix, 3-D and 4-D conv weights,
a 0-dim and a (1, out, 1) ``scale``, BN with and without affine leaves and
``num_batches_tracked``, and an unknown leaf. Then ``convert_file`` on a
``torch.save``d checkpoint of an SV-DGCNN classifier written in the
reference's naming: the port's ``check_structure`` finds its tree, the
leaves come back, and ``--test`` evaluates it.
"""

import re

import h5py
import numpy as np
import pytest
import torch

from svnet_tpu.utils import convert as jconv
from svnet_tpu_torch.cli.main_cls_dgcnn import main as cls_main
from svnet_tpu_torch.models.sv_dgcnn import SVDGCNNCls, init_params
from svnet_tpu_torch.utils import convert
from svnet_tpu_torch.utils.convert import flatten, module_tree, nest

# module path -> kind; each kind's leaves below
COMMON = {"conv1.gate.0": "lin", "conv1.gate.2": "lin",
          "conv2.linear1": "bin", "conv2.bn1": "bn", "conv2.bn2.bn": "bn_plain",
          "conv5.conv": "conv2d", "head.lsr": "lsr", "head.extra": "unknown"}
MODEL_MODULES = {
    "sv_dgcnn_cls": {},
    "sv_dgcnn_partseg": {"conv7.0": "conv1d", "conv7.1": "bn", "conv8.0": "conv1d",
                         "conv9.1": "bn", "conv10.0": "conv1d"},
    "sv_pointnet_cls": {"feat.conv1.linear2": "bin"},
    "sv_pointnet_partseg": {"conv_fuse1.0": "conv1d", "conv_fuse2.1": "bn",
                            "convs1.0": "conv1d", "convs2.1": "bn",
                            "convs3.0": "conv1d"},
    "vn_dgcnn_cls": {"linear1": ("rows", 6 * 682)},
    "vn_dgcnn_partseg": {"conv7.0": "conv1d", "conv7.1": "bn",
                         "conv8.0": ("rows", 3 * 682 + 64 + 3 * 63),
                         "conv9.1": "bn", "conv10.0": "conv1d"},
    "pointnet_cls": {"feat.stn.bn1": "bn", "feat.fstn.bn2": "bn",
                     "feat.stn.bn3": "bn", "feat.stn.bn4": "bn",
                     "feat.fstn.bn5": "bn", "feat.bn1": "bn", "feat.bn3": "bn"},
    "pointnet_partseg": {"stn.bn1": "bn", "fstn.bn4": "bn", "stn.bn5": "bn",
                         "bn1": "bn", "bn5": "bn", "bns1": "bn", "bns3": "bn"},
    "dgcnn_cls": {"conv1.0": "conv2d", "conv1.1": "bn", "conv5.0": "conv1d",
                  "bn1": "bn", "bn5": "bn"},
    "dgcnn_partseg": {"transform_net.conv1.0": "conv2d",
                      "transform_net.conv2.1": "bn", "transform_net.bn1": "bn",
                      "transform_net.bn2": "bn", "conv7.0": "conv1d",
                      "conv7.1": "bn", "conv3.0": "conv2d", "conv3.1": "bn",
                      "bn3": "bn", "bn7": "bn", "bn10": "bn"},
    "bipointnet_cls": {
        "feat.stn.bn1": "bn", "feat.stn.bn2": "bn", "feat.stn.bn3": "bn",
        "feat.fstn.bn4": "bn", "feat.fstn.bn5": "bn",
        "feat.stn.conv1.lin": "bin", "feat.fstn.conv1.lin": "bin",
        "feat.stn.conv2.lin": "bin", "feat.fstn.conv3.lin": "bin",
        "feat.stn.fc1": "lsr", "feat.fstn.fc2": "bin",
        "feat.bn1": "bn", "feat.bn2": "bn", "feat.bn3": "bn",
        "feat.conv1.lin": "bin", "feat.conv2.lin": "bin",
        "feat.conv3.lin": "bin", "bn1": "bn", "bn2": "bn", "fc1": "bin",
        "fc2": "lsr"},
    "bipointnet_partseg": {
        "stn.bn1": "bn", "fstn.bn2": "bn", "stn.bn3": "bn", "stn.bn4": "bn",
        "fstn.bn5": "bn", "stn.conv1.lin": "bin", "fstn.conv1.lin": "bin",
        "stn.conv2.lin": "bin", "fstn.conv3.lin": "bin", "stn.fc2": "lsr",
        "conv1.lin": "bin", "conv3.lin": "bin", "conv5.lin": "bin",
        "bn2": "bn", "bn5": "bn", "convs2.lin": "bin", "convs4.lin": "bin",
        "bns1": "bn"},
    "vn_pointnet_cls": {"feat.conv3.map_to_feat": "lin",
                        "feat.fstn.fc3.map_to_feat": "lin",
                        "fc1": ("rows", 3 * 682)},
    "vn_pointnet_partseg": {"conv5.map_to_feat": "lin",
                            "fstn.fc3.map_to_feat": "lin",
                            "convs1": ("rows", 3 * 1364 + 16 + 3 * 275 + 3 * 1364)},
}


def _leaves(kind, rng, prefix: str) -> dict:
    """A module's reference leaves (torch orientation), seeded."""
    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    o, i = 3, 5
    if isinstance(kind, tuple):  # a post-hook linear at its real rows
        kind, i = "conv1d", kind[1]
    leaves = {
        "lin": lambda: {"weight": r(o, i), "bias": r(o)},
        "conv1d": lambda: {"weight": r(o, i, 1)},
        "conv2d": lambda: {"weight": r(o, i, 1, 1)},
        "bin": lambda: {"weight": r(o, i, 1), "beta": r(1, i, 1),
                        "scale": r(1, o, 1)},
        "lsr": lambda: {"weight": r(o, i), "scale": np.array(0.7, np.float32)},
        "bn": lambda: {"weight": r(o), "bias": r(o), "running_mean": r(o),
                       "running_var": np.abs(r(o)) + 0.1,
                       "num_batches_tracked": np.array(7, np.int64)},
        "bn_plain": lambda: {"running_mean": r(o), "running_var": np.abs(r(o)),
                             "num_batches_tracked": np.array(3, np.int64)},
        "unknown": lambda: {"alpha": r(2)},
    }[kind]()
    return {f"{prefix}.{n}": v for n, v in leaves.items()}


def state_dict(model: str, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    sd = {}
    for path, kind in {**COMMON, **MODEL_MODULES[model]}.items():
        sd.update(_leaves(kind, rng, "module." + path))
    return sd


def _as_numpy(tree: dict) -> dict:
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in flatten(tree).items()}


def test_every_model_and_rule_is_covered():
    """Each MODEL_RULES key has a dict here, and each of its rule patterns
    (and the common ones) matches a key as the rules see it."""
    assert set(MODEL_MODULES) == set(convert.MODEL_RULES) == set(jconv.MODEL_RULES)
    for model, rules in convert.MODEL_RULES.items():
        keys = [k[len("module."):] for k in state_dict(model)]
        for pat, rep in convert._COMMON_RULES + rules:
            assert any(re.search(pat, k) for k in keys), (model, pat)
            keys = [re.sub(pat, rep, k) for k in keys]


@pytest.mark.parametrize("model", sorted(jconv.MODEL_RULES))
def test_convert_state_dict_matches_jax(model):
    """The port's tree equals JAX's: the same paths, every leaf equal, the
    port's as float32 tensors; torch tensors in and numpy arrays in give
    the same tree."""
    sd = state_dict(model)
    want = _as_numpy(jconv.convert_state_dict(sd, model=model))
    for given in (sd, {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}):
        got = convert.convert_state_dict(given, model=model)
        flat = flatten(got)
        assert all(isinstance(v, torch.Tensor) and v.dtype == torch.float32
                   for v in flat.values())
        got = _as_numpy(got)
        assert sorted(got) == sorted(want)
        for path in want:
            assert got[path].shape == want[path].shape, path
            assert np.array_equal(got[path], want[path].astype(np.float32)), path


def _reference_state_dict(tree: dict) -> dict:
    """A port weight tree of the SV-DGCNN classifier in the reference's
    naming and orientation: gate_fc1/2 -> gate.0/2, kernels (out, in[, 1]),
    beta (1, in, 1), scale (1, out, 1), BN leaves with running stats."""
    sd = {}
    for path, v in flatten(tree["params"]).items():
        path = path.replace("gate_fc1", "gate.0").replace("gate_fc2", "gate.2")
        head, leaf = path.rsplit(".", 1)
        if leaf == "kernel":
            sd[f"{head}.weight"] = v.T[..., None] if "linear" in head else v.T
        elif head.endswith(".bn") or head == "bn":
            sd[f"{head}.{'weight' if leaf == 'scale' else leaf}"] = v
        elif leaf in ("beta", "scale"):
            sd[path] = v.reshape(1, -1, 1)
        else:
            sd[path] = v
    for path, v in flatten(tree["batch_stats"]).items():
        head, leaf = path.rsplit(".", 1)
        sd[f"{head}.running_{leaf}"] = v
        sd[f"{head}.num_batches_tracked"] = torch.tensor(5)
    return {"module." + k: v.clone() for k, v in sd.items()}


def test_convert_file_feeds_test(tmp_path):
    """load_pth / convert_file on a torch.save'd {'state_dict': ...}:
    check_structure finds the port model's tree, every leaf returns, and
    the CLI's --test evaluates the converted checkpoint on the CPU."""
    gen = torch.Generator().manual_seed(3)
    tree = init_params(40, 4, True, gen)
    tree["batch_stats"] = nest({k: torch.rand(v.shape, generator=gen) + 0.5
                                for k, v in flatten(tree["batch_stats"]).items()})
    pth = tmp_path / "model.t7"
    torch.save({"epoch": 250, "state_dict": _reference_state_dict(tree)}, pth)
    out = tmp_path / "converted.ckpt"
    convert.main([str(pth), str(out), "--model", "sv_dgcnn_cls"])
    ckpt = torch.load(out, weights_only=True)
    model = SVDGCNNCls(40, 4, True)
    converted = {"params": ckpt["params"], "batch_stats": ckpt["batch_stats"]}
    assert convert.check_structure(converted, module_tree(model)) == ([], [], [])
    want = {**flatten(tree["params"]), **flatten(tree["batch_stats"])}
    got = {**flatten(ckpt["params"]), **flatten(ckpt["batch_stats"])}
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert convert.load_pth(str(pth)).keys() == {"params", "batch_stats"}

    rng = np.random.default_rng(4)
    root = tmp_path / "data" / "modelnet40_ply_hdf5_2048"
    root.mkdir(parents=True)
    for part, n in (("train", 4), ("test", 4)):
        with h5py.File(root / f"ply_data_{part}0.h5", "w") as f:
            f["data"] = rng.standard_normal((n, 48, 3)).astype("float32")
            f["label"] = rng.integers(0, 40, (n, 1)).astype("int64")
    acc = cls_main(["--binary", "--test", str(out), "--batch-size", "4",
                    "--num-points", "32", "--k", "4", "--num-workers", "1",
                    "--rot-test", "aligned", "--device", "cpu",
                    "--data-dir", str(tmp_path / "data"),
                    "--save-dir", str(tmp_path / "res")])
    assert 0.0 <= acc <= 1.0
    log = next((tmp_path / "res").glob("cls-2*.txt")).read_text()
    assert "checkpoint loaded successfully" in log
