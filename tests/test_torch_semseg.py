"""S3DIS and the semantic-segmentation trainer of the port
(``data.S3DIS``/``RoomArrayDataset``, the Loader's per-point batches,
``train.loop.run_semseg``, ``cli/main_semseg.py``) against the JAX
package's, and ``--model bipointnet`` through the trainers: the weights
drawn on the first test batch, both PointNet CLIs and ``main_semseg``
for one epoch with ``--device cpu``, then ``--test`` on the checkpoint.
A synthetic S3DIS tree as tests/test_semseg.py writes one: 12 rooms of
128 points of 9 channels in one HDF5 file, 13 labels, areas 1-6.
"""

import h5py
import numpy as np
import pytest
import torch

from svnet_tpu.cli.main_semseg import build_parser as jax_semseg_parser
from svnet_tpu.data import S3DIS as JaxS3DIS
from svnet_tpu.data import Loader as JaxLoader
from svnet_tpu_torch.cli import flags
from svnet_tpu_torch.cli.main_cls_pointnet import main as cls_pointnet
from svnet_tpu_torch.cli.main_partseg_pointnet import main as pseg_pointnet
from svnet_tpu_torch.cli.main_semseg import build_parser, main as semseg_main
from svnet_tpu_torch.data import ArrayDataset, Loader, RoomArrayDataset, S3DIS
from svnet_tpu_torch.models import BiPointNetCls
from svnet_tpu_torch.nn.scope import init_tree
from svnet_tpu_torch.train import loop
from svnet_tpu_torch.utils.convert import flatten, module_tree

from test_torch_pseg_train import _write_shapenetpart
from test_torch_zoo_cli import _common, _head, _write_modelnet40
from test_torch_zoo_cls import _one_torch_thread  # noqa: F401

ROOMS, POINTS = 12, 128


@pytest.fixture(scope="module")
def s3dis(tmp_path_factory):
    root = tmp_path_factory.mktemp("s3dis")
    d = root / "indoor3d_sem_seg_hdf5_data"
    d.mkdir()
    rng = np.random.default_rng(0)
    with h5py.File(d / "ply_data_all_0.h5", "w") as f:
        f["data"] = rng.standard_normal((ROOMS, POINTS, 9)).astype("float32")
        f["label"] = rng.integers(0, 13, (ROOMS, POINTS)).astype("uint8")
    (d / "all_files.txt").write_text("indoor3d_sem_seg_hdf5_data/ply_data_all_0.h5\n")
    names = [f"Area_{1 + (i % 6)}_room{i}" for i in range(ROOMS)]
    (d / "room_filelist.txt").write_text("\n".join(names) + "\n")
    return root


def test_s3dis_items_and_batches_match_jax(s3dis):
    """Both partitions of ``--test-area 5``: the rooms, and each item
    (the first 96 points; train: permuted with their labels, two passes
    of the same generator) bitwise JAX's; the Loader's batches (B=4,
    shuffled, and padded for test) bitwise JAX's Loader's: points (4, 96,
    9), a per-point target (4, 96), no label or category."""
    for part, seed in (("train", 1), ("test", 2)):
        got = S3DIS(96, str(s3dis), part, "5", seed)
        want = JaxS3DIS(96, str(s3dis), part, "5", seed)
        assert len(got) == len(want) == (10 if part == "train" else 2)
        for _ in range(2):
            for i in range(len(got)):
                (gp, gs), (wp, ws) = got[i], want[i]
                np.testing.assert_array_equal(gp, wp)
                np.testing.assert_array_equal(gs, ws)
                assert gp.shape == (96, 9) and gs.dtype == np.int64
        train = part == "train"
        kw = dict(shuffle=train, drop_last=train, pad_last=not train, seed=3)
        got = Loader(S3DIS(96, str(s3dis), part, "5", seed), 4, device="cpu", **kw)
        want = JaxLoader(JaxS3DIS(96, str(s3dis), part, "5", seed), 4, **kw)
        for gb, wb in zip(got, want, strict=True):
            assert set(gb) == {"points", "target", "pad", "size"}
            assert gb["points"].shape == (4, 96, 9) and gb["target"].shape == (4, 96)
            for name in ("points", "target"):
                np.testing.assert_array_equal(gb[name].numpy(), wb[name])
            assert (gb["pad"], gb["size"]) == (wb["pad"], wb["size"])


def test_semseg_miou():
    """The mean IoU over the classes present in the truth (a class only
    predicted counts nowhere); the point accuracy beside it."""
    seg = np.array([[0, 0, 1, 1], [2, 2, 2, 0]])
    pred = np.array([[0, 1, 1, 1], [2, 2, 5, 0]])
    # class 0: 2 of 3; class 1: 2 of 3; class 2: 2 of 3
    assert loop.semseg_miou(pred, seg) == pytest.approx(2 / 3)
    assert loop.semseg_miou(seg, seg) == 1.0

    def step(batch, generator):
        return torch.tensor(0.5), torch.from_numpy(pred)

    loader = [{"target": torch.from_numpy(seg), "size": 2}]
    acc, miou, loss = loop.eval_semseg(step, loader, None, lambda m: None)
    assert (acc, miou, loss) == (0.75, pytest.approx(2 / 3), 0.5)


def test_bipointnet_trainer_inits_on_the_first_test_batch(tmp_path):
    """``--model bipointnet``: the trainer's starting weights are the
    seeded model's kernels with the LSR scales drawn on the first test
    batch (JAX's ``model.init`` on it), not on the constructor's tiny
    cloud; ``init_on`` draws exactly ``init_tree`` on the batch."""
    rng = np.random.default_rng(7)
    train = ArrayDataset(rng.standard_normal((8, 32, 3)), rng.integers(0, 40, 8),
                         train=True)
    test = ArrayDataset(rng.standard_normal((4, 32, 3)), rng.integers(0, 40, 4))
    args = flags.build_parser("cls", "pointnet").parse_args(
        ["--model", "bipointnet", *_common(tmp_path, tmp_path / "r")])
    run = loop._Run(args, "cls")
    built = run.build()
    seeded = module_tree(BiPointNetCls(40, 4, generator=torch.Generator().manual_seed(1)))
    run.prepare(built, loop.model_loss, train, test)
    got = flatten(run.state.tree())
    points = next(iter(Loader(test, 4, device="cpu")))["points"]
    want = flatten(init_tree(type(built[0]).forward_fn, (points,), built[0].config,
                             torch.Generator().manual_seed(1)))
    assert set(got) == set(want)
    moved = 0
    for path, w in want.items():
        torch.testing.assert_close(got[path], w, rtol=0, atol=0, msg=path)
        moved += not torch.equal(flatten(seeded)[path], w)
    # the 15 LSR scales moved to the batch's; nothing else
    assert moved == 15


def test_bipointnet_clis_train_and_test_on_cpu(tmp_path):
    """``main_cls_pointnet`` and ``main_partseg_pointnet`` with ``--model
    bipointnet --device cpu``: one epoch, the EPOCH line, a 40-class or
    50-part head, ``--test`` on the best checkpoint giving the same
    metric."""
    for task, main, write, seed in (("cls", cls_pointnet, _write_modelnet40, 4),
                                    ("partseg", pseg_pointnet, _write_shapenetpart, 6)):
        data, save = tmp_path / f"data_{task}", tmp_path / f"res_{task}"
        write(data, np.random.default_rng(seed))
        common = _common(data, save, ("--model", "bipointnet"))
        metric = main(common)
        assert 0.0 <= metric <= 1.0
        assert "EPOCH 000/001 | Test: loss" in (save / f"{task}-log.txt").read_text()
        assert _head(save)[1] == (40 if task == "cls" else 50)
        best = str(save / "save_models" / "model_best.ckpt")
        assert main(common + ["--test", best]) == metric


def test_main_semseg_trains_and_tests_on_cpu(s3dis, tmp_path):
    """``main_semseg --device cpu`` for one epoch on the synthetic rooms
    (``--test-area 5``: 10 train rooms, 2 test): the EPOCH line, the
    best point accuracy returned, a 13-class head; ``--test`` on the
    checkpoint returns the mIoU the epoch logged. The flags: JAX's
    defaults; ``--rot z`` raises ``ValueError``, ``--dp 2``
    ``NotImplementedError``."""
    save = tmp_path / "res"
    common = ["--epochs", "1", "--num-points", "96", "--batch-size", "4",
              "--test-area", "5", "--data-dir", str(s3dis), "--save-dir", str(save),
              "--device", "cpu"]
    acc = semseg_main(common)
    assert 0.0 <= acc <= 1.0
    log = (save / "semseg-log.txt").read_text()
    assert f"acc {acc:.6f}, miou " in log
    ckpt = torch.load(save / "save_models" / "model_best.ckpt", map_location="cpu",
                      weights_only=False)
    assert tuple(ckpt["params"]["convs4"]["kernel"].shape) == (128, 13)
    miou = semseg_main(common + ["--test", str(save / "save_models" / "model_best.ckpt")])
    assert f"miou {miou:.6f}" in log

    want = vars(jax_semseg_parser().parse_args([]))
    got = vars(build_parser().parse_args([]))
    assert {n: got[n] for n in want} == want and got["device"] == "cuda"
    with pytest.raises(ValueError):
        semseg_main(common + ["--rot", "z"])
    with pytest.raises(NotImplementedError):
        semseg_main(common + ["--dp", "2"])


def test_room_array_dataset_is_s3dis_in_memory(s3dis):
    """``RoomArrayDataset`` on S3DIS's arrays draws the same items."""
    want = S3DIS(64, str(s3dis), "train", "2", 5)
    got = RoomArrayDataset(want.data, want.seg, 64, train=True, seed=5)
    for i in range(len(want)):
        for g, w in zip(got[i], want[i]):
            np.testing.assert_array_equal(g, w)
