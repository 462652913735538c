"""S3DIS semantic-segmentation CLI of the port (counterpart of
svnet_tpu/cli/main_semseg.py), BiPointNet_SEMSEG:

    python -m svnet_tpu_torch.cli.main_semseg --data-dir data --test-area 5

trains on the card; ``--device cpu`` trains on the CPU. The JAX CLI's
flags plus ``--device``; ``--dp`` other than 1 raises
(``flags.check_ported``), and the flags of the other CLIs that the
shared trainer reads take their values that do not act (no knobs, no
preload, no BN re-estimation)."""

import argparse

from svnet_tpu_torch.cli.flags import build_parser as trainer_parser
from svnet_tpu_torch.train.loop import run_semseg


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="S3DIS semantic segmentation (PyTorch / CUDA)")
    p.add_argument("--model", type=str, default="bipointnet",
                   choices=["bipointnet"])
    p.add_argument("--test-area", type=str, default="5")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--wd", type=float, default=1e-4)
    p.add_argument("--num-points", type=int, default=4096)
    p.add_argument("--rot", type=str, default="aligned",
                   choices=["aligned", "z", "so3"])
    p.add_argument("--rot-test", type=str, default="aligned",
                   choices=["aligned", "z", "so3"])
    p.add_argument("--smoothing", action="store_true")
    p.add_argument("--test", metavar="PATH", default=None)
    p.add_argument("--resume-from", metavar="PATH", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--data-dir", metavar="DATADIR", type=str, default="data")
    p.add_argument("--save-dir", metavar="SAVEDIR", type=str, default="results")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default: the card, required) or 'cpu'")
    own = vars(p.parse_args([]))
    rest = vars(trainer_parser("cls", "pointnet").parse_args([]))
    p.set_defaults(**{n: v for n, v in rest.items() if n not in own})
    p.set_defaults(task="semseg", dataset="s3dis", binary=True, bn_reestimate=0,
                   num_workers=0)
    return p


def main(argv=None):
    return run_semseg(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
