"""SV-PointNet classification CLI of the port (counterpart of
svnet_tpu/cli/main_cls_pointnet.py):

    python -m svnet_tpu_torch.cli.main_cls_pointnet --binary --data-dir data

runs on the card; ``--device cpu`` runs the kernels' plain versions on
the CPU."""

from svnet_tpu_torch.cli.flags import build_parser
from svnet_tpu_torch.train.loop import run_cls


def main(argv=None):
    return run_cls(build_parser("cls", "pointnet").parse_args(argv))


if __name__ == "__main__":
    main()
