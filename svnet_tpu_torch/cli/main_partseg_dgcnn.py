"""Part-segmentation CLI of the port (counterpart of
svnet_tpu/cli/main_partseg_dgcnn.py):

    python -m svnet_tpu_torch.cli.main_partseg_dgcnn --binary --data-dir data

trains SV-DGCNN on ShapeNetPart (<data-dir>/shapenet*hdf5*/) on the card;
``--device cpu`` runs the kernels' plain versions on the CPU."""

from svnet_tpu_torch.cli.flags import build_parser
from svnet_tpu_torch.train.loop import run_partseg


def main(argv=None):
    return run_partseg(build_parser("partseg", "dgcnn").parse_args(argv))


if __name__ == "__main__":
    main()
