"""The port's VN and original part segmenters (``--model vn|original``,
PointNet and DGCNN backbones) against the JAX package's flax models (CPU,
B=4, N=32, k=8, 50 parts, one-hot categories), by the checks and bars of
tests/test_torch_zoo_cls.py: the weight tree, eval in float32, the train
forward and one train step (loss without label smoothing, as the JAX
trainer's ``seg_loss``; the T-Net term for the original PointNet) in
float64.
"""

import pytest

from test_torch_zoo_cls import _one_torch_thread, check_model  # noqa: F401


@pytest.mark.parametrize("backbone,model,pooling", [
    ("pointnet", "vn", "mean"), ("dgcnn", "vn", "max"),
    ("pointnet", "original", "mean"), ("dgcnn", "original", "mean")])
def test_part_segmenter_matches_flax(backbone, model, pooling):
    check_model("partseg", backbone, model, pooling)
