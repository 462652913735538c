"""``analyze_model``'s every number against JAX's for the original PointNet and DGCNN and BiPointNet
(tests/test_torch_analysis.py::parity), at N = 64, k = 8; binary and FP
where the model takes ``binary``. Six cases: each traces a JAX model.
"""

import pytest

from test_torch_analysis import parity

CASES = [
    ('cls', 'dgcnn', 'original', False),
    ('partseg', 'dgcnn', 'original', False),
    ('cls', 'pointnet', 'original', False),
    ('partseg', 'pointnet', 'original', False),
    ('cls', 'pointnet', 'bipointnet', False),
    ('partseg', 'pointnet', 'bipointnet', False),
]


@pytest.mark.parametrize("task,backbone,model,binary", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_analyze_model_matches_jax(task, backbone, model, binary):
    parity(task, backbone, model, binary)
