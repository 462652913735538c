"""AOT export of the port's other engines (svnet_tpu_torch/serve.py), on
the CPU: the round2, round and edge trunks of the classifier, the SV-DGCNN
part segmenter and the SV-PointNet classifier, each artifact bitwise its
live engine (the cases and ``check_artifact`` are tests/test_torch_serve.py's;
its last case runs in tests/test_torch_serve_ops.py, to keep each file at
most 6 tests)."""

import pytest

from test_torch_serve import OTHER_CASES, _one_torch_thread, check_artifact  # noqa: F401

TRUNK_CASES = list(OTHER_CASES)[:6]


@pytest.mark.parametrize("case", TRUNK_CASES)
def test_artifact_equals_live_engine(case):
    """The engine's artifact equals its live engine (``check_artifact``)."""
    check_artifact(*OTHER_CASES[case])
