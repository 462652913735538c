"""B10b's first round in fast mode against the Pallas kernel in
interpret mode (the cases and bars of tests/test_torch_round2_modes.py)."""

import pytest

from test_torch_round2_modes import (  # noqa: F401
    CASE_IDS,
    CASES,
    _one_torch_thread,
    cls_folded,
    first_modes_case,
)

IDS = [i for c, i in zip(CASES, CASE_IDS) if c[0] == "fast"]


@pytest.mark.parametrize("mode,n,t", [c for c in CASES if c[0] == "fast"],
                         ids=IDS)
def test_round2_first_modes_match_jax(cls_folded, mode, n, t):  # noqa: F811
    first_modes_case(cls_folded, mode, n, t)
