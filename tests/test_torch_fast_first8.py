"""B1 in fast mode at 8-bit gathers against the Pallas kernel in
interpret mode (the cases and bars of tests/test_torch_fast.py)."""

import pytest

from test_torch_fast import (  # noqa: F401
    FIRST_CASES,
    _first_case,
    _gather_bits,
    _one_torch_thread,
    first_ids,
)

CASES = [c for c in FIRST_CASES if c[0] == 8]


@pytest.mark.parametrize("bits,n,t,cross,v_out", CASES, ids=first_ids(CASES))
def test_round3_first_fast_matches_jax(bits, n, t, cross, v_out):
    with _gather_bits(bits):
        _first_case(n, t, cross, v_out)
