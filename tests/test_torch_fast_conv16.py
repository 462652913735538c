"""B2 in fast mode at 16-bit gathers against the Pallas kernel in
interpret mode, binary and FP (the cases and bars of
tests/test_torch_fast.py)."""

import pytest

from test_torch_fast import (  # noqa: F401
    CONV_CASES,
    _conv_case,
    _gather_bits,
    _one_torch_thread,
    conv_ids,
    conv_weights,
)

CASES = [c for c in CONV_CASES if c[0] == 16]


@pytest.mark.parametrize("bits,name,n,t", CASES, ids=conv_ids(CASES))
def test_round3_fast_matches_jax(conv_weights, bits, name, n, t):  # noqa: F811
    with _gather_bits(bits):
        _conv_case(*conv_weights, name, n, t)
