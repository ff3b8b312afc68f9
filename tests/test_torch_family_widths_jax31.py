"""Kernel 5's 31-bit widths (t = 9..15, L = 2) against the JAX package's
XLA tier: ``check_rescue_width`` of ``tests/test_torch_family_widths_jax.py``
on the first field of each new (t, L), cut to one round, 16 lanes, exact
equality."""

import pytest
from test_torch_family_widths_jax import check_rescue_width, small_widths

THIRTY_ONE_BIT = small_widths(2)


@pytest.mark.parametrize("label", list(THIRTY_ONE_BIT))
def test_rescue_plain_matches_permute_jit_at_the_31_bit_fields(label):
    check_rescue_width(THIRTY_ONE_BIT[label])
