"""Deterministic GMiMC-erf parameter generation.

Counterpart of ``sponge_tpu/gmimc/params.py``, in pure Python.  The default
round count is the post-attack envelope rounds = 2 ceil(log_alpha p) + 2t
(ePrint 2020/188, 2020/948), for fields of 60 bits or more; smaller fields
must pass ``rounds``.  alpha is the smallest prime invertible mod p-1 and the
round constants come from the Poseidon Grain LFSR by rejection sampling: a
self-consistent deterministic instance, with the scalar oracle as ground
truth.
"""

from __future__ import annotations

import functools
import math

from ..fields import FieldSpec
from ..poseidon.params import _DEFAULT_CAPACITY, PoseidonGrainLFSR
from ..rescue.params import smallest_alpha
from .config import GmimcConfig


def gmimc_default_rounds(fs: FieldSpec, t: int, alpha: int) -> int:
    """The conservative default round count (module docstring)."""
    return 2 * math.ceil(fs.modulus_bit_size / math.log2(alpha)) + 2 * t


def generate_gmimc_parameters(
    fs: FieldSpec,
    rate: int,
    capacity: int = 1,
    alpha: int | None = None,
    rounds: int | None = None,
) -> GmimcConfig:
    """Deterministic GMiMC-erf parameters for any (field, rate, capacity)."""
    t = rate + capacity
    if alpha is None:
        alpha = smallest_alpha(fs.modulus)
    if rounds is None:
        if fs.modulus_bit_size < 60:
            raise ValueError(
                "GMiMC's post-attack security analysis covers large fields "
                f"only; pass rounds= explicitly for {fs.name} "
                f"({fs.modulus_bit_size} bits)"
            )
        rounds = gmimc_default_rounds(fs, t, alpha)
    lfsr = PoseidonGrainLFSR(False, fs.modulus_bit_size, t, rounds, 0)
    rc = tuple(lfsr.get_field_elements_rejection_sampling(fs, rounds))
    return GmimcConfig(field=fs, rounds=rounds, alpha=alpha, rc=rc, rate=rate, capacity=capacity)


@functools.lru_cache(maxsize=None)
def get_default_gmimc_parameters(fs: FieldSpec, rate: int) -> GmimcConfig:
    """Default GMiMC-erf parameters: smallest valid alpha, the post-attack
    round count, the per-field sponge capacity."""
    return generate_gmimc_parameters(fs, rate, _DEFAULT_CAPACITY.get(fs.name, 1))
