"""Deterministic Griffin parameter generation.

Counterpart of ``sponge_tpu/griffin/params.py``, in pure Python.  alpha is
the smallest prime invertible mod p-1; the default round count is the
conservative envelope d = 3 -> 16, d = 5 -> 14, d >= 7 -> 12 for fields of
60 bits or more (smaller fields must pass ``rounds``); the linear layer is
Poseidon2's external matrix.  The rc rows come from the Poseidon Grain LFSR
by rejection sampling, then (a, b) is redrawn until a != 0 and a^2 - 4b is
a quadratic non-residue: a self-consistent deterministic instance, with the
scalar oracle as ground truth.
"""

from __future__ import annotations

import functools

from ..fields import FieldSpec
from ..poseidon.params import _DEFAULT_CAPACITY, PoseidonGrainLFSR
from ..poseidon2.params import external_matrix
from ..rescue.params import smallest_alpha
from .config import GriffinConfig, is_quadratic_nonresidue


def griffin_default_rounds(alpha: int) -> int:
    """The conservative default round count (module docstring)."""
    if alpha <= 3:
        return 16
    if alpha <= 5:
        return 14
    return 12


def generate_griffin_parameters(
    fs: FieldSpec,
    rate: int,
    capacity: int = 1,
    alpha: int | None = None,
    rounds: int | None = None,
) -> GriffinConfig:
    """Deterministic Griffin parameters for any (field, rate, capacity) with
    a defined external matrix."""
    t = rate + capacity
    p = fs.modulus
    if alpha is None:
        alpha = smallest_alpha(p)
    if rounds is None:
        if fs.modulus_bit_size < 60:
            raise ValueError(
                "Griffin's published security analysis covers large fields "
                f"only; pass rounds= explicitly for {fs.name} "
                f"({fs.modulus_bit_size} bits)"
            )
        rounds = griffin_default_rounds(alpha)
    mat_e = external_matrix(t)  # raises for unsupported widths
    lfsr = PoseidonGrainLFSR(False, fs.modulus_bit_size, t, rounds, 0)
    rc = tuple(tuple(lfsr.get_field_elements_rejection_sampling(fs, t)) for _ in range(rounds - 1))
    while True:
        a = lfsr.get_field_elements_rejection_sampling(fs, 1)[0]
        b = lfsr.get_field_elements_rejection_sampling(fs, 1)[0]
        if a != 0 and is_quadratic_nonresidue((a * a - 4 * b) % p, p):
            break
    return GriffinConfig(
        field=fs, rounds=rounds, alpha=alpha, mat_e=mat_e, rc=rc, qc_alpha=a, qc_beta=b,
        rate=rate, capacity=capacity,
    )


@functools.lru_cache(maxsize=None)
def get_default_griffin_parameters(fs: FieldSpec, rate: int) -> GriffinConfig:
    """Default Griffin parameters: smallest alpha, the conservative round
    count, the per-field sponge capacity."""
    return generate_griffin_parameters(fs, rate, _DEFAULT_CAPACITY.get(fs.name, 1))
