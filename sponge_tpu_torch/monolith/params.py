"""Deterministic Monolith parameter generation.

Counterpart of ``sponge_tpu/monolith/params.py``, in pure Python.  R = 6
rounds, Bars on the leading u elements (u = 4 for the 64-bit instances, 8
for the 31-bit ones), Bricks, and an MDS Concrete with round constants after
it in all but the last round.

Concrete matrices: Goldilocks t = 12 takes the power-of-two circulant
circ(1, 1, 2, 1, 8, 32, 2, 256, 4096, 8, 65536, 1024), Goldilocks t = 8 the
small-integer circulant (25, 6, 2, 25, 27, 14, 29, 1), and the 31-bit fields
(Mersenne31, KoalaBear, BabyBear) at t = 16 the small-integer circulant
(31, 19, 21, ...); each was checked MDS by the JAX package's
``tools/check_mds``.  Other geometries fall back to a Cauchy matrix
``(x_i + y_j)^-1`` drawn from the same Grain stream as the round constants.

Round constants come from the Poseidon Grain LFSR seeded with
(sbox_inverse=False, prime bits, t, R_F=rounds, R_P=bars): rounds - 1 rows
of t rejection-sampled elements (the last row is zero), then the Cauchy
draws where they apply.  A self-consistent deterministic instance, with the
scalar oracle as ground truth.
"""

from __future__ import annotations

import functools

from ..fields import FieldSpec
from ..poseidon.params import PoseidonGrainLFSR
from .config import MonolithConfig

_GOLDILOCKS_T12_ROW = (1, 1, 2, 1, 8, 32, 2, 256, 4096, 8, 65536, 1024)
_M31_T16_ROW = (31, 19, 21, 11, 5, 7, 9, 26, 9, 16, 23, 13, 30, 30, 17, 5)
_GOLDILOCKS_T8_ROW = (25, 6, 2, 25, 27, 14, 29, 1)


def _circulant(row: tuple) -> tuple:
    t = len(row)
    return tuple(tuple(row[(j - i) % t] for j in range(t)) for i in range(t))


def _cauchy_mds(lfsr: PoseidonGrainLFSR, fs: FieldSpec, t: int) -> tuple:
    """Cauchy matrix from the Grain stream: redraw until the x_i are
    pairwise distinct, the y_j are pairwise distinct and every x_i + y_j is
    nonzero."""
    p = fs.modulus
    while True:
        xs = lfsr.get_field_elements_mod_p(fs, t)
        ys = lfsr.get_field_elements_mod_p(fs, t)
        if len(set(xs)) != t or len(set(ys)) != t:
            continue
        if any((x + y) % p == 0 for x in xs for y in ys):
            continue
        return tuple(tuple(pow((x + y) % p, -1, p) for y in ys) for x in xs)


def generate_monolith_parameters(
    fs: FieldSpec,
    rate: int,
    capacity: int,
    rounds: int = 6,
    bars: int | None = None,
    concrete: tuple | None = None,
) -> MonolithConfig:
    """Deterministic Monolith parameters for a bar-safe field."""
    t = rate + capacity
    if bars is None:
        bars = 4 if fs.modulus_bit_size > 32 else 8
    lfsr = PoseidonGrainLFSR(False, fs.modulus_bit_size, t, rounds, bars)
    rc = tuple(
        tuple(lfsr.get_field_elements_rejection_sampling(fs, t)) for _ in range(rounds - 1)
    ) + ((0,) * t,)
    if concrete is None:
        if fs.name == "goldilocks_fr" and t == 12:
            concrete = _circulant(_GOLDILOCKS_T12_ROW)
        elif fs.name == "goldilocks_fr" and t == 8:
            concrete = _circulant(_GOLDILOCKS_T8_ROW)
        elif fs.name in ("mersenne31_fr", "koalabear_fr", "babybear_fr") and t == 16:
            concrete = _circulant(_M31_T16_ROW)
        else:
            concrete = _cauchy_mds(lfsr, fs, t)
    return MonolithConfig(
        field=fs, rounds=rounds, bars=bars, rc=rc, concrete=concrete, rate=rate, capacity=capacity
    )


# (field, rate) -> (capacity, rounds, bars): Monolith-64 at t = 12 and t = 8
# (u = 4), Monolith-31 at t = 16 (u = 8), extended to KoalaBear and BabyBear.
_DEFAULTS = {
    ("goldilocks_fr", 8): (4, 6, 4),
    ("goldilocks_fr", 4): (4, 6, 4),
    ("mersenne31_fr", 8): (8, 6, 8),
    ("koalabear_fr", 8): (8, 6, 8),
    ("babybear_fr", 8): (8, 6, 8),
}


@functools.lru_cache(maxsize=None)
def get_default_monolith_parameters(fs: FieldSpec, rate: int = 8) -> MonolithConfig:
    """Default Monolith parameters (small-field sponge geometries only)."""
    key = (fs.name, rate)
    if key not in _DEFAULTS:
        raise ValueError(
            f"no default Monolith parameters for {fs.name} at rate={rate}: "
            f"the Bars layer requires p = 2^n - 2^m + 1 (Goldilocks rates "
            f"4/8; Mersenne31, KoalaBear, BabyBear rate 8)"
        )
    capacity, rounds, bars = _DEFAULTS[key]
    return generate_monolith_parameters(fs, rate, capacity, rounds, bars)
