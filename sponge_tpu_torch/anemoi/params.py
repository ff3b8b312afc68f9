"""Deterministic Anemoi parameter generation.

Counterpart of ``sponge_tpu/anemoi/params.py``, in pure Python.  alpha is
the smallest prime invertible mod p-1 and g the field's generator.  M_x is
the identity at l = 1, the paper's [[1, g], [g, g^2 + 1]] at l = 2 and a
Grain-drawn Cauchy matrix for l >= 3.  The default round count is the
conservative envelope l = 1 -> 25, l = 2 -> 17, l >= 3 -> 14 for fields of
60 bits or more (smaller fields must pass ``rounds``).  The rc rows come
from the Poseidon Grain LFSR (rounds rows of l for X, then for Y, then the
Cauchy draws): a self-consistent deterministic instance, with the scalar
oracle as ground truth.
"""

from __future__ import annotations

import functools

from ..fields import FieldSpec
from ..poseidon.params import _DEFAULT_CAPACITY, PoseidonGrainLFSR
from ..rescue.params import smallest_alpha
from .config import AnemoiConfig


def anemoi_default_rounds(lcol: int) -> int:
    """The conservative default round count (module docstring)."""
    if lcol == 1:
        return 25
    if lcol == 2:
        return 17
    return 14


def cauchy_mds(lfsr: PoseidonGrainLFSR, fs: FieldSpec, n: int) -> tuple:
    """An n x n Cauchy matrix 1 / (x_i + y_j) from the Grain stream, redrawn
    until the x_i are distinct, the y_j are distinct and no x_i + y_j is 0
    (``sponge_tpu/monolith/params.py`` ``_cauchy_mds``)."""
    p = fs.modulus
    while True:
        xs = lfsr.get_field_elements_mod_p(fs, n)
        ys = lfsr.get_field_elements_mod_p(fs, n)
        if len(set(xs)) != n or len(set(ys)) != n:
            continue
        if any((x + y) % p == 0 for x in xs for y in ys):
            continue
        return tuple(tuple(pow((x + y) % p, -1, p) for y in ys) for x in xs)


def diffusion_matrix(lfsr: PoseidonGrainLFSR, fs: FieldSpec, lcol: int) -> tuple:
    """M_x for l = lcol (module docstring); draws from ``lfsr`` for l >= 3."""
    g, p = fs.generator, fs.modulus
    if lcol == 1:
        return ((1,),)
    if lcol == 2:
        return ((1, g), (g, (g * g + 1) % p))
    return cauchy_mds(lfsr, fs, lcol)


def generate_anemoi_parameters(
    fs: FieldSpec,
    rate: int,
    capacity: int = 1,
    alpha: int | None = None,
    rounds: int | None = None,
) -> AnemoiConfig:
    """Deterministic Anemoi parameters for any even-width (field, rate,
    capacity)."""
    t = rate + capacity
    if t % 2 != 0:
        raise ValueError(f"Anemoi state width must be even; got t={t}")
    lcol = t // 2
    if alpha is None:
        alpha = smallest_alpha(fs.modulus)
    if rounds is None:
        if fs.modulus_bit_size < 60:
            raise ValueError(
                "Anemoi's published security analysis covers large fields "
                f"only; pass rounds= explicitly for {fs.name} "
                f"({fs.modulus_bit_size} bits)"
            )
        rounds = anemoi_default_rounds(lcol)
    lfsr = PoseidonGrainLFSR(False, fs.modulus_bit_size, t, rounds, 0)
    rc_x = tuple(tuple(lfsr.get_field_elements_rejection_sampling(fs, lcol)) for _ in range(rounds))
    rc_y = tuple(tuple(lfsr.get_field_elements_rejection_sampling(fs, lcol)) for _ in range(rounds))
    return AnemoiConfig(
        field=fs, rounds=rounds, alpha=alpha, g=fs.generator,
        mat_x=diffusion_matrix(lfsr, fs, lcol), rc_x=rc_x, rc_y=rc_y, rate=rate,
        capacity=capacity,
    )


@functools.lru_cache(maxsize=None)
def get_default_anemoi_parameters(fs: FieldSpec, rate: int) -> AnemoiConfig:
    """Default Anemoi parameters: smallest alpha, the field's generator, the
    conservative round count, the per-field sponge capacity (rate must keep
    t even)."""
    return generate_anemoi_parameters(fs, rate, _DEFAULT_CAPACITY.get(fs.name, 1))
