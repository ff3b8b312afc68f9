"""Deterministic Rescue-Prime parameter generation.

Counterpart of ``sponge_tpu/rescue/params.py``, in pure Python.  Round
counts follow the Rescue-Prime specification's Groebner-basis cost model
(ePrint 2020/1143 §2.5); alpha is the smallest prime invertible mod p-1.
Round constants come from the Poseidon Grain LFSR by rejection sampling and
the MDS from the Cauchy construction: a self-consistent deterministic
instance, with the scalar oracle as ground truth.

``get_rpo_parameters`` is Rescue Prime Optimized as Miden deploys it
(miden-crypto ``Rpo256``, ePrint 2022/1577): Goldilocks, width 12, rate 8,
capacity 4, alpha 7, 7 rounds, the published circulant MDS and the affine
layer first.  Its round constants are the Grain draws of the other
instances, not Miden's ARK1/ARK2 tables.
"""

from __future__ import annotations

import dataclasses
import functools
import math

from ..fields import GOLDILOCKS_FR, FieldSpec
from ..poseidon.params import _DEFAULT_CAPACITY, PoseidonGrainLFSR
from .config import RescueConfig


def smallest_alpha(p: int) -> int:
    """The smallest prime alpha with gcd(alpha, p-1) = 1 (spec §2.2)."""
    cand = 3
    while True:
        if math.gcd(cand, p - 1) == 1:
            return cand
        cand += 2
        while any(cand % q == 0 for q in range(3, int(cand**0.5) + 1, 2)):
            cand += 2


def rescue_round_count(p: int, t: int, capacity: int, security_level: int, alpha: int) -> int:
    """Rounds N per the spec's Groebner cost model (§2.5): the smallest l1
    with binom(v(l1) + dcon(l1), v(l1))^2 > 2^security_level, where
    dcon(N) = floor((alpha-1) t (N-1) / 2) + 2 and v(N) = t (N-1) + rate;
    then N = ceil(1.5 max(5, l1))."""
    rate = t - capacity

    def dcon(n: int) -> int:
        return ((alpha - 1) * t * (n - 1)) // 2 + 2

    def v(n: int) -> int:
        return t * (n - 1) + rate

    target = 1 << security_level
    l1 = next((n for n in range(1, 26) if math.comb(v(n) + dcon(n), v(n)) ** 2 > target), 25)
    return math.ceil(1.5 * max(5, l1))


def generate_rescue_parameters(
    fs: FieldSpec,
    rate: int,
    capacity: int = 1,
    security_level: int = 128,
    alpha: int | None = None,
    rounds: int | None = None,
) -> RescueConfig:
    """Deterministic Rescue-Prime parameters for any (field, rate, capacity)."""
    t = rate + capacity
    p = fs.modulus
    if alpha is None:
        alpha = smallest_alpha(p)
    if rounds is None:
        rounds = rescue_round_count(p, t, capacity, security_level, alpha)
    # Grain seeded with (R_F = 2N injection rows, R_P = 0): the 2N x t round
    # constants, then the Cauchy MDS draws.
    lfsr = PoseidonGrainLFSR(False, fs.modulus_bit_size, t, 2 * rounds, 0)
    rc = tuple(
        tuple(lfsr.get_field_elements_rejection_sampling(fs, t)) for _ in range(2 * rounds)
    )
    xs = lfsr.get_field_elements_mod_p(fs, t)
    ys = lfsr.get_field_elements_mod_p(fs, t)
    mds = tuple(tuple(pow((x + y) % p, -1, p) for y in ys) for x in xs)
    return RescueConfig(
        field=fs, rounds=rounds, alpha=alpha, mds=mds, rc=rc, rate=rate, capacity=capacity
    )


@functools.lru_cache(maxsize=None)
def get_default_rescue_parameters(fs: FieldSpec, rate: int) -> RescueConfig:
    """Default Rescue-Prime parameters: the spec's smallest alpha and round
    count at 128-bit security, the per-field sponge capacity."""
    return generate_rescue_parameters(fs, rate, _DEFAULT_CAPACITY.get(fs.name, 1))


# The first row of the MDS matrix of miden-crypto's Rpo256:
# row i is this row rotated right by i, MDS[i][j] = RPO_MDS_ROW[(j - i) % 12].
RPO_MDS_ROW = (7, 23, 8, 26, 13, 10, 9, 7, 6, 22, 21, 8)


@functools.lru_cache(maxsize=None)
def get_rpo_parameters(fs: FieldSpec) -> RescueConfig:
    """Rescue Prime Optimized at Miden's shape: Goldilocks, rate 8,
    capacity 4 (rows [0, 4), the rate rows [4, 12)), alpha 7, 7 rounds, the
    circulant MDS of ``RPO_MDS_ROW``, the MDS before the S-box
    (``mds_first``).  The 14 x 12 round constants are
    ``generate_rescue_parameters``' Grain draws at these sizes (R_F = 14,
    R_P = 0).  Only Goldilocks has the published matrix."""
    if fs.modulus != GOLDILOCKS_FR.modulus:
        raise ValueError(f"Rescue Prime Optimized's MDS is published for Goldilocks; got {fs.name}")
    t = len(RPO_MDS_ROW)
    mds = tuple(tuple(RPO_MDS_ROW[(j - i) % t] for j in range(t)) for i in range(t))
    cfg = generate_rescue_parameters(fs, 8, 4, alpha=7, rounds=7)
    return dataclasses.replace(cfg, mds=mds, mds_first=True)
