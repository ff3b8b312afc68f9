"""Deterministic Poseidon2 parameter generation.

Counterpart of ``sponge_tpu/poseidon2/params.py``, in pure Python.  Matrices
follow ePrint 2023/323 §5:

* t = 2:  M_E = [[2,1],[1,2]],              M_I diag mu = (2, 3)
* t = 3:  M_E = circ(2,1,1),                M_I diag mu = (2, 2, 3)
* t = 4:  M_E = M4 (the paper's 4x4 matrix),
* t = 4k, k >= 2:  M_E = block-circulant with diagonal blocks 2*M4 and
  off-diagonal blocks M4,
* t >= 4: M_I = J + diag(mu - 1) with ``mu`` drawn from the Grain LFSR
  (rejection-sampled below p) until M_I is invertible and the diagonal
  entries are pairwise distinct and not 0 or 1.

Round constants come from the Poseidon Grain LFSR seeded with
(sbox_inverse=False, prime_bits, t, R_F, R_P), in schedule order: the R_F
external rows, then the R_P internal scalars, then the diagonal draws.  These
are a self-consistent deterministic instance (no published cross-vectors);
the scalar oracle is the ground truth.
"""

from __future__ import annotations

import functools

from ..fields import FieldSpec
from ..poseidon.params import _DEFAULT_CAPACITY, _DEFAULT_TABLES, PoseidonGrainLFSR
from .config import Poseidon2Config

# The paper's 4x4 building block (ePrint 2023/323 §5.1).
_M4 = (
    (5, 7, 1, 3),
    (4, 6, 1, 1),
    (1, 3, 5, 7),
    (1, 1, 4, 6),
)


def external_matrix(t: int) -> tuple:
    """The small-integer external matrix M_E for state width ``t``."""
    if t == 2:
        return ((2, 1), (1, 2))
    if t == 3:
        return ((2, 1, 1), (1, 2, 1), (1, 1, 2))
    if t == 4:
        return _M4
    if t % 4 == 0:
        k = t // 4
        return tuple(
            tuple((2 if bi == bj else 1) * v for bj in range(k) for v in _M4[r])
            for bi in range(k)
            for r in range(4)
        )
    raise ValueError(
        f"Poseidon2 external matrix defined for t in {{2, 3}} or t % 4 == 0; got t={t}"
    )


def _det_mod_p(mat, p: int) -> int:
    """Determinant mod the prime p by Gaussian elimination."""
    m = [row[:] for row in mat]
    n = len(m)
    det = 1
    for col in range(n):
        pivot = next((r for r in range(col, n) if m[r][col] % p != 0), None)
        if pivot is None:
            return 0
        if pivot != col:
            m[col], m[pivot] = m[pivot], m[col]
            det = -det % p
        det = det * m[col][col] % p
        inv = pow(m[col][col], -1, p)
        for r in range(col + 1, n):
            f = m[r][col] * inv % p
            for c in range(col, n):
                m[r][c] = (m[r][c] - f * m[col][c]) % p
    return det


def internal_diag(t: int, fs: FieldSpec, lfsr: PoseidonGrainLFSR | None) -> tuple:
    """Diagonal ``mu`` of M_I: the paper's fixed values at t = 2, 3; for
    t >= 4 Grain draws until M_I is invertible with pairwise distinct
    entries not in {0, 1}."""
    if t == 2:
        return (2, 3)
    if t == 3:
        return (2, 2, 3)
    p = fs.modulus
    while True:
        diag = tuple(lfsr.get_field_elements_rejection_sampling(fs, t))
        if len(set(diag)) != t or any(d in (0, 1) for d in diag):
            continue
        dense = [[diag[i] % p if i == j else 1 for j in range(t)] for i in range(t)]
        if _det_mod_p(dense, p) != 0:
            return diag


def generate_poseidon2_parameters(
    fs: FieldSpec,
    rate: int,
    alpha: int,
    full_rounds: int,
    partial_rounds: int,
    capacity: int = 1,
) -> Poseidon2Config:
    """Deterministic Poseidon2 parameters for any supported width."""
    t = rate + capacity
    mat_e = external_matrix(t)
    lfsr = PoseidonGrainLFSR(False, fs.modulus_bit_size, t, full_rounds, partial_rounds)
    external_rc = tuple(
        tuple(lfsr.get_field_elements_rejection_sampling(fs, t)) for _ in range(full_rounds)
    )
    internal_rc = tuple(
        lfsr.get_field_elements_rejection_sampling(fs, 1)[0] for _ in range(partial_rounds)
    )
    return Poseidon2Config(
        field=fs,
        full_rounds=full_rounds,
        partial_rounds=partial_rounds,
        alpha=alpha,
        external_rc=external_rc,
        internal_rc=internal_rc,
        mat_e=mat_e,
        mat_i_diag=internal_diag(t, fs, lfsr),
        rate=rate,
        capacity=capacity,
    )


@functools.lru_cache(maxsize=None)
def get_default_poseidon2_parameters(
    fs: FieldSpec, rate: int, optimized_for_weights: bool = False
) -> Poseidon2Config:
    """Default Poseidon2 parameters from the Poseidon round-count tables
    (rate, alpha, R_F, R_P) and the per-field capacity.  Only widths with a
    defined external matrix (t in {2, 3} or t % 4 == 0) exist."""
    table = _DEFAULT_TABLES[fs.name][bool(optimized_for_weights)]
    capacity = _DEFAULT_CAPACITY.get(fs.name, 1)
    for rate_, alpha, full_rounds, partial_rounds, _skip in table:
        if rate_ == rate:
            return generate_poseidon2_parameters(
                fs, rate, alpha, full_rounds, partial_rounds, capacity
            )
    raise ValueError(f"no default Poseidon2 parameters for rate={rate}")
