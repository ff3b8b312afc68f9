"""Optimized partial-round evaluation (sparse MDS factorization).

Counterpart of ``sponge_tpu/poseidon/optimized.py``.  A partial round applies
the S-box to element 0 only, yet the plain schedule pays a dense t x t MDS
product per round.  The chain of R_P partial rounds factors exactly into

    x += c_1;  x = S(x)
    for r = 2..R_P:   x += č_r;  x = Sp_r·x;  x = S(x)
    x = D·x

where each ``Sp_r`` is sparse (dense first row ``row0``, dense first column
``col0`` below the diagonal, identity elsewhere) and ``D`` is one dense
matrix applied once after the chain.  Cost per round: t + (t-1) products
instead of t^2.  The second CUDA kernel (csrc/poseidon_opt.cu) and its plain
version evaluate this schedule.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

from .config import PoseidonConfig


def _mat_vec(p, m, v):
    return tuple(sum(mij * vj for mij, vj in zip(row, v)) % p for row in m)


def _mat_mul(p, a, b):
    n = len(a)
    return tuple(
        tuple(sum(a[i][k] * b[k][j] for k in range(n)) % p for j in range(n))
        for i in range(n)
    )


def _mat_inv(p, m):
    """Gauss-Jordan inverse over GF(p)."""
    n = len(m)
    aug = [list(row) + [int(i == j) for j in range(n)] for i, row in enumerate(m)]
    for col in range(n):
        piv = next(r for r in range(col, n) if aug[r][col] % p != 0)
        aug[col], aug[piv] = aug[piv], aug[col]
        inv = pow(aug[col][col], -1, p)
        aug[col] = [(x * inv) % p for x in aug[col]]
        for r in range(n):
            if r != col and aug[r][col]:
                f = aug[r][col]
                aug[r] = [(x - f * y) % p for x, y in zip(aug[r], aug[col])]
    return tuple(tuple(row[n:]) for row in aug)


@dataclass(frozen=True)
class SparseFactor:
    """One sparse partial-round matrix."""

    row0: Tuple[int, ...]  # length t
    col0: Tuple[int, ...]  # length t-1 (rows 1..t-1 of column 0)

    def apply(self, p, x):
        out0 = sum(r * v for r, v in zip(self.row0, x)) % p
        rest = tuple((c * x[0] + xi) % p for c, xi in zip(self.col0, x[1:]))
        return (out0,) + rest


@dataclass(frozen=True)
class OptimizedPartialLayers:
    """Precomputed optimized partial-round schedule for one config."""

    c_first: Tuple[int, ...]  # ark row of the first partial round
    constants: Tuple[Tuple[int, ...], ...]  # č_r for r = 2..R_P
    sparse: Tuple[SparseFactor, ...]  # Sp_r for r = 2..R_P
    dense: Tuple[Tuple[int, ...], ...]  # the final dense matrix D


def _factor(p, m):
    """M = M'·M'' with M' = diag(1, M_hat) and M'' sparse."""
    t = len(m)
    m_hat = tuple(tuple(m[i][j] for j in range(1, t)) for i in range(1, t))
    w = tuple(m[i][0] for i in range(1, t))
    w_hat = _mat_vec(p, _mat_inv(p, m_hat), w)
    m_prime = tuple(
        tuple(
            (1 if i == j == 0 else (m_hat[i - 1][j - 1] if i > 0 and j > 0 else 0))
            for j in range(t)
        )
        for i in range(t)
    )
    return m_prime, SparseFactor(row0=tuple(m[0]), col0=w_hat)


@functools.lru_cache(maxsize=None)
def optimized_partial_layers(cfg: PoseidonConfig) -> OptimizedPartialLayers:
    """Derive the sparse factorization and transformed constants for ``cfg``."""
    p = cfg.field.modulus
    k = cfg.partial_rounds
    half = cfg.full_rounds // 2
    m = tuple(tuple(row) for row in cfg.mds)
    if k < 2:
        raise ValueError("optimized schedule needs >= 2 partial rounds")

    m_inv = _mat_inv(p, m)
    ark = [tuple(cfg.ark[half + r]) for r in range(k)]
    c_hat = [_mat_vec(p, m_inv, ark[r]) for r in range(1, k)]

    # Factor round matrices left to right; each popped M' crosses the next
    # block's constant add and merges into the next round's matrix.
    mats = [m] * k
    sparse = []
    for i in range(k - 1):
        m_prime, sp = _factor(p, mats[i])
        sparse.append(sp)
        if i + 1 <= k - 2:
            c_hat[i + 1] = _mat_vec(p, _mat_inv(p, m_prime), c_hat[i + 1])
        mats[i + 1] = _mat_mul(p, mats[i + 1], m_prime)

    return OptimizedPartialLayers(
        c_first=ark[0],
        constants=tuple(c_hat),
        sparse=tuple(sparse),
        dense=mats[k - 1],
    )


def eval_partial_chain_optimized(cfg: PoseidonConfig, state) -> tuple:
    """Scalar evaluation of the optimized partial chain on a full state tuple."""
    p = cfg.field.modulus
    layers = optimized_partial_layers(cfg)

    def sbox0(x):
        return (pow(x[0], cfg.alpha, p),) + tuple(x[1:])

    x = sbox0(tuple((xi + ci) % p for xi, ci in zip(state, layers.c_first)))
    for c, sp in zip(layers.constants, layers.sparse):
        x = tuple((xi + ci) % p for xi, ci in zip(x, c))
        x = sbox0(sp.apply(p, x))
    return _mat_vec(p, layers.dense, x)
