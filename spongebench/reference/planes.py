"""The program's element layout, as the benchmark hands inputs over and
reads outputs back: a batch of field elements is an int32 plane of L limbs
of 24 bits (little-endian, batch innermost) holding the Montgomery form
x * R mod p, R = 2^(24 L), L = ceil((bits(p) + 4) / 24).  A plane the
program returns is canonical: every limb below 2^24 and the value below p.
"""

from __future__ import annotations

import numpy as np

LIMB_BITS = 24


def nlimbs(p: int) -> int:
    return -(-(p.bit_length() + 4) // LIMB_BITS)


def decode(p: int, limbs) -> list:
    """(L, K) limb array -> K field elements, or None for a column that is
    not canonical (a limb outside [0, 2^24) or a value not below p)."""
    limbs = np.asarray(limbs, dtype=np.int64)
    L = nlimbs(p)
    if limbs.shape[0] != L:
        raise ValueError(f"expected {L} limbs, got shape {limbs.shape}")
    r_inv = pow(1 << (LIMB_BITS * L), -1, p)
    out = []
    for col in limbs.T.tolist():
        if any(v < 0 or v >> LIMB_BITS for v in col):
            out.append(None)
            continue
        m = 0
        for v in reversed(col):
            m = (m << LIMB_BITS) | v
        out.append(m * r_inv % p if m < p else None)
    return out


def encode(p: int, values) -> np.ndarray:
    """Field elements -> (L, K) int32 canonical Montgomery limb array."""
    L = nlimbs(p)
    r = 1 << (LIMB_BITS * L)
    cols = []
    for v in values:
        m = v % p * r % p
        cols.append([(m >> (LIMB_BITS * i)) & ((1 << LIMB_BITS) - 1) for i in range(L)])
    return np.asarray(cols, dtype=np.int32).reshape(-1, L).T.copy()


def top_limb_bound(p: int) -> int:
    """A top limb below this keeps any value of the plane below p."""
    return p >> (LIMB_BITS * (nlimbs(p) - 1))
