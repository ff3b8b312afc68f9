"""Plain Rescue over Python ints, in either round order, with Miden's
length-tagged overwrite sponge and 2-to-1 merge: the benchmark's reference
for the configurations whose family is ``rescue``.

Written from the Rescue-Prime paper (ePrint 2020/1143: each half-round the
S-box, then the MDS matrix and the round constants) and Rescue Prime
Optimized's (ePrint 2022/1577, as miden-crypto's ``Rpo256`` runs it in
``src/hash/rescue/rpo/mod.rs``: each half-round the MDS matrix and the
round constants, then the S-box, so a round is ``apply_mds``, ``ARK1[r]``,
x^alpha, ``apply_mds``, ``ARK2[r]``, x^(1/alpha)), and Miden's
``Rpo256::hash_elements`` and ``Rpo256::merge``; not from the program
under test, which it never imports.  The MDS matrix and the order come
from the configuration: a circulant given by its first row (row i is that
row rotated right by i, so ``MDS[i][j] = row[(j - i) mod t]``).

Departures from the published description:

* the round constants are not Miden's ARK1/ARK2 tables (no published
  vectors in the repo) but draws of Poseidon's Grain LFSR
  (``poseidon.py``'s ``GrainLFSR``, clocked one bit at a time) seeded with
  (bits of p, t, R_F = 2N, R_P = 0), rejection-sampled below p, 2N rows of
  t in half-round order: rows 2r and 2r + 1 stand for ``ARK1[r]`` and
  ``ARK2[r]``.  The shapes are Miden's: N = 7 rounds of two t-element rows.

Both modes put the capacity in front: rows [0, capacity) of the state,
the rate after it, the digest the rate's first rows.
"""

from __future__ import annotations

from dataclasses import dataclass

from .poseidon import GrainLFSR


def circulant(row) -> tuple:
    """The circulant matrix whose row i is ``row`` rotated right by i."""
    t = len(row)
    return tuple(tuple(row[(j - i) % t] for j in range(t)) for i in range(t))


@dataclass(frozen=True)
class Rescue:
    """One Rescue parameter set: the field, the width, the S-box exponent
    and its inverse, the round order, the MDS matrix and the round
    constants (two rows a round)."""

    p: int
    t: int
    alpha: int
    rounds: int
    mds_first: bool
    mds: tuple  # (t, t)
    rc: tuple  # (2 N, t)

    @classmethod
    def generate(cls, p: int, t: int, alpha: int, rounds: int, mds_row, mds_first: bool) -> "Rescue":
        if len(mds_row) != t:
            raise ValueError(f"an MDS row of {t} entries; got {len(mds_row)}")
        lfsr = GrainLFSR(p.bit_length(), t, 2 * rounds, 0)
        rc = tuple(tuple(lfsr.rejection_sampled(p, t)) for _ in range(2 * rounds))
        return cls(p, t, alpha, rounds, bool(mds_first), circulant(tuple(mds_row)), rc)

    @property
    def inv_alpha(self) -> int:
        return pow(self.alpha, -1, self.p - 1)

    def permute(self, state: list) -> list:
        p = self.p
        if len(state) != self.t:
            raise ValueError(f"a state of width {self.t}; got {len(state)}")
        state = [x % p for x in state]
        for h, consts in enumerate(self.rc):
            e = self.inv_alpha if h % 2 else self.alpha
            if not self.mds_first:
                state = [pow(x, e, p) for x in state]
            state = [(sum(m * x for m, x in zip(row, state)) + c) % p for row, c in zip(self.mds, consts)]
            if self.mds_first:
                state = [pow(x, e, p) for x in state]
        return state


def hash_elements(params: Rescue, elems, rate: int, capacity: int, outputs: int) -> list:
    """Miden's ``hash_elements``: a zero state with capacity element 0 set
    to the input's length mod the rate; each chunk of ``rate`` elements
    written over the rate and the state permuted, a last partial chunk
    padded with zeros (so a length that is a multiple of the rate takes no
    further permutation); the rate's first ``outputs`` elements."""
    if capacity + rate != params.t:
        raise ValueError(f"rate + capacity must be the width {params.t}")
    elems = list(elems)
    state = [0] * params.t
    state[0] = len(elems) % rate
    for lo in range(0, len(elems), rate):
        chunk = elems[lo : lo + rate]
        state = params.permute(state[:capacity] + chunk + [0] * (rate - len(chunk)))
    return state[capacity : capacity + outputs]


def merge(params: Rescue, left, right, capacity: int) -> list:
    """Miden's ``merge``: the two digests written over the rate of a zero
    state (no length tag), one permutation, the rate's first d elements."""
    d = len(left)
    if len(right) != d or capacity + 2 * d > params.t:
        raise ValueError(f"two digests of one size that fit the rate; got {len(left)} and {len(right)}")
    state = [0] * capacity + list(left) + list(right)
    return params.permute(state + [0] * (params.t - len(state)))[capacity : capacity + d]
