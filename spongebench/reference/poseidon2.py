"""Plain Poseidon2 over Python ints, with Plonky3's padding-free sponge and
truncated-permutation compression: the benchmark's reference for the
configurations whose family is ``poseidon2``.

Written from the Poseidon2 paper (ePrint 2023/323: the round schedule of
§3, the matrices of §5) and Plonky3's ``PaddingFreeSponge`` and
``TruncatedPermutation``, not from the program under test, which it never
imports.  The constants come from Poseidon's Grain LFSR (``poseidon.py``'s
``GrainLFSR``, clocked one bit at a time) seeded with (bits of p, t, R_F,
R_P), drawn by rejection below p in this order: R_F rows of t external
round constants, R_P internal round constants (one each), then the
diagonal mu of the internal matrix, t at a time, until a draw is pairwise
distinct, holds neither 0 nor 1 and gives an invertible
M_I = J + diag(mu - 1).  The external matrix is built from the paper's
M4 (§5.1): M4 itself at t = 4, and at t = 4k the block matrix with 2 M4 on
the diagonal and M4 off it.

The permutation follows the paper's schedule: M_E, R_F/2 external rounds
(constants, every S-box, M_E), R_P internal rounds (constant and S-box on
element 0, M_I), R_F/2 external rounds.  Both modes put the rate in front
of the capacity.
"""

from __future__ import annotations

from dataclasses import dataclass

from .poseidon import GrainLFSR

# ePrint 2023/323 §5.1.
M4 = (
    (5, 7, 1, 3),
    (4, 6, 1, 1),
    (1, 3, 5, 7),
    (1, 1, 4, 6),
)


def external_matrix(t: int) -> tuple:
    """M_E at width t, a multiple of 4."""
    if t < 4 or t % 4:
        raise ValueError(f"the external matrix is built from M4 at t = 4k; got t={t}")
    return tuple(tuple(M4[r % 4][c % 4] * (2 if r // 4 == c // 4 and t > 4 else 1) for c in range(t))
                 for r in range(t))


def _invertible(mat: list, p: int) -> bool:
    """Whether ``mat`` is invertible mod p, by Gaussian elimination."""
    m = [list(row) for row in mat]
    n = len(m)
    for col in range(n):
        pivot = next((r for r in range(col, n) if m[r][col] % p), None)
        if pivot is None:
            return False
        m[col], m[pivot] = m[pivot], m[col]
        inv = pow(m[col][col], -1, p)
        for r in range(col + 1, n):
            f = m[r][col] * inv % p
            m[r] = [(a - f * b) % p for a, b in zip(m[r], m[col])]
    return True


@dataclass(frozen=True)
class Poseidon2:
    """One Poseidon2 parameter set: the field, the width and the
    permutation's constants, worked out from the Grain LFSR."""

    p: int
    t: int
    alpha: int
    full_rounds: int
    partial_rounds: int
    external_rc: tuple  # (R_F, t)
    internal_rc: tuple  # (R_P,)
    mat_e: tuple  # (t, t)
    diag: tuple  # (t,): mu, the diagonal of M_I

    @classmethod
    def generate(cls, p: int, t: int, alpha: int, full_rounds: int, partial_rounds: int) -> "Poseidon2":
        lfsr = GrainLFSR(p.bit_length(), t, full_rounds, partial_rounds)
        external_rc = tuple(tuple(lfsr.rejection_sampled(p, t)) for _ in range(full_rounds))
        internal_rc = tuple(lfsr.rejection_sampled(p, 1)[0] for _ in range(partial_rounds))
        while True:
            diag = tuple(lfsr.rejection_sampled(p, t))
            if len(set(diag)) < t or 0 in diag or 1 in diag:
                continue
            if _invertible([[diag[i] if i == j else 1 for j in range(t)] for i in range(t)], p):
                break
        return cls(p, t, alpha, full_rounds, partial_rounds, external_rc, internal_rc, external_matrix(t), diag)

    def _external(self, state: list) -> list:
        """M_E . state, as §5.1 computes it: M4 on each block of four,
        then each block plus the sum of all blocks (the dense ``mat_e``)."""
        blocks = [[sum(m * x for m, x in zip(row, state[i : i + 4])) for row in M4]
                  for i in range(0, self.t, 4)]
        if self.t == 4:
            return [v % self.p for v in blocks[0]]
        sums = [sum(col) for col in zip(*blocks)]
        return [(v + s) % self.p for b in blocks for v, s in zip(b, sums)]

    def _internal(self, state: list) -> list:
        total = sum(state)
        return [(total + (mu - 1) * x) % self.p for mu, x in zip(self.diag, state)]

    def permute(self, state: list) -> list:
        p, a = self.p, self.alpha
        if len(state) != self.t:
            raise ValueError(f"a state of width {self.t}; got {len(state)}")
        half = self.full_rounds // 2

        def external_round(state, consts):
            return self._external([pow((x + c) % p, a, p) for x, c in zip(state, consts)])

        state = self._external(list(state))
        for consts in self.external_rc[:half]:
            state = external_round(state, consts)
        for c in self.internal_rc:
            state[0] = pow((state[0] + c) % p, a, p)
            state = self._internal(state)
        for consts in self.external_rc[half:]:
            state = external_round(state, consts)
        return state


def padding_free_hash(params: Poseidon2, elems, rate: int, outputs: int) -> list:
    """Plonky3's ``PaddingFreeSponge``: a zero state; each chunk of up to
    ``rate`` elements overwrites the state's first elements and the state
    is permuted (no padding, so no permutation follows a last full chunk);
    the first ``outputs`` elements."""
    elems = list(elems)
    state = [0] * params.t
    for lo in range(0, len(elems), rate):
        chunk = elems[lo : lo + rate]
        state = params.permute(chunk + state[len(chunk):])
    return state[:outputs]


def truncated_compress(params: Poseidon2, left, right) -> list:
    """Plonky3's ``TruncatedPermutation``: the first d elements of the
    permuted left ‖ right, 2d = t."""
    if 2 * len(left) != params.t or len(right) != len(left):
        raise ValueError(f"two digests of t/2 = {params.t // 2} elements; got {len(left)} and {len(right)}")
    return params.permute(list(left) + list(right))[: len(left)]
