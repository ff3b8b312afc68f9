"""The least time a Poseidon permutation can take on the card, and the
card's peaks it rests on.

The count is the sparse schedule's (the partial rounds factored into one
dense matrix and t-1 scalings a round), keyed by the Poseidon config and not
by the kernel that runs it: an element is counted in the fewest 32-bit words
that hold it (one word below 2^31, two at Goldilocks, 24-bit limbs at the
other fields), so any body or kernel that computes the same permutation is
held to the same work.  Wide products are 32 x 32 -> 64-bit multiply-adds
(IMAD.WIDE.U32), narrow ones 32-bit (IMAD); both issue on one integer pipe,
so their times add.
"""

from __future__ import annotations

from dataclasses import dataclass

GOLDILOCKS_P = (1 << 64) - (1 << 32) + 1


@dataclass(frozen=True)
class Peaks:
    sms: int
    clock_hz: float  # the SM clock's maximum
    narrow_per_clock: int  # 32-bit multiply-adds per clock per SM
    wide_per_clock: int  # widening ones
    hbm_bytes_per_s: float

    @property
    def narrow_per_s(self) -> float:
        return self.sms * self.narrow_per_clock * self.clock_hz

    @property
    def wide_per_s(self) -> float:
        return self.sms * self.wide_per_clock * self.clock_hz


# The card's integer peaks: 64 IMAD per clock per SM (CUDA C++ Programming
# Guide, arithmetic instruction throughput, compute capability 9.0), a
# widening IMAD issuing as two; 132 SMs at 1,980 MHz; 3.35 TB/s of HBM3.
PEAKS = {
    "NVIDIA H100 80GB HBM3": Peaks(132, 1.98e9, 64, 32, 3.35e12),
}


def chain_products(e: int, sq: int, mul: int) -> int:
    """Fewest products of x^e over left-to-right sliding-window chains
    (windows of 1 to 8 bits), a squaring costing ``sq`` and a multiply
    ``mul``: the table x^2, x^3, x^5, ... up to the largest window used,
    then one squaring per bit after the first window and one multiply per
    further window."""
    bits, best = bin(e)[2:], None
    for w in range(1, 9):
        n_sq = n_mul = top = 0
        i, first = 0, True
        while i < len(bits):
            if bits[i] == "0":
                n_sq, i = n_sq + 1, i + 1
                continue
            j = min(i + w, len(bits))
            while bits[j - 1] == "0":
                j -= 1
            top = max(top, int(bits[i:j], 2))
            if not first:
                n_sq, n_mul = n_sq + j - i, n_mul + 1
            first, i = False, j
        if top > 1:
            n_sq, n_mul = n_sq + 1, n_mul + (top - 1) // 2
        cost = n_sq * sq + n_mul * mul
        best = cost if best is None else min(best, cost)
    return best


def permutation_products(p: int, t: int, alpha: int, full_rounds: int, partial_rounds: int) -> tuple:
    """(wide, narrow) multiply-adds of one Poseidon permutation on the sparse
    schedule: the full rounds' S-boxes and dense rows, the first partial
    round's S-box, then per further partial round one S-box, one dense row
    and t-1 scalings, and the t rows of the matrix that precedes the partial
    rounds.  On limbs a product is 2 L^2 limb products, a squaring
    L (L + 1) / 2 + L^2, a lazily summed row (t + 1) L^2; one word: a product
    2 wide and 1 narrow, a row t + 1 wide and 1 narrow; two words
    (Goldilocks, plain form): a product 4, a squaring 3, a row 4 t, the
    reduction mod p none."""
    if p < 1 << 31:
        mm = (2, 1)
        row = (t + 1, 1)
        chain = chain_products(alpha, 1, 1)
        sb = (2 * chain, chain)
    elif p == GOLDILOCKS_P:
        mm = (4, 0)
        row = (4 * t, 0)
        sb = (chain_products(alpha, 3, 4), 0)
    else:
        L = -(-(p.bit_length() + 4) // 24)
        mm = (2 * L * L, 0)
        row = ((t + 1) * L * L, 0)
        sb = (chain_products(alpha, L * (L + 1) // 2 + L * L, mm[0]), 0)
    terms = (
        (full_rounds * t, sb),
        (full_rounds * t, row),
        (1, sb),
        (partial_rounds - 1, row),
        ((partial_rounds - 1) * (t - 1), mm),
        (partial_rounds - 1, sb),
        (t, row),
    )
    return sum(n * c[0] for n, c in terms), sum(n * c[1] for n, c in terms)


def poseidon_bound_s(peaks: Peaks, p: int, t: int, alpha: int, full_rounds: int,
                     partial_rounds: int, permutations: int) -> float:
    """Least seconds of ``permutations`` Poseidon permutations: their
    products at the integer peaks, or their states read and written once at
    the HBM rate, whichever is longer."""
    wide, narrow = permutation_products(p, t, alpha, full_rounds, partial_rounds)
    ops_s = permutations * (wide / peaks.wide_per_s + narrow / peaks.narrow_per_s)
    words = -(-(p.bit_length() + 4) // 24)  # the plane's limbs per element
    bytes_s = permutations * 2 * t * words * 4 / peaks.hbm_bytes_per_s
    return max(ops_s, bytes_s)
