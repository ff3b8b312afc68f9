"""Plain Poseidon duplex sponge over Python ints: the benchmark's reference.

Written from arkworks-rs/sponge v0.3.0 (``src/poseidon/grain_lfsr.rs``,
``src/poseidon/mod.rs``, ``src/poseidon/traits.rs``), not from the program
under test, which it never imports.  The Grain LFSR is clocked one bit at a
time, as the crate clocks it; the permutation is the dense one (every round
adds its constants, applies its S-boxes and the whole MDS matrix); the
sponge keeps the crate's duplex state machine, quirks included: absorbing
adds into the rate part of the ``capacity || rate`` state, and a squeeze
that crosses the rate skips its permutation when what is left to squeeze
equals the rate.

The one generalisation is the capacity: the crate seeds the LFSR with
t = rate + 1; a config here may state a larger capacity (the small fields),
and t = rate + capacity seeds it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


class GrainLFSR:
    """The crate's 80-bit Grain LFSR (``PoseidonGrainLFSR``)."""

    def __init__(self, prime_bits: int, t: int, full_rounds: int, partial_rounds: int):
        state = [False] * 80
        state[1] = True  # b0, b1: a prime field
        # b2..b5: the S-box is x^alpha, not an inverse: all zero

        def put(lo: int, hi: int, value: int) -> None:
            for i in range(hi, lo - 1, -1):
                state[i] = bool(value & 1)
                value >>= 1

        put(6, 17, prime_bits)
        put(18, 29, t)
        put(30, 39, full_rounds)
        put(40, 49, partial_rounds)
        for i in range(50, 80):
            state[i] = True
        self.state, self.head, self.prime_bits = state, 0, prime_bits
        for _ in range(160):
            self._update()

    def _update(self) -> bool:
        s, h = self.state, self.head
        bit = s[(h + 62) % 80] ^ s[(h + 51) % 80] ^ s[(h + 38) % 80] ^ s[(h + 23) % 80] ^ s[(h + 13) % 80] ^ s[h]
        s[h] = bit
        self.head = (h + 1) % 80
        return bit

    def bits(self, n: int) -> list:
        out = []
        for _ in range(n):
            first = self._update()
            while not first:
                self._update()
                first = self._update()
            out.append(self._update())
        return out

    def _next_int(self) -> int:
        value = 0
        for bit in self.bits(self.prime_bits):  # most significant bit first
            value = (value << 1) | int(bit)
        return value

    def rejection_sampled(self, p: int, n: int) -> list:
        out = []
        while len(out) < n:
            v = self._next_int()
            if v < p:
                out.append(v)
        return out

    def mod_p(self, p: int, n: int) -> list:
        return [self._next_int() % p for _ in range(n)]


@dataclass(frozen=True)
class Poseidon:
    """One Poseidon parameter set: the field, the sponge geometry and the
    permutation's constants, worked out from the Grain LFSR."""

    p: int
    rate: int
    capacity: int
    alpha: int
    full_rounds: int
    partial_rounds: int
    ark: tuple
    mds: tuple

    @property
    def t(self) -> int:
        return self.rate + self.capacity

    @classmethod
    def generate(cls, p: int, rate: int, capacity: int, alpha: int, full_rounds: int,
                 partial_rounds: int) -> "Poseidon":
        """``find_poseidon_ark_and_mds``: round constants by rejection
        sampling, then the Cauchy matrix mds[i][j] = 1 / (x_i + y_j)."""
        t = rate + capacity
        lfsr = GrainLFSR(p.bit_length(), t, full_rounds, partial_rounds)
        ark = tuple(tuple(lfsr.rejection_sampled(p, t)) for _ in range(full_rounds + partial_rounds))
        xs, ys = lfsr.mod_p(p, t), lfsr.mod_p(p, t)
        mds = tuple(tuple(pow((x + y) % p, -1, p) for y in ys) for x in xs)
        return cls(p, rate, capacity, alpha, full_rounds, partial_rounds, ark, mds)

    def permute(self, state: list) -> list:
        p, a, mds = self.p, self.alpha, self.mds
        half = self.full_rounds // 2
        for r, consts in enumerate(self.ark):
            state = [(x + c) % p for x, c in zip(state, consts)]
            if r < half or r >= half + self.partial_rounds:
                state = [pow(x, a, p) for x in state]
            else:
                state[0] = pow(state[0], a, p)
            state = [math.sumprod(row, state) % p for row in mds]
        return state


class Sponge:
    """The crate's ``PoseidonSponge`` over native field elements."""

    def __init__(self, params: Poseidon):
        self.params = params
        self.state = [0] * params.t
        self.absorbing, self.index = True, 0

    def _permute(self) -> None:
        self.state = self.params.permute(self.state)

    def absorb(self, elems) -> None:
        elems = list(elems)
        if not elems:
            return
        if self.absorbing and self.index < self.params.rate:
            start = self.index
        else:
            self._permute()
            start = 0
        rate, cap, p = self.params.rate, self.params.capacity, self.params.p
        while True:
            if start + len(elems) <= rate:
                for i, e in enumerate(elems):
                    self.state[cap + start + i] = (self.state[cap + start + i] + e) % p
                self.absorbing, self.index = True, start + len(elems)
                return
            n = rate - start
            for i, e in enumerate(elems[:n]):
                self.state[cap + start + i] = (self.state[cap + start + i] + e) % p
            self._permute()
            elems, start = elems[n:], 0

    def squeeze(self, n: int) -> list:
        if n == 0:
            return []
        if self.absorbing or self.index == self.params.rate:
            self._permute()
            start = 0
        else:
            start = self.index
        rate, cap = self.params.rate, self.params.capacity
        out = []
        while True:
            if start + n - len(out) <= rate:
                k = n - len(out)
                out += self.state[cap + start : cap + start + k]
                self.absorbing, self.index = False, start + k
                return out
            k = rate - start
            out += self.state[cap + start : cap + rate]
            if n - (len(out) - k) != rate:  # the crate's quirk
                self._permute()
            start = 0


def hash_elements(params: Poseidon, elems, outputs: int) -> list:
    """A fresh sponge absorbs ``elems`` and squeezes ``outputs`` elements."""
    s = Sponge(params)
    s.absorb(elems)
    return s.squeeze(outputs)


def compress(params: Poseidon, left, right) -> list:
    """The 2-to-1 node of a Merkle tree over d-element digests: a fresh
    sponge absorbs left || right and squeezes d elements."""
    return hash_elements(params, list(left) + list(right), len(left))
