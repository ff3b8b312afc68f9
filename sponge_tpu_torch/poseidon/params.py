"""Deterministic Poseidon parameter generation (Grain LFSR + Cauchy MDS).

Counterpart of ``sponge_tpu/poseidon/params.py``: the same Grain LFSR, the
same default tables and the same reference test fixture, in pure Python, so
the port computes its parameters on a machine without JAX.  Equality with the
JAX package's parameters is tested on the CPU (tests/test_torch_fields.py).
"""

from __future__ import annotations

import functools
import json
import pathlib

import numpy as np

from ..fields import BLS12_381_FR, FieldSpec
from .config import PoseidonConfig


class PoseidonGrainLFSR:
    """80-bit Grain LFSR seeded from the field/sponge descriptor.

    Seed: b0-b1 field type, b2-b5 S-box kind, b6-17 prime bits, b18-29 state
    width t, b30-39 R_F, b40-49 R_P, b50-79 ones; taps {62, 51, 38, 23, 13, 0};
    160 warm-up clocks; the output filter drops bit pairs whose first bit is 0
    and emits the second bit otherwise.  The register is clocked 18 bits at a
    time (the nearest tap is 80 - 62 = 18 clocks ahead, so one window fixes
    the next 18 bits), and the filter runs over arrays of clocked bits.
    """

    _TAPS = (0, 13, 23, 38, 51, 62)
    _CHUNK = 80 - 62

    def __init__(
        self,
        is_sbox_an_inverse: bool,
        prime_num_bits: int,
        state_len: int,
        num_full_rounds: int,
        num_partial_rounds: int,
    ):
        self.prime_num_bits = prime_num_bits
        bits = [False] * 80  # bits[i] is the state bit at head-relative offset i
        bits[1] = True
        bits[5] = bool(is_sbox_an_inverse)

        def fill(lo: int, hi: int, value: int):
            for i in range(hi, lo - 1, -1):
                bits[i] = (value & 1) == 1
                value >>= 1

        fill(6, 17, prime_num_bits)
        fill(18, 29, state_len)
        fill(30, 39, num_full_rounds)
        fill(40, 49, num_partial_rounds)
        for i in range(50, 80):
            bits[i] = True
        # Writing at the head and advancing it is "shift right, insert the new
        # bit at offset 79" on this packed window.
        self.window = sum(1 << i for i, b in enumerate(bits) if b)
        self._raw = self._clock(160)[160:]  # clocked bits not yet filtered, from a pair boundary

    def _clock(self, n: int) -> np.ndarray:
        """At least ``n`` next clocked bits (whole chunks of 18), in order:
        bit j of a chunk is the XOR of the window's bits j + tap, and the
        window then shifts by 18 with the chunk at its top (offsets 62-79)."""
        w, mask, chunks = self.window, (1 << self._CHUNK) - 1, []
        for _ in range(-(-n // self._CHUNK)):
            c = (w ^ (w >> 13) ^ (w >> 23) ^ (w >> 38) ^ (w >> 51) ^ (w >> 62)) & mask
            w = (w >> self._CHUNK) | (c << (80 - self._CHUNK))
            chunks.append(c)
        self.window = w
        shifts = np.arange(self._CHUNK, dtype=np.uint32)
        return ((np.array(chunks, dtype=np.uint32)[:, None] >> shifts) & 1).astype(np.uint8).ravel()

    def _bits(self, num_bits: int) -> np.ndarray:
        """The next ``num_bits`` output bits (uint8 array)."""
        raw = self._raw
        while True:
            pairs = raw[: len(raw) // 2 * 2].reshape(-1, 2)
            kept = np.flatnonzero(pairs[:, 0])
            if len(kept) >= num_bits:
                break
            raw = np.concatenate([raw, self._clock(4 * (num_bits - len(kept)) + 64)])
        self._raw = raw[2 * (int(kept[num_bits - 1]) + 1) if num_bits else 0 :]
        return pairs[kept[:num_bits], 1]

    def get_bits(self, num_bits: int) -> list:
        return self._bits(num_bits).tolist()

    def _next_int_msb(self) -> int:
        bits = self._bits(self.prime_num_bits)
        pad = np.zeros(-len(bits) % 8, dtype=np.uint8)
        return int.from_bytes(np.packbits(np.concatenate([pad, bits])).tobytes(), "big")

    def get_field_elements_rejection_sampling(self, fs: FieldSpec, num_elems: int):
        """One rejection-sampled element below p per draw."""
        if fs.modulus_bit_size != self.prime_num_bits:
            raise ValueError("LFSR was seeded for another prime size")
        res = []
        for _ in range(num_elems):
            while True:
                candidate = self._next_int_msb()
                if candidate < fs.modulus:
                    res.append(candidate)
                    break
        return res

    def get_field_elements_mod_p(self, fs: FieldSpec, num_elems: int):
        """Draw prime_num_bits bits and reduce mod p."""
        if fs.modulus_bit_size != self.prime_num_bits:
            raise ValueError("LFSR was seeded for another prime size")
        return [self._next_int_msb() % fs.modulus for _ in range(num_elems)]


def find_poseidon_ark_and_mds(
    fs: FieldSpec,
    rate: int,
    full_rounds: int,
    partial_rounds: int,
    skip_matrices: int,
    capacity: int = 1,
):
    """ARK constants by rejection sampling and the Cauchy MDS matrix
    ``mds[i][j] = (x_i + y_j)^{-1}``."""
    t = rate + capacity
    lfsr = PoseidonGrainLFSR(False, fs.modulus_bit_size, t, full_rounds, partial_rounds)
    ark = tuple(
        tuple(lfsr.get_field_elements_rejection_sampling(fs, t))
        for _ in range(full_rounds + partial_rounds)
    )
    for _ in range(skip_matrices):
        lfsr.get_field_elements_mod_p(fs, 2 * t)
    xs = lfsr.get_field_elements_mod_p(fs, t)
    ys = lfsr.get_field_elements_mod_p(fs, t)
    p = fs.modulus
    mds = tuple(tuple(pow((x + y) % p, -1, p) for y in ys) for x in xs)
    return ark, mds


# Default tables: (rate, alpha, full_rounds, partial_rounds, skip_matrices).
_BLS12_381_FR_CONSTRAINTS = (
    (2, 17, 8, 31, 0),
    (3, 5, 8, 56, 0),
    (4, 5, 8, 56, 0),
    (5, 5, 8, 57, 0),
    (6, 5, 8, 57, 0),
    (7, 5, 8, 57, 0),
    (8, 5, 8, 57, 0),
)
_BLS12_381_FR_WEIGHTS = tuple((rate, 257, 8, 13, 0) for rate in range(2, 9))
# BLS12-377 Fr: 5 divides p - 1, so alpha = 17 at every rate.
_BLS12_377_FR_CONSTRAINTS = tuple(
    (rate, 17, rf, rp, skip) for rate, _a, rf, rp, skip in _BLS12_381_FR_CONSTRAINTS
)
_GOLDILOCKS_CONSTRAINTS = ((4, 7, 8, 22, 0), (8, 7, 8, 22, 0))
_BABYBEAR_CONSTRAINTS = ((8, 7, 8, 13, 0),)
_MERSENNE31_CONSTRAINTS = ((8, 5, 8, 14, 0),)
_KOALABEAR_CONSTRAINTS = ((8, 3, 8, 20, 0),)

_DEFAULT_TABLES = {
    "bls12_381_fr": {False: _BLS12_381_FR_CONSTRAINTS, True: _BLS12_381_FR_WEIGHTS},
    "bn254_fr": {False: _BLS12_381_FR_CONSTRAINTS, True: _BLS12_381_FR_WEIGHTS},
    "bls12_377_fr": {False: _BLS12_377_FR_CONSTRAINTS, True: _BLS12_381_FR_WEIGHTS},
    "goldilocks_fr": {False: _GOLDILOCKS_CONSTRAINTS, True: _GOLDILOCKS_CONSTRAINTS},
    "babybear_fr": {False: _BABYBEAR_CONSTRAINTS, True: _BABYBEAR_CONSTRAINTS},
    "mersenne31_fr": {False: _MERSENNE31_CONSTRAINTS, True: _MERSENNE31_CONSTRAINTS},
    "koalabear_fr": {False: _KOALABEAR_CONSTRAINTS, True: _KOALABEAR_CONSTRAINTS},
}

# Sponge capacity in state elements: 1 for the ~255-bit fields, more for the
# small fields so that the capacity holds at least ~248 bits.
_DEFAULT_CAPACITY = {
    "goldilocks_fr": 4,
    "babybear_fr": 8,
    "mersenne31_fr": 8,
    "koalabear_fr": 8,
}


def register_default_table(
    fs: FieldSpec,
    table,
    capacity: int = 1,
    optimized_for_weights_table=None,
) -> None:
    """Register default Poseidon tables for a user-supplied field, so that
    ``get_default_poseidon_parameters`` serves it (the hook of the
    reference's ``PoseidonDefaultConfig`` trait).

    ``table``: rows ``(rate, alpha, full_rounds, partial_rounds,
    skip_matrices)``; ``optimized_for_weights_table`` defaults to ``table``;
    ``capacity`` in state elements.  Registering a field name again, or a
    shipped field's name, replaces its tables.
    """

    def validated(t):
        rows = tuple(tuple(int(v) for v in row) for row in t)
        for row in rows:
            if len(row) != 5:
                raise ValueError(
                    "table rows must be (rate, alpha, full_rounds, partial_rounds,"
                    f" skip_matrices); got {row}"
                )
        return rows

    rows = validated(table)
    weights = rows if optimized_for_weights_table is None else validated(optimized_for_weights_table)
    if capacity < 1:
        raise ValueError("capacity must be >= 1")
    _DEFAULT_TABLES[fs.name] = {False: rows, True: weights}
    _DEFAULT_CAPACITY[fs.name] = capacity
    get_default_poseidon_parameters.cache_clear()  # it caches by field, not by table


_VECTORS = pathlib.Path(__file__).resolve().parents[2] / "vectors"


@functools.lru_cache(maxsize=None)
def poseidon_test_fixture() -> PoseidonConfig:
    """The reference crate's hardcoded test parameters (BLS12-381 Fr,
    alpha=17, rate=2, R_F=8, R_P=29), read from
    ``vectors/poseidon_bls381_fr_test_fixture.json``."""
    data = json.loads((_VECTORS / "poseidon_bls381_fr_test_fixture.json").read_text())
    return PoseidonConfig(
        field=BLS12_381_FR,
        full_rounds=data["full_rounds"],
        partial_rounds=data["partial_rounds"],
        alpha=data["alpha"],
        ark=tuple(tuple(int(v) for v in row) for row in data["ark"]),
        mds=tuple(tuple(int(v) for v in row) for row in data["mds"]),
        rate=data["rate"],
        capacity=data["capacity"],
    )


@functools.lru_cache(maxsize=None)
def get_default_poseidon_parameters(
    fs: FieldSpec, rate: int, optimized_for_weights: bool = False
) -> PoseidonConfig:
    """Default Poseidon parameters for ``rate`` from the field's table."""
    table = _DEFAULT_TABLES[fs.name][bool(optimized_for_weights)]
    capacity = _DEFAULT_CAPACITY.get(fs.name, 1)
    for rate_, alpha, full_rounds, partial_rounds, skip_matrices in table:
        if rate_ == rate:
            ark, mds = find_poseidon_ark_and_mds(
                fs, rate, full_rounds, partial_rounds, skip_matrices, capacity
            )
            return PoseidonConfig(
                field=fs,
                full_rounds=full_rounds,
                partial_rounds=partial_rounds,
                alpha=alpha,
                ark=ark,
                mds=mds,
                rate=rate,
                capacity=capacity,
            )
    raise ValueError(f"no default Poseidon parameters for rate={rate}")
