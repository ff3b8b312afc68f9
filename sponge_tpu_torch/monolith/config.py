"""Monolith configuration (counterpart of ``sponge_tpu/monolith/config.py``).

Monolith (Grassi et al., ePrint 2023/1025) is the permutation for fields of
the shapes ``p = 2^n - 1`` (Monolith-31 over Mersenne31) and
``p = 2^n - 2^m + 1`` with a chunk boundary at ``m`` (Monolith-64 over
Goldilocks, KoalaBear, BabyBear).  It opens with one Concrete; then each of
R rounds (typically 6) is

    Bars:     the leading ``u`` elements are cut into bit chunks
              (8, 8, ..., rem), each chunk passes a chi-like bitwise S-box,
              the chunks are put back together;
    Bricks:   x_i <- x_i + x_{i-1}^2, every square of the values before the
              update (a type-2 Feistel);
    Concrete: state <- M . state for an MDS matrix M, then + rc[round] (the
              last round's constants are zero).

The flat constant buffer of the CUDA kernel (``kernel_constants``) is laid
out by ``constant_layout``; ``csrc/monolith.cu`` reads the same order.  Its
round constants and matrix are in the domain of the kernel body that
``ops/bounds.py`` ``check_monolith_bounds`` chooses.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from ..fields import FieldSpec
from ..poseidon.config import mont_limb_rows, unpack_layout


def bar_m(fs: FieldSpec) -> int:
    """m of p = 2^n - 2^m + 1 (the Bar chunk boundary ``check_bar_field``
    needs); 0 when p is not of that shape."""
    d = (1 << fs.modulus_bit_size) + 1 - fs.modulus
    return d.bit_length() - 1 if d > 0 and d & (d - 1) == 0 else 0


def bar_chunks(fs: FieldSpec) -> tuple:
    """Chunk widths (little-endian) of the Bar decomposition: 8-bit chunks
    with an extra boundary at ``m`` (p = 2^n - 2^m + 1) when m is not
    byte-aligned (Mersenne31 8,8,8,7; Goldilocks 8 x 8; BabyBear's m = 27
    splits the top byte: 8,8,8,3,4).  No chunk crosses a multiple of 8, so
    none straddles two of the port's 24-bit limbs."""
    n = fs.modulus_bit_size
    m = bar_m(fs)
    chunks = []
    bit = 0
    while bit < n:
        nxt = (bit // 8 + 1) * 8
        if nxt >= n:
            nxt = n
        if m > 1 and bit < m < nxt:
            nxt = m
        chunks.append(nxt - bit)
        bit = nxt
    return tuple(chunks)


def chunk_sbox(y, k: int):
    """The chi-like k-bit S-box on a Python int or an integer tensor of
    values below 2^k: even k uses the 3-rotation AND (the 2-term chi is not
    invertible for even sizes), odd k the 2-rotation form; both close with a
    1-bit rotation.  Fixes 0 and the all-ones chunk."""
    mask = (1 << k) - 1

    def rot(v, r):
        r %= k
        return ((v << r) | (v >> (k - r))) & mask

    nb = y ^ mask
    if k % 2 == 0:
        z = y ^ (rot(nb, 1) & rot(y, 2) & rot(y, 3))
    else:
        z = y ^ (rot(nb, 1) & rot(y, 2))
    return rot(z, 1)


@functools.lru_cache(maxsize=None)
def _check_chunk_sbox(k: int) -> None:
    """The k-bit S-box is a bijection fixing 0 and 2^k - 1 (k <= 8, so at
    most 256 entries are checked)."""
    table = [chunk_sbox(y, k) for y in range(1 << k)]
    if len(set(table)) != 1 << k:
        raise ValueError(f"{k}-bit bar S-box is not a bijection")
    if table[0] != 0 or table[-1] != (1 << k) - 1:
        raise ValueError(f"{k}-bit bar S-box does not fix 0 / all-ones")


@functools.lru_cache(maxsize=None)
def check_bar_field(fs: FieldSpec) -> None:
    """Bars map [0, p) onto [0, p) iff the invalid strings [p, 2^n) map onto
    themselves.  With p = 2^n - 2^m + 1 a string is invalid iff its top
    n - m bits are all ones and its low m bits are not all zero; each chunk
    S-box fixes the all-zero and all-one chunks, so both predicates are kept
    chunk by chunk whenever m is a chunk boundary.  m = 1 (p = 2^n - 1) also
    qualifies: its one invalid string (all ones) is a fixed point."""
    n = fs.modulus_bit_size
    d = (1 << n) + 1 - fs.modulus  # = 2^m for the supported shapes
    if d & (d - 1):
        raise ValueError(
            f"{fs.name} is not bar-safe: p must be 2^n - 2^m + 1 (got "
            f"2^{n} + 1 - p = {d}, not a power of two)"
        )
    m = d.bit_length() - 1
    boundaries = {0}
    acc = 0
    for c in bar_chunks(fs):
        acc += c
        boundaries.add(acc)
    if m != 1 and m not in boundaries:
        raise ValueError(
            f"{fs.name} is not bar-safe: m = {m} is not a bar chunk boundary "
            f"(chunks {bar_chunks(fs)})"
        )
    for k in set(bar_chunks(fs)):
        _check_chunk_sbox(k)


def bar_int(fs: FieldSpec, x: int) -> int:
    """Bar of one canonical value: cut into chunks, S-box each, put back."""
    out, bit = 0, 0
    for k in bar_chunks(fs):
        out |= chunk_sbox((x >> bit) & ((1 << k) - 1), k) << bit
        bit += k
    return out


@dataclass(frozen=True)
class MonolithConfig:
    """Parameters of the Monolith permutation and the duplex sponge geometry.

    ``rc`` is indexed ``rc[round][element]``; the last row must be all zeros
    (the paper adds no constants after the last round).  ``concrete`` is the
    (t, t) MDS matrix.
    """

    field: FieldSpec
    rounds: int
    bars: int  # u: leading state elements through Bar each round
    rc: tuple  # (rounds, t) ints
    concrete: tuple  # (t, t) ints
    rate: int
    capacity: int = 1

    def __post_init__(self):
        t = self.rate + self.capacity
        check_bar_field(self.field)
        if self.rounds < 1:
            raise ValueError("rounds must be >= 1")
        if not 1 <= self.bars <= t:
            raise ValueError(f"bars must be in [1, t]; got {self.bars}")
        if len(self.rc) != self.rounds:
            raise ValueError("rc must have rounds rows")
        for row in self.rc:
            if len(row) != t:
                raise ValueError("each rc row must have t entries")
        if any(v != 0 for v in self.rc[-1]):
            raise ValueError("the last rc row must be all zeros (paper schedule)")
        if len(self.concrete) != t or any(len(row) != t for row in self.concrete):
            raise ValueError("concrete must be t x t")

    @property
    def t(self) -> int:
        """State width (rate + capacity)."""
        return self.rate + self.capacity

    def pow2_circulant_exponents(self) -> tuple | None:
        """(t, t) exponents when ``concrete`` is a circulant of powers of
        two; None otherwise."""
        t = self.t
        first = self.concrete[0]
        for i in range(t):
            for j in range(t):
                if self.concrete[i][j] != first[(j - i) % t]:
                    return None
        exps = []
        for v in first:
            if v <= 0 or v & (v - 1):
                return None
            exps.append(v.bit_length() - 1)
        return tuple(tuple(exps[(j - i) % t] for j in range(t)) for i in range(t))

    def concrete_small_entries(self) -> tuple | None:
        """The matrix itself when every entry is a positive integer below
        2^24 (one 24-bit digit: the kernel's scaled Concrete multiplies limb
        words by the plain entry); None otherwise (dense Montgomery rows)."""
        if all(0 < v < (1 << 24) for row in self.concrete for v in row):
            return self.concrete
        return None

    def oracle_sponge(self):
        """Scalar python-int duplex sponge over this permutation."""
        from .oracle import OracleMonolithSponge

        return OracleMonolithSponge(self)


def constant_layout(cfg: MonolithConfig):
    """Sections of the flat int32 constant buffer, in order, limb axis last:
    the modulus, R mod p (the Montgomery form of 1), plain 1 and R^2 mod p
    as plain limbs; the Bar chunk widths; the round constants; the Concrete
    matrix."""
    t, L = cfg.t, cfg.field.nlimbs
    return [
        ("p", (L,)),
        ("rho", (L,)),
        ("one", (L,)),
        ("r2", (L,)),
        ("chunks", (len(bar_chunks(cfg.field)),)),
        ("rc", (cfg.rounds, t, L)),
        ("mat", (t, t, L)),
    ]


@functools.lru_cache(maxsize=None)
def kernel_constants(cfg: MonolithConfig) -> np.ndarray:
    """Flat int32 buffer of ``constant_layout``, built once per config.  The
    round constants are Montgomery limbs for the generic body and plain
    canonical limbs for the Mersenne body (which never leaves the canonical
    domain); the matrix is Montgomery limbs for the generic body's dense
    Concrete and plain limbs otherwise (a scaled entry is its own low
    limb)."""
    from ..ops.bounds import check_monolith_bounds

    fs = cfg.field
    plan = check_monolith_bounds(cfg)

    def plain_rows(rows):
        return np.stack([np.stack([fs.int_to_limbs(v % fs.modulus) for v in row]) for row in rows])

    generic = plan.body == "generic"
    parts = [
        fs.int_to_limbs(fs.modulus),
        fs.int_to_limbs(fs.r_mod_p),
        fs.int_to_limbs(1),
        fs.int_to_limbs(fs.r2_mod_p),
        np.asarray(bar_chunks(fs), dtype=np.int64),
        mont_limb_rows(fs, cfg.rc) if generic else plain_rows(cfg.rc),
        mont_limb_rows(fs, cfg.concrete) if generic and plan.concrete == "dense" else plain_rows(cfg.concrete),
    ]
    return np.concatenate([np.asarray(a).reshape(-1) for a in parts]).astype(np.int32)


def unpack_constants(cfg: MonolithConfig, buf):
    """Views of a (device) constant buffer by section, each with a trailing
    batch axis of 1."""
    return unpack_layout(constant_layout(cfg), buf)
