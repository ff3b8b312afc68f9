"""Poseidon2 configuration (counterpart of ``sponge_tpu/poseidon2/config.py``).

The round schedule is the ePrint 2023/323 one:

    state <- M_E . state                                   (initial linear layer)
    R_F/2 external rounds:  state <- M_E . sbox(state + rc_ext[r])
    R_P   internal rounds:  state[0] <- sbox(state[0] + rc_int[r]); state <- M_I . state
    R_F/2 external rounds:  state <- M_E . sbox(state + rc_ext[r])

``mat_e`` is stored dense (t x t small ints); ``mat_i_diag`` stores the
diagonal ``mu`` of ``M_I = J + diag(mu - 1)`` (off-diagonal entries are all 1).

The flat constant buffer the CUDA kernel reads (``kernel_constants``) is laid
out by ``constant_layout``; ``csrc/poseidon2.cu`` reads the same order.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from ..fields import FieldSpec
from ..poseidon.config import mont_limb_rows, unpack_layout

# Diagonal entries mu - 1 below this scale the limbs by a plain integer;
# larger ones take one constant Montgomery product per element.
SMALL_DIAG_LIMIT = 1 << 4

# Kernel 3 keeps one element in one 32-bit word (its one-word body) for a
# field below this: every value below 2p then fits a word.
WORD_FIELD_LIMIT = 1 << 31
WORD_HEAD = 5  # p, -p^-1 mod 2^32, 2^16 mod p, 2^48 mod p, floor(2^48 / p)


def one_word(fs: FieldSpec) -> bool:
    """Whether kernel 3 runs the field with its one-word body."""
    return fs.modulus < WORD_FIELD_LIMIT


@dataclass(frozen=True)
class Poseidon2Config:
    """Parameters of the Poseidon2 permutation and the duplex sponge geometry.

    ``external_rc[round][element]`` covers the R_F external rounds (first half
    before the internal phase, second half after); ``internal_rc[r]`` is the
    single element-0 constant of internal round r.
    """

    field: FieldSpec
    full_rounds: int
    partial_rounds: int
    alpha: int
    external_rc: tuple  # (R_F, t) ints
    internal_rc: tuple  # (R_P,) ints
    mat_e: tuple  # (t, t) small ints
    mat_i_diag: tuple  # (t,) diagonal mu of M_I
    rate: int
    capacity: int = 1

    def __post_init__(self):
        t = self.rate + self.capacity
        if self.full_rounds % 2 != 0:
            raise ValueError("full_rounds must be even (R_F/2 + R_P + R_F/2)")
        if len(self.external_rc) != self.full_rounds:
            raise ValueError("external_rc must have full_rounds rows")
        for row in self.external_rc:
            if len(row) != t:
                raise ValueError("each external_rc row must have t entries")
        if len(self.internal_rc) != self.partial_rounds:
            raise ValueError("internal_rc must have partial_rounds entries")
        if len(self.mat_e) != t or any(len(row) != t for row in self.mat_e):
            raise ValueError("mat_e must be t x t")
        if len(self.mat_i_diag) != t:
            raise ValueError("mat_i_diag must have t entries")

    @property
    def t(self) -> int:
        """State width (rate + capacity)."""
        return self.rate + self.capacity

    @property
    def rounds(self) -> int:
        return self.full_rounds + self.partial_rounds

    @property
    def diag_m1(self) -> tuple:
        """``mu_i - 1 mod p``: M_I x = sigma + diag_m1 * x."""
        p = self.field.modulus
        return tuple((d - 1) % p for d in self.mat_i_diag)

    @property
    def small_diag(self) -> bool:
        """True when every ``mu_i - 1`` scales limbs as a plain integer."""
        return all(v < SMALL_DIAG_LIMIT for v in self.diag_m1)

    def batched_permute(self, state, backend: str = "auto"):
        """Permutation hook of the shared duplex sponge
        (``poseidon.permutation.batched_permute`` delegates here)."""
        from .permutation import batched_permute2

        return batched_permute2(self, state, backend)

    def oracle_sponge(self):
        """Scalar python-int duplex sponge over this permutation."""
        from .oracle import OraclePoseidon2Sponge

        return OraclePoseidon2Sponge(self)


LIMB_SECTIONS = 7  # the sections of the limb body (and of the plain version)


def constant_layout(cfg: Poseidon2Config):
    """Sections of the flat int32 constant buffer, in order, limb axis last:
    the modulus and rho = R mod p (plain limbs; rho is also the Montgomery
    form of 1), the round constants and M_I's Montgomery diagonal
    (Montgomery limbs), then M_E and the small diagonal as plain ints.  For
    a field below 2^31 (``one_word``) the one-word body's section follows:
    ``WORD_HEAD`` words of field constants, the round constants and the
    diagonal in Montgomery form with R' = 2^32, and M_E again."""
    t, L = cfg.t, cfg.field.nlimbs
    layout = [
        ("p", (L,)),
        ("rho", (L,)),
        ("ext", (cfg.full_rounds, t, L)),
        ("int", (cfg.partial_rounds, L)),
        ("diag_mont", (t, L)),
        ("mat_e", (t, t)),
        ("diag_small", (t,)),
    ]
    if one_word(cfg.field):
        layout += [
            ("word_head", (WORD_HEAD,)),
            ("word_ext", (cfg.full_rounds, t)),
            ("word_int", (cfg.partial_rounds,)),
            ("word_diag", (t,)),
            ("word_mat_e", (t, t)),
        ]
    return layout


def _int32_words(values) -> np.ndarray:
    """Words below 2^32 as int32 (the same 32 bits)."""
    return np.asarray([v - (1 << 32) if v >= 1 << 31 else v for v in values], dtype=np.int64)


def word_constants(cfg: Poseidon2Config) -> np.ndarray:
    """The one-word section of ``constant_layout``: p, -p^-1 mod 2^32,
    2^16 mod p (a product by it takes a value from R = 2^48 to R' = 2^32),
    2^48 mod p (back), floor(2^48 / p) (``reduce_wide``'s quotient), then
    the round constants and mu - 1 times R' mod p, and M_E."""
    p = cfg.field.modulus
    head = [p, (-pow(p, -1, 1 << 32)) % (1 << 32), (1 << 16) % p, (1 << 48) % p, (1 << 48) // p]
    mont = [(v << 32) % p for v in [v for row in cfg.external_rc for v in row] + list(cfg.internal_rc)
            + list(cfg.diag_m1)]
    return np.concatenate([_int32_words(head + mont), np.asarray(cfg.mat_e, dtype=np.int64).reshape(-1)])


@functools.lru_cache(maxsize=None)
def kernel_constants(cfg: Poseidon2Config) -> np.ndarray:
    """Flat int32 buffer of ``constant_layout``, built once per config."""
    fs = cfg.field
    dm1 = cfg.diag_m1
    parts = [
        fs.int_to_limbs(fs.modulus),
        fs.int_to_limbs(fs.r_mod_p),
        mont_limb_rows(fs, cfg.external_rc),
        mont_limb_rows(fs, [cfg.internal_rc])[0] if cfg.partial_rounds else np.zeros(0),
        mont_limb_rows(fs, [dm1])[0],
        np.asarray(cfg.mat_e, dtype=np.int64),
        np.asarray([v if v < SMALL_DIAG_LIMIT else 0 for v in dm1], dtype=np.int64),
    ]
    if one_word(fs):
        parts.append(word_constants(cfg))
    return np.concatenate([np.asarray(a).reshape(-1) for a in parts]).astype(np.int32)


def unpack_constants(cfg: Poseidon2Config, buf):
    """Views of a (device) constant buffer by section, each with a trailing
    batch axis of 1."""
    return unpack_layout(constant_layout(cfg), buf)
