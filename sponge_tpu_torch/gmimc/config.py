"""GMiMC-erf configuration (counterpart of ``sponge_tpu/gmimc/config.py``).

GMiMC (ePrint 2019/397) in its expanding-round-function form is an
unbalanced Feistel network over t branches.  Round r:

    F   = (x_0 + c_r)^alpha
    x_i = x_i + F                  for i = 1..t-1
    state -> (x_1, ..., x_{t-1}, x_0)

The original x_0, without the constant, moves to the back.  There is no
linear layer and one constant per round.

The flat constant buffer of the CUDA kernel (``kernel_constants``) is laid
out by ``constant_layout``; ``csrc/gmimc.cu`` reads the same order, its limb
body the limb sections and, at Goldilocks (``word_body``), its two-word body
the word section.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np

from ..fields import GOLDILOCKS_FR, FieldSpec
from ..poseidon.config import mont_limb_rows, unpack_layout


@dataclass(frozen=True)
class GmimcConfig:
    """Parameters of the GMiMC-erf permutation and the duplex sponge
    geometry.  ``rc`` has one constant per round (it enters only the F-branch
    input)."""

    field: FieldSpec
    rounds: int
    alpha: int
    rc: tuple  # (rounds,) ints
    rate: int
    capacity: int = 1

    def __post_init__(self):
        t = self.rate + self.capacity
        p = self.field.modulus
        if t < 2:
            raise ValueError(f"GMiMC state width must be >= 2; got t={t}")
        if math.gcd(self.alpha, p - 1) != 1:
            raise ValueError(
                f"alpha={self.alpha} is not invertible mod p-1; the round "
                f"function is not a permutation over {self.field.name}"
            )
        if self.rounds < 1:
            raise ValueError("rounds must be >= 1")
        if len(self.rc) != self.rounds:
            raise ValueError("rc must have one constant per round")

    @property
    def t(self) -> int:
        """State width (rate + capacity)."""
        return self.rate + self.capacity

    def batched_permute(self, state, backend: str = "auto"):
        """Permutation hook of the shared duplex sponge
        (``poseidon.permutation.batched_permute`` delegates here)."""
        from .permutation import batched_gmimc_permute

        return batched_gmimc_permute(self, state, backend)

    def oracle_sponge(self):
        """Scalar python-int duplex sponge over this permutation."""
        from .oracle import OracleGmimcSponge

        return OracleGmimcSponge(self)


LIMB_SECTIONS = 3  # the sections of the limb body (and of the plain version)
WORD_HEAD = 4  # 2^-72 mod p and 2^72 mod p, two 32-bit words each


def word_body(fs: FieldSpec) -> bool:
    """Whether kernel 8 runs the field with its two-word body (Goldilocks:
    its reduction mod p takes no multiply)."""
    return fs.modulus == GOLDILOCKS_FR.modulus


def constant_layout(cfg: GmimcConfig):
    """Sections of the flat int32 constant buffer, in order, limb axis last:
    the modulus and R mod p (the Montgomery form of 1) as plain limbs, then
    the round constants as Montgomery limbs.  At Goldilocks (``word_body``)
    the two-word body's section follows: ``WORD_HEAD`` words converting the
    plane's R = 2^72 (2^-72 mod p in, 2^72 mod p out), then the round
    constants as plain values, each 64-bit value as two 32-bit words, low
    first."""
    L = cfg.field.nlimbs
    layout = [("p", (L,)), ("one", (L,)), ("rc", (cfg.rounds, L))]
    if word_body(cfg.field):
        layout += [("word_head", (WORD_HEAD,)), ("word_rc", (cfg.rounds, 2))]
    return layout


def _word_pairs(values) -> np.ndarray:
    """64-bit values as (low, high) 32-bit words in int32 (the same bits)."""
    words = [w for v in values for w in (v & 0xFFFFFFFF, v >> 32)]
    return np.asarray([w - (1 << 32) if w >= 1 << 31 else w for w in words], dtype=np.int64)


@functools.lru_cache(maxsize=None)
def kernel_constants(cfg: GmimcConfig) -> np.ndarray:
    """Flat int32 buffer of ``constant_layout``, built once per config."""
    fs = cfg.field
    parts = [fs.int_to_limbs(fs.modulus), fs.int_to_limbs(fs.r_mod_p), mont_limb_rows(fs, [cfg.rc])]
    if word_body(fs):
        p, r = fs.modulus, fs.r
        parts.append(_word_pairs([pow(r, -1, p), r % p] + list(cfg.rc)))
    return np.concatenate([np.asarray(a).reshape(-1) for a in parts]).astype(np.int32)


def unpack_constants(cfg: GmimcConfig, buf):
    """Views of a (device) constant buffer by section, each with a trailing
    batch axis of 1."""
    return unpack_layout(constant_layout(cfg), buf)
