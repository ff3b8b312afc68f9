"""Griffin-pi configuration (counterpart of ``sponge_tpu/griffin/config.py``).

Griffin (ePrint 2022/403) mixes one inverse power map, one forward power
map and t-2 elements gated by a quadratic of a linear combination:

    y_0 = x_0^(1/d)
    y_1 = x_1^d
    y_i = x_i * (L_i^2 + alpha_i * L_i + beta_i)        for i = 2..t-1
          with L_i = (i-1) * y_0 + y_1 + x_{i-1}         (L_2 = y_0 + y_1)

where (alpha_i, beta_i) = ((i-1) a, (i-1)^2 b) for a base pair (a, b) with
a^2 - 4b a quadratic non-residue mod p, so every gate is non-zero and the
layer is a permutation.  The permutation is

    state <- M_E . state;   per round r: state <- M_E . S(state) + rc[r]

with M_E Poseidon2's small-integer matrix and rc[rounds - 1] = 0.

The flat constant buffer of the CUDA kernel (``kernel_constants``) is laid
out by ``constant_layout``; ``csrc/griffin.cu`` reads the same order.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np

from ..fields import FieldSpec
from ..ops._build import registers
from ..ops.montgomery import window_for, window_schedule
from ..poseidon.config import mont_limb_rows, unpack_layout


def is_quadratic_nonresidue(v: int, p: int) -> bool:
    """Euler's criterion: v^((p-1)/2) == -1 mod p (p an odd prime)."""
    return v % p != 0 and pow(v % p, (p - 1) // 2, p) == p - 1


@dataclass(frozen=True)
class GriffinConfig:
    """Parameters of the Griffin-pi permutation and the duplex sponge
    geometry.  ``rc`` has ``rounds - 1`` rows (the last round adds no
    constants); ``qc_alpha``/``qc_beta`` are the base pair (a, b) of the
    quadratic gates."""

    field: FieldSpec
    rounds: int
    alpha: int
    mat_e: tuple  # (t, t) small ints
    rc: tuple  # (rounds - 1, t) ints
    qc_alpha: int
    qc_beta: int
    rate: int
    capacity: int = 1

    def __post_init__(self):
        t = self.rate + self.capacity
        p = self.field.modulus
        if t < 3 or (t != 3 and t % 4 != 0):
            raise ValueError(f"Griffin state width must be 3 or a multiple of 4; got t={t}")
        if math.gcd(self.alpha, p - 1) != 1:
            raise ValueError(
                f"alpha={self.alpha} is not invertible mod p-1; the inverse "
                f"power map x^(1/alpha) does not exist over {self.field.name}"
            )
        if self.rounds < 1:
            raise ValueError("rounds must be >= 1")
        if len(self.rc) != self.rounds - 1:
            raise ValueError("rc must have rounds - 1 rows")
        for row in self.rc:
            if len(row) != t:
                raise ValueError("each rc row must have t entries")
        if len(self.mat_e) != t or any(len(row) != t for row in self.mat_e):
            raise ValueError("mat_e must be t x t")
        if not is_quadratic_nonresidue((self.qc_alpha * self.qc_alpha - 4 * self.qc_beta) % p, p):
            raise ValueError(
                "qc_alpha^2 - 4*qc_beta must be a quadratic non-residue mod p "
                "(otherwise some quadratic factor has a root and the "
                "nonlinear layer is not a permutation)"
            )

    @property
    def t(self) -> int:
        """State width (rate + capacity)."""
        return self.rate + self.capacity

    @property
    def inv_alpha(self) -> int:
        """The inverse power-map exponent alpha^{-1} mod p-1."""
        return pow(self.alpha, -1, self.field.modulus - 1)

    def quad_coeffs(self, i: int) -> tuple[int, int]:
        """(alpha_i, beta_i) of the i-th element's quadratic, i in 2..t-1."""
        p, g = self.field.modulus, i - 1
        return (g * self.qc_alpha) % p, (g * g * self.qc_beta) % p

    def batched_permute(self, state, backend: str = "auto"):
        """Permutation hook of the shared duplex sponge
        (``poseidon.permutation.batched_permute`` delegates here)."""
        from .permutation import batched_griffin_permute

        return batched_griffin_permute(self, state, backend)

    def oracle_sponge(self):
        """Scalar python-int duplex sponge over this permutation."""
        from .oracle import OracleGriffinSponge

        return OracleGriffinSponge(self)


@functools.lru_cache(maxsize=None)
def window(cfg: GriffinConfig) -> int:
    """Kernel 6's window (``montgomery.window_for``) for x_0^(1/alpha): one
    chain per lane at the kernel's registers."""
    L = cfg.field.nlimbs
    return window_for(cfg.inv_alpha, L, 1, registers("sponge_griffin", cfg.t, L))


def schedule(cfg: GriffinConfig) -> list[int]:
    """``montgomery.window_schedule`` of 1/alpha at ``window``."""
    return window_schedule(cfg.inv_alpha, window(cfg))


def constant_layout(cfg: GriffinConfig):
    """Sections of the flat int32 constant buffer, in order, limb axis last:
    the modulus and R mod p (plain limbs), the round constants with a zero
    last row and the gates' (alpha_i, beta_i) for i = 2..t-1 (Montgomery
    limbs), M_E (plain ints) and the window schedule of 1/alpha
    (``schedule``)."""
    t, L = cfg.t, cfg.field.nlimbs
    return [
        ("p", (L,)),
        ("one", (L,)),
        ("rc", (cfg.rounds, t, L)),
        ("qa", (t - 2, L)),
        ("qb", (t - 2, L)),
        ("mat_e", (t, t)),
        ("inv_window", (len(schedule(cfg)),)),
    ]


@functools.lru_cache(maxsize=None)
def kernel_constants(cfg: GriffinConfig) -> np.ndarray:
    """Flat int32 buffer of ``constant_layout``, built once per config."""
    fs, t = cfg.field, cfg.t
    quads = [cfg.quad_coeffs(i) for i in range(2, t)]
    parts = [
        fs.int_to_limbs(fs.modulus),
        fs.int_to_limbs(fs.r_mod_p),
        mont_limb_rows(fs, tuple(cfg.rc) + ((0,) * t,)),
        mont_limb_rows(fs, [[a for a, _ in quads]]),
        mont_limb_rows(fs, [[b for _, b in quads]]),
        np.asarray(cfg.mat_e, dtype=np.int64),
        np.asarray(schedule(cfg), dtype=np.int64),
    ]
    return np.concatenate([np.asarray(a).reshape(-1) for a in parts]).astype(np.int32)


def unpack_constants(cfg: GriffinConfig, buf):
    """Views of a (device) constant buffer by section, each with a trailing
    batch axis of 1."""
    return unpack_layout(constant_layout(cfg), buf)
