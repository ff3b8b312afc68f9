"""Rescue-Prime configuration (counterpart of ``sponge_tpu/rescue/config.py``).

Rescue-Prime (ePrint 2020/1143) alternates the S-box x^alpha with the inverse
S-box x^(1/alpha) in every round.  Round r (of N):

    state <- MDS . sbox_alpha(state)     + rc[2r]
    state <- MDS . sbox_1/alpha(state)   + rc[2r+1]

Rescue Prime Optimized (ePrint 2022/1577, ``mds_first``) puts the affine
layer before the S-box in each half-round, so the permutation ends on the
inverse S-box:

    state <- sbox_alpha(MDS . state + rc[2r])
    state <- sbox_1/alpha(MDS . state + rc[2r+1])

The flat constant buffer of the CUDA kernel (``kernel_constants``) is laid
out by ``constant_layout``; ``csrc/rescue.cu`` reads the same order.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np

from ..fields import FieldSpec
from ..ops._build import registers
from ..ops.montgomery import wide_state, window_for, window_schedule
from ..poseidon.config import mont_limb_rows, unpack_layout


@dataclass(frozen=True)
class RescueConfig:
    """Parameters of the Rescue-Prime permutation and the duplex sponge
    geometry.  ``rc[2*r + half][element]``: two injection rows per round.
    ``mds_first``: the round order of Rescue Prime Optimized (the MDS and
    the constants, then the S-box), part of the permutation."""

    field: FieldSpec
    rounds: int
    alpha: int
    mds: tuple  # (t, t) ints
    rc: tuple  # (2 * rounds, t) ints
    rate: int
    capacity: int = 1
    mds_first: bool = False

    def __post_init__(self):
        t = self.rate + self.capacity
        p = self.field.modulus
        if math.gcd(self.alpha, p - 1) != 1:
            raise ValueError(
                f"alpha={self.alpha} is not invertible mod p-1; the inverse "
                f"S-box x^(1/alpha) does not exist over {self.field.name}"
            )
        if self.rounds < 1:
            raise ValueError("rounds must be >= 1")
        if len(self.rc) != 2 * self.rounds:
            raise ValueError("rc must have 2 * rounds rows")
        for row in self.rc:
            if len(row) != t:
                raise ValueError("each rc row must have t entries")
        if len(self.mds) != t or any(len(row) != t for row in self.mds):
            raise ValueError("mds must be t x t")

    @property
    def t(self) -> int:
        """State width (rate + capacity)."""
        return self.rate + self.capacity

    @property
    def inv_alpha(self) -> int:
        """The inverse S-box exponent alpha^{-1} mod p-1 (about log2 p bits)."""
        return pow(self.alpha, -1, self.field.modulus - 1)

    def oracle_sponge(self):
        """Scalar python-int duplex sponge over this permutation."""
        from .oracle import OracleRescueSponge

        return OracleRescueSponge(self)


@functools.lru_cache(maxsize=None)
def windows(cfg: RescueConfig) -> tuple[int, int]:
    """Kernel 5's windows (``montgomery.window_for``) for x^alpha and
    x^(1/alpha): the t chains of a lane at the kernel's registers, or one
    chain at a wide state (``montgomery.wide_state``: one element at a
    time)."""
    t, L = cfg.t, cfg.field.nlimbs
    regs, chains = registers("sponge_rescue", t, L), 1 if wide_state(t, L) else t
    return window_for(cfg.alpha, L, chains, regs), window_for(cfg.inv_alpha, L, chains, regs)


def schedules(cfg: RescueConfig) -> tuple[list[int], list[int]]:
    """``montgomery.window_schedule`` of alpha and 1/alpha at ``windows``."""
    w_alpha, w_inv = windows(cfg)
    return window_schedule(cfg.alpha, w_alpha), window_schedule(cfg.inv_alpha, w_inv)


def constant_layout(cfg: RescueConfig):
    """Sections of the flat int32 constant buffer, in order, limb axis last:
    the modulus and R mod p (the Montgomery form of 1) as plain limbs, the
    round constants and the MDS as Montgomery limbs, then the window
    schedules of alpha and 1/alpha (``schedules``)."""
    t, L = cfg.t, cfg.field.nlimbs
    alpha_sched, inv_sched = schedules(cfg)
    return [
        ("p", (L,)),
        ("one", (L,)),
        ("rc", (2 * cfg.rounds, t, L)),
        ("mds", (t, t, L)),
        ("alpha_window", (len(alpha_sched),)),
        ("inv_window", (len(inv_sched),)),
    ]


@functools.lru_cache(maxsize=None)
def kernel_constants(cfg: RescueConfig) -> np.ndarray:
    """Flat int32 buffer of ``constant_layout``, built once per config."""
    fs = cfg.field
    parts = [
        fs.int_to_limbs(fs.modulus),
        fs.int_to_limbs(fs.r_mod_p),
        mont_limb_rows(fs, cfg.rc),
        mont_limb_rows(fs, cfg.mds),
        *(np.asarray(sched, dtype=np.int64) for sched in schedules(cfg)),
    ]
    return np.concatenate([np.asarray(a).reshape(-1) for a in parts]).astype(np.int32)


def unpack_constants(cfg: RescueConfig, buf):
    """Views of a (device) constant buffer by section, each with a trailing
    batch axis of 1."""
    return unpack_layout(constant_layout(cfg), buf)
