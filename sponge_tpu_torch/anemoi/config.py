"""Anemoi configuration (counterpart of ``sponge_tpu/anemoi/config.py``).

Anemoi (ePrint 2022/840) views the t = 2l state as two columns
X = (x_0..x_{l-1}) and Y = (y_0..y_{l-1}).  Round r:

    X += rc_x[r];  Y += rc_y[r]
    diffusion:  X <- M_x X;  Y <- M_x rot_left_1(Y);  Y += X;  X += Y
    open Flystel on every pair (x, y):
        u = x - (g y^2 + g^-1);  v = y - u^(1/alpha);  (x, y) <- (u + g v^2, v)

and one more diffusion closes the permutation.  M_x is the identity at
l = 1, [[1, g], [g, g^2 + 1]] at l = 2 and a Cauchy matrix for l >= 3.

The flat constant buffer of the CUDA kernel (``kernel_constants``) is laid
out by ``constant_layout``; ``csrc/anemoi.cu`` reads the same order.
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
class AnemoiConfig:
    """Parameters of the Anemoi permutation and the duplex sponge geometry.
    ``rc_x``/``rc_y``: ``rounds`` rows of l constants; ``mat_x``: the l x l
    diffusion matrix; ``g``: the generator of the Flystel quadratics."""

    field: FieldSpec
    rounds: int
    alpha: int
    g: int
    mat_x: tuple  # (l, l) ints
    rc_x: tuple  # (rounds, l) ints
    rc_y: tuple  # (rounds, l) ints
    rate: int
    capacity: int = 1

    def __post_init__(self):
        t = self.rate + self.capacity
        p = self.field.modulus
        if t < 2 or t % 2 != 0:
            raise ValueError(f"Anemoi state width must be even; got t={t}")
        lcol = t // 2
        if math.gcd(self.alpha, p - 1) != 1:
            raise ValueError(
                f"alpha={self.alpha} is not invertible mod p-1; the inverse "
                f"power map x^(1/alpha) does not exist over {self.field.name}"
            )
        if self.rounds < 1:
            raise ValueError("rounds must be >= 1")
        if self.g % p == 0:
            raise ValueError("g must be non-zero mod p")
        for name, rc in (("rc_x", self.rc_x), ("rc_y", self.rc_y)):
            if len(rc) != self.rounds:
                raise ValueError(f"{name} must have rounds rows")
            for row in rc:
                if len(row) != lcol:
                    raise ValueError(f"each {name} row must have l entries")
        if len(self.mat_x) != lcol or any(len(r) != lcol for r in self.mat_x):
            raise ValueError("mat_x must be l x l")
        if lcol == 1 and self.mat_x[0][0] % p != 1:
            # every tier skips the 1 x 1 product at l = 1
            raise ValueError("mat_x must be the identity at l = 1")

    @property
    def t(self) -> int:
        """State width (rate + capacity = 2l)."""
        return self.rate + self.capacity

    @property
    def l(self) -> int:  # noqa: E743 (the paper's name)
        """Column length t / 2: the number of Flystel pairs."""
        return self.t // 2

    @property
    def inv_alpha(self) -> int:
        """The inverse power-map exponent alpha^{-1} mod p-1."""
        return pow(self.alpha, -1, self.field.modulus - 1)

    @property
    def g_inv(self) -> int:
        """g^{-1} mod p (the constant term of Q_gamma)."""
        return pow(self.g, -1, self.field.modulus)

    def oracle_sponge(self):
        """Scalar python-int duplex sponge over this permutation."""
        from .oracle import OracleAnemoiSponge

        return OracleAnemoiSponge(self)


@functools.lru_cache(maxsize=None)
def window(cfg: AnemoiConfig) -> int:
    """Kernel 7's window (``montgomery.window_for``) for x^(1/alpha): the l
    chains of a lane at the kernel's registers, or one chain where the
    kernel runs one Flystel pair at a time (``pairwise``)."""
    L = cfg.field.nlimbs
    chains = 1 if pairwise(cfg) else cfg.l
    return window_for(cfg.inv_alpha, L, chains, registers("sponge_anemoi", 2 * cfg.l, L))


def pairwise(cfg: AnemoiConfig) -> bool:
    """``csrc/anemoi.cu`` kPairwise: a wide state (``montgomery.wide_state``)
    of more than two pairs runs the Flystel one pair at a time."""
    return wide_state(2 * cfg.l, cfg.field.nlimbs) and cfg.l > 2


def schedule(cfg: AnemoiConfig) -> list[int]:
    """``montgomery.window_schedule`` of 1/alpha at ``window``."""
    return window_schedule(cfg.inv_alpha, window(cfg))


def constant_layout(cfg: AnemoiConfig):
    """Sections of the flat int32 constant buffer, in order, limb axis last:
    the modulus and R mod p (plain limbs); rc_x, rc_y, M_x and the Flystel
    scalars g, -g, -g^-1 and -1 (Montgomery limbs); the window schedule of
    1/alpha (``schedule``)."""
    lc, L = cfg.l, cfg.field.nlimbs
    return [
        ("p", (L,)),
        ("one", (L,)),
        ("rc_x", (cfg.rounds, lc, L)),
        ("rc_y", (cfg.rounds, lc, L)),
        ("mat", (lc, lc, L)),
        ("scalars", (4, L)),
        ("inv_window", (len(schedule(cfg)),)),
    ]


@functools.lru_cache(maxsize=None)
def kernel_constants(cfg: AnemoiConfig) -> np.ndarray:
    """Flat int32 buffer of ``constant_layout``, built once per config."""
    fs = cfg.field
    p = fs.modulus
    parts = [
        fs.int_to_limbs(p),
        fs.int_to_limbs(fs.r_mod_p),
        mont_limb_rows(fs, cfg.rc_x),
        mont_limb_rows(fs, cfg.rc_y),
        mont_limb_rows(fs, cfg.mat_x),
        mont_limb_rows(fs, [[cfg.g, -cfg.g % p, -cfg.g_inv % p, p - 1]]),
        np.asarray(schedule(cfg), dtype=np.int64),
    ]
    return np.concatenate([np.asarray(a).reshape(-1) for a in parts]).astype(np.int32)


def unpack_constants(cfg: AnemoiConfig, buf):
    """Views of a (device) constant buffer by section, each with a trailing
    batch axis of 1."""
    return unpack_layout(constant_layout(cfg), buf)
