"""Static worst-case value simulation of the two kernels' schedules.

Counterpart of ``_sparse_value_bound`` (``sponge_tpu/ops/pallas_cios.py:509-556``).
The kernels keep field values lazily reduced: a Montgomery product leaves a
value below ``a * b / R + p``, an addition is carried but not reduced, and in
the sparse partial phase elements 1..t-1 grow by about 2p per round.  A value
is held exactly as long as it stays below R (limbs carried, top limb below
2^24); the single conditional subtraction at the end makes the output
canonical only if the last value is below 2p.  ``check_kernel_bounds``
replays each kernel's schedule on exclusive integer bounds and raises when
either condition could fail, so a config that could overflow never launches.
It also bounds the 64-bit REDC column accumulators.
"""

from __future__ import annotations

import functools

from ..fields import LIMB_BITS
from ..poseidon.config import PoseidonConfig


class _Sim:
    """Exclusive value bounds through one schedule, tracking the maximum."""

    def __init__(self, cfg: PoseidonConfig):
        self.p = cfg.field.modulus
        self.R = cfg.field.r
        self.alpha = cfg.alpha
        self.vmax = 0

    def _see(self, v: int) -> int:
        self.vmax = max(self.vmax, v)
        return v

    def add(self, a: int, b: int) -> int:
        return self._see(a + b - 1)

    def mul(self, a: int, b: int) -> int:
        # REDC of T <= (a-1)(b-1): result < T/R + p.
        return self._see((a - 1) * (b - 1) // self.R + self.p + 1)

    def dot(self, xs) -> int:
        # One REDC over sum_j x_j * c_j with canonical constants c_j < p.
        return self._see(sum((x - 1) * (self.p - 1) for x in xs) // self.R + self.p + 1)

    def sbox(self, v: int) -> int:
        acc = v
        for bit in bin(self.alpha)[3:]:
            acc = self.mul(acc, acc)
            if bit == "1":
                acc = self.mul(acc, v)
        return acc

    def full_round(self, xs):
        xs = [self.sbox(self.add(x, self.p)) for x in xs]
        return [self.dot(xs)] * len(xs)

    def partial_round(self, xs):
        xs = [self.add(x, self.p) for x in xs]
        xs[0] = self.sbox(xs[0])
        return [self.dot(xs)] * len(xs)


def simulate(cfg: PoseidonConfig, optimized: bool):
    """(largest exclusive bound reached, exclusive bound of the output before
    the final subtraction) for the dense (``optimized=False``) or the
    sparse-factorized kernel schedule, from canonical inputs."""
    sim = _Sim(cfg)
    p = sim.p
    half = cfg.full_rounds // 2
    xs = [p] * cfg.t
    for _ in range(half):
        xs = sim.full_round(xs)
    if optimized:
        # First partial round: ark + sbox0; then R_P - 1 sparse rounds where
        # elements 1..t-1 accumulate a reduced product and a constant.
        xs = [sim.add(x, p) for x in xs]
        xs[0] = sim.sbox(xs[0])
        for _ in range(cfg.partial_rounds - 1):
            xs = [sim.add(x, p) for x in xs]
            out0 = sim.dot(xs)
            rest = [sim.add(sim.mul(xs[0], p), x) for x in xs[1:]]
            xs = [sim.sbox(out0)] + rest
        xs = [sim.dot(xs)] * cfg.t
    else:
        for _ in range(cfg.partial_rounds):
            xs = sim.partial_round(xs)
    for _ in range(cfg.full_rounds - half):
        xs = sim.full_round(xs)
    return sim.vmax, max(xs)


def column_bound(cfg: PoseidonConfig) -> int:
    """Largest REDC column: t products per limb of a row dot plus the REDC
    products (each below 2^48), plus the carry from the column below."""
    L = cfg.field.nlimbs
    limb = (1 << LIMB_BITS) - 1
    return (cfg.t + 1) * L * limb * limb + (1 << (64 - LIMB_BITS))


@functools.lru_cache(maxsize=None)
def check_kernel_bounds(cfg: PoseidonConfig, optimized: bool) -> int:
    """Raise ValueError unless the kernel schedule is exact for ``cfg``;
    returns the largest value bound (for reports and tests)."""
    fs = cfg.field
    vmax, vout = simulate(cfg, optimized)
    if vmax > fs.r:
        raise ValueError(
            f"{fs.name} t={cfg.t}: lazily reduced values can reach R "
            f"({vmax / fs.modulus:.1f}p vs R = {fs.r / fs.modulus:.1f}p)"
        )
    if vout > 2 * fs.modulus:
        raise ValueError(f"{fs.name} t={cfg.t}: output bound {vout / fs.modulus:.2f}p >= 2p")
    if column_bound(cfg) >= 1 << 63:
        raise ValueError(f"{fs.name} t={cfg.t}: REDC columns can overflow 63 bits")
    return vmax
