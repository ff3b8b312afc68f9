"""Static worst-case value simulation of the CUDA kernels' schedules.

Counterpart of ``_sparse_value_bound`` (``sponge_tpu/ops/pallas_cios.py:509-556``),
``_fold_count`` (``pallas_p2.py:70-88``) and ``_check_kernel_value_bounds``
(``pallas_rescue.py:259-307``), derived for the port's 24-bit limbs.
The kernels keep field values lazily reduced: a Montgomery product leaves a
value below ``a * b / R + p``, an addition is carried but not reduced, and in
the sparse partial phase elements 1..t-1 grow by about 2p per round.  A value
is held exactly as long as it stays below R (limbs carried, top limb below
2^24); the single conditional subtraction at the end makes the output
canonical only if the last value is below 2p.  ``check_kernel_bounds``
replays each Poseidon kernel's schedule on exclusive integer bounds and
raises when either condition could fail, so a config that could overflow
never launches.  It also bounds the 64-bit REDC column accumulators.

Poseidon2 (kernel 3) has two bodies (``check_p2_bounds``).  Its limb body
never reduces in its linear layers: limb words hold small-integer
combinations of 24-bit limbs and values grow past R.  Its simulation
(``p2_plan``) tracks each element's value bound and limb-word bound through
the kernel's exact schedule, derives how many top-carry rho-folds each
round needs before its S-boxes and after each S-box product to bring
values back under R, and checks that every 32-bit word stays below 2^32.
Its one-word body (fields below 2^31) is replayed by ``_P2WordSim``.
Rescue, GMiMC, Griffin and Anemoi (kernels 5, 8, 6, 7) replay their
schedules on (value, limb word) bounds through ``_Replay``: GMiMC's limb
body keeps its rest-branch adds uncarried for the whole permutation (its
two-word Goldilocks body is replayed by ``_GmimcWordSim``), and GMiMC's,
Griffin's and Anemoi's optional reductions are taken where the replay
without them fails.  The TPU kernels' 12-bit fixpoints
(``pallas_gmimc.py:67``, ``pallas_griffin.py:75``, ``pallas_anemoi.py:69``)
do not carry over to the port's 24-bit plan.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

from ..anemoi.config import window as anemoi_window
from ..fields import LIMB_BITS, one_word, word_body
from ..griffin.config import window as griffin_window
from ..poseidon.config import PoseidonConfig
from ..rescue.config import windows as rescue_windows
from .montgomery import fold_bound, fold_count, ladder_schedule, window_schedule


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
            # kernel 1 adds x_i into the columns of col0_i * x0 before the
            # carry (sparse_linear): the same value as the product plus x_i
            rest = [sim.add(sim.mul(xs[0], p), x) for x in xs[1:]]
            xs = [sim.sbox(out0)] + rest
        xs = [sim.dot(xs)] * cfg.t
    else:
        for _ in range(cfg.partial_rounds):
            xs = sim.partial_round(xs)
    for _ in range(cfg.full_rounds - half):
        xs = sim.full_round(xs)
    return sim.vmax, max(xs)


def column_bound(t: int, L: int) -> int:
    """Largest REDC column: t products per limb of a row dot plus the REDC
    products (each below 2^48), plus the carry from the column below."""
    limb = (1 << LIMB_BITS) - 1
    return (t + 1) * L * limb * limb + (1 << (64 - LIMB_BITS))


def sqr_column_bound(L: int) -> int:
    """Largest column of ``mont_sqr``: at most L products of a limb by a
    doubled limb (below 2^25), the L REDC products (each below 2^48), and
    the carry from the column below."""
    limb = (1 << LIMB_BITS) - 1
    return L * limb * (2 * limb) + L * limb * limb + (1 << (64 - LIMB_BITS))


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
    if column_bound(cfg.t, fs.nlimbs) >= 1 << 63:
        raise ValueError(f"{fs.name} t={cfg.t}: REDC columns can overflow 63 bits")
    if sqr_column_bound(fs.nlimbs) >= 1 << 63:  # both kernels square with mont_sqr
        raise ValueError(f"{fs.name}: squaring columns can overflow 63 bits")
    return vmax


# ---------------------------------------------------------------------------
# Poseidon2 (csrc/poseidon2.cu)
# ---------------------------------------------------------------------------

_W24 = 1 << LIMB_BITS  # exclusive bound of a carried limb
_W32 = 1 << 32

# Most rho-folds kernel 3's limb body takes before a round's S-boxes (and at
# the exit), and after each S-box product (csrc/poseidon2.cu kMaxFolds,
# kMaxSboxFolds).
P2_FOLD_CAPS = (2, 1)

# Poseidon2's 4 x 4 block of M_E (ePrint 2023/323, section 5.1); M_E at
# t = 4k, k >= 2, is circ(2 M4, M4, ..., M4).
M4 = ((5, 7, 1, 3), (4, 6, 1, 1), (1, 3, 5, 7), (1, 1, 4, 6))


@dataclass(frozen=True)
class P2Plan:
    """How kernel 3 runs one config.  ``body`` "limb": Montgomery limbs,
    ``folds`` the top-carry rho-folds per round (before the round's
    S-boxes, after each S-box product), then (the exit's, 0); ``min_folds``
    the folds one permutation takes when every value is folded only as often
    as it needs; ``vmax`` and ``wmax`` the largest value and limb word.
    ``body`` "word": one 32-bit Montgomery word per element (fields below
    2^31), no folds; ``structured`` whether M_E runs as
    circ(2 M4, M4, ..., M4); ``vmax`` the largest 64-bit row sum and
    ``wmax`` the largest word."""

    body: str
    structured: bool
    folds: tuple
    vmax: int
    wmax: int
    min_folds: int


class _P2Sim:
    """Exclusive (value, limb word) bounds of each element through kernel 3's
    limb body.  With ``folds="minimal"`` each instance folds as often as its
    own value needs, and ``need`` records the most any instance of a round's
    site needed; with a fixed plan (``P2Plan.folds``) every instance of a
    round's site takes that round's count and every constraint is checked.
    ``instances`` counts the folds taken."""

    def __init__(self, cfg, folds):
        fs = cfg.field
        self.cfg = cfg
        self.p, self.R, self.rho, self.L = fs.modulus, fs.r, fs.r_mod_p, fs.nlimbs
        self.minimal = folds == "minimal"
        self.plan = None if self.minimal else folds
        self.need = {}
        self.round = 0
        self.vmax = self.wmax = self.instances = 0

    def _fail(self, msg):
        fs = self.cfg.field
        raise ValueError(f"Poseidon2 kernel, {fs.name} t={self.cfg.t}: {msg}")

    def _see(self, v, w):
        self.vmax, self.wmax = max(self.vmax, v), max(self.wmax, w)
        if w > _W32:
            self._fail(f"a limb word can reach 2^{(w - 1).bit_length()} (>= 2^32)")
        return v, w

    def carried(self, v):
        """A carried value: low limbs below 2^24, the rest in the top word."""
        top = ((v - 1) >> (LIMB_BITS * (self.L - 1))) + 1
        return self._see(v, max(_W24, top))

    def carry_add(self, x, addend):
        """``add_const``/``norm``: one carry pass adding limbs below 2^24."""
        v, w = x
        self._see(v, w + _W24 + ((w + _W24) >> LIMB_BITS))
        return self.carried(v + addend - 1)

    def fold(self, x, site):
        """``site`` 0: before the S-boxes (or the exit's, at round
        ``rounds``); 1: after an S-box product."""
        v, _ = x
        if self.minimal:
            n = fold_count(self.R, self.rho, v)
            key = (self.round, site)
            self.need[key] = max(self.need.get(key, 0), n)
        else:
            n = self.plan[self.round][site]
        self.instances += n
        for _ in range(n):
            cm = (v - 1) // self.R
            self._see(v, (cm + 1) * _W24 + 1)  # low limb + c * rho limb + carry
            v = fold_bound(self.R, self.rho, v)
        return self.carried(v)

    def mul(self, a, b):
        if a[0] > self.R or b[0] > self.R:
            self._fail("a Montgomery product input can reach R")
        return self.carried((a[0] - 1) * (b[0] - 1) // self.R + self.p + 1)

    def sbox(self, x):
        acc = x
        for g in ladder_schedule(self.cfg.alpha):
            for _ in range(abs(g)):
                acc = self.fold(self.mul(acc, acc), 1)
            if g > 0:
                acc = self.fold(self.mul(acc, x), 1)
        return acc

    def lin(self, coeffs, xs):
        if any(c < 0 for c in coeffs):
            self._fail("linear-layer coefficients must be non-negative")
        v = sum(c * (x[0] - 1) for c, x in zip(coeffs, xs)) + 1
        w = sum(c * (x[1] - 1) for c, x in zip(coeffs, xs)) + 1
        return self._see(v, w)

    def external(self, xs):
        return [self.lin(row, xs) for row in self.cfg.mat_e]

    def run(self):
        cfg, p = self.cfg, self.p
        t, half = cfg.t, cfg.full_rounds // 2
        xs = self.external([self.carried(p)] * t)
        for r in range(cfg.rounds):
            self.round = r
            if r < half or r >= half + cfg.partial_rounds:
                xs = [self.fold(self.carry_add(x, p), 0) for x in xs]
                xs = self.external([self.sbox(x) for x in xs])
                continue
            xs = [self.fold(self.carry_add(x, p if e == 0 else 1), 0) for e, x in enumerate(xs)]
            xs[0] = self.sbox(xs[0])
            sigma = self.lin([1] * t, xs)
            if cfg.small_diag:
                xs = [self.lin([1, d], [sigma, x]) for d, x in zip(cfg.diag_m1, xs)]
            else:
                xs = [self.lin([1, 1], [sigma, self.mul(x, (p, _W24))]) for x in xs]
        self.round = cfg.rounds
        xs = [self.fold(self.carry_add(x, 1), 0) for x in xs]
        out = max(self.mul(x, (p, _W24))[0] for x in xs)  # Montgomery product by 1
        if out > 2 * p:
            self._fail(f"output bound {out / p:.2f}p >= 2p")


@functools.lru_cache(maxsize=None)
def p2_plan(cfg) -> P2Plan:
    """Kernel 3's limb body for ``cfg``: each round's fold counts, the most
    any instance of the round's site needs in a replay that folds every
    value as often as it needs (a plan with more folds never reaches a
    larger bound), then verified by a replay with those counts fixed.
    Raises ValueError if no plan is exact (a limb word could reach 2^32, a
    product input R, the output 2p, or a count its cap)."""
    minimal = _P2Sim(cfg, "minimal")
    minimal.run()
    folds = tuple((minimal.need.get((r, 0), 0), minimal.need.get((r, 1), 0)) for r in range(cfg.rounds))
    folds += ((minimal.need.get((cfg.rounds, 0), 0), 0),)
    for pre, sbox in folds:
        if pre > P2_FOLD_CAPS[0] or sbox > P2_FOLD_CAPS[1]:
            raise ValueError(f"Poseidon2 kernel, {cfg.field.name} t={cfg.t}: a site needs more folds than "
                             f"the kernel takes ({P2_FOLD_CAPS})")
    sim = _P2Sim(cfg, folds)
    sim.run()
    if column_bound(1, cfg.field.nlimbs) >= 1 << 63 or sqr_column_bound(cfg.field.nlimbs) >= 1 << 63:
        raise ValueError(f"{cfg.field.name}: REDC columns can overflow 63 bits")
    return P2Plan("limb", False, folds, sim.vmax, sim.wmax, minimal.instances)


def m4_structured(mat_e) -> bool:
    """Whether M_E is circ(2 M4, M4, ..., M4) over k >= 2 chunks of four."""
    t = len(mat_e)
    return t % 4 == 0 and t >= 8 and all(
        mat_e[i][j] == (2 if i // 4 == j // 4 else 1) * M4[i % 4][j % 4] for i in range(t) for j in range(t)
    )


_WIDE_LIMIT = 1 << 40  # reduce_wide's input range


class _P2WordSim:
    """Exclusive bounds through kernel 3's one-word body
    (``csrc/poseidon2.cu`` ``poseidon2_word_kernel``): a product
    (a b + q p) / 2^32 with a b + q p below 2^64 and its result below
    a b / 2^32 + p; a conditional subtraction of an input below 2p; a 64-bit
    row sum below 2^40, which ``reduce_wide`` takes below 2p; every word
    below 2^32."""

    def __init__(self, cfg):
        self.cfg, self.p = cfg, cfg.field.modulus
        self.vmax = self.wmax = 0
        if not (1 << 16) < self.p < 1 << 31:
            self._fail("the one-word body needs 2^16 < p < 2^31")

    def _fail(self, msg):
        raise ValueError(f"Poseidon2 one-word kernel, {self.cfg.field.name} t={self.cfg.t}: {msg}")

    def word(self, v):
        self.wmax = max(self.wmax, v)
        if v > _W32:
            self._fail(f"a word can reach 2^{(v - 1).bit_length()} (>= 2^32)")
        return v

    def mul(self, a, b):
        if (a - 1) * (b - 1) + (_W32 - 1) * self.p >= 1 << 64:
            self._fail("a product's a b + q p can reach 2^64")
        return self.word((a - 1) * (b - 1) // _W32 + self.p + 1)

    def sub(self, v):
        if v > 2 * self.p:
            self._fail("a conditional subtraction's input can reach 2p")
        return min(v, self.p)

    def add(self, a, b):
        return self.word(a + b - 1)

    def reduce(self, coeffs, xs):
        """A 64-bit sum of small-integer multiples, reduced below 2p."""
        s = sum(c * (x - 1) for c, x in zip(coeffs, xs)) + 1
        self.vmax = max(self.vmax, s)
        if s > _WIDE_LIMIT:
            self._fail(f"a row sum can reach 2^{(s - 1).bit_length()} (reduce_wide takes below 2^40)")
        return self.word(2 * self.p)

    def sbox(self, x):
        acc = x
        for g in ladder_schedule(self.cfg.alpha):
            for _ in range(abs(g)):
                acc = self.sub(self.mul(acc, acc))
            if g > 0:
                acc = self.sub(self.mul(acc, x))
        return acc

    def permutation(self, xs):
        """The bounds of t words entering the first M_E -> those leaving
        the last one."""
        cfg, p = self.cfg, self.p
        t, half = cfg.t, cfg.full_rounds // 2
        external = lambda xs: [self.reduce(row, xs) for row in cfg.mat_e]  # noqa: E731
        xs = external(xs)
        for r in range(cfg.rounds):
            if r < half or r >= half + cfg.partial_rounds:
                xs = external([self.sbox(self.sub(self.add(self.sub(x), p))) for x in xs])
                continue
            xs[0] = self.sbox(self.sub(self.add(self.sub(xs[0]), p)))
            sigma = self.sub(self.reduce([1] * t, xs))
            xs = [self.add(sigma, self.sub(self.mul(x, p))) for x in xs]
        return xs

    def run(self, boundary_sub=True):
        """The overwrite sponge's launch: a chunk's rows enter through the
        product by 2^16 mod p; at a chunk boundary each row is a new
        chunk's or carried from the last M_E (below 2p), which the kernel
        takes through one conditional subtraction (``boundary_sub``); the
        exit's product by 2^48 mod p.  The second permutation covers every
        later one: it starts from the same bounds."""
        cfg, p = self.cfg, self.p
        if any(c < 0 for row in cfg.mat_e for c in row):
            self._fail("M_E entries must be non-negative")
        entry = self.mul(p, p)
        xs = self.permutation([entry] * cfg.t)
        xs = self.permutation([max(entry, self.sub(x) if boundary_sub else x) for x in xs])
        for x in xs:
            self.sub(self.mul(x, p))  # canonical


@functools.lru_cache(maxsize=None)
def check_p2_bounds(cfg) -> P2Plan:
    """Kernel 3's plan for ``cfg``: the one-word body for a field below
    2^31 (``fields.one_word``), with the structured M_E where the
    matrix is circ(2 M4, M4, ..., M4), proved by a replay of its bounds;
    else the limb body's ``p2_plan``.  Raises ValueError if the field's body
    does not admit the config (no fallback to the other)."""
    if not one_word(cfg.field):
        return p2_plan(cfg)
    sim = _P2WordSim(cfg)
    sim.run()
    return P2Plan("word", m4_structured(cfg.mat_e), (), sim.vmax, sim.wmax, 0)


# ---------------------------------------------------------------------------
# Rescue-Prime, GMiMC, Griffin and Anemoi (csrc/rescue.cu, csrc/gmimc.cu,
# csrc/griffin.cu, csrc/anemoi.cu)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class KernelPlan:
    """What a family kernel's replay found: whether the kernel must take its
    optional reduction (Griffin's post-linear, Anemoi's post-PHT Montgomery
    product by 1, GMiMC's front reduction of its S-box input), and the
    largest value and 32-bit limb word bound reached."""

    reduce: bool
    vmax: int
    wmax: int


class _Replay:
    """Exclusive (value, limb word) bounds of one element through a kernel's
    schedule, as the ``mont.cuh`` routines the kernel calls leave them.
    A carried element has limbs 0..L-2 below 2^24 and the rest of its value
    in the top word; ``lin`` is a word-wise small-integer combination with
    no carry (``small_mat_apply``, GMiMC's deferred adds)."""

    def __init__(self, what: str, fs, terms: int = 1):
        self.what, self.p, self.R, self.L = what, fs.modulus, fs.r, fs.nlimbs
        self.vmax = self.wmax = 0
        if column_bound(terms, self.L) >= 1 << 63:
            self._fail("REDC columns can overflow 63 bits")
        self.const = self.carried(self.p)  # a canonical constant of the buffer

    def _fail(self, msg):
        raise ValueError(f"{self.what}: {msg}")

    def _see(self, v, w):
        self.vmax, self.wmax = max(self.vmax, v), max(self.wmax, w)
        if w > _W32:
            self._fail(f"a limb word can reach 2^{(w - 1).bit_length()} (>= 2^32)")
        return v, w

    def carried(self, v):
        top = ((v - 1) >> (LIMB_BITS * (self.L - 1))) + 1
        return self._see(v, max(_W24, top))

    def lin(self, coeffs, xs):
        v = sum(c * (x[0] - 1) for c, x in zip(coeffs, xs)) + 1
        return self._see(v, sum(c * (x[1] - 1) for c, x in zip(coeffs, xs)) + 1)

    def carry_pass(self, x):
        self._see(x[0], x[1] + 255)  # a word plus the carry from below
        return self.carried(x[0])

    def add(self, x, y):
        """``add_lazy``: word plus word plus carry, carried as it goes."""
        self._see(x[0], x[1] + y[1] + 255)
        return self.carried(x[0] + y[0] - 1)

    def mul(self, a, b):
        for v, w in (a, b):
            if v > self.R:
                self._fail(
                    f"a Montgomery product input can reach R ({v / self.p:.1f}p vs "
                    f"R = {self.R / self.p:.1f}p)"
                )
            if w > _W24:
                self._fail("a Montgomery product input is not carried")
        return self.carried((a[0] - 1) * (b[0] - 1) // self.R + self.p + 1)

    def row(self, xs):
        """``mont_row``: the terms' products by canonical constants summed
        lazily, one REDC."""
        for x in xs:
            self.mul(x, self.const)
        return self.carried(sum((x[0] - 1) * (self.p - 1) for x in xs) // self.R + self.p + 1)

    def pow(self, x, e, square=None):
        """``mont_pow`` (squarings by ``mul``) or, with ``square=self.sqr``,
        ``pow_sqr``: the run-length schedule of e."""
        square = square or (lambda a: self.mul(a, a))
        acc = x
        for g in ladder_schedule(e):
            for _ in range(abs(g)):
                acc = square(acc)
            if g > 0:
                acc = self.mul(acc, x)
        return acc

    def sqr(self, x):
        """``mont_sqr``: the bound of ``mul(x, x)``; its columns hold
        products by doubled limb words (below 2^25 for a carried input)."""
        if sqr_column_bound(self.L) >= 1 << 63:
            self._fail("squaring columns can overflow 63 bits")
        return self.mul(x, x)

    def pow_window(self, x, e, w):
        """``pow_window``: the odd-power table (x^2 = sqr(x), x^3 = x^2 x,
        then x^(2j+1) = x^(2j-1) x^2), then the chain of
        ``window_schedule(e, w)`` from its seed."""
        table = [x]
        if w > 1:
            x2 = self.sqr(x)
            table.append(self.mul(x2, x))
            while len(table) < 1 << (w - 1):
                table.append(self.mul(table[-1], x2))
        sched = window_schedule(e, w)
        acc = table[sched[0]]
        for squarings, j in zip(sched[1::2], sched[2::2]):
            for _ in range(squarings):
                acc = self.sqr(acc)
            if j >= 0:
                acc = self.mul(acc, table[j])
        return acc

    def reduce_front(self, x):
        """``reduce_front`` (kernel 8): f - q p for a carried f with top word
        T = f >> S (S = 24 (L - 1)), q = floor(T qinv / 2^32) and qinv =
        floor((2^32 - 1) / (p_top + 1)), so q p <= f.  Over the values with
        q = k the largest result is at the largest such T, and it grows
        with k (a step of q adds at least (p_top + 1) 2^S - p > 0), so the
        exclusive bound is the larger of the top value's and the top T's of
        q = kmax - 1."""
        v, _ = x
        S = LIMB_BITS * (self.L - 1)
        qinv = (_W32 - 1) // ((self.p >> S) + 1)
        q = lambda top: top * qinv >> 32
        top = (v - 1) >> S
        kmax = q(top)
        out = v - kmax * self.p
        if kmax:
            below = -(-kmax * _W32 // qinv) - 1  # the largest T with q(T) = kmax - 1
            out = max(out, ((below + 1) << S) - q(below) * self.p)
        return self.carried(out)

    def exit(self, x):
        """One Montgomery product by 1, then one conditional subtraction."""
        self.subtract_once(self.mul(x, self.const))

    def subtract_once(self, x):
        """The store's one conditional subtraction: canonical only below 2p."""
        if x[0] > 2 * self.p:
            self._fail("output bound >= 2p")


@functools.lru_cache(maxsize=None)
def check_rescue_bounds(cfg) -> int:
    """Replay kernel 5's schedule on exclusive value bounds: both window
    chains (``rescue.config.windows``) product by product, tables included,
    the MDS row dots (one REDC each) and the constant adds, in the config's
    round order, then the exit: after Rescue-Prime's constant add the
    product by the Montgomery form of 1, after Rescue Prime Optimized's
    last chain (``mds_first``) nothing but the store's conditional
    subtraction.  Raises ValueError if a product input could reach R, the
    output 2p, or a column 2^63; returns the largest value bound."""
    fs, t = cfg.field, cfg.t
    sim = _Replay(f"Rescue kernel, {fs.name} t={t}", fs, terms=t)
    w_alpha, w_inv = rescue_windows(cfg)
    mds_first = getattr(cfg, "mds_first", False)  # a duck-typed config without it: Rescue-Prime's order
    x = sim.const
    for h in range(2 * cfg.rounds):
        chain = (cfg.inv_alpha, w_inv) if h % 2 else (cfg.alpha, w_alpha)
        if mds_first:
            x = sim.pow_window(sim.add(sim.row([x] * t), sim.const), *chain)
        else:
            x = sim.add(sim.row([sim.pow_window(x, *chain)] * t), sim.const)
    if mds_first:
        sim.subtract_once(x)
    else:
        sim.exit(x)
    return sim.vmax


def _gmimc_replay(cfg, reduce_front: bool) -> KernelPlan:
    fs, t = cfg.field, cfg.t
    sim = _Replay(f"GMiMC kernel, {fs.name} t={t} rounds={cfg.rounds}", fs)
    xs = [sim.const] * t
    for r in range(cfg.rounds):
        j = r % t  # the front's register; the kernel never moves the state
        f = sim.add(xs[j], sim.const)
        if reduce_front:
            f = sim.reduce_front(f)
        f = sim.pow(f, cfg.alpha, square=sim.sqr)
        xs = [x if i == j else sim.lin((1, 1), (x, f)) for i, x in enumerate(xs)]
    for x in xs:
        sim.exit(sim.carry_pass(x))
    return KernelPlan(reduce_front, sim.vmax, sim.wmax)


@functools.lru_cache(maxsize=None)
def check_gmimc_bounds(cfg) -> KernelPlan:
    """Replay kernel 8's limb body.  Each round copies the front element,
    adds c_r (carried), takes the front reduction if the plan has it, and
    raises the copy to alpha; F is added word by word, uncarried, to the
    other t-1 elements, which keep every such add until the exit: values
    grow by F per add, and limb words by up to 2^24.  The exit is a carry
    pass and a Montgomery product by 1.  Without the reduction the S-box
    input grows with the elements and F with it: where that replay fails
    (BLS12-381 at t = 4..9, whose products reach 611-899p of R = 565p), the
    plan takes the reduction (``reduce``).  Raises ValueError if neither
    plan keeps every product input below R, every limb word below 2^32 and
    the output below 2p."""
    try:
        return _gmimc_replay(cfg, False)
    except ValueError:
        return _gmimc_replay(cfg, True)


_W64 = 1 << 64
_EPS = (1 << 32) - 1  # 2^64 mod p at Goldilocks


class _GmimcWordSim:
    """Exclusive bounds through kernel 8's two-word body (``csrc/gmimc.cu``
    ``gmimc_word_kernel``, Goldilocks only).  An element is (v, e): its
    64-bit word below v and its excess word below e (the 2^64s its deferred
    adds carried out; e = 1 is no excess).  A product's inputs carry no
    excess; its partial products, middle column and high word stay below
    2^64, and ``gl_reduce``'s borrow and carry fix-ups cannot wrap.  An add
    counts one carry into the excess, below 2^32; a fold takes the excess in
    as k (2^32 - 1) with one carry fix-up that cannot wrap.  ``emax`` is the
    largest excess reached."""

    def __init__(self, cfg):
        self.cfg, self.p = cfg, cfg.field.modulus
        self.emax = 0
        if not word_body(cfg.field):
            self._fail("the two-word body needs p = 2^64 - 2^32 + 1")

    def _fail(self, msg):
        cfg = self.cfg
        raise ValueError(f"GMiMC two-word kernel, {cfg.field.name} t={cfg.t} rounds={cfg.rounds}: {msg}")

    def _word(self, v, what):
        if v > _W64:
            self._fail(f"{what} can reach 2^{(v - 1).bit_length()} (>= 2^64)")
        return v

    def _halves(self, x):
        """The largest low and high 32-bit halves of a product input."""
        v, e = x
        if e > 1:
            self._fail("a product input carries excess (a fold is missing)")
        self._word(v, "a product input")
        return min(v - 1, _EPS), (v - 1) >> 32

    def reduce(self, hi):
        """``GL_REDUCE_N`` of a 128-bit value whose high word hh:hl is below
        ``hi``: V = lo - hh + hl (2^32 - 1) lies in [-hh, 2^64 + hl (2^32 -
        1)), so its 96-bit top word is -1, 0 or 1, and adding its 2^64 back
        as 2^32 - 1 must leave a 64-bit word: at least 2^32 - 1 when V < 0,
        below 2^64 - (2^32 - 1) when V >= 2^64."""
        hh, hl = (self._word(hi, "a product's high word") - 1) >> 32, min(hi - 1, _EPS)
        if hh > 0 and _W64 - hh < _EPS:
            self._fail("the reduction's fix-up of a negative sum can wrap")
        if hl * _EPS - 1 + _EPS >= _W64:
            self._fail("the reduction's fix-up of a sum past 2^64 can wrap")
        return _W64, 1

    def mul(self, a, b):
        """``gl_mul``: p01 + p00 / 2^32 + (p10 mod 2^32) below 2^64, then the
        high word p11 + mid / 2^32 + p10 / 2^32."""
        (a0, a1), (b0, b1) = self._halves(a), self._halves(b)
        p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
        mid = self._word(p01 + (p00 >> 32) + min(p10, _EPS) + 1, "a product's middle column") - 1
        return self.reduce(p11 + (mid >> 32) + (p10 >> 32) + 1)

    def sqr(self, a):
        """``gl_sqr``: the high word p11 + 2 p01 / 2^32 + the low add's carry."""
        a0, a1 = self._halves(a)
        return self.reduce(a1 * a1 + ((a0 * a1) >> 31) + 2)

    def pow(self, x, e):
        acc = x
        for g in ladder_schedule(e):
            for _ in range(abs(g)):
                acc = self.sqr(acc)
            if g > 0:
                acc = self.mul(acc, x)
        return acc

    def add(self, x, f):
        """``gl_add_deferred``: the 64-bit add wraps, its carry enters the
        excess word."""
        if f[1] > 1:
            self._fail("a deferred add's addend carries excess")
        e = x[1] + 1
        self.emax = max(self.emax, e - 1)
        if e > _W32:
            self._fail("an excess word can reach 2^32")
        return _W64, e

    def fold(self, x, c):
        """``gl_fold`` with a constant below ``c``: k = excess + the add's
        carry in a 32-bit word, the sum plus k (2^32 - 1) below 2^65 and,
        past 2^64, its fix-up by 2^32 - 1 below 2^64."""
        v, e = x
        k = e - 1 + int(v - 1 + c - 1 >= _W64)
        if k >= _W32:
            self._fail("a fold's k (2^32 - 1) can reach 2^64")
        if k * _EPS + _EPS > _W64:
            self._fail("a fold's carry fix-up can wrap")
        return _W64, 1

    def run(self):
        cfg, p = self.cfg, self.p
        xs = [self.mul((p, 1), (p, 1))] * cfg.t  # the entry's product by 2^-72 mod p
        for r in range(cfg.rounds):
            j = r % cfg.t  # the front's register; the kernel never moves the state
            f = self.pow(self.fold(xs[j], p), cfg.alpha)
            xs = [x if i == j else self.add(x, f) for i, x in enumerate(xs)]
        for x in xs:  # the exit: fold, the product by 2^72 mod p, one subtraction
            if self.mul(self.fold(x, 1), (p, 1))[0] > 2 * p:
                self._fail("the exit's conditional subtraction takes an input of 2p or more")


@functools.lru_cache(maxsize=None)
def check_gmimc_word_bounds(cfg) -> int:
    """Replay kernel 8's two-word body (Goldilocks) on exclusive bounds:
    every partial product, middle column and high word below 2^64, every
    reduction's and fold's fix-up unable to wrap, every excess word below
    2^32, no product input carrying excess, the exit's subtraction input
    below 2p.  Raises ValueError if any could fail (or the field is not
    Goldilocks); returns the largest excess an element reaches."""
    sim = _GmimcWordSim(cfg)
    sim.run()
    return sim.emax



# ---------------------------------------------------------------------------
# Kernel 2's word bodies (csrc/poseidon_dense_words.cu)
# ---------------------------------------------------------------------------

DENSE_WORD_GROUP = 4  # products per 64-bit group sum (kWordGroup)


class _DenseWordSim(_P2WordSim):
    """Exclusive bounds through kernel 2's one-word body
    (``poseidon_dense_word_kernel``): canonical words in and out of every
    step (products and sums below 2p, then ``word_sub``), and each MDS row
    (``word_row``) summed in groups of ``DENSE_WORD_GROUP`` products of
    canonical words by canonical constants, each group sum below 2^64, its
    high words and its low words summed apart, one REDC of the low sum
    (low + q p below 2^64), and the total below 2^40 (``reduce_wide``).
    ``vmax`` is the largest row total."""

    def _fail(self, msg):
        cfg = self.cfg
        raise ValueError(f"Poseidon one-word kernel, {cfg.field.name} t={cfg.t}: {msg}")

    def row(self, xs):
        p, hi, lo = self.p, 0, 0
        for g in range(0, len(xs), DENSE_WORD_GROUP):
            s = sum((x - 1) * (p - 1) for x in xs[g : g + DENSE_WORD_GROUP])  # inclusive
            if s >= _W64:
                self._fail(f"a group sum of {DENSE_WORD_GROUP} products can reach 2^64")
            hi, lo = hi + (s >> 32), lo + min(s, _W32 - 1)
        if lo + (_W32 - 1) * p >= _W64:
            self._fail("the low sum's REDC can reach 2^64")
        total = hi + (lo + (_W32 - 1) * p) // _W32 + 1
        self.vmax = max(self.vmax, total)
        if total > _WIDE_LIMIT:
            self._fail(f"a row total can reach 2^{(total - 1).bit_length()} (reduce_wide takes below 2^40)")
        return self.sub(self.word(2 * p))

    def run(self):
        cfg, p = self.cfg, self.p
        half = cfg.full_rounds // 2
        xs = [self.sub(self.mul(p, p))] * cfg.t  # the entry's product by 2^16 mod p
        for r in range(cfg.rounds):
            xs = [self.sub(self.add(x, p)) for x in xs]
            if half <= r < half + cfg.partial_rounds:
                xs[0] = self.sbox(xs[0])
            else:
                xs = [self.sbox(x) for x in xs]
            xs = [self.row(xs)] * cfg.t  # every row has the same bound
        for x in xs:
            self.sub(self.mul(x, p))  # the exit's product by 2^48 mod p: canonical


@functools.lru_cache(maxsize=None)
def check_dense_word_bounds(cfg: PoseidonConfig) -> int:
    """Replay kernel 2's one-word body on exclusive bounds; raises
    ValueError if a word, group sum or REDC could reach 2^64 or 2^32 as the
    body needs, a row total reach 2^40, or the field not lie in (2^16,
    2^31).  Returns the largest row total."""
    sim = _DenseWordSim(cfg)
    sim.run()
    return sim.vmax


class _DenseGLSim(_GmimcWordSim):
    """Exclusive bounds through kernel 2's two-word body
    (``poseidon_dense_gl_kernel``, Goldilocks only).  An element is (v, 1):
    a 64-bit word below v and no excess word.  ARK (``gl_add``) adds a
    constant below p and brings a carry out of 2^64 back as 2^32 - 1, which
    must not wrap again; a product is ``_GmimcWordSim.mul``/``sqr``; an MDS
    row sums t 128-bit products in five 32-bit words (``gl_mac``) and
    reduces them once (``gl_reduce5``).  ``tmax`` is the largest row sum's
    top word n4."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.tmax = 0

    def _fail(self, msg):
        cfg = self.cfg
        raise ValueError(f"Poseidon two-word kernel, {cfg.field.name} t={cfg.t}: {msg}")

    def add_const(self, x):
        v = self._word(x[0], "an ARK input") - 1 + self.p - 1  # inclusive
        if v >= _W64 and v - _W64 + _EPS >= _W64:
            self._fail("an ARK add's carry fix-up can wrap")
        return _W64, 1

    def reduce5(self, total):
        """``gl_reduce5`` of a sum below ``total``: V = n1:n0 - n3 - n2 +
        (n2 - n4) 2^32 with n2, n3 below 2^32 and n4 below total / 2^128;
        V + 2^64 less 2^32 - 1 must stay non-negative when V < 0, and
        V - 2^64 plus 2^32 - 1 below 2^64 when V >= 2^64."""
        n4 = (total - 1) >> 128
        self.tmax = max(self.tmax, n4)
        if n4 >= _W32:
            self._fail("a row sum can reach 2^160")
        v_min = -2 * (_W32 - 1) - n4 * _W32
        v_max = _W64 - 1 + (_W32 - 1) * _W32
        if v_min + _W64 - _EPS < 0:
            self._fail("the row reduction's fix-up of a negative sum can wrap")
        if v_max - _W64 + _EPS >= _W64:
            self._fail("the row reduction's fix-up of a sum past 2^64 can wrap")
        return _W64, 1

    def row(self, xs):
        p = self.p
        for x in xs:
            self._halves(x)  # a product input: a word, no excess
        return self.reduce5(sum((x[0] - 1) * (p - 1) for x in xs) + 1)

    def run(self):
        cfg, p = self.cfg, self.p
        half = cfg.full_rounds // 2
        xs = [self.mul((p, 1), (p, 1))] * cfg.t  # the entry's product by 2^-72 mod p
        for r in range(cfg.rounds):
            xs = [self.add_const(x) for x in xs]
            if half <= r < half + cfg.partial_rounds:
                xs[0] = self.pow(xs[0], cfg.alpha)
            else:
                xs = [self.pow(x, cfg.alpha) for x in xs]
            xs = [self.row(xs)] * cfg.t
        for x in xs:  # the exit: the product by 2^72 mod p, one subtraction
            if self.mul(x, (p, 1))[0] > 2 * p:
                self._fail("the exit's conditional subtraction takes an input of 2p or more")


@functools.lru_cache(maxsize=None)
def check_dense_gl_bounds(cfg: PoseidonConfig) -> int:
    """Replay kernel 2's two-word body (Goldilocks) on exclusive bounds:
    every product input a word below 2^64 with no excess, every partial
    product, middle column and reduction fix-up in range, every ARK add's
    and row reduction's fix-up unable to wrap.  Raises ValueError if any
    could fail (or the field is not Goldilocks); returns the largest top
    word n4 of a row sum."""
    sim = _DenseGLSim(cfg)
    sim.run()
    return sim.tmax


class _OptGLSim(_DenseGLSim):
    """Exclusive bounds through kernel 1's two-word body
    (``csrc/poseidon_opt_words.cu``, Goldilocks only): the entry (a state
    element plus an absorbed row by ``gl_add``, both canonical, then the
    product by 2^-72 mod p), the full rounds as ``_DenseGLSim``'s, each
    sparse round's row0 dot (``gl_row``) and its x_i + col0_i x0 (x_i in the
    five-word accumulator's low words, the product added by ``gl_mac``,
    ``gl_reduce5``), D, and the exit's one conditional subtraction.  The
    state is two bounds, element 0's and that of elements 1..t-1, which
    every step treats alike, so a replay costs the same at any t.
    ``tmax`` is the largest top word n4 of an accumulator."""

    def _fail(self, msg):
        cfg = self.cfg
        raise ValueError(f"Poseidon two-word sparse kernel, {cfg.field.name} t={cfg.t}: {msg}")

    def row(self, x0, rest):
        """``gl_row`` of a state whose element 0 lies below ``x0`` and the
        others below ``rest``, by constants below p."""
        p, t = self.p, self.cfg.t
        self._halves(x0)  # product inputs: words, no excess
        self._halves(rest)
        return self.reduce5((x0[0] - 1) * (p - 1) + (t - 1) * (rest[0] - 1) * (p - 1) + 1)

    def mac(self, x, y):
        """x + y c for a constant c below p: x in the accumulator's low
        words, the product added by ``gl_mac``, one ``gl_reduce5``."""
        if x[1] > 1:
            self._fail("a sparse accumulator's x_i carries excess")
        self._word(x[0], "a sparse accumulator's x_i")
        self._halves(y)
        return self.reduce5(x[0] - 1 + (y[0] - 1) * (self.p - 1) + 1)

    def full_round(self, x):
        x = self.pow(self.add_const(x), self.cfg.alpha)
        return self.row(x, x)

    def run(self):
        cfg, p = self.cfg, self.p
        half = cfg.full_rounds // 2
        x = self.mul(self.add_const((p, 1)), (p, 1))  # the absorbed add, the product by 2^-72 mod p
        for _ in range(half):
            x = self.full_round(x)
        x0 = self.pow(self.add_const(x), cfg.alpha)  # the first partial round
        rest = self.add_const(x)
        for _ in range(cfg.partial_rounds - 1):
            x0, rest = self.add_const(x0), self.add_const(rest)
            x0, rest = self.pow(self.row(x0, rest), cfg.alpha), self.mac(rest, x0)
        x = self.row(x0, rest)  # D
        for _ in range(cfg.full_rounds - half):
            x = self.full_round(x)
        if self.mul(x, (p, 1))[0] > 2 * p:  # the exit: the product by 2^72 mod p, one subtraction
            self._fail("the exit's conditional subtraction takes an input of 2p or more")


@functools.lru_cache(maxsize=None)
def check_opt_gl_bounds(cfg: PoseidonConfig) -> int:
    """Replay kernel 1's two-word body (Goldilocks) on exclusive bounds:
    every product input a word below 2^64 with no excess, every partial
    product, middle column and reduction fix-up in range, every ARK and
    absorbed add's fix-up unable to wrap, every row and sparse accumulator
    below 2^160 with a fix-up that cannot wrap, the exit's subtraction input
    below 2p.  Raises ValueError if any could fail (or the field is not
    Goldilocks); returns the largest top word n4 of an accumulator."""
    sim = _OptGLSim(cfg)
    sim.run()
    return sim.tmax

# ---------------------------------------------------------------------------
# Kernel 5's two-word body (csrc/rescue_words.cu)
# ---------------------------------------------------------------------------

# The inverse S-box at alpha = 7 (Miden's chain, csrc/rescue_words.cu
# gl_pow_inv7): after x^2, x^4 and x^7 = x^2 x^4 x, runs of squarings of
# the running power, each followed by a product by the named power.
INV7_RUNS = ((3, "x4"), (6, "t3"), (12, "t4"), (6, "t3"), (31, "t6"), (1, "t6"), (2, "x7"))


@dataclass(frozen=True)
class RescueGLPlan:
    """Kernel 5's two-word body for one config (``check_rescue_gl_bounds``):
    ``chain``, alpha = 7's fixed chains (else square-and-multiply over the
    exponents); ``narrow``, the MDS rows' two 64-bit accumulators (else
    ``gl_row``); ``acc``, the largest accumulator bound: a narrow row's
    (exclusive, at most 2^64) or ``gl_row``'s top word n4."""

    chain: bool
    narrow: bool
    acc: int


class _RescueGLSim(_DenseGLSim):
    """Exclusive bounds through kernel 5's two-word body
    (``csrc/rescue_words.cu``, Goldilocks only): the entry (a canonical
    value times 2^-72 mod p), in the config's round order each half-round's
    S-boxes (x^7 and Miden's inverse chain where alpha is 7, else
    square-and-multiply over the exponent's bits), its MDS rows (narrow:
    the elements' low and high 32-bit halves times the entries summed in
    two 64-bit accumulators and reduced once, ``gl_narrow``; else
    ``gl_row``) and its constant adds (``gl_add``), then the exit's one
    conditional subtraction.  Every element takes the same steps, so the
    state is one bound and a replay costs the same at any t.  ``amax`` is
    the largest accumulator bound."""

    def __init__(self, cfg, narrow: bool):
        super().__init__(cfg)
        self.narrow_rows, self.chain = narrow, cfg.alpha == 7
        self.amax = 0
        if narrow:
            entries = [v % self.p for row in cfg.mds for v in row]
            if max(entries) >= _W32:
                self._fail("an MDS entry is no 32-bit word (narrow rows)")
            self.row_sum = max(sum(v % self.p for v in row) for row in cfg.mds)

    def _fail(self, msg):
        cfg = self.cfg
        raise ValueError(f"Rescue two-word kernel, {cfg.field.name} t={cfg.t}: {msg}")

    def pow_bits(self, x, e):
        """``gl_pow64``: MSB-first square-and-multiply over the bits of e."""
        acc = x
        for bit in range(e.bit_length() - 2, -1, -1):
            acc = self.sqr(acc)
            if (e >> bit) & 1:
                acc = self.mul(acc, x)
        return acc

    def pow7(self, x):
        """``gl_pow7``: x^7 = (x^2)^2 (x^2 x)."""
        x2 = self.sqr(x)
        return self.mul(self.sqr(x2), self.mul(x2, x))

    def pow_inv7(self, x):
        """``gl_pow_inv7``: Miden's chain, ``INV7_RUNS``."""
        x2 = self.sqr(x)
        power = {"x4": self.sqr(x2)}
        power["x7"] = self.mul(self.mul(x2, power["x4"]), x)
        acc = power["x4"]
        for (squarings, by), name in zip(INV7_RUNS, ("t3", "t4", "t5", "t6", "t7", "a", "out")):
            for _ in range(squarings):
                acc = self.sqr(acc)
            acc = power[name] = self.mul(acc, power[by])
        return acc

    def sbox(self, x, inverse: bool):
        if self.chain:
            return self.pow_inv7(x) if inverse else self.pow7(x)
        return self.pow_bits(x, self.cfg.inv_alpha if inverse else self.cfg.alpha)

    def narrow(self, x):
        """``gl_narrow`` of a row whose elements lie below ``x``: each
        accumulator (low halves, high halves, times entries summing to
        ``row_sum``) below 2^64, k = hi / 2^32 plus a carry below 2^32
        (k (2^32 - 1) < p, ``gl_add``'s constant), and ``gl_add``'s
        fix-up."""
        self._halves(x)  # the halves of a word with no excess
        lo = min(x[0] - 1, _EPS) * self.row_sum + 1
        hi = ((x[0] - 1) >> 32) * self.row_sum + 1
        self.amax = max(self.amax, lo, hi)
        if max(lo, hi) > _W64:
            self._fail("a narrow row's accumulator can reach 2^64")
        k = ((hi - 1) >> 32) + 1  # inclusive
        if k >= _W32:
            self._fail("a narrow row's 2^64s can reach 2^32")
        v = _W64 - 1 + k * _EPS  # inclusive
        if v >= _W64 and v - _W64 + _EPS >= _W64:
            self._fail("a narrow row's fix-up can wrap")
        return _W64, 1

    def row(self, x):
        if self.narrow_rows:
            return self.narrow(x)
        self._halves(x)
        out = self.reduce5(self.cfg.t * (x[0] - 1) * (self.p - 1) + 1)
        self.amax = max(self.amax, self.tmax)
        return out

    def run(self):
        cfg, p = self.cfg, self.p
        mds_first = getattr(cfg, "mds_first", False)
        x = self.mul((p, 1), (p, 1))  # the entry's product by 2^-72 mod p
        for h in range(2 * cfg.rounds):
            if mds_first:
                x = self.add_const(self.row(x))
            x = self.sbox(x, inverse=bool(h % 2))
            if not mds_first:
                x = self.add_const(self.row(x))
        if self.mul(x, (p, 1))[0] > 2 * p:  # the exit: the product by 2^72 mod p, one subtraction
            self._fail("the exit's conditional subtraction takes an input of 2p or more")


@functools.lru_cache(maxsize=None)
def check_rescue_gl_bounds(cfg) -> RescueGLPlan:
    """Replay kernel 5's two-word body (Goldilocks) on exclusive bounds:
    every product input a word below 2^64 with no excess, every partial
    product, middle column and reduction fix-up in range, every constant
    add's fix-up unable to wrap, the exit's subtraction input below 2p; the
    MDS rows narrow where every entry is a 32-bit word and the narrow
    accumulators stay below 2^64, else ``gl_row``'s, whose sums stay below
    2^160.  Raises ValueError if the body could fail (or the field is not
    Goldilocks); returns the plan it replayed."""
    narrow = True
    try:
        sim = _RescueGLSim(cfg, narrow=True)
        sim.run()
    except ValueError:
        if not word_body(cfg.field):
            raise
        narrow = False
        sim = _RescueGLSim(cfg, narrow=False)
        sim.run()
    return RescueGLPlan(chain=sim.chain, narrow=narrow, acc=sim.amax)


def _griffin_replay(cfg, reduce_linear: bool) -> KernelPlan:
    fs, t = cfg.field, cfg.t
    sim = _Replay(f"Griffin kernel, {fs.name} t={t}", fs)
    c, w = sim.const, griffin_window(cfg)

    def linear(xs, with_rc):
        ys = [sim.lin(row, xs) for row in cfg.mat_e]
        ys = [sim.add(y, c) if with_rc else sim.carry_pass(y) for y in ys]
        return [sim.mul(y, c) for y in ys] if reduce_linear else ys

    xs = linear([c] * t, False)
    for _ in range(cfg.rounds):
        y0, y1 = sim.pow_window(xs[0], cfg.inv_alpha, w), sim.pow(xs[1], cfg.alpha, sim.sqr)
        out = [y0, y1] + xs[2:]
        for i in range(t - 1, 1, -1):  # descending, as the kernel
            terms = [y0, y1] + ([xs[i - 1]] if i >= 3 else [])
            li = sim.carry_pass(sim.lin([i - 1, 1, 1][: len(terms)], terms))
            quad = sim.add(sim.add(sim.sqr(li), sim.mul(li, c)), c)
            out[i] = sim.mul(xs[i], quad)
        xs = linear(out, True)
    for x in xs:
        sim.exit(x)
    return KernelPlan(reduce_linear, sim.vmax, sim.wmax)


@functools.lru_cache(maxsize=None)
def check_griffin_bounds(cfg) -> KernelPlan:
    """Replay kernel 6's schedule: the opening small-integer linear layer
    (limb words unreduced, then carried), per round the window chain on x_0
    (``griffin.config.window``, its table included), x_1^alpha by
    ``pow_sqr``, the quadratic gates from i = t-1 down to 2 (L_i^2 by
    ``mont_sqr``), and the linear layer plus rc.  The linear layer amplifies values by its row sum,
    so where the replay without it fails, the plan takes the post-linear
    Montgomery product by 1 (``reduce``), as the TPU kernel does
    (``pallas_griffin.py:359-364``).  Raises ValueError if neither plan is
    exact."""
    try:
        return _griffin_replay(cfg, False)
    except ValueError:
        return _griffin_replay(cfg, True)


def _anemoi_replay(cfg, reduce_pht: bool) -> KernelPlan:
    fs, lcol = cfg.field, cfg.l
    sim = _Replay(f"Anemoi kernel, {fs.name} l={lcol}", fs, terms=lcol)
    c, w = sim.const, anemoi_window(cfg)

    def diffusion(x, y):
        if lcol > 1:
            x, y = sim.row([x] * lcol), sim.row([y] * lcol)
        y = sim.add(y, x)
        x = sim.add(x, y)
        return (sim.mul(x, c), sim.mul(y, c)) if reduce_pht else (x, y)

    x = y = c  # one bound per column: every pair takes the same schedule
    for _ in range(cfg.rounds):
        x, y = diffusion(sim.add(x, c), sim.add(y, c))
        u = sim.add(sim.add(x, sim.mul(sim.sqr(y), c)), c)
        v = sim.add(y, sim.mul(sim.pow_window(u, cfg.inv_alpha, w), c))
        x, y = sim.add(u, sim.mul(sim.sqr(v), c)), v
    x, y = diffusion(x, y)
    sim.exit(x)
    sim.exit(y)
    return KernelPlan(reduce_pht, sim.vmax, sim.wmax)


@functools.lru_cache(maxsize=None)
def check_anemoi_bounds(cfg) -> KernelPlan:
    """Replay kernel 7's schedule: the rc adds, the diffusion (M_x rows
    lazily summed with one REDC each, none at l = 1; then the PHT adds), the
    open Flystel with its squarings, its window chain
    (``anemoi.config.window``) and its subtractions as products by negated
    constants, the closing diffusion and the exit.  At l = 1 nothing
    reduces between the PHT adds and values grow round over round, so where
    the replay without it fails the plan takes the post-PHT Montgomery
    product by 1 (``reduce``), as the TPU kernel does
    (``pallas_anemoi.py:81-89``).
    Raises ValueError if neither plan is exact."""
    try:
        return _anemoi_replay(cfg, False)
    except ValueError:
        return _anemoi_replay(cfg, True)


# ---------------------------------------------------------------------------
# Monolith (csrc/monolith.cu)
# ---------------------------------------------------------------------------

MONOLITH_SITES = ("sq", "add", "conc", "rc")


@dataclass(frozen=True)
class MonolithPlan:
    """How kernel 4 runs one config: the body (``"generic"``: Montgomery
    limbs; ``"mersenne"``: one canonical word per element, no Montgomery
    form inside), the Concrete (``"scaled"``: a circulant of plain
    small-integer entries, its first row held in registers, times limb words
    in 64-bit columns; ``"dense"``: a lazily summed row of constant
    products), the fold count at each site of ``MONOLITH_SITES``
    (rho-folds for the generic body, 2^n = 1 folds for the Mersenne body),
    the shift s with R mod p = 2^s (Mersenne body), and the largest value
    and 32-bit limb word bound reached."""

    body: str
    concrete: str
    folds: tuple
    shift: int | None
    vmax: int
    wmax: int


def mersenne_rot_shift(fs) -> int | None:
    """s with R mod p = 2^s when p = 2^n - 1 and n <= 32, else None.  Then
    the Montgomery form of x is x rotated left by s within n bits, and one
    canonical element is one 32-bit word: the Mersenne body of kernel 4
    rotates at its boundary and runs with no Montgomery reduction.  The
    port's s is 24 L mod n: 17 for Mersenne31 (L = 2), 11 for 2^13 - 1
    (L = 1); the JAX package's 12-bit limbs give 5 and 11."""
    n = fs.modulus_bit_size
    if fs.modulus != (1 << n) - 1 or n > 32:
        return None
    return (LIMB_BITS * fs.nlimbs) % n


class _MonolithReplay(_Replay):
    """Kernel 4's generic body on exclusive (value, limb word) bounds: Bars
    (a product by plain 1, the conditional subtraction, chi on canonical
    bits, a product by R^2), Bricks from i = t-1 down (each square by
    ``mont_sqr``, each square and each sum rho-folded), the Concrete and
    + rc (folded), then the exit product by the Montgomery form of 1.  With ``folds=None`` each site's count grows
    to what its instances need; with fixed counts every constraint is
    checked."""

    def __init__(self, cfg, concrete, folds=None):
        fs = cfg.field
        super().__init__(f"Monolith kernel, {fs.name} t={cfg.t}", fs, terms=cfg.t if concrete == "dense" else 1)
        self.cfg, self.concrete, self.rho = cfg, concrete, fs.r_mod_p
        self.derive = folds is None
        self.folds = dict(zip(MONOLITH_SITES, folds or (0,) * len(MONOLITH_SITES)))

    def _count(self, site, v):
        if self.derive:
            self.folds[site] = max(self.folds[site], fold_count(self.R, self.rho, v))
        return self.folds[site]

    def fold(self, x, site):
        """``fold``: n top-carry rho-folds in 32-bit words."""
        v = x[0]
        for _ in range(self._count(site, v)):
            cm = (v - 1) // self.R
            self._see(v, (cm + 1) * _W24 + 256)  # a low limb plus c * rho_k plus a carry
            v = fold_bound(self.R, self.rho, v)
        return self.carried(v)

    def concrete_layer(self, xs):
        if self.concrete == "dense":
            return [self.fold(self.row(xs), "conc") for _ in xs]
        out = []
        for row in self.cfg.concrete:
            col = sum(c * (x[1] - 1) for c, x in zip(row, xs)) + (1 << 40)  # a column plus its carry in
            if col >= 1 << 63:
                self._fail("a Concrete column can reach 2^63")
            v = sum(c * (x[0] - 1) for c, x in zip(row, xs)) + 1
            self.vmax = max(self.vmax, v)
            for _ in range(self._count("conc", v)):  # ``fold_cols``: the H * rho_k in 64-bit columns
                if v > 1 << (LIMB_BITS * self.L + 39):
                    self._fail("a Concrete fold can pass 2^63 in a column")
                v = fold_bound(self.R, self.rho, v)
            out.append(self.carried(v))
        return out

    def run(self):
        cfg, p = self.cfg, self.p
        t = cfg.t
        one = (2, 2)  # plain 1 as an exclusive bound
        xs = self.concrete_layer([self.const] * t)
        for _ in range(cfg.rounds):
            for e in range(cfg.bars):
                if self.mul(xs[e], one)[0] > 2 * p:
                    self._fail("a Bars input is not below 2p after the product by 1")
                xs[e] = self.mul(self.const, self.const)  # canonical bits times R^2
            new = list(xs)
            for i in range(t - 1, 0, -1):
                sq = self.fold(self.sqr(xs[i - 1]), "sq")
                new[i] = self.fold(self.add(xs[i], sq), "add")
            xs = [self.fold(self.add(x, self.const), "rc") for x in self.concrete_layer(new)]
        for x in xs:
            self.exit(x)
        return tuple(self.folds[s] for s in MONOLITH_SITES)


def _mersenne_fold_count(p: int, n: int, vmax: int) -> int:
    """2^n = 1 folds, V -> (V >> n) + (V & p), that bring every value below
    ``vmax`` under 2p (one conditional subtraction then canonicalizes)."""
    folds = 0
    while vmax > 2 * p:
        vmax = ((vmax - 1) >> n) + p + 1
        folds += 1
    return folds


def _mersenne_plan(cfg, concrete: str, s: int) -> MonolithPlan:
    """Kernel 4's Mersenne body: every value canonical (< p < 2^32) in one
    word between sites; a square, a Concrete row or a sum is formed in 64
    bits and folded back below 2p.  Raises if a Concrete row can reach
    2^64."""
    fs, t, p = cfg.field, cfg.t, cfg.field.modulus
    n = fs.modulus_bit_size
    mat_max = max(sum(row) for row in cfg.concrete) if concrete == "scaled" else t * (p - 1)
    conc = mat_max * (p - 1) + 1
    if conc > 1 << 64:
        raise ValueError(f"Monolith kernel, {fs.name} t={t}: a Mersenne Concrete row can reach 2^64")
    folds = tuple(
        _mersenne_fold_count(p, n, v) for v in ((p - 1) ** 2 + 1, 2 * p - 1, conc, 2 * p - 1)
    )
    return MonolithPlan("mersenne", concrete, folds, s, max(conc, (p - 1) ** 2 + 1), p)


def _generic_plan(cfg, concrete: str) -> MonolithPlan:
    from ..monolith.config import bar_chunks

    fs = cfg.field
    bit = 0
    for w in bar_chunks(fs):
        if bit // LIMB_BITS != (bit + w - 1) // LIMB_BITS:
            raise ValueError(f"{fs.name}: a Bar chunk straddles two 24-bit limbs")
        bit += w
    folds = list(_MonolithReplay(cfg, concrete).run())
    for i in range(len(folds)):  # then each site's count down as far as the replay admits
        while folds[i]:
            try:
                _MonolithReplay(cfg, concrete, tuple(folds[:i] + [folds[i] - 1] + folds[i + 1 :])).run()
            except ValueError:
                break
            folds[i] -= 1
    sim = _MonolithReplay(cfg, concrete, tuple(folds))
    sim.run()
    return MonolithPlan("generic", concrete, tuple(folds), None, sim.vmax, sim.wmax)


@functools.lru_cache(maxsize=None)
def check_monolith_bounds(cfg) -> MonolithPlan:
    """Kernel 4's plan for ``cfg``: the Mersenne body where
    ``mersenne_rot_shift`` applies, else the generic body; the scaled
    Concrete where the matrix is a circulant of small integers (the kernel
    keeps its first row in registers) and the replay admits it, else the
    dense one; the fold counts derived by a replay of
    the body that brings every value under R at every site, then taken down
    site by site as far as a replay with the counts fixed admits (values may
    pass R between sites while every word stays below 2^32 and every
    product input below R), and verified once more.  Raises
    ValueError if no plan is exact (a value could reach R, a word 2^32, a
    column 2^63 or 2^64)."""
    s = mersenne_rot_shift(cfg.field)
    t, first = cfg.t, cfg.concrete[0]
    circulant = all(cfg.concrete[i][j] == first[(j - i) % t] for i in range(t) for j in range(t))
    kinds = ("scaled", "dense") if circulant and cfg.concrete_small_entries() is not None else ("dense",)
    err = None
    for kind in kinds:
        try:
            return _mersenne_plan(cfg, kind, s) if s is not None else _generic_plan(cfg, kind)
        except ValueError as e:
            err = e
    raise err
