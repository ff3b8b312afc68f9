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

Poseidon2 (kernel 3) never reduces in its linear layers: limb words hold
small-integer combinations of 24-bit limbs and values grow past R.  Its
simulation (``p2_plan``) tracks each element's value bound and limb-word
bound through the kernel's exact schedule, derives how many top-carry
rho-folds each static site needs to bring values back under R, and checks
that every 32-bit word stays below 2^32.  Rescue, GMiMC, Griffin and Anemoi
(kernels 5, 8, 6, 7) replay their schedules on (value, limb word) bounds
through ``_Replay``: GMiMC's rest-branch adds stay uncarried for the whole
permutation, and Griffin's and Anemoi's optional reductions are taken where
the replay without them fails.  The TPU kernels' 12-bit fixpoints
(``pallas_gmimc.py:67``, ``pallas_griffin.py:75``, ``pallas_anemoi.py:69``)
do not carry over to the port's 24-bit plan.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

from ..fields import LIMB_BITS
from ..poseidon.config import PoseidonConfig
from .montgomery import fold_bound, fold_count, ladder_schedule


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


def column_bound(t: int, L: int) -> int:
    """Largest REDC column: t products per limb of a row dot plus the REDC
    products (each below 2^48), plus the carry from the column below."""
    limb = (1 << LIMB_BITS) - 1
    return (t + 1) * L * limb * limb + (1 << (64 - LIMB_BITS))


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
    return vmax


# ---------------------------------------------------------------------------
# Poseidon2 (csrc/poseidon2.cu)
# ---------------------------------------------------------------------------

_W24 = 1 << LIMB_BITS  # exclusive bound of a carried limb
_W32 = 1 << 32

FOLD_SITES = ("ext", "int", "sbox_ext", "sbox_int", "exit")


@dataclass(frozen=True)
class P2Plan:
    """Fold counts per static site of the Poseidon2 kernel, in
    ``FOLD_SITES`` order, and the largest value and limb word reached.
    ``min_folds`` is the number of folds one permutation takes when every
    value is folded only as often as it needs (the kernel applies each
    site's count at every instance of the site)."""

    folds: tuple
    vmax: int
    wmax: int
    min_folds: int


class _P2Sim:
    """Exclusive (value, limb word) bounds of each element through kernel 3's
    schedule.  With ``folds=None`` each site's count grows to what its
    instances need; with fixed counts every constraint is checked; with
    ``folds="minimal"`` each instance folds as often as its own value needs.
    ``instances`` counts the folds taken."""

    def __init__(self, cfg, folds=None):
        fs = cfg.field
        self.cfg = cfg
        self.p, self.R, self.rho, self.L = fs.modulus, fs.r, fs.r_mod_p, fs.nlimbs
        self.derive, self.minimal = folds is None, folds == "minimal"
        fixed = folds if isinstance(folds, tuple) else (0,) * len(FOLD_SITES)
        self.folds = dict(zip(FOLD_SITES, fixed))
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
        v, _ = x
        need = fold_count(self.R, self.rho, v)
        if self.derive:
            self.folds[site] = max(self.folds[site], need)
        n = need if self.minimal else self.folds[site]
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

    def sbox(self, x, site):
        acc = x
        for g in ladder_schedule(self.cfg.alpha):
            for _ in range(abs(g)):
                acc = self.fold(self.mul(acc, acc), site)
            if g > 0:
                acc = self.fold(self.mul(acc, x), site)
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
        for r in range(cfg.full_rounds + cfg.partial_rounds):
            if r < half or r >= half + cfg.partial_rounds:
                xs = [self.fold(self.carry_add(x, p), "ext") for x in xs]
                xs = self.external([self.sbox(x, "sbox_ext") for x in xs])
                continue
            xs = [self.fold(self.carry_add(x, p if e == 0 else 1), "int") for e, x in enumerate(xs)]
            xs[0] = self.sbox(xs[0], "sbox_int")
            sigma = self.lin([1] * t, xs)
            if cfg.small_diag:
                xs = [self.lin([1, d], [sigma, x]) for d, x in zip(cfg.diag_m1, xs)]
            else:
                xs = [self.lin([1, 1], [sigma, self.mul(x, (p, _W24))]) for x in xs]
        xs = [self.fold(self.carry_add(x, 1), "exit") for x in xs]
        out = max(self.mul(x, (p, _W24))[0] for x in xs)  # Montgomery product by 1
        if out > 2 * p:
            self._fail(f"output bound {out / p:.2f}p >= 2p")
        return tuple(self.folds[s] for s in FOLD_SITES)


@functools.lru_cache(maxsize=None)
def p2_plan(cfg) -> P2Plan:
    """Fold counts of kernel 3 for ``cfg``, derived and then verified by a
    second replay with those counts fixed; raises ValueError if no plan is
    exact (a limb word could reach 2^32 or a product input R)."""
    folds = _P2Sim(cfg).run()
    sim = _P2Sim(cfg, folds)
    sim.run()
    if column_bound(1, cfg.field.nlimbs) >= 1 << 63:
        raise ValueError(f"{cfg.field.name}: REDC columns can overflow 63 bits")
    minimal = _P2Sim(cfg, "minimal")
    minimal.run()
    return P2Plan(folds=folds, vmax=sim.vmax, wmax=sim.wmax, min_folds=minimal.instances)


# ---------------------------------------------------------------------------
# Rescue-Prime, GMiMC, Griffin and Anemoi (csrc/rescue.cu, csrc/gmimc.cu,
# csrc/griffin.cu, csrc/anemoi.cu)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class KernelPlan:
    """What a family kernel's replay found: whether the kernel must take its
    optional reduction (Griffin's post-linear, Anemoi's post-PHT Montgomery
    product by 1; never for GMiMC), and the largest value and 32-bit limb
    word bound reached."""

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

    def pow(self, x, e):
        """``mont_pow`` / ``pow_ladder``: the run-length schedule of e."""
        acc = x
        for g in ladder_schedule(e):
            for _ in range(abs(g)):
                acc = self.mul(acc, acc)
            if g > 0:
                acc = self.mul(acc, x)
        return acc

    def exit(self, x):
        """One Montgomery product by 1, then one conditional subtraction."""
        if self.mul(x, self.const)[0] > 2 * self.p:
            self._fail("output bound >= 2p")


@functools.lru_cache(maxsize=None)
def check_rescue_bounds(cfg) -> int:
    """Replay kernel 5's schedule on exclusive value bounds: both ladders
    product by product, the MDS row dots (one REDC each), the constant adds
    and the exit product by the Montgomery form of 1.  Raises ValueError if
    a product input could reach R, the output 2p, or a column 2^63; returns
    the largest value bound."""
    fs, t = cfg.field, cfg.t
    sim = _Replay(f"Rescue kernel, {fs.name} t={t}", fs, terms=t)
    x = sim.const
    for h in range(2 * cfg.rounds):
        y = sim.pow(x, cfg.inv_alpha if h % 2 else cfg.alpha)
        x = sim.add(sim.row([y] * t), sim.const)
    sim.exit(x)
    return sim.vmax


@functools.lru_cache(maxsize=None)
def check_gmimc_bounds(cfg) -> KernelPlan:
    """Replay kernel 8's schedule.  Each round copies the front element,
    adds c_r (carried) and raises it to alpha; F is added word by word,
    uncarried, to the other t-1 elements, which keep every such add until
    the exit: values grow by F per add, and limb words by up to 2^24.  The
    exit is a carry pass and a Montgomery product by 1.  Raises ValueError
    if a product input could reach R, a limb word 2^32 or the output 2p."""
    fs, t = cfg.field, cfg.t
    sim = _Replay(f"GMiMC kernel, {fs.name} t={t} rounds={cfg.rounds}", fs)
    xs = [sim.const] * t
    for r in range(cfg.rounds):
        j = r % t  # the front's register; the kernel never moves the state
        f = sim.pow(sim.add(xs[j], sim.const), cfg.alpha)
        xs = [x if i == j else sim.lin((1, 1), (x, f)) for i, x in enumerate(xs)]
    for x in xs:
        sim.exit(sim.carry_pass(x))
    return KernelPlan(False, sim.vmax, sim.wmax)


def _griffin_replay(cfg, reduce_linear: bool) -> KernelPlan:
    fs, t = cfg.field, cfg.t
    sim = _Replay(f"Griffin kernel, {fs.name} t={t}", fs)
    c = sim.const

    def linear(xs, with_rc):
        ys = [sim.lin(row, xs) for row in cfg.mat_e]
        ys = [sim.add(y, c) if with_rc else sim.carry_pass(y) for y in ys]
        return [sim.mul(y, c) for y in ys] if reduce_linear else ys

    xs = linear([c] * t, False)
    for _ in range(cfg.rounds):
        y0, y1 = sim.pow(xs[0], cfg.inv_alpha), sim.pow(xs[1], cfg.alpha)
        out = [y0, y1] + xs[2:]
        for i in range(t - 1, 1, -1):  # descending, as the kernel
            terms = [y0, y1] + ([xs[i - 1]] if i >= 3 else [])
            li = sim.carry_pass(sim.lin([i - 1, 1, 1][: len(terms)], terms))
            quad = sim.add(sim.add(sim.mul(li, li), sim.mul(li, c)), c)
            out[i] = sim.mul(xs[i], quad)
        xs = linear(out, True)
    for x in xs:
        sim.exit(x)
    return KernelPlan(reduce_linear, sim.vmax, sim.wmax)


@functools.lru_cache(maxsize=None)
def check_griffin_bounds(cfg) -> KernelPlan:
    """Replay kernel 6's schedule: the opening small-integer linear layer
    (limb words unreduced, then carried), per round the inverse ladder on
    x_0, x_1^alpha, the quadratic gates from i = t-1 down to 2, and the
    linear layer plus rc.  The linear layer amplifies values by its row sum,
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
    c = sim.const

    def diffusion(x, y):
        if lcol > 1:
            x, y = sim.row([x] * lcol), sim.row([y] * lcol)
        y = sim.add(y, x)
        x = sim.add(x, y)
        return (sim.mul(x, c), sim.mul(y, c)) if reduce_pht else (x, y)

    x = y = c  # one bound per column: every pair takes the same schedule
    for _ in range(cfg.rounds):
        x, y = diffusion(sim.add(x, c), sim.add(y, c))
        u = sim.add(sim.add(x, sim.mul(sim.mul(y, y), c)), c)
        v = sim.add(y, sim.mul(sim.pow(u, cfg.inv_alpha), c))
        x, y = sim.add(u, sim.mul(sim.mul(v, v), c)), v
    x, y = diffusion(x, y)
    sim.exit(x)
    sim.exit(y)
    return KernelPlan(reduce_pht, sim.vmax, sim.wmax)


@functools.lru_cache(maxsize=None)
def check_anemoi_bounds(cfg) -> KernelPlan:
    """Replay kernel 7's schedule: the rc adds, the diffusion (M_x rows
    lazily summed with one REDC each, none at l = 1; then the PHT adds), the
    open Flystel with its subtractions as products by negated constants, the
    closing diffusion and the exit.  At l = 1 nothing reduces between the
    PHT adds and values grow round over round, so where the replay without
    it fails the plan takes the post-PHT Montgomery product by 1
    (``reduce``), as the TPU kernel does (``pallas_anemoi.py:81-89``).
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
    form inside), the Concrete (``"scaled"``: plain small-integer entries
    times limb words in 64-bit columns; ``"dense"``: a lazily summed row of
    constant products), the fold count at each site of ``MONOLITH_SITES``
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
    bits, a product by R^2), Bricks from i = t-1 down (each square and each
    sum rho-folded), the Concrete and + rc (folded), then the exit product
    by the Montgomery form of 1.  With ``folds=None`` each site's count grows
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
                sq = self.fold(self.mul(xs[i - 1], xs[i - 1]), "sq")
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
    Concrete where every matrix entry is a small integer and the replay
    admits it, else the dense one; the fold counts derived by a replay of
    the body that brings every value under R at every site, then taken down
    site by site as far as a replay with the counts fixed admits (values may
    pass R between sites while every word stays below 2^32 and every
    product input below R), and verified once more.  Raises
    ValueError if no plan is exact (a value could reach R, a word 2^32, a
    column 2^63 or 2^64)."""
    s = mersenne_rot_shift(cfg.field)
    kinds = ("scaled", "dense") if cfg.concrete_small_entries() is not None else ("dense",)
    err = None
    for kind in kinds:
        try:
            return _mersenne_plan(cfg, kind, s) if s is not None else _generic_plan(cfg, kind)
        except ValueError as e:
            err = e
    raise err
