"""The port's GMiMC-erf family against the JAX package and the oracle.

Parameters and validation; the oracle's frozen vectors and the JAX oracle on
random states; ``gmimc_permute_plain`` (kernel 8's function) against
``gmimc_permute_jit`` and the Pallas kernel ``gmimc_permute_fn`` in
interpret mode, inputs and outputs carried across with ``interop``; the
static bound of the limb body's fully deferred rest-branch adds, with its
refusals; word-by-word emulations of ``csrc/gmimc.cu``'s two bodies (the
limb body in 32-bit words and 64-bit columns, the two-word Goldilocks body
in 64-bit words with its excess words) against the oracle, and the
two-word body against ``gmimc_permute_jit``; the two-word replay, with its
refusals; the body choice and the bound's recount at Goldilocks; dispatch;
and the sponge and transcript entry points driven by a GMiMC config.  Inputs come from numpy seeds; equality is exact
(tolerance 0) on canonical values.  The CUDA kernel itself runs on the card
(``chip_smoke.py``).  The helpers here serve the Griffin and Anemoi tests
too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sponge_tpu
from sponge_tpu.fields import FieldSpec as JaxFieldSpec
from sponge_tpu.gmimc import GmimcConfig as JaxGmimcConfig
from sponge_tpu.gmimc import OracleGmimcSponge as JaxOracleGmimc
from sponge_tpu.gmimc.params import generate_gmimc_parameters as jax_generate
from sponge_tpu.gmimc.permutation import _device_constants as jax_device_constants
from sponge_tpu.gmimc.permutation import gmimc_permute_jit
from sponge_tpu.ops.pallas_gmimc import gmimc_permute_fn
import sponge_tpu_torch as st
from sponge_tpu_torch import interop
from sponge_tpu_torch.fields import ints_to_mont_tensor, mont_tensor_to_ints
from sponge_tpu_torch.gmimc.config import LIMB_SECTIONS, constant_layout, kernel_constants
from sponge_tpu_torch.ops import _build
from sponge_tpu_torch.ops.bounds import _GmimcWordSim, _gmimc_replay, check_gmimc_bounds, check_gmimc_word_bounds
from sponge_tpu_torch.ops.gmimc import BODIES, _launch_args, body, gmimc_permute, gmimc_permute_plain
from sponge_tpu_torch.ops.montgomery import ladder_schedule, wide_state, window_schedule
from sponge_tpu_torch.poseidon.config import layout_size, mont_limb_rows

JAX_T25 = JaxFieldSpec(name="tiny_fr_25", modulus=(1 << 25) - 39, generator=3)
T25 = st.FieldSpec(name="tiny_fr_25", modulus=(1 << 25) - 39, generator=3)
FIELDS = {"bls12_381": "BLS12_381_FR", "bn254": "BN254_FR", "goldilocks": "GOLDILOCKS_FR"}


# ---- helpers shared by tests/test_torch_{gmimc,griffin,anemoi}.py ----


def lanes(p, t, B, seed):
    """[t][B] values: random residues with 0, 1, p-1, p-2 in every element
    position across the first lanes."""
    rng = np.random.default_rng(seed)
    vals = [[int(rng.integers(0, 2**63)) ** 3 % p for _ in range(B)] for _ in range(t)]
    edge = [0, 1, p - 1, p - 2]
    for b in range(min(B, 8)):
        for e in range(t):
            vals[e][b] = edge[(b + e) % 4] if b < 4 else edge[(b // 2 + e) % 4]
    return vals


def oracle_permute(cfg, vals):
    """[t][B] -> [t][B] through the config's scalar oracle."""
    out = []
    for b in range(len(vals[0])):
        o = cfg.oracle_sponge()
        o.state = [row[b] for row in vals]
        o.permute()
        out.append(o.state)
    return [list(col) for col in zip(*out)]


def jax_oracle_permute(oracle, jcfg, vals):
    """[t][B] -> [t][B] through the JAX package's scalar oracle class
    ``oracle`` of ``jcfg``."""
    out = []
    for b in range(len(vals[0])):
        o = oracle(jcfg)
        o.state = [row[b] for row in vals]
        o.permute()
        out.append(o.state)
    return [list(col) for col in zip(*out)]


def mont_col(fs, v):
    """(L, 1) 24-bit Montgomery limbs of v: one constant of the JAX tiers'
    device layout at the port's limb width."""
    return mont_limb_rows(fs, [[v % fs.modulus]])[0, 0][:, None]


def plain(family, cfg, vals):
    """[t][B] -> [t][B] through the family's plain version on the CPU."""
    perm = family(cfg, "cpu")
    out = family.plain(cfg, perm.consts, ints_to_mont_tensor(cfg.field, vals, "cpu"))
    assert out.dtype == torch.int32
    return mont_tensor_to_ints(cfg.field, out)


def jax_plane(jcfg, vals):
    fs = jcfg.field
    return jnp.asarray(np.stack([fs.ints_to_mont_plane(r) for r in vals]))


def plain_matches_jax(family, jcfg, fn, vals):
    """The plain version of the port's config equals ``fn`` (a JAX tier of
    ``jcfg``) on ``vals``; planes carried across with ``interop``."""
    cfg = interop.config_from_jax(jcfg)
    fs, jfs = cfg.field, jcfg.field
    x = jax_plane(jcfg, vals)
    state = interop.plane_from_jax(np.asarray(x), fs, jfs.limb_bits, "cpu")
    assert mont_tensor_to_ints(fs, state) == vals
    perm = family(cfg, "cpu")
    out = family.plain(cfg, perm.consts, state)
    want = interop.plane_from_jax(np.asarray(fn(x)), fs, jfs.limb_bits, "cpu")
    assert torch.equal(out, want)
    back = interop.plane_to_jax(out, fs, jfs.limb_bits, jfs.nlimbs)
    assert [jfs.mont_plane_to_ints(r) for r in back] == mont_tensor_to_ints(fs, out)


def sponge_squeeze(cfg, absorbed, n, B=2):
    s = st.PoseidonSponge(cfg, batch_size=B, device="cpu")
    s.absorb([st.Fp(v, cfg.field) for v in absorbed])
    out = s.squeeze_native_field_elements(n)
    assert all(lane == out[0] for lane in out)
    return out[0]


_M24, _M32, _M64 = (1 << 24) - 1, (1 << 32) - 1, (1 << 64) - 1


class Words:
    """``csrc/mont.cuh`` transliterated for one lane: an element is a list of
    L uint32 limb words, a REDC column a uint64; both wrap as on the card.
    ``colmax`` is the largest column any product reached before wrapping."""

    def __init__(self, fs):
        self.L, self.p, self.n0inv = fs.nlimbs, [int(v) for v in fs.int_to_limbs(fs.modulus)], fs.n0inv
        self.colmax = 0

    def redc_step(self, acc):
        """``redc_step``: retire column 0 with q * p, shift its carry up."""
        q = ((acc[0] & _M24) * self.n0inv) & _M24
        acc = [a + q * pk for a, pk in zip(acc, self.p)]
        self.colmax = max(self.colmax, *acc)
        acc = [a & _M64 for a in acc]
        carry = acc[0] >> 24
        acc = acc[1:] + [0]
        acc[0] = (acc[0] + carry) & _M64
        return acc

    def mont_mul(self, a, b):
        L, acc = self.L, [0] * self.L
        for i in range(L):
            for k in range(L):
                acc[k] = (acc[k] + a[k] * b[i]) & _M64
            acc = self.redc_step(acc)
        return self.carry_out(acc)

    def mont_row(self, xs, consts):
        """``mont_row``: the products of xs[j] by consts[j] (L limbs each)
        summed in the same 64-bit columns, one REDC."""
        L, acc = self.L, [0] * self.L
        for i in range(L):
            for x, c in zip(xs, consts):
                for k in range(L):
                    acc[k] = (acc[k] + x[k] * c[i]) & _M64
            acc = self.redc_step(acc)
        return self.carry_out(acc)

    def sqr(self, a):
        """``mont_sqr``: row i adds a_i^2 into column 2i and a_k * 2 a_i into
        column i + k for k > i (acc[k] holds column i + k)."""
        L, acc = self.L, [0] * self.L
        for i in range(L):
            di = (a[i] << 1) & _M32
            acc[i] += a[i] * a[i]
            for k in range(i + 1, L):
                acc[k] += a[k] * di
            acc = self.redc_step(acc)
        return self.carry_out(acc)

    def carry_out(self, acc):
        """64-bit columns -> carried 32-bit limb words."""
        out, c = [0] * self.L, 0
        for k in range(self.L - 1):
            v = (acc[k] + c) & _M64
            out[k], c = v & _M24, v >> 24
        out[-1] = (acc[-1] + c) & _M32
        return out

    def add_lazy(self, x, y):
        x, c = list(x), 0
        for k in range(self.L - 1):
            v = (x[k] + y[k] + c) & _M32
            x[k], c = v & _M24, v >> 24
        x[-1] = (x[-1] + y[-1] + c) & _M32
        return x

    def carry_pass(self, x):
        return self.add_lazy(x, [0] * self.L)

    def pow(self, x, e):
        """x^e by the run-length schedule of e, squaring by ``mont_mul``."""
        acc = x
        for g in ladder_schedule(e):
            for _ in range(abs(g)):
                acc = self.mont_mul(acc, acc)
            if g > 0:
                acc = self.mont_mul(acc, x)
        return acc

    def pow_window(self, x, e, w):
        """``pow_window``: the odd-power table by the chain's own steps (x^2
        parked in the last slot until the last multiply), then the chain of
        ``window_schedule(e, w)`` from its seed, squarings by ``sqr``."""
        entries = 1 << (w - 1)
        table = [x] * entries
        if entries > 1:
            acc = table[-1] = self.sqr(x)
            for k in range(1, entries):
                acc = table[k] = self.mont_mul(acc, table[0] if k == 1 else table[-1])
        sched = window_schedule(e, w)
        acc = table[sched[0]]
        for squarings, j in zip(sched[1::2], sched[2::2]):
            for _ in range(squarings):
                acc = self.sqr(acc)
            if j >= 0:
                acc = self.mont_mul(acc, table[j])
        return acc

    def store(self, x):
        """``reduce_once``: subtract p unless that borrows."""
        d, borrow = [], 0
        for k in range(self.L):
            w = x[k] - self.p[k] - borrow
            borrow = int(w < 0)
            d.append(w & _M24)
        return x if borrow else d


def emulate(cfg, kernel, vals):
    """[t][B] canonical values through a ``Words`` kernel emulation; checks
    that every output limb is carried."""
    fs, out = cfg.field, []
    for b in range(len(vals[0])):
        limbs = [[int(v) for v in fs.ints_to_mont_plane([row[b]])[:, 0]] for row in vals]
        res = kernel.permute(limbs)
        assert all(w <= _M24 for v in res for w in v)
        out.append([fs.from_mont(fs.limbs_to_int(v)) for v in res])
    return [list(col) for col in zip(*out)]


# ---- parameters ----


def tiny25(rounds=30, rate=2):
    """A 25-bit JAX config (tests/test_gmimc.py's field)."""
    return jax_generate(JAX_T25, rate, rounds=rounds)


DEFAULTS = {"bls12_381-r2": ("bls12_381", 2), "bn254-r2": ("bn254", 2), "goldilocks-r4": ("goldilocks", 4),
            # more widths of the default tables: (4, 11), (9, 11), (2, 11), (5, 3), (12, 3)
            "bls12_381-r3": ("bls12_381", 3), "bls12_381-r8": ("bls12_381", 8), "bn254-r1": ("bn254", 1),
            "goldilocks-r1": ("goldilocks", 1), "goldilocks-r8": ("goldilocks", 8)}


@pytest.mark.parametrize("name", list(DEFAULTS))
def test_default_parameters_equal_jax(name):
    field, rate = DEFAULTS[name]
    fs, jfs = getattr(st, FIELDS[field]), getattr(sponge_tpu, FIELDS[field])
    cfg = st.get_default_gmimc_parameters(fs, rate)
    jcfg = sponge_tpu.get_default_gmimc_parameters(jfs, rate)
    assert cfg == interop.config_from_jax(jcfg)
    assert st.gmimc_default_rounds(fs, cfg.t, cfg.alpha) == cfg.rounds


def test_tiny_parameters_and_defaults():
    cfg = st.generate_gmimc_parameters(interop.field_for_modulus(JAX_T25.modulus), 2, rounds=30)
    assert cfg == interop.config_from_jax(tiny25())
    assert (st.get_default_gmimc_parameters(st.BLS12_381_FR, 2).rounds,
            st.get_default_gmimc_parameters(st.GOLDILOCKS_FR, 4).rounds) == (226, 62)


VALIDATION = {
    "width": dict(rounds=2, alpha=5, rc=(1, 2), rate=0),
    "alpha": dict(rounds=2, alpha=3, rc=(1, 2), rate=2),
    "rc": dict(rounds=3, alpha=5, rc=(1, 2), rate=2),
    "rounds": dict(rounds=0, alpha=5, rc=(), rate=2),
}


@pytest.mark.parametrize("case", list(VALIDATION))
def test_validation_errors_match_jax(case):
    kw = VALIDATION[case]
    with pytest.raises(ValueError) as want:
        JaxGmimcConfig(field=sponge_tpu.BLS12_381_FR, **kw)
    with pytest.raises(ValueError) as got:
        st.GmimcConfig(field=st.BLS12_381_FR, **kw)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="pass rounds"):
        st.generate_gmimc_parameters(st.MERSENNE31_FR, 8, capacity=8)


# ---- oracle ----


def test_oracle_frozen_vectors():
    o = st.OracleGmimcSponge(st.get_default_gmimc_parameters(st.BLS12_381_FR, 2))
    o.absorb_field_elements([0, 1])
    assert o.squeeze_native_field_elements(2) == [
        37046578519137793905068004997922276005969922553874139160809393105572205846096,
        36927340725794352549314907498009288447328445793911509161713498516543876008544,
    ]
    o = st.OracleGmimcSponge(st.get_default_gmimc_parameters(st.GOLDILOCKS_FR, 4))
    o.absorb_field_elements(list(range(4)))
    assert o.squeeze_native_field_elements(2) == [2530300686986820728, 5710632959018033549]


@pytest.mark.parametrize("rate", [1, 2, 7])
def test_oracle_matches_jax_oracle(rate):
    jcfg = tiny25(rounds=20, rate=rate)
    cfg = interop.config_from_jax(jcfg)
    vals = lanes(JAX_T25.modulus, cfg.t, 5, rate)
    for b in range(5):
        o, j = st.OracleGmimcSponge(cfg), JaxOracleGmimc(jcfg)
        o.state = j.state = [row[b] for row in vals]
        o.permute()
        j.permute()
        assert o.state == j.state, b


# ---- the plain version against the JAX tiers and the oracle ----


@pytest.mark.parametrize("name", ["tiny_fr_25-t3", "goldilocks_fr-t8"])
def test_plain_matches_gmimc_permute_jit(name):
    """On the 25-bit field and the whole Goldilocks rate-4 instance.  At
    BLS12-381 width the JAX tier's compile takes about 10 s on the CPU; the
    full-width check there is against the oracle (below)."""
    if name.startswith("tiny"):
        jcfg = tiny25(rounds=30)
    else:
        jcfg = sponge_tpu.get_default_gmimc_parameters(sponge_tpu.GOLDILOCKS_FR, 4)
    vals = lanes(jcfg.field.modulus, jcfg.t, 16, 11)
    plain_matches_jax(st.GmimcPermutation, jcfg, gmimc_permute_jit(jcfg), vals)


def test_plain_matches_gmimc_kernel_interpret():
    jcfg = tiny25(rounds=6)
    fn = gmimc_permute_fn(jcfg, interpret=True)
    plain_matches_jax(st.GmimcPermutation, jcfg, fn, lanes(JAX_T25.modulus, 3, 2048, 71))


@pytest.mark.parametrize("name", ["bls12_381_fr-t3", "goldilocks_fr-t8"])
def test_plain_matches_oracle_full_width(name):
    """All 226 BLS12-381 rounds and all 62 Goldilocks rounds, against the
    JAX package's oracle."""
    jfs, fs, rate = ((sponge_tpu.BLS12_381_FR, st.BLS12_381_FR, 2) if name.startswith("bls")
                     else (sponge_tpu.GOLDILOCKS_FR, st.GOLDILOCKS_FR, 4))
    cfg, jcfg = st.get_default_gmimc_parameters(fs, rate), sponge_tpu.get_default_gmimc_parameters(jfs, rate)
    assert cfg == interop.config_from_jax(jcfg)
    vals = lanes(cfg.field.modulus, cfg.t, 4, 9)
    assert plain(st.GmimcPermutation, cfg, vals) == jax_oracle_permute(JaxOracleGmimc, jcfg, vals)


# ---- the static bound of kernel 8 ----


def test_bound_admits_the_instantiated_configs():
    for fs, rate in [(st.BLS12_381_FR, 2), (st.BN254_FR, 2), (st.GOLDILOCKS_FR, 4)]:
        cfg = st.get_default_gmimc_parameters(fs, rate)
        plan = check_gmimc_bounds(cfg)
        assert not plan.reduce and plan.vmax <= fs.r and plan.wmax <= 1 << 32, fs.name
    bls = check_gmimc_bounds(st.get_default_gmimc_parameters(st.BLS12_381_FR, 2))
    assert 400 * st.BLS12_381_FR.modulus < bls.vmax  # the tight case: 462p of R = 565p
    assert 1 << 31 < bls.wmax  # about 151 deferred adds of 24-bit limbs
    check_gmimc_bounds(st.generate_gmimc_parameters(T25, 2, rounds=30))


def test_bound_refuses_overflowing_round_counts():
    """BLS12-381 at t = 9 with 238 rounds: without the front reduction the
    front reaches R, so the plan takes it.  The 25-bit field (R/p = 2^23) at
    400 rounds: about 267 deferred adds of 24-bit limbs reach 2^32 in a word
    before any value nears R, with or without the reduction."""
    bls9 = st.get_default_gmimc_parameters(st.BLS12_381_FR, 8)
    with pytest.raises(ValueError, match="reach R"):
        _gmimc_replay(bls9, False)
    assert check_gmimc_bounds(bls9).reduce
    with pytest.raises(ValueError, match="2\\^32"):
        check_gmimc_bounds(st.generate_gmimc_parameters(T25, 2, rounds=400))
    assert not check_gmimc_bounds(st.generate_gmimc_parameters(T25, 2, rounds=250)).reduce


# ---- word-by-word emulation of csrc/gmimc.cu ----


def reduce_front_words(p, f):
    """``reduce_front`` on carried limb words f (p: the modulus's limbs):
    f - q p with q = top * qinv / 2^32, qinv = (2^32 - 1) / (p_top + 1),
    limb by limb with floor-shifted borrows; never negative."""
    q, c, out = f[-1] * (_M32 // (p[-1] + 1)) >> 32, 0, []
    for k in range(len(p) - 1):
        v = f[k] + c - q * p[k]
        out.append(v & _M24)
        c = v >> 24
    top = f[-1] + c - q * p[-1]
    assert 0 <= top <= _M32
    return out + [top]


class Kernel8(Words):
    """``csrc/gmimc.cu``'s limb body for one lane: the front of round r0 + j
    is register j, its copy plus c_r is reduced by ``reduce_front`` where
    the plan asks for it and raised by ``pow_sqr1`` (squarings by
    ``mont_sqr``); F is added to the other words with no carry; the state
    is rotated back by rounds mod t at the end.  A wide state
    (``montgomery.wide_state``) rotates as it adds, round by round:
    x[e - 1] = x[e] + F, x[t - 1] = the old front."""

    def __init__(self, cfg):
        super().__init__(cfg.field)
        c = [int(v) for v in kernel_constants(cfg)]
        L = self.L
        self.cfg, self.one, self.rc = cfg, c[L : 2 * L], c[2 * L : 2 * L + cfg.rounds * L]
        self.reduce = check_gmimc_bounds(cfg).reduce

    def reduce_front(self, f):
        return reduce_front_words(self.p, f)

    def front(self, x, r):
        f = self.add_lazy(x, self.rc[r * self.L :][: self.L])
        return self.pow(self.reduce_front(f) if self.reduce else f, self.cfg.alpha)

    def pow(self, x, e):
        """``pow_sqr1``: the run-length schedule of e, squarings by ``sqr``."""
        acc = x
        for g in ladder_schedule(e):
            for _ in range(abs(g)):
                acc = self.sqr(acc)
            if g > 0:
                acc = self.mont_mul(acc, x)
        return acc

    def permute(self, x):
        cfg, L, t = self.cfg, self.L, self.cfg.t
        add = lambda v, f: [(w + fw) & _M32 for w, fw in zip(v, f)]
        if wide_state(t, L):
            for r in range(cfg.rounds):
                f = self.front(x[0], r)
                x = [add(v, f) for v in x[1:]] + [x[0]]
        else:
            for r0 in range(0, cfg.rounds, t):
                for j in range(min(t, cfg.rounds - r0)):
                    f = self.front(x[j], r0 + j)
                    x = [v if e == j else add(v, f) for e, v in enumerate(x)]
            s = cfg.rounds % t
            x = x[s:] + x[:s]
        return [self.store(self.mont_mul(self.carry_pass(v), self.one)) for v in x]


KERNEL8 = {
    "bls12_381_fr-t3": lambda: st.get_default_gmimc_parameters(st.BLS12_381_FR, 2),
    "goldilocks_fr-t8": lambda: st.get_default_gmimc_parameters(st.GOLDILOCKS_FR, 4),
    "tiny_fr_25-t3": lambda: st.generate_gmimc_parameters(T25, 2, rounds=250),
    "bls12_381_fr-t4": lambda: st.get_default_gmimc_parameters(st.BLS12_381_FR, 3),
    "bls12_381_fr-t9": lambda: st.get_default_gmimc_parameters(st.BLS12_381_FR, 8),
    "bn254_fr-t9": lambda: st.get_default_gmimc_parameters(st.BN254_FR, 8),
}


@pytest.mark.parametrize("name", list(KERNEL8))
def test_kernel_emulation_matches_oracle(name):
    """All rounds; BLS12-381 t = 4 and t = 9 in the wide order with the
    front reduction, BN254 t = 9 in the wide order without it."""
    cfg = KERNEL8[name]()
    vals = lanes(cfg.field.modulus, cfg.t, 4, 13)
    kernel = Kernel8(cfg)
    assert kernel.reduce == (cfg.field.name == "bls12_381_fr" and cfg.t >= 4)
    assert emulate(cfg, kernel, vals) == oracle_permute(cfg, vals)


# ---- the two-word body (Goldilocks) ----

_EPS = (1 << 32) - 1  # 2^64 mod p at Goldilocks


class Kernel8Word:
    """``csrc/gmimc.cu``'s two-word body for one lane: 64-bit words in plain
    form, exact 128-bit products (``gl_mul``, ``gl_sqr``) reduced by
    ``GL_REDUCE_N``, the excess word of each element (``gl_add_deferred``)
    and ``gl_fold``; every intermediate is checked against the limit the
    replay (``_GmimcWordSim``) proves.  ``emax`` is the largest excess
    reached."""

    def __init__(self, cfg):
        self.cfg, self.emax = cfg, 0
        layout = constant_layout(cfg)
        w = [int(v) & _M32 for v in kernel_constants(cfg)[layout_size(layout[:LIMB_SECTIONS]) :]]
        pairs = [w[i] | w[i + 1] << 32 for i in range(0, len(w), 2)]
        self.to_word, self.from_word, self.rc = pairs[0], pairs[1], pairs[2:]

    @staticmethod
    def reduce(n):
        """``GL_REDUCE_N``: V = lo - hh + hl (2^32 - 1) in 96 bits, its top
        word s (-1, 0 or 1) added back as s (2^32 - 1)."""
        assert 0 <= n < 1 << 128
        lo, hh, hl = n & _M64, n >> 96, (n >> 64) & _M32
        v = lo - hh + hl * _EPS
        s = v >> 64  # floor: -1 below 0
        assert s in (-1, 0, 1)
        r = (v & _M64) + s * _EPS
        assert 0 <= r <= _M64
        return r

    def mul(self, a, b):
        assert a <= _M64 and b <= _M64
        return self.reduce(a * b)

    def sqr(self, a):
        return self.mul(a, a)

    def pow(self, x, alpha):
        acc = x
        for bit in range(alpha.bit_length() - 2, -1, -1):
            acc = self.sqr(acc)
            if (alpha >> bit) & 1:
                acc = self.mul(acc, x)
        return acc

    @staticmethod
    def fold(x, e, c):
        """``gl_fold``: k = e + the carry of x + c (a 32-bit word), the sum
        plus k (2^32 - 1) in 96 bits, its top word t (0 or 1) added back as
        t (2^32 - 1)."""
        s = x + c
        k = e + (s >> 64)
        assert k <= _M32
        w = (s & _M64) + k * _EPS
        t = w >> 64
        assert t in (0, 1)
        r = (w & _M64) + t * _EPS
        assert r <= _M64
        return r

    def permute(self, limbs):
        cfg, t, p = self.cfg, self.cfg.t, self.cfg.field.modulus
        x = [self.mul(l0 | l1 << 24 | l2 << 48, self.to_word) for l0, l1, l2 in limbs]
        ex = [0] * t
        for r0 in range(0, cfg.rounds, t):
            for j in range(min(t, cfg.rounds - r0)):
                f = self.pow(self.fold(x[j], ex[j], self.rc[r0 + j]), cfg.alpha)
                for e in range(t):
                    if e != j:
                        s = x[e] + f
                        x[e], ex[e] = s & _M64, ex[e] + (s >> 64)
                        assert ex[e] <= _M32
        self.emax = max(self.emax, *ex)  # an excess never falls
        s = cfg.rounds % t
        x, ex = x[s:] + x[:s], ex[s:] + ex[:s]
        out = []
        for v, e in zip(x, ex):
            v = self.mul(self.fold(v, e, 0), self.from_word)
            v = v - p if v >= p else v
            out.append([v & _M24, (v >> 24) & _M24, v >> 48])
        return out


def test_word_kernel_emulation_matches_oracle_and_jax():
    """Goldilocks t = 8 (all 62 rounds): the two-word body on seeded lanes,
    edge lanes (0, 1, p-1, p-2 across the element positions) and lanes of
    p-1 and p-2 in every element (every first-round add carries into the
    excess words) equals the port's oracle and the JAX package's
    ``gmimc_permute_jit``; no excess passes the replay's."""
    cfg = st.get_default_gmimc_parameters(st.GOLDILOCKS_FR, 4)
    jcfg = sponge_tpu.get_default_gmimc_parameters(sponge_tpu.GOLDILOCKS_FR, 4)
    p = cfg.field.modulus
    vals = [row + [p - 1, p - 2] for row in lanes(p, cfg.t, 10, 23)]
    kern = Kernel8Word(cfg)
    got = emulate(cfg, kern, vals)
    assert got == oracle_permute(cfg, vals)
    out = np.asarray(gmimc_permute_jit(jcfg)(jax_plane(jcfg, vals)))
    assert got == [jcfg.field.mont_plane_to_ints(row) for row in out]
    assert 0 < kern.emax <= check_gmimc_word_bounds(cfg)


def test_word_replay_admits_goldilocks_and_refuses_a_missing_fold():
    """The replay admits Goldilocks t = 8: the largest excess is the 55 adds
    an element takes in 62 rounds (fronts 7 times).  Without the front's
    fold, or the exit's, a product input carries excess and the replay
    refuses; a field other than Goldilocks is refused."""
    cfg = st.get_default_gmimc_parameters(st.GOLDILOCKS_FR, 4)
    assert check_gmimc_word_bounds(cfg) == cfg.rounds - cfg.rounds // cfg.t == 55
    p = cfg.field.modulus

    class NoFrontFold(_GmimcWordSim):
        def fold(self, x, c):
            return x if c == p else super().fold(x, c)

    class NoExitFold(_GmimcWordSim):
        def fold(self, x, c):
            return x if c == 1 else super().fold(x, c)

    for sim in (NoFrontFold, NoExitFold):
        with pytest.raises(ValueError, match="carries excess"):
            sim(cfg).run()
    with pytest.raises(ValueError, match="2\\^64 - 2\\^32"):
        check_gmimc_word_bounds(st.get_default_gmimc_parameters(st.BLS12_381_FR, 2))


def test_body_choice_and_launch_args():
    """The two-word body at Goldilocks, the limb body at every other field;
    the bodies' pairs make up ``_build.INSTANTIATIONS``.  The wrapper's C
    arguments: the limb body gets the limb sections, the two-word body its
    section; a Goldilocks config at a pair the two-word body lacks raises
    (no fallback to the limb body)."""
    assert BODIES["limb"] | BODIES["word"] == _build.INSTANTIATIONS["sponge_gmimc"]
    bls, gl = st.get_default_gmimc_parameters(st.BLS12_381_FR, 2), st.get_default_gmimc_parameters(st.GOLDILOCKS_FR, 4)
    tiny = st.generate_gmimc_parameters(T25, 2, rounds=30)
    for cfg, kind in ((bls, "limb"), (st.get_default_gmimc_parameters(st.BN254_FR, 2), "limb"), (tiny, "limb"),
                      (gl, "word")):
        assert body(cfg) == kind and ("word_rc" in dict(constant_layout(cfg))) == (kind == "word"), cfg.field.name
    consts = st.GmimcPermutation(gl, "cpu").consts
    layout = constant_layout(gl)
    limb_words = layout_size(layout[:LIMB_SECTIONS])
    assert _launch_args(gl, consts) == (
        1, gl.rounds, gl.alpha, 0, consts.data_ptr() + 4 * limb_words, layout_size(layout) - limb_words,
        gl.field.n0inv
    )
    consts = st.GmimcPermutation(bls, "cpu").consts
    assert _launch_args(bls, consts)[:6] == (0, bls.rounds, bls.alpha, 0, consts.data_ptr(),
                                             layout_size(constant_layout(bls)))
    bls9 = st.get_default_gmimc_parameters(st.BLS12_381_FR, 8)
    assert _launch_args(bls9, st.GmimcPermutation(bls9, "cpu").consts)[:4] == (0, bls9.rounds, bls9.alpha, 1)
    gl3 = st.generate_gmimc_parameters(st.GOLDILOCKS_FR, 2, capacity=1, rounds=20)  # t = 3
    with pytest.raises(NotImplementedError, match="word body"):
        _launch_args(gl3, st.GmimcPermutation(gl3, "cpu").consts)


def test_bound_recount_at_goldilocks():
    """``chip_smoke.py``'s bound counts Goldilocks in two 32-bit words: a
    product 4 widening multiplies, a squaring 3, a reduction none, the
    plane's conversion a product each way: 62 (2 3 + 2 4) + 16 4 = 932 for
    GMiMC t = 8 (4,236 by the limb count).  BLS12-381 keeps 616 a round
    (two ``mont_sqr`` and one product at L = 11) and one product by 1 per
    element."""
    import chip_smoke

    gl, bls = st.get_default_gmimc_parameters(st.GOLDILOCKS_FR, 4), st.get_default_gmimc_parameters(st.BLS12_381_FR, 2)
    assert chip_smoke.limb_products("gmimc_permute", gl) == (932, 0)
    assert chip_smoke.limb_products("gmimc_permute", gl, words=False) == (4236, 0)
    assert chip_smoke.limb_products("gmimc_permute", bls) == (616 * 226 + 3 * 242, 0)


# ---- dispatch ----


def test_dispatch_on_cpu():
    cfg = interop.config_from_jax(tiny25(rounds=12))
    vals = lanes(cfg.field.modulus, cfg.t, 8, 21)
    state = ints_to_mont_tensor(cfg.field, vals, "cpu")
    out = st.batched_permute(cfg, state)  # "auto" on a CPU tensor: the plain version
    assert torch.equal(out, st.batched_permute(cfg, state, "plain"))
    assert mont_tensor_to_ints(cfg.field, out) == oracle_permute(cfg, vals)
    with pytest.raises(ValueError, match="CUDA kernel"):
        st.batched_permute(cfg, state, "kernel")
    with pytest.raises(ValueError, match="unknown backend"):
        st.batched_permute(cfg, state, "gmimc_pallas")
    perm = st.GmimcPermutation(cfg, "cpu")
    with pytest.raises(ValueError, match="no kernel for device"):
        gmimc_permute(cfg, perm.consts.to("meta"), state.to("meta"))
    with pytest.raises(TypeError):
        gmimc_permute(cfg, perm.consts, state.long())
    with pytest.raises(NotImplementedError):
        st.batched_permute(tiny25(), state)  # a JAX config
    with pytest.raises(NotImplementedError):
        _build.check_instantiated("sponge_gmimc", 10, 11)
    for t, L in _build.INSTANTIATIONS["sponge_gmimc"]:
        _build.check_instantiated("sponge_gmimc", t, L)
    assert gmimc_permute_plain is st.GmimcPermutation.plain


# ---- entry points over the plain tier ----


def test_sponge_reproduces_golden_vectors():
    bls = st.get_default_gmimc_parameters(st.BLS12_381_FR, 2)
    assert sponge_squeeze(bls, [0, 1], 2) == [
        37046578519137793905068004997922276005969922553874139160809393105572205846096,
        36927340725794352549314907498009288447328445793911509161713498516543876008544,
    ]
    gl = st.get_default_gmimc_parameters(st.GOLDILOCKS_FR, 4)
    assert sponge_squeeze(gl, [0, 1, 2, 3], 2) == [2530300686986820728, 5710632959018033549]


def test_sponges_and_transcript_match_oracle():
    """A lazy and an eager sponge, then a compiled Fiat-Shamir schedule
    (mode flips, a multi-chunk squeeze) over Goldilocks rate 4, against the
    oracle replay (tests/test_gmimc.py:147 for the JAX package)."""
    cfg = st.get_default_gmimc_parameters(st.GOLDILOCKS_FR, 4)
    fs, B = cfg.field, 3
    rng = np.random.default_rng(8)
    lanes_ = [[st.Fp(int(rng.integers(0, 2**63)) % fs.modulus, fs) for _ in range(6)] for _ in range(B)]
    for sponge in (
        st.PoseidonSponge(cfg, batch_size=B, lazy=False, device="cpu"),
        st.LazyPoseidonSponge(cfg, batch_size=B, device="cpu"),
    ):
        oracles = [st.OracleGmimcSponge(cfg) for _ in range(B)]
        sponge.absorb(st.Batched(lanes_))
        sponge.absorb(b"gmimc")
        for o, lane in zip(oracles, lanes_):
            o.absorb(lane)
            o.absorb(b"gmimc")
        assert sponge.squeeze_native_field_elements(5) == [o.squeeze_native_field_elements(5) for o in oracles]
        assert sponge.squeeze_bytes(11) == [o.squeeze_bytes(11) for o in oracles]
        assert sponge.squeeze_bits(40) == [o.squeeze_bits(40) for o in oracles]
    steps = [st.TranscriptAbsorb(3), st.TranscriptSqueeze(2), st.TranscriptAbsorb(6),
             st.TranscriptSqueeze(9)]
    vals = lanes(fs.modulus, 9, B, 42)
    out = st.compile_transcript(cfg, steps)(ints_to_mont_tensor(fs, vals, "cpu"))
    for b in range(B):
        o = st.OracleGmimcSponge(cfg)
        o.absorb_field_elements([row[b] for row in vals[:3]])
        want = o.squeeze_native_field_elements(2)
        o.absorb_field_elements([row[b] for row in vals[3:]])
        want += o.squeeze_native_field_elements(9)
        assert [fs.limbs_to_int(out[k, :, b].numpy()) for k in range(11)] == want, b


# ---- interop ----


def test_interop_from_device_constants():
    jcfg = tiny25(rounds=7)
    cfg = interop.gmimc_config_from_device_constants(
        jax_device_constants(jcfg), modulus=JAX_T25.modulus, limb_bits=JAX_T25.limb_bits,
        alpha=jcfg.alpha, rate=jcfg.rate,
    )
    assert cfg == interop.config_from_jax(jcfg)
    rc = mont_limb_rows(cfg.field, [cfg.rc])[0][..., None]  # (rounds, L, 1) at 24-bit limbs
    back = interop.gmimc_config_from_device_constants(
        rc, modulus=cfg.field.modulus, limb_bits=24, alpha=cfg.alpha, rate=cfg.rate
    )
    assert back == cfg
    with pytest.raises(TypeError, match="no port counterpart"):
        interop.config_from_jax(JAX_T25)
