"""The port's Poseidon2 family against the JAX package and the oracle.

Parameters field by field; the oracle's frozen vectors and the JAX oracle on
random states; ``permute_p2_plain`` (kernel 3's function) against
``poseidon2_permute_jit`` and the Pallas kernel ``p2_permute_fn`` in
interpret mode on the 35-bit test field and the 44-bit low-headroom field,
and against the oracle at full width; the static fold plan and the one-word
body's replay; the body each field takes; word-by-word emulations of both
bodies of ``csrc/poseidon2.cu`` (32-bit words, 64-bit columns and products)
against the oracle, which run the kernel's schedules and fold counts on the
CPU;
dispatch; and the sponge, transcript and Merkle entry points driven by a
Poseidon2 config.  Inputs come from numpy seeds; equality is exact
(tolerance 0) on canonical values.  The CUDA kernel itself runs on the card
(``chip_smoke.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import TINY_FR, tiny_poseidon2_config

import sponge_tpu
from sponge_tpu.fields import FieldSpec as JaxFieldSpec
from sponge_tpu.ops.pallas_p2 import p2_permute_fn
from sponge_tpu.poseidon2 import OraclePoseidon2Sponge as JaxOracle2
from sponge_tpu.poseidon2.params import external_matrix as jax_external_matrix
from sponge_tpu.poseidon2.permutation import device_constants2 as jax_device_constants2
from sponge_tpu.poseidon2.permutation import poseidon2_permute_jit
import sponge_tpu_torch as st
from sponge_tpu_torch import interop
from sponge_tpu_torch.fields import ints_to_mont_tensor, mont_tensor_to_ints
from sponge_tpu_torch.hash import hash_elements, merkle_root
from sponge_tpu_torch.ops import _build
from sponge_tpu_torch.ops.bounds import P2_FOLD_CAPS, check_p2_bounds, m4_structured, p2_plan
from sponge_tpu_torch.ops.montgomery import ladder_schedule
from sponge_tpu_torch.ops.poseidon2 import _launch_args, permute_p2, permute_p2_plain
from sponge_tpu_torch.poseidon.config import layout_size
from sponge_tpu_torch.poseidon2.config import LIMB_SECTIONS, constant_layout, kernel_constants
from sponge_tpu_torch.poseidon2.oracle import OraclePoseidon2Sponge
from sponge_tpu_torch.poseidon2.params import external_matrix

JAX_LOW = JaxFieldSpec(name="low_headroom_44", modulus=(1 << 44) - 17, generator=3)

# JAX configs on the small fields (tests/test_poseidon2.py's cases).
TINY = {
    "t3": lambda: tiny_poseidon2_config(),
    "t4": lambda: tiny_poseidon2_config(rate=3, alpha=5, full_rounds=4, partial_rounds=6),
    "t8": lambda: tiny_poseidon2_config(rate=7, alpha=5, full_rounds=4, partial_rounds=4),
    "low-t8": lambda: sponge_tpu.generate_poseidon2_parameters(JAX_LOW, 7, 5, 4, 4),
}


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
    """[t][B] -> [t][B] through the port's scalar oracle."""
    out = []
    for b in range(len(vals[0])):
        o = OraclePoseidon2Sponge(cfg)
        o.state = [row[b] for row in vals]
        o.permute()
        out.append(o.state)
    return [list(col) for col in zip(*out)]


def plain(cfg, vals):
    perm = st.Poseidon2Permutation(cfg, "cpu")
    out = permute_p2_plain(cfg, perm.consts, ints_to_mont_tensor(cfg.field, vals, "cpu"))
    assert out.dtype == torch.int32
    return mont_tensor_to_ints(cfg.field, out)


def jax_plane(fs, vals):
    return jnp.asarray(np.stack([fs.ints_to_mont_plane(r) for r in vals]))


def jax_ints(fs, plane):
    return [fs.mont_plane_to_ints(row) for row in np.asarray(plane)]


# ---- parameters ----


DEFAULTS = {
    "bls12_381-r2": ("BLS12_381_FR", 2),
    "bn254-r2": ("BN254_FR", 2),
    "bls12_377-r2": ("BLS12_377_FR", 2),
    "babybear-r8": ("BABYBEAR_FR", 8),
    "koalabear-r8": ("KOALABEAR_FR", 8),
    "goldilocks-r8": ("GOLDILOCKS_FR", 8),
}


@pytest.mark.parametrize("name", list(DEFAULTS))
def test_default_parameters_equal_jax(name):
    const, rate = DEFAULTS[name]
    fs, jfs = getattr(st, const), getattr(sponge_tpu, const)
    cfg = st.get_default_poseidon2_parameters(fs, rate)
    jcfg = sponge_tpu.get_default_poseidon2_parameters(jfs, rate)
    assert cfg == interop.config_from_jax(jcfg)
    assert (cfg.t, cfg.alpha, cfg.full_rounds, cfg.partial_rounds) == (
        jcfg.t, jcfg.alpha, jcfg.full_rounds, jcfg.partial_rounds,
    )


@pytest.mark.parametrize("name", list(TINY))
def test_generated_parameters_equal_jax(name):
    jcfg = TINY[name]()
    fs = interop.field_for_modulus(jcfg.field.modulus)
    cfg = st.generate_poseidon2_parameters(
        fs, jcfg.rate, jcfg.alpha, jcfg.full_rounds, jcfg.partial_rounds
    )
    assert cfg == interop.config_from_jax(jcfg)


def test_external_matrix_matches_jax():
    for t in (2, 3, 4, 8, 12, 16):
        assert external_matrix(t) == jax_external_matrix(t), t
    with pytest.raises(ValueError):
        external_matrix(5)


# ---- oracle ----


def test_oracle_frozen_vectors():
    s = OraclePoseidon2Sponge(interop.config_from_jax(tiny_poseidon2_config()))
    s.absorb_field_elements([0, 1, 2])
    assert s.squeeze_native_field_elements(3) == [2041425071, 11606794380, 33819483313]
    s = OraclePoseidon2Sponge(st.get_default_poseidon2_parameters(st.BLS12_381_FR, 2))
    s.absorb_field_elements([0, 1, 2])
    assert s.squeeze_native_field_elements(3) == [
        52083961829638530329803873513984423317950149524710559639711710544245016843101,
        46550625866894159897150880606355238520431023163927606006962896442099973167881,
        42226209967555737499361210161376034319861506751659560949906643713058884560743,
    ]


@pytest.mark.parametrize("t", [3, 4, 8, 16])
def test_oracle_matches_jax_oracle(t):
    jcfg = sponge_tpu.generate_poseidon2_parameters(TINY_FR, t - 1, 5, 4, 6)
    cfg = interop.config_from_jax(jcfg)
    vals = lanes(TINY_FR.modulus, t, 6, t)
    for b in range(6):
        o, j = OraclePoseidon2Sponge(cfg), JaxOracle2(jcfg)
        o.state = j.state = [row[b] for row in vals]
        o.permute()
        j.permute()
        assert o.state == j.state, b


# ---- the plain version against the JAX tiers and the oracle ----


@pytest.mark.parametrize("name", list(TINY))
def test_plain_matches_poseidon2_permute_jit(name):
    jcfg = TINY[name]()
    jfs = jcfg.field
    vals = lanes(jfs.modulus, jcfg.t, 32, 5)
    ref = jax_ints(jfs, poseidon2_permute_jit(jcfg)(jax_plane(jfs, vals)))
    assert plain(interop.config_from_jax(jcfg), vals) == ref


def test_plain_matches_p2_kernel_interpret():
    jcfg = tiny_poseidon2_config(partial_rounds=6)
    vals = lanes(TINY_FR.modulus, jcfg.t, 8 * 128, 55)
    fn = p2_permute_fn(jcfg, interpret=True, sublanes=8, lane_streams=1)
    ref = jax_ints(TINY_FR, fn(jax_plane(TINY_FR, vals)))
    assert plain(interop.config_from_jax(jcfg), vals) == ref


FULL_WIDTH = {"bls12_381_fr-t3": (st.BLS12_381_FR, 2), "babybear_fr-t16": (st.BABYBEAR_FR, 8)}


@pytest.mark.parametrize("name", list(FULL_WIDTH))
def test_plain_matches_oracle_full_width(name):
    cfg = st.get_default_poseidon2_parameters(*FULL_WIDTH[name])
    vals = lanes(cfg.field.modulus, cfg.t, 8, 9)
    assert plain(cfg, vals) == oracle_permute(cfg, vals)


# ---- the static fold plan of kernel 3 ----


def test_fold_plan_admits_shipped_configs():
    for fs, rate in [
        (st.BLS12_381_FR, 2), (st.BN254_FR, 2), (st.BLS12_377_FR, 2),
        (st.BABYBEAR_FR, 8), (st.KOALABEAR_FR, 8), (st.GOLDILOCKS_FR, 8),
    ]:
        cfg = st.get_default_poseidon2_parameters(fs, rate)
        plan = p2_plan(cfg)
        assert plan.body == "limb" and len(plan.folds) == cfg.rounds + 1 and plan.folds[-1][1] == 0
        assert all(pre <= P2_FOLD_CAPS[0] and sbox <= P2_FOLD_CAPS[1] for pre, sbox in plan.folds), fs.name
        assert plan.wmax <= 1 << 31, fs.name  # t = 16: 80 * 2^24 + 2^24
    bb = p2_plan(st.get_default_poseidon2_parameters(st.BABYBEAR_FR, 8))
    assert bb.wmax == 81 * (1 << 24) + 1
    # The internal phase sums all elements every round, so values pass R even
    # at BLS12-381's R = 565p: the plan folds there, and not in the first
    # external rounds, whose values stay small.
    cfg = st.get_default_poseidon2_parameters(st.BLS12_381_FR, 2)
    bls, half = p2_plan(cfg), cfg.full_rounds // 2
    assert bls.vmax > st.BLS12_381_FR.r
    assert all(f == (0, 0) for f in bls.folds[:half])
    assert max(pre for pre, _ in bls.folds[half : half + cfg.partial_rounds]) == 2
    # R = 2^48 = 16.0p: the external row sums (48 at t = 8) pass R in one round.
    low_cfg = interop.config_from_jax(TINY["low-t8"]())
    low = p2_plan(low_cfg)
    assert low.vmax > 40 * low_cfg.field.r and all(pre >= 1 for pre, _ in low.folds)


@pytest.mark.parametrize("name", ["bls12_381", "babybear", "low-t8"])
def test_minimal_folds_within_the_plan(name):
    """``min_folds`` (each value folded only as often as it needs) is at most
    what the kernel's per-round counts take over every instance, and nonzero
    where values pass R."""
    cfg = {
        "bls12_381": lambda: st.get_default_poseidon2_parameters(st.BLS12_381_FR, 2),
        "babybear": lambda: st.get_default_poseidon2_parameters(st.BABYBEAR_FR, 8),
        "low-t8": lambda: interop.config_from_jax(TINY["low-t8"]()),
    }[name]()
    plan = p2_plan(cfg)
    products = sum(abs(g) + (g > 0) for g in ladder_schedule(cfg.alpha))
    half = cfg.full_rounds // 2
    taken = cfg.t * plan.folds[-1][0]
    for r, (pre, sbox) in enumerate(plan.folds[:-1]):
        external = r < half or r >= half + cfg.partial_rounds
        taken += cfg.t * pre + (cfg.t if external else 1) * products * sbox
    assert 0 < plan.min_folds <= taken


def test_fold_plan_refuses_overflowing_words():
    cfg = interop.config_from_jax(tiny_poseidon2_config())
    big = st.Poseidon2Config(
        field=cfg.field, full_rounds=cfg.full_rounds, partial_rounds=cfg.partial_rounds,
        alpha=cfg.alpha, external_rc=cfg.external_rc, internal_rc=cfg.internal_rc,
        mat_e=((100, 100, 100),) * 3, mat_i_diag=cfg.mat_i_diag, rate=2,
    )
    with pytest.raises(ValueError, match="2\\^32"):
        p2_plan(big)
    neg = st.Poseidon2Config(
        field=cfg.field, full_rounds=cfg.full_rounds, partial_rounds=cfg.partial_rounds,
        alpha=cfg.alpha, external_rc=cfg.external_rc, internal_rc=cfg.internal_rc,
        mat_e=((2, 1, -1), (1, 2, 1), (1, 1, 2)), mat_i_diag=cfg.mat_i_diag, rate=2,
    )
    with pytest.raises(ValueError, match="non-negative"):
        p2_plan(neg)


# ---- word-by-word emulation of csrc/poseidon2.cu ----

_M24, _M32, _M64 = (1 << 24) - 1, (1 << 32) - 1, (1 << 64) - 1


class _Kernel3:
    """csrc/poseidon2.cu's limb body and csrc/mont.cuh transliterated for one
    lane: uint32 limb words and uint64 columns wrap as on the card; the fold
    counts per round from ``p2_plan``."""

    def __init__(self, cfg):
        fs = cfg.field
        self.cfg, self.L, self.t = cfg, fs.nlimbs, cfg.t
        c = [int(v) for v in kernel_constants(cfg)]
        L, t = self.L, self.t
        self.p, self.rho = c[:L], c[L : 2 * L]
        off = 2 * L
        self.ext = c[off : off + cfg.full_rounds * t * L]
        off += cfg.full_rounds * t * L
        self.int = c[off : off + cfg.partial_rounds * L]
        off += cfg.partial_rounds * L
        self.diag_mont = c[off : off + t * L]
        off += t * L
        self.mat_e = c[off : off + t * t]
        self.diag_small = c[off + t * t : off + t * t + t]
        self.n0inv = fs.n0inv
        self.plan = check_p2_bounds(cfg).folds

    def redc_step(self, acc):
        q = ((acc[0] & _M24) * self.n0inv) & _M24
        acc = [(a + q * pk) & _M64 for a, pk in zip(acc, self.p)]
        carry = acc[0] >> 24
        acc = acc[1:] + [0]
        acc[0] = (acc[0] + carry) & _M64
        return acc

    def carry_out(self, acc):
        out, c = [0] * self.L, 0
        for k in range(self.L - 1):
            v = (acc[k] + c) & _M64
            out[k], c = v & _M24, v >> 24
        out[-1] = (acc[-1] + c) & _M32
        return out

    def mont_mul(self, a, b):
        acc = [0] * self.L
        for i in range(self.L):
            acc = [(acc[k] + a[k] * b[i]) & _M64 for k in range(self.L)]
            acc = self.redc_step(acc)
        return self.carry_out(acc)

    def mont_sqr(self, a):
        """``mont_sqr``: row i adds a_i^2 into column 2i and a_k * 2 a_i into
        column i + k for k > i."""
        acc = [0] * self.L
        for i in range(self.L):
            di = (a[i] << 1) & _M32
            acc[i] = (acc[i] + a[i] * a[i]) & _M64
            for k in range(i + 1, self.L):
                acc[k] = (acc[k] + a[k] * di) & _M64
            acc = self.redc_step(acc)
        return self.carry_out(acc)

    def add_lazy(self, x, y):
        x, c = list(x), 0
        for k in range(self.L - 1):
            v = (x[k] + y[k] + c) & _M32
            x[k], c = v & _M24, v >> 24
        x[-1] = (x[-1] + y[-1] + c) & _M32
        return x

    def fold(self, x, n):
        """``fold_upto``: n top-carry rho-folds."""
        for _ in range(n):
            c = x[-1] >> 24
            x = x[:-1] + [x[-1] & _M24]
            x = self.add_lazy(x, [(c * r) & _M32 for r in self.rho])
        return x

    def sbox(self, xs, folds):
        """``p2_sbox``: square-and-multiply over the bits of alpha, squarings
        by ``mont_sqr``, each product followed by ``folds`` folds (the same
        words whether the kernel raises the elements in lockstep or, at a
        wide state, one at a time)."""
        base = [list(x) for x in xs]
        alpha = self.cfg.alpha
        for bit in range(alpha.bit_length() - 2, -1, -1):
            xs = [self.fold(self.mont_sqr(x), folds) for x in xs]
            if (alpha >> bit) & 1:
                xs = [self.fold(self.mont_mul(x, b), folds) for x, b in zip(xs, base)]
        return xs

    def small_mat_apply(self, xs):
        t = self.t
        return [
            [sum(self.mat_e[i * t + j] * xs[j][k] for j in range(t)) & _M32 for k in range(self.L)]
            for i in range(t)
        ]

    def permute(self, x):
        cfg, L, t = self.cfg, self.L, self.t
        zero = [0] * L
        half = cfg.full_rounds // 2
        x = self.small_mat_apply(x)
        for r in range(cfg.full_rounds + cfg.partial_rounds):
            pre, sbox = self.plan[r]
            if r < half or r >= half + cfg.partial_rounds:
                re = r if r < half else r - cfg.partial_rounds
                x = [self.fold(self.add_lazy(x[e], self.ext[(re * t + e) * L :][:L]), pre) for e in range(t)]
                x = self.small_mat_apply(self.sbox(x, sbox))
                continue
            ri = r - half
            x = [self.add_lazy(x[0], self.int[ri * L : (ri + 1) * L])] + [self.add_lazy(v, zero) for v in x[1:]]
            x = [self.fold(v, pre) for v in x]
            x[0] = self.sbox([x[0]], sbox)[0]
            sigma = [sum(v[k] for v in x) & _M32 for k in range(L)]
            if cfg.small_diag:
                x = [[(s + d * w) & _M32 for s, w in zip(sigma, v)] for d, v in zip(self.diag_small, x)]
            else:
                x = [
                    [(s + w) & _M32 for s, w in zip(sigma, self.mont_mul(v, self.diag_mont[e * L :][:L]))]
                    for e, v in enumerate(x)
                ]
        out = []
        for v in x:
            v = self.mont_mul(self.fold(self.add_lazy(v, zero), self.plan[-1][0]), self.rho)
            d, borrow = [], 0
            for k in range(L):
                w = v[k] - self.p[k] - borrow
                borrow = int(w < 0)
                d.append(w & _M24)
            out.append(v if borrow else d)
        return out


def cut_rounds(cfg):
    """``cfg`` with its own constants, rounds cut to R_F = 4, R_P = 6: two
    external rounds on each side, six internal ones."""
    return dataclasses.replace(cfg, full_rounds=4, partial_rounds=6, internal_rc=cfg.internal_rc[:6],
                               external_rc=cfg.external_rc[:2] + cfg.external_rc[-2:])


DEFAULT_EMULATED = {
    "bls12_381_fr-t3": lambda: st.get_default_poseidon2_parameters(st.BLS12_381_FR, 2),
    # a wide state (t L > 40 words: one element's S-box at a time), cut in rounds
    "bls12_381_fr-t8-cut": lambda: cut_rounds(st.get_default_poseidon2_parameters(st.BLS12_381_FR, 7)),
    "goldilocks_fr-t12": lambda: st.get_default_poseidon2_parameters(st.GOLDILOCKS_FR, 8),
}


@pytest.mark.parametrize("name", ["low-t8", "t4", "bls12_381_fr-t3", "bls12_381_fr-t8-cut", "goldilocks_fr-t12"])
def test_kernel_emulation_matches_oracle(name):
    if name in DEFAULT_EMULATED:
        cfg = DEFAULT_EMULATED[name]()
    else:
        cfg = interop.config_from_jax(TINY[name]())
    fs, kern = cfg.field, _Kernel3(cfg)
    vals = lanes(fs.modulus, cfg.t, 4, 13)
    want = oracle_permute(cfg, vals)
    for b in range(4):
        limbs = [[int(v) for v in fs.ints_to_mont_plane([row[b]])[:, 0]] for row in vals]
        out = kern.permute(limbs)
        assert all(w <= _M24 for v in out for w in v)
        assert [fs.from_mont(fs.limbs_to_int(v)) for v in out] == [row[b] for row in want], b


# ---- the one-word body ----

FR25 = st.FieldSpec(name="tiny_fr_25", modulus=(1 << 25) - 39, generator=3)
TINY35 = interop.field_for_modulus(TINY_FR.modulus)


def _reversed_rows(cfg):
    """``cfg`` with M_E's rows reversed: no longer circ(2 M4, M4, ...)."""
    return dataclasses.replace(cfg, mat_e=tuple(reversed(cfg.mat_e)))


WORD_CONFIGS = {
    "babybear_fr-t16": lambda: st.get_default_poseidon2_parameters(st.BABYBEAR_FR, 8),
    "koalabear_fr-t16": lambda: st.get_default_poseidon2_parameters(st.KOALABEAR_FR, 8),
    "mersenne31_fr-t16": lambda: st.get_default_poseidon2_parameters(st.MERSENNE31_FR, 8),
    "babybear_fr-t16-dense": lambda: _reversed_rows(st.get_default_poseidon2_parameters(st.BABYBEAR_FR, 8)),
    "tiny_fr_25-t8": lambda: st.generate_poseidon2_parameters(FR25, 7, 5, 4, 4),
    "tiny_fr_25-t3": lambda: st.generate_poseidon2_parameters(FR25, 2, 5, 4, 8),
}


class _WordKernel3:
    """csrc/poseidon2.cu's one-word body for one lane: uint32 words and
    uint64 products, each checked against the bound the replay claims."""

    def __init__(self, cfg):
        self.cfg, self.t = cfg, cfg.t
        layout = constant_layout(cfg)
        c = [int(v) & _M32 for v in kernel_constants(cfg)[layout_size(layout[:LIMB_SECTIONS]) :]]
        self.p, self.n0, self.to_word, self.from_word, self.barrett = c[:5]
        t, rf, rp = cfg.t, cfg.full_rounds, cfg.partial_rounds
        self.ext, self.int = c[5 : 5 + rf * t], c[5 + rf * t : 5 + rf * t + rp]
        self.diag = c[5 + rf * t + rp : 5 + rf * t + rp + t]
        self.mat = c[5 + rf * t + rp + t :]
        self.structured = check_p2_bounds(cfg).structured

    def mul(self, a, b):
        """``word_mul``: (a b + q p) / 2^32 with a b + q p below 2^64."""
        t = a * b
        q = ((t & _M32) * self.n0) & _M32
        u = t + q * self.p
        assert u < 1 << 64 and u & _M32 == 0
        return u >> 32

    def sub(self, v):
        """``word_sub``: min(v, v - p) on an input below 2p."""
        assert v < 2 * self.p
        return min(v, (v - self.p) & _M32)

    def reduce_wide(self, s):
        assert s < 1 << 40
        q = ((((s >> 8) & _M32) * self.barrett) & _M64) >> 40
        r = (s - q * self.p) & _M32
        assert r < 2 * self.p and (r - s) % self.p == 0
        return r

    def external(self, x):
        t = self.t
        if self.structured:
            z = []
            for ch in range(0, t, 4):
                x0, x1, x2, x3 = x[ch : ch + 4]
                t0, t1 = x0 + x1, x2 + x3
                t2, t3 = 2 * x1 + t1, 2 * x3 + t0
                t4, t5 = 4 * t1 + t3, 4 * t0 + t2
                z += [t3 + t5, t5, t2 + t4, t4]
            s = [sum(z[ch + j] for ch in range(0, t, 4)) for j in range(4)]
            z = [v + s[i % 4] for i, v in enumerate(z)]
        else:
            z = [sum(self.mat[i * t + j] * x[j] for j in range(t)) for i in range(t)]
        return [self.reduce_wide(v) for v in z]

    def sbox(self, xs):
        base, alpha = list(xs), self.cfg.alpha
        for bit in range(alpha.bit_length() - 2, -1, -1):
            xs = [self.sub(self.mul(x, x)) for x in xs]
            if (alpha >> bit) & 1:
                xs = [self.sub(self.mul(x, b)) for x, b in zip(xs, base)]
        return xs

    def permute(self, limbs):
        cfg, t = self.cfg, self.t
        half = cfg.full_rounds // 2
        x = self.external([self.mul(lo | (hi << 24), self.to_word) for lo, hi in limbs])
        for r in range(cfg.full_rounds + cfg.partial_rounds):
            if r < half or r >= half + cfg.partial_rounds:
                re = r if r < half else r - cfg.partial_rounds
                x = [self.sub(self.sub(v) + self.ext[re * t + e]) for e, v in enumerate(x)]
                x = self.external(self.sbox(x))
                continue
            x[0] = self.sbox([self.sub(self.sub(x[0]) + self.int[r - half])])[0]
            sigma = self.sub(self.reduce_wide(sum(x)))
            x = [sigma + self.sub(self.mul(v, d)) for v, d in zip(x, self.diag)]
            assert all(v < 1 << 32 for v in x)
        out = [self.sub(self.mul(v, self.from_word)) for v in x]
        return [[v & _M24, v >> 24] for v in out]


@pytest.mark.parametrize("name", list(WORD_CONFIGS))
def test_word_kernel_emulation_matches_oracle(name):
    """The one-word body on edge lanes (0, 1, p-1, p-2 in every element
    position) and random ones equals the oracle, and every intermediate
    stays inside the bound the replay proves."""
    cfg = WORD_CONFIGS[name]()
    fs, kern = cfg.field, _WordKernel3(cfg)
    assert kern.structured == m4_structured(cfg.mat_e) == (cfg.t > 3 and not name.endswith("dense"))
    vals = lanes(fs.modulus, cfg.t, 6, 17)
    want = oracle_permute(cfg, vals)
    for b in range(6):
        limbs = [[int(v) for v in fs.ints_to_mont_plane([row[b]])[:, 0]] for row in vals]
        out = kern.permute(limbs)
        assert [fs.from_mont(fs.limbs_to_int(v)) for v in out] == [row[b] for row in want], b


def test_body_choice():
    """The one-word body at every field below 2^31, the limb body at every
    other field (the 255-bit ones, the 35-bit and 44-bit test fields)."""
    limb = [
        st.get_default_poseidon2_parameters(st.BLS12_381_FR, 2),
        st.get_default_poseidon2_parameters(st.BN254_FR, 2),
        st.get_default_poseidon2_parameters(st.BLS12_377_FR, 2),
        interop.config_from_jax(tiny_poseidon2_config()),
        interop.config_from_jax(TINY["low-t8"]()),
    ]
    for cfg in limb:
        plan = check_p2_bounds(cfg)
        assert plan.body == "limb" and plan == p2_plan(cfg), cfg.field.name
        assert "word_head" not in dict(constant_layout(cfg))
    for name, make in WORD_CONFIGS.items():
        cfg = make()
        plan = check_p2_bounds(cfg)
        assert plan.body == "word" and plan.folds == () and plan.wmax <= 1 << 32, name
        assert plan.vmax < 1 << 40


def test_word_replay_refuses_overflow():
    """Row sums past reduce_wide's range (2^40) are refused; so is a field at
    2^31 or above for the one-word replay."""
    bb = st.get_default_poseidon2_parameters(st.BABYBEAR_FR, 8)
    big = dataclasses.replace(bb, mat_e=tuple(tuple(1 << 10 for _ in row) for row in bb.mat_e))
    with pytest.raises(ValueError, match="row sum"):
        check_p2_bounds(big)
    from sponge_tpu_torch.ops.bounds import _P2WordSim

    with pytest.raises(ValueError, match="2\\^31"):
        _P2WordSim(st.get_default_poseidon2_parameters(st.GOLDILOCKS_FR, 8))


def test_launch_args_per_body():
    """The wrapper's C arguments: the limb body gets the limb sections and the
    fold table, the one-word body its section; a body with no instantiation
    at (t, L) raises."""
    bb = st.get_default_poseidon2_parameters(st.BABYBEAR_FR, 8)
    consts = st.Poseidon2Permutation(bb, "cpu").consts
    args = _launch_args(bb, consts)
    layout = constant_layout(bb)
    limb_words = layout_size(layout[:LIMB_SECTIONS])
    assert args[0] == 2 and args[6] == layout_size(layout) - limb_words and args[7] is None
    assert args[5] == consts.data_ptr() + 4 * limb_words
    tiny = interop.config_from_jax(tiny_poseidon2_config())
    args = _launch_args(tiny, st.Poseidon2Permutation(tiny, "cpu").consts)
    assert args[0] == 0 and args[6] == layout_size(constant_layout(tiny))
    wide = st.generate_poseidon2_parameters(TINY35, 15, 5, 4, 4)  # a limb field at t = 16
    with pytest.raises(NotImplementedError, match="limb body"):
        _launch_args(wide, st.Poseidon2Permutation(wide, "cpu").consts)


# ---- dispatch ----


def test_dispatch_on_cpu():
    cfg = interop.config_from_jax(tiny_poseidon2_config())
    vals = lanes(cfg.field.modulus, cfg.t, 8, 21)
    state = ints_to_mont_tensor(cfg.field, vals, "cpu")
    out = st.batched_permute(cfg, state)  # "auto" on a CPU tensor: the plain version
    assert torch.equal(out, st.batched_permute(cfg, state, "plain"))
    assert mont_tensor_to_ints(cfg.field, out) == oracle_permute(cfg, vals)
    with pytest.raises(ValueError, match="CUDA kernel"):
        st.batched_permute(cfg, state, "kernel")
    with pytest.raises(ValueError, match="unknown backend"):
        st.batched_permute(cfg, state, "opt")
    perm = st.Poseidon2Permutation(cfg, "cpu")
    with pytest.raises(ValueError, match="no kernel for device"):
        permute_p2(cfg, perm.consts.to("meta"), state.to("meta"))
    with pytest.raises(ValueError, match="constants"):
        permute_p2(cfg, perm.consts[:-1], state)
    with pytest.raises(NotImplementedError):
        st.batched_permute(tiny_poseidon2_config(), state)  # a JAX config
    with pytest.raises(NotImplementedError):
        _build.check_instantiated("sponge_poseidon2", 13, 2)
    for t, L in _build.INSTANTIATIONS["sponge_poseidon2"]:
        _build.check_instantiated("sponge_poseidon2", t, L)


# ---- entry points over the plain tier ----


def test_sponges_match_oracle():
    cfg = interop.config_from_jax(tiny_poseidon2_config())
    fs = cfg.field
    B = 4
    rng = np.random.default_rng(3)
    lanes_ = [[st.Fp(int(rng.integers(0, fs.modulus)), fs) for _ in range(5)] for _ in range(B)]
    for sponge in (
        st.PoseidonSponge(cfg, batch_size=B, lazy=False, device="cpu"),
        st.LazyPoseidonSponge(cfg, batch_size=B, device="cpu"),
    ):
        oracles = [OraclePoseidon2Sponge(cfg) for _ in range(B)]
        sponge.absorb(st.Batched(lanes_))
        sponge.absorb(b"poseidon2")
        for o, lane in zip(oracles, lanes_):
            o.absorb(lane)
            o.absorb(b"poseidon2")
        assert sponge.squeeze_native_field_elements(4) == [
            o.squeeze_native_field_elements(4) for o in oracles
        ]
        assert sponge.squeeze_bytes(11) == [o.squeeze_bytes(11) for o in oracles]
        assert sponge.squeeze_bits(45) == [o.squeeze_bits(45) for o in oracles]


def test_transcript_and_hash_match_oracle():
    cfg = interop.config_from_jax(tiny_poseidon2_config())
    fs, B = cfg.field, 4
    vals = lanes(fs.modulus, 4, B, 42)
    plane = ints_to_mont_tensor(fs, vals, "cpu")
    steps = [st.TranscriptAbsorb(3), st.TranscriptSqueeze(2), st.TranscriptAbsorb(1),
             st.TranscriptSqueeze(1)]
    out = st.compile_transcript(cfg, steps)(plane)
    hashed = mont_tensor_to_ints(fs, hash_elements(cfg, plane, 3))
    for b in range(B):
        o = OraclePoseidon2Sponge(cfg)
        o.absorb_field_elements([vals[k][b] for k in range(3)])
        want = o.squeeze_native_field_elements(2)
        o.absorb_field_elements([vals[3][b]])
        want += o.squeeze_native_field_elements(1)
        assert [fs.limbs_to_int(out[k, :, b].numpy()) for k in range(3)] == want, b
        o = OraclePoseidon2Sponge(cfg)
        o.absorb_field_elements([vals[k][b] for k in range(4)])
        assert [hashed[k][b] for k in range(3)] == o.squeeze_native_field_elements(3), b


def test_merkle_root_matches_oracle():
    cfg = interop.config_from_jax(tiny_poseidon2_config())
    fs = cfg.field
    leaves = lanes(fs.modulus, 1, 16, 77)[0]
    root = merkle_root(cfg, ints_to_mont_tensor(fs, leaves, "cpu"))
    level = leaves
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level), 2):
            o = OraclePoseidon2Sponge(cfg)
            o.absorb_field_elements(level[i : i + 2])
            nxt.append(o.squeeze_native_field_elements(1)[0])
        level = nxt
    assert mont_tensor_to_ints(fs, root[:, None]) == level


def test_interop_from_device_constants():
    jcfg = TINY["t4"]()
    c = jax_device_constants2(jcfg)
    cfg = interop.poseidon2_config_from_device_constants(
        c["ext"], c["internal"], c["mat_e"], c["diag_m1"], modulus=jcfg.field.modulus,
        limb_bits=jcfg.field.limb_bits, alpha=jcfg.alpha, rate=jcfg.rate,
    )
    assert cfg == interop.config_from_jax(jcfg)
    from sponge_tpu_torch.poseidon2.permutation import device_constants2

    mine = device_constants2(cfg)
    back = interop.poseidon2_config_from_device_constants(
        mine["ext"], mine["internal"], mine["mat_e"], mine["diag_m1"],
        modulus=cfg.field.modulus, limb_bits=24, alpha=cfg.alpha, rate=cfg.rate,
    )
    assert back == cfg
