"""Kernel 2 (the dense Poseidon permutation) and its three bodies.

Word-by-word emulations of ``csrc/poseidon_dense.cu``'s limb body
(``Kernel2``: 24-bit limbs in 32-bit words, 64-bit REDC columns, the
constants read in the staged buffer's order, a full round's S-boxes by
``pow_sqr`` squaring with ``mont_sqr``) and ``csrc/poseidon_dense_words.cu``'s
one-word body (``Kernel2Word``: one Montgomery word at R' = 2^32, MDS rows
in groups of four products) and two-word body (``Kernel2GL``: 64-bit words
in plain form, rows in a five-word accumulator) against the scalar oracle
on seeded lanes and lanes of 0, 1, p-1 and p-2, each holding its replay's
limits (``ops/bounds.py``); the limb emulation against the JAX package's
Pallas kernel in interpret mode on the 35-bit test field; the word replays'
refusals; the body choice over every default config; the wrapper's launch
arguments, with no fallback from a body to another.  Equality is exact
(tolerance 0) on canonical values.  The CUDA kernel itself runs on the card
(``chip_smoke.py``).
"""

import pathlib
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import TINY_FR, tiny_poseidon_config
from test_torch_gmimc import _M24, _M32, _M64, Kernel8Word, emulate
from test_torch_permutation import TINY, Kernel1, cut_rounds, default_poseidon_configs, jax_ints, lanes
from test_torch_widths import jax_config, jax_oracle_lanes

import sponge_tpu
import sponge_tpu_torch as st
from sponge_tpu.ops.pallas_permute import pallas_permute_fn
from sponge_tpu_torch import interop
from sponge_tpu_torch.ops import _build
from sponge_tpu_torch.ops import poseidon_dense as dense
from sponge_tpu_torch.ops.bounds import (
    DENSE_WORD_GROUP,
    _DenseGLSim,
    check_dense_gl_bounds,
    check_dense_word_bounds,
    check_kernel_bounds,
)
from sponge_tpu_torch.poseidon.config import kernel_constants
from sponge_tpu_torch.poseidon.oracle import OraclePoseidonSponge

_EPS = (1 << 32) - 1  # 2^64 mod p at Goldilocks


def oracle_lanes(cfg, vals):
    """[t][B] -> [t][B] through the port's scalar oracle."""
    out = []
    for b in range(len(vals[0])):
        o = OraclePoseidonSponge(cfg)
        o.state = [row[b] for row in vals]
        o.permute()
        out.append(o.state)
    return [list(col) for col in zip(*out)]


# ---- the limb body ----


class Kernel2(Kernel1):
    """``poseidon_dense_kernel`` for one lane: per round the round
    constants added to every element (``add_const`` from the staged
    buffer), x^alpha by ``pow_sqr`` (squarings by ``mont_sqr``) on all t
    elements in lockstep in a full round (at a wide state one chain on x[0]
    and the state rotated by one, t times: the same words) or on element 0
    in a partial round, then the MDS
    rows (``mont_row``: t products in one set of columns, one REDC), then
    ``store``.  ``vmax`` is the largest value any element reached,
    ``colmax`` the largest REDC column."""

    def permute(self, x):
        cfg, c = self.cfg, self.c
        half = cfg.full_rounds // 2
        for r in range(cfg.rounds):
            x = self.add(x, c["ark"][r])
            if half <= r < half + cfg.partial_rounds:
                x = self.pow_sqr(x[:1]) + x[1:]
            elif self.wide:
                x = [self.pow_sqr([v])[0] for v in x]
            else:
                x = self.pow_sqr(x)
            x = self.mat_apply(x, c["mds"])
        return [self.store(v) for v in x]


def _tiny17():
    return interop.config_from_jax(tiny_poseidon_config(**TINY["alpha17"]))


LIMB = {
    "bls12_381-r2": lambda: st.get_default_poseidon_parameters(st.BLS12_381_FR, 2),
    "bn254-r2": lambda: st.get_default_poseidon_parameters(st.BN254_FR, 2),
    "bls12_381-r8-cut": lambda: cut_rounds(st.get_default_poseidon_parameters(st.BLS12_381_FR, 8)),
    "tiny35-alpha17": _tiny17,
}


@pytest.mark.parametrize("name", list(LIMB))
def test_limb_emulation_matches_oracle(name):
    """The limb body's word order on seeded lanes and lanes of 0, 1, p-1,
    p-2 against the oracle; every REDC column (squarings' included) below
    2^63, every value below the replay's bound (``check_kernel_bounds``),
    which the lanes come within 4x of."""
    cfg = LIMB[name]()
    assert dense.body(cfg) == "limb" and (cfg.t, cfg.field.nlimbs) in dense.BODIES["limb"]
    vals = lanes(cfg.field.modulus, cfg.t, 16, 31)
    kernel = Kernel2(cfg)
    assert emulate(cfg, kernel, vals) == oracle_lanes(cfg, vals)
    assert kernel.colmax < 1 << 63
    vmax = check_kernel_bounds(cfg, False)
    assert vmax // 4 < kernel.vmax < vmax


def test_limb_emulation_matches_pallas_permute_interpret():
    """On the 35-bit test field (t = 3, alpha = 5) the limb body's word
    order equals the JAX package's Pallas kernel ``pallas_permute_fn`` run
    in interpret mode."""
    jcfg = tiny_poseidon_config(**TINY["alpha5"])
    cfg = interop.config_from_jax(jcfg)
    vals = lanes(TINY_FR.modulus, jcfg.t, 128, 3)
    jstate = jnp.asarray(np.stack([TINY_FR.ints_to_mont_plane(r) for r in vals]))
    ref = pallas_permute_fn(jcfg, tile=128, interpret=True)(jstate)
    assert emulate(cfg, Kernel2(cfg), vals) == jax_ints(ref)


# ---- the word bodies ----


class Kernel2Word:
    """``poseidon_dense_word_kernel`` for one lane: canonical words at
    R' = 2^32 (``word_mul``, ``word_sub``), each MDS row (``word_row``) in
    groups of ``DENSE_WORD_GROUP`` products, their high and low words summed
    apart, one REDC of the low sum, ``reduce_wide`` and ``word_sub``.  Every
    step asserts the limit the replay proves; ``vmax`` is the largest row
    total."""

    def __init__(self, cfg):
        self.cfg, self.vmax = cfg, 0
        w = [int(v) & _M32 for v in dense.word_constants(cfg)]
        self.p, self.n0, self.to_word, self.from_word, self.barrett = w[:5]
        n = cfg.rounds * cfg.t
        self.ark, self.mds = w[5 : 5 + n], w[5 + n :]

    def mul(self, a, b):
        t = a * b
        s = t + ((t & _M32) * self.n0 & _M32) * self.p
        assert s < 1 << 64
        return s >> 32

    def sub(self, v):
        assert v < 2 * self.p
        return min(v, (v - self.p) & _M32)

    def reduce_wide(self, s):
        assert s < 1 << 40
        q = ((s >> 8) * self.barrett) >> 40
        v = (s - q * self.p) & _M32
        assert v == s % self.p or v == s % self.p + self.p
        return v

    def row(self, x, m):
        hi = lo = 0
        for g in range(0, len(x), DENSE_WORD_GROUP):
            s = sum(a * b for a, b in zip(x[g : g + DENSE_WORD_GROUP], m[g : g + DENSE_WORD_GROUP]))
            assert s < 1 << 64
            hi, lo = hi + (s >> 32), lo + (s & _M32)
        r = lo + ((lo & _M32) * self.n0 & _M32) * self.p
        assert r < 1 << 64
        total = hi + (r >> 32)
        self.vmax = max(self.vmax, total + 1)
        return self.sub(self.reduce_wide(total))

    def sbox(self, xs):
        base = list(xs)
        for bit in bin(self.cfg.alpha)[3:]:
            xs = [self.sub(self.mul(v, v)) for v in xs]
            if bit == "1":
                xs = [self.sub(self.mul(v, b)) for v, b in zip(xs, base)]
        return xs

    def permute(self, limbs):
        cfg, t = self.cfg, self.cfg.t
        half = cfg.full_rounds // 2
        x = [self.sub(self.mul(l0 | l1 << 24, self.to_word)) for l0, l1 in limbs]
        for r in range(cfg.rounds):
            x = [self.sub(v + c) for v, c in zip(x, self.ark[r * t : (r + 1) * t])]
            x = self.sbox(x[:1]) + x[1:] if half <= r < half + cfg.partial_rounds else self.sbox(x)
            x = [self.row(x, self.mds[i * t : (i + 1) * t]) for i in range(t)]
        out = [self.sub(self.mul(v, self.from_word)) for v in x]
        return [[v & _M24, v >> 24] for v in out]


class Kernel2GL(Kernel8Word):
    """``poseidon_dense_gl_kernel`` for one lane: 64-bit words in plain
    form, products by ``Kernel8Word.mul`` (``GL_REDUCE_N``), ARK by
    ``gl_add``, each MDS row's t 128-bit products summed exactly and reduced
    by ``gl_reduce5`` (V = lo - n3 - n2 + (n2 - n4) 2^32, its top word s
    added back as s (2^32 - 1)).  ``tmax`` is the largest row sum's top word
    n4."""

    def __init__(self, cfg):
        self.cfg, self.tmax = cfg, 0
        w = [int(v) & _M32 for v in dense.word_constants(cfg)]
        pairs = [w[i] | w[i + 1] << 32 for i in range(0, len(w), 2)]
        n = cfg.rounds * cfg.t
        self.to_word, self.from_word = pairs[:2]
        self.ark, self.mds = pairs[2 : 2 + n], pairs[2 + n :]

    @staticmethod
    def add(x, c):
        s = x + c
        if s > _M64:
            s = s - (1 << 64) + _EPS
        assert s <= _M64
        return s

    def reduce5(self, n):
        assert 0 <= n < 1 << 160
        self.tmax = max(self.tmax, n >> 128)
        lo, n2, n3, n4 = n & _M64, (n >> 64) & _M32, (n >> 96) & _M32, n >> 128
        v = lo - n3 - n2 + (n2 - n4) * (1 << 32)
        s = v >> 64
        assert s in (-1, 0, 1)
        r = (v & _M64) + s * _EPS
        assert 0 <= r <= _M64
        return r

    def permute(self, limbs):
        cfg, t, p = self.cfg, self.cfg.t, self.cfg.field.modulus
        half = cfg.full_rounds // 2
        x = [self.mul(l0 | l1 << 24 | l2 << 48, self.to_word) for l0, l1, l2 in limbs]
        for r in range(cfg.rounds):
            x = [self.add(v, c) for v, c in zip(x, self.ark[r * t : (r + 1) * t])]
            if half <= r < half + cfg.partial_rounds:
                x[0] = self.pow(x[0], cfg.alpha)
            else:
                x = [self.pow(v, cfg.alpha) for v in x]
            x = [self.reduce5(sum(a * b for a, b in zip(x, self.mds[i * t : (i + 1) * t]))) for i in range(t)]
        out = []
        for v in x:
            v = self.mul(v, self.from_word)
            v = v - p if v >= p else v
            out.append([v & _M24, (v >> 24) & _M24, v >> 48])
        return out


WORDS = {
    "goldilocks-r4": ("GOLDILOCKS_FR", "two-word"),
    "goldilocks-r8": ("GOLDILOCKS_FR", "two-word"),
    "babybear-r8": ("BABYBEAR_FR", "one-word"),
    "koalabear-r8": ("KOALABEAR_FR", "one-word"),
    "mersenne31-r8": ("MERSENNE31_FR", "one-word"),
}


@pytest.mark.parametrize("name", list(WORDS))
def test_word_emulation_matches_oracle(name):
    """Each word body's words on seeded lanes, lanes of 0, 1, p-1, p-2
    across the element positions and lanes of all p-1 and all p-2 (the
    largest inputs) against the port's oracle and the JAX package's, at the
    default config (all rounds; its constants equal the JAX package's
    default); every group sum below 2^64, row total below 2^40 and row sum
    below 2^160 as the emulations assert, and the row totals (one word) or
    top words (two words) within the replay's bound."""
    field, kind = WORDS[name]
    rate = int(name.split("-r")[1])
    cfg = st.get_default_poseidon_parameters(getattr(st, field), rate)
    jcfg = jax_config(cfg)
    assert jcfg == sponge_tpu.get_default_poseidon_parameters(getattr(sponge_tpu, field), rate)
    assert dense.body(cfg) == kind and (cfg.t, cfg.field.nlimbs) in dense.BODIES[kind]
    p = cfg.field.modulus
    vals = [row + [p - 1, p - 2] for row in lanes(p, cfg.t, 16, 37)]
    want = jax_oracle_lanes(jcfg, vals)
    assert oracle_lanes(cfg, vals) == want
    kernel = Kernel2Word(cfg) if kind == "one-word" else Kernel2GL(cfg)
    assert emulate(cfg, kernel, vals) == want
    if kind == "one-word":
        assert check_dense_word_bounds(cfg) // 4 < kernel.vmax <= check_dense_word_bounds(cfg)
    else:
        assert 0 < kernel.tmax <= check_dense_gl_bounds(cfg) == cfg.t - 1


def _wide_m31():
    """Mersenne31 at t = 1024 (two full rounds): each row's 256 group sums
    carry 2^40 into its high sum, past ``reduce_wide``'s range."""
    t, one = 1024, (1,) * 1024
    return st.PoseidonConfig(field=st.MERSENNE31_FR, full_rounds=2, partial_rounds=0, alpha=5,
                             ark=(one, one), mds=(one,) * t, rate=t - 1)


def _config(fs, t=3, rounds=(8, 4), alpha=5):
    rng = np.random.default_rng(7)
    draw = lambda: int(rng.integers(0, 1 << 62)) % fs.modulus  # noqa: E731
    return st.PoseidonConfig(field=fs, full_rounds=rounds[0], partial_rounds=rounds[1], alpha=alpha,
                             ark=tuple(tuple(draw() for _ in range(t)) for _ in range(sum(rounds))),
                             mds=tuple(tuple(draw() for _ in range(t)) for _ in range(t)), rate=t - 1)


class _NoArkFold(_DenseGLSim):
    """The two-word replay with ARK's carry left out: the sum can pass
    2^64 and reach a product."""

    def add_const(self, x):
        return x[0] + self.p - 1, 1


REFUSALS = {
    "one-word-t1024": (lambda: check_dense_word_bounds(_wide_m31()), "reduce_wide takes below 2\\^40"),
    "one-word-32-bit-field": (
        lambda: check_dense_word_bounds(_config(st.FieldSpec(name="f32", modulus=(1 << 32) - 5, generator=2))),
        "2\\^16 < p < 2\\^31"),
    "two-word-babybear": (lambda: check_dense_gl_bounds(_config(st.BABYBEAR_FR)), "2\\^64 - 2\\^32"),
    "two-word-no-ark-fold": (
        lambda: _NoArkFold(st.get_default_poseidon_parameters(st.GOLDILOCKS_FR, 4)).run(),
        "a product input can reach 2\\^65"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_word_replays_refuse_overflowing_configs(name):
    """Each word replay refuses what would overflow its body: a one-word
    row total past 2^40 (t = 1024), a field of 32 bits, a field other than
    Goldilocks for the two-word body, and an ARK add whose carry is not
    brought back."""
    check, match = REFUSALS[name]
    with pytest.raises(ValueError, match=match):
        check()


def test_word_group_matches_the_source():
    text = (pathlib.Path(_build.CSRC) / "poseidon_dense_words.cu").read_text()
    assert int(re.search(r"constexpr int kWordGroup = (\d+);", text)[1]) == DENSE_WORD_GROUP
    assert 4 * (st.MERSENNE31_FR.modulus - 1) ** 2 < 1 << 64 <= 5 * (st.BABYBEAR_FR.modulus - 1) ** 2


# ---- the body choice and the wrapper ----


def test_body_choice_for_every_default_config():
    """All 52 default configs: the one-word body at the 31-bit fields (16, 2),
    the two-word body at Goldilocks (8, 3) and (12, 3), the limb body at the
    ~255-bit fields; each body's pair is compiled, each replay admits its
    configs, and the bodies' pairs make up ``_build.INSTANTIATIONS``."""
    assert frozenset().union(*dense.BODIES.values()) == _build.INSTANTIATIONS["sponge_poseidon_dense"]
    configs = default_poseidon_configs()
    assert len(configs) == 52
    want = {2: "one-word", 3: "two-word", 11: "limb"}
    for label, cfg in configs.items():
        kind = dense.body(cfg)
        assert kind == want[cfg.field.nlimbs], label
        assert (cfg.t, cfg.field.nlimbs) in dense.BODIES[kind], label
        words = {"limb": 0, "one-word": 5 + cfg.rounds * cfg.t + cfg.t ** 2,
                 "two-word": 2 * (2 + cfg.rounds * cfg.t + cfg.t ** 2)}[kind]
        assert len(dense.word_constants(cfg)) == words, label
    counts = {k: sum(dense.body(c) == k for c in configs.values()) for k in dense.BODY_CODES}
    assert counts == {"limb": 42, "one-word": 6, "two-word": 4}


def test_launch_args_by_body():
    """The wrapper's C arguments: the limb body the common head and body 0;
    a word body its code, its own constant buffer (the module's ``words``
    buffer, not kernel 1's) and its length, and refuses to launch without
    it; kernel 1 the head alone.  A config whose body lacks its pair
    raises NotImplementedError, though the limb body has the pair: no
    fallback."""
    bls = st.get_default_poseidon_parameters(st.BLS12_381_FR, 2)
    perm = st.PoseidonPermutation(bls, "cpu")
    consts = perm.consts
    head = (bls.alpha, bls.full_rounds, bls.partial_rounds, consts.data_ptr(), bls.field.n0inv)
    assert dense._launch_args(bls, consts) == head + (0, None, 0)
    assert dense._launch_args(bls, consts, optimized=True) == head
    assert perm.words.numel() == 0 and [name for name, _ in perm.named_buffers()] == ["consts", "words"]
    for field, rate, code in (("BABYBEAR_FR", 8, 1), ("GOLDILOCKS_FR", 8, 2)):
        cfg = st.get_default_poseidon_parameters(getattr(st, field), rate)
        perm = st.PoseidonPermutation(cfg, "cpu")
        consts, words = perm.consts, perm.words
        args = dense._launch_args(cfg, consts, words=words)
        assert args[5:] == (code, words.data_ptr(), len(dense.word_constants(cfg))), field
        assert words.data_ptr() != consts.data_ptr() and torch.equal(words, torch.from_numpy(dense.word_constants(cfg)))
        for bad in (None, words[1:], words.to("meta")):
            with pytest.raises(ValueError, match="word_constants"):
                dense._launch_args(cfg, consts, words=bad)
        assert not perm.state_dict()  # both buffers are rebuilt from the config, never saved
    bb3 = _config(st.BABYBEAR_FR, alpha=7)  # (3, 2): the limb body's pair, not the one-word body's
    assert (3, 2) in dense.BODIES["limb"] and dense.body(bb3) == "one-word"
    with pytest.raises(NotImplementedError, match="one-word body"):
        dense._launch_args(bb3, st.PoseidonPermutation(bb3, "cpu").consts)


def test_word_constants_hold_the_field_and_the_round_constants():
    """One word: p, -p^-1 mod 2^32, 2^16 and 2^48 mod p, floor(2^48 / p),
    then ARK and MDS times 2^32 mod p.  Two words: 2^-72 and 2^72 mod p,
    then ARK and MDS as plain values, low word first."""
    bb = st.get_default_poseidon_parameters(st.BABYBEAR_FR, 8)
    p = bb.field.modulus
    w = [int(v) & _M32 for v in dense.word_constants(bb)]
    assert w[:5] == [p, -pow(p, -1, 1 << 32) % (1 << 32), (1 << 16) % p, (1 << 48) % p, (1 << 48) // p]
    assert w[5] == (bb.ark[0][0] << 32) % p and w[-1] == (bb.mds[-1][-1] << 32) % p
    gl = st.get_default_poseidon_parameters(st.GOLDILOCKS_FR, 4)
    p = gl.field.modulus
    w = [int(v) & _M32 for v in dense.word_constants(gl)]
    pairs = [w[i] | w[i + 1] << 32 for i in range(0, len(w), 2)]
    assert pairs[:3] == [pow(1 << 72, -1, p), (1 << 72) % p, gl.ark[0][0]] and pairs[-1] == gl.mds[-1][-1]
    assert len(dense.word_constants(st.get_default_poseidon_parameters(st.BLS12_381_FR, 2))) == 0


def test_a_body_without_its_pair_raises_on_a_cuda_tensor(monkeypatch):
    """A BabyBear config at (3, 2), a pair compiled for the limb body only,
    raises NotImplementedError for a CUDA tensor before anything runs:
    neither the plain version nor a launch."""
    cfg = _config(st.BABYBEAR_FR, alpha=7)
    cuda_state = types.SimpleNamespace(device=torch.device("cuda", 0), shape=(cfg.t, cfg.field.nlimbs, 8))

    def refuse(*args):
        raise AssertionError("ran a body without its pair")

    monkeypatch.setattr(_build, "check_state", lambda *args: None)
    monkeypatch.setattr(_build, "launch", refuse)
    monkeypatch.setattr(dense, "permute_dense_plain", refuse)
    before = dense.permute_dense.launches
    consts = torch.from_numpy(kernel_constants(cfg))
    with pytest.raises(NotImplementedError, match="kernel 2's one-word body"):
        dense.permute_dense(cfg, consts, cuda_state)
    assert dense.permute_dense.launches == before



def test_smoke_census_names_each_body():
    """``chip_smoke.py`` finds each body's instantiation and its staged
    bytes: the limb body p | ark | mds (5,588 B at BLS12-381 rate 2), a
    word body its own buffer."""
    import chip_smoke

    bls, gl, bb = (st.get_default_poseidon_parameters(getattr(st, f), r)
                   for f, r in (("BLS12_381_FR", 2), ("GOLDILOCKS_FR", 4), ("BABYBEAR_FR", 8)))
    name = "poseidon_permute_dense"
    assert chip_smoke.census_instance(name, bls) == ("poseidon_dense_kernel", (3, 11), 5588)
    assert chip_smoke.census_instance(name, gl) == ("poseidon_dense_gl_kernel", (8,), 4 * len(dense.word_constants(gl)))
    assert chip_smoke.census_instance(name, bb) == ("poseidon_dense_word_kernel", (16,), 4 * len(dense.word_constants(bb)))
    assert chip_smoke.dense_plan_text(bb).startswith("one-word body")
    assert chip_smoke.dense_plan_text(gl) == "two-word body, largest row sum 8 x 2^128"
    assert chip_smoke.dense_plan_text(bls).startswith("limb body, value bound")
