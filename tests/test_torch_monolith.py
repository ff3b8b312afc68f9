"""The port's Monolith family against the JAX package and the oracle.

Parameters, Bar functions and validation against ``sponge_tpu.monolith``;
the oracle's frozen vectors through the port's oracle and a CPU
``PoseidonSponge``; ``monolith_permute_plain`` (kernel 4's function) against
``monolith_permute_jit`` at full width on all seven configs the kernel is
instantiated for, and against the Pallas kernel body (``_monolith_kernel``
under ``jit`` with mock refs, as ``tests/test_monolith.py`` runs it) on a
generic-body and a Mersenne-body config, planes carried across with
``interop``; ``check_monolith_bounds``' plans and refusals; a word-by-word
emulation of ``csrc/monolith.cu`` (both bodies, 32-bit words, 64-bit
columns) against the oracle; dispatch; and the sponge and hashing entry
points over Monolith.  Inputs come from numpy seeds; equality is exact
(tolerance 0) on canonical values.  The CUDA kernel itself runs on the card
(``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gmimc import _M24, _M32, Words, emulate, lanes, oracle_permute, plain_matches_jax, sponge_squeeze

import sponge_tpu
from sponge_tpu.fields import FieldSpec as JaxFieldSpec
from sponge_tpu.monolith import MonolithConfig as JaxMonolithConfig
from sponge_tpu.monolith import bar_chunks as jax_bar_chunks
from sponge_tpu.monolith import bar_int as jax_bar_int
from sponge_tpu.monolith import chunk_sbox as jax_chunk_sbox
from sponge_tpu.monolith import generate_monolith_parameters as jax_generate
from sponge_tpu.monolith import get_default_monolith_parameters as jax_default
from sponge_tpu.monolith import monolith_permute_jit
from sponge_tpu.ops import pallas_monolith as pm
import sponge_tpu_torch as st
from sponge_tpu_torch import interop
from sponge_tpu_torch.fields import ints_to_mont_tensor, mont_tensor_to_ints
from sponge_tpu_torch.monolith.config import bar_chunks, bar_int, chunk_sbox, kernel_constants
from sponge_tpu_torch.ops import _build
from sponge_tpu_torch.ops.bounds import _MonolithReplay, check_monolith_bounds, mersenne_rot_shift
from sponge_tpu_torch.ops.monolith import monolith_permute, monolith_permute_plain

M13 = interop.field_for_modulus((1 << 13) - 1)  # the port's field of tests/test_monolith.py's tiny_m13
JAX_M13 = JaxFieldSpec(name="tiny_m13", modulus=(1 << 13) - 1, generator=17)
NAMES = {"gl": "GOLDILOCKS_FR", "m31": "MERSENNE31_FR", "kb": "KOALABEAR_FR", "bb": "BABYBEAR_FR"}


def jax_config(name):
    """The JAX config of ``name``: a default (field-rate), a dense
    capacity-2 test config (field-t4) or the 13-bit Mersenne field (m13)."""
    if name == "m13":
        return jax_generate(JAX_M13, 2, 2, 6, 2)
    field, geo = name.split("-")
    jfs = getattr(sponge_tpu, NAMES[field])
    if geo == "t4":
        return jax_generate(jfs, 2, 2, 6, 2)
    return jax_default(jfs, int(geo[1:]))


def port_config(name):
    if name == "m13":
        return st.generate_monolith_parameters(M13, 2, 2, 6, 2)
    field, geo = name.split("-")
    fs = getattr(st, NAMES[field])
    if geo == "t4":
        return st.generate_monolith_parameters(fs, 2, 2, 6, 2)
    return st.get_default_monolith_parameters(fs, int(geo[1:]))


# The configs kernel 4 is instantiated for: GL t = 12 and 8, the 31-bit
# fields at t = 16, and the dense KoalaBear and Mersenne31 t = 4 configs.
KERNEL_CONFIGS = ["gl-r8", "gl-r4", "m31-r8", "kb-r8", "bb-r8", "kb-t4", "m31-t4"]


# ---- parameters, Bars and validation ----


@pytest.mark.parametrize("name", KERNEL_CONFIGS + ["m13"])
def test_parameters_equal_jax(name):
    cfg = port_config(name)
    assert cfg == interop.config_from_jax(jax_config(name))
    assert cfg.concrete_small_entries() == jax_config(name).concrete_small_entries()
    assert cfg.pow2_circulant_exponents() == jax_config(name).pow2_circulant_exponents()


@pytest.mark.parametrize("field", ["gl", "m31", "kb", "bb", "m13"])
def test_bar_functions_match_jax(field):
    fs, jfs = (M13, JAX_M13) if field == "m13" else (getattr(st, NAMES[field]), getattr(sponge_tpu, NAMES[field]))
    assert bar_chunks(fs) == jax_bar_chunks(jfs)
    for k in set(bar_chunks(fs)):
        assert [chunk_sbox(y, k) for y in range(1 << k)] == [jax_chunk_sbox(y, k) for y in range(1 << k)]
    rng = np.random.default_rng(3)
    vals = [0, 1, fs.modulus - 1, fs.modulus - 2] + [int(v) % fs.modulus for v in rng.integers(0, 2**62, 200)]
    assert [bar_int(fs, v) for v in vals] == [jax_bar_int(jfs, v) for v in vals]
    assert all(bar_int(fs, v) < fs.modulus for v in vals)


def _validation_cases():
    m31 = dict(field=None, rounds=2, bars=2, rc=((1,) * 4, (0,) * 4), concrete=((1,) * 4,) * 4, rate=2, capacity=2)
    return {
        "last-rc-row": dict(m31, rc=((1,) * 4, (1,) * 4)),
        "bars": dict(m31, bars=5),
        "rounds": dict(m31, rounds=0, rc=()),
        "rc-rows": dict(m31, rounds=3),
        "rc-width": dict(m31, rc=((1,) * 3, (0,) * 4)),
        "concrete": dict(m31, concrete=((1,) * 4,) * 3),
    }


@pytest.mark.parametrize("case", list(_validation_cases()) + ["bar-safety"])
def test_validation_errors_match_jax(case):
    if case == "bar-safety":
        kw = dict(_validation_cases()["bars"], bars=2)
        port, jax_ = dict(kw, field=st.BLS12_381_FR), dict(kw, field=sponge_tpu.BLS12_381_FR)
    else:
        kw = _validation_cases()[case]
        port, jax_ = dict(kw, field=st.MERSENNE31_FR), dict(kw, field=sponge_tpu.MERSENNE31_FR)
    with pytest.raises(ValueError) as want:
        JaxMonolithConfig(**jax_)
    with pytest.raises(ValueError) as got:
        st.MonolithConfig(**port)
    assert str(got.value) == str(want.value)


def test_default_lookup_refuses_like_jax():
    with pytest.raises(ValueError) as want:
        jax_default(sponge_tpu.GOLDILOCKS_FR, 2)
    with pytest.raises(ValueError) as got:
        st.get_default_monolith_parameters(st.GOLDILOCKS_FR, 2)
    assert str(got.value) == str(want.value)


# ---- oracle goldens (tests/test_monolith.py:163-177 and :380-393) ----

GOLDENS = {
    "gl-r8": (8, [5256865702680375205, 16889867171626752680, 17825305887195455664]),
    "m31-r8": (8, [1207749644, 841790736, 175126303]),
    "kb-r8": (8, [935778397, 727696613, 565866719]),
    "bb-r8": (8, [1869215551, 585220566, 752895513]),
    "gl-r4": (4, [3013020673448842056, 17604359482555244088]),
}


@pytest.mark.parametrize("name", list(GOLDENS))
def test_oracle_and_sponge_reproduce_golden_vectors(name):
    n_in, golden = GOLDENS[name]
    cfg = port_config(name)
    o = st.OracleMonolithSponge(cfg)
    o.absorb_field_elements(list(range(n_in)))
    assert o.squeeze_native_field_elements(len(golden)) == golden
    assert sponge_squeeze(cfg, list(range(n_in)), len(golden)) == golden


# ---- the plain version against the JAX tiers ----


@pytest.mark.parametrize("name", KERNEL_CONFIGS)
def test_plain_matches_monolith_permute_jit(name):
    """Full width: the whole permutation of every kernel config."""
    jcfg = jax_config(name)
    vals = lanes(jcfg.field.modulus, jcfg.t, 16, 5)  # 0, 1, p-1, p-2 in every position
    plain_matches_jax(st.MonolithPermutation, jcfg, monolith_permute_jit(jcfg), vals)


def _kernel_body(jcfg):
    """``_monolith_kernel`` (the Pallas body) under ``jit`` on mock refs,
    one lane stream, as tests/test_monolith.py runs it on the CPU."""

    class FakeRef:
        def __init__(self, arr):
            self.arr = jnp.asarray(arr)

        def __getitem__(self, idx):
            return self.arr[idx]

        def __setitem__(self, idx, value):
            self.arr = self.arr.at[idx].set(value)

    t, L = jcfg.t, jcfg.field.nlimbs
    rc = pm.monolith_rc_plane(jcfg)

    @jax.jit
    def run(state):
        B = state.shape[-1]
        out = FakeRef(jnp.zeros((t, L, B // 128, 128), jnp.int32))
        pm._monolith_kernel(FakeRef(rc), FakeRef(state.reshape(t, L, B // 128, 128)), out, cfg=jcfg, lane_streams=1)
        return out.arr.reshape(t, L, B)

    return run


@pytest.mark.parametrize("name", ["kb-t4", "m13"])
def test_plain_matches_kernel_body(name):
    """The generic body (dense KoalaBear t = 4) and the Mersenne body
    (2^13 - 1, t = 4) of the Pallas kernel, 128 lanes.  The JAX body leaves
    values below 2p; interop reduces them."""
    jcfg = jax_config(name)
    assert (pm.check_kernel_bounds(jcfg)["rot"] is None) == (name == "kb-t4")
    vals = lanes(jcfg.field.modulus, jcfg.t, 128, 17)
    plain_matches_jax(st.MonolithPermutation, jcfg, _kernel_body(jcfg), vals)


# ---- the plan of kernel 4 ----


def test_plans_of_the_instantiated_configs():
    plans = {name: check_monolith_bounds(port_config(name)) for name in KERNEL_CONFIGS + ["m13"]}
    for name in ("gl-r8", "gl-r4", "kb-r8", "bb-r8"):
        assert (plans[name].body, plans[name].concrete) == ("generic", "scaled"), name
    # Goldilocks t = 12 folds each Concrete row's high part twice and each
    # sum after + rc once; squares and Bricks sums may pass R (their words
    # stay below 2^32 and the next product's input below R)
    assert [plans[n].folds for n in ("gl-r8", "gl-r4", "kb-r8", "bb-r8")] == [
        (0, 0, 2, 1), (0, 0, 1, 1), (0, 0, 1, 1), (0, 0, 1, 1)]
    assert (plans["kb-t4"].body, plans["kb-t4"].concrete, plans["kb-t4"].folds) == ("generic", "dense", (0, 0, 0, 0))
    assert (plans["m31-r8"].body, plans["m31-r8"].concrete, plans["m31-r8"].folds) == ("mersenne", "scaled", (1, 0, 1, 0))
    assert (plans["m31-t4"].body, plans["m31-t4"].concrete, plans["m31-t4"].folds) == ("mersenne", "dense", (1, 0, 2, 0))
    assert plans["m13"].body == "mersenne" and plans["m13"].shift == 11
    # Goldilocks t = 12: row sum 70,967, so a Concrete row reaches more than
    # 70,967 R before its fold, below the fold's 2^39 R limit; every word
    # stays below 2^32.
    assert 70_967 * st.GOLDILOCKS_FR.r < plans["gl-r8"].vmax < st.GOLDILOCKS_FR.r << 39
    assert all(plan.wmax < 1 << 32 for plan in plans.values())


def test_mersenne_shift_is_derived_for_24_bit_limbs():
    """R mod p = 2^s: s = 48 mod 31 = 17 for Mersenne31 at L = 2 (the JAX
    package's 12-bit limbs give 5), 24 mod 13 = 11 for 2^13 - 1 at L = 1."""
    assert mersenne_rot_shift(st.MERSENNE31_FR) == 17
    assert pm.mersenne_rot_shift(sponge_tpu.MERSENNE31_FR) == 5
    assert mersenne_rot_shift(M13) == 11
    for fs in (M13, st.MERSENNE31_FR):
        assert fs.r_mod_p == 1 << mersenne_rot_shift(fs)
    for fs in (st.KOALABEAR_FR, st.BABYBEAR_FR, st.GOLDILOCKS_FR, st.BLS12_381_FR):
        assert mersenne_rot_shift(fs) is None


def test_plan_refusals():
    """A dense Mersenne31 row at t = 8 can reach 8 p^2 > 2^64; a generic
    plan is minimal: one fold fewer at any site lets a word pass 2^32 or a
    product input reach R."""
    with pytest.raises(ValueError, match="2\\^64"):
        check_monolith_bounds(st.generate_monolith_parameters(st.MERSENNE31_FR, 4, 4, 6, 2))
    for name in ("gl-r8", "gl-r4", "kb-r8", "bb-r8"):
        folds = check_monolith_bounds(port_config(name)).folds
        for i in range(len(folds)):
            if folds[i]:
                with pytest.raises(ValueError, match="can reach"):
                    _MonolithReplay(port_config(name), "scaled", folds[:i] + (folds[i] - 1,) + folds[i + 1 :]).run()


# ---- word-by-word emulation of csrc/monolith.cu ----


def chi_word(y, k):
    """``chi_chunk`` on 32-bit words."""
    mask = (1 << k) - 1

    def rot(v, r):
        r %= k
        return ((v << r) | (v >> (k - r))) & mask

    nb = y ^ mask
    z = y ^ (rot(nb, 1) & rot(y, 2)) if k & 1 else y ^ (rot(nb, 1) & rot(y, 2) & rot(y, 3))
    return rot(z, 1)


class Kernel4(Words):
    """``csrc/monolith.cu`` for one lane: ``monolith_kernel`` (generic body)
    or ``monolith_mersenne_kernel``, as the plan picks."""

    def __init__(self, cfg):
        super().__init__(cfg.field)
        self.cfg, self.plan = cfg, check_monolith_bounds(cfg)
        c = [int(v) for v in kernel_constants(cfg)]
        L, t = self.L, cfg.t
        self.rho, self.one, self.r2 = c[L : 2 * L], c[2 * L : 3 * L], c[3 * L : 4 * L]
        n = len(bar_chunks(cfg.field))
        self.chunks = c[4 * L : 4 * L + n]
        rc = c[4 * L + n :]
        self.rc = [[rc[(r * t + e) * L :][:L] for e in range(t)] for r in range(cfg.rounds)]
        mat = rc[cfg.rounds * t * L :]
        self.mat = [[mat[(i * t + j) * L :][:L] for j in range(t)] for i in range(t)]
        self.f_sq, self.f_add, self.f_conc, self.f_rc = self.plan.folds

    def fold(self, x, n):
        x = list(x)
        for _ in range(n):
            c = x[-1] >> 24
            x[-1] &= _M24
            x = self.add_lazy(x, [(c * r) & _M32 for r in self.rho])
        return x

    def fold_cols(self, acc, n):
        for _ in range(n):
            c = 0
            for k in range(self.L):
                v = acc[k] + c
                acc[k], c = v & _M24, v >> 24
            acc = [a + c * r for a, r in zip(acc, self.rho)]
            assert all(a < 1 << 64 for a in acc)
        return self.carry_out(acc)

    def bar_limbs(self, x):
        out, c, bit = [], 0, 0
        for k in range(self.L):
            o = 0
            while c < len(self.chunks) and bit < 24 * (k + 1):
                w, off = self.chunks[c], bit - 24 * k
                o |= chi_word((x[k] >> off) & ((1 << w) - 1), w) << off
                bit, c = bit + w, c + 1
            out.append(o)
        return out

    def concrete(self, x):
        if self.plan.concrete == "dense":
            return [self.fold(self.row(x, self.mat[i]), self.f_conc) for i in range(self.cfg.t)]
        out = []
        for i in range(self.cfg.t):
            acc = [0] * self.L
            for j in range(self.cfg.t):
                acc = [a + self.mat[i][j][0] * w for a, w in zip(acc, x[j])]
            out.append(self.fold_cols(acc, self.f_conc))
        return out

    def row(self, x, consts):
        """``mont_row``: the t products summed in the same columns, one REDC."""
        L, acc = self.L, [0] * self.L
        for i in range(L):
            for j in range(len(x)):
                for k in range(L):
                    acc[k] = (acc[k] + x[j][k] * consts[j][i]) & ((1 << 64) - 1)
            q = ((acc[0] & _M24) * self.n0inv) & _M24
            acc = [a + q * pk for a, pk in zip(acc, self.p)]
            carry = acc[0] >> 24
            acc = acc[1:] + [0]
            acc[0] += carry
        return self.carry_out(acc)

    def permute(self, x):
        if self.plan.body == "mersenne":
            return self.permute_mersenne(x)
        cfg = self.cfg
        x = self.concrete(x)
        for r in range(cfg.rounds):
            for e in range(cfg.bars):
                plain = self.store(self.mont_mul(x[e], self.one))  # reduce_once
                x[e] = self.mont_mul(self.bar_limbs(plain), self.r2)
            for i in range(cfg.t - 1, 0, -1):
                sq = self.fold(self.mont_mul(x[i - 1], x[i - 1]), self.f_sq)
                x[i] = self.fold(self.add_lazy(x[i], sq), self.f_add)
            x = [self.fold(self.add_lazy(v, c), self.f_rc) for v, c in zip(self.concrete(x), self.rc[r])]
        return [self.store(self.mont_mul(v, self.rho)) for v in x]

    def permute_mersenne(self, limbs):
        cfg, L = self.cfg, self.L
        n, s = cfg.field.modulus_bit_size, self.plan.shift
        p = (1 << n) - 1
        word = lambda ls: sum(v << (24 * k) for k, v in enumerate(ls))  # noqa: E731

        def reduce(v, folds):
            assert v < 1 << 64
            for _ in range(folds):
                v = (v >> n) + (v & p)
            assert v < 1 << 32
            return v - p if v >= p else v

        def rotl(v, r):
            return ((v << r) | (v >> (n - r))) & p

        def concrete(x):
            return [reduce(sum(word(self.mat[i][j]) * x[j] for j in range(cfg.t)), self.f_conc) for i in range(cfg.t)]

        x = concrete([rotl(word(ls), n - s) for ls in limbs])
        for r in range(cfg.rounds):
            for e in range(cfg.bars):
                o, bit = 0, 0
                for w in self.chunks:
                    o |= chi_word((x[e] >> bit) & ((1 << w) - 1), w) << bit
                    bit += w
                x[e] = o
            for i in range(cfg.t - 1, 0, -1):
                x[i] = reduce(x[i] + reduce(x[i - 1] * x[i - 1], self.f_sq), self.f_add)
            x = [reduce(v + word(c), self.f_rc) for v, c in zip(concrete(x), self.rc[r])]
        out = []
        for v in x:
            v = rotl(v, s)
            out.append([(v >> (24 * k)) & _M24 if k < L - 1 else v >> (24 * k) for k in range(L)])
        return out


@pytest.mark.parametrize("name", KERNEL_CONFIGS + ["m13"])
def test_kernel_emulation_matches_oracle(name):
    cfg = port_config(name)
    vals = lanes(cfg.field.modulus, cfg.t, 6, 23)
    assert emulate(cfg, Kernel4(cfg), vals) == oracle_permute(cfg, vals)


# ---- dispatch and entry points ----


def test_dispatch_on_cpu():
    cfg = port_config("m31-t4")
    vals = lanes(cfg.field.modulus, cfg.t, 8, 21)
    state = ints_to_mont_tensor(cfg.field, vals, "cpu")
    out = st.batched_permute(cfg, state)  # "auto" on a CPU tensor: the plain version
    assert torch.equal(out, st.batched_permute(cfg, state, "plain"))
    assert mont_tensor_to_ints(cfg.field, out) == oracle_permute(cfg, vals)
    with pytest.raises(ValueError, match="CUDA kernel"):
        st.batched_permute(cfg, state, "kernel")
    perm = st.MonolithPermutation(cfg, "cpu")
    with pytest.raises(ValueError, match="no kernel for device"):
        monolith_permute(cfg, perm.consts.to("meta"), state.to("meta"))
    with pytest.raises(TypeError):
        monolith_permute(cfg, perm.consts, state.long())
    with pytest.raises(NotImplementedError):
        st.batched_permute(jax_config("m31-t4"), state)  # a JAX config
    with pytest.raises(NotImplementedError):
        _build.check_instantiated("sponge_monolith", 16, 3)
    for t, L in _build.INSTANTIATIONS["sponge_monolith"]:
        _build.check_instantiated("sponge_monolith", t, L)
    assert monolith_permute_plain is st.MonolithPermutation.plain


def test_lazy_sponge_and_transcript_match_oracle():
    """A lazy Monolith-31 sponge (mode flips, a multi-chunk squeeze, bytes
    and bits) against the oracle, as chip_smoke.py drives it on the card."""
    cfg = port_config("m31-r8")
    fs, B = cfg.field, 3
    rng = np.random.default_rng(12)
    lanes_ = [[st.Fp(int(rng.integers(0, 2**62)) % fs.modulus, fs) for _ in range(10)] for _ in range(B)]
    sponge = st.LazyPoseidonSponge(cfg, batch_size=B, device="cpu")
    oracles = [st.OracleMonolithSponge(cfg) for _ in range(B)]
    sponge.absorb(st.Batched(lanes_))
    sponge.absorb(b"monolith")
    for o, lane in zip(oracles, lanes_):
        o.absorb(lane)
        o.absorb(b"monolith")
    assert sponge.squeeze_native_field_elements(11) == [o.squeeze_native_field_elements(11) for o in oracles]
    assert sponge.squeeze_bytes(13) == [o.squeeze_bytes(13) for o in oracles]
    assert sponge.squeeze_bits(70) == [o.squeeze_bits(70) for o in oracles]
