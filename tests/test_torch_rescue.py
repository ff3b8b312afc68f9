"""The port's Rescue-Prime family against the JAX package and the oracle.

Parameters field by field; the run-length ladder schedule; the
sliding-window schedule, its counts and the rule that picks a kernel's
window; the Montgomery squaring against the product; the oracle's frozen
vectors and the JAX oracle on random states; ``rescue_permute_plain``
(kernel 5's function) against ``rescue_permute_jit`` and the Pallas kernel
``rescue_permute_fn`` in interpret mode on the 25-bit test field with two
rounds (as tests/test_rescue.py runs them), and against the oracle at full
width; the static value bound; the constant layout; a word-by-word
emulation of ``csrc/rescue.cu`` against the oracle; dispatch; and the
sponge, transcript and Merkle entry points driven by a Rescue config.
Inputs come from numpy seeds; equality is exact (tolerance 0) on canonical
values.

At BLS12-381 Fr the 14-round plain permutation takes about 7 s per call on
the CPU (some 10^4 Montgomery products of 11 limbs in tensor ops), too long
for this suite: here the full-width check runs the first round of the
BLS12-381 instance (both S-boxes, the 254-bit inverse ladder); the whole
permutation at B = 2^20 against the oracle is a phase of ``chip_smoke.py``.
The CUDA kernel itself runs on the card.
"""

import dataclasses
from collections import namedtuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import TINY_FR
from test_torch_gmimc import _M24, Words, emulate

import sponge_tpu
from sponge_tpu.fields import FieldSpec as JaxFieldSpec
from sponge_tpu.ops.pallas_rescue import _exponent_runs as jax_exponent_runs
from sponge_tpu.ops.pallas_rescue import rescue_permute_fn
from sponge_tpu.rescue import OracleRescueSponge as JaxOracleRescue
from sponge_tpu.rescue.params import generate_rescue_parameters as jax_generate
from sponge_tpu.rescue.permutation import _device_constants as jax_device_constants
from sponge_tpu.rescue.permutation import rescue_permute_jit
import sponge_tpu_torch as st
from sponge_tpu_torch import interop
from sponge_tpu_torch.fields import ints_to_mont_tensor, mont_tensor_to_ints
from sponge_tpu_torch.hash import merkle_root
from sponge_tpu_torch.ops import _build
from sponge_tpu_torch.ops import montgomery as mont
from sponge_tpu_torch.ops.bounds import _Replay, check_rescue_bounds, sqr_column_bound
from sponge_tpu_torch.ops.montgomery import _exponent_runs, ladder_schedule, wide_state, window_counts, window_schedule
from sponge_tpu_torch.ops.rescue import rescue_permute, rescue_permute_plain
from sponge_tpu_torch.rescue.config import (
    constant_layout,
    kernel_constants,
    schedules,
    unpack_constants,
    windows,
)
from sponge_tpu_torch.rescue.oracle import OracleRescueSponge
from sponge_tpu_torch.rescue.permutation import _device_constants

JAX_T25 = JaxFieldSpec(name="tiny_fr_25", modulus=(1 << 25) - 39, generator=3)


def tiny25(rounds=4):
    """tests/test_rescue.py's 25-bit config (JAX)."""
    return jax_generate(JAX_T25, 2, rounds=rounds)


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
    out = []
    for b in range(len(vals[0])):
        o = OracleRescueSponge(cfg)
        o.state = [row[b] for row in vals]
        o.permute()
        out.append(o.state)
    return [list(col) for col in zip(*out)]


def plain(cfg, vals):
    perm = st.RescuePermutation(cfg, "cpu")
    out = rescue_permute_plain(cfg, perm.consts, ints_to_mont_tensor(cfg.field, vals, "cpu"))
    assert out.dtype == torch.int32
    return mont_tensor_to_ints(cfg.field, out)


def jax_run(jcfg, fn, vals):
    fs = jcfg.field
    out = fn(jnp.asarray(np.stack([fs.ints_to_mont_plane(r) for r in vals])))
    return [fs.mont_plane_to_ints(row) for row in np.asarray(out)]


# ---- parameters ----

DEFAULTS = {
    "bls12_381-r2": ("BLS12_381_FR", 2),
    "mersenne31-r8": ("MERSENNE31_FR", 8),
    "babybear-r8": ("BABYBEAR_FR", 8),
    "goldilocks-r8": ("GOLDILOCKS_FR", 8),
    # more widths of the default tables: (2, 11), (9, 11), (6, 11), (4, 11), (5, 3), (9, 2)
    "bls12_381-r1": ("BLS12_381_FR", 1),
    "bls12_381-r8": ("BLS12_381_FR", 8),
    "bn254-r5": ("BN254_FR", 5),
    "bls12_377-r3": ("BLS12_377_FR", 3),
    "goldilocks-r1": ("GOLDILOCKS_FR", 1),
    "koalabear-r1": ("KOALABEAR_FR", 1),
}


@pytest.mark.parametrize("name", list(DEFAULTS))
def test_default_parameters_equal_jax(name):
    const, rate = DEFAULTS[name]
    cfg = st.get_default_rescue_parameters(getattr(st, const), rate)
    jcfg = sponge_tpu.get_default_rescue_parameters(getattr(sponge_tpu, const), rate)
    assert cfg == interop.config_from_jax(jcfg)
    assert cfg.inv_alpha == jcfg.inv_alpha


def test_tiny_parameters_and_spec_counts_equal_jax():
    jcfg = tiny25()
    fs = interop.field_for_modulus(JAX_T25.modulus)
    assert st.generate_rescue_parameters(fs, 2, rounds=4) == interop.config_from_jax(jcfg)
    for p in (st.BLS12_381_FR.modulus, st.GOLDILOCKS_FR.modulus, st.MERSENNE31_FR.modulus):
        assert st.smallest_alpha(p) == sponge_tpu.rescue.smallest_alpha(p)
    assert st.rescue_round_count(st.BLS12_381_FR.modulus, 3, 1, 128, 5) == 14
    assert st.get_default_rescue_parameters(st.BLS12_381_FR, 2).rounds == 14


def test_exponent_runs_reproduce_the_inverse_exponents():
    rng = np.random.default_rng(5)
    exps = [
        st.get_default_rescue_parameters(fs, rate).inv_alpha
        for fs, rate in [(st.BLS12_381_FR, 2), (st.BABYBEAR_FR, 8), (st.GOLDILOCKS_FR, 8)]
    ] + [tiny25().inv_alpha] + [int(v) | 1 for v in rng.integers(3, 1 << 60, size=6)] + [
        int(v) << 3 for v in rng.integers(3, 1 << 40, size=3)
    ]
    for e in exps:
        runs, trailing = _exponent_runs(e)
        assert (runs, trailing) == jax_exponent_runs(e)
        acc = 1
        for g in ladder_schedule(e):
            acc <<= abs(g)
            acc |= g > 0
        assert acc == e
        assert sum(abs(g) for g in ladder_schedule(e)) == e.bit_length() - 1
    bls = st.get_default_rescue_parameters(st.BLS12_381_FR, 2).inv_alpha
    assert (bls.bit_length() - 1, bin(bls).count("1") - 1) == (253, 129)


# ---- the sliding-window chain and the squaring of kernels 5 and 7 ----

SHIPPED_FIELDS = ["BLS12_381_FR", "BN254_FR", "GOLDILOCKS_FR", "BABYBEAR_FR", "KOALABEAR_FR", "MERSENNE31_FR"]


def chain_exponent(sched, w):
    """The exponent a window schedule computes: seed 2j + 1, then per pair
    a shift by the squarings and + 2j + 1; checks each index is an odd
    power of the w-bit table."""
    assert all(-1 <= j < 1 << (w - 1) for j in [sched[0]] + sched[2::2])
    acc = 2 * sched[0] + 1
    for squarings, j in zip(sched[1::2], sched[2::2]):
        acc = (acc << squarings) + (2 * j + 1 if j >= 0 else 0)
    return acc


@pytest.mark.parametrize("w", [1, 2, 3, 4, 5])
def test_window_schedule_reproduces_exponents(w):
    """alpha and 1/alpha of every shipped field (and of the 25-bit test
    field), plus random exponents; windows end in a 1-bit, so only the
    trailing pair has index -1."""
    rng = np.random.default_rng(w)
    exps = []
    for name in SHIPPED_FIELDS:
        p = getattr(st, name).modulus
        alpha = st.smallest_alpha(p)
        exps += [alpha, pow(alpha, -1, p - 1)]
    exps += [tiny25().inv_alpha, 1, 2, 3, 1 << 40] + [int(v) for v in rng.integers(1, 1 << 62, size=8)]
    for e in exps:
        sched = window_schedule(e, w)
        assert chain_exponent(sched, w) == e, (e, w)
        assert -1 not in sched[2:-1:2]
        assert (2 * sched[0] + 1).bit_length() + sum(sched[1::2]) == e.bit_length()
    assert window_schedule(5, 1) == [0, 2, 0]  # x^5: two squarings, one multiply


def test_window_counts_match_the_sliding_window():
    """At BLS12-381 the inverse exponent takes 253 + 129 at w = 1 (the
    run-length ladder's count), and 252 + 66, 251 + 62, 250 + 56 with the
    table at w = 3, 4, 5; at 187 and 242 limb products per squaring and
    multiply, 63,096 limb products at w = 3 against the ladder's 92,444."""
    e = st.get_default_rescue_parameters(st.BLS12_381_FR, 2).inv_alpha
    assert window_counts(e, 1) == (253, 129)
    assert sum(abs(g) + (g > 0) for g in ladder_schedule(e)) == 253 + 129
    assert [window_counts(e, w) for w in (3, 4, 5)] == [(252, 66), (251, 62), (250, 56)]
    sq, mul = window_counts(e, 3)
    assert (sq * 187 + mul * 242, 382 * 242) == (63096, 92444)


def test_window_rule_keeps_the_blocks_registers_allow():
    """The rule's arithmetic of residency and its choices: kernel 5 at
    (3, 11) and 114 registers holds 4 blocks by registers and by its 3-bit
    table (50,688 bytes); a 4-bit table (118,272 bytes) leaves 1, so w = 3;
    at 96 registers (5 blocks) the 3-bit table no longer keeps them and the
    rule falls back to w = 2.  Kernel 7 at (4, 11) and 128 registers takes
    w = 3; BabyBear t = 16 w = 2; Goldilocks l = 4 w = 4."""
    bls = st.get_default_rescue_parameters(st.BLS12_381_FR, 2)
    assert mont.window_table_bytes(3, 11, 3) == 50688
    assert mont.window_table_bytes(3, 11, 4) == 118272
    assert mont.window_table_bytes(3, 11, 1) == 0
    assert [mont.blocks_per_sm(114, b) for b in (0, 50688, 118272)] == [4, 4, 1]
    assert mont.blocks_per_sm(32, 0) == 16  # 2048 threads per SM
    assert mont.window_for(bls.inv_alpha, 11, 3, 114) == 3
    assert mont.window_for(bls.inv_alpha, 11, 3, 96) == 2
    assert mont.window_for(bls.alpha, 11, 3, 114) == 1
    assert mont.window_for(bls.inv_alpha, 11, 2, 128) == 3
    bb = st.get_default_rescue_parameters(st.BABYBEAR_FR, 8)
    assert mont.window_for(bb.inv_alpha, 2, 16, 64) == 2
    gl = st.get_default_anemoi_parameters(st.GOLDILOCKS_FR, 4)
    assert mont.window_for(gl.inv_alpha, 3, 4, 96) == 4


_LIMB_EDGES = {
    "bls12_381_fr-L11": "BLS12_381_FR",
    "goldilocks_fr-L3": "GOLDILOCKS_FR",
    "babybear_fr-L2": "BABYBEAR_FR",
}


@pytest.mark.parametrize("name", list(_LIMB_EDGES))
def test_sqr_equals_mont_mul_on_edge_limbs(name):
    """``mont_sqr`` equals ``mont_mul(a, a)`` word for word on carried
    inputs below R: every limb 2^24 - 1 (R - 1), 0, 1, p - 1, p - 2, single
    full limbs and random words; no 64-bit column reaches 2^63, and none
    passes ``sqr_column_bound``."""
    fs = getattr(st, _LIMB_EDGES[name])
    L = fs.nlimbs
    rng = np.random.default_rng(L)
    ints = [fs.r - 1, 0, 1, fs.modulus - 1, fs.modulus - 2, fs.r - fs.modulus]
    ints += [(_M24) << (24 * k) for k in range(L)] + [int(v) for v in rng.integers(0, 1 << 62, size=8)]
    words = Words(fs)
    for v in ints:
        a = [int(x) for x in fs.int_to_limbs(v % fs.r)]
        assert words.sqr(a) == words.mont_mul(a, a), v
    assert words.colmax < 1 << 63
    sq = Words(fs)
    sq.sqr([_M24] * L)
    assert sq.colmax <= sqr_column_bound(L) < 1 << 63


def test_sqr_replay_refuses_columns_past_63_bits():
    """A radix of 12,000 limbs: a product's columns stay below 2^63, a
    squaring's (limbs times doubled limbs) do not."""
    p = (1 << 31) - 1
    fs = namedtuple("_Field", "name modulus r nlimbs")("huge", p, 1 << (24 * 12000), 12000)
    sim = _Replay("huge", fs)
    sim.mul(sim.const, sim.const)
    with pytest.raises(ValueError, match="squaring columns"):
        sim.sqr(sim.const)


# ---- oracle ----


def test_oracle_frozen_vectors():
    o = OracleRescueSponge(st.get_default_rescue_parameters(st.BLS12_381_FR, 2))
    o.absorb_field_elements([0, 1])
    assert o.squeeze_native_field_elements(2) == [
        45302786381541930325162575638737089225573393886344434601026979521681543727945,
        26952253882373158469686854567157364530461338720960972120602142787680627985088,
    ]
    gl = st.get_default_rescue_parameters(st.GOLDILOCKS_FR, 8)
    assert gl.rounds == 8 and gl.alpha == 7
    o = OracleRescueSponge(gl)
    o.absorb_field_elements(list(range(8)))
    assert o.squeeze_native_field_elements(2) == [11777114957144409127, 14272716373264212525]


@pytest.mark.parametrize("t", [3, 4, 8, 16])
def test_oracle_matches_jax_oracle(t):
    jcfg = jax_generate(TINY_FR, t - 1, rounds=3)
    cfg = interop.config_from_jax(jcfg)
    vals = lanes(TINY_FR.modulus, t, 5, t)
    for b in range(5):
        o, j = OracleRescueSponge(cfg), JaxOracleRescue(jcfg)
        o.state = j.state = [row[b] for row in vals]
        o.permute()
        j.permute()
        assert o.state == j.state, b


# ---- the plain version against the JAX tiers and the oracle ----


def test_plain_matches_rescue_permute_jit():
    jcfg = tiny25(rounds=2)
    vals = lanes(JAX_T25.modulus, jcfg.t, 32, 11)
    assert plain(interop.config_from_jax(jcfg), vals) == jax_run(jcfg, rescue_permute_jit(jcfg), vals)


def test_plain_matches_rescue_kernel_interpret():
    jcfg = tiny25(rounds=2)
    vals = lanes(JAX_T25.modulus, jcfg.t, 1024, 71)
    ref = jax_run(jcfg, rescue_permute_fn(jcfg, interpret=True), vals)
    assert plain(interop.config_from_jax(jcfg), vals) == ref


def _bls_first_round():
    full = st.get_default_rescue_parameters(st.BLS12_381_FR, 2)
    return st.RescueConfig(
        field=full.field, rounds=1, alpha=full.alpha, mds=full.mds, rc=full.rc[:2], rate=2
    )


FULL_WIDTH = {
    "bls12_381_fr-t3-round1": _bls_first_round,
    "babybear_fr-t16": lambda: st.get_default_rescue_parameters(st.BABYBEAR_FR, 8),
}


@pytest.mark.parametrize("name", list(FULL_WIDTH))
def test_plain_matches_oracle_full_width(name):
    cfg = FULL_WIDTH[name]()
    vals = lanes(cfg.field.modulus, cfg.t, 8, 9)
    assert plain(cfg, vals) == oracle_permute(cfg, vals)


# ---- the static value bound of kernel 5 ----


def test_value_bound_admits_shipped_configs():
    for fs, rate in [
        (st.BLS12_381_FR, 2), (st.BN254_FR, 2), (st.MERSENNE31_FR, 8),
        (st.BABYBEAR_FR, 8), (st.GOLDILOCKS_FR, 8), (st.GOLDILOCKS_FR, 4),
    ]:
        cfg = st.get_default_rescue_parameters(fs, rate)
        assert 2 * fs.modulus <= check_rescue_bounds(cfg) < 3 * fs.modulus, fs.name
    check_rescue_bounds(interop.config_from_jax(tiny25()))


_Field = namedtuple("_Field", "name modulus r nlimbs")
_Cfg = namedtuple("_Cfg", "field t rounds alpha inv_alpha")


def test_value_bound_refuses_overflow():
    """A radix of only 2p: the MDS row sums reach R.  A state 4096 wide:
    the REDC columns of a row pass 2^63."""
    p = (1 << 31) - 1
    tight = _Cfg(_Field("tight", p, 2 * p, 2), 3, 2, 5, pow(5, -1, p - 1))
    with pytest.raises(ValueError, match="reach R"):
        check_rescue_bounds(tight)
    wide = _Cfg(_Field("wide", p, 1 << 264, 11), 4096, 1, 5, pow(5, -1, p - 1))
    with pytest.raises(ValueError, match="63 bits"):
        check_rescue_bounds(wide)


# ---- kernel 5's constant layout and a word-by-word emulation of csrc/rescue.cu ----


@pytest.mark.parametrize("name", ["bls12_381_fr-t3", "babybear_fr-t16"])
def test_constant_layout_matches_unpack_and_kernel_offsets(name):
    """``unpack_constants`` names the sections of ``constant_layout`` in
    order; the kernel finds the alpha schedule after 2L + (2N + t) t L words
    and the inverse one after it; both hold ``schedules(cfg)``."""
    cfg = {"bls12_381_fr-t3": lambda: st.get_default_rescue_parameters(st.BLS12_381_FR, 2),
           "babybear_fr-t16": lambda: st.get_default_rescue_parameters(st.BABYBEAR_FR, 8)}[name]()
    buf = torch.from_numpy(kernel_constants(cfg))
    parts = unpack_constants(cfg, buf)
    assert list(parts) == [n for n, _ in constant_layout(cfg)] == [
        "p", "one", "rc", "mds", "alpha_window", "inv_window"]
    t, L = cfg.t, cfg.field.nlimbs
    off = 2 * L + (2 * cfg.rounds + t) * t * L
    alpha_sched, inv_sched = schedules(cfg)
    assert buf[off : off + len(alpha_sched)].tolist() == alpha_sched == parts["alpha_window"].flatten().tolist()
    assert buf[off + len(alpha_sched) :].tolist() == inv_sched == parts["inv_window"].flatten().tolist()
    assert (alpha_sched, inv_sched) == tuple(window_schedule(e, w) for e, w in zip((cfg.alpha, cfg.inv_alpha), windows(cfg)))


class Kernel5(Words):
    """``csrc/rescue.cu`` for one lane: per half-round ``pow_window`` on
    every element (x^alpha, then x^(1/alpha), at ``windows(cfg)``), the MDS
    rows summed in 64-bit columns with one REDC each, + rc; the exit
    product by 1.  A wide state (``montgomery.wide_state``) takes the wide
    order: element 0 raised and shifted in at the top, t times, then the
    rows one at a time, each shifted in (``mat_apply_rows``)."""

    def __init__(self, cfg):
        super().__init__(cfg.field)
        c = [int(v) for v in kernel_constants(cfg)]
        L, t = self.L, cfg.t
        self.cfg, self.one = cfg, c[L : 2 * L]
        self.rc = c[2 * L : 2 * L + 2 * cfg.rounds * t * L]
        mds = c[2 * L + 2 * cfg.rounds * t * L :]
        self.mds_rows = [[mds[(r * t + j) * L :][:L] for j in range(t)] for r in range(t)]
        self.windows = windows(cfg)

    def permute(self, x):
        cfg, L, t = self.cfg, self.L, self.cfg.t
        w_alpha, w_inv = self.windows
        for h in range(2 * cfg.rounds):
            e, w = (cfg.inv_alpha, w_inv) if h % 2 else (cfg.alpha, w_alpha)
            if wide_state(t, L):
                for _ in range(t):
                    x = x[1:] + [self.pow_window(x[0], e, w)]
                y = [[0] * L] * t
                for row in self.mds_rows:
                    y = y[1:] + [self.mont_row(x, row)]
            else:
                x = [self.pow_window(v, e, w) for v in x]
                y = [self.mont_row(x, row) for row in self.mds_rows]
            x = [self.add_lazy(v, self.rc[(h * t + r) * L :][:L]) for r, v in enumerate(y)]
        return [self.store(self.mont_mul(v, self.one)) for v in x]


def _bls_t9_first_round():
    full = st.get_default_rescue_parameters(st.BLS12_381_FR, 8)
    return dataclasses.replace(full, rounds=1, rc=full.rc[:2])


KERNEL5 = {
    "bls12_381_fr-t3-round1": _bls_first_round,
    "babybear_fr-t16": lambda: st.get_default_rescue_parameters(st.BABYBEAR_FR, 8),
    "tiny_fr_25-t3": lambda: interop.config_from_jax(tiny25()),
    "bls12_381_fr-t9-round1": _bls_t9_first_round,
    "goldilocks_fr-t12": lambda: st.get_default_rescue_parameters(st.GOLDILOCKS_FR, 8),
}


@pytest.mark.parametrize("name", list(KERNEL5))
def test_kernel_emulation_matches_oracle(name):
    """Full width (BLS12-381 t = 3 cut to one round: both chains, the
    254-bit one at w = 3; t = 9 in the wide order, the 254-bit chain at
    w = 5) and the small fields on a few lanes with edge values; every
    column below 2^63."""
    cfg = KERNEL5[name]()
    vals = lanes(cfg.field.modulus, cfg.t, 3, 17)
    kernel = Kernel5(cfg)
    assert emulate(cfg, kernel, vals) == oracle_permute(cfg, vals)
    assert kernel.colmax < 1 << 63


# ---- dispatch ----


def test_dispatch_on_cpu():
    cfg = interop.config_from_jax(tiny25(rounds=2))
    vals = lanes(cfg.field.modulus, cfg.t, 8, 21)
    state = ints_to_mont_tensor(cfg.field, vals, "cpu")
    out = st.batched_permute(cfg, state)  # "auto" on a CPU tensor: the plain version
    assert torch.equal(out, st.batched_permute(cfg, state, "plain"))
    assert mont_tensor_to_ints(cfg.field, out) == oracle_permute(cfg, vals)
    with pytest.raises(ValueError, match="CUDA kernel"):
        st.batched_permute(cfg, state, "kernel")
    with pytest.raises(ValueError, match="unknown backend"):
        st.batched_permute(cfg, state, "rescue_pallas")
    perm = st.RescuePermutation(cfg, "cpu")
    with pytest.raises(ValueError, match="no kernel for device"):
        rescue_permute(cfg, perm.consts.to("meta"), state.to("meta"))
    with pytest.raises(TypeError):
        rescue_permute(cfg, perm.consts, state.long())
    with pytest.raises(NotImplementedError):
        st.batched_permute(tiny25(), state)  # a JAX config
    with pytest.raises(NotImplementedError):
        _build.check_instantiated("sponge_rescue", 8, 2)
    for t, L in _build.INSTANTIATIONS["sponge_rescue"]:
        _build.check_instantiated("sponge_rescue", t, L)


def test_configs_from_the_jax_package_take_rescue_primes_order():
    """The JAX package has Rescue-Prime's order alone: its configs arrive
    with the S-box first (``mds_first`` false)."""
    assert interop.config_from_jax(tiny25(rounds=2)).mds_first is False


# ---- entry points over the plain tier ----


def test_sponges_match_oracle():
    cfg = interop.config_from_jax(tiny25(rounds=2))
    fs, B = cfg.field, 3
    rng = np.random.default_rng(8)
    lanes_ = [[st.Fp(int(rng.integers(0, fs.modulus)), fs) for _ in range(4)] for _ in range(B)]
    for sponge in (
        st.PoseidonSponge(cfg, batch_size=B, lazy=False, device="cpu"),
        st.LazyPoseidonSponge(cfg, batch_size=B, device="cpu"),
    ):
        oracles = [OracleRescueSponge(cfg) for _ in range(B)]
        sponge.absorb(st.Batched(lanes_))
        sponge.absorb(st.U64(7))
        for o, lane in zip(oracles, lanes_):
            o.absorb(lane)
            o.absorb(st.U64(7))
        assert sponge.squeeze_native_field_elements(3) == [
            o.squeeze_native_field_elements(3) for o in oracles
        ]
        assert sponge.squeeze_bytes(9) == [o.squeeze_bytes(9) for o in oracles]
        assert sponge.squeeze_bits(30) == [o.squeeze_bits(30) for o in oracles]


def test_transcript_and_merkle_match_oracle():
    cfg = interop.config_from_jax(tiny25(rounds=2))
    fs, B = cfg.field, 4
    vals = lanes(fs.modulus, 3, B, 42)
    steps = [st.TranscriptAbsorb(2), st.TranscriptSqueeze(1), st.TranscriptAbsorb(1),
             st.TranscriptSqueeze(2)]
    out = st.compile_transcript(cfg, steps)(ints_to_mont_tensor(fs, vals, "cpu"))
    for b in range(B):
        o = OracleRescueSponge(cfg)
        o.absorb_field_elements([vals[0][b], vals[1][b]])
        want = o.squeeze_native_field_elements(1)
        o.absorb_field_elements([vals[2][b]])
        want += o.squeeze_native_field_elements(2)
        assert [fs.limbs_to_int(out[k, :, b].numpy()) for k in range(3)] == want, b
    leaves = lanes(fs.modulus, 1, 8, 77)[0]
    level = leaves
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level), 2):
            o = OracleRescueSponge(cfg)
            o.absorb_field_elements(level[i : i + 2])
            nxt.append(o.squeeze_native_field_elements(1)[0])
        level = nxt
    root = merkle_root(cfg, ints_to_mont_tensor(fs, leaves, "cpu"))
    assert mont_tensor_to_ints(fs, root[:, None]) == level


def test_interop_from_device_constants():
    jcfg = tiny25(rounds=3)
    rc, mds = jax_device_constants(jcfg)
    cfg = interop.rescue_config_from_device_constants(
        rc, mds, modulus=JAX_T25.modulus, limb_bits=JAX_T25.limb_bits, alpha=jcfg.alpha,
        rate=jcfg.rate,
    )
    assert cfg == interop.config_from_jax(jcfg)
    rc, mds = _device_constants(cfg)
    back = interop.rescue_config_from_device_constants(
        rc, mds, modulus=cfg.field.modulus, limb_bits=24, alpha=cfg.alpha, rate=cfg.rate
    )
    assert back == cfg
