"""The port's Anemoi family against the JAX package and the oracle.

Parameters (the diffusion matrix at l = 1, 2 and 4) and validation; the
oracle's frozen vectors and the JAX oracle on random states;
``anemoi_permute_plain`` (kernel 7's function) against ``anemoi_permute_jit``
and the Pallas kernel ``anemoi_permute_fn`` in interpret mode on the 25-bit
test field, and against the oracle at full width (BLS12-381 with one round:
there a round costs some 400 Montgomery products, about 0.25 s a pair on
the CPU, and the JAX tier's compile tens of seconds); the static bound and
its post-PHT reduction; a word-by-word emulation of ``csrc/anemoi.cu``
against the oracle; dispatch; and the sponge, transcript and Merkle entry
points driven by an Anemoi config.  The BLS12-381 golden vector through the
sponge (25 rounds at l = 1, one permutation 5-8 s on the CPU) is checked on
the card (``chip_smoke.py``).  Inputs come from numpy seeds; equality is
exact (tolerance 0) on canonical values.
"""

import dataclasses
from collections import namedtuple

import pytest
import torch
from test_torch_gmimc import (
    JAX_T25,
    T25,
    Words,
    emulate,
    jax_oracle_permute,
    lanes,
    mont_col,
    oracle_permute,
    plain,
    plain_matches_jax,
    sponge_squeeze,
)

import sponge_tpu
from sponge_tpu.anemoi import AnemoiConfig as JaxAnemoiConfig
from sponge_tpu.anemoi import OracleAnemoiSponge as JaxOracleAnemoi
from sponge_tpu.anemoi.params import generate_anemoi_parameters as jax_generate
from sponge_tpu.anemoi.permutation import _device_constants as jax_device_constants
from sponge_tpu.anemoi.permutation import anemoi_permute_jit
from sponge_tpu.ops.pallas_anemoi import anemoi_permute_fn
import sponge_tpu_torch as st
from sponge_tpu_torch import interop
from sponge_tpu_torch.anemoi.config import constant_layout, kernel_constants, pairwise, schedule, unpack_constants, window
from sponge_tpu_torch.fields import ints_to_mont_tensor, mont_tensor_to_ints
from sponge_tpu_torch.hash import merkle_root
from sponge_tpu_torch.ops import _build
from sponge_tpu_torch.ops.anemoi import anemoi_permute
from sponge_tpu_torch.ops.bounds import check_anemoi_bounds
from sponge_tpu_torch.ops.montgomery import window_schedule
from sponge_tpu_torch.poseidon.config import mont_limb_rows

FIELDS = {"bls12_381": "BLS12_381_FR", "bn254": "BN254_FR", "goldilocks": "GOLDILOCKS_FR"}


def tiny25(rounds=4, rate=3):
    """tests/test_anemoi.py's 25-bit config (JAX)."""
    return jax_generate(JAX_T25, rate, rounds=rounds)


def bls_cut(rate, rounds=1, package=st):
    """The BLS12-381 default of ``rate`` (of the port, or of the JAX package
    ``sponge_tpu``) with its first ``rounds`` rounds."""
    full = package.get_default_anemoi_parameters(package.BLS12_381_FR, rate)
    return dataclasses.replace(full, rounds=rounds, rc_x=full.rc_x[:rounds], rc_y=full.rc_y[:rounds])


# ---- parameters ----


DEFAULTS = {
    "bls12_381-r1": ("bls12_381", 1),
    "bls12_381-r3": ("bls12_381", 3),
    "bn254-r3": ("bn254", 3),
    "goldilocks-r4": ("goldilocks", 4),
    # more widths of the default tables: (6, 11), (8, 11), (6, 3), (10, 3), (12, 3)
    "bls12_381-r5": ("bls12_381", 5),
    "bls12_381-r7": ("bls12_381", 7),
    "goldilocks-r2": ("goldilocks", 2),
    "goldilocks-r6": ("goldilocks", 6),
    "goldilocks-r8": ("goldilocks", 8),
}


@pytest.mark.parametrize("name", list(DEFAULTS))
def test_default_parameters_equal_jax(name):
    field, rate = DEFAULTS[name]
    fs, jfs = getattr(st, FIELDS[field]), getattr(sponge_tpu, FIELDS[field])
    cfg = st.get_default_anemoi_parameters(fs, rate)
    jcfg = sponge_tpu.get_default_anemoi_parameters(jfs, rate)
    ported = interop.config_from_jax(jcfg)
    assert type(ported) is st.AnemoiConfig and cfg == ported
    assert (cfg.inv_alpha, cfg.g_inv, cfg.l) == (jcfg.inv_alpha, jcfg.g_inv, jcfg.l)
    assert st.anemoi_default_rounds(cfg.l) == cfg.rounds


def test_tiny_parameters_and_matrices():
    for rate in (1, 3, 7):  # M_x: identity, [[1, g], [g, g^2 + 1]], Cauchy
        cfg = st.generate_anemoi_parameters(T25, rate, rounds=4)
        assert cfg == dataclasses.replace(interop.config_from_jax(tiny25(rate=rate)), field=T25)
    assert st.get_default_anemoi_parameters(st.BLS12_381_FR, 3).mat_x == ((1, 7), (7, 50))


def _validation_cases(cfg):
    return {
        "width": dict(rounds=2, alpha=5, g=7, mat_x=cfg.mat_x, rc_x=cfg.rc_x[:2], rc_y=cfg.rc_y[:2], rate=2),
        "alpha": dict(rounds=2, alpha=3, g=7, mat_x=cfg.mat_x, rc_x=cfg.rc_x[:2], rc_y=cfg.rc_y[:2], rate=1),
        "rc_x": dict(rounds=3, alpha=5, g=7, mat_x=cfg.mat_x, rc_x=cfg.rc_x[:2], rc_y=cfg.rc_y[:3], rate=1),
        "g": dict(rounds=2, alpha=5, g=0, mat_x=cfg.mat_x, rc_x=cfg.rc_x[:2], rc_y=cfg.rc_y[:2], rate=1),
        "identity": dict(rounds=25, alpha=5, g=7, mat_x=((2,),), rc_x=cfg.rc_x, rc_y=cfg.rc_y, rate=1),
    }


@pytest.mark.parametrize("case", ["width", "alpha", "rc_x", "g", "identity"])
def test_validation_errors_match_jax(case):
    cfg = st.get_default_anemoi_parameters(st.BLS12_381_FR, 1)
    kw = _validation_cases(cfg)[case]
    with pytest.raises(ValueError) as want:
        JaxAnemoiConfig(field=sponge_tpu.BLS12_381_FR, **kw)
    with pytest.raises(ValueError) as got:
        st.AnemoiConfig(field=st.BLS12_381_FR, **kw)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="must be even"):
        st.generate_anemoi_parameters(st.BLS12_381_FR, 2)


# ---- oracle ----


def test_oracle_frozen_vectors():
    o = st.OracleAnemoiSponge(st.get_default_anemoi_parameters(st.BLS12_381_FR, 1))
    o.absorb_field_elements([0])
    assert o.squeeze_native_field_elements(2) == [
        35675714314881219429352217523578393221143023524104408084397769653631559795453,
        29250560957318018735580408678162621932017287796996990149206325536109642299737,
    ]
    o = st.OracleAnemoiSponge(st.get_default_anemoi_parameters(st.GOLDILOCKS_FR, 4))
    o.absorb_field_elements(list(range(4)))
    assert o.squeeze_native_field_elements(2) == [8816711172724677702, 3319201661018352774]


@pytest.mark.parametrize("rate", [1, 3, 7])
def test_oracle_matches_jax_oracle(rate):
    jcfg = tiny25(rate=rate)
    cfg = interop.config_from_jax(jcfg)
    vals = lanes(JAX_T25.modulus, cfg.t, 5, rate)
    for b in range(5):
        o, j = st.OracleAnemoiSponge(cfg), JaxOracleAnemoi(jcfg)
        o.state = j.state = [row[b] for row in vals]
        o.permute()
        j.permute()
        assert o.state == j.state, b


# ---- the plain version against the JAX tiers and the oracle ----


def test_plain_matches_anemoi_permute_jit():
    """At l = 1; l = 2 against the Pallas kernel below."""
    jcfg = tiny25(rate=1)
    vals = lanes(JAX_T25.modulus, jcfg.t, 16, 11)
    plain_matches_jax(st.AnemoiPermutation, jcfg, anemoi_permute_jit(jcfg), vals)


def test_plain_matches_anemoi_kernel_interpret():
    jcfg = tiny25(rounds=2)
    fn = anemoi_permute_fn(jcfg, interpret=True)
    plain_matches_jax(st.AnemoiPermutation, jcfg, fn, lanes(JAX_T25.modulus, 4, 2048, 71))


FULL_WIDTH = {  # JAX configs
    "bls12_381_fr-l1-round1": lambda: bls_cut(1, package=sponge_tpu),
    "bls12_381_fr-l2-round1": lambda: bls_cut(3, package=sponge_tpu),
    "goldilocks_fr-l4": lambda: sponge_tpu.get_default_anemoi_parameters(sponge_tpu.GOLDILOCKS_FR, 4),
}


@pytest.mark.parametrize("name", list(FULL_WIDTH))
def test_plain_matches_oracle_full_width(name):
    """Against the JAX package's oracle; BLS12-381 cut to one round to keep
    the plain inverse ladder short on the CPU."""
    jcfg = FULL_WIDTH[name]()
    cfg = interop.config_from_jax(jcfg)
    if name.startswith("bls"):
        assert cfg == bls_cut(cfg.rate)
    vals = lanes(cfg.field.modulus, cfg.t, 4, 9)
    assert plain(st.AnemoiPermutation, cfg, vals) == jax_oracle_permute(JaxOracleAnemoi, jcfg, vals)


# ---- the static bound of kernel 7 ----


def test_bound_takes_the_post_pht_reduction_where_needed():
    """l = 1 over BLS12-381: nothing reduces between the PHT adds and the
    values grow round over round, so the plan reduces after each
    diffusion; l = 2 (BLS12-381, BN254) and l = 4 (Goldilocks) do not."""
    assert check_anemoi_bounds(st.get_default_anemoi_parameters(st.BLS12_381_FR, 1)).reduce
    assert check_anemoi_bounds(st.get_default_anemoi_parameters(st.BN254_FR, 1)).reduce
    for fs, rate in [(st.BLS12_381_FR, 3), (st.BN254_FR, 3), (st.GOLDILOCKS_FR, 4)]:
        plan = check_anemoi_bounds(st.get_default_anemoi_parameters(fs, rate))
        assert not plan.reduce and plan.vmax < 10 * fs.modulus, fs.name
    assert not check_anemoi_bounds(interop.config_from_jax(tiny25())).reduce


_Field = namedtuple("_Field", "name modulus r nlimbs")
_Cfg = namedtuple("_Cfg", "field l rounds inv_alpha")


def test_bound_refuses_what_no_plan_makes_exact():
    """A radix of only 2p: the PHT sums reach R even when reduced after
    every diffusion.  A state of 2 x 4096 pairs: the M_x row columns pass
    2^63."""
    p = (1 << 31) - 1
    with pytest.raises(ValueError, match="reach R"):
        check_anemoi_bounds(_Cfg(_Field("tight", p, 2 * p, 2), 1, 2, pow(5, -1, p - 1)))
    with pytest.raises(ValueError, match="63 bits"):
        check_anemoi_bounds(_Cfg(_Field("wide", p, 1 << 264, 11), 4096, 1, pow(5, -1, p - 1)))


# ---- word-by-word emulation of csrc/anemoi.cu ----


class Kernel7(Words):
    """``csrc/anemoi.cu`` for one lane: rc adds, the diffusion (M_x rows
    with one REDC each, then the PHT, then the plan's reduction), the
    Flystel with its squarings by ``sqr``, the inverse S-box by
    ``pow_window`` at ``window(cfg)`` and products by -g and -1, rounds + 1
    diffusions in all."""

    def __init__(self, cfg):
        super().__init__(cfg.field)
        c = [int(v) for v in kernel_constants(cfg)]
        L, n = self.L, cfg.l
        self.cfg, self.one = cfg, c[L : 2 * L]
        off = 2 * L
        self.rc_x, self.rc_y = c[off : off + cfg.rounds * n * L], c[off + cfg.rounds * n * L :]
        off += 2 * cfg.rounds * n * L
        self.mat = c[off : off + n * n * L]
        off += n * n * L
        self.g, self.neg_g, self.neg_ginv, self.neg_one = (c[off + i * L : off + (i + 1) * L] for i in range(4))
        self.reduce = check_anemoi_bounds(cfg).reduce
        self.w = window(cfg)

    def row(self, xs, r):
        """``mat_apply_rolled`` row r (the same sums as ``mont_row``)."""
        n, L = len(xs), self.L
        return self.mont_row(xs, [self.mat[(r * n + j) * L :][:L] for j in range(n)])

    def diffusion(self, x, y):
        n = self.cfg.l
        if n > 1:
            yr = y[1:] + y[:1]
            x, y = [self.row(x, r) for r in range(n)], [self.row(yr, r) for r in range(n)]
        y = [self.add_lazy(b, a) for a, b in zip(x, y)]
        x = [self.add_lazy(a, b) for a, b in zip(x, y)]
        if self.reduce:
            x, y = [self.mont_mul(v, self.one) for v in x], [self.mont_mul(v, self.one) for v in y]
        return x, y

    def flystel(self, a, b):
        """One pair (x, y) through the open Flystel."""
        u = self.add_lazy(self.add_lazy(a, self.mont_mul(self.sqr(b), self.neg_g)), self.neg_ginv)
        v = self.add_lazy(b, self.mont_mul(self.pow_window(u, self.cfg.inv_alpha, self.w), self.neg_one))
        return self.add_lazy(u, self.mont_mul(self.sqr(v), self.g)), v

    def permute(self, s):
        cfg, L, n = self.cfg, self.L, self.cfg.l
        x, y = s[:n], s[n:]
        for r in range(cfg.rounds):
            x = [self.add_lazy(v, self.rc_x[(r * n + j) * L :][:L]) for j, v in enumerate(x)]
            y = [self.add_lazy(v, self.rc_y[(r * n + j) * L :][:L]) for j, v in enumerate(y)]
            x, y = self.diffusion(x, y)
            if pairwise(cfg):  # pair 0, then both columns shifted, l times
                for _ in range(n):
                    a, b = self.flystel(x[0], y[0])
                    x, y = x[1:] + [a], y[1:] + [b]
            else:
                x, y = map(list, zip(*(self.flystel(a, b) for a, b in zip(x, y))))
        x, y = self.diffusion(x, y)
        return [self.store(self.mont_mul(v, self.one)) for v in x + y]


KERNEL7 = {
    **FULL_WIDTH,
    "bls12_381_fr-l4-round1": lambda: bls_cut(7, package=sponge_tpu),
    "goldilocks_fr-l6": lambda: sponge_tpu.get_default_anemoi_parameters(sponge_tpu.GOLDILOCKS_FR, 8),
}


@pytest.mark.parametrize("name", list(KERNEL7))
def test_kernel_emulation_matches_oracle(name):
    """Full width (BLS12-381 t = 2 and t = 4 cut to one round, the 254-bit
    chain at w = 3; t = 8 one pair at a time, at w = 5; Goldilocks t = 8 and
    12 in lockstep); every column below 2^63."""
    cfg = interop.config_from_jax(KERNEL7[name]())
    vals = lanes(cfg.field.modulus, cfg.t, 3, 13)
    kernel = Kernel7(cfg)
    assert emulate(cfg, kernel, vals) == oracle_permute(cfg, vals)
    assert kernel.colmax < 1 << 63


@pytest.mark.parametrize("name", ["bls12_381_fr-l2", "goldilocks_fr-l4"])
def test_constant_layout_matches_unpack_and_kernel_offsets(name):
    """``unpack_constants`` names the sections of ``constant_layout`` in
    order; the kernel finds the inverse schedule after 6L + 2 rounds l L +
    l^2 L words, and it is ``window_schedule`` at ``window(cfg)``."""
    cfg = {"bls12_381_fr-l2": lambda: st.get_default_anemoi_parameters(st.BLS12_381_FR, 3),
           "goldilocks_fr-l4": lambda: st.get_default_anemoi_parameters(st.GOLDILOCKS_FR, 4)}[name]()
    buf = torch.from_numpy(kernel_constants(cfg))
    parts = unpack_constants(cfg, buf)
    assert list(parts) == [n for n, _ in constant_layout(cfg)] == [
        "p", "one", "rc_x", "rc_y", "mat", "scalars", "inv_window"]
    L, n = cfg.field.nlimbs, cfg.l
    off = 6 * L + 2 * cfg.rounds * n * L + n * n * L
    assert buf[off:].tolist() == schedule(cfg) == parts["inv_window"].flatten().tolist()
    assert schedule(cfg) == window_schedule(cfg.inv_alpha, window(cfg))


# ---- dispatch ----


def test_dispatch_on_cpu():
    cfg = interop.config_from_jax(tiny25(rounds=3))
    vals = lanes(cfg.field.modulus, cfg.t, 8, 21)
    state = ints_to_mont_tensor(cfg.field, vals, "cpu")
    out = st.batched_permute(cfg, state)  # "auto" on a CPU tensor: the plain version
    assert torch.equal(out, st.batched_permute(cfg, state, "plain"))
    assert mont_tensor_to_ints(cfg.field, out) == oracle_permute(cfg, vals)
    with pytest.raises(ValueError, match="CUDA kernel"):
        st.batched_permute(cfg, state, "kernel")
    with pytest.raises(ValueError, match="unknown backend"):
        st.batched_permute(cfg, state, "anemoi_pallas")
    perm = st.AnemoiPermutation(cfg, "cpu")
    with pytest.raises(ValueError, match="no kernel for device"):
        anemoi_permute(cfg, perm.consts.to("meta"), state.to("meta"))
    with pytest.raises(NotImplementedError):
        st.batched_permute(tiny25(), state)  # a JAX config
    with pytest.raises(NotImplementedError):
        _build.check_instantiated("sponge_anemoi", 2, 2)
    for t, L in _build.INSTANTIATIONS["sponge_anemoi"]:
        _build.check_instantiated("sponge_anemoi", t, L)


# ---- entry points over the plain tier ----


def test_sponge_reproduces_golden_vector():
    gl = st.get_default_anemoi_parameters(st.GOLDILOCKS_FR, 4)
    assert sponge_squeeze(gl, [0, 1, 2, 3], 2) == [8816711172724677702, 3319201661018352774]


def test_sponge_transcript_and_merkle_match_oracle():
    cfg = interop.config_from_jax(tiny25(rounds=3))
    fs, B = cfg.field, 4
    lane_vals = lanes(fs.modulus, 5, B, 8)
    for sponge in (
        st.PoseidonSponge(cfg, batch_size=B, lazy=False, device="cpu"),
        st.LazyPoseidonSponge(cfg, batch_size=B, device="cpu"),
    ):
        sponge.absorb(st.Batched([[st.Fp(row[b], fs) for row in lane_vals] for b in range(B)]))
        sponge.absorb(b"anemoi")
        oracles = [st.OracleAnemoiSponge(cfg) for _ in range(B)]
        for b, o in enumerate(oracles):
            o.absorb([st.Fp(row[b], fs) for row in lane_vals])
            o.absorb(b"anemoi")
        assert sponge.squeeze_native_field_elements(4) == [o.squeeze_native_field_elements(4) for o in oracles]
        assert sponge.squeeze_bits(50) == [o.squeeze_bits(50) for o in oracles]
    steps = [st.TranscriptAbsorb(4), st.TranscriptSqueeze(1), st.TranscriptAbsorb(1), st.TranscriptSqueeze(4)]
    vals = lanes(fs.modulus, 5, B, 42)
    out = st.compile_transcript(cfg, steps)(ints_to_mont_tensor(fs, vals, "cpu"))
    for b in range(B):
        o = st.OracleAnemoiSponge(cfg)
        o.absorb_field_elements([row[b] for row in vals[:4]])
        want = o.squeeze_native_field_elements(1)
        o.absorb_field_elements([vals[4][b]])
        want += o.squeeze_native_field_elements(4)
        assert [fs.limbs_to_int(out[k, :, b].numpy()) for k in range(5)] == want, b
    leaves = lanes(fs.modulus, 1, 8, 77)[0]
    level = leaves
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level), 2):
            o = st.OracleAnemoiSponge(cfg)
            o.absorb_field_elements(level[i : i + 2])
            nxt.append(o.squeeze_native_field_elements(1)[0])
        level = nxt
    root = merkle_root(cfg, ints_to_mont_tensor(fs, leaves, "cpu"))
    assert mont_tensor_to_ints(fs, root[:, None]) == level


# ---- interop ----


@pytest.mark.parametrize("rate", [1, 7])
def test_interop_from_device_constants(rate):
    jcfg = tiny25(rate=rate)
    cfg = interop.anemoi_config_from_device_constants(
        jax_device_constants(jcfg), modulus=JAX_T25.modulus, limb_bits=JAX_T25.limb_bits,
        alpha=jcfg.alpha, rate=jcfg.rate,
    )
    assert cfg == interop.config_from_jax(jcfg)
    fs = cfg.field
    consts = {  # the JAX layout at 24-bit limbs
        "rc_x": mont_limb_rows(fs, cfg.rc_x)[..., None],
        "rc_y": mont_limb_rows(fs, cfg.rc_y)[..., None],
        "mat": tuple(tuple(mont_col(fs, e) for e in row) for row in cfg.mat_x),
        "g": mont_col(fs, cfg.g),
    }
    back = interop.anemoi_config_from_device_constants(
        consts, modulus=fs.modulus, limb_bits=24, alpha=cfg.alpha, rate=cfg.rate
    )
    assert back == cfg
