"""The port's Griffin-pi family against the JAX package and the oracle.

Parameters and validation; the oracle's frozen vectors and the JAX oracle on
random states; ``griffin_permute_plain`` (kernel 6's function) against
``griffin_permute_jit`` and the Pallas kernel ``griffin_permute_fn`` in
interpret mode on the 25-bit test field, and against the oracle at full
width (BLS12-381 with its rounds cut to two: there the plain permutation
takes about 0.5 s a round on the CPU and the JAX tier's compile some 40 s);
the static bound and its post-linear reduction, the window rule of the
inverse chain and its replay; a word-by-word emulation of ``csrc/griffin.cu``
against the oracle; dispatch; and the sponge, transcript
and Merkle entry points driven by a Griffin config.  Inputs come from numpy
seeds; equality is exact (tolerance 0) on canonical values.  The CUDA kernel
itself runs on the card (``chip_smoke.py``).
"""

from collections import namedtuple

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_gmimc import (
    _M32,
    JAX_T25,
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
from sponge_tpu.griffin import GriffinConfig as JaxGriffinConfig
from sponge_tpu.griffin import OracleGriffinSponge as JaxOracleGriffin
from sponge_tpu.griffin.params import generate_griffin_parameters as jax_generate
from sponge_tpu.griffin.permutation import _device_constants as jax_device_constants
from sponge_tpu.griffin.permutation import griffin_permute_jit
from sponge_tpu.ops.pallas_griffin import griffin_permute_fn
import sponge_tpu_torch as st
from sponge_tpu_torch import interop
from sponge_tpu_torch.fields import ints_to_mont_tensor, mont_tensor_to_ints
from sponge_tpu_torch.griffin.config import constant_layout, kernel_constants, schedule, unpack_constants, window
from sponge_tpu_torch.hash import compress_pairs, merkle_root
from sponge_tpu_torch.ops import _build
from sponge_tpu_torch.ops import montgomery as mont
from sponge_tpu_torch.ops.bounds import _griffin_replay, check_griffin_bounds
from sponge_tpu_torch.ops.griffin import griffin_permute
from sponge_tpu_torch.ops.montgomery import window_schedule
from sponge_tpu_torch.poseidon.config import mont_limb_rows

FIELDS = {"bls12_381": "BLS12_381_FR", "bn254": "BN254_FR", "goldilocks": "GOLDILOCKS_FR"}


def tiny25(rounds=4, rate=2):
    """tests/test_griffin.py's 25-bit config (JAX)."""
    return jax_generate(JAX_T25, rate, rounds=rounds)


def bls_cut(rounds=2, package=st, rate=2):
    """The BLS12-381 default of ``rate`` (of the port, or of the JAX package
    ``sponge_tpu``) with its first ``rounds`` rounds."""
    full = package.get_default_griffin_parameters(package.BLS12_381_FR, rate)
    return dataclasses.replace(full, rounds=rounds, rc=full.rc[: rounds - 1])


# ---- parameters ----


DEFAULTS = {"bls12_381-r2": ("bls12_381", 2), "bn254-r2": ("bn254", 2), "goldilocks-r4": ("goldilocks", 4),
            # more widths of the default tables: (4, 11), (8, 11), (12, 3)
            "bls12_381-r3": ("bls12_381", 3), "bls12_381-r7": ("bls12_381", 7), "bn254-r7": ("bn254", 7),
            "goldilocks-r8": ("goldilocks", 8)}


@pytest.mark.parametrize("name", list(DEFAULTS))
def test_default_parameters_equal_jax(name):
    field, rate = DEFAULTS[name]
    fs, jfs = getattr(st, FIELDS[field]), getattr(sponge_tpu, FIELDS[field])
    cfg = st.get_default_griffin_parameters(fs, rate)
    jcfg = sponge_tpu.get_default_griffin_parameters(jfs, rate)
    ported = interop.config_from_jax(jcfg)
    assert type(ported) is st.GriffinConfig and cfg == ported
    assert cfg.inv_alpha == jcfg.inv_alpha
    assert [cfg.quad_coeffs(i) for i in range(2, cfg.t)] == [jcfg.quad_coeffs(i) for i in range(2, cfg.t)]
    assert st.griffin_default_rounds(cfg.alpha) == cfg.rounds


def test_tiny_parameters_and_nonresidues():
    fs = interop.field_for_modulus(JAX_T25.modulus)
    for rate in (2, 3, 7):
        assert st.generate_griffin_parameters(fs, rate, rounds=4) == interop.config_from_jax(tiny25(rate=rate))
    from sponge_tpu.griffin.config import is_quadratic_nonresidue as jax_qnr

    for p in (JAX_T25.modulus, st.BLS12_381_FR.modulus, st.GOLDILOCKS_FR.modulus):
        assert [st.is_quadratic_nonresidue(v, p) for v in range(40)] == [jax_qnr(v, p) for v in range(40)]


def _validation_cases(fr, cfg):
    return {
        "width": dict(rounds=2, alpha=5, mat_e=((2, 1), (1, 2)), rc=(cfg.rc[0][:2],), rate=1),
        "alpha": dict(rounds=2, alpha=3, mat_e=cfg.mat_e, rc=cfg.rc[:1], rate=2),
        "rc": dict(rounds=3, alpha=5, mat_e=cfg.mat_e, rc=cfg.rc[:1], rate=2),
        "residue": dict(rounds=14, alpha=5, mat_e=cfg.mat_e, rc=cfg.rc, rate=2, qc_alpha=2, qc_beta=0),
    }


@pytest.mark.parametrize("case", ["width", "alpha", "rc", "residue"])
def test_validation_errors_match_jax(case):
    jcfg = sponge_tpu.get_default_griffin_parameters(sponge_tpu.BLS12_381_FR, 2)
    cfg = st.get_default_griffin_parameters(st.BLS12_381_FR, 2)
    kw = dict(qc_alpha=cfg.qc_alpha, qc_beta=cfg.qc_beta)
    kw.update(_validation_cases(st.BLS12_381_FR, cfg)[case])
    with pytest.raises(ValueError) as want:
        JaxGriffinConfig(field=jcfg.field, **kw)
    with pytest.raises(ValueError) as got:
        st.GriffinConfig(field=cfg.field, **kw)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jax_generate(sponge_tpu.BLS12_381_FR, 4)  # t = 5
    with pytest.raises(ValueError) as got:
        st.generate_griffin_parameters(st.BLS12_381_FR, 4)
    assert str(got.value) == str(want.value)


# ---- oracle ----


def test_oracle_frozen_vectors():
    o = st.OracleGriffinSponge(st.get_default_griffin_parameters(st.BLS12_381_FR, 2))
    o.absorb_field_elements([0, 1])
    assert o.squeeze_native_field_elements(2) == [
        17568489372357836836505885331655087491470577238226034896877593231157640869808,
        14593224294559100415741393686604387315592950665506024215387915292647432429441,
    ]
    o = st.OracleGriffinSponge(st.get_default_griffin_parameters(st.GOLDILOCKS_FR, 4))
    o.absorb_field_elements(list(range(4)))
    assert o.squeeze_native_field_elements(2) == [5142094782954152270, 13580507934772854974]


@pytest.mark.parametrize("rate", [2, 3, 7])
def test_oracle_matches_jax_oracle(rate):
    jcfg = tiny25(rate=rate)
    cfg = interop.config_from_jax(jcfg)
    vals = lanes(JAX_T25.modulus, cfg.t, 5, rate)
    for b in range(5):
        o, j = st.OracleGriffinSponge(cfg), JaxOracleGriffin(jcfg)
        o.state = j.state = [row[b] for row in vals]
        o.permute()
        j.permute()
        assert o.state == j.state, b


# ---- the plain version against the JAX tiers and the oracle ----


def test_plain_matches_griffin_permute_jit():
    jcfg = tiny25()
    vals = lanes(JAX_T25.modulus, jcfg.t, 16, 11)
    plain_matches_jax(st.GriffinPermutation, jcfg, griffin_permute_jit(jcfg), vals)


def test_plain_matches_griffin_kernel_interpret():
    jcfg = tiny25(rounds=2)
    fn = griffin_permute_fn(jcfg, interpret=True)
    plain_matches_jax(st.GriffinPermutation, jcfg, fn, lanes(JAX_T25.modulus, 3, 2048, 71))


@pytest.mark.parametrize("name", ["bls12_381_fr-t3-rounds2", "goldilocks_fr-t8"])
def test_plain_matches_oracle_full_width(name):
    """Against the JAX package's oracle; BLS12-381 cut to two rounds to keep
    the plain inverse ladder short on the CPU."""
    if name.startswith("bls"):
        jcfg = bls_cut(package=sponge_tpu)
        assert interop.config_from_jax(jcfg) == bls_cut()
    else:
        jcfg = sponge_tpu.get_default_griffin_parameters(sponge_tpu.GOLDILOCKS_FR, 4)
    cfg = interop.config_from_jax(jcfg)
    vals = lanes(cfg.field.modulus, cfg.t, 4, 9)
    assert plain(st.GriffinPermutation, cfg, vals) == jax_oracle_permute(JaxOracleGriffin, jcfg, vals)


# ---- the static bound of kernel 6 ----


def test_bound_takes_the_post_linear_reduction_where_needed():
    """Goldilocks t = 8: the row sum 48 against R/p = 256 diverges
    unreduced, so the plan reduces after each linear layer; BLS12-381 and
    BN254 at t = 3 (row sum 4) do not."""
    assert check_griffin_bounds(st.get_default_griffin_parameters(st.GOLDILOCKS_FR, 4)).reduce
    for fs in (st.BLS12_381_FR, st.BN254_FR):
        plan = check_griffin_bounds(st.get_default_griffin_parameters(fs, 2))
        assert not plan.reduce and plan.vmax < 10 * fs.modulus, fs.name
    assert not check_griffin_bounds(interop.config_from_jax(tiny25())).reduce


_Field = namedtuple("_Field", "name modulus r nlimbs")
_Cfg = namedtuple("_Cfg", "field t rounds alpha inv_alpha mat_e")


def test_bound_refuses_what_no_plan_makes_exact():
    """A 44-bit field has R = 16p: at t = 8 one linear layer alone reaches
    48p.  A radix of 2p fails at t = 3 too."""
    low = st.FieldSpec(name="low_headroom_44", modulus=(1 << 44) - 17, generator=3)
    with pytest.raises(ValueError, match="reach R"):
        check_griffin_bounds(st.generate_griffin_parameters(low, 7, rounds=4))
    p = (1 << 31) - 1
    tight = _Cfg(_Field("tight", p, 2 * p, 2), 3, 2, 5, pow(5, -1, p - 1), ((2, 1, 1), (1, 2, 1), (1, 1, 2)))
    with pytest.raises(ValueError, match="reach R"):
        check_griffin_bounds(tight)


# ---- word-by-word emulation of csrc/griffin.cu ----


class Kernel6(Words):
    """``csrc/griffin.cu`` for one lane: the opening linear layer, then per
    round the window chain on x_0 (``pow_window`` at the config's window,
    read from the buffer's schedule), x_1^alpha by ``pow_sqr`` (squarings by
    ``mont_sqr``), the gates from i = t-1 down to 2 (L_i^2 by ``mont_sqr``,
    the products by alpha_i and by 1 as full products by the constant's
    limbs), the linear layer plus rc, and the plan's post-linear
    reduction."""

    def __init__(self, cfg):
        super().__init__(cfg.field)
        c = [int(v) for v in kernel_constants(cfg)]
        L, t = self.L, cfg.t
        self.cfg, self.one = cfg, c[L : 2 * L]
        off = 2 * L
        self.rc = c[off : off + cfg.rounds * t * L]
        off += cfg.rounds * t * L
        self.qa, self.qb = c[off : off + (t - 2) * L], c[off + (t - 2) * L : off + 2 * (t - 2) * L]
        off += 2 * (t - 2) * L
        self.mat = c[off : off + t * t]
        self.sched = c[off + t * t :]
        self.reduce = check_griffin_bounds(cfg).reduce

    def linear(self, x, rc_row):
        t, L = self.cfg.t, self.L
        y = [[sum(self.mat[i * t + j] * x[j][k] for j in range(t)) & _M32 for k in range(L)] for i in range(t)]
        y = [self.carry_pass(v) if rc_row is None else self.add_lazy(v, rc_row[e * L :][:L]) for e, v in enumerate(y)]
        return [self.mont_mul(v, self.one) for v in y] if self.reduce else y

    def permute(self, x):
        cfg, L, t = self.cfg, self.L, self.cfg.t
        x = self.linear(x, None)
        assert self.sched == window_schedule(cfg.inv_alpha, window(cfg))
        for r in range(cfg.rounds):
            y0, y1 = self.pow_window(x[0], cfg.inv_alpha, window(cfg)), self.pow_sqr(x[1], cfg.alpha)
            for i in range(t - 1, 1, -1):
                li = [((i - 1) * a + b + (x[i - 1][k] if i >= 3 else 0)) & _M32 for k, (a, b) in enumerate(zip(y0, y1))]
                li = self.carry_pass(li)
                quad = self.add_lazy(self.sqr(li), self.mont_mul(li, self.qa[(i - 2) * L :][:L]))
                x[i] = self.mont_mul(x[i], self.add_lazy(quad, self.qb[(i - 2) * L :][:L]))
            x[0], x[1] = y0, y1
            x = self.linear(x, self.rc[r * t * L : (r + 1) * t * L])
        return [self.store(self.mont_mul(v, self.one)) for v in x]

    def pow_sqr(self, x, e):
        """``pow_sqr1``: square-and-multiply over the bits of e, squarings by
        ``mont_sqr``."""
        acc = x
        for bit in range(e.bit_length() - 2, -1, -1):
            acc = self.sqr(acc)
            if (e >> bit) & 1:
                acc = self.mont_mul(acc, x)
        return acc


KERNEL6 = {
    "bls12_381_fr-t3-rounds2": bls_cut,
    "goldilocks_fr-t8": lambda: st.get_default_griffin_parameters(st.GOLDILOCKS_FR, 4),
    "tiny_fr_25-t8": lambda: interop.config_from_jax(tiny25(rate=7)),
    "bls12_381_fr-t4-rounds2": lambda: bls_cut(rate=3),
    "bls12_381_fr-t8-rounds6": lambda: bls_cut(6, rate=7),
    "goldilocks_fr-t12": lambda: st.get_default_griffin_parameters(st.GOLDILOCKS_FR, 8),
}


@pytest.mark.parametrize("name", list(KERNEL6))
def test_kernel_emulation_matches_oracle(name):
    """BLS12-381 t = 3, 4 and 8 cut in rounds (t = 8 at 6 rounds takes the
    post-linear reduction), Goldilocks t = 8 and 12 (both reduced) and the
    25-bit t = 8 at all rounds; the 44- and 88-word states (4, 11) and
    (8, 11) keep kernel 6's one chain per lane and its gates one at a time,
    the same schedule as at t = 3."""
    cfg = KERNEL6[name]()
    vals = lanes(cfg.field.modulus, cfg.t, 4, 13)
    kernel = Kernel6(cfg)
    assert kernel.reduce == (name in ("bls12_381_fr-t8-rounds6", "goldilocks_fr-t8", "goldilocks_fr-t12"))
    assert emulate(cfg, kernel, vals) == oracle_permute(cfg, vals)


def test_window_rule_picks_kernel_6s_windows():
    """x_0^(1/alpha) is one chain per lane.  At BLS12-381 (L = 11) a 4-bit
    table (39,424 bytes a block) keeps the 5 blocks of 81-96 registers, and
    251 squarings and 62 multiplies beat w = 3's 252 + 66 and the ladder's
    253 + 129; at 80 registers (6 blocks) only w = 3 keeps them.  Goldilocks
    (L = 3) takes w = 4 (61 + 19 against the ladder's 63 + 32) at any
    residency.  The shipped windows are the rule's at ``_build.REGISTERS``,
    and the buffer carries their schedules."""
    bls = st.get_default_griffin_parameters(st.BLS12_381_FR, 2)
    gl = st.get_default_griffin_parameters(st.GOLDILOCKS_FR, 4)
    assert mont.window_table_bytes(1, 11, 4) == 39424
    assert [mont.window_for(bls.inv_alpha, 11, 1, r) for r in (80, 88, 96, 104, 128)] == [3, 4, 4, 4, 4]
    assert [mont.window_counts(bls.inv_alpha, w) for w in (1, 3, 4)] == [(253, 129), (252, 66), (251, 62)]
    assert [mont.window_for(gl.inv_alpha, 3, 1, r) for r in (32, 56, 96, 128)] == [4, 4, 4, 4]
    assert mont.window_counts(gl.inv_alpha, 1) == (63, 32) and mont.window_counts(gl.inv_alpha, 4) == (61, 19)
    for cfg in (bls, gl):
        L = cfg.field.nlimbs
        assert window(cfg) == mont.window_for(cfg.inv_alpha, L, 1, _build.registers("sponge_griffin", cfg.t, L))
        sched = unpack_constants(cfg, torch.from_numpy(kernel_constants(cfg)))["inv_window"]
        assert sched.reshape(-1).tolist() == schedule(cfg) == window_schedule(cfg.inv_alpha, window(cfg))
        assert dict(constant_layout(cfg))["inv_window"] == (len(schedule(cfg)),)


@pytest.mark.parametrize("name", ["bls12_381", "bn254", "goldilocks"])
def test_replay_admits_shipped_window_chains(name):
    """The replay of the window chain (its table included) and the
    squarings admits the shipped configs with the plan's reduction, and its
    bounds stay where the kernel needs them."""
    fs, rate = {"bls12_381": (st.BLS12_381_FR, 2), "bn254": (st.BN254_FR, 2), "goldilocks": (st.GOLDILOCKS_FR, 4)}[name]
    cfg = st.get_default_griffin_parameters(fs, rate)
    plan = check_griffin_bounds(cfg)
    assert plan == _griffin_replay(cfg, plan.reduce)
    assert plan.vmax < fs.r and plan.wmax < 1 << 32
    assert plan.reduce == (name == "goldilocks")


def test_replay_refuses_an_overflowing_window_chain():
    """A radix of 2p: the window table's first squaring already reaches R,
    with or without the post-linear reduction."""
    p = (1 << 31) - 1
    tight = _Cfg(_Field("tight", p, 2 * p, 2), 3, 2, 5, pow(5, -1, p - 1), ((2, 1, 1), (1, 2, 1), (1, 1, 2)))
    for reduce in (False, True):
        with pytest.raises(ValueError, match="reach R"):
            _griffin_replay(tight, reduce)


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
        st.batched_permute(cfg, state, "griffin_pallas")
    perm = st.GriffinPermutation(cfg, "cpu")
    with pytest.raises(ValueError, match="no kernel for device"):
        griffin_permute(cfg, perm.consts.to("meta"), state.to("meta"))
    with pytest.raises(NotImplementedError):
        st.batched_permute(tiny25(), state)  # a JAX config
    with pytest.raises(NotImplementedError):
        _build.check_instantiated("sponge_griffin", 10, 11)
    for t, L in _build.INSTANTIATIONS["sponge_griffin"]:
        _build.check_instantiated("sponge_griffin", t, L)


# ---- entry points over the plain tier ----


def test_sponge_reproduces_golden_vectors():
    """Goldilocks rate 4 in full; at BLS12-381 the first squeezed element
    (one permutation, about 5 s on the CPU; both elements on the card in
    chip_smoke.py)."""
    gl = st.get_default_griffin_parameters(st.GOLDILOCKS_FR, 4)
    assert sponge_squeeze(gl, [0, 1, 2, 3], 2) == [5142094782954152270, 13580507934772854974]
    bls = st.get_default_griffin_parameters(st.BLS12_381_FR, 2)
    assert sponge_squeeze(bls, [0, 1], 1, B=1) == [
        17568489372357836836505885331655087491470577238226034896877593231157640869808
    ]


def test_sponge_transcript_and_merkle_match_oracle():
    cfg = interop.config_from_jax(tiny25(rounds=3))
    fs, B = cfg.field, 4
    lane_vals = lanes(fs.modulus, 5, B, 8)
    for sponge in (
        st.PoseidonSponge(cfg, batch_size=B, lazy=False, device="cpu"),
        st.LazyPoseidonSponge(cfg, batch_size=B, device="cpu"),
    ):
        sponge.absorb(st.Batched([[st.Fp(row[b], fs) for row in lane_vals] for b in range(B)]))
        sponge.absorb(st.U64(9))
        oracles = [st.OracleGriffinSponge(cfg) for _ in range(B)]
        for b, o in enumerate(oracles):
            o.absorb([st.Fp(row[b], fs) for row in lane_vals])
            o.absorb(st.U64(9))
        assert sponge.squeeze_native_field_elements(3) == [o.squeeze_native_field_elements(3) for o in oracles]
        assert sponge.squeeze_bytes(7) == [o.squeeze_bytes(7) for o in oracles]
    steps = [st.TranscriptAbsorb(2), st.TranscriptSqueeze(1), st.TranscriptAbsorb(1), st.TranscriptSqueeze(2)]
    vals = lanes(fs.modulus, 3, B, 42)
    out = st.compile_transcript(cfg, steps)(ints_to_mont_tensor(fs, vals, "cpu"))
    for b in range(B):
        o = st.OracleGriffinSponge(cfg)
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
            o = st.OracleGriffinSponge(cfg)
            o.absorb_field_elements(level[i : i + 2])
            nxt.append(o.squeeze_native_field_elements(1)[0])
        level = nxt
    plane = ints_to_mont_tensor(fs, leaves, "cpu")
    root = merkle_root(cfg, plane)
    assert mont_tensor_to_ints(fs, root[:, None]) == level
    pairs = compress_pairs(cfg, plane[:, 0::2], plane[:, 1::2])
    assert mont_tensor_to_ints(fs, pairs) == [
        oracle_compress(cfg, leaves[i], leaves[i + 1]) for i in range(0, 8, 2)
    ]


def oracle_compress(cfg, a, b):
    o = cfg.oracle_sponge()
    o.absorb_field_elements([a, b])
    return o.squeeze_native_field_elements(1)[0]


# ---- interop ----


def test_interop_from_device_constants():
    jcfg = tiny25(rate=7)
    rc, mat_e, quads = jax_device_constants(jcfg)
    cfg = interop.griffin_config_from_device_constants(
        rc, mat_e, quads, modulus=JAX_T25.modulus, limb_bits=JAX_T25.limb_bits, alpha=jcfg.alpha,
        rate=jcfg.rate,
    )
    assert cfg == interop.config_from_jax(jcfg)
    fs, t = cfg.field, cfg.t
    rc = mont_limb_rows(fs, tuple(cfg.rc) + ((0,) * t,))[..., None]  # the JAX layout at 24-bit limbs
    quads = [tuple(mont_col(fs, v) for v in cfg.quad_coeffs(i)) for i in range(2, t)]
    back = interop.griffin_config_from_device_constants(
        rc, np.asarray(cfg.mat_e), quads, modulus=fs.modulus, limb_bits=24, alpha=cfg.alpha, rate=cfg.rate
    )
    assert back == cfg
