"""Kernels 5-8 at every width of the default Rescue-Prime, GMiMC, Griffin
and Anemoi tables.

The port compiles kernel 5 (Rescue-Prime), kernel 8 (GMiMC-erf, both
bodies), kernel 6 (Griffin-pi) and kernel 7 (Anemoi) at every (t, L) of
their default tables over the seven fields at rates 1-8 (115 configs).
Here, on the CPU: every default config passes its wrapper's instantiation
check and its bound replay (GMiMC at Goldilocks: the two-word replay); a
pair outside the compiled set raises on a CUDA tensor with no fallback; the
GMiMC replay refuses BLS12-381 at t = 4..9 without the front reduction and
admits every default (t, 11) config with it, and its bound of the
reduction is tight against the word-level reduction; and the plain versions
(the kernels' functions) equal the JAX package at each new width: the JAX
oracle at the ~255-bit widths (GMiMC at all rounds; Rescue-Prime, Griffin
and Anemoi, whose plain 254-bit inverse chain costs about a second a round
here, cut in rounds) and at the small fields at all rounds, and
``gmimc_permute_jit`` at the Goldilocks widths.  The JAX package's XLA tier
compiles for 10-160 s here at the ~255-bit widths and for 10-33 s at
Griffin's and Anemoi's Goldilocks widths, whatever the round count, over a
test's budget; Rescue-Prime's small-field widths run it in
``tests/test_torch_family_widths_jax.py``.  The kernels' word orders are
emulated in the family files (``Kernel5``, ``Kernel8``, ``Kernel6``,
``Kernel7``).  Inputs come from numpy seeds with 0, 1, p-1 and p-2 in every
element position; equality is exact.
"""

import dataclasses
import random
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_gmimc import _M24, _M32, jax_oracle_permute, lanes, reduce_front_words

import sponge_tpu
import sponge_tpu_torch as st
from sponge_tpu.anemoi import OracleAnemoiSponge as JaxOracleAnemoi
from sponge_tpu.gmimc import OracleGmimcSponge as JaxOracleGmimc
from sponge_tpu.gmimc.permutation import gmimc_permute_jit
from sponge_tpu.griffin import OracleGriffinSponge as JaxOracleGriffin
from sponge_tpu.rescue import OracleRescueSponge as JaxOracleRescue
from sponge_tpu_torch import interop
from sponge_tpu_torch.fields import ints_to_mont_tensor, mont_tensor_to_ints
from sponge_tpu_torch.ops import _build
from sponge_tpu_torch.ops import anemoi as anemoi_ops
from sponge_tpu_torch.ops import gmimc as gmimc_ops
from sponge_tpu_torch.ops import griffin as griffin_ops
from sponge_tpu_torch.ops import rescue as rescue_ops
from sponge_tpu_torch.ops.bounds import (
    _gmimc_replay,
    _Replay,
    check_anemoi_bounds,
    check_gmimc_bounds,
    check_gmimc_word_bounds,
    check_griffin_bounds,
    check_rescue_bounds,
    check_rescue_gl_bounds,
)
from sponge_tpu_torch.ops.montgomery import WIDE_WORDS, wide_state

DEFAULT_FIELDS = ("BLS12_381_FR", "BN254_FR", "BLS12_377_FR", "GOLDILOCKS_FR", "BABYBEAR_FR", "KOALABEAR_FR",
                  "MERSENNE31_FR")
FAMILIES = {  # getter name, permutation class, C symbol, ops module, default configs
    "rescue": ("get_default_rescue_parameters", st.RescuePermutation, "sponge_rescue", rescue_ops, 56),
    "gmimc": ("get_default_gmimc_parameters", st.GmimcPermutation, "sponge_gmimc", gmimc_ops, 32),
    "griffin": ("get_default_griffin_parameters", st.GriffinPermutation, "sponge_griffin", griffin_ops, 11),
    "anemoi": ("get_default_anemoi_parameters", st.AnemoiPermutation, "sponge_anemoi", anemoi_ops, 16),
}
# the (t, L) of each table compiled before the wide schedules, and its test-field pairs
FIRST_PAIRS = {
    "rescue": {(3, 11), (16, 2), (3, 2)},
    "gmimc": {(3, 11), (8, 3), (3, 2)},
    "griffin": {(3, 11), (8, 3), (3, 2)},
    "anemoi": {(4, 11), (2, 11), (8, 3), (4, 2)},
}


def default_configs(family, package=st):
    """{label: config}: every default parameter set of ``family`` (of the
    port, or of the JAX package) over the seven fields at rates 1-8."""
    getter = getattr(package, FAMILIES[family][0])
    out = {}
    for name in DEFAULT_FIELDS:
        for rate in range(1, 9):
            try:
                out[f"{name.lower()}-r{rate}"] = getter(getattr(package, name), rate)
            except ValueError:
                pass
    return out


def first_of_each_pair(family):
    """{label: config}: the first default config (fields in order) of each
    (t, L) compiled since the wide schedules."""
    out, seen = {}, set(FIRST_PAIRS[family])
    for label, cfg in default_configs(family).items():
        pair = (cfg.t, cfg.field.nlimbs)
        if pair not in seen:
            seen.add(pair)
            out[label] = cfg
    return out


# ---- the instantiation guard ----


@pytest.mark.parametrize("family", list(FAMILIES))
def test_every_default_family_config_is_instantiated(family):
    """All 115 default configs (56 Rescue-Prime, 32 GMiMC, 11 Griffin, 16
    Anemoi) pass their kernel's instantiation check and their wrapper's
    launch arguments, which run the bound replay (GMiMC and Rescue-Prime:
    the two-word replay at Goldilocks, whose widths the two-word body holds,
    and the limb replay elsewhere, GMiMC's with the front reduction at
    BLS12-381 t >= 4); the compiled pairs are the defaults' and the test
    fields'."""
    _, perm, symbol, ops, count = FAMILIES[family]
    cfgs = default_configs(family)
    assert len(cfgs) == count
    pairs = set()
    for label, cfg in cfgs.items():
        t, L = cfg.t, cfg.field.nlimbs
        pairs.add((t, L))
        _build.check_instantiated(symbol, t, L)
        module = perm(cfg, "cpu")
        args = ops._launch_args(cfg, module.consts, *((module.words,) if family == "rescue" else ()))
        if family == "gmimc":
            word = cfg.field.name == "goldilocks_fr"
            assert args[0] == int(word) and (t, L) in gmimc_ops.BODIES["word" if word else "limb"], label
            if word:
                check_gmimc_word_bounds(cfg)
            assert args[3] == int(cfg.field.name == "bls12_381_fr" and t >= 4), label
        elif family == "rescue":
            kind = rescue_ops.body(cfg)
            assert args[8] == rescue_ops.BODY_CODES[kind] and (t, L) in rescue_ops.BODIES[kind], label
            if kind == "two-word":
                assert args[-2:] == (1, int(check_rescue_gl_bounds(cfg).narrow)), label
            else:
                assert 2 * cfg.field.modulus <= check_rescue_bounds(cfg) < 3 * cfg.field.modulus, label
        else:
            plan = (check_griffin_bounds if family == "griffin" else check_anemoi_bounds)(cfg)
            assert plan.vmax < cfg.field.r and plan.wmax <= 1 << 32, label
    assert pairs <= _build.INSTANTIATIONS[symbol]
    assert _build.INSTANTIATIONS[symbol] - pairs <= FIRST_PAIRS[family]
    if family == "gmimc":
        assert gmimc_ops.BODIES["limb"] | gmimc_ops.BODIES["word"] == _build.INSTANTIATIONS[symbol]
    if family == "rescue":
        assert rescue_ops.BODIES["limb"] | rescue_ops.BODIES["two-word"] == _build.INSTANTIATIONS[symbol]


def _uncompiled(family):
    """A config of ``family`` at a (t, L) outside ``INSTANTIATIONS``: BLS12-381
    at t = 10 (Rescue-Prime, GMiMC, Anemoi) or t = 12 (Griffin)."""
    fs = st.BLS12_381_FR
    if family == "rescue":
        return st.generate_rescue_parameters(fs, 9, rounds=2)
    if family == "gmimc":
        return st.generate_gmimc_parameters(fs, 9, rounds=12)
    if family == "griffin":
        return st.generate_griffin_parameters(fs, 11, rounds=3)
    return st.generate_anemoi_parameters(fs, 9, rounds=2)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_uncompiled_pair_raises_on_a_cuda_tensor_with_no_fallback(family, monkeypatch):
    """A config at a (t, L) outside ``INSTANTIATIONS`` raises
    NotImplementedError for a CUDA tensor before anything runs: neither the
    plain version nor a launch."""
    _, _, symbol, ops, _ = FAMILIES[family]
    cfg = _uncompiled(family)
    assert (cfg.t, cfg.field.nlimbs) not in _build.INSTANTIATIONS[symbol]
    cuda_state = types.SimpleNamespace(device=torch.device("cuda", 0), shape=(cfg.t, cfg.field.nlimbs, 8))

    def refuse(*args):
        raise AssertionError("ran on an uncompiled pair")

    wrapper = getattr(ops, f"{family}_permute")
    monkeypatch.setattr(_build, "check_state", lambda *args: None)
    monkeypatch.setattr(_build, "launch", refuse)
    monkeypatch.setattr(ops, f"{family}_permute_plain", refuse)
    before = wrapper.launches
    with pytest.raises(NotImplementedError, match="no CUDA kernel instantiation"):
        wrapper(cfg, torch.zeros(1, dtype=torch.int32), cuda_state)
    assert wrapper.launches == before


def test_wide_words_match_mont_cuh():
    """``montgomery.WIDE_WORDS`` is ``kWideWords`` of ``csrc/mont.cuh``, and
    the wide pairs of kernels 5 and 7 are the ~255-bit fields' t >= 4 (kernel
    7: one pair at a time from l = 3 on)."""
    text = (_build.CSRC / "mont.cuh").read_text()
    assert int(re.search(r"constexpr int kWideWords = (\d+);", text)[1]) == WIDE_WORDS
    assert "kPairwise = kWideState<T, L> && T / 2 > 2;" in (_build.CSRC / "anemoi.cu").read_text()
    assert {p for p in _build.INSTANTIATIONS["sponge_rescue"] if wide_state(*p)} == {(t, 11) for t in range(4, 10)}
    pairwise = {(t, L) for t, L in _build.INSTANTIATIONS["sponge_anemoi"] if wide_state(t, L) and t // 2 > 2}
    assert pairwise == {(6, 11), (8, 11)}


# ---- kernel 8's front reduction ----


def test_gmimc_replay_refuses_bls12_381_without_the_front_reduction():
    """Without the front reduction the S-box input grows with the deferred
    adds and the replay refuses BLS12-381 at every t from 4 to 9 (R =
    565.3p); with it, every default (t, 11) config of the three ~255-bit
    fields is admitted, and only those six take it."""
    bls = st.BLS12_381_FR
    with pytest.raises(ValueError, match=r"654\.1p vs R = 565\.3p"):
        _gmimc_replay(st.get_default_gmimc_parameters(bls, 3), False)
    for rate in range(3, 9):
        with pytest.raises(ValueError, match="reach R"):
            _gmimc_replay(st.get_default_gmimc_parameters(bls, rate), False)
    admitted = 0
    for name in ("BLS12_381_FR", "BN254_FR", "BLS12_377_FR"):
        fs = getattr(st, name)
        for rate in range(1, 9):
            cfg = st.get_default_gmimc_parameters(fs, rate)
            plan = check_gmimc_bounds(cfg)
            assert plan.reduce == (fs is bls and cfg.t >= 4), (name, rate)
            assert plan.vmax < fs.r and plan.wmax < 1 << 32
            admitted += 1
    assert admitted == 24  # t = 2..9 at the three fields: the 21 at new pairs and (3, 11)


@pytest.mark.parametrize("field", ["BLS12_381_FR", "BN254_FR", "GOLDILOCKS_FR", "tiny_fr_25"])
def test_front_reduction_bound_is_tight(field):
    """``_Replay.reduce_front``'s exclusive bound for carried inputs below V
    is one more than the largest result: over each top word T the largest
    input leaves the largest result, v - q(T) p, and the bound equals the
    largest of those over every T at the 25-bit field and over the last two
    quotient steps (where the replay finds it) at the others.  The
    word-level reduction of the kernel (``reduce_front_words``) leaves
    exactly v - q(T) p, carried, at that maximum, at V - 1 and at random
    values below V."""
    fs = (st.FieldSpec(name="tiny_fr_25", modulus=(1 << 25) - 39, generator=3) if field == "tiny_fr_25"
          else getattr(st, field))
    p, L, S = fs.modulus, fs.nlimbs, 24 * (fs.nlimbs - 1)
    p_limbs = [int(w) for w in fs.int_to_limbs(p)]
    qinv = _M32 // ((p >> S) + 1)
    sim, rng = _Replay("test", fs), random.Random(17)
    for mult in (3, 40, 251, 467):
        V = mult * p + rng.randrange(p)
        top = V - 1 >> S
        start = 0 if top < 1 << 16 else top - 2 * ((p >> S) + 2)
        reduced = lambda v: v - ((v >> S) * qinv >> 32) * p
        worst = max((min((T + 1 << S) - 1, V - 1) for T in range(start, top + 1)), key=reduced)
        want = reduced(worst) + 1
        assert sim.reduce_front((V, 0))[0] == want, mult
        for v in [worst, V - 1] + [rng.randrange(V) for _ in range(64)]:
            limbs = [v >> 24 * k & _M24 for k in range(L - 1)] + [v >> S]
            out = reduce_front_words(p_limbs, limbs)
            r = sum(w << 24 * k for k, w in enumerate(out))
            assert r == reduced(v) and 0 <= r < want and max(out[:-1]) <= _M24


# ---- the plain versions against the JAX package at the new widths ----


def _cut(cfg, rounds):
    """The config with its first ``rounds`` rounds (Rescue-Prime: 2 rc rows a
    round; Griffin: rounds - 1 rows; Anemoi: both columns' rows)."""
    if isinstance(cfg, (st.RescueConfig, sponge_tpu.RescueConfig)):
        return dataclasses.replace(cfg, rounds=rounds, rc=cfg.rc[: 2 * rounds])
    if isinstance(cfg, (st.GriffinConfig, sponge_tpu.GriffinConfig)):
        return dataclasses.replace(cfg, rounds=rounds, rc=cfg.rc[: rounds - 1])
    return dataclasses.replace(cfg, rounds=rounds, rc_x=cfg.rc_x[:rounds], rc_y=cfg.rc_y[:rounds])


ORACLES = {"rescue": JaxOracleRescue, "gmimc": JaxOracleGmimc, "griffin": JaxOracleGriffin,
           "anemoi": JaxOracleAnemoi}
# rounds kept at a ~255-bit width (None: all); the small fields run all rounds
CUT = {"rescue": 1, "gmimc": None, "griffin": 2, "anemoi": 1}
NEW_PAIRS = [(family, label) for family in FAMILIES for label in first_of_each_pair(family)]


@pytest.mark.parametrize("family,label", NEW_PAIRS, ids=[f"{f}-{label}" for f, label in NEW_PAIRS])
def test_plain_matches_jax_oracle_at_each_new_width(family, label):
    """The first default config of each new (t, L) (44 pairs: the ~255-bit
    fields cut in rounds where the inverse chain is long, every small field
    at all rounds), the port's config equal to the JAX package's through
    ``interop``, on 12 lanes against the JAX package's oracle."""
    getter, perm, *_ = FAMILIES[family]
    cfg = first_of_each_pair(family)[label]
    name = next(n for n in DEFAULT_FIELDS if getattr(st, n) is cfg.field)
    jcfg = getattr(sponge_tpu, getter)(getattr(sponge_tpu, name), cfg.rate)
    assert interop.config_from_jax(jcfg) == cfg
    if cfg.field.nlimbs == 11 and CUT[family]:
        cfg, jcfg = _cut(cfg, CUT[family]), _cut(jcfg, CUT[family])
    vals = lanes(cfg.field.modulus, cfg.t, 12, 59 + cfg.t)
    out = perm.plain(cfg, perm(cfg, "cpu").consts, ints_to_mont_tensor(cfg.field, vals, "cpu"))
    assert mont_tensor_to_ints(cfg.field, out) == jax_oracle_permute(ORACLES[family], jcfg, vals)


GMIMC_GL = [label for label, cfg in first_of_each_pair("gmimc").items() if cfg.field is st.GOLDILOCKS_FR]


@pytest.mark.parametrize("label", GMIMC_GL)
def test_gmimc_plain_matches_permute_jit_at_goldilocks(label):
    """Kernel 8's two-word widths (Goldilocks t = 5..12 beyond t = 8), all
    rounds, 24 lanes: the plain version equals ``gmimc_permute_jit``."""
    cfg = first_of_each_pair("gmimc")[label]
    jcfg = sponge_tpu.get_default_gmimc_parameters(sponge_tpu.GOLDILOCKS_FR, cfg.rate)
    jfs = jcfg.field
    vals = lanes(jfs.modulus, jcfg.t, 24, 61 + cfg.rate)
    x = jnp.asarray(np.stack([jfs.ints_to_mont_plane(r) for r in vals]))
    want = [jfs.mont_plane_to_ints(r) for r in np.asarray(gmimc_permute_jit(jcfg)(x))]
    out = st.GmimcPermutation.plain(cfg, st.GmimcPermutation(cfg, "cpu").consts,
                                    ints_to_mont_tensor(cfg.field, vals, "cpu"))
    assert mont_tensor_to_ints(cfg.field, out) == want
