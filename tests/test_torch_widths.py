"""Kernels 1, 2 and 3 at every width of the default Poseidon and Poseidon2
tables.

The port compiles kernels 1 and 2 at every (t, L) of the default Poseidon
tables (both tables over the seven fields: the ~255-bit fields at rates 2-8,
t = 3..9 with L = 11; Goldilocks at t = 8 and 12; the 31-bit fields at
t = 16) and kernel 3's limb body at every Poseidon2 default width.  Here, on
the CPU: every default config passes the wrappers' instantiation and bound
checks, a pair outside the compiled set raises on a CUDA tensor with no
fallback, the C entry points dispatch exactly the pairs ``_build`` lists,
and the plain versions (the kernels' functions) equal the JAX package at the
new widths: ``permute_jit`` at the small fields at full rounds; the JAX
package's oracle at the ~255-bit widths cut in rounds (R_F = 4, R_P = 6) and
at full rounds (``permute_jit`` compiles for 9-13 s at t >= 4 over a
~255-bit field whatever the round count, its rounds being fori_loops, which
is over a test's budget); and the CIOS kernel body run as plain jnp at
t = 4 over the 35-bit test field.  The word order of the kernels' wide schedule is emulated
in ``tests/test_torch_permutation.py`` (``Kernel1``) and
``tests/test_torch_poseidon2.py`` (``_Kernel3``).  Inputs come from numpy
seeds with 0, 1, p-1 and p-2 in every element position; equality is exact.
The chunked Grain LFSR that generates the parameters is held against the
register clocked one bit at a time.
"""

import pathlib
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import tiny_poseidon_config
from test_torch_permutation import DEFAULT_FIELDS, _FakeRef, both_plains, cut_rounds, default_poseidon_configs, lanes

import sponge_tpu
import sponge_tpu_torch as st
from sponge_tpu.ops import pallas_cios as pc
from sponge_tpu.poseidon.optimized import optimized_partial_layers as jax_layers
from sponge_tpu.poseidon.oracle import OraclePoseidonSponge as JaxOracle
from sponge_tpu.poseidon.permutation import permute_jit
from sponge_tpu.poseidon2 import OraclePoseidon2Sponge as JaxOracle2
from sponge_tpu_torch import interop
from sponge_tpu_torch.fields import ints_to_mont_tensor, mont_tensor_to_ints
from sponge_tpu_torch.ops import _build
from sponge_tpu_torch.ops import gmimc as gmimc_ops
from sponge_tpu_torch.ops import poseidon2 as p2_ops
from sponge_tpu_torch.ops import poseidon_dense, poseidon_opt
from sponge_tpu_torch.ops.bounds import P2_FOLD_CAPS
from sponge_tpu_torch.ops.poseidon2 import BODIES, permute_p2_plain
from sponge_tpu_torch.poseidon.params import PoseidonGrainLFSR

CSRC = pathlib.Path(_build.CSRC)


def default_p2_configs():
    """{label: config}: every default Poseidon2 parameter set of the port."""
    out = {}
    for fs in DEFAULT_FIELDS:
        for rate in range(1, 9):
            try:
                out[f"{fs.name}-r{rate}"] = st.get_default_poseidon2_parameters(fs, rate)
            except ValueError:
                pass
    return out


def jax_config(cfg):
    """The JAX package's PoseidonConfig with ``cfg``'s constants."""
    return sponge_tpu.poseidon.config.PoseidonConfig(
        field=getattr(sponge_tpu, cfg.field.name.upper()), full_rounds=cfg.full_rounds,
        partial_rounds=cfg.partial_rounds, alpha=cfg.alpha, ark=cfg.ark, mds=cfg.mds, rate=cfg.rate,
        capacity=cfg.capacity)


def jax_oracle_lanes(jcfg, vals, oracle=JaxOracle):
    """[t][B] -> [t][B] through the JAX package's scalar oracle."""
    out = []
    for b in range(len(vals[0])):
        o = oracle(jcfg)
        o.state = [row[b] for row in vals]
        o.permute()
        out.append(o.state)
    return [list(col) for col in zip(*out)]


# ---- the instantiation guard ----


def test_every_default_poseidon_config_is_instantiated():
    """All 52 default Poseidon configs pass kernels 1 and 2's instantiation
    check and their wrappers' launch arguments (the value-bound replay)."""
    pos = default_poseidon_configs()
    assert len(pos) == 52
    for label, cfg in pos.items():
        perm = st.PoseidonPermutation(cfg, "cpu")
        for symbol in ("sponge_poseidon_opt", "sponge_poseidon_dense"):
            _build.check_instantiated(symbol, cfg.t, cfg.field.nlimbs)
        for optimized in (False, True):
            args = poseidon_dense._launch_args(cfg, perm.consts, optimized=optimized, words=perm.words)
            assert args[:3] == (cfg.alpha, cfg.full_rounds, cfg.partial_rounds), label


def test_every_default_poseidon2_config_is_instantiated():
    """All 14 default Poseidon2 configs pass kernel 3's instantiation check
    and its body's (``BODIES``); the limb body's fold plan stays within the
    kernel's caps (``kMaxFolds``, ``kMaxSboxFolds``)."""
    p2 = default_p2_configs()
    assert len(p2) == 14
    for label, cfg in p2.items():
        _build.check_instantiated("sponge_poseidon2", cfg.t, cfg.field.nlimbs)
        consts = st.Poseidon2Permutation(cfg, "cpu").consts
        args = p2_ops._launch_args(cfg, consts)  # raises outside the body's pairs
        plan = p2_ops.check_p2_bounds(cfg)
        assert args[0] == (0 if plan.body == "limb" else 1 + plan.structured), label
        if plan.body == "limb":
            assert all(pre <= P2_FOLD_CAPS[0] and sbox <= P2_FOLD_CAPS[1] for pre, sbox in plan.folds), label
    widths = {(cfg.t, cfg.field.nlimbs) for cfg in p2.values() if p2_ops.check_p2_bounds(cfg).body == "limb"}
    assert {(4, 11), (8, 11), (8, 3), (12, 3)} <= widths <= BODIES["limb"]


def _uncompiled():
    rng = np.random.default_rng(5)
    fs = st.BLS12_381_FR
    draw = lambda: int(rng.integers(1, 2**62))
    pos = st.PoseidonConfig(field=fs, full_rounds=8, partial_rounds=4, alpha=5,
                            ark=tuple(tuple(draw() for _ in range(10)) for _ in range(12)),
                            mds=tuple(tuple(draw() for _ in range(10)) for _ in range(10)), rate=9)
    p2 = st.generate_poseidon2_parameters(st.GOLDILOCKS_FR, 15, 7, 8, 22)  # (16, 3)
    return [(poseidon_opt.permute_opt, pos), (poseidon_dense.permute_dense, pos), (p2_ops.permute_p2, p2)]


@pytest.mark.parametrize("index", range(3), ids=["opt-(10, 11)", "dense-(10, 11)", "p2-(16, 3)"])
def test_uncompiled_pair_raises_on_a_cuda_tensor_with_no_fallback(index, monkeypatch):
    """A config at a (t, L) outside ``INSTANTIATIONS`` raises
    NotImplementedError for a CUDA tensor before anything runs: neither the
    plain version nor a launch."""
    wrapper, cfg = _uncompiled()[index]
    assert (cfg.t, cfg.field.nlimbs) not in _build.INSTANTIATIONS["sponge_poseidon2" if wrapper is
                                                                    p2_ops.permute_p2 else "sponge_poseidon_opt"]
    cuda_state = types.SimpleNamespace(device=torch.device("cuda", 0), shape=(cfg.t, cfg.field.nlimbs, 8))

    def refuse(*args):
        raise AssertionError("ran on an uncompiled pair")

    monkeypatch.setattr(_build, "check_state", lambda *args: None)
    monkeypatch.setattr(_build, "launch", refuse)
    for module in (poseidon_opt, poseidon_dense, p2_ops):
        for name in ("permute_opt_plain", "permute_dense_plain", "permute_p2_plain"):
            if hasattr(module, name):
                monkeypatch.setattr(module, name, refuse)
    before = wrapper.launches
    with pytest.raises(NotImplementedError, match="no CUDA kernel instantiation"):
        wrapper(cfg, torch.zeros(1, dtype=torch.int32), cuda_state)
    assert wrapper.launches == before


@pytest.mark.parametrize("source,symbol", [("poseidon_opt.cu", "sponge_poseidon_opt"),
                                           ("poseidon_dense.cu", "sponge_poseidon_dense"),
                                           ("poseidon2.cu", "limb"),
                                           ("rescue.cu", "sponge_rescue"),
                                           ("griffin.cu", "sponge_griffin"),
                                           ("anemoi.cu", "sponge_anemoi"),
                                           ("gmimc.cu", "gmimc-limb"),
                                           ("gmimc.cu", "gmimc-word"),
                                           ("poseidon_dense_words.cu", "dense-one-word"),
                                           ("poseidon_dense_words.cu", "dense-two-word")])
def test_c_entry_points_dispatch_the_listed_pairs(source, symbol):
    """Each C entry point's ``PAIR(t, L)`` lines are the pairs ``_build``
    lists (kernel 2: its limb body's, ``ops/poseidon_dense.py`` ``BODIES``,
    and its word bodies' ``WORD(t)`` lines at L = 2 and ``GL(t)`` lines at
    L = 3; kernel 3: its limb body's, ``BODIES``; kernel 8: its limb body's
    ``PAIR`` lines and its two-word body's ``WORD(t)`` lines at L = 3,
    ``ops/gmimc.py`` ``BODIES``), so no listed pair returns -1 on the card
    and none is compiled unlisted."""
    text = (CSRC / source).read_text()
    if symbol in ("gmimc-word", "dense-one-word"):
        L = 2 if symbol == "dense-one-word" else 3
        pairs = [(int(t), L) for t in re.findall(r"^\s*WORD\((\d+)\)$", text, re.M)]
    elif symbol == "dense-two-word":
        pairs = [(int(t), 3) for t in re.findall(r"^\s*GL\((\d+)\)$", text, re.M)]
    else:
        pairs = [(int(t), int(L)) for t, L in re.findall(r"^\s*PAIR\((\d+), (\d+)\)$", text, re.M)]
    assert len(pairs) == len(set(pairs))
    want = {"limb": BODIES["limb"], "gmimc-limb": gmimc_ops.BODIES["limb"],
            "gmimc-word": gmimc_ops.BODIES["word"], "sponge_poseidon_dense": poseidon_dense.BODIES["limb"],
            "dense-one-word": poseidon_dense.BODIES["one-word"],
            "dense-two-word": poseidon_dense.BODIES["two-word"]}.get(symbol) or _build.INSTANTIATIONS[symbol]
    assert set(pairs) == want
    if symbol == "limb":
        caps = tuple(int(v) for v in re.findall(r"constexpr int kMax(?:Sbox)?Folds = (\d+);", text))
        assert caps == P2_FOLD_CAPS


# ---- the plain versions against the JAX package at the new widths ----

SMALL_FIELDS = {
    "goldilocks-t8": ("GOLDILOCKS_FR", 4),
    "goldilocks-t12": ("GOLDILOCKS_FR", 8),
    "babybear-t16": ("BABYBEAR_FR", 8),
    "koalabear-t16": ("KOALABEAR_FR", 8),
    "mersenne31-t16": ("MERSENNE31_FR", 8),
}


@pytest.mark.parametrize("name", list(SMALL_FIELDS))
def test_plain_matches_permute_jit_at_the_small_fields(name):
    field, rate = SMALL_FIELDS[name]
    cfg = st.get_default_poseidon_parameters(getattr(st, field), rate)
    jcfg = sponge_tpu.get_default_poseidon_parameters(getattr(sponge_tpu, field), rate)
    assert jax_config(cfg) == jcfg
    jfs = jcfg.field
    vals = lanes(jfs.modulus, jcfg.t, 64, 31)
    out = permute_jit(jcfg)(jnp.asarray(np.stack([jfs.ints_to_mont_plane(r) for r in vals])))
    assert both_plains(cfg, vals) == [jfs.mont_plane_to_ints(row) for row in np.asarray(out)]


# one config per (t, L) of the ~255-bit fields beyond rate 2, the three fields in turn
WIDE = {f"{field.lower()}-t{rate + 1}": (field, rate) for field, rate in zip(
    ("BLS12_381_FR", "BN254_FR", "BLS12_377_FR", "BLS12_381_FR", "BN254_FR", "BLS12_377_FR"), range(3, 9))}


@pytest.mark.parametrize("name", list(WIDE))
def test_plain_matches_jax_oracle_cut_in_rounds(name):
    """The ~255-bit widths t = 4..9 cut to R_F = 4, R_P = 6 (every stage of
    both kernels), on 24 lanes, both tables' alphas."""
    field, rate = WIDE[name]
    for weights in (False, True):
        cfg = cut_rounds(st.get_default_poseidon_parameters(getattr(st, field), rate, weights))
        vals = lanes(cfg.field.modulus, cfg.t, 24, 37 + rate)
        assert both_plains(cfg, vals) == jax_oracle_lanes(jax_config(cfg), vals)


FULL = {f"{fs}-t{r + c}": (fs, r) for fs, r, c in (
    ("BLS12_381_FR", 3, 1), ("BN254_FR", 4, 1), ("BLS12_377_FR", 5, 1), ("BLS12_381_FR", 6, 1),
    ("BN254_FR", 7, 1), ("BLS12_381_FR", 8, 1), ("GOLDILOCKS_FR", 4, 4), ("GOLDILOCKS_FR", 8, 4),
    ("KOALABEAR_FR", 8, 8))}


@pytest.mark.parametrize("name", list(FULL))
def test_plain_matches_jax_oracle_at_full_rounds(name):
    """One default config per new (t, L) at full rounds, on 16 lanes (0, 1,
    p-1, p-2 in every element position), against the JAX package's oracle."""
    field, rate = FULL[name]
    cfg = st.get_default_poseidon_parameters(getattr(st, field), rate)
    vals = lanes(cfg.field.modulus, cfg.t, 16, 41 + rate)
    assert both_plains(cfg, vals) == jax_oracle_lanes(jax_config(cfg), vals)


P2_WIDE = {"bls12_381-t4": ("BLS12_381_FR", 3), "bn254-t8": ("BN254_FR", 7),
           "goldilocks-t8": ("GOLDILOCKS_FR", 4), "goldilocks-t12": ("GOLDILOCKS_FR", 8)}


@pytest.mark.parametrize("name", list(P2_WIDE))
def test_poseidon2_plain_matches_jax_oracle_at_the_new_widths(name):
    """Kernel 3's plain version at its four new (t, L), full rounds, against
    the JAX package's Poseidon2 oracle with the JAX package's own
    parameters."""
    field, rate = P2_WIDE[name]
    cfg = st.get_default_poseidon2_parameters(getattr(st, field), rate)
    jcfg = sponge_tpu.get_default_poseidon2_parameters(getattr(sponge_tpu, field), rate)
    assert interop.config_from_jax(jcfg) == cfg
    vals = lanes(cfg.field.modulus, cfg.t, 16, 43 + rate)
    consts = st.Poseidon2Permutation(cfg, "cpu").consts
    out = permute_p2_plain(cfg, consts, ints_to_mont_tensor(cfg.field, vals, "cpu"))
    assert mont_tensor_to_ints(cfg.field, out) == jax_oracle_lanes(jcfg, vals, JaxOracle2)


@pytest.mark.parametrize("optimized", [False, True], ids=["dense", "sparse-opt"])
def test_plain_matches_cios_kernel_body_at_t4(optimized):
    """The TPU's production kernel body (``pallas_cios._permute_kernel``) run
    as plain jnp at a state wider than the port's first instantiations: t = 4
    over the 35-bit test field (R_F = 4, R_P = 3), 128 lanes.  At a default
    width the body takes 35-54 s to trace and run here (Goldilocks t = 8,
    whatever the round count), over a test's budget."""
    jcfg = tiny_poseidon_config(t=4)
    fs, t, B = jcfg.field, jcfg.t, 128
    L = fs.nlimbs
    vals = lanes(fs.modulus, t, B, 47)
    st4 = np.stack([fs.ints_to_mont_plane(r) for r in vals]).reshape(t, L, 1, B)
    limbs = lambda vs: np.concatenate([fs.int_to_mont_limbs(v) for v in vs])
    ark = np.stack([limbs(row) for row in jcfg.ark]).astype(np.int32)
    if optimized:
        layers = jax_layers(jcfg)
        popt = np.stack([np.concatenate([limbs(c), limbs(sp.row0), limbs(sp.col0)])
                         for c, sp in zip(layers.constants, layers.sparse)]).astype(np.int32)
    else:
        popt = np.zeros((1, 1), dtype=np.int32)

    @jax.jit
    def run(a, o, s):
        out = _FakeRef(jnp.zeros_like(s))
        pc._permute_kernel(_FakeRef(a), _FakeRef(o), _FakeRef(s), out, cfg=jcfg, optimized=optimized)
        return out.arr

    ref = np.asarray(run(ark, popt, st4)).reshape(t, L, B)
    assert both_plains(interop.config_from_jax(jcfg), vals) == [fs.mont_plane_to_ints(row) for row in ref]


# ---- the parameters' generator ----


def _bit_by_bit(seed_args, sizes):
    """The Grain LFSR clocked one bit at a time, as the reference crate
    does: the output of ``get_bits`` for each size in turn."""
    is_inverse, prime_bits, t, rf, rp = seed_args
    bits = [False] * 80
    bits[1], bits[5] = True, is_inverse
    for lo, hi, value in ((6, 17, prime_bits), (18, 29, t), (30, 39, rf), (40, 49, rp)):
        for i in range(hi, lo - 1, -1):
            bits[i], value = bool(value & 1), value >> 1
    bits[50:] = [True] * 30
    window = sum(1 << i for i, b in enumerate(bits) if b)
    taps = (1 << 62) | (1 << 51) | (1 << 38) | (1 << 23) | (1 << 13) | 1

    def clock():
        nonlocal window
        new = (window & taps).bit_count() & 1
        window = (window >> 1) | (new << 79)
        return new

    for _ in range(160):
        clock()
    out = []
    for n in sizes:
        res = []
        while len(res) < n:
            if clock():
                res.append(clock())
            else:
                clock()
        out.append(res)
    return out


@pytest.mark.parametrize("seed_args", [(False, 255, 9, 8, 57), (False, 64, 12, 8, 22), (True, 31, 16, 8, 13)],
                         ids=["bls12_381-t9", "goldilocks-t12", "inverse-31"])
def test_chunked_grain_lfsr_matches_bit_by_bit(seed_args):
    """``PoseidonGrainLFSR`` clocks 18 bits at a time and filters arrays of
    pairs; its output bits equal the register clocked bit by bit over draws
    of 0 to 300 bits."""
    sizes = [int(n) for n in np.random.default_rng(3).choice([0, 1, 2, 7, 31, 64, 255, 300], 120)]
    lfsr = PoseidonGrainLFSR(*seed_args)
    assert [lfsr.get_bits(n) for n in sizes] == _bit_by_bit(seed_args, sizes)
