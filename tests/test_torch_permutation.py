"""The port's permutations against the JAX package's tiers and the oracle.

Both plain versions (``permute_dense_plain``: kernel 2's function;
``permute_opt_plain``: kernel 1's) are held against ``permute_jit``, the
Pallas kernel ``pallas_permute_fn`` in interpret mode and the CIOS kernel
body, on the 35-bit test field where the JAX tiers compile in seconds, and
against the scalar oracle on full-width BLS12-381 Fr lanes including the
values 0, 1, p-1, p-2.  Exact equality throughout.  The CUDA kernels
themselves run only on the card (``chip_smoke.py``); here the dispatch
rules and the static value-bound check are tested.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import TINY_FR, tiny_poseidon_config
from test_torch_gmimc import _M64, Words, emulate

import sponge_tpu
import sponge_tpu_torch as st
from sponge_tpu.ops import pallas_cios as pc
from sponge_tpu.ops.pallas_permute import pallas_permute_fn
from sponge_tpu.poseidon.config import device_constants as jax_device_constants
from sponge_tpu.poseidon.optimized import optimized_partial_layers as jax_layers
from sponge_tpu.poseidon.oracle import OraclePoseidonSponge as JaxOracle
from sponge_tpu.poseidon.permutation import permute_jit
from sponge_tpu_torch import interop
from sponge_tpu_torch.fields import FieldSpec, ints_to_mont_tensor, mont_tensor_to_ints
from sponge_tpu_torch.ops import _build
from sponge_tpu_torch.ops.bounds import check_kernel_bounds
from sponge_tpu_torch.ops.poseidon_dense import permute_dense, permute_dense_plain
from sponge_tpu_torch.ops.poseidon_opt import permute_opt, permute_opt_plain
from sponge_tpu_torch.poseidon.config import PoseidonConfig, constant_layout, kernel_constants
from sponge_tpu_torch.poseidon.oracle import OraclePoseidonSponge

TINY = {
    "alpha5": dict(),
    "alpha17": dict(full_rounds=8, partial_rounds=8, alpha=17, seed=11),
}


def lanes(p, t, B, seed):
    """[t][B] values: random residues, with 0, 1, p-1, p-2 in every element
    position across the first lanes."""
    rng = np.random.default_rng(seed)
    vals = [[int(rng.integers(0, 2**63)) ** 4 % p for _ in range(B)] for _ in range(t)]
    edge = [0, 1, p - 1, p - 2]
    for b in range(16):
        for e in range(t):
            vals[e][b] = edge[(b + e) % 4] if b < 8 else edge[(b // 4 + e) % 4]
    return vals


def both_plains(cfg, vals):
    """(dense plain output, opt plain output) as [t][B] canonical ints."""
    perm = st.PoseidonPermutation(cfg, "cpu")
    state = ints_to_mont_tensor(cfg.field, vals, "cpu")
    dense = permute_dense_plain(cfg, perm.consts, state)
    opt = permute_opt_plain(cfg, perm.consts, state)
    assert dense.dtype == opt.dtype == torch.int32
    assert torch.equal(dense, opt)  # both canonical
    return mont_tensor_to_ints(cfg.field, dense)


def jax_ints(plane):
    return [TINY_FR.mont_plane_to_ints(row) for row in np.asarray(plane)]


@pytest.mark.parametrize("name", list(TINY))
def test_plain_matches_permute_jit(name):
    jcfg = tiny_poseidon_config(**TINY[name])
    vals = lanes(TINY_FR.modulus, jcfg.t, 64, 0)
    jstate = jnp.asarray(np.stack([TINY_FR.ints_to_mont_plane(r) for r in vals]))
    assert both_plains(interop.config_from_jax(jcfg), vals) == jax_ints(permute_jit(jcfg)(jstate))


@pytest.mark.parametrize("name", list(TINY))
def test_plain_matches_pallas_permute_interpret(name):
    jcfg = tiny_poseidon_config(**TINY[name])
    vals = lanes(TINY_FR.modulus, jcfg.t, 128, 1)
    jstate = jnp.asarray(np.stack([TINY_FR.ints_to_mont_plane(r) for r in vals]))
    ref = pallas_permute_fn(jcfg, tile=128, interpret=True)(jstate)
    assert both_plains(interop.config_from_jax(jcfg), vals) == jax_ints(ref)


class _FakeRef:
    """Stand-in for a Pallas ref, so the CIOS kernel body runs as plain jnp
    (as tests/test_pallas_kernels.py runs it)."""

    def __init__(self, arr):
        self.arr = jnp.asarray(arr)

    def __getitem__(self, idx):
        return self.arr[idx]

    def __setitem__(self, idx, value):
        self.arr = self.arr.at[idx].set(value)


@pytest.mark.parametrize("optimized", [False, True], ids=["dense", "sparse-opt"])
def test_plain_matches_cios_kernel_body(optimized):
    jcfg = tiny_poseidon_config()
    fs, L, t, B = TINY_FR, TINY_FR.nlimbs, jcfg.t, 128
    vals = lanes(fs.modulus, t, B, 2)
    st4 = np.stack([fs.ints_to_mont_plane(r) for r in vals]).reshape(t, L, 1, 128)
    ark = np.stack(
        [np.concatenate([fs.int_to_mont_limbs(c) for c in row]) for row in jcfg.ark]
    ).astype(np.int32)
    if optimized:
        layers = jax_layers(jcfg)
        popt = np.stack(
            [
                np.concatenate(
                    [fs.int_to_mont_limbs(v) for v in c]
                    + [fs.int_to_mont_limbs(v) for v in sp.row0]
                    + [fs.int_to_mont_limbs(v) for v in sp.col0]
                )
                for c, sp in zip(layers.constants, layers.sparse)
            ]
        ).astype(np.int32)
    else:
        popt = np.zeros((1, 1), dtype=np.int32)

    @jax.jit
    def run(a, o, s):
        out = _FakeRef(jnp.zeros_like(s))
        pc._permute_kernel(_FakeRef(a), _FakeRef(o), _FakeRef(s), out, cfg=jcfg, optimized=optimized)
        return out.arr

    ref = np.asarray(run(ark, popt, st4)).reshape(t, L, B)
    assert both_plains(interop.config_from_jax(jcfg), vals) == jax_ints(ref)


def test_plain_matches_oracle_bls_adversarial():
    cfg = st.get_default_poseidon_parameters(st.BLS12_381_FR, 2)
    vals = lanes(cfg.field.modulus, cfg.t, 16, 3)
    got = both_plains(cfg, vals)
    jcfg = sponge_tpu.get_default_poseidon_parameters(sponge_tpu.BLS12_381_FR, 2)
    for b in range(16):
        o, j = OraclePoseidonSponge(cfg), JaxOracle(jcfg)
        o.state = j.state = [vals[e][b] for e in range(cfg.t)]
        o.permute()
        j.permute()
        assert o.state == j.state == [got[e][b] for e in range(cfg.t)], b
    # The public entry points: auto (kernel 1's path) and plain.
    state = ints_to_mont_tensor(cfg.field, vals, "cpu")
    assert torch.equal(st.batched_permute(cfg, state), st.permute(cfg, state))


def test_interop_built_permutation_matches():
    """A permutation built from the JAX package's device constants gives the
    same output as one built from the port's own config."""
    jcfg = tiny_poseidon_config(**TINY["alpha17"])
    consts = jax_device_constants(jcfg)
    cfg = interop.config_from_device_constants(
        consts["ark"], consts["mds"], modulus=TINY_FR.modulus, limb_bits=TINY_FR.limb_bits,
        full_rounds=jcfg.full_rounds, partial_rounds=jcfg.partial_rounds,
        alpha=jcfg.alpha, rate=jcfg.rate,
    )
    assert cfg == interop.config_from_jax(jcfg)
    vals = lanes(TINY_FR.modulus, 3, 32, 4)
    jstate = np.stack([TINY_FR.ints_to_mont_plane(r) for r in vals])
    state = interop.plane_from_jax(jstate, cfg.field, TINY_FR.limb_bits, "cpu")
    out = st.batched_permute(cfg, state)
    back = interop.plane_to_jax(out, cfg.field, TINY_FR.limb_bits, TINY_FR.nlimbs)
    assert jax_ints(back) == jax_ints(permute_jit(jcfg)(jnp.asarray(jstate)))


def test_kernel_backends_refuse_cpu_tensors():
    cfg = interop.config_from_jax(tiny_poseidon_config())
    state = st.zero_state(cfg, 8, "cpu")
    for backend in ("opt", "dense"):
        with pytest.raises(ValueError, match="CUDA kernel"):
            st.batched_permute(cfg, state, backend)
    with pytest.raises(ValueError, match="unknown backend"):
        st.batched_permute(cfg, state, "cios")
    perm = st.PoseidonPermutation(cfg, "cpu")
    for wrapper in (permute_dense, permute_opt):
        with pytest.raises(ValueError, match="no kernel for device"):
            wrapper(cfg, perm.consts.to("meta"), state.to("meta"))
        with pytest.raises(TypeError):
            wrapper(cfg, perm.consts, state.long())
        with pytest.raises(ValueError):
            wrapper(cfg, perm.consts, st.zero_state(cfg, 8, "cpu")[:2])
    with pytest.raises(NotImplementedError):
        st.batched_permute(tiny_poseidon_config(), state)  # a JAX config
    with pytest.raises(NotImplementedError):
        _build.check_instantiated("sponge_poseidon_opt", 10, 11)
    for symbol in ("sponge_poseidon_opt", "sponge_poseidon_dense"):
        for t, L in _build.INSTANTIATIONS[symbol]:
            _build.check_instantiated(symbol, t, L)


DEFAULT_FIELDS = (st.BLS12_381_FR, st.BN254_FR, st.BLS12_377_FR, st.GOLDILOCKS_FR, st.BABYBEAR_FR,
                  st.KOALABEAR_FR, st.MERSENNE31_FR)


def default_poseidon_configs():
    """{label: config}: every default Poseidon parameter set, both tables
    (constraints, weights) over the seven fields at the rates each has."""
    out = {}
    for fs in DEFAULT_FIELDS:
        for rate in range(1, 9):
            for weights in (False, True):
                try:
                    out[f"{fs.name}-r{rate}-{'weights' if weights else 'constraints'}"] = (
                        st.get_default_poseidon_parameters(fs, rate, weights))
                except ValueError:
                    pass
    return out


def _kernel_configs():
    out = default_poseidon_configs()
    out["fixture"] = st.poseidon_test_fixture()
    for name, kw in TINY.items():
        out[f"tiny-{name}"] = interop.config_from_jax(tiny_poseidon_config(**kw))
    return out


@pytest.mark.parametrize("optimized", [False, True], ids=["dense", "opt"])
def test_value_bounds_clear_every_instantiated_config(optimized):
    for name, cfg in _kernel_configs().items():
        symbol = "sponge_poseidon_opt" if optimized else "sponge_poseidon_dense"
        assert (cfg.t, cfg.field.nlimbs) in _build.INSTANTIATIONS[symbol], name
        vmax = check_kernel_bounds(cfg, optimized)
        assert vmax <= cfg.field.r, name
    bls = st.get_default_poseidon_parameters(st.BLS12_381_FR, 2)
    if optimized:  # the sparse phase grows elements 1..t-1 by ~2p per round
        assert 40 * bls.field.modulus < check_kernel_bounds(bls, True) < bls.field.r // 4


def test_value_bounds_refuse_overflowing_config():
    """R = 16p with a long sparse phase: the unreduced elements would pass R."""
    fs = FieldSpec(name="headroom16", modulus=(1 << 44) - 21, generator=3)
    rng = np.random.default_rng(0)
    draw = lambda: int(rng.integers(1, fs.modulus))
    rounds = 8 + 40
    cfg = PoseidonConfig(
        field=fs, full_rounds=8, partial_rounds=40, alpha=5,
        ark=tuple(tuple(draw() for _ in range(3)) for _ in range(rounds)),
        mds=tuple(tuple(draw() for _ in range(3)) for _ in range(3)),
        rate=2,
    )
    check_kernel_bounds(cfg, False)
    with pytest.raises(ValueError, match="reach R"):
        check_kernel_bounds(cfg, True)


# ---- word-by-word emulation of csrc/poseidon_opt.cu ----


WIDE_WORDS = 40  # csrc/mont.cuh kWideWords


class Kernel1(Words):
    """``csrc/poseidon_opt.cu`` for one lane: the stage loop (the linear
    layer of the stage before: D after the partial phase, the MDS after a
    full round; then a full round's round constants and ``pow_sqr`` on all
    t elements in lockstep, or the partial phase), each sparse round's
    ``sparse_linear`` (the row0 dot and both col0 products accumulated side
    by side, each REDC step in turn, x_i added into its product's columns
    before the carry), then ``store``.  A state of more than ``WIDE_WORDS``
    words takes the wide schedule: the S-boxes one element at a time, the
    MDS rows one at a time (``mat_apply_rows``) and ``sparse_linear_wide``
    (the row0 dot, then each x_i + col0_i * x0 from the old x0), the same
    products in another order.  ``vmax`` is the largest value any element
    reached."""

    def __init__(self, cfg):
        super().__init__(cfg.field)
        self.cfg, self.vmax = cfg, 0
        self.wide = cfg.t * self.L > WIDE_WORDS
        buf, off, self.c = [int(v) for v in kernel_constants(cfg)], 0, {}
        L = self.L
        for name, shape in constant_layout(cfg):
            n = int(np.prod(shape))
            flat = buf[off : off + n]
            off += n
            if len(shape) == 3:  # (rows, entries, L)
                flat = [[flat[(r * shape[1] + e) * L :][:L] for e in range(shape[1])] for r in range(shape[0])]
            self.c[name] = flat

    def _see(self, xs):
        self.vmax = max(self.vmax, *(sum(w << (24 * k) for k, w in enumerate(v)) for v in xs))
        return xs

    def add(self, xs, consts):
        return self._see([self.add_lazy(v, c) for v, c in zip(xs, consts)])

    def pow_sqr(self, xs):
        """``pow_sqr``: MSB-first over the bits of alpha, every element
        squared by ``sqr``, then multiplied by its input where the bit is
        set."""
        base = list(xs)
        for bit in bin(self.cfg.alpha)[3:]:
            xs = self._see([self.sqr(v) for v in xs])
            if bit == "1":
                xs = self._see([self.mont_mul(v, b) for v, b in zip(xs, base)])
        return xs

    def mat_apply(self, xs, mat):
        return self._see([self.mont_row(xs, row) for row in mat])

    def sparse_linear_wide(self, xs, row, col):
        out = [self.mont_row(xs, row)]
        for e in range(1, self.cfg.t):
            acc = [0] * self.L
            for i in range(self.L):
                acc = self.redc_step([(a + w * col[e - 1][i]) & _M64 for a, w in zip(acc, xs[0])])
            acc = [a + w for a, w in zip(acc, xs[e])]
            self.colmax = max(self.colmax, *acc)
            out.append(self.carry_out(acc))
        return self._see(out)

    def sparse_linear(self, xs, row, col):
        if self.wide:
            return self.sparse_linear_wide(xs, row, col)
        L, t = self.L, self.cfg.t
        acc = [[0] * L for _ in range(t)]
        for i in range(L):
            for j in range(t):
                acc[0] = [(a + w * row[j][i]) & _M64 for a, w in zip(acc[0], xs[j])]
            for e in range(1, t):
                acc[e] = [(a + w * col[e - 1][i]) & _M64 for a, w in zip(acc[e], xs[0])]
            acc = [self.redc_step(a) for a in acc]
        for e in range(1, t):
            acc[e] = [a + w for a, w in zip(acc[e], xs[e])]
        self.colmax = max(self.colmax, *(a for col in acc for a in col))
        return self._see([self.carry_out(a) for a in acc])

    def permute(self, x):
        cfg, c = self.cfg, self.c
        half, F, P = cfg.full_rounds // 2, cfg.full_rounds, cfg.partial_rounds
        for s in range(F + 2):
            if s > 0:
                x = self.mat_apply(x, c["dense"] if s == half + 1 else c["mds"])
            if s > F:
                break
            if s != half:
                x = self.pow_sqr(self.add(x, c["ark"][s if s < half else s + P - 1]))
                continue
            x = self.add(x, c["ark"][half])
            for r in range(P):
                x = self.pow_sqr(x[:1]) + x[1:]
                if r == P - 1:
                    break
                x = self.sparse_linear(self.add(x, c["chat"][r]), c["row0"][r], c["col0"][r])
        return [self.store(v) for v in x]


def cut_rounds(cfg, full_rounds=4, partial_rounds=6):
    """``cfg`` with its own constants, rounds cut to R_F = 4, R_P = 6 by
    default (every stage of kernel 1: two full rounds each side, the first
    partial round, five sparse rounds, D)."""
    return dataclasses.replace(cfg, full_rounds=full_rounds, partial_rounds=partial_rounds,
                               ark=cfg.ark[: full_rounds + partial_rounds])


def _bls_cut():
    return cut_rounds(st.get_default_poseidon_parameters(st.BLS12_381_FR, 2))


KERNEL1 = {
    "tiny-alpha5": lambda: interop.config_from_jax(tiny_poseidon_config(**TINY["alpha5"])),
    "tiny-alpha17": lambda: interop.config_from_jax(tiny_poseidon_config(**TINY["alpha17"])),
    "bls12_381-cut": _bls_cut,
    "bls12_381-r2": lambda: st.get_default_poseidon_parameters(st.BLS12_381_FR, 2),
    "bn254-r2": lambda: st.get_default_poseidon_parameters(st.BN254_FR, 2),
    # the wide schedule at (9, 11); the small fields' widths at full rounds
    "bls12_381-r8-cut": lambda: cut_rounds(st.get_default_poseidon_parameters(st.BLS12_381_FR, 8)),
    "goldilocks-r8": lambda: st.get_default_poseidon_parameters(st.GOLDILOCKS_FR, 8),
    "babybear-r8": lambda: st.get_default_poseidon_parameters(st.BABYBEAR_FR, 8),
}


@pytest.mark.parametrize("name", list(KERNEL1))
def test_kernel_emulation_matches_oracle(name):
    """Kernel 1's word order on random lanes and on lanes of 0, 1, p-1, p-2
    against the oracle; every column below 2^63 and every value below the
    replay's bound (``check_kernel_bounds``), which the lanes come within 4x
    of (the replay takes every value at its worst)."""
    cfg = KERNEL1[name]()
    vals = lanes(cfg.field.modulus, cfg.t, 20, 29)
    kernel = Kernel1(cfg)
    got = emulate(cfg, kernel, vals)
    want = []
    for b in range(len(vals[0])):
        o = OraclePoseidonSponge(cfg)
        o.state = [row[b] for row in vals]
        o.permute()
        want.append(o.state)
    assert got == [list(col) for col in zip(*want)]
    assert kernel.colmax < 1 << 63
    vmax = check_kernel_bounds(cfg, True)
    assert vmax // 4 < kernel.vmax < vmax
