"""sponge_tpu_torch fields, parameters and interop against the JAX package.

Codecs round-trip on every shipped field and the tiny test field; the
port's own Grain-LFSR parameters, sparse factorization and test fixture are
equal to ``sponge_tpu``'s; the interop converter turns the JAX package's
device constants (12- and 13-bit limb plans) into the port's config.  All
comparisons are exact.
"""

import numpy as np
import pytest
import torch
from conftest import TINY_FR, tiny_poseidon_config

import sponge_tpu
import sponge_tpu_torch as st
from sponge_tpu.poseidon.config import device_constants as jax_device_constants
from sponge_tpu.poseidon.optimized import eval_partial_chain_optimized as jax_eval_chain
from sponge_tpu.poseidon.optimized import optimized_partial_layers as jax_layers
from sponge_tpu_torch import interop
from sponge_tpu_torch.fields import FieldSpec, ints_to_mont_tensor, mont_tensor_to_ints
from sponge_tpu_torch.poseidon.config import (
    constant_layout,
    device_constants,
    kernel_constants,
    unpack_constants,
)
from sponge_tpu_torch.poseidon.optimized import (
    eval_partial_chain_optimized,
    optimized_partial_layers,
)

PORT_TINY = FieldSpec(name=TINY_FR.name, modulus=TINY_FR.modulus, generator=TINY_FR.generator)
FIELDS = [
    st.BLS12_381_FR,
    st.BN254_FR,
    st.BLS12_377_FR,
    st.GOLDILOCKS_FR,
    st.BABYBEAR_FR,
    st.MERSENNE31_FR,
    st.KOALABEAR_FR,
    PORT_TINY,
]


def edge_values(fs, rng, n=12):
    p = fs.modulus
    return [0, 1, p - 1, p - 2] + [int(rng.integers(0, 2**63)) ** 4 % p for _ in range(n)]


@pytest.mark.parametrize("fs", FIELDS, ids=lambda f: f.name)
def test_codec_round_trip(fs):
    rng = np.random.default_rng(1)
    vals = edge_values(fs, rng)
    plane = fs.ints_to_mont_plane(vals)
    assert plane.shape == (fs.nlimbs, len(vals)) and plane.dtype == np.int32
    assert plane.min() >= 0 and plane.max() < 1 << 24
    assert fs.mont_plane_to_ints(plane) == vals
    for i, v in enumerate(vals):
        assert fs.limbs_to_int(plane[:, i]) == v * fs.r % fs.modulus
    grid = [vals, vals[::-1]]
    t = ints_to_mont_tensor(fs, grid, "cpu")
    assert t.shape == (2, fs.nlimbs, len(vals)) and t.dtype == torch.int32
    assert mont_tensor_to_ints(fs, t) == grid


def test_limb_plan():
    """24-bit plan: L = ceil((bits + 4) / 24); the 255/254-bit fields share
    the JAX 12-bit plan's R = 2^264."""
    for fs in FIELDS:
        assert fs.nlimbs == -(-(fs.modulus.bit_length() + 4) // 24)
        assert fs.r >= 16 * fs.modulus
    for name in ("bls12_381_fr", "bn254_fr", "bls12_377_fr"):
        assert st.get_field(name).r == sponge_tpu.get_field(name).r == 1 << 264
    assert st.BLS12_381_FR_L13 is st.BLS12_381_FR
    assert st.BLS12_381_FR.nlimbs == 11 and PORT_TINY.nlimbs == 2


@pytest.mark.parametrize("rate", [2, 4])
@pytest.mark.parametrize("name", ["bls12_381_fr", "bn254_fr"])
def test_params_equal_jax(name, rate):
    port = st.get_default_poseidon_parameters(st.get_field(name), rate)
    ref = sponge_tpu.get_default_poseidon_parameters(sponge_tpu.get_field(name), rate)
    assert (port.full_rounds, port.partial_rounds, port.alpha) == (
        ref.full_rounds, ref.partial_rounds, ref.alpha,
    )
    assert (port.rate, port.capacity) == (ref.rate, ref.capacity)
    assert port.ark == ref.ark
    assert port.mds == ref.mds


def test_fixture_equal_jax():
    port, ref = st.poseidon_test_fixture(), sponge_tpu.poseidon_test_fixture()
    assert (port.ark, port.mds, port.alpha, port.partial_rounds) == (
        ref.ark, ref.mds, ref.alpha, ref.partial_rounds,
    )


@pytest.mark.parametrize("which", ["bls_rate2", "tiny"])
def test_optimized_layers_equal_jax(which):
    if which == "tiny":
        ref_cfg = tiny_poseidon_config(full_rounds=8, partial_rounds=8, alpha=17, seed=11)
    else:
        ref_cfg = sponge_tpu.get_default_poseidon_parameters(sponge_tpu.BLS12_381_FR, 2)
    cfg = interop.config_from_jax(ref_cfg)
    ours, ref = optimized_partial_layers(cfg), jax_layers(ref_cfg)
    assert ours.c_first == ref.c_first and ours.constants == ref.constants
    assert ours.dense == ref.dense
    assert [(s.row0, s.col0) for s in ours.sparse] == [(s.row0, s.col0) for s in ref.sparse]
    x = tuple(range(3, 3 + cfg.t))
    assert eval_partial_chain_optimized(cfg, x) == jax_eval_chain(ref_cfg, x)


@pytest.mark.parametrize("plan", ["limb12", "limb13"])
def test_interop_device_constants(plan):
    fs_jax = sponge_tpu.BLS12_381_FR if plan == "limb12" else sponge_tpu.fields.BLS12_381_FR_L13
    ref_cfg = sponge_tpu.get_default_poseidon_parameters(fs_jax, 2)
    consts = jax_device_constants(ref_cfg)
    cfg = interop.config_from_device_constants(
        consts["ark"], consts["mds"],
        modulus=fs_jax.modulus, limb_bits=fs_jax.limb_bits,
        full_rounds=ref_cfg.full_rounds, partial_rounds=ref_cfg.partial_rounds,
        alpha=ref_cfg.alpha, rate=ref_cfg.rate,
    )
    assert cfg == st.get_default_poseidon_parameters(st.BLS12_381_FR, 2)
    # State planes cross in both directions through canonical ints.
    rng = np.random.default_rng(5)
    vals = [edge_values(fs_jax, rng, 4) for _ in range(3)]
    jplane = np.stack([fs_jax.ints_to_mont_plane(row) for row in vals])
    plane = interop.plane_from_jax(jplane, cfg.field, fs_jax.limb_bits, "cpu")
    assert mont_tensor_to_ints(cfg.field, plane) == vals
    back = interop.plane_to_jax(plane, cfg.field, fs_jax.limb_bits, fs_jax.nlimbs)
    assert [fs_jax.mont_plane_to_ints(row) for row in back] == vals


def test_constant_buffer_layout():
    cfg = st.get_default_poseidon_parameters(st.BLS12_381_FR, 2)
    buf = torch.from_numpy(kernel_constants(cfg))
    parts = unpack_constants(cfg, buf)
    assert [n for n, _ in constant_layout(cfg)] == list(parts)
    dc = device_constants(cfg)
    assert np.array_equal(parts["ark"].numpy(), dc["ark"])
    assert np.array_equal(parts["mds"].numpy(), dc["mds"])
    assert cfg.field.limbs_to_int(parts["p"][:, 0].numpy()) == cfg.field.modulus
    layers = optimized_partial_layers(cfg)
    fs = cfg.field
    assert fs.mont_plane_to_ints(parts["dense"][1].numpy()[..., 0].T) == list(layers.dense[1])
    with pytest.raises(ValueError):
        unpack_constants(cfg, buf[:-1])
