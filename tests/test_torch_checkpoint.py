"""Checkpoints of the port (``checkpoint.py``) against ``sponge_tpu.checkpoint``.

Sponge files of Poseidon and Poseidon2 cross between the packages in both
directions (the config fingerprints are equal strings); Merkle-level files
cross too, with the JAX package's 12-bit and 13-bit limb plans told apart
by their limb counts; every family of the port round-trips its own files;
a file is refused under another config.  The JAX package's fingerprint
reads ``alpha``, ``full_rounds`` and ``partial_rounds`` of every config and
so raises on the families that lack them: that reference fault is pinned
here, and the port does not share it.

The JAX side runs the conftest's 35-bit configs; the port's configs use a
field of the same name, which the fingerprint records.  Equality is exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
from conftest import TINY_FR, tiny_poseidon2_config, tiny_poseidon_config

import sponge_tpu
import sponge_tpu.checkpoint as jck
import sponge_tpu.hash as jhash
import sponge_tpu_torch as st
from sponge_tpu_torch import checkpoint as ck
from sponge_tpu_torch import hash as h
from sponge_tpu_torch import interop
from sponge_tpu_torch.fields import ints_to_mont_tensor, mont_tensor_to_ints

PORT_TINY = st.FieldSpec(name=TINY_FR.name, modulus=TINY_FR.modulus, generator=TINY_FR.generator)
B = 4


def port_config(jcfg):
    """The port's config of a JAX config, over the port's field of the
    same name."""
    return dataclasses.replace(interop.config_from_jax(jcfg), field=PORT_TINY)


JP = tiny_poseidon_config()
JP2 = tiny_poseidon2_config()


def lanes(seed, n, p=TINY_FR.modulus):
    rng = np.random.default_rng(seed)
    return [[int(rng.integers(0, 2**63)) % p for _ in range(n)] for _ in range(B)]


@pytest.mark.parametrize("jcfg", [JP, JP2], ids=["poseidon", "poseidon2"])
def test_fingerprint_equals_jax(jcfg):
    assert ck._cfg_fingerprint(port_config(jcfg)) == jck._cfg_fingerprint(jcfg)


@pytest.mark.parametrize("rate", [2, 5])
def test_fingerprint_equals_jax_at_bls12_381(rate):
    jcfg = sponge_tpu.get_default_poseidon_parameters(sponge_tpu.BLS12_381_FR, rate)
    cfg = st.get_default_poseidon_parameters(st.BLS12_381_FR, rate)
    assert ck._cfg_fingerprint(cfg) == jck._cfg_fingerprint(jcfg)


@pytest.mark.parametrize("jcfg", [JP, JP2], ids=["poseidon", "poseidon2"])
def test_sponge_files_cross_both_ways(jcfg, tmp_path):
    """A sponge saved mid-transcript by one package loads in the other with
    the same state and bookkeeping, and squeezes what the oracle does."""
    cfg = port_config(jcfg)
    rows = [list(row) for row in zip(*lanes(1, cfg.t))]  # [t][B]
    state = sponge_tpu.SpongeState(state=rows, mode="absorbing", index=1)
    jck.save_sponge(tmp_path / "jax.npz", sponge_tpu.PoseidonSponge.from_state(state, jcfg))
    port = st.PoseidonSponge.from_state(st.SpongeState(state=rows, mode="absorbing", index=1), cfg, device="cpu")
    ck.save_sponge(tmp_path / "port.npz", port)
    from_jax = ck.load_sponge(tmp_path / "jax.npz", cfg, device="cpu")
    from_port = jck.load_sponge(tmp_path / "port.npz", jcfg)
    for s in (from_jax, from_port):
        got = s.into_state()
        assert (got.state, got.mode, got.index) == (rows, "absorbing", 1)
    want = []
    for b in range(B):
        o = jcfg.oracle_sponge()
        o.state, o.mode, o.index = [row[b] for row in rows], "absorbing", 1
        want.append(o.squeeze_native_field_elements(3))
    assert from_port.squeeze_native_field_elements(3) == want
    assert from_jax.squeeze_native_field_elements(3) == want


FAMILIES = {
    "poseidon": lambda: port_config(JP),
    "poseidon2": lambda: port_config(JP2),
    "rescue": lambda: st.get_default_rescue_parameters(st.BABYBEAR_FR, 8),
    "gmimc": lambda: st.get_default_gmimc_parameters(st.GOLDILOCKS_FR, 4),
    "griffin": lambda: st.get_default_griffin_parameters(st.GOLDILOCKS_FR, 4),
    "anemoi": lambda: st.get_default_anemoi_parameters(st.GOLDILOCKS_FR, 4),
    "monolith": lambda: st.get_default_monolith_parameters(st.GOLDILOCKS_FR),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_every_family_round_trips(family, tmp_path):
    """Save mid-transcript (absorbing, then squeezing), load, and get the
    same squeezes; a file is refused under another family's config."""
    cfg = FAMILIES[family]()
    fs = cfg.field
    s = st.PoseidonSponge(cfg, batch_size=B, device="cpu")
    s.absorb(st.Batched([[st.Fp(v, fs) for v in lane] for lane in lanes(3, 5, fs.modulus)]))
    ck.save_sponge(tmp_path / "absorbing.npz", s)
    s.squeeze_native_field_elements(2)
    ck.save_sponge(tmp_path / "squeezing.npz", s)
    resumed = ck.load_sponge(tmp_path / "squeezing.npz", cfg, device="cpu")
    assert (resumed.mode, resumed.index) == (s.mode, s.index) == ("squeezing", 2)
    assert resumed.squeeze_native_field_elements(3) == s.squeeze_native_field_elements(3)
    early = ck.load_sponge(tmp_path / "absorbing.npz", cfg, device="cpu")
    assert early.mode == "absorbing"
    fresh = st.PoseidonSponge(cfg, batch_size=B, device="cpu")
    fresh.absorb(st.Batched([[st.Fp(v, fs) for v in lane] for lane in lanes(3, 5, fs.modulus)]))
    assert early.squeeze_native_field_elements(2) == fresh.squeeze_native_field_elements(2)
    other = FAMILIES["gmimc" if family != "gmimc" else "griffin"]()
    with pytest.raises(ValueError, match="different config"):
        ck.load_sponge(tmp_path / "squeezing.npz", other, device="cpu")


def test_wrong_config_and_wrong_kind_refused(tmp_path):
    cfg = port_config(JP)
    s = st.PoseidonSponge(cfg, batch_size=B, device="cpu")
    s.absorb([st.Fp(1, PORT_TINY)])
    ck.save_sponge(tmp_path / "s.npz", s)
    ark = [list(row) for row in cfg.ark]
    ark[-1][-1] = (ark[-1][-1] + 1) % PORT_TINY.modulus
    tampered = dataclasses.replace(cfg, ark=tuple(tuple(r) for r in ark))
    with pytest.raises(ValueError, match="different config"):
        ck.load_sponge(tmp_path / "s.npz", tampered, device="cpu")
    with pytest.raises(ValueError, match="different config"):
        ck.load_sponge(tmp_path / "s.npz", dataclasses.replace(cfg, field=interop.field_for_modulus(
            PORT_TINY.modulus)), device="cpu")
    with pytest.raises(ValueError, match="not a merkle-level checkpoint"):
        ck.load_merkle_level(tmp_path / "s.npz", cfg, device="cpu")
    ck.save_merkle_level(tmp_path / "m.npz", cfg, ints_to_mont_tensor(PORT_TINY, [1, 2], "cpu"), 3)
    with pytest.raises(ValueError, match="not a sponge checkpoint"):
        ck.load_sponge(tmp_path / "m.npz", cfg, device="cpu")


def test_jax_rescue_fingerprint_fault_is_not_copied(tmp_path):
    """The JAX package's fingerprint reads ``full_rounds``, which a Rescue
    config lacks (a known fault of the reference); the port writes the
    keys a config has, so its Rescue files work."""
    jcfg = sponge_tpu.get_default_rescue_parameters(sponge_tpu.BABYBEAR_FR, 8)
    with pytest.raises(AttributeError):
        jck._cfg_fingerprint(jcfg)
    cfg = interop.config_from_jax(jcfg)
    fingerprint = ck._cfg_fingerprint(cfg)
    assert '"alpha"' in fingerprint and "full_rounds" not in fingerprint
    mono = ck._cfg_fingerprint(st.get_default_monolith_parameters(st.GOLDILOCKS_FR))
    assert "alpha" not in mono and '"kind": "MonolithConfig"' in mono


LEAVES = 32
LEVEL_DEPTH = 2


@pytest.fixture(scope="module")
def jax_levels():
    """The JAX package's tree over the same leaves in its 12-bit and 13-bit
    limb plans: (config, level 2 plane, canonical root) per plan."""
    vals = lanes(7, LEAVES // B)
    flat = [v for lane in vals for v in lane]
    out = {}
    for bits in (12, 13):
        field = dataclasses.replace(TINY_FR, limb_bits=bits)
        jcfg = dataclasses.replace(JP, field=field)
        levels = jhash.merkle_tree(jcfg, jnp.asarray(field.ints_to_mont_plane(flat)))
        root = interop.jax_limbs_to_ints(np.asarray(levels[-1]), field.modulus, bits).tolist()[0]
        out[bits] = (jcfg, np.asarray(levels[LEVEL_DEPTH]), root)
    return flat, out


@pytest.mark.parametrize("bits", [12, 13])
def test_jax_merkle_level_resumes_in_port(bits, jax_levels, tmp_path):
    flat, plans = jax_levels
    jcfg, level, root = plans[bits]
    assert level.shape == (jcfg.field.nlimbs, LEAVES >> LEVEL_DEPTH)
    jck.save_merkle_level(tmp_path / "level.npz", jcfg, level, LEVEL_DEPTH)
    cfg = port_config(JP)
    plane, depth = ck.load_merkle_level(tmp_path / "level.npz", cfg, device="cpu")
    assert depth == LEVEL_DEPTH and plane.shape == (PORT_TINY.nlimbs, LEAVES >> LEVEL_DEPTH)
    resumed = h.merkle_root(cfg, plane)
    assert mont_tensor_to_ints(PORT_TINY, resumed[:, None]) == [root]
    full = h.merkle_root(cfg, ints_to_mont_tensor(PORT_TINY, flat, "cpu"))
    assert mont_tensor_to_ints(PORT_TINY, full[:, None]) == [root]


def test_port_merkle_level_resumes_in_jax(jax_levels, tmp_path):
    """The port writes the JAX package's 12-bit plan."""
    flat, plans = jax_levels
    jcfg, _, root = plans[12]
    cfg = port_config(JP)
    levels = h.merkle_tree(cfg, ints_to_mont_tensor(PORT_TINY, flat, "cpu"))
    ck.save_merkle_level(tmp_path / "level.npz", cfg, levels[LEVEL_DEPTH], LEVEL_DEPTH)
    plane, depth = jck.load_merkle_level(tmp_path / "level.npz", jcfg)
    assert depth == LEVEL_DEPTH and plane.shape == (jcfg.field.nlimbs, LEAVES >> LEVEL_DEPTH)
    resumed = jhash.merkle_root(jcfg, jnp.asarray(plane))
    assert interop.jax_limbs_to_ints(np.asarray(resumed)[:, None], TINY_FR.modulus, 12).tolist() == [root]


def test_bls12_381_limb_plans_by_limb_count(tmp_path):
    """At BLS12-381 the JAX package's 12-bit plan has 22 limbs and its
    13-bit plan 20: the port writes the first and reads both."""
    cfg = st.get_default_poseidon_parameters(st.BLS12_381_FR, 2)
    jcfg = sponge_tpu.get_default_poseidon_parameters(sponge_tpu.BLS12_381_FR, 2)
    j13 = sponge_tpu.get_default_poseidon_parameters(sponge_tpu.BLS12_381_FR_L13, 2)
    rng = np.random.default_rng(9)
    vals = [[int(rng.integers(0, 2**63)) ** 4 % cfg.field.modulus for _ in range(8)] for _ in range(2)]
    level = ints_to_mont_tensor(cfg.field, vals, "cpu")  # a wide (2, L, 8) level
    ck.save_merkle_level(tmp_path / "port.npz", cfg, level, 5)
    plane, depth = jck.load_merkle_level(tmp_path / "port.npz", jcfg)
    assert plane.shape == (2, sponge_tpu.BLS12_381_FR.nlimbs, 8) and depth == 5
    assert interop.jax_limbs_to_ints(plane, cfg.field.modulus, 12).tolist() == vals
    for jfield, jc in ((sponge_tpu.BLS12_381_FR, jcfg), (sponge_tpu.BLS12_381_FR_L13, j13)):
        jplane = np.stack([jfield.ints_to_mont_plane(row) for row in vals])
        jck.save_merkle_level(tmp_path / f"jax{jfield.limb_bits}.npz", jc, jplane, 5)
        got, _ = ck.load_merkle_level(tmp_path / f"jax{jfield.limb_bits}.npz", cfg, device="cpu")
        assert mont_tensor_to_ints(cfg.field, got) == vals
    assert (sponge_tpu.BLS12_381_FR.nlimbs, sponge_tpu.BLS12_381_FR_L13.nlimbs) == (22, 20)
    np.savez(tmp_path / "odd.npz", kind="merkle_level", config=ck._cfg_fingerprint(cfg), depth=1,
             plane=np.zeros((21, 4), np.int32))
    with pytest.raises(ValueError, match="21-limb plane"):
        ck.load_merkle_level(tmp_path / "odd.npz", cfg, device="cpu")
