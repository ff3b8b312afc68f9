"""The host-side tail of the port's public API against the JAX package:
``collect_sponge_bytes`` / ``collect_sponge_field_elements``,
``field_element_size_sum`` / ``field_element_size_num_bits``,
``register_default_table`` and ``PoseidonSponge.absorb_stream``.  Exact
equality."""

import numpy as np
import pytest
from conftest import TINY_FR_45, tiny_poseidon_config

import sponge_tpu
import sponge_tpu.poseidon.params as jparams
import sponge_tpu_torch as st
import sponge_tpu_torch.poseidon.params as tparams
from sponge_tpu_torch import interop
from sponge_tpu_torch.fields import ints_to_mont_tensor


def values(pkg, fs):
    """One value of every codec kind, built from package ``pkg``."""
    return [
        pkg.U8(7), pkg.I64(-3), pkg.Usize(12), b"bytes", [pkg.U8(1), pkg.U8(2)],
        pkg.Fp(fs.modulus - 1, fs), pkg.Some(pkg.U32(9)), pkg.NONE, pkg.WithLength([pkg.U16(5)]),
        [pkg.Fp(3, fs), pkg.Fp(4, fs)],
    ]


@pytest.mark.parametrize("field", ["BLS12_381_FR", "GOLDILOCKS_FR"])
def test_collect_matches_jax(field):
    jfs, tfs = getattr(sponge_tpu, field), getattr(st, field)
    jv, tv = values(sponge_tpu, jfs), values(st, tfs)
    assert st.collect_sponge_bytes(*tv) == sponge_tpu.collect_sponge_bytes(*jv)
    assert st.collect_sponge_field_elements(tfs, *tv) == sponge_tpu.collect_sponge_field_elements(jfs, *jv)
    assert st.collect_sponge_bytes() == b"" and st.collect_sponge_field_elements(tfs) == []


@pytest.mark.parametrize("field", ["BLS12_381_FR", "BN254_FR", "GOLDILOCKS_FR", "BABYBEAR_FR"])
def test_field_element_sizes_match_jax(field):
    jfs, tfs = getattr(sponge_tpu, field), getattr(st, field)
    for sizes in ([], [st.FULL], [st.FULL, st.Truncated(10)], [st.Truncated(tfs.modulus_bit_size)] * 3):
        jsizes = [s if s == st.FULL else sponge_tpu.Truncated(s.num_bits) for s in sizes]
        assert st.field_element_size_sum(sizes, tfs) == sponge_tpu.field_element_size_sum(jsizes, jfs)
    assert st.field_element_size_num_bits(st.Truncated(3), tfs) == sponge_tpu.field_element_size_num_bits(
        sponge_tpu.Truncated(3), jfs
    )
    with pytest.raises(ValueError):
        st.field_element_size_sum([st.Truncated(tfs.modulus_bit_size + 1)], tfs)


def test_register_default_table_matches_jax(monkeypatch):
    """A registered field gets the JAX package's defaults; bad rows are
    refused; the registry is restored after the test."""
    for mod in (jparams, tparams):
        monkeypatch.setattr(mod, "_DEFAULT_TABLES", dict(mod._DEFAULT_TABLES))
        monkeypatch.setattr(mod, "_DEFAULT_CAPACITY", dict(mod._DEFAULT_CAPACITY))
    tfs = st.FieldSpec(name=TINY_FR_45.name, modulus=TINY_FR_45.modulus, generator=TINY_FR_45.generator)
    try:
        with pytest.raises(KeyError):
            st.get_default_poseidon_parameters(tfs, 2)
        table = [(2, 5, 4, 3, 0), (3, 5, 4, 3, 1)]
        sponge_tpu.register_default_table(TINY_FR_45, table, capacity=2)
        st.register_default_table(tfs, table, capacity=2)
        for rate in (2, 3):
            got = st.get_default_poseidon_parameters(tfs, rate)
            want = interop.config_from_jax(sponge_tpu.get_default_poseidon_parameters(TINY_FR_45, rate))
            assert (got.ark, got.mds, got.rate, got.capacity) == (want.ark, want.mds, want.rate, want.capacity)
        # registering again replaces the tables, and the cached configs with them
        st.register_default_table(tfs, [(2, 5, 4, 5, 0)], capacity=1)
        assert st.get_default_poseidon_parameters(tfs, 2).partial_rounds == 5
        with pytest.raises(ValueError):
            st.get_default_poseidon_parameters(tfs, 3)
        with pytest.raises(ValueError):
            st.register_default_table(tfs, [(2, 5, 4)])
        with pytest.raises(ValueError):
            st.register_default_table(tfs, [(2, 5, 4, 3, 0)], optimized_for_weights_table=[(2, 5, 4)])
        with pytest.raises(ValueError):
            st.register_default_table(tfs, table, capacity=0)
    finally:
        st.get_default_poseidon_parameters.cache_clear()


def test_absorb_stream_matches_jax():
    """Chunks of planes (3-D tensors in the port, arrays in the JAX package)
    and codec values stream into the same squeezes as in the JAX package."""
    jcfg = tiny_poseidon_config()
    cfg = interop.config_from_jax(jcfg)
    fs, B = cfg.field, 4
    rng = np.random.default_rng(5)
    grids = [[[int(rng.integers(0, 2**62)) % fs.modulus for _ in range(B)] for _ in range(k)] for k in (3, 1, 4)]
    tchunks = [ints_to_mont_tensor(fs, grids[0], "cpu"), st.U64(9), ints_to_mont_tensor(fs, grids[1], "cpu"),
               [st.Fp(5, fs)], ints_to_mont_tensor(fs, grids[2], "cpu")]
    jchunks = [np.stack([jcfg.field.ints_to_mont_plane(row) for row in grids[0]]), sponge_tpu.U64(9),
               np.stack([jcfg.field.ints_to_mont_plane(row) for row in grids[1]]),
               [sponge_tpu.Fp(5, jcfg.field)], np.stack([jcfg.field.ints_to_mont_plane(row) for row in grids[2]])]
    s = st.PoseidonSponge(cfg, batch_size=B, device="cpu")
    js = sponge_tpu.PoseidonSponge(jcfg, batch_size=B)
    assert s.absorb_stream(iter(tchunks)) == js.absorb_stream(iter(jchunks)) == 5
    assert (s.mode, s.index) == (js.mode, js.index)
    assert s.squeeze_native_field_elements(3) == js.squeeze_native_field_elements(3)
    one_shot = st.PoseidonSponge(cfg, batch_size=B, device="cpu")
    for chunk in tchunks:
        if hasattr(chunk, "dim"):
            one_shot.absorb_element_plane(chunk)
        else:
            one_shot.absorb(chunk)
    assert st.PoseidonSponge(cfg, batch_size=B, device="cpu").absorb_stream([]) == 0
    streamed = st.PoseidonSponge(cfg, batch_size=B, device="cpu")
    streamed.absorb_stream(tchunks)
    assert streamed.squeeze_native_field_elements(2) == one_shot.squeeze_native_field_elements(2)
