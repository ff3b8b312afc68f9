"""The port's Absorb codec and scalar oracle sponge against ``sponge_tpu``'s.

The port carries its own pure-Python copies (the card's machine has no JAX),
so each value below is built once from each package's types and must encode
to the same field elements and bytes, over a native and a non-native field;
and the two oracle sponges must agree through one schedule of absorbs,
squeezes (native, bytes, bits, non-native sizes) and a fork.  Exact equality.
"""

import types

import pytest

import sponge_tpu
import sponge_tpu.absorb as jabsorb
import sponge_tpu_torch as st
import sponge_tpu_torch.absorb as pabsorb
from sponge_tpu.poseidon.oracle import OraclePoseidonSponge as JaxOracle
from sponge_tpu.poseidon.oracle import Truncated as JaxTruncated
from sponge_tpu_torch.poseidon.oracle import OraclePoseidonSponge, Truncated

JAX = types.SimpleNamespace(
    codec=jabsorb, bls=sponge_tpu.BLS12_381_FR, bn=sponge_tpu.BN254_FR
)
PORT = types.SimpleNamespace(codec=pabsorb, bls=st.BLS12_381_FR, bn=st.BN254_FR)

P = st.BLS12_381_FR.modulus

# Each builder makes one absorbable value from a package's types.
VALUES = {
    "bool": lambda ns: True,
    "u8": lambda ns: ns.codec.U8(255),
    "u32": lambda ns: ns.codec.U32(2**32 - 1),
    "u128": lambda ns: ns.codec.U128(2**128 - 3),
    "i16_negative": lambda ns: ns.codec.I16(-2),
    "i128_min": lambda ns: ns.codec.I128(-(2**127)),
    "isize": lambda ns: ns.codec.Isize(-7),
    "usize": lambda ns: ns.codec.Usize(2**64 - 1),
    "bytes": lambda ns: bytes(range(70)),
    "empty_bytes": lambda ns: b"",
    "u8_list": lambda ns: [ns.codec.U8(v) for v in (1, 2, 250)],
    "fp_native": lambda ns: ns.codec.Fp(P - 1, ns.bls),
    "fp_list": lambda ns: [ns.codec.Fp(v, ns.bls) for v in (0, 1, P - 2)],
    "some": lambda ns: ns.codec.Some(ns.codec.U64(9)),
    "none": lambda ns: ns.codec.NONE,
    "with_length_bytes": lambda ns: ns.codec.WithLength(b"abc"),
    "with_length_list": lambda ns: ns.codec.WithLength([ns.codec.U16(5), ns.codec.I8(-1)]),
    "sw_point": lambda ns: ns.codec.SWPoint(ns.codec.Fp(3, ns.bls), ns.codec.Fp(4, ns.bls)),
    "sw_infinity": lambda ns: ns.codec.SWPoint(
        ns.codec.Fp(0, ns.bls), ns.codec.Fp(0, ns.bls), True
    ),
    "te_point": lambda ns: ns.codec.TEPoint(ns.codec.Fp(5, ns.bls), ns.codec.Fp(P - 6, ns.bls)),
    "nested": lambda ns: [
        ns.codec.Some(b"xy"), ns.codec.NONE, [ns.codec.U64(1), False], ns.codec.Fp(8, ns.bls)
    ],
}


@pytest.mark.parametrize("name", list(VALUES))
def test_codec_matches_jax(name):
    port, ref = VALUES[name](PORT), VALUES[name](JAX)
    assert pabsorb.to_sponge_bytes(port) == jabsorb.to_sponge_bytes(ref)
    for field in ("bls", "bn"):  # native and non-native target field
        fs_port, fs_ref = getattr(PORT, field), getattr(JAX, field)
        try:
            want = jabsorb.to_sponge_field_elements(ref, fs_ref)
        except ValueError:
            with pytest.raises(ValueError):
                pabsorb.to_sponge_field_elements(port, fs_port)
            continue
        assert pabsorb.to_sponge_field_elements(port, fs_port) == want


def test_codec_rejects_what_jax_rejects():
    for ns in (PORT, JAX):
        with pytest.raises(TypeError):
            ns.codec.to_sponge_field_elements(5, ns.bls)  # an untyped int
        with pytest.raises(ValueError):
            ns.codec.U8(256)
        with pytest.raises(ValueError):  # a list of non-native elements
            ns.codec.to_sponge_field_elements([ns.codec.Fp(1, ns.bls)], ns.bn)


def test_oracle_sponge_matches_jax_oracle():
    port = OraclePoseidonSponge(st.get_default_poseidon_parameters(st.BLS12_381_FR, 2))
    ref = JaxOracle(sponge_tpu.get_default_poseidon_parameters(sponge_tpu.BLS12_381_FR, 2))
    for name in ("bytes", "u32", "fp_list", "sw_point", "nested"):
        port.absorb(VALUES[name](PORT))
        ref.absorb(VALUES[name](JAX))
    assert port.squeeze_native_field_elements(3) == ref.squeeze_native_field_elements(3)
    assert port.squeeze_bytes(45) == ref.squeeze_bytes(45)
    assert port.squeeze_bits(130) == ref.squeeze_bits(130)
    port_fork, ref_fork = port.fork(b"domain"), ref.fork(b"domain")
    assert port_fork.squeeze_field_elements_with_sizes(
        PORT.bn, ["full", Truncated(80)]
    ) == ref_fork.squeeze_field_elements_with_sizes(JAX.bn, ["full", JaxTruncated(80)])
    assert (port.state, port.mode, port.index) == (ref.state, ref.mode, ref.index)
