"""The port's R1CS tracer (``sponge_tpu_torch/tracer``) against the JAX
package's tracer and both packages' native sponges.

Every case of the JAX package's tracer tests runs through both tracers on
the same values: the constraint systems must be identical (the same witness
values in the same order, the same ``(a, b, c)`` linear combinations in the
same order, term for term), the squeezed or encoded values must be equal
and equal to the native sponge or codec of each package, and each system
must be satisfied.  Covered: squeezes of native elements, bits, bytes and
non-native elements; the permutation's 275 constraints at BLS12-381 rate 2;
the non-native limb geometry; the gadget codec in both wire formats and its
option; fork; the macros; and a tampered witness.  Values come from numpy
seeds; comparisons are exact.
"""

from types import SimpleNamespace

import numpy as np
import pytest

import sponge_tpu
import sponge_tpu.absorb
import sponge_tpu.tracer
import sponge_tpu_torch
import sponge_tpu_torch.absorb
import sponge_tpu_torch.tracer


def namespace(pkg, absorb, tracer):
    fr = pkg.BLS12_381_FR
    if pkg is sponge_tpu:
        cfg = pkg.get_default_poseidon_parameters(fr, 2, False)
    else:
        cfg = pkg.get_default_poseidon_parameters(fr, 2)
    return SimpleNamespace(FR=fr, BN=pkg.BN254_FR, CFG=cfg, T=tracer, A=absorb, Oracle=pkg.OraclePoseidonSponge)


PACKAGES = {
    "jax": namespace(sponge_tpu, sponge_tpu.absorb, sponge_tpu.tracer),
    "port": namespace(sponge_tpu_torch, sponge_tpu_torch.absorb, sponge_tpu_torch.tracer),
}


def rand_fr(rng, fs, n):
    return [int(rng.integers(0, 2 ** 63)) ** 4 % fs.modulus for _ in range(n)]


def absorbed(ns, vals):
    cs = ns.T.ConstraintSystem(ns.FR)
    sponge = ns.T.PoseidonSpongeVar(cs, ns.CFG)
    sponge.absorb([ns.T.FpVar.new_witness(cs, v) for v in vals])
    native = ns.Oracle(ns.CFG)
    native.absorb_field_elements(vals)
    return cs, sponge, native


# Each case drives one package (``ns``) on values from ``rng`` and returns
# (its constraint systems, its outputs); it checks the package against its
# own native sponge or codec as it goes.


def case_squeeze_native(ns, rng):
    cs, sponge, native = absorbed(ns, rand_fr(rng, ns.FR, 3))
    got = [e.value for e in sponge.squeeze_field_elements(3)]
    assert got == native.squeeze_native_field_elements(3)
    return [cs], got


def case_squeeze_bits(ns, rng):
    cs, sponge, native = absorbed(ns, rand_fr(rng, ns.FR, 2))
    got = [b.value for b in sponge.squeeze_bits(300)]
    assert got == native.squeeze_bits(300)
    return [cs], got


def case_squeeze_bytes(ns, rng):
    cs, sponge, native = absorbed(ns, rand_fr(rng, ns.FR, 2))
    got = bytes(b.value for b in sponge.squeeze_bytes(50))
    assert got == native.squeeze_bytes(50)
    return [cs], got


def case_squeeze_nonnative(ns, rng):
    cs, sponge, native = absorbed(ns, rand_fr(rng, ns.FR, 2))
    gadgets, bit_vecs = sponge.squeeze_nonnative_field_elements(ns.BN, 2)
    params = ns.T.get_params(ns.BN.modulus_bit_size, ns.FR.modulus_bit_size)
    got = [ns.T.nonnative_limbs_value(limbs, params.bits_per_limb, ns.BN) for limbs in gadgets]
    assert got == native.squeeze_field_elements(ns.BN, 2)
    assert all(len(bv) == ns.BN.modulus_bit_size - 1 for bv in bit_vecs)
    return [cs], got


def case_permutation_count(ns, rng):
    """x^17 costs 5 products: a permutation is 5 * (R_F * t + R_P) = 275."""
    cs = ns.T.ConstraintSystem(ns.FR)
    sponge = ns.T.PoseidonSpongeVar(cs, ns.CFG)
    sponge.state = [ns.T.FpVar.new_witness(cs, v) for v in rand_fr(rng, ns.FR, ns.CFG.t)]
    base = cs.num_constraints
    sponge.permute()
    assert cs.num_constraints - base == 5 * (ns.CFG.full_rounds * ns.CFG.t + ns.CFG.partial_rounds) == 275
    return [cs], [e.value for e in sponge.state]


def case_limb_geometry(ns, rng):
    """ark-r1cs-std's get_params geometry, limbs in range, and num_limbs
    witnesses plus num_limbs constraints per element."""
    params = ns.T.get_params(ns.BN.modulus_bit_size, ns.FR.modulus_bit_size, "constraints")
    assert (params.num_limbs, params.bits_per_limb) == (17, 15)
    wparams = ns.T.get_params(ns.BN.modulus_bit_size, ns.FR.modulus_bit_size, "weight")
    assert (wparams.num_limbs, wparams.bits_per_limb) == (6, 43)
    cs, sponge, _ = absorbed(ns, rand_fr(rng, ns.FR, 1))
    per = ns.BN.modulus_bit_size - 1
    bits = sponge.squeeze_bits(2 * per)
    base_w, base_c = cs.num_witness_variables, cs.num_constraints
    gadgets = ns.T.bits_le_to_nonnative(cs, [bits[:per], bits[per:]], ns.BN)
    assert cs.num_witness_variables - base_w == cs.num_constraints - base_c == 2 * params.num_limbs
    assert all(len(limbs) == params.num_limbs for limbs in gadgets)
    assert all(limb.value < (1 << params.bits_per_limb) for limbs in gadgets for limb in limbs)
    return [cs], [[limb.value for limb in limbs] for limbs in gadgets]


def case_gadget_field_encoding(ns, rng):
    T, A, FR = ns.T, ns.A, ns.FR
    cs = T.ConstraintSystem(FR)
    data = bytes(range(40))
    got = [e.value for e in T.to_sponge_field_elements_gadget([T.UInt8.constant(b, FR) for b in data], cs, FR)]
    assert got == A.to_sponge_field_elements(data, FR)
    assert T.to_sponge_field_elements_gadget(T.Boolean.constant(True, FR), cs, FR)[0].value == 1
    x = rand_fr(rng, FR, 1)[0]
    assert T.to_sponge_field_elements_gadget(T.FpVar.constant(x, FR), cs, FR)[0].value == x
    return [cs], got


def case_gadget_byte_encoding(ns, rng):
    T, A, FR = ns.T, ns.A, ns.FR
    cs = T.ConstraintSystem(FR)
    data = bytes([0, 1, 2, 3, 4, 5])
    got = [bytes(b.value for b in T.to_sponge_bytes_gadget([T.UInt8.constant(b, FR) for b in data], cs, FR))]
    assert got[0] == A.to_sponge_bytes(data)
    vals = rand_fr(rng, FR, 10)
    got.append(bytes(b.value for b in T.to_sponge_bytes_gadget([T.FpVar.new_witness(cs, v) for v in vals], cs, FR)))
    assert got[1] == A.to_sponge_bytes([A.Fp(v, FR) for v in vals])
    assert [b.value for b in T.to_sponge_bytes_gadget(T.Boolean.constant(True, FR), cs, FR)] == [1]
    return [cs], got


def case_gadget_option(ns, rng):
    T, A, FR = ns.T, ns.A, ns.FR
    x = rand_fr(rng, FR, 1)[0]
    cs = T.ConstraintSystem(FR)
    some, none = T.OptionVar(T.FpVar.new_witness(cs, x)), T.OptionVar(None)
    got = []
    for var, native in ((some, A.Some(A.Fp(x, FR))), (none, A.NONE)):
        got.append([e.value for e in T.to_sponge_field_elements_gadget(var, cs, FR)])
        assert got[-1] == A.to_sponge_field_elements(native, FR)
        got.append(bytes(b.value for b in T.to_sponge_bytes_gadget(var, cs, FR)))
        assert got[-1] == A.to_sponge_bytes(native)
    return [cs], got


def case_fork(ns, rng):
    cs, sponge, native = absorbed(ns, rand_fr(rng, ns.FR, 2))
    got = [e.value for e in sponge.fork(b"dom").squeeze_field_elements(2)]
    assert got == native.fork(b"dom").squeeze_native_field_elements(2)
    return [cs], got


def case_macros(ns, rng):
    """Sequential absorbs == one absorb of the collected encoding."""
    T, FR = ns.T, ns.FR
    vals = rand_fr(rng, FR, 3)
    cs = T.ConstraintSystem(FR)
    items = [T.FpVar.new_witness(cs, vals[0]), T.Boolean.constant(True, FR),
             [T.FpVar.new_witness(cs, v) for v in vals[1:]]]
    s1 = T.PoseidonSpongeVar(cs, ns.CFG)
    T.absorb_gadget(s1, *items)
    s2 = T.PoseidonSpongeVar(cs, ns.CFG)
    s2.absorb(T.collect_sponge_field_elements_gadget(cs, FR, *items))
    got = [e.value for e in s1.squeeze_field_elements(2)]
    assert got == [e.value for e in s2.squeeze_field_elements(2)]
    return [cs], got


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}


def system(cs):
    """A constraint system as plain data: witness values, and every
    constraint's three linear combinations as ordered (variable, coeff) terms."""
    lcs = [tuple(tuple(lc.terms.items()) for lc in abc) for abc in cs.constraints]
    return cs.witness, lcs


@pytest.mark.parametrize("case", sorted(CASES))
def test_tracer_matches_jax_tracer(case):
    runs = {name: CASES[case](ns, np.random.default_rng(23)) for name, ns in PACKAGES.items()}
    (jcs, jout), (pcs, pout) = runs["jax"], runs["port"]
    assert pout == jout
    assert len(pcs) == len(jcs)
    for p, j in zip(pcs, jcs):
        assert p.num_witness_variables == j.num_witness_variables
        assert p.num_constraints == j.num_constraints
        assert system(p) == system(j)
        assert p.is_satisfied() and j.is_satisfied()


def test_tampered_witness_fails():
    """A corrupted witness makes both tracers' systems unsatisfied."""
    for ns in PACKAGES.values():
        cs, sponge, _ = absorbed(ns, rand_fr(np.random.default_rng(5), ns.FR, 2))
        sponge.squeeze_field_elements(1)
        assert cs.is_satisfied()
        mid = len(cs.witness) // 2
        cs.witness[mid] = (cs.witness[mid] + 1) % ns.FR.modulus
        assert not cs.is_satisfied()


def test_gadget_of_and_public_names():
    t = sponge_tpu_torch.tracer
    assert t.gadget_of(sponge_tpu_torch.PoseidonSponge) is t.PoseidonSpongeVar
    with pytest.raises(TypeError, match="no gadget"):
        t.gadget_of(sponge_tpu_torch.OraclePoseidonSponge)
    assert t.__all__ == sponge_tpu.tracer.__all__
