"""The port's batched sponge against the oracle and the JAX package's sponge.

Golden vector; lazy == eager; random absorb/squeeze schedules against one
oracle sponge per lane; fork/clone independence (a torch plane written in
place would leak between clones, which share planes); byte, bit and
non-native squeezes with 24-bit limbs; and the port against
``sponge_tpu.PoseidonSponge`` on the tiny field.  Exact equality.
"""

import numpy as np
import pytest
from conftest import TINY_FR, tiny_poseidon_config

import sponge_tpu
import sponge_tpu_torch as st
from sponge_tpu_torch import interop
from sponge_tpu_torch.fields import ints_to_mont_tensor
from sponge_tpu_torch.poseidon.oracle import OraclePoseidonSponge
from sponge_tpu_torch.sponge import decode_canonical_plane

FR = st.BLS12_381_FR
CFG = st.get_default_poseidon_parameters(FR, 2)
GOLDEN_SQUEEZE = [
    40442793463571304028337753002242186710310163897048962278675457993207843616876,
    2664374461699898000291153145224099287711224021716202960480903840045233645301,
    50191078828066923662070228256530692951801504043422844038937334196346054068797,
]


@pytest.mark.parametrize("lazy", [True, False], ids=["lazy", "eager"])
def test_golden_vector(lazy):
    s = st.PoseidonSponge(CFG, batch_size=4, lazy=lazy, device="cpu")
    s.absorb([st.Fp(0, FR), st.Fp(1, FR), st.Fp(2, FR)])
    assert s.squeeze_native_field_elements(3) == [GOLDEN_SQUEEZE] * 4


def run_schedule(seed, cfg, sponges, oracles, steps):
    """Drive every sponge (and one oracle per lane) through one random
    schedule; every squeeze must agree everywhere."""
    rng = np.random.default_rng(seed)
    fs = cfg.field
    B = len(oracles)
    for _ in range(steps):
        kind = rng.choice(["absorb", "absorb", "squeeze", "bytes", "bits"])
        n = int(rng.integers(1, 6))
        if kind == "absorb":
            lanes = [
                [st.Fp(int(rng.integers(0, 2**62)) % fs.modulus, fs) for _ in range(n)]
                for _ in range(B)
            ]
            for s in sponges:
                s.absorb(st.Batched(lanes))
            for o, lane in zip(oracles, lanes):
                o.absorb(lane)
            continue
        if kind == "squeeze":
            want = [o.squeeze_native_field_elements(n) for o in oracles]
            got = [s.squeeze_native_field_elements(n) for s in sponges]
        elif kind == "bytes":
            want = [o.squeeze_bytes(n + 30) for o in oracles]
            got = [s.squeeze_bytes(n + 30) for s in sponges]
        else:
            want = [o.squeeze_bits(n * 40) for o in oracles]
            got = [s.squeeze_bits(n * 40) for s in sponges]
        assert all(g == want for g in got), kind
        for s in sponges:
            assert (s.mode, s.index) == (oracles[0].mode, oracles[0].index)


@pytest.mark.parametrize("seed", [0, 1])
def test_lazy_and_eager_match_oracle_tiny(seed):
    cfg = interop.config_from_jax(tiny_poseidon_config())
    B = 3
    sponges = [st.PoseidonSponge(cfg, B, lazy=lazy, device="cpu") for lazy in (True, False)]
    run_schedule(seed, cfg, sponges, [OraclePoseidonSponge(cfg) for _ in range(B)], 14)


def test_random_schedule_matches_oracle_bls():
    B = 4
    s = st.PoseidonSponge(CFG, B, device="cpu")
    run_schedule(7, CFG, [s], [OraclePoseidonSponge(CFG) for _ in range(B)], 6)


@pytest.mark.parametrize("lazy", [True, False], ids=["lazy", "eager"])
def test_live_mode_index_and_empty_squeeze(lazy):
    cfg = interop.config_from_jax(tiny_poseidon_config())
    s = st.PoseidonSponge(cfg, 2, lazy=lazy, device="cpu")
    o = OraclePoseidonSponge(cfg)
    for n in (1, 2, 3):
        vals = [st.Fp(v, cfg.field) for v in range(n)]
        s.absorb(vals)
        o.absorb(vals)
        assert bool(s._pending) == lazy and (s.mode, s.index) == (o.mode, o.index)
    # A squeeze of nothing still permutes and flips the mode, as in the oracle.
    assert s.squeeze_native_field_elements(0) == [[], []] and o.squeeze_native_field_elements(0) == []
    assert (s.mode, s.index) == (o.mode, o.index) == (st.SQUEEZING, 0)
    s.absorb([st.Fp(4, cfg.field)])
    o.absorb([st.Fp(4, cfg.field)])
    state = s.into_state()
    assert state.state == [[v, v] for v in o.state]
    r = st.PoseidonSponge.from_state(state, cfg, device="cpu")
    assert r.squeeze_native_field_elements(3) == [o.squeeze_native_field_elements(3)] * 2


def test_compiled_transcript_matches_oracle():
    """A fixed schedule, including a squeeze of exactly the rate after a
    partial squeeze (the reference's skipped permute), against the oracle."""
    cfg = interop.config_from_jax(tiny_poseidon_config())
    fs = cfg.field
    steps = [
        st.TranscriptAbsorb(3), st.TranscriptSqueeze(1), st.TranscriptSqueeze(2),
        st.TranscriptAbsorb(1), st.TranscriptSqueeze(3), st.TranscriptAbsorb(0),
    ]
    rng = np.random.default_rng(4)
    vals = [[int(rng.integers(0, fs.modulus)) for _ in range(2)] for _ in range(4)]
    run = st.compile_transcript(cfg, steps)
    out = run(ints_to_mont_tensor(fs, vals, "cpu"))
    assert out.shape == (6, fs.nlimbs, 2)
    got = decode_canonical_plane(fs, out)
    for b in range(2):
        o = OraclePoseidonSponge(cfg)
        o.absorb_field_elements([vals[i][b] for i in range(3)])
        want = o.squeeze_native_field_elements(1) + o.squeeze_native_field_elements(2)
        o.absorb_field_elements([vals[3][b]])
        assert got[b] == want + o.squeeze_native_field_elements(3)
    with pytest.raises(ValueError, match="element rows"):
        run(ints_to_mont_tensor(fs, vals[:3], "cpu"))


@pytest.mark.parametrize("lazy", [True, False], ids=["lazy", "eager"])
def test_fork_and_clone_are_independent(lazy):
    """Regression for shared planes: writing into a fork or a clone must not
    change the parent (the JAX package shares planes between clones)."""
    cfg = interop.config_from_jax(tiny_poseidon_config())
    fs = cfg.field
    s = st.PoseidonSponge(cfg, 2, lazy=lazy, device="cpu")
    o = OraclePoseidonSponge(cfg)
    s.absorb([st.Fp(5, fs)])
    o.absorb([st.Fp(5, fs)])
    parent_plane = s.plane
    f, of = s.fork(b"domain"), o.fork(b"domain")
    c, oc = s.clone(), o.clone()
    for sp, orc in ((f, of), (c, oc)):
        sp.absorb([st.Fp(9, fs)])
        orc.absorb([st.Fp(9, fs)])
    assert c.squeeze_native_field_elements(1) == [oc.squeeze_native_field_elements(1)] * 2
    assert f.squeeze_native_field_elements(3) == [of.squeeze_native_field_elements(3)] * 2
    assert s.plane is parent_plane
    assert s.squeeze_native_field_elements(2) == [o.squeeze_native_field_elements(2)] * 2


def test_byte_bit_and_nonnative_squeezes_match_oracle():
    """Byte and bit extraction from 24-bit limbs, and the bit-packing
    non-native squeeze, against the oracle over BLS12-381 Fr."""
    s = st.PoseidonSponge(CFG, 2, lazy=False, device="cpu")
    o = OraclePoseidonSponge(CFG)
    payload = [b"transcript bytes", st.U64(7), [st.Fp(11, FR), st.Fp(FR.modulus - 1, FR)]]
    for x in payload:
        s.absorb(x)
        o.absorb(x)
    assert s.squeeze_bytes(70) == [o.squeeze_bytes(70)] * 2
    assert s.squeeze_bits(300) == [o.squeeze_bits(300)] * 2
    sizes = [st.FULL, st.Truncated(100), st.FULL]
    assert s.squeeze_field_elements_with_sizes(st.BN254_FR, sizes) == [
        o.squeeze_field_elements_with_sizes(st.BN254_FR, sizes)
    ] * 2
    assert s.squeeze_field_elements(FR, 2) == [o.squeeze_field_elements(FR, 2)] * 2


def test_matches_jax_sponge_tiny():
    """Same schedule through sponge_tpu.PoseidonSponge (eager, tiny field)."""
    jcfg = tiny_poseidon_config()
    cfg = interop.config_from_jax(jcfg)
    js = sponge_tpu.PoseidonSponge(jcfg, batch_size=2, lazy=False)
    s = st.PoseidonSponge(cfg, 2, device="cpu")
    # Squeezes of one width only: each new width recompiles the JAX eager ops.
    for step in range(3):
        lanes = [[st.Fp(10 * step + b + k, cfg.field) for k in range(step + 1)] for b in range(2)]
        jlanes = [[sponge_tpu.Fp(x.value, TINY_FR) for x in lane] for lane in lanes]
        s.absorb(st.Batched(lanes))
        js.absorb(sponge_tpu.Batched(jlanes))
        assert s.squeeze_native_field_elements(2) == js.squeeze_native_field_elements(2)
    assert s.squeeze_bytes(8) == js.squeeze_bytes(8)
