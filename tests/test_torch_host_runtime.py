"""The port's native host runtime (``sponge_tpu_torch/poseidon/host.py``,
``csrc/host/poseidon_host.cc``) against the port's oracles and the JAX
package's oracles and ``host_run_schedule``.

Every family's configs come from the JAX package's parameter functions and
cross over through ``interop.config_from_jax``.  Covered: the golden vector
through ``HostPoseidonSponge``; batched permutes at rates 2/4/8 and for all
seven families (GMiMC at Goldilocks and BLS12-381), with 0, 1, p-1 and p-2
in the states; every ``Host*Sponge`` through absorb, squeeze, bytes, fork
and ``SpongeExt``; random schedules with zero-count steps, mode flips and
the remaining == rate squeeze quirk; segmented resume through
``SpongeState``; the element-count check; the C++ source against the JAX
package's; and two processes building one library at once.  Inputs come
from numpy seeds; every comparison is exact on canonical values.
"""

import hashlib
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

import sponge_tpu
from sponge_tpu.anemoi import OracleAnemoiSponge as JaxAnemoi
from sponge_tpu.gmimc import OracleGmimcSponge as JaxGmimc
from sponge_tpu.griffin import OracleGriffinSponge as JaxGriffin
from sponge_tpu.monolith import OracleMonolithSponge as JaxMonolith
from sponge_tpu.poseidon import host as jax_host
from sponge_tpu.poseidon.oracle import OraclePoseidonSponge as JaxPoseidon
from sponge_tpu.poseidon2 import OraclePoseidon2Sponge as JaxPoseidon2
from sponge_tpu.rescue import OracleRescueSponge as JaxRescue
import sponge_tpu_torch as st
from sponge_tpu_torch import interop
from sponge_tpu_torch.poseidon import host
from sponge_tpu_torch.poseidon.oracle import ABSORBING, OraclePoseidonSponge, SpongeState
from sponge_tpu_torch.utils import native

REPO = pathlib.Path(__file__).resolve().parents[1]
J = sponge_tpu

# (name, JAX config factory, port oracle class, port host class, JAX oracle class)
FAMILIES = {
    "poseidon-bls-r2": (lambda: J.get_default_poseidon_parameters(J.BLS12_381_FR, 2, False),
                        st.OraclePoseidonSponge, st.HostPoseidonSponge, JaxPoseidon),
    "poseidon-bn-r4": (lambda: J.get_default_poseidon_parameters(J.BN254_FR, 4, False),
                       st.OraclePoseidonSponge, st.HostPoseidonSponge, JaxPoseidon),
    "poseidon2-bls-r2": (lambda: J.get_default_poseidon2_parameters(J.BLS12_381_FR, 2),
                         st.OraclePoseidon2Sponge, st.HostPoseidon2Sponge, JaxPoseidon2),
    "poseidon2-koalabear-r8": (lambda: J.get_default_poseidon2_parameters(J.KOALABEAR_FR, 8),
                               st.OraclePoseidon2Sponge, st.HostPoseidon2Sponge, JaxPoseidon2),
    "rescue-m31-r8": (lambda: J.get_default_rescue_parameters(J.MERSENNE31_FR, 8),
                      st.OracleRescueSponge, st.HostRescueSponge, JaxRescue),
    "rescue-bls-r2": (lambda: J.get_default_rescue_parameters(J.BLS12_381_FR, 2),
                      st.OracleRescueSponge, st.HostRescueSponge, JaxRescue),
    "griffin-bls-r2": (lambda: J.get_default_griffin_parameters(J.BLS12_381_FR, 2),
                       st.OracleGriffinSponge, st.HostGriffinSponge, JaxGriffin),
    "griffin-goldilocks-r4": (lambda: J.get_default_griffin_parameters(J.GOLDILOCKS_FR, 4),
                              st.OracleGriffinSponge, st.HostGriffinSponge, JaxGriffin),
    "anemoi-bls-r1": (lambda: J.get_default_anemoi_parameters(J.BLS12_381_FR, 1),
                      st.OracleAnemoiSponge, st.HostAnemoiSponge, JaxAnemoi),
    "anemoi-bls-r3": (lambda: J.get_default_anemoi_parameters(J.BLS12_381_FR, 3),
                      st.OracleAnemoiSponge, st.HostAnemoiSponge, JaxAnemoi),
    "anemoi-goldilocks-r4": (lambda: J.get_default_anemoi_parameters(J.GOLDILOCKS_FR, 4),
                             st.OracleAnemoiSponge, st.HostAnemoiSponge, JaxAnemoi),
    "gmimc-goldilocks-r4": (lambda: J.get_default_gmimc_parameters(J.GOLDILOCKS_FR, 4),
                            st.OracleGmimcSponge, st.HostGmimcSponge, JaxGmimc),
    "gmimc-bls-r2": (lambda: J.get_default_gmimc_parameters(J.BLS12_381_FR, 2),
                     st.OracleGmimcSponge, st.HostGmimcSponge, JaxGmimc),
    "monolith-goldilocks": (lambda: J.get_default_monolith_parameters(J.GOLDILOCKS_FR),
                            st.OracleMonolithSponge, st.HostMonolithSponge, JaxMonolith),
    "monolith-m31": (lambda: J.get_default_monolith_parameters(J.MERSENNE31_FR),
                     st.OracleMonolithSponge, st.HostMonolithSponge, JaxMonolith),
    "monolith-koalabear": (lambda: J.get_default_monolith_parameters(J.KOALABEAR_FR),
                           st.OracleMonolithSponge, st.HostMonolithSponge, JaxMonolith),
    "monolith-babybear": (lambda: J.get_default_monolith_parameters(J.BABYBEAR_FR),
                          st.OracleMonolithSponge, st.HostMonolithSponge, JaxMonolith),
}
FR = st.BLS12_381_FR
GOLDEN = [
    40442793463571304028337753002242186710310163897048962278675457993207843616876,
    2664374461699898000291153145224099287711224021716202960480903840045233645301,
    50191078828066923662070228256530692951801504043422844038937334196346054068797,
]


@pytest.fixture(scope="module", autouse=True)
def native_runtimes(tmp_path_factory):
    """Both packages' host libraries.  The JAX package's builds into a
    directory of this module's own, so no other test process shares its
    temporary file name."""
    if native.get_poseidon_lib() is None:
        pytest.skip("no C++ compiler for the native host runtime")
    mp = pytest.MonkeyPatch()
    mp.setenv("SPONGE_TPU_CACHE", str(tmp_path_factory.mktemp("jax_host_cache")))
    try:
        assert jax_host.get_poseidon_lib() is not None
    finally:
        mp.undo()


def configs(name):
    make, oracle, host_cls, jax_oracle = FAMILIES[name]
    jcfg = make()
    return jcfg, interop.config_from_jax(jcfg), oracle, host_cls, jax_oracle


def rand_vals(rng, fs, n):
    return [int(rng.integers(0, 2 ** 63)) ** 4 % fs.modulus for _ in range(n)]


def oracle_states(oracle_cls, cfg, states):
    out = []
    for i in range(0, len(states), cfg.t):
        o = oracle_cls(cfg)
        o.state = list(states[i : i + cfg.t])
        o.permute()
        out.extend(o.state)
    return out


def run_oracle(sponge, steps, elems):
    out, pos = [], 0
    for kind, n in steps:
        if kind == "absorb":
            sponge.absorb_field_elements(elems[pos : pos + n])
            pos += n
        else:
            out.extend(sponge.squeeze_native_field_elements(n))
    return out


def test_golden_vector_host():
    s = st.HostPoseidonSponge(st.get_default_poseidon_parameters(FR, 2))
    assert s._native
    s.absorb([st.Fp(v, FR) for v in (0, 1, 2)])
    assert s.squeeze_native_field_elements(3) == GOLDEN


@pytest.mark.parametrize("rate", [2, 4, 8])
def test_host_permute_batch_vs_oracles(rate):
    jcfg = J.get_default_poseidon_parameters(J.BLS12_381_FR, rate, False)
    cfg = interop.config_from_jax(jcfg)
    assert cfg == st.get_default_poseidon_parameters(FR, rate)
    rng = np.random.default_rng(rate)
    states = rand_vals(rng, FR, 5 * cfg.t)
    states[:4] = [0, 1, FR.modulus - 1, FR.modulus - 2]
    got = host.host_permute_states(cfg, states)
    assert got == oracle_states(OraclePoseidonSponge, cfg, states)
    assert got == oracle_states(JaxPoseidon, jcfg, states)
    assert host.host_permute_states(cfg, states, n_threads=3) == got


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_host_runtime_vs_oracles(name):
    """Batched permute, the host sponge and one native schedule of every
    family against the port's oracle, the JAX oracle and the JAX host runtime."""
    jcfg, cfg, oracle, host_cls, jax_oracle = configs(name)
    fs, t = cfg.field, cfg.t
    assert host.host_available(cfg)
    rng = np.random.default_rng(sum(map(ord, name)))
    states = rand_vals(rng, fs, 3 * t)
    states[:4] = [0, 1, fs.modulus - 1, fs.modulus - 2]
    got = host.host_permute_states(cfg, states)
    assert got == oracle_states(oracle, cfg, states)
    assert got == oracle_states(jax_oracle, jcfg, states)

    h, o, jo = host_cls(cfg), oracle(cfg), jax_oracle(jcfg)
    assert h._native and isinstance(h, oracle)
    vals = rand_vals(rng, fs, 5)
    for s in (h, o, jo):
        s.absorb_field_elements(vals)
    want = o.squeeze_native_field_elements(cfg.rate + 3)
    assert h.squeeze_native_field_elements(cfg.rate + 3) == want
    assert jo.squeeze_native_field_elements(cfg.rate + 3) == want
    assert (h.state, h.mode, h.index) == (o.state, o.mode, o.index)

    steps = [("absorb", 5), ("squeeze", 3), ("absorb", 1), ("squeeze", cfg.rate)]
    elems = vals + [7]
    sq, state = host.host_run_schedule(cfg, steps, elems)
    jsq, jstate = jax_host.host_run_schedule(jcfg, steps, elems)
    o2 = oracle(cfg)
    assert sq == jsq == run_oracle(o2, steps, elems)
    assert state.state == jstate.state == o2.state
    assert (state.mode, state.index) == (jstate.mode, jstate.index) == (o2.mode, o2.index)


@pytest.mark.parametrize("name", ["poseidon-bls-r2", "poseidon2-koalabear-r8", "monolith-goldilocks"])
def test_host_sponge_formatting_fork_and_state(name):
    """The inherited bytes/bits/non-native/fork/clone surfaces and SpongeExt
    run on the native permute."""
    _, cfg, oracle, host_cls, _ = configs(name)
    fs = cfg.field
    rng = np.random.default_rng(9)
    vals = rand_vals(rng, fs, 3)
    h, o = host_cls(cfg), oracle(cfg)
    for s in (h, o):
        s.absorb([st.Fp(v, fs) for v in vals])
    hf, of = h.fork(b"domain"), o.fork(b"domain")
    assert type(hf) is host_cls
    assert hf.squeeze_bytes(77) == of.squeeze_bytes(77)
    assert h.squeeze_bits(300) == o.squeeze_bits(300)
    h2, o2 = h.clone(), o.clone()
    assert h2.squeeze_field_elements(st.BN254_FR, 3) == o2.squeeze_field_elements(st.BN254_FR, 3)
    state = h.into_state()
    restored = host_cls.from_state(state, cfg)
    assert restored._native
    assert restored.squeeze_native_field_elements(4) == oracle.from_state(state, cfg).squeeze_native_field_elements(4)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_host_run_schedule_random(seed):
    """Random schedules (zero-count steps, mode flips, squeezes of exactly
    the rate from index 0 and from mid-rate) against the stepped oracle, the
    JAX host runtime and the port's host sponge, final state included."""
    jcfg = J.get_default_poseidon_parameters(J.BLS12_381_FR, 2, False)
    cfg = interop.config_from_jax(jcfg)
    rng = np.random.default_rng(100 + seed)
    steps, elems = [("absorb", 1), ("squeeze", 1), ("squeeze", cfg.rate)], []
    elems += rand_vals(rng, FR, 1)
    for _ in range(14):
        n = int(rng.integers(0, 8))
        if rng.integers(2):
            steps.append(("absorb", n))
            elems.extend(rand_vals(rng, FR, n))
        else:
            steps.append(("squeeze", n))
    got, got_state = host.host_run_schedule(cfg, steps, elems)
    jgot, jstate = jax_host.host_run_schedule(jcfg, steps, elems)
    o, h = OraclePoseidonSponge(cfg), st.HostPoseidonSponge(cfg)
    assert got == jgot == run_oracle(o, steps, elems) == run_oracle(h, steps, elems)
    assert got_state == SpongeState(state=o.state, mode=o.mode, index=o.index)
    assert (jstate.state, jstate.mode, jstate.index) == (o.state, o.mode, o.index)
    assert (h.state, h.mode, h.index) == (o.state, o.mode, o.index)


def test_host_run_schedule_segmented_resume():
    """A schedule split over two native calls (state passed through), or
    resumed from an oracle's SpongeExt state, equals one call."""
    cfg = st.get_default_poseidon_parameters(FR, 2)
    rng = np.random.default_rng(42)
    steps = [("absorb", 3), ("squeeze", 2), ("absorb", 1), ("squeeze", 4), ("absorb", 5), ("squeeze", 3)]
    elems = rand_vals(rng, FR, 9)
    full, full_state = host.host_run_schedule(cfg, steps, elems)
    a, sa = host.host_run_schedule(cfg, steps[:3], elems[:4])
    b, sb = host.host_run_schedule(cfg, steps[3:], elems[4:], state=sa)
    assert a + b == full and sb == full_state
    o = OraclePoseidonSponge(cfg)
    run_oracle(o, steps[:3], elems[:4])
    assert o.into_state() == sa
    c, sc = host.host_run_schedule(cfg, steps[3:], elems[4:], state=o.into_state())
    assert c == b and sc == full_state
    assert host.host_run_schedule(cfg, [], [])[1] == SpongeState(state=[0] * cfg.t, mode=ABSORBING, index=0)


def test_host_run_schedule_and_permute_validate_input():
    cfg = st.get_default_poseidon_parameters(FR, 2)
    with pytest.raises(ValueError, match="absorbs 2 elements"):
        host.host_run_schedule(cfg, [("absorb", 2)], [1])
    with pytest.raises(ValueError, match="unknown step kind"):
        host.host_run_schedule(cfg, [("permute", 1)], [])
    with pytest.raises(ValueError, match="not a multiple"):
        host.host_permute_states(cfg, [1, 2])


def test_host_source_is_the_jax_packages():
    """The port's poseidon_host.cc is the JAX package's csrc/poseidon_host.cc
    byte for byte, but for the reference crate's location in two comments:
    an absolute path of the machine it was read on, which the port's
    sources do not carry.  Their hashes agree once that path is made
    relative, so the two cannot drift."""
    ours = (REPO / "sponge_tpu_torch/csrc/host/poseidon_host.cc").read_bytes()
    ref = re.sub(rb"/\S*?/reference/", b"reference ", (REPO / "csrc/poseidon_host.cc").read_bytes())
    assert hashlib.sha256(ours).hexdigest() == hashlib.sha256(ref).hexdigest()


def test_concurrent_builds_load_one_whole_library(tmp_path):
    """Two processes build the native codec at once into an empty build
    directory: both load a whole library, and one file is left."""
    code = (
        "import sys, pathlib\n"
        "from sponge_tpu_torch.utils import native\n"
        "native.BUILD_DIR = pathlib.Path(sys.argv[1])\n"
        "import sponge_tpu_torch as st\n"
        "lib = native.get_lib()\n"
        "assert lib is not None\n"
        "fs = st.BLS12_381_FR\n"
        "xs = list(range(1, 33)) + [fs.modulus - 1]\n"
        "assert fs.mont_plane_to_ints(fs.ints_to_mont_plane(xs)) == xs\n"
        "print('loaded', native.library_path(native.CSRC / 'host_codec.cc', 'hostcodec').name)\n"
    )
    build = tmp_path / "build"
    procs = [
        subprocess.Popen([sys.executable, "-c", code, str(build)], cwd=REPO, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
        for _ in range(2)
    ]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert outs[0][0] == outs[1][0] and outs[0][0].startswith("loaded")
    assert [f.name for f in build.iterdir() if not f.name.startswith(".")] == [outs[0][0].split()[1]]
