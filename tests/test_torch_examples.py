"""The port's examples (``sponge_tpu_torch/examples``) run with ``--device
cpu`` in subprocesses, checked against the JAX package's oracle sponges.

Each example must exit 0 and print the JAX example's load-bearing line; its
printed challenges, root or tour values must equal what the JAX package's
oracles compute on the same inputs (tolerance 0).  The family tour runs one
config per case.  All subprocesses start together when the module's first
test runs, so the file costs about the slowest of them.  Asked for the
card where there is none, each example raises.
"""

import ast
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import sponge_tpu as J
from sponge_tpu_torch.examples import family_tour, fiat_shamir, merkle_commitment

REPO = Path(__file__).resolve().parents[1]
FS_LANES = 16
MERKLE_LANES, MERKLE_PROOFS = 64, 8
TOUR = [name for name, _ in family_tour.configs()]
RUNS = {
    "fiat_shamir": ["fiat_shamir", "--lanes", str(FS_LANES)],
    "merkle_commitment": ["merkle_commitment", "--lanes", str(MERKLE_LANES), "--proofs", str(MERKLE_PROOFS)],
    **{f"tour{i}": ["family_tour", "--lanes", "2", "--only", name] for i, name in enumerate(TOUR)},
}
# The JAX examples' configs of the tour, in the same order.
JAX_TOUR = [
    lambda: J.get_default_poseidon_parameters(J.BLS12_381_FR, rate=2),
    lambda: J.get_default_poseidon2_parameters(J.KOALABEAR_FR, 8),
    lambda: J.get_default_rescue_parameters(J.MERSENNE31_FR, 8),
    lambda: J.get_default_monolith_parameters(J.GOLDILOCKS_FR),
    lambda: J.get_default_griffin_parameters(J.GOLDILOCKS_FR, 4),
    lambda: J.get_default_anemoi_parameters(J.GOLDILOCKS_FR, 4),
    lambda: J.get_default_gmimc_parameters(J.GOLDILOCKS_FR, 4),
]


@pytest.fixture(scope="module")
def runs():
    """All example runs, started at once; each test waits for its own."""
    procs = {
        key: subprocess.Popen(
            [sys.executable, "-m", f"sponge_tpu_torch.examples.{args[0]}", "--device", "cpu", *args[1:]],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for key, args in RUNS.items()
    }
    yield procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def output(runs, key) -> str:
    out, err = runs[key].communicate(timeout=300)
    assert runs[key].returncode == 0, err[-2000:]
    return out


def test_fiat_shamir_matches_jax_oracle(runs):
    out = output(runs, "fiat_shamir")
    assert "challenges match the device transcript lane" in out
    lane = 7
    got = ast.literal_eval(re.search(rf"lane {lane} challenges = (\[.*\])", out).group(1))
    msgs = np.random.default_rng(fiat_shamir.SEED).integers(0, 1 << 62, size=(4, FS_LANES))
    o = J.get_default_poseidon_parameters(J.BLS12_381_FR, 2, False).oracle_sponge()
    o.absorb_field_elements([int(v) for v in msgs[:3, lane]])
    want = o.squeeze_native_field_elements(2)
    o.absorb_field_elements([int(msgs[3, lane])])
    assert got == want + o.squeeze_native_field_elements(1)


def test_merkle_commitment_matches_jax_oracle(runs):
    out = output(runs, "merkle_commitment")
    assert f"opened+verified {MERKLE_PROOFS} proofs" in out
    cfg = J.get_default_monolith_parameters(J.GOLDILOCKS_FR)
    level, _ = merkle_commitment.leaf_values(MERKLE_LANES, MERKLE_PROOFS)
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level), 2):
            o = cfg.oracle_sponge()
            o.absorb_field_elements(level[i : i + 2])
            nxt.append(o.squeeze_native_field_elements(1)[0])
        level = nxt
    assert int(re.search(r"root = (\d+)", out).group(1)) == level[0]


@pytest.mark.parametrize("index", range(len(TOUR)), ids=[name.split(" /")[0] for name in TOUR])
def test_family_tour_matches_jax_oracle(runs, index):
    name = TOUR[index]
    out = output(runs, f"tour{index}")
    m = re.search(rf"  {re.escape(name)}: challenge=(\d+)  forked_bytes=([0-9a-f]+)", out)
    assert m, out
    cfg = JAX_TOUR[index]()
    fs = cfg.field
    o = cfg.oracle_sponge()
    o.absorb(b"domain: example")
    o.absorb(J.U64(42))
    o.absorb([J.Fp(3, fs), J.Fp(5, fs)])
    sub = o.fork(b"sub-protocol")
    assert int(m.group(1)) == o.squeeze_native_field_elements(1)[0]
    assert m.group(2) == sub.squeeze_bytes(8).hex()


@pytest.mark.parametrize("example", [fiat_shamir, merkle_commitment, family_tour], ids=lambda m: m.__name__)
def test_examples_refuse_a_missing_card(example, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main(device="cuda")
