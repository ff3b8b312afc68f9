"""The plain reference against ark-sponge's golden vector and against the
program's plain tier at tiny sizes (the test may import the program; the
reference may not)."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from spongebench.harness import ROOT, load_benchmark
from spongebench.reference import planes
from spongebench.reference.poseidon import Poseidon, Sponge, compress, hash_elements

P_BLS = 52435875175126190479447740508185965837690552500527637822603658699938581184513
CONFIGS = [c["file"] for c in load_benchmark()["configs"]]


def _config(path):
    import json

    return json.loads((ROOT / path).read_text())


def _reference(config):
    from spongebench.harness import _load_module

    return _load_module(ROOT / "spongebench" / "families" / f"{config['family']}.py").Reference(config).params


def test_golden_vector():
    """ark-sponge's rate-2 vector: absorb [0, 1, 2], the first squeezed
    element."""
    s = Sponge(Poseidon.generate(P_BLS, 2, 1, 17, 8, 31))
    s.absorb([0, 1, 2])
    assert s.squeeze(3)[0] == 40442793463571304028337753002242186710310163897048962278675457993207843616876


@pytest.mark.parametrize("path", CONFIGS)
def test_constants_equal_the_programs_defaults(path):
    import sponge_tpu_torch as st

    config = _config(path)
    ref = _reference(config)
    cfg = st.get_default_poseidon_parameters(st.get_field(config["field"]), config["rate"])
    assert (ref.ark, ref.mds, ref.capacity) == (cfg.ark, cfg.mds, cfg.capacity)


@pytest.mark.parametrize("path", CONFIGS)
def test_sponge_and_tree_equal_the_programs_plain_tier(path):
    """hash_elements over uneven rows and one tree level, element for
    element, through the program's CPU tier."""
    import sponge_tpu_torch as st
    from sponge_tpu_torch import hash as sthash

    config = _config(path)
    p, d = config["modulus"], config["digest_elems"]
    ref = _reference(config)
    cfg = st.get_default_poseidon_parameters(st.get_field(config["field"]), config["rate"])
    rng = np.random.default_rng(5)
    k, n = 2 * config["rate"] + 3, 4
    rows = [[int(v) % p for v in rng.integers(0, 2**63, k, dtype=np.uint64)] for _ in range(n)]
    rows[0][:3] = [0, 1, p - 1]
    plane = torch.from_numpy(np.stack([planes.encode(p, [r[e] for r in rows]) for e in range(k)]))
    got = sthash.hash_elements(cfg, plane, d)
    want = [hash_elements(ref, r, d) for r in rows]
    assert [list(x) for x in zip(*[planes.decode(p, got[e].numpy()) for e in range(d)])] == want
    level = sthash.merkle_tree_wide(cfg, got)[1]
    assert [list(x) for x in zip(*[planes.decode(p, level[e].numpy()) for e in range(d)])] == [
        compress(ref, want[0], want[1]), compress(ref, want[2], want[3])]


def test_plane_codec_equals_the_programs():
    import sponge_tpu_torch as st

    for fs in (st.BLS12_381_FR, st.GOLDILOCKS_FR):
        vals = [0, 1, 2, fs.modulus - 1, fs.modulus // 3]
        enc = planes.encode(fs.modulus, vals)
        assert np.array_equal(enc, fs.ints_to_mont_plane(vals))
        assert planes.decode(fs.modulus, enc) == vals
    bad = planes.encode(P_BLS, [5])
    bad[-1, 0] = 1 << 24
    assert planes.decode(P_BLS, bad) == [None]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import spongebench.reference.poseidon, spongebench.reference.planes;"
            "from spongebench.harness import _load_module, BENCH_DIR;"
            "_load_module(BENCH_DIR / 'families' / 'poseidon.py');"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'sponge_tpu_torch', 'sponge_tpu', 'jax', 'torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
