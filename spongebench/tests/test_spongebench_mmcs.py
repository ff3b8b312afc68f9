"""The MMCS cell (``bb-mmcs-commit-2p23``) on the CPU: it resolves to the
Poseidon2 family, the ``mmcs`` job and its three readers; a tiny mix is
judged correct; the control, a digest or node altered where the program
makes it, and an overwrite at the wrong rows read ``correct`` false; a
program without the two calls fails before any input is made; the readers
on hand-made spans and traces; the family's bound."""

import subprocess
import sys

import pytest
import torch

from spongebench.harness import ROOT, TraceContext, load_benchmark, resolve
from spongebench.roofline import PEAKS
from spongebench.tests.helpers import tiny_run
from spongebench.trace import Trace

CELL = "bb-mmcs-commit-2p23"
READERS = ["overwrite_share.mmcs", "leaf_hash_share.mmcs", "p2_bound_share.mmcs"]
H100 = "NVIDIA H100 80GB HBM3"


def _bump(plane):
    out = plane.clone()
    out.view(-1)[0] ^= 1
    return out


def test_cell_resolves_to_its_family_job_and_readers():
    cell = resolve(CELL)
    assert cell.chips == 1 and cell.config["name"] == "bb-poseidon2-t16"
    assert cell.family.__file__.endswith("families/poseidon2.py")
    assert cell.job.__file__.endswith("jobs/mmcs.py")
    assert [n for n, _, _ in cell.per_layer] == READERS
    assert [n for n, _, _ in cell.end_to_end] == ["leaves_per_s", "commit_ms_p90", "setup_s"]


def test_each_cell_reads_the_metrics_that_list_it():
    bench = load_benchmark()
    for w in bench["workloads"]:
        want = [m["name"] for m in bench["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert [n for n, _, _ in resolve(w["name"]).per_layer] == want


def test_tiny_mix_is_correct():
    out = tiny_run(CELL, leaves_log2=3)
    assert out["correct"] is True
    assert set(out["checks"]) == {"answer_mismatches", "leaf_mismatches", "node_mismatches", "proof_failures"}
    assert all(c["value"] == 0 for c in out["checks"].values())


def test_control_is_not_correct():
    out = tiny_run(CELL, leaves_log2=3, control=True)
    assert out["correct"] is False
    assert out["checks"]["leaf_mismatches"]["value"] > 0 and out["checks"]["node_mismatches"]["value"] > 0


@pytest.mark.parametrize("site", ["padding_free_hash", "truncated_compress_pairs"])
def test_altered_digest_or_node_is_not_correct(monkeypatch, site):
    """One limb flipped in the leaf digests, or in the one level of two
    nodes, where the program makes it."""
    from sponge_tpu_torch import hash as sthash

    real = getattr(sthash, site)

    def altered(cfg, *args, **kw):
        out = real(cfg, *args, **kw)
        return _bump(out) if site == "padding_free_hash" or out.shape[-1] == 2 else out

    monkeypatch.setattr(sthash, site, altered)
    out = tiny_run(CELL, leaves_log2=3)
    assert out["correct"] is False
    key = "leaf_mismatches" if site == "padding_free_hash" else "node_mismatches"
    assert out["checks"][key]["value"] > 0


def test_overwrite_at_the_wrong_rows_is_not_correct(monkeypatch):
    """The chunk written after the capacity, where an ark-sponge adds it."""
    from sponge_tpu_torch import hash as sthash

    def behind_capacity(cfg, state, chunk):
        return torch.cat([state[: cfg.capacity], chunk, state[cfg.capacity + chunk.shape[0]:]])

    monkeypatch.setattr(sthash, "overwrite_rows", behind_capacity)
    out = tiny_run(CELL, leaves_log2=3)
    assert out["correct"] is False and out["checks"]["leaf_mismatches"]["value"] > 0


@pytest.mark.parametrize("call", ["padding_free_hash", "merkle_tree_truncated"])
def test_a_program_without_the_calls_fails_before_its_inputs(monkeypatch, call):
    from sponge_tpu_torch import hash as sthash

    made = []
    monkeypatch.delattr(sthash, call)
    monkeypatch.setattr("spongebench.jobs.commit.random_plane", lambda *a: made.append(a))
    with pytest.raises(AttributeError, match=call):
        tiny_run(CELL)
    assert made == []


def test_reference_and_family_import_nothing_of_the_program():
    code = ("import sys; import spongebench.reference.poseidon2;"
            "from spongebench.harness import _load_module, BENCH_DIR;"
            "_load_module(BENCH_DIR / 'families' / 'poseidon2.py');"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'sponge_tpu_torch', 'sponge_tpu', 'jax', 'torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_bound_counts_poseidon2s_own_work():
    """Per permutation at t = 16: 8 x 16 + 13 S-boxes of 4 products, 13 x
    16 diagonal products, each 2 wide and 1 narrow; M_E's additions
    nothing.  2^20 permutations at the H100's peaks: 0.242 ms."""
    cell = resolve(CELL)
    assert cell.family.permutation_products(cell.config) == (2 * (141 * 4 + 208), 141 * 4 + 208)
    assert round(cell.family.permutations_bound_s(PEAKS[H100], cell.config, 1 << 20) * 1e3, 3) == 0.242
    with pytest.raises(ValueError, match="2\\^31"):
        cell.family.permutation_products(dict(cell.config, modulus=(1 << 64) - (1 << 32) + 1))


def span(name, parent, count, device_us):
    return {"name": name, "parent": parent, "count": count, "host_us": 1.0, "device_us": device_us}


# A leaf hash of two chunks, then a tree of one level, then an opening.
HAND_MADE = [
    span("hash.padding_free", None, 4, 600.0),
    span("sponge.overwrite", 0, 4, 100.0),
    span("sponge.permute", 0, 4, 200.0),
    span("sponge.overwrite", 0, 4, 50.0),
    span("sponge.permute", 0, 4, 200.0),
    span("merkle.tree", None, 4, 300.0),
    span("merkle.level", 5, 2, 250.0),
    span("merkle.truncate", 6, 2, 240.0),
    span("sponge.permute", 7, 2, 200.0),
    span("merkle.open", None, 3, 100.0),
]


@pytest.fixture
def readers():
    cell = resolve(CELL)
    return cell, {name: reader for name, _, reader in cell.per_layer}


def test_span_readers_on_a_hand_made_list(readers, monkeypatch):
    from sponge_tpu_torch.utils import profiling

    _, read = readers
    monkeypatch.setattr(profiling, "spans", lambda: [dict(s) for s in HAND_MADE])
    assert read["overwrite_share.mmcs"](None) == pytest.approx(100 * 150 / 1000)
    assert read["leaf_hash_share.mmcs"](None) == pytest.approx(100 * 600 / 1000)


@pytest.mark.parametrize("name", READERS[:2])
@pytest.mark.parametrize("case", ("no_spans_api", "no_spans", "no_device_time", "none_of_its_own"))
def test_span_readers_give_none_without_what_they_read(readers, monkeypatch, name, case):
    from sponge_tpu_torch.utils import profiling

    _, read = readers
    if case == "no_spans_api":
        monkeypatch.delattr(profiling, "spans")
    elif case == "no_spans":
        monkeypatch.setattr(profiling, "spans", lambda: [])
    elif case == "no_device_time":
        monkeypatch.setattr(profiling, "spans", lambda: [dict(s, device_us=None) for s in HAND_MADE])
    else:  # a program before this cell's spans, on another path
        monkeypatch.setattr(profiling, "spans", lambda: [dict(s) for s in HAND_MADE[5:]])
    assert read[name](None) is None


def _trace(kernel_us):
    events = [{"ph": "X", "cat": "cpu_op", "name": "ProfilerStep#1", "ts": 0.0, "dur": 10_000.0},
              {"ph": "X", "cat": "kernel", "name": "void sponge::poseidon2_word_kernel<16, true>(int const*, int*)",
               "ts": 100.0, "dur": kernel_us},
              {"ph": "X", "cat": "kernel", "name": "void at::native::cat_kernel(int*)", "ts": 10.0, "dur": 50.0}]
    return Trace.from_events(events)


def test_p2_bound_share_reads_kernel_3_in_the_trace(readers):
    cell, read = readers
    ctx = TraceContext(_trace(4_000.0), 2, 1 << 20, cell.config, cell.family, H100)
    bound_s = cell.family.permutations_bound_s(PEAKS[H100], cell.config, 2 << 20)
    assert read["p2_bound_share.mmcs"](ctx) == pytest.approx(100 * bound_s / 4e-3)
    assert read["p2_bound_share.mmcs"](TraceContext(_trace(4_000.0), 2, 1 << 20, cell.config, cell.family,
                                                    "cpu")) is None
