"""The harness on the CPU: cells resolve by name, ``BENCHMARK.json`` keeps
to the benchmark's contract, the result line's keys (the contract's, with
the compared numbers under ``checks`` last), and the refusals."""

import json
import re
import shutil
import subprocess
import sys
import time

import pytest

from spongebench import harness
from spongebench.harness import BENCH_DIR, ROOT, load_benchmark
from spongebench.tests.helpers import tiny_run

BENCH = load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert BENCH["paths"] == ["spongebench"] and BENCH["command"][1].startswith("spongebench/")
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("spongebench/") and (ROOT / c["file"]).is_file()
        family = json.loads((ROOT / c["file"]).read_text())["family"]
        assert (BENCH_DIR / "families" / f"{family}.py").is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
        names.add(c["name"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in names and w["chips"] in (1, 4)
        traffic = json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH_DIR / "jobs" / f"{traffic['job']}.py").is_file()
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"]) == len(set(CELLS))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
    assert len({m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}) == len(e2e) + len(BENCH["per_layer"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_by_name(name):
    cell = harness.resolve(name)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert cell.config["name"] == entry["config"]
    assert [n for n, _, _ in cell.end_to_end] == [m["name"] for m in BENCH["end_to_end"]]
    assert [n for n, _, _ in cell.per_layer] == [m["name"] for m in BENCH["per_layer"]]
    assert all(callable(r) for _, _, r in cell.end_to_end + cell.per_layer)
    assert cell.family.__file__.endswith(f"families/{cell.config['family']}.py")
    assert cell.job.__file__.endswith(f"jobs/{cell.traffic['job']}.py")
    with pytest.raises(KeyError):
        harness.resolve(name + "-none")


@pytest.mark.parametrize("name", CELLS)
def test_result_keys(name):
    out = tiny_run(name)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"leaves_per_s", "commit_ms_p90", "setup_s"}
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())


def test_traced_result_keys():
    out = tiny_run("bls381-merkle-2p24", trace=True)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "breakdown", "checks"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_new_cell_is_only_new_files_and_entries(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a cell
    and a per-layer metric as new files and entries alone, and the new cell
    resolves and runs; a metric without ``workloads`` applies to every
    cell, one with it to the cells it lists."""
    shutil.copytree(BENCH_DIR, tmp_path / "spongebench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    config = json.loads((BENCH_DIR / "configs" / "bls381-poseidon-r2.json").read_text())
    (tmp_path / "spongebench/configs/bls381-poseidon-r2-copy.json").write_text(
        json.dumps(dict(config, name="bls381-poseidon-r2-copy")))
    mix = json.loads((BENCH_DIR / "traffic" / "merkle-2p24.json").read_text())
    (tmp_path / "spongebench/traffic/merkle-opened.json").write_text(
        json.dumps(dict(mix, leaves_log2=2, openings=3)))
    (tmp_path / "spongebench/metrics/jobs_per_s.py").write_text(
        "def read(ctx):\n    return len(ctx.jobs) / ctx.seconds\n")
    bench["configs"].append(dict(bench["configs"][0], name="bls381-poseidon-r2-copy",
                                 file="spongebench/configs/bls381-poseidon-r2-copy.json"))
    bench["workloads"].append({"name": "bls381-merkle-opened", "config": "bls381-poseidon-r2-copy",
                               "traffic": "merkle-opened", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "jobs_per_s", "unit": "jobs/s", "better": "higher", "bound": 0.01,
                                "source": "host_clock"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.resolve("bls381-merkle-opened", root=tmp_path)
    assert [n for n, _, _ in cell.end_to_end] == ["leaves_per_s", "commit_ms_p90", "setup_s", "jobs_per_s"]
    assert cell.per_layer == []  # every per-layer entry lists the cells it reads
    assert "jobs_per_s" in [n for n, _, _ in harness.resolve(CELLS[0], root=tmp_path).end_to_end]
    out = harness.run(cell, 2**33 + 1, 0, False, "cpu", time.perf_counter())
    assert out["correct"] is True and set(out["checks"]) == {"answer_mismatches", "node_mismatches",
                                                              "proof_failures"}
    assert out["metrics"]["jobs_per_s"]["unit"] == "jobs/s"


def test_no_card_exits_without_a_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "spongebench/run.py", "--workload", CELLS[0], "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    for name in ("sponge_tpu_torch_extra", "jaxtyping_like", "sponge_tpu_torch.hash"):
        monkeypatch.setitem(sys.modules, name, object())
    assert "sponge_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "sponge_tpu.fields", object())
    assert "sponge_tpu" in harness.forbidden_modules()


def test_a_run_loads_no_forbidden_module():
    code = ("import json, time; from spongebench import harness;"
            "from spongebench.tests.helpers import tiny_run;"
            "out = tiny_run('bls381-merkle-2p24', leaves_log2=1);"
            "print(json.dumps([out['correct'], harness.forbidden_modules()]))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == [True, []]
