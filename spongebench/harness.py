"""One run of one benchmark cell.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``;
its configuration in the file that the configuration's entry names, whose
``family`` names ``families/<family>.py`` (the program's config, the
control's, the plain reference, the permutations' bound); its traffic mix
in ``traffic/<mix>.json``, whose ``job`` names the generator
``jobs/<job>.py`` that reads the mix's parameters, runs one job and judges
the outputs; and each metric's reader in ``metrics/<metric>.py``, the
end-to-end ones reading the window, the per-layer ones the trace.  A new
cell, configuration, mix or metric is new files and entries.

A run: make the cell's inputs on the device from the seed, build the
program's objects, warm up the cell's shapes (``setup_s`` ends here), run
jobs in a closed loop for ``--seconds`` (``--trace 1``: profile a few whole
jobs instead), judge every output against the plain reference, and print
one JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pathlib
import sys
import tempfile
import time
from dataclasses import dataclass

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# Top-level modules that no run may load: the JAX package the program was
# ported from, and JAX itself.
FORBIDDEN = ("jax", "jaxlib", "flax", "sponge_tpu")
TRACED = 4  # jobs profiled in a --trace 1 run, after one the profiler warms up on


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    family: object  # families/<family>.py
    job: object  # jobs/<job>.py
    end_to_end: list  # (name, unit, reader)
    per_layer: list  # (name, unit, reader)


@dataclass
class Window:
    """What an end-to-end reader reads: the window's jobs (each with its
    ``units`` and ``ms``), its wall time up to the last completion, and the
    set-up time before it."""

    jobs: list
    seconds: float
    setup_s: float


@dataclass
class TraceContext:
    """What a per-layer reader reads: the trace of ``jobs`` whole jobs,
    ``permutations`` each, of ``config`` (of ``family``) on ``device``."""

    trace: object
    jobs: int
    permutations: int
    config: dict
    family: object
    device: str


def load_benchmark(root=ROOT) -> dict:
    return json.loads((pathlib.Path(root) / "BENCHMARK.json").read_text())


def _load_module(path: pathlib.Path):
    """The module in ``path``, found by file name (which may hold dots)."""
    name = "spongebench_{}_{}".format(path.parent.name, path.stem.replace(".", "_").replace("-", "_"))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


def resolve(name: str, root=ROOT) -> Cell:
    """The cell called ``name``, with its configuration, traffic parameters,
    family, job and metric readers.  A metric applies to the cells that its
    ``workloads`` lists, or to every cell without that key."""
    root = pathlib.Path(root)
    bench, bench_dir = load_benchmark(root), root / BENCH_DIR.name
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; one of {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    readers = {kind: [(m["name"], m["unit"], _load_module(bench_dir / "metrics" / f"{m['name']}.py").read)
                      for m in bench[kind] if name in m.get("workloads", [name])]
               for kind in ("end_to_end", "per_layer")}
    return Cell(name, int(w["chips"]), config, traffic,
                _load_module(bench_dir / "families" / f"{config['family']}.py"),
                _load_module(bench_dir / "jobs" / f"{traffic['job']}.py"),
                readers["end_to_end"], readers["per_layer"])


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str, t_start: float,
        control: bool = False) -> dict:
    """One run of ``cell``: the result's fields (all but ``device``'s card
    name), and ``checks`` last, each compared number with its limit.
    ``control`` runs the family's control config in the program's place."""
    import torch

    import sponge_tpu_torch as st

    make_config = cell.family.control_config if control else cell.family.program_config
    cfg = make_config(st, cell.config)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    job = cell.job.Job(cfg, cell.config, cell.traffic, device, seed)
    records = [job.run(j) for j in range(job.warm)]
    j = len(records)
    setup_s = time.perf_counter() - t_start
    metrics, dev = {}, {}
    if trace:
        ctx, traced = _traced(job, j, cell, device)
        records += traced
        window = traced[1:]
        dev = {"busy_s": ctx.trace.busy_us() * 1e-6, "window_s": ctx.trace.window_us * 1e-6}
        readers, breakdown = cell.per_layer, ctx.trace.breakdown()
    else:
        window = []
        t0 = end = time.perf_counter()
        while not window or end - t0 < seconds:
            start = end
            rec = job.run(j)
            end = time.perf_counter()
            rec.ms = (end - start) * 1e3
            window.append(rec)
            j += 1
        records += window
        ctx = Window(window, end - t0, setup_s)
        readers, breakdown = cell.end_to_end, None
    for name, unit, reader in readers:
        value = reader(ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    if device == "cuda":
        dev["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    t_judge = time.perf_counter()
    checks, failed = job.judge(cell.family.Reference(cell.config), records, seed)
    print(f"judged {len(records)} jobs in {time.perf_counter() - t_judge:.1f} s", file=sys.stderr)
    out = {
        "correct": not any(failed) and all(v <= lim for v, lim in checks.values()),
        "attempted": len(window),
        "failed": sum(failed[-len(window):]),
        "metrics": metrics,
        "device": dev,
    }
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return out


def _traced(job, j, cell, device):
    """Profile ``TRACED`` whole jobs after one for the profiler's own
    warm-up; the trace is read and deleted."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from .trace import Trace

    activities = [ProfilerActivity.CPU]
    if device == "cuda":
        activities.append(ProfilerActivity.CUDA)
    records = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=TRACED),
                     on_trace_ready=lambda prof: prof.export_chrome_trace(path)) as prof:
            for _ in range(1 + TRACED):
                records.append(job.run(j))
                j += 1
                prof.step()
        tr = Trace.from_file(path)
    ctx = TraceContext(tr, TRACED, job.permutations, cell.config, cell.family, _device_name(device))
    return ctx, records


def _device_name(device: str) -> str:
    import torch

    return torch.cuda.get_device_name(0) if device == "cuda" else "cpu"


def parse(argv):
    ap = argparse.ArgumentParser(description="One run of one benchmark cell of sponge_tpu_torch.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def report(out: dict) -> None:
    """The check lines last on standard error, the result last on standard
    output."""
    for k, c in out["checks"].items():
        print(f"{k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


def main(argv, t_start: float, control: bool = False) -> int:
    args = parse(argv)
    cell = resolve(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = run(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start, control)
    out["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
                     **out["device"]}
    bad = forbidden_modules()
    if bad:
        print(f"modules loaded that no run may load: {bad}", file=sys.stderr)
        return 3
    report(out)
    return 0
