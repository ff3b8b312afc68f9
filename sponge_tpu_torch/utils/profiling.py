"""Tracing, throughput and static cost counts of sponge workloads.

Counterpart of ``sponge_tpu/utils/profiling.py``:

* ``trace``: a ``torch.profiler`` capture of the enclosed block (CPU and,
  where there is a GPU, CUDA activity), written as a Chrome trace;
* ``annotate``: a named span in that trace (``record_function``);
* ``device_busy_share``: the share of the traced window in which a CUDA
  kernel ran;
* ``ThroughputMeter``: permutations per second of a step function;
* ``sbox_muls`` and ``op_counts``: the static per-permutation arithmetic
  count of a Poseidon config.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import time
from dataclasses import dataclass

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ..poseidon.config import PoseidonConfig

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir):
    """Profile the enclosed block and write ``log_dir/trace.json`` (Chrome
    trace format; open it in Perfetto).  CUDA work is traced where a GPU is
    present and synchronized before the trace ends."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = pathlib.Path(log_dir)
    path.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(str(path / TRACE_FILE))


annotate = record_function


def _events(trace_path) -> list:
    data = json.loads(pathlib.Path(trace_path).read_text())
    return data["traceEvents"] if isinstance(data, dict) else data


def device_busy_share(trace_path) -> dict:
    """Device time in a trace written by ``trace`` (a file, or the
    directory it was written to): {window_us, kernel_us, busy_share,
    kernels}.  The window runs from the first to the last event of the
    trace; kernel time is the union of the CUDA kernel intervals, so
    overlapping kernels count once; ``kernels`` sums each kernel name's
    time."""
    path = pathlib.Path(trace_path)
    events = [e for e in _events(path / TRACE_FILE if path.is_dir() else path)
              if e.get("ph") == "X" and "dur" in e]
    if not events:
        raise ValueError(f"{trace_path}: no timed events")
    start = min(float(e["ts"]) for e in events)
    end = max(float(e["ts"]) + float(e["dur"]) for e in events)
    kernels = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                     for e in events if e.get("cat") == "kernel")
    busy, reach, by_name = 0.0, start, {}
    for lo, hi, name in kernels:
        by_name[name] = by_name.get(name, 0.0) + (hi - lo)
        if hi > reach:
            busy += hi - max(lo, reach)
            reach = hi
    window = end - start
    return {"window_us": window, "kernel_us": busy, "busy_share": busy / window, "kernels": by_name}


@dataclass
class ThroughputMeter:
    """Sustained permutations per second of a state -> state step function."""

    reps: int = 8

    def measure(self, step_fn, state: torch.Tensor) -> float:
        out = step_fn(state)
        _sync(out)
        t0 = time.perf_counter()
        for _ in range(self.reps):
            out = step_fn(out)
        _sync(out)
        dt = (time.perf_counter() - t0) / self.reps
        return out.shape[-1] / dt


def _sync(x: torch.Tensor) -> None:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def sbox_muls(alpha: int) -> int:
    """Field multiplies per S-box application (square-and-multiply chain)."""
    bits = bin(alpha)[2:]
    return (len(bits) - 1) + bits[1:].count("1")


def op_counts(cfg: PoseidonConfig) -> dict:
    """Static per-permutation arithmetic count of ``cfg``, as the JAX
    package's: Montgomery multiplies as the scalar reference performs them
    (S-boxes and a dense MDS every round), and its estimate of the 32-bit
    multiplies per lane of its kernel, whose limbs have 12 bits (not the
    port's 24)."""
    p = cfg.field.modulus
    L = -(-(p.bit_length() + 4) // 12)  # the JAX package's limb count
    t = cfg.t
    s = sbox_muls(cfg.alpha)
    sbox_apps = cfg.full_rounds * t + cfg.partial_rounds
    field_muls = sbox_apps * s + cfg.rounds * t * t
    redc = sum(1 for k in range(L) if (p >> (12 * k)) & 0xFFF) * L
    per_mul = L * L + redc
    mds_per_round = t * (t * L * L + redc)
    int32_muls = sbox_apps * s * per_mul + cfg.rounds * mds_per_round
    return {
        "rounds": cfg.rounds,
        "sbox_applications": sbox_apps,
        "sbox_muls_each": s,
        "field_muls": field_muls,
        "int32_muls_cios_per_lane": int32_muls,
        "r1cs_constraints_per_permutation": s * sbox_apps,
    }
