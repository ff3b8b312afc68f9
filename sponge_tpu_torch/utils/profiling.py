"""Tracing of sponge workloads.

Counterpart of ``sponge_tpu/utils/profiling.py``:

* ``trace``: a ``torch.profiler`` capture of the enclosed block (CPU and,
  where there is a GPU, CUDA activity), written as a Chrome trace;
* ``annotate``: the port's span.  While a profiler records, it is a named
  range in the profiler's trace (``record_function``) and a record kept in
  memory: its name, the enclosing span, a count, its host time and, once
  CUDA is initialised, its device time on the current stream.  While none
  records, it is one shared no-op;
* ``spans`` and ``reset``: the records since the last reset;
* ``device_busy_share``: the share of the traced window in which a CUDA
  kernel ran.

The port opens these spans, each with the count named beside it:

* ``merkle.tree``: ``hash._tree_levels``, the leaves;
* ``merkle.level``: each level of it, the nodes the level produces;
* ``merkle.open``: ``hash.merkle_open_batch``, the openings;
* ``hash.elements``: ``hash.hash_elements``, the lanes;
* ``sponge.absorb``: ``poseidon.permutation.add_rows``, the lanes;
* ``sponge.absorb_fused``: ``poseidon.permutation.absorb_permute`` where
  kernel 1 adds the rows as it loads the state, the lanes;
* ``sponge.permute``: ``poseidon.permutation.batched_permute``, and inside
  ``sponge.absorb_fused``, the lanes, which are the permutations.

    with profiling.trace("run"):
        hash.merkle_tree(cfg, leaves)
    profiling.spans()  # [{"name": "merkle.tree", "parent": None, ...}, ...]
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import threading
import time

import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"

TREE = "merkle.tree"
LEVEL = "merkle.level"
OPEN = "merkle.open"
ELEMENTS = "hash.elements"
ABSORB = "sponge.absorb"
ABSORB_FUSED = "sponge.absorb_fused"
PERMUTE = "sponge.permute"


class _Recorder:
    """The spans of this process, in the order they opened, and each
    thread's open spans (their indices)."""

    def __init__(self):
        self.records: list = []
        self.lock = threading.Lock()
        self.local = threading.local()

    def open_spans(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def reset(self) -> None:
        with self.lock:
            self.records = []
        self.open_spans().clear()

    def spans(self) -> list:
        with self.lock:
            records = list(self.records)
        if any(r.events is not None for r in records):
            torch.cuda.synchronize()
        for r in records:
            if r.events is not None and r.host_ns is not None:
                start, end = r.events
                r.device_us, r.events = start.elapsed_time(end) * 1e3, None
        return [{"name": r.name, "parent": r.parent, "count": r.count,
                 "host_us": None if r.host_ns is None else r.host_ns * 1e-3, "device_us": r.device_us}
                for r in records]


_RECORDER = _Recorder()


class _Span:
    """One span while a profiler records (``annotate``), and its record."""

    __slots__ = ("name", "count", "parent", "index", "range", "events", "t0", "host_ns", "device_us")

    def __init__(self, name: str, count):
        self.name, self.count = name, count
        self.events = self.host_ns = self.device_us = None

    def __enter__(self):
        stack = _RECORDER.open_spans()
        self.parent = stack[-1] if stack else None
        with _RECORDER.lock:
            self.index = len(_RECORDER.records)
            _RECORDER.records.append(self)
        stack.append(self.index)
        self.range = record_function(self.name)
        self.range.__enter__()
        if torch.cuda.is_initialized():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self.events = (start, torch.cuda.Event(enable_timing=True))
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        self.range.__exit__(*exc)
        self.host_ns = t1 - self.t0
        stack = _RECORDER.open_spans()
        if stack and stack[-1] == self.index:
            stack.pop()
        return False


_OFF = contextlib.nullcontext()


def annotate(name: str, count=None):
    """A span called ``name`` over the ``with`` block, with ``count`` units
    of work.  Only while a profiler records (PyTorch's own flag for fast
    checks) does it record anything; otherwise it is one shared no-op."""
    if not autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, count)


def spans() -> list:
    """The spans recorded since the last ``reset``, in the order they opened:
    dicts of ``name``, ``parent`` (the enclosing span's index in this list,
    or None), ``count``, ``host_us`` and ``device_us`` (the time between
    CUDA events on the current stream at entry and exit, idle included;
    None without CUDA).  A span still open has neither time.  Synchronises
    the device."""
    return _RECORDER.spans()


def reset() -> None:
    """Forget every span recorded so far."""
    _RECORDER.reset()


@contextlib.contextmanager
def trace(log_dir):
    """Profile the enclosed block and write ``log_dir/trace.json`` (Chrome
    trace format; open it in Perfetto).  CUDA work is traced where a GPU is
    present and synchronized before the trace ends.  The spans start afresh
    (``reset``) and stay readable by ``spans`` afterwards."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = pathlib.Path(log_dir)
    path.mkdir(parents=True, exist_ok=True)
    reset()
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(str(path / TRACE_FILE))


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
