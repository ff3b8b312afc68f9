"""Reduction of a ``torch.profiler`` Chrome trace to intervals, busy time
and the breakdown that a traced run prints.

The busy time is the union of the device's intervals (kernels, copies and
fills), so overlapping work counts once: the arithmetic of the program's
``device_busy_share``, copied here so that the yardstick does not move with
the program.  The window is the span of the profiler's active steps.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
# The port's permutation entry points (``sponge_tpu_torch/csrc/*.cu``),
# whatever their template arguments.  Every other device interval is glue.
PERMUTATION_KERNELS = frozenset((
    "poseidon_opt_kernel", "poseidon_dense_kernel", "poseidon_dense_word_kernel", "poseidon_dense_gl_kernel",
    "poseidon2_kernel", "poseidon2_word_kernel", "rescue_kernel", "griffin_kernel", "anemoi_kernel",
    "gmimc_kernel", "gmimc_word_kernel", "monolith_kernel", "monolith_mersenne_kernel",
))


def short_name(name: str) -> str:
    """A kernel's name without its return type and its argument list (the
    last parenthesised group, whatever parentheses its template arguments
    hold)."""
    name = name.strip().removeprefix("void ")
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                return name[:i].strip()
    return name


def is_permutation(name: str) -> bool:
    """Whether a kernel is one of ``PERMUTATION_KERNELS``: its short name
    without template arguments or namespace."""
    base = short_name(name).split("<", 1)[0]
    return base.rsplit("::", 1)[-1] in PERMUTATION_KERNELS


@dataclass
class Trace:
    """The timed events of one trace, in microseconds."""

    device: list  # (start, end, name, cat)
    host: list  # (start, end, name)
    window: tuple  # (start, end)

    @classmethod
    def from_events(cls, events: list) -> "Trace":
        timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
        device, host, steps = [], [], []
        for e in timed:
            lo = float(e["ts"])
            hi = lo + float(e["dur"])
            cat, name = e.get("cat", ""), e.get("name", "")
            if cat in DEVICE_CATS:
                device.append((lo, hi, name, cat))
            elif cat in HOST_CATS:
                host.append((lo, hi, name))
                if name.startswith("ProfilerStep#"):
                    steps.append((lo, hi))
        spans = steps or [(lo, hi) for lo, hi, *_ in device + host]
        if not spans:
            raise ValueError("the trace holds no timed events")
        window = (min(lo for lo, _ in spans), max(hi for _, hi in spans))
        return cls(sorted(device), sorted(host), window)

    @classmethod
    def from_file(cls, path) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls.from_events(data["traceEvents"] if isinstance(data, dict) else data)

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def kernels(self) -> list:
        return [d for d in self.device if d[3] == "kernel"]

    def permutation_kernels(self) -> list:
        return [d for d in self.device if d[3] == "kernel" and is_permutation(d[2])]

    def glue(self) -> list:
        """Every device interval (kernel, copy or fill) that is not a
        permutation kernel."""
        return [d for d in self.device if not (d[3] == "kernel" and is_permutation(d[2]))]

    def busy_us(self, intervals=None) -> float:
        """The union of ``intervals`` (all device intervals by default),
        clipped to the window."""
        lo_w, hi_w = self.window
        busy, reach = 0.0, lo_w
        for lo, hi, *_ in sorted(self.device if intervals is None else intervals):
            lo, hi = max(lo, reach), min(hi, hi_w)
            if hi > lo:
                busy += hi - lo
                reach = hi
        return busy

    def gaps(self) -> list:
        """(start, end) of every stretch of the window with nothing on the
        device."""
        out, reach = [], self.window[0]
        for lo, hi, *_ in self.device:
            if lo > reach:
                out.append((reach, min(lo, self.window[1])))
            reach = max(reach, hi)
        if reach < self.window[1]:
            out.append((reach, self.window[1]))
        return [(lo, hi) for lo, hi in out if hi > lo]

    def host_at(self, stamps) -> list:
        """For each of the ascending times ``stamps``, the innermost host
        event running then: of those that cover it, the one that started
        last."""
        out, active, i = [], [], 0
        for ts in stamps:
            while i < len(self.host) and self.host[i][0] <= ts:
                if not self.host[i][2].startswith("ProfilerStep#"):
                    active.append(self.host[i])
                i += 1
            active = [e for e in active if e[1] >= ts]
            out.append(max(active)[2] if active else "(no host event)")
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by what the host was doing at their start; seconds."""
        ops = {}
        for lo, hi, name, _ in self.device:
            key = short_name(name)
            ops[key] = ops.get(key, 0.0) + (hi - lo) * 1e-6
        idle = {}
        gaps = self.gaps()
        for (lo, hi), key in zip(gaps, self.host_at([lo for lo, _ in gaps])):
            idle[key] = idle.get(key, 0.0) + (hi - lo) * 1e-6
        rank = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]
        return {"device_ops": rank(ops), "idle_gaps": rank(idle)}
