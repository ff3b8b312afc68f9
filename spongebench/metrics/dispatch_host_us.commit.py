"""Host microseconds of one call of the program's permutation dispatch
(``poseidon.permutation.batched_permute``, the ``sponge.permute`` spans
with lanes to permute): the checks, the module and the kernel launch, up
to the return, while the card runs the work.  The median over the traced
calls: a launch that finds the launch queue full waits there for the card,
which is a stall and not dispatch work, and a few such waits of
milliseconds would move a mean far.  Read from the program's spans
(``sponge_tpu_torch.utils.profiling.spans``), so with the profiler's own
cost on every operation inside; None without them, or where a span has no
device time (a run on the host, whose host time is the permutation
itself)."""

import statistics

from sponge_tpu_torch.utils import profiling


def read(ctx):
    spans = profiling.spans() if hasattr(profiling, "spans") else []
    calls = [s for s in spans if s["name"] == "sponge.permute" and (s["count"] or 0) > 0]
    if not calls or any(s["device_us"] is None or s["host_us"] is None for s in calls):
        return None
    return statistics.median(s["host_us"] for s in calls)
