"""Share of the outermost program spans' device time spent in the absorbs
(``sponge.absorb``, the program's ``transcript.add_rows``): the rate rows
added into whole states and the states put back together.  Read from the
spans the program records while the profiler runs
(``sponge_tpu_torch.utils.profiling.spans``); device time is between CUDA
events at a span's entry and exit, idle included.  None without them."""

from sponge_tpu_torch.utils import profiling


def read(ctx):
    spans = profiling.spans() if hasattr(profiling, "spans") else []
    absorbs = [s["device_us"] for s in spans if s["name"] == "sponge.absorb"]
    outer = [s["device_us"] for s in spans if s["parent"] is None]
    if not absorbs or None in absorbs + outer or sum(outer) <= 0:
        return None
    return 100.0 * sum(absorbs) / sum(outer)
