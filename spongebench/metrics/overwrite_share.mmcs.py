"""Share of the outermost program spans' device time spent in the
overwrites (``sponge.overwrite``, the program's
``poseidon.permutation.overwrite_rows``): each chunk written into the rate
of a new state, the rest of the state copied beside it.  Read from the
spans the program records while the profiler runs
(``sponge_tpu_torch.utils.profiling.spans``); device time is between CUDA
events at a span's entry and exit, idle included.  None without them."""

from sponge_tpu_torch.utils import profiling


def read(ctx):
    spans = profiling.spans() if hasattr(profiling, "spans") else []
    writes = [s["device_us"] for s in spans if s["name"] == "sponge.overwrite"]
    outer = [s["device_us"] for s in spans if s["parent"] is None]
    if not writes or None in writes + outer or sum(outer) <= 0:
        return None
    return 100.0 * sum(writes) / sum(outer)
