"""Share of the outermost program spans' device time spent hashing the
rows (``hash.rpo``, the program's ``hash.rpo_hash_elements``): Miden's
leaf sponge against the merge tree and the openings.  Read from the spans
the program records while the profiler runs
(``sponge_tpu_torch.utils.profiling.spans``); device time is between CUDA
events at a span's entry and exit, idle included.  None without them."""

from sponge_tpu_torch.utils import profiling


def read(ctx):
    spans = profiling.spans() if hasattr(profiling, "spans") else []
    hashes = [s["device_us"] for s in spans if s["name"] == "hash.rpo"]
    outer = [s["device_us"] for s in spans if s["parent"] is None]
    if not hashes or None in hashes + outer or sum(outer) <= 0:
        return None
    return 100.0 * sum(hashes) / sum(outer)
