"""Share of the overwritten chunks that the permutation kernel wrote over
the state as it loaded it (``sponge.overwrite_fused`` spans, the
program's ``poseidon.permutation.overwrite_permute`` on kernel 3, each
counting its lanes times its chunks), among all overwritten chunks: those
and the ``sponge.overwrite`` spans' lanes, one span a chunk, where PyTorch
ops write each chunk into a new state before a separate permutation
launch.  Counted, not timed.  Read from the program's spans
(``sponge_tpu_torch.utils.profiling.spans``); None without them or without
any overwrite."""

from sponge_tpu_torch.utils import profiling


def read(ctx):
    spans = profiling.spans() if hasattr(profiling, "spans") else []
    fused = sum(s["count"] or 0 for s in spans if s["name"] == "sponge.overwrite_fused")
    apart = sum(s["count"] or 0 for s in spans if s["name"] == "sponge.overwrite")
    if fused + apart <= 0:
        return None
    return 100.0 * fused / (fused + apart)
