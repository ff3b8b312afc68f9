"""Share of the absorbed lanes whose rows the permutation kernel added as it
loaded the state (``sponge.absorb_fused`` spans, the program's
``poseidon.permutation.absorb_permute`` on kernel 1), among all absorbed
lanes: those and the lanes of the ``sponge.absorb`` spans, where PyTorch
ops add the rows before a separate permutation launch.  Counted by the
spans' lanes, not timed.  Read from the program's spans
(``sponge_tpu_torch.utils.profiling.spans``); None without them or without
any absorb."""

from sponge_tpu_torch.utils import profiling


def read(ctx):
    spans = profiling.spans() if hasattr(profiling, "spans") else []
    fused = sum(s["count"] or 0 for s in spans if s["name"] == "sponge.absorb_fused")
    apart = sum(s["count"] or 0 for s in spans if s["name"] == "sponge.absorb")
    if fused + apart <= 0:
        return None
    return 100.0 * fused / (fused + apart)
