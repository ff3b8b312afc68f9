"""Share of the tree's tagged nodes (the ``merkle.tagged`` spans' counts,
the program's ``hash.compress_children``) whose sponge step ran in one
launch, the tag folded into its first round's constants: the lanes of the
``sponge.absorb_fused`` spans directly inside a ``merkle.tagged`` span.
100 when every node is that launch, 0 where the rows are added apart
(``sponge.absorb``, a zero state built and tagged before the permutation).
Counted, not timed.  Read from the program's spans
(``sponge_tpu_torch.utils.profiling.spans``); None without them or without
any tagged node."""

from sponge_tpu_torch.utils import profiling


def read(ctx):
    spans = profiling.spans() if hasattr(profiling, "spans") else []
    tagged = {i for i, s in enumerate(spans) if s["name"] == "merkle.tagged"}
    nodes = sum(spans[i]["count"] or 0 for i in tagged)
    fused = sum(s["count"] or 0 for s in spans if s["name"] == "sponge.absorb_fused" and s["parent"] in tagged)
    if nodes <= 0:
        return None
    return 100.0 * fused / nodes
