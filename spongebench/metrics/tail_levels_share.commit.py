"""Share of the Merkle trees' device time (``merkle.tree`` spans) spent in
the levels that produce fewer than 2^17 nodes (``merkle.level`` spans with
a smaller count): levels narrower than one wave of kernel 1 at (3, 11),
132 SMs x 4 blocks x 128 threads = 67,584 lanes, where a permutation
launch cannot fill the card.  The levels' time runs from CUDA events at
their entry and exit, so the device's idle there counts.  Read from the
program's spans (``sponge_tpu_torch.utils.profiling.spans``); None without
them."""

from sponge_tpu_torch.utils import profiling

NARROW = 1 << 17


def read(ctx):
    spans = profiling.spans() if hasattr(profiling, "spans") else []
    trees = [s["device_us"] for s in spans if s["name"] == "merkle.tree"]
    narrow = [s["device_us"] for s in spans if s["name"] == "merkle.level" and s["count"] < NARROW]
    if not trees or None in trees + narrow or sum(trees) <= 0:
        return None
    return 100.0 * sum(narrow) / sum(trees)
