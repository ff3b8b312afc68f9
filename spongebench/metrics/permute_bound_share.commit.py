"""The least time of the permutations the program counted (the lanes of
its ``sponge.permute`` spans, summed) at the card's integer peaks (the
family's ``permutations_bound_s``), over those spans' device time: the
in-program counterpart of ``perm_bound_share.commit``.  A span's device
time runs between CUDA events at its entry and exit, so it holds the
launch's latency on a starved device as well as the kernel.  Read from the
program's spans (``sponge_tpu_torch.utils.profiling.spans``); None without
them or without the card's peaks."""

from spongebench.roofline import PEAKS
from sponge_tpu_torch.utils import profiling


def read(ctx):
    peaks = PEAKS.get(ctx.device)
    spans = profiling.spans() if hasattr(profiling, "spans") else []
    calls = [s for s in spans if s["name"] == "sponge.permute"]
    if peaks is None or not calls or any(s["device_us"] is None for s in calls):
        return None
    device_us = sum(s["device_us"] for s in calls)
    if device_us <= 0:
        return None
    bound_s = ctx.family.permutations_bound_s(peaks, ctx.config, sum(s["count"] for s in calls))
    return 100.0 * bound_s / (device_us * 1e-6)
