"""Kernel 5's share of its roofline: the least time of the traced jobs'
permutations at the card's integer peaks (the family's
``permutations_bound_s``: Rescue's own products at two words an element,
the inverse S-box's chain among them), over the time of the port's
permutation kernels in the trace (``trace.PERMUTATION_KERNELS``,
``rescue_kernel`` among them).  Keyed by the configuration, so any body
that computes the same permutation is held to the same work."""

from spongebench.roofline import PEAKS


def read(ctx):
    peaks = PEAKS.get(ctx.device)
    perm_us = ctx.trace.busy_us(ctx.trace.permutation_kernels())
    if peaks is None or perm_us <= 0:
        return None
    bound_s = ctx.family.permutations_bound_s(peaks, ctx.config, ctx.permutations * ctx.jobs)
    return 100.0 * bound_s / (perm_us * 1e-6)
