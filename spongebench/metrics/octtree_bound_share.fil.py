"""Kernel 1's share of its roofline on Filecoin's tree: the least time of
the traced jobs' permutations at the card's integer peaks (the family's
``permutations_bound_s`` at the configuration's t = 9, alpha 5, 8 + 57
rounds), over the time of the port's permutation kernels in the trace
(``trace.PERMUTATION_KERNELS``): ``perm_bound_share.commit``'s arithmetic.
Keyed by the configuration, so any body that computes the same permutation
is held to the same work."""

from spongebench.roofline import PEAKS


def read(ctx):
    peaks = PEAKS.get(ctx.device)
    perm_us = ctx.trace.busy_us(ctx.trace.permutation_kernels())
    if peaks is None or perm_us <= 0:
        return None
    bound_s = ctx.family.permutations_bound_s(peaks, ctx.config, ctx.permutations * ctx.jobs)
    return 100.0 * bound_s / (perm_us * 1e-6)
