"""Share of the device's busy time spent in anything but the port's
permutation kernels (``trace.PERMUTATION_KERNELS``): PyTorch's adds,
concatenations, fills and gathers, copies, and any kernel a later change
adds around the permutations, such as a fused absorb."""


def read(ctx):
    busy = ctx.trace.busy_us()
    if busy <= 0:
        return None
    return 100.0 * ctx.trace.busy_us(ctx.trace.glue()) / busy
