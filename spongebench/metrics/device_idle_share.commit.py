"""Share of the traced window in which nothing ran on the device: one
minus the union of its kernel, copy and fill intervals."""


def read(ctx):
    window = ctx.trace.window_us
    if window <= 0 or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us() / window)
