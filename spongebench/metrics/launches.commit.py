"""CUDA kernel launches per job, counted in the trace."""


def read(ctx):
    kernels = ctx.trace.kernels()
    return len(kernels) / ctx.jobs if kernels else None
