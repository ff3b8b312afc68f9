"""Leaves of every commitment completed in the window over the window's
wall time up to the last completion: a prover's throughput."""


def read(ctx):
    return sum(r.units for r in ctx.jobs) / ctx.seconds
