"""Seconds from the process's start to the window: imports, the program's
kernel library, parameters, inputs from the seed and the warm jobs."""


def read(ctx):
    return ctx.setup_s
