"""The 90th percentile of one commitment's host-clock time, from leaves on
the device to root and openings on the host, over every commitment of the
window."""

import numpy as np


def read(ctx):
    return float(np.percentile([r.ms for r in ctx.jobs], 90))
