"""Median host ms from a frame handed to the backend to its velocity
scalar on the host, over the untraced window's frames."""
import numpy as np


def read(ctx):
    if not ctx.host.latency_s:
        return None
    return 1e3 * float(np.median(ctx.host.latency_s))
