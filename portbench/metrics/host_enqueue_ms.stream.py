"""Median host ms of the stream's ``step`` up to its return, before the
host waits for the scalar: the launches of one frame, over the untraced
window's frames."""
import numpy as np


def read(ctx):
    if not ctx.host.enqueue_s:
        return None
    return 1e3 * float(np.median(ctx.host.enqueue_s))
