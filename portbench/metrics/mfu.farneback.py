"""Farneback's whole step: the least time of a field (the larger of its
operations at cv2's stage boundaries over the fp32 peak and of its frames
in and flow out over the HBM peak, counts/farneback.py) times the fields
completed in the untraced window, over its length, in %."""
from portbench.counts import least_seconds


def read(ctx):
    if ctx.peak is None or ctx.host.fields == 0:
        return None
    return 100.0 * least_seconds(ctx.counts["flops"], ctx.counts["bytes"],
                                 ctx.peak) * ctx.host.fields / ctx.host.window_s
