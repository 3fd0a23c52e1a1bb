"""Median length (ms, the trace's clock) of the program's
``ofc.stream.step`` spans: a frame's enqueue, from the stream's ``step``
call up to its unsynced du."""
from portbench.spans import median_ms


def read(ctx):
    return median_ms(ctx, "ofc.stream.step")
