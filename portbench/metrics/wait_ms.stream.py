"""Median length (ms, the trace's clock) of the program's
``ofc.stream.wait`` spans: the backend's host blocked on the card for a
frame's du after the step returned."""
from portbench.spans import median_ms


def read(ctx):
    return median_ms(ctx, "ofc.stream.wait")
