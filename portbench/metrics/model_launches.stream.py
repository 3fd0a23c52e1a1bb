"""Launches (kernels, copies, memsets) the host makes inside the program's
``ofc.model.forward`` spans (the net's forward, between the input and output
resizes) per frame."""
from portbench.spans import launches_per


def read(ctx):
    return launches_per(ctx, "ofc.model.forward", ctx.calls)
