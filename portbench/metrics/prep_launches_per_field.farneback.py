"""Launches (kernels, copies, memsets) the host makes inside the program's
``ofc.farneback.prep`` spans (each pyramid level's blur, resize and
polynomial expansion) per flow field."""
from portbench.spans import launches_per


def read(ctx):
    return launches_per(ctx, "ofc.farneback.prep", ctx.fields)
