"""Launches (kernels, copies, memsets) the host makes inside the program's
``ofc.raft.lookup`` spans (each update's windowed lookup of the packed
pyramid, ``ops/allpairs.py``) per flow field."""
from portbench.spans import launches_per


def read(ctx):
    return launches_per(ctx, "ofc.raft.lookup", ctx.fields)
