"""K4's share of its roofline: the least time of its operations and bytes
(counts/) over the device time of its kernels."""
from portbench.kernels import K4, named, roofline

_match = named(K4)


def read(ctx):
    return roofline(ctx, "k4", _match)
