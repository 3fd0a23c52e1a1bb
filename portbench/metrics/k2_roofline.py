"""K2's share of its roofline: the least time of its operations and bytes
(counts/) over the device time of its kernels."""
from portbench.kernels import K2, named, roofline

_match = named(K2)


def read(ctx):
    return roofline(ctx, "k2", _match)
