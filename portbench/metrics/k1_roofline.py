"""K1's share of its roofline: the least time of its operations and bytes
(counts/) over the device time of its kernels."""
from portbench.kernels import K1, named, roofline

_match = named(K1)


def read(ctx):
    return roofline(ctx, "k1", _match)
