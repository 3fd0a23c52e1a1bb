"""K3's share of its roofline: the least time of its operations and bytes
(counts/) over the device time of its kernels."""
from portbench.kernels import K3, named, roofline

_match = named(K3)


def read(ctx):
    return roofline(ctx, "k3", _match)
