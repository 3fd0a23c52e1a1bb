"""Device ms per flow field of every Farneback kernel that is not K1 or K2:
the prep stage (blur, resize, expansion), the flow's resizes between
levels, the frames' conversion and the output's stack."""
from portbench.kernels import K1, K2, ms_per_field, named

_k12 = named(K1 + K2)


def read(ctx):
    return ms_per_field(ctx, lambda n: not _k12(n))
