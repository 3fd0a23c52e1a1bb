"""The prep stage's share of its roofline: its bytes at the stage's
boundary (counts/farneback.py ``prep``) over the HBM peak, divided by the
device time of every kernel that is not K1 or K2."""
from portbench.kernels import K1, K2, named, roofline

_k12 = named(K1 + K2)


def read(ctx):
    return roofline(ctx, "prep", lambda n: not _k12(n))
