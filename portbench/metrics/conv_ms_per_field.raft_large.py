"""Device ms of cuDNN's convolution kernels (and their layout transforms)
per flow field, RAFT (large).  The name pattern (``portbench/kernels.py``
``CONV``) also takes cuBLAS's GEMM of the all-pairs product, so this is
the encoders', the updates' and the mask head's convolutions plus the
volume's product."""
from portbench.kernels import is_conv, ms_per_field


def read(ctx):
    return ms_per_field(ctx, is_conv)
