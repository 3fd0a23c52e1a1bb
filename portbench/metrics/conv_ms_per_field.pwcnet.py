"""Device ms of cuDNN's convolution kernels (and their layout transforms)
per flow field, PWC-Net."""
from portbench.kernels import is_conv, ms_per_field


def read(ctx):
    return ms_per_field(ctx, is_conv)
