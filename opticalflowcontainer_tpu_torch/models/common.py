"""Building blocks shared by the model zoo (reference ``models/common.py``).

torch-parity notes that converted weights depend on:

- :class:`Conv` pads ``(k // 2) * dilation`` on every side explicitly, as
  the reference's flax ``Conv`` does (XLA ``SAME`` would pad a strided conv
  of an even input (0, 1) and shift it by one pixel).
- :class:`Deconv` is ``ConvTranspose2d(kernel=4, stride=2, padding=1)``.
  The reference stores its kernel as the spatially flipped HWIO kernel of
  the equivalent input-dilated conv; ``models/convert.py`` carries it back.

Layout: NCHW activations, torch's OIHW / IOHW weights.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def leaky(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=slope)


class Conv(nn.Conv2d):
    """Conv2d with the reference's explicit symmetric padding.  Its weights
    come from the flax key ``<path>/Conv_0``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, padding: int | None = None,
                 dilation: int = 1, bias: bool = True):
        p = padding if padding is not None else (kernel // 2) * dilation
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=p,
                         dilation=dilation, bias=bias)


class Deconv(nn.ConvTranspose2d):
    """2x upsampling transposed conv, torch ``ConvTranspose2d(kernel=4,
    stride=2, padding=1)``.  Its weights come from the flax key ``<path>``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 4,
                 bias: bool = True):
        super().__init__(in_ch, out_ch, kernel, stride=2, padding=1, bias=bias)
