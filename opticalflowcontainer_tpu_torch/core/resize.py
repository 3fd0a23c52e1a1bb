"""Bilinear resize with half-pixel centres (reference ``core/resize.py``).

src = (dst + 0.5) * src_n / dst_n - 0.5, edge clamped: the convention of
cv2.resize(INTER_LINEAR) and torch interpolate(align_corners=False), which
the Farneback pyramid and the inter-level flow resize use.  Gather form: one
``index_select`` pair and a lerp per axis, fp32.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def _taps(src: int, dst: int, device: torch.device):
    """(lower index, upper index, upper weight) of each output position,
    kept on ``device``: an upload per call would synchronize the stream."""
    # fp32 coordinates, as the reference computes them on the device
    i = np.arange(dst, dtype=np.float64)
    c = ((i + 0.5) * (src / dst) - 0.5).astype(np.float32)
    c0 = np.floor(c)
    w1 = c - c0
    c0i = c0.astype(np.int64)
    return tuple(torch.from_numpy(a).to(device) for a in (
        np.clip(c0i, 0, src - 1), np.clip(c0i + 1, 0, src - 1), w1))


def _resize_axis(x: torch.Tensor, dim: int, dst: int) -> torch.Tensor:
    src = x.shape[dim]
    if src == dst:
        return x
    lo, hi, w1 = _taps(src, dst, x.device)
    a = x.index_select(dim, lo)
    b = x.index_select(dim, hi)
    shape = [1] * x.dim()
    shape[dim] = dst
    w1 = w1.reshape(shape)
    return a * (1 - w1) + b * w1


def resize_bilinear(img: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Resize the trailing two dims of a float [..., H, W] tensor to
    ``size = (H', W')``."""
    out = _resize_axis(img, img.dim() - 2, size[0])
    return _resize_axis(out, img.dim() - 1, size[1])
