"""Image pyramids (reference ``core/pyramid.py``).

- :func:`pyr_down` / :func:`gaussian_pyramid`: cv2-parity pyrDown, the
  5-tap binomial kernel [1, 4, 6, 4, 1] / 16 with a REFLECT_101 border, then
  every second pixel: what ``cv2.buildOpticalFlowPyramid`` feeds the
  Lucas-Kanade tracker.
- :func:`image_pyramid_resize`: successive bilinear resizes to dims // 2**k
  of the input, the models' style of image pyramid.

Images are [..., H, W] float tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from .filters import _sepconv
from .resize import resize_bilinear

_PYR_KERNEL = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """``cv2.pyrDown`` parity: the binomial blur, then every second pixel
    from the first, so the output is ceil(H / 2) x ceil(W / 2)."""
    blurred = _sepconv(img, _PYR_KERNEL, _PYR_KERNEL, "reflect101")
    return blurred[..., ::2, ::2].contiguous()


def gaussian_pyramid(img: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """``levels`` images: level 0 is the input (as fp32), each next level
    the pyr_down of the one before."""
    pyr = [img.float()]
    for _ in range(levels - 1):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def image_pyramid_resize(img: torch.Tensor, levels: int,
                         align_corners: bool = False) -> list[torch.Tensor]:
    """Bilinear half-resolution pyramid: level k is the previous level
    resized to the input's H // 2**k x W // 2**k."""
    H, W = img.shape[-2], img.shape[-1]
    pyr = [img]
    for k in range(1, levels):
        pyr.append(resize_bilinear(pyr[-1], (H // 2**k, W // 2**k),
                                   align_corners=align_corners))
    return pyr
