"""Colour conversion for the frame-ingest stage (reference ``core/color.py``)."""
from __future__ import annotations

import torch

# ITU-R BT.601 luma weights, what cv2.cvtColor(COLOR_BGR2GRAY) uses
_BT601 = (0.299, 0.587, 0.114)


def bgr_to_gray(img: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] BGR -> [..., H, W] luma, in the input's float dtype."""
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    return _BT601[0] * r + _BT601[1] * g + _BT601[2] * b
