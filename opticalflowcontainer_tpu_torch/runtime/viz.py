"""Debug visualization (the port's copy of the reference's
``runtime/viz.py`` ``flow_to_bgr``): the dense HSV flow image the flow node
publishes on ``/optical_flow/image_flow``.  The reference's arrow overlays
draw with cv2 and are not ported yet (ROADMAP module item 3)."""
from __future__ import annotations

import numpy as np
import torch

from ..core.color import flow_to_hsv_rgb


def flow_to_bgr(flow, max_mag: float | None = None) -> np.ndarray:
    """[H, W, 2] flow (numpy or tensor) -> uint8 BGR [H, W, 3] on the host:
    hue = direction, value = magnitude (scaled by the field's largest one
    when ``max_mag`` is None)."""
    f = flow if isinstance(flow, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(flow, np.float32))
    rgb = flow_to_hsv_rgb(f, max_mag).cpu().numpy()
    return (rgb[..., ::-1] * 255).astype(np.uint8)
