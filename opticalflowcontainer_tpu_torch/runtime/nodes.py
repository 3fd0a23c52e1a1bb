"""Flow-node backends (reference ``runtime/nodes.py``): the learned-model
backend so far."""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..core.device import resolve_device


def make_model_backend(estimate_fn: Callable, bgr_to_rgb: bool = False, *,
                       device=None) -> Callable:
    """Wrap a model ``estimate``-style callable (img1, img2) -> flow as a
    flow-node backend ``(prev, cur, dt) -> flow`` [H, W, 2] numpy.

    The node hands over uint8 BGR frames (``backend.wants_color``); they are
    uploaded as uint8 and turned into float [0, 1] HWC on ``device`` (the
    card unless ``"cpu"`` is asked for).  The models take BGR, so the default
    keeps it; ``bgr_to_rgb=True`` flips the channels for RGB-trained nets.
    Gray frames are stacked to 3 channels.  NaN and Inf in the flow become
    0, as the reference scrubs them."""
    dev = resolve_device(device)

    def prep(frame) -> torch.Tensor:
        x = torch.as_tensor(np.ascontiguousarray(frame)).to(dev)
        x = x.float() / 255.0
        if x.dim() == 2:
            return x[..., None].expand(*x.shape, 3)
        return x.flip(-1) if bgr_to_rgb else x

    def backend(prev, cur, dt):
        flow = estimate_fn(prep(prev), prep(cur))
        return torch.nan_to_num(flow, nan=0.0, posinf=0.0,
                                neginf=0.0).cpu().numpy()

    backend.wants_color = True
    return backend
