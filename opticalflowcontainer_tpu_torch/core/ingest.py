"""Batched device-side frame ingest (the port's copy of the reference's
``core/ingest.py``): decode-adjacent preprocessing as one device stage
instead of per-frame host work.

uint8 frames go to the device as uint8 (4x fewer bytes over PCIe than
float32); everything after the copy is device math.  JPEG entropy decoding
stays on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from .color import bgr_to_gray
from .device import resolve_device
from .resize import resize_bilinear


def preprocess_frames(
    frames,
    out_hw: tuple[int, int] | None = None,
    to_gray: bool = False,
    to_rgb: bool = False,
    normalize: bool = True,
    mean: tuple[float, float, float] | None = None,
    *,
    device=None,
) -> torch.Tensor:
    """[B, H, W, 3] uint8 BGR (numpy or tensor) -> preprocessed float32
    batch on ``device`` (the card unless ``"cpu"``).

    - ``to_gray``: BT.601 grayscale -> [B, H', W']
    - ``to_rgb``: channel flip (models trained on RGB)
    - ``out_hw``: bilinear resize (half-pixel, cv2 parity)
    - ``normalize``: /255; ``mean``: per-channel subtraction after that
      (mean values are on the normalized 0-1 scale, so it requires
      ``normalize=True``, and it is per-channel, so incompatible with
      ``to_gray``)
    """
    if mean is not None and to_gray:
        raise ValueError("mean is per-channel; incompatible with to_gray")
    if mean is not None and not normalize:
        raise ValueError(
            "mean values are on the normalized 0-1 scale; subtracting them "
            "from 0-255 pixels would be silently wrong -- set normalize=True")
    dev = resolve_device(device)
    if not isinstance(frames, torch.Tensor):
        frames = torch.from_numpy(np.ascontiguousarray(frames))
    x = frames.to(dev).to(torch.float32)
    if to_gray:
        x = bgr_to_gray(x)
        if out_hw is not None:
            x = resize_bilinear(x, out_hw)
    else:
        if to_rgb:
            x = x.flip(-1)
        if out_hw is not None:
            x = resize_bilinear(x.movedim(-1, -3), out_hw).movedim(-3, -1)
    if normalize:
        x = x * (1.0 / 255.0)
    if mean is not None:
        x = x - torch.tensor(mean, dtype=torch.float32, device=dev)
    return x


def pad_to_multiple(x, mult: int, channel_last: bool = True):
    """Edge-pad the trailing spatial dims of a tensor (or numpy array) up to
    a multiple of ``mult`` (the models' stride contract); returns (padded
    tensor, (H, W) original)."""
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    h_ax = x.dim() - (3 if channel_last else 2)
    H, W = x.shape[h_ax], x.shape[h_ax + 1]
    Hp = -(-H // mult) * mult
    Wp = -(-W // mult) * mult
    if Hp == H and Wp == W:
        return x, (H, W)
    rows = torch.arange(Hp, device=x.device).clamp(max=H - 1)
    cols = torch.arange(Wp, device=x.device).clamp(max=W - 1)
    return x.index_select(h_ax, rows).index_select(h_ax + 1, cols), (H, W)
