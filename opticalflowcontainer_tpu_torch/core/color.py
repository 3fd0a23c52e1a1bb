"""Colour conversion and normalization for the frame-ingest stage
(reference ``core/color.py``)."""
from __future__ import annotations

import math

import torch

# ITU-R BT.601 luma weights, what cv2.cvtColor(COLOR_BGR2GRAY) uses
_BT601 = (0.299, 0.587, 0.114)


def bgr_to_rgb(img: torch.Tensor) -> torch.Tensor:
    """Channel flip on the trailing dim ([..., H, W, 3])."""
    return img.flip(-1)


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] RGB -> [..., H, W] luma, the BT.601 terms summed in the
    reference's order (R, G, B), in the input's float dtype."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    return _BT601[0] * r + _BT601[1] * g + _BT601[2] * b


def bgr_to_gray(img: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] BGR -> [..., H, W] luma, in the input's float dtype."""
    b, g, r = img[..., 0], img[..., 1], img[..., 2]
    return _BT601[0] * r + _BT601[1] * g + _BT601[2] * b


def normalize_image(img: torch.Tensor, scale: float = 1.0 / 255.0,
                    mean: tuple[float, ...] | None = None) -> torch.Tensor:
    """``img * scale - mean`` (per channel on the trailing dim) in fp32.
    ``mean=None`` skips the subtraction; the models that subtract each
    image's own mean (LFN3) do that inside their forward."""
    out = img.float() * scale
    if mean is not None:
        out = out - torch.tensor(mean, dtype=torch.float32, device=out.device)
    return out


def flow_to_hsv_rgb(flow: torch.Tensor, max_mag: float | None = None) -> torch.Tensor:
    """Dense-flow HSV visualization (hue = angle, value = magnitude) of
    [..., H, W, 2] flow as float RGB [..., H, W, 3] in [0, 1] (reference
    ``core/color.py:44``).  The angle follows cv2.cartToPolar: [0, 2 pi)
    from +x, so rightward flow is hue 0, red.  ``max_mag=None`` scales the
    value by each field's largest magnitude."""
    u, v = flow[..., 0].float(), flow[..., 1].float()
    mag = torch.sqrt(u * u + v * v)
    ang = torch.atan2(v, u)  # [-pi, pi]
    ang = torch.where(ang < 0, ang + 2.0 * math.pi, ang)
    hue = ang / (2.0 * math.pi)
    if max_mag is None:
        denom = mag.amax(dim=(-2, -1), keepdim=True).clamp_min(1e-6)
    else:
        denom = max_mag
    val = (mag / denom).clamp(0.0, 1.0)
    # HSV -> RGB at saturation 1: p = 0, q = val (1 - f), t = val f, each
    # formed as the reference forms it (t as val (1 - (1 - f))) so that
    # both round alike
    h6 = hue * 6.0
    i = torch.floor(h6)
    f = h6 - i
    p = torch.zeros_like(val)
    q = val * (1.0 - f)
    t = val * (1.0 - (1.0 - f))
    sector = i.to(torch.int64) % 6
    table = ((val, t, p), (q, val, p), (p, val, t), (p, q, val), (t, p, val),
             (val, p, q))
    out = []
    for c in range(3):
        ch = p
        for s in range(6):
            ch = torch.where(sector == s, table[s][c], ch)
        out.append(ch)
    return torch.stack(out, dim=-1)
