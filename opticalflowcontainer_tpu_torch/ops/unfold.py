"""Neighbourhoods of each pixel: the distance-weighted neighbourhood sum of
LiteFlowNet's and LFN3's Regularization (reference ``ops/unfold.py``
``unfold`` and ``models/liteflownet.py:124-130``), and the k x k patch stack
itself (:func:`unfold`), which the convex upsampler of RAFT and NeuFlow-v2
takes.

The reference unfolds the flow into its k x k neighbourhoods ([H, W, k*k,
2]), multiplies by the k*k distance weights and reduces with a 1x1 conv
(``scale_x`` / ``scale_y``).  Here the same sum runs tap by tap over one
zero-padded copy of the flow, so the k*k stack is never materialized.  The
reference computes it in XLA, outside any Pallas kernel, so it stays plain
PyTorch on every device, as does :func:`unfold`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def neighbourhood_sum(x: torch.Tensor, weights: torch.Tensor,
                      taps: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """out[b, c, p] = sum_j taps[c, j] * weights[b, j, p] * x[b, c, p + o_j]
    + bias[c].

    ``x`` [B, C, H, W], ``weights`` [B, k*k, H, W], ``taps`` [C, k*k],
    ``bias`` [C].  Tap j sits at offset o_j = (j // k - k // 2, j % k -
    k // 2) in (y, x), the reference unfold's row-major order; x is zero
    outside the image."""
    B, C, H, W = x.shape
    kk = weights.shape[1]
    k = int(round(kk ** 0.5))
    if k * k != kk or k % 2 == 0 or taps.shape != (C, kk):
        raise ValueError(f"weights {tuple(weights.shape)} and taps "
                         f"{tuple(taps.shape)} do not make an odd k x k "
                         f"window over {C} channels")
    p = k // 2
    xp = F.pad(x, (p, p, p, p))
    taps = taps.reshape(1, C, kk, 1, 1)
    acc = None
    for j in range(kk):
        dy, dx = divmod(j, k)
        w = weights[:, j:j + 1] * taps[:, :, j]
        term = xp[:, :, dy:dy + H, dx:dx + W]
        acc = term * w if acc is None else acc.addcmul_(term, w)
    return acc + bias.reshape(1, C, 1, 1)


def unfold(x: torch.Tensor, ksize: int, padding: int | None = None) -> torch.Tensor:
    """[..., C, H, W] -> [..., C, k*k, H, W]: the zero-padded k x k
    neighbourhood of each pixel (reference ``ops/unfold.py`` ``unfold``, in
    channels-first layout), patch index dy * k + dx; padding k // 2 by
    default keeps the spatial dims."""
    if padding is None:
        padding = ksize // 2
    H, W = x.shape[-2], x.shape[-1]
    xp = F.pad(x, (padding, padding, padding, padding))
    return torch.stack([xp[..., dy:dy + H, dx:dx + W]
                        for dy in range(ksize) for dx in range(ksize)], dim=-3)
