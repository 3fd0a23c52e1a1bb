"""Backward warping: the reference's three conventions (``core/warp.py``).

The model zoo's ``backwarp`` helpers use three sampling grids, and
converted weights are only right with the matching one:

- LiteFlowNet: grid_sample(align_corners=True), zeros padding, which in
  pixel space is exactly ``p + flow`` (:func:`warp_align_corners`);
- LiteFlowNet3: grid_sample(align_corners=False) on a half-pixel grid, an
  effective displacement of flow * (W/(W-1), H/(H-1))
  (:func:`warp_half_pixel`);
- PWC-Net: the pixel warp plus a warped ones channel thresholded at 0.999
  and multiplied in (:func:`warp_with_mask`).

Layout: images ``[B, C, H, W]``, flow ``[B, 2, H, W]`` with channel 0 = u
(x displacement) and 1 = v.  Every warp goes through K3
(``ops/warp_bilinear.py``): the CUDA kernel on the card, its plain version
on the CPU.  The samplers at arbitrary coordinates are plain PyTorch.
"""
from __future__ import annotations

import torch

from ..ops import warp_bilinear as _k3

MASK_THRESHOLD = 0.999


def _sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
            padding: str) -> torch.Tensor:
    """Coordinates [h, w] are shared by the batch; [B, h, w] are per image."""
    if padding not in _k3.PADDINGS:
        raise ValueError(f"padding must be one of {_k3.PADDINGS}, got {padding!r}")
    B = img.shape[0]
    x, y = (c.float().expand(B, *c.shape[-2:]) if c.dim() == 2 else c.float()
            for c in (x, y))
    return _k3.sample_plain(img, x, y, padding)


def sample_bilinear_zeros(img: torch.Tensor, x: torch.Tensor,
                          y: torch.Tensor) -> torch.Tensor:
    """Sample ``img`` [B, C, H, W] at pixel coordinates ``x``, ``y``
    ([h, w] or [B, h, w]); taps outside the image contribute zero, as in
    torch grid_sample(padding_mode="zeros")."""
    return _sample(img, x, y, "zeros")


def sample_bilinear_edge(img: torch.Tensor, x: torch.Tensor,
                         y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample with the coordinate clamped into the image (border
    replicate), as the classical-flow stack samples."""
    return _sample(img, x, y, "edge")


def warp_bilinear(img: torch.Tensor, flow: torch.Tensor,
                  padding: str = "zeros") -> torch.Tensor:
    """out(p) = img(p + flow(p)), flow in raw pixels (K3)."""
    return _k3.warp_bilinear(img, flow[:, 0].float(), flow[:, 1].float(),
                             padding)


def warp_align_corners(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """LiteFlowNet convention: align_corners=True maps normalized
    coordinates onto pixel centres, so the warp is the pixel warp."""
    return warp_bilinear(img, flow, padding="zeros")


def warp_half_pixel(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """LiteFlowNet3 convention: the half-pixel grid scales the displacement
    by W/(W-1) in x and H/(H-1) in y."""
    H, W = img.shape[-2:]
    sx = W / (W - 1.0) if W > 1 else 1.0
    sy = H / (H - 1.0) if H > 1 else 1.0
    # Python scalars are rounded to fp32 first, as the reference's fp32 scale
    return _k3.warp_bilinear(img, flow[:, 0].float() * sx,
                             flow[:, 1].float() * sy, "zeros")


def warp_with_mask(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """PWC-Net convention: the zeros-padded pixel warp, gated by (warped
    ones channel > 0.999), which K3 computes from the tap weights."""
    return _k3.warp_bilinear(img, flow[:, 0].float(), flow[:, 1].float(),
                             "zeros", mask_threshold=MASK_THRESHOLD)


def flow_grid_sample(img: torch.Tensor, grid_xy: torch.Tensor,
                     padding: str = "zeros") -> torch.Tensor:
    """Sample ``img`` [B, C, H, W] at absolute pixel coordinates
    ``grid_xy`` [B, h, w, 2] (x, y) of any spatial shape."""
    return _sample(img, grid_xy[..., 0], grid_xy[..., 1], padding)
