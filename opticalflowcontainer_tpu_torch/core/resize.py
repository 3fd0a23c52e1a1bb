"""Resizes.  Bilinear with an explicit grid convention (reference
``core/resize.py``), cv2's INTER_AREA and INTER_NEAREST for the flow
node's fixed net size, and PIL's BICUBIC for the comparison GIF (below).

Bilinear, gather form (one ``index_select`` pair and a lerp per axis, fp32):

- half-pixel centres (the default): src = (dst + 0.5) * src_n / dst_n - 0.5,
  edge clamped: the convention of cv2.resize(INTER_LINEAR) and torch
  interpolate(align_corners=False), which the Farneback pyramid, the
  inter-level flow resize and the models' estimate contract use;
- ``align_corners=True``: src = dst * (src_n - 1) / (dst_n - 1), torch
  interpolate(align_corners=True), for the resize pyramid of
  :func:`~.pyramid.image_pyramid_resize`.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .device import cached_tensors


@cached_tensors(256)
def _taps(src: int, dst: int, device: torch.device, align_corners: bool = False):
    """(lower index, upper index, upper weight) of each output position,
    kept on ``device``: an upload per call would synchronize the stream."""
    i = np.arange(dst, dtype=np.float64)
    if align_corners and dst > 1:
        c = i * ((src - 1) / (dst - 1))
    else:
        c = (i + 0.5) * (src / dst) - 0.5
    # fp32 coordinates, as the reference computes them on the device
    c = c.astype(np.float32)
    c0 = np.floor(c)
    w1 = c - c0
    c0i = c0.astype(np.int64)
    return tuple(torch.from_numpy(a).to(device) for a in (
        np.clip(c0i, 0, src - 1), np.clip(c0i + 1, 0, src - 1), w1))


def _resize_axis(x: torch.Tensor, dim: int, dst: int,
                 align_corners: bool) -> torch.Tensor:
    src = x.shape[dim]
    if src == dst:
        return x
    lo, hi, w1 = _taps(src, dst, x.device, align_corners)
    a = x.index_select(dim, lo)
    b = x.index_select(dim, hi)
    shape = [1] * x.dim()
    shape[dim] = dst
    # the weights in the image's dtype, as the reference (bf16 stays bf16)
    w1 = w1.reshape(shape).to(x.dtype)
    return a * (1 - w1) + b * w1


def resize_bilinear(img: torch.Tensor, size: tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Resize the trailing two dims of a float [..., H, W] tensor to
    ``size = (H', W')``, half-pixel centres unless ``align_corners``, in
    the tensor's dtype."""
    out = _resize_axis(img, img.dim() - 2, size[0], align_corners)
    return _resize_axis(out, img.dim() - 1, size[1], align_corners)


# ------------------------------------------------ cv2 INTER_AREA / NEAREST
# The flow node resizes frames to a fixed net size with cv2.resize
# (reference runtime/nodes.py:226-244): INTER_AREA for the frame,
# INTER_NEAREST for the junction mask.  These are the port's own versions,
# on [H, W] or [H, W, C] numpy arrays or tensors (cv2's layout), sizes given
# as (H', W').

def _area_taps(src: int, dst: int) -> list[list[tuple[int, float]]]:
    """(source index, weight) of each output position of an area
    downscale, scale = src / dst >= 1: each source pixel weighted by its
    overlap with the output cell (cv2 computeResizeAreaTab, double
    arithmetic, float weights)."""
    scale = src / dst
    taps = []
    for d in range(dst):
        fs1 = d * scale
        fs2 = fs1 + scale
        cell = min(scale, src - fs1)
        s2 = min(math.floor(fs2), src - 1)
        s1 = min(math.ceil(fs1), s2)
        row = []
        if s1 - fs1 > 1e-3:
            row.append((s1 - 1, (s1 - fs1) / cell))
        row.extend((s, 1.0 / cell) for s in range(s1, s2))
        if fs2 - s2 > 1e-3:
            row.append((s2, min(fs2 - s2, 1.0, cell) / cell))
        taps.append(row)
    return taps


def _area_linear_taps(src: int, dst: int) -> list[list[tuple[int, float]]]:
    """Two taps of each output position where INTER_AREA upscales an axis:
    cv2's bilinear resize with its area coefficients (the left tap's weight
    is the part of the output cell before the next source pixel)."""
    scale, inv = src / dst, dst / src
    taps = []
    for d in range(dst):
        s = math.floor(d * scale)
        f = (d + 1) - (s + 1) * inv
        f = 0.0 if f <= 0 else f - math.floor(f)
        if s < 0:
            s, f = 0, 0.0
        if s >= src - 1:
            s, f = src - 1, 0.0
        taps.append([(s, 1.0 - f), (min(s + 1, src - 1), f)])
    return taps


@functools.lru_cache(maxsize=64)
def _tap_table(src: int, dst: int, area: bool) -> tuple[np.ndarray, np.ndarray]:
    """The taps as an index table [dst, K] and fp32 weights [dst, K], short
    rows padded with weight 0."""
    taps = _area_taps(src, dst) if area else _area_linear_taps(src, dst)
    k = max(len(t) for t in taps)
    idx = np.zeros((dst, k), np.int64)
    w = np.zeros((dst, k), np.float32)
    for d, row in enumerate(taps):
        for j, (s, a) in enumerate(row):
            idx[d, j], w[d, j] = s, a
    return idx, w


def _as_tensor(img) -> tuple[torch.Tensor, bool]:
    if isinstance(img, torch.Tensor):
        return img, False
    return torch.from_numpy(np.ascontiguousarray(img)), True


def _resize_taps(x: torch.Tensor, dim: int, idx: np.ndarray,
                 w: np.ndarray) -> torch.Tensor:
    """Sum over taps k of w[:, k] * x[idx[:, k]] along ``dim``, in tap
    order, in fp32."""
    shape = [1] * x.dim()
    shape[dim] = idx.shape[0]
    out = None
    for k in range(idx.shape[1]):
        i = torch.from_numpy(idx[:, k]).to(x.device)
        wk = torch.from_numpy(w[:, k]).to(x.device).reshape(shape)
        term = x.index_select(dim, i) * wk
        out = term if out is None else out + term
    return out


def resize_area(img, size: tuple[int, int]):
    """cv2.resize(img, (W', H'), interpolation=INTER_AREA) of a float
    [H, W] or [H, W, C] image, as fp32: numpy in, numpy out; a tensor stays
    on its device.  Downscaling weights each source pixel by its overlap
    with the output pixel (a box mean for an integer factor); where either
    axis upscales, cv2's bilinear form with area coefficients, on both
    axes, as cv2 does.  Horizontal pass, then vertical."""
    x, was_numpy = _as_tensor(img)
    x = x.float()
    (H, W), (h, w) = x.shape[:2], size
    area = H >= h and W >= w
    out = _resize_taps(x, 1, *_tap_table(W, w, area)) if W != w else x
    out = _resize_taps(out, 0, *_tap_table(H, h, area)) if H != h else out
    return out.numpy() if was_numpy else out


def resize_nearest(img, size: tuple[int, int]):
    """cv2.resize(img, (W', H'), interpolation=INTER_NEAREST) of an [H, W]
    or [H, W, C] image of any dtype: source index floor(d * src / dst)
    (cv2's double arithmetic), clamped to the last pixel.  numpy in, numpy
    out; a tensor stays on its device."""
    x, was_numpy = _as_tensor(img)
    out = x
    for dim, dst in ((1, size[1]), (0, size[0])):
        src = x.shape[dim]
        ifx = 1.0 / (dst / src)
        i = [min(math.floor(d * ifx), src - 1) for d in range(dst)]
        out = out.index_select(dim, torch.tensor(i, device=x.device))
    return out.numpy() if was_numpy else out


def _pil_bicubic(x: float) -> float:
    """PIL's bicubic kernel (a = -0.5, support 2)."""
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _pil_taps(src: int, dst: int) -> tuple[np.ndarray, np.ndarray]:
    """PIL's ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` for
    BICUBIC: each output's source indices [dst, k] and 22-bit fixed-point
    weights [dst, k] (0 past the output's last tap)."""
    scale = src / dst
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    idx = np.zeros((dst, ksize), np.int64)
    w = np.zeros((dst, ksize), np.int64)
    for xx in range(dst):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), src) - xmin
        k = [_pil_bicubic((x + xmin - center + 0.5) / filterscale)
             for x in range(xmax)]
        ww = sum(k)
        for x, kx in enumerate(k):
            kx = kx / ww if ww != 0.0 else kx
            w[xx, x] = int(-0.5 + kx * (1 << 22)) if kx < 0 else int(
                0.5 + kx * (1 << 22))
            idx[xx, x] = xmin + x
    return idx, w


def resize_bicubic_pil(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``PIL.Image.resize((W', H'), Image.BICUBIC)`` of a uint8 [H, W] or
    [H, W, C] image: the kernel widened by the scale when shrinking, 22-bit
    fixed-point taps, a horizontal pass rounded to uint8 and then a
    vertical one, as ``ImagingResample`` computes them (numpy, on the
    host)."""
    x = np.asarray(img)
    if x.dtype != np.uint8:
        raise ValueError(f"expected a uint8 image, got {x.dtype}")
    (H, W), (h, w) = x.shape[:2], size
    out = x.astype(np.int64)
    for axis, src, dst in ((1, W, w), (0, H, h)):
        if src == dst:
            continue
        idx, wt = _pil_taps(src, dst)
        taps = np.take(out, idx, axis=axis)  # [.., dst, k, ..]
        shape = [1] * taps.ndim
        shape[axis], shape[axis + 1] = dst, idx.shape[1]
        acc = (1 << 21) + (taps * wt.reshape(shape)).sum(axis=axis + 1)
        out = np.clip(acc >> 22, 0, 255)
    return out.astype(np.uint8)
