"""The four cv2 operations behind the eval's affine pair generators
(reference ``eval/datasets.py``), as host code: the pairs are host data, as
cv2's are.

- :func:`gaussian_blur`: ``cv2.GaussianBlur(img, (0, 0), sigma)`` on float32
  images: the kernel size from sigma by OpenCV's rule for float depths
  (``cvRound(8 sigma + 1) | 1``), reflect-101 border, through the port's
  separable filter.
- :func:`rotation_matrix_2d`: ``cv2.getRotationMatrix2D`` in closed form.
- :func:`warp_affine_linear`: ``cv2.warpAffine`` with INTER_LINEAR and
  BORDER_CONSTANT 0 on float32 images, as OpenCV 5 computes it (below).
- :func:`copy_make_border_reflect101`: ``cv2.copyMakeBorder`` with
  BORDER_REFLECT_101.

OpenCV 5's linear warp of float32 images does not round source positions to
1/32 px as OpenCV 4.10 and earlier did (INTER_BITS fixed point); it
computes them in float32.  The matrix is inverted in double and cast to
float32 (m0..m5).  In its vector loop, 16 destination columns at a time, a
pixel's source x is ``fma(m0, x, float(y * m1 + m2))``.  The last
``W % 16`` columns of a row go through a scalar loop, where it is
``fma(m0, x, y * m1) + m2``; y is formed the same way from m3..m5.  The
pixel is then ``v0 + b (v1 - v0)``, with ``v0 = p00 + a (p01 - p00)``,
``v1 = p10 + a (p11 - p10)``, and a, b the fractional parts.  Each of those
is one float32 fma; a tap outside the image reads 0.  This module computes
the same thing.  Each fma is formed in float64 and rounded once to float32,
which equals the fused result except where the float64 sum itself rounds,
and the 16-column split is OpenCV's x86 AVX2 dispatch.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .filters import _sepconv, gaussian_kernel_1d

# destination columns of OpenCV's vectorized warp loop (two 8-lane float
# registers); the row's remaining columns take its scalar loop
_CV_VECTOR_COLUMNS = 16


def gaussian_blur(img, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, (0, 0), sigma)`` of a float image [H, W] or
    [H, W, C] (the channels blurred apart), float32 out."""
    ksize = int(np.rint(sigma * 8 + 1)) | 1
    k = gaussian_kernel_1d(ksize, sigma)
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    if x.dim() == 3:
        return _sepconv(x.permute(2, 0, 1), k, k, "reflect101").permute(
            1, 2, 0).contiguous().numpy()
    return _sepconv(x, k, k, "reflect101").numpy()


def rotation_matrix_2d(center, angle_deg: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle_deg, scale)``: the float64
    [2, 3] matrix rotating by ``angle_deg`` counter-clockwise about
    ``center`` (taken as float32, cv2's Point2f) and scaling by ``scale``."""
    cx, cy = (float(np.float32(c)) for c in center)
    angle = angle_deg * math.pi / 180.0
    alpha = math.cos(angle) * scale
    beta = math.sin(angle) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def _invert_affine(M) -> np.ndarray:
    """cv2's inverse of the [2, 3] affine ``M`` (``invertAffineTransform``'s
    arithmetic, in its order), as 6 float64."""
    m = np.asarray(M, np.float64).reshape(6).copy()
    D = m[0] * m[4] - m[1] * m[3]
    D = 1.0 / D if D != 0 else 0.0
    a11, a22 = m[4] * D, m[0] * D
    m[0] = a11
    m[1] *= -D
    m[3] *= -D
    m[4] = a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


def _fma32(a, b, c) -> np.ndarray:
    """float32 a * b + c with one rounding (the product of two float32 is
    exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _source_axis(mx, my, mc, W: int, H: int) -> np.ndarray:
    """One source coordinate [H, W] float32 of OpenCV 5's warp (module
    docstring): the vector loop's form, then the scalar tail's."""
    x = np.arange(W, dtype=np.float32)[None, :]
    y = np.arange(H, dtype=np.float32)[:, None]
    mx, my, mc = np.float32(mx), np.float32(my), np.float32(mc)
    vec = _fma32(mx, x, y * my + mc)
    tail = _fma32(mx, x, y * my) + mc
    split = (W // _CV_VECTOR_COLUMNS) * _CV_VECTOR_COLUMNS
    return np.where(np.arange(W)[None, :] < split, vec, tail)


def warp_affine_linear(img, M, dsize) -> np.ndarray:
    """``cv2.warpAffine(img, M, dsize)`` with INTER_LINEAR and a constant 0
    border: dst(x, y) = img(M^-1 (x, y)), bilinear, for a float32 image
    [H, W] or [H, W, C]; ``dsize`` is (width, height) as in cv2."""
    src = np.asarray(img, np.float32)
    W, H = int(dsize[0]), int(dsize[1])
    m = _invert_affine(M)
    sx = _source_axis(m[0], m[1], m[2], W, H)
    sy = _source_axis(m[3], m[4], m[5], W, H)
    fx, fy = np.floor(sx), np.floor(sy)
    a, b = sx - fx, sy - fy
    if src.ndim == 3:
        a, b = a[..., None], b[..., None]
    sh, sw = src.shape[:2]
    # two zero pixels around the source: a pixel whose taps all fall
    # outside reads four zeros wherever its index is clamped to
    pad = np.zeros((sh + 4, sw + 4) + src.shape[2:], np.float32)
    pad[2:-2, 2:-2] = src
    ix = np.clip(fx, -2, sw).astype(np.int64) + 2
    iy = np.clip(fy, -2, sh).astype(np.int64) + 2
    p00, p01 = pad[iy, ix], pad[iy, ix + 1]
    p10, p11 = pad[iy + 1, ix], pad[iy + 1, ix + 1]
    v0 = _fma32(a, p01 - p00, p00)
    v1 = _fma32(a, p11 - p10, p10)
    return _fma32(b, v1 - v0, v0)


def copy_make_border_reflect101(img, top: int, bottom: int, left: int,
                                right: int) -> np.ndarray:
    """``cv2.copyMakeBorder(img, top, bottom, left, right,
    cv2.BORDER_REFLECT_101)`` of [H, W] or [H, W, C]."""
    img = np.asarray(img)
    widths = ((top, bottom), (left, right)) + ((0, 0),) * (img.ndim - 2)
    return np.pad(img, widths, mode="reflect")
