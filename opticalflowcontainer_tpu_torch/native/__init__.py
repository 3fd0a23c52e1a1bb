"""Host-side native components: :func:`detect_junctions`, the fishnet
junction-point detector (the port's copy of the reference's ``native``
package).

The detector stays on the host, as in the reference: contour tracing does
not map onto the card.  It has two forms of one pipeline:

- compiled (the default): ``ops/csrc/junction_detect.cpp``, host C++ with
  no OpenCV, built by the same single ``nvcc`` call as the CUDA kernels
  (``ops/_build.py``) and called through ``ctypes``;
- plain (``force_python=True``): the same steps in numpy on
  :mod:`..core.contours`, the port's copies of the cv2 calls of the
  reference's fallback.

Nothing falls back: when the library cannot be built the compiled form
raises with the build's output, and the plain form runs only when asked.

The pipeline: down-weight pixels whose red-minus-blue lies below
``rb_lo`` (blue water), BT.601 gray, a 3x3 Gaussian blur, an inverted
adaptive Gaussian threshold (block 11, C 2), every contour (outer and
hole borders), the cells whose area lies within ``area_tol`` of
``grid_area`` and whose box is solid (area / box >= 0.4) and not too
elongated (aspect within [0.5, 2]), their box corners as candidates, and
the centroids of the radius-``cluster_eps`` clusters of at least
``min_cluster_pts`` candidates.  The clusters are the connected components
of the candidates' eps-graph, so the junctions depend neither on the order
in which contours are found nor on how their chains are compressed: only
the order in which a cluster's members are summed does.
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..core.contours import (
    adaptive_threshold_gaussian_inv,
    approx_simple,
    bounding_rect,
    box_points,
    contour_area,
    find_contours,
    gaussian_blur_u8,
    min_area_rect,
)


def detect_junctions(
    bgr: np.ndarray,
    grid_area: float = 200.0,
    area_tol: float = 2.0,
    cluster_eps: float = 6.0,
    min_cluster_pts: int = 3,
    rb_lo: float = -20.0,
    rb_hi: float = 15.0,
    rotated: bool = False,
    max_out: int = 4096,
    force_python: bool = False,
) -> np.ndarray:
    """Fishnet junction points of a bgr8 image [H, W, 3] -> [N, 2] float32
    (x, y), at most ``max_out`` of them.

    ``rotated=True`` fits minimum-area rectangles to the cells (nets seen at
    an angle) instead of axis-aligned boxes.  The compiled form runs unless
    ``force_python`` asks for the plain one."""
    bgr = np.ascontiguousarray(bgr, np.uint8)
    if bgr.ndim != 3 or bgr.shape[2] != 3:
        raise ValueError(f"expected a bgr8 image [H, W, 3], got shape {bgr.shape}")
    if force_python:
        return _detect_plain(bgr, grid_area, area_tol, cluster_eps,
                             min_cluster_pts, rb_lo, rb_hi, rotated)[:max_out]
    from ..ops._build import load_kernels

    lib = load_kernels()  # raises with nvcc's output when it cannot build
    out = np.empty((max(max_out, 1), 2), np.float32)
    n = lib.ofc_detect_junctions(
        bgr.ctypes.data, bgr.shape[0], bgr.shape[1], float(grid_area),
        float(area_tol), float(cluster_eps), int(min_cluster_pts),
        float(rb_lo), float(rb_hi), int(bool(rotated)), out.ctypes.data,
        int(max_out))
    if n < 0:
        raise RuntimeError("ofc_detect_junctions failed (out of memory)")
    return out[:n].copy()


def suppress_background(bgr: np.ndarray, rb_lo: float, rb_hi: float) -> np.ndarray:
    """BT.601 gray of a bgr8 image with pixels whose red minus blue lies
    below ``rb_lo`` ramped down to 0 over ``max(rb_hi - rb_lo, 1)``, in
    float32, truncated to uint8."""
    f32 = np.float32
    b, g, r = (bgr[..., i].astype(f32) for i in range(3))
    rb = r - b
    span = f32(max(rb_hi - rb_lo, 1.0))
    w = np.where(rb < f32(rb_lo),
                 np.maximum(f32(0), f32(1) + (rb - f32(rb_lo)) / span), f32(1))
    lum = f32(0.114) * b + f32(0.587) * g + f32(0.299) * r
    return np.minimum(f32(255), lum * w).astype(np.uint8)


def _cell_corners(chain: np.ndarray, amin: float, amax: float,
                  rotated: bool) -> list | None:
    """The four corner candidates of a contour that passes the cell
    filters, else None."""
    area = contour_area(chain)
    if area < amin or area > amax:
        return None
    if rotated:
        rect = min_area_rect(approx_simple(chain))
        (rw, rh), ang = rect[1], rect[2]
        if ang < -45:  # the reference's swap, kept as written
            rw, rh = rh, rw
        if rw <= 0 or rh <= 0:
            return None
        if area / (rw * rh) < 0.4 or not 0.5 <= rw / rh <= 2.0:
            return None
        return [tuple(p) for p in box_points(rect).tolist()]
    x, y, bw, bh = bounding_rect(chain)
    if area / (bw * bh) < 0.4 or not 0.5 <= bw / bh <= 2.0:
        return None
    return [(x, y), (x + bw, y), (x, y + bh), (x + bw, y + bh)]


def _detect_plain(bgr, grid_area, area_tol, cluster_eps, min_pts, rb_lo,
                  rb_hi, rotated) -> np.ndarray:
    binary = adaptive_threshold_gaussian_inv(
        gaussian_blur_u8(suppress_background(bgr, rb_lo, rb_hi), 3))
    amin, amax = grid_area / area_tol, grid_area * area_tol
    cands = []
    for chain in find_contours(binary):
        corners = _cell_corners(chain, amin, amax, rotated)
        if corners is not None:
            cands += corners
    if not cands:
        return np.zeros((0, 2), np.float32)
    return cluster_centroids(np.asarray(cands, np.float32), cluster_eps, min_pts)


def cluster_centroids(pts: np.ndarray, eps: float, min_pts: int) -> np.ndarray:
    """Centroids (float32 means in index order) of the connected components
    of the points' eps-graph (squared float32 distance <= eps^2) with at
    least ``min_pts`` members, in the order of their lowest index."""
    n = len(pts)
    label = -np.ones(n, np.int64)
    eps2 = np.float32(eps * eps)
    nc = 0
    for seed in range(n):
        if label[seed] != -1:
            continue
        stack = [seed]
        label[seed] = nc
        while stack:
            i = stack.pop()
            d2 = np.sum((pts - pts[i]) ** 2, axis=1)
            for j in np.nonzero((d2 <= eps2) & (label == -1))[0]:
                label[j] = nc
                stack.append(int(j))
        nc += 1
    out = [pts[label == c].mean(axis=0) for c in range(nc)
           if np.count_nonzero(label == c) >= min_pts]
    return np.asarray(out, np.float32).reshape(-1, 2)


__all__ = ["detect_junctions"]
