"""The cv2 operations behind the fishnet junction detector, in numpy: the
plain version of the detector (``native.detect_junctions(...,
force_python=True)``) and the oracle its compiled form
(``ops/csrc/junction_detect.cpp``) is held against.

- :func:`gaussian_blur_u8`: ``cv2.GaussianBlur`` on uint8 images.  OpenCV
  blurs 8-bit images in bit-exact fixed point: the 1-D kernel is rounded to
  8 fraction bits (``getGaussianKernelBitExact`` and an error-diffusing
  rounding that keeps its sum at exactly 256), the row pass is exact in
  8.8 fixed point, and the column pass sums to 16 fraction bits and rounds
  half up once.  So the result is ``(sum ky[i] kx[j] src + 2^15) >> 16``
  over the padded image, computed here in integers.
- :func:`adaptive_threshold_gaussian_inv`: ``cv2.adaptiveThreshold`` with
  ADAPTIVE_THRESH_GAUSSIAN_C and THRESH_BINARY_INV.  Its mean is not the
  fixed-point blur: OpenCV converts the image to float32, blurs it with
  BORDER_REPLICATE in float32 (:func:`gaussian_mean_f32`) and rounds the
  mean back to uint8; a pixel is ``max_value`` where
  ``src - mean <= -floor(C)``.
- :func:`find_contours`: ``cv2.findContours`` with RETR_TREE and
  CHAIN_APPROX_NONE, point sets only (no hierarchy): Suzuki-Abe border
  following with 8-connected foreground, OpenCV's neighbour order and
  marks.  OpenCV 5 pads the image with a ring of zeros, so pixels on the
  image's edge are foreground like any other.  :func:`approx_simple`
  compresses a chain as CHAIN_APPROX_SIMPLE does.
- :func:`contour_area`, :func:`bounding_rect`, :func:`convex_hull`,
  :func:`min_area_rect` and :func:`box_points`: ``cv2.contourArea``
  (shoelace in double), ``cv2.boundingRect``, ``cv2.convexHull`` (strictly
  convex, positive orientation), ``cv2.minAreaRect`` (rotating calipers in
  float32, the angle in [-90, 0) as OpenCV 5 reports it) and
  ``cv2.boxPoints``.

Contours come in raster order of their start pixels, which is not cv2's
order; the detector does not depend on it (module docstring of
``native``).
"""
from __future__ import annotations

import math

import numpy as np

_PAD = {"reflect101": "reflect", "replicate": "edge"}


def _check_u8(src) -> np.ndarray:
    src = np.asarray(src)
    if src.dtype != np.uint8 or src.ndim != 2:
        raise ValueError(f"expected a uint8 [H, W] image, got {src.dtype} {src.shape}")
    return src


def _gaussian_kernel(ksize: int, sigma: float) -> list[float]:
    """OpenCV's ``getGaussianKernelBitExact`` in double: the fixed kernels
    of sizes 1-7 when ``sigma <= 0``, else the sampled Gaussian (sigma from
    the size when ``sigma <= 0``) normalized to sum 1."""
    if ksize % 2 != 1 or ksize < 1:
        raise ValueError(f"ksize must be odd and positive, got {ksize}")
    fixed = {1: [1.0], 3: [0.25, 0.5, 0.25],
             5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
             7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375,
                 0.03125]}
    if sigma <= 0 and ksize in fixed:
        return fixed[ksize]
    s = sigma if sigma > 0 else ksize * 0.15 + 0.35
    scale2 = -0.125 / (s * s)
    vals = [math.exp((x * x) * scale2) for x in range(1 - ksize, 0, 2)]
    mul = 1.0 / (2.0 * sum(vals) + 1.0)
    return [v * mul for v in vals] + [mul] + [v * mul for v in vals[::-1]]


def gaussian_kernel_fixed(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """OpenCV's Gaussian kernel for 8-bit images: ``ksize`` int64 taps with
    8 fraction bits that sum to exactly 256 (an error-diffusing rounding,
    the centre tap taking the remainder: getGaussianKernelFixedPoint_ED)."""
    k = _gaussian_kernel(ksize, sigma)
    n2 = ksize // 2
    out = [0] * ksize
    err = 0.0
    for i in range(n2):
        adj = k[i] * 256.0 + err
        v = round(adj)  # half to even, as cvRound
        err = adj - v
        out[i] = out[ksize - 1 - i] = v
    out[n2] = 256 - 2 * sum(out[:n2])
    return np.asarray(out, np.int64)


def gaussian_blur_u8(src: np.ndarray, ksize: int, sigma: float = 0.0,
                     border: str = "reflect101") -> np.ndarray:
    """``cv2.GaussianBlur(src, (ksize, ksize), sigma, borderType=...)`` of a
    uint8 [H, W] image, bit for bit."""
    src = _check_u8(src)
    k = gaussian_kernel_fixed(ksize, sigma)
    r = ksize // 2
    x = np.pad(src.astype(np.int64), r, mode=_PAD[border])
    H, W = src.shape
    rows = sum(k[j] * x[:, j:j + W] for j in range(ksize))
    acc = sum(k[i] * rows[i:i + H] for i in range(ksize))
    return ((acc + (1 << 15)) >> 16).astype(np.uint8)


def _fma32(a, b, c) -> np.ndarray:
    """float32 ``fma(a, b, c)``: formed in float64 and rounded once (exact
    but where the float64 sum itself rounds)."""
    return (np.float64(a) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def gaussian_mean_f32(src: np.ndarray, ksize: int) -> np.ndarray:
    """The float32 (ksize, ksize) Gaussian mean (sigma from the size) with
    BORDER_REPLICATE that ``cv2.adaptiveThreshold`` takes of a uint8 image:
    a row pass that accumulates the taps left to right in fused
    multiply-adds, then a column pass that starts from the centre row and
    adds each symmetric pair's sum in a fused multiply-add, OpenCV's
    vectorized float filter; its scalar tail (the last ``W % 16`` columns)
    rounds within 1e-5 of it."""
    src = _check_u8(src)
    k = [np.float32(v) for v in _gaussian_kernel(ksize, 0.0)]
    r = ksize // 2
    H, W = src.shape
    x = np.pad(src.astype(np.float32), r, mode="edge")
    rows = (k[0] * x[:, :W]).astype(np.float32)
    for j in range(1, ksize):
        rows = _fma32(k[j], x[:, j:j + W], rows)
    acc = (k[r] * rows[r:r + H]).astype(np.float32)
    for j in range(1, r + 1):
        acc = _fma32(k[r + j], rows[r + j:r + j + H] + rows[r - j:r - j + H], acc)
    return acc


def adaptive_threshold_gaussian_inv(src: np.ndarray, max_value: int = 255,
                                    block_size: int = 11,
                                    c: float = 2.0) -> np.ndarray:
    """``cv2.adaptiveThreshold(src, max_value, ADAPTIVE_THRESH_GAUSSIAN_C,
    THRESH_BINARY_INV, block_size, c)`` of a uint8 [H, W] image: the float
    mean rounded half to even to uint8, then ``max_value`` where
    ``src - mean <= -floor(c)``, else 0."""
    mean = np.rint(gaussian_mean_f32(src, block_size)).astype(np.int32)
    diff = src.astype(np.int32) - mean
    return np.where(diff <= -math.floor(c), np.uint8(max_value), np.uint8(0))


# OpenCV's chain codes: 0 east, then counter-clockwise on the screen
# (y down): 1 north-east, 2 north, ... 7 south-east
_DX = (1, 1, 0, -1, -1, -1, 0, 1)
_DY = (0, -1, -1, -1, 0, 1, 1, 1)
_UNSEEN, _SEEN, _RIGHT_ZERO = 1, 2, 3  # labels of foreground pixels


def find_contours(binary: np.ndarray) -> list[np.ndarray]:
    """Every border of the nonzero pixels of ``binary`` [H, W] (outer
    borders and hole borders, as RETR_TREE returns them), each an int32
    [N, 2] (x, y) chain with every border pixel in OpenCV's tracing order
    (CHAIN_APPROX_NONE), in raster order of the start pixels."""
    binary = np.asarray(binary)
    if binary.ndim != 2:
        raise ValueError(f"expected an [H, W] image, got shape {binary.shape}")
    H, W = binary.shape
    Wp = W + 2
    fg = np.zeros((H + 2, Wp), bool)
    fg[1:-1, 1:-1] = binary != 0
    lab = fg.astype(np.int8).ravel().tolist()
    delta = [dx + dy * Wp for dx, dy in zip(_DX, _DY)] * 2
    # Tracing relabels foreground pixels but never changes which pixels are
    # zero, so the scan's only candidates are the row transitions between
    # zero and nonzero; whether each starts a border is read when the scan
    # reaches it.
    rows, cols = np.nonzero(fg[:, 1:] != fg[:, :-1])
    contours = []
    for pos in (rows * Wp + cols + 1).tolist():
        if lab[pos]:
            if lab[pos] == _UNSEEN:  # 0 -> 1: an outer border starts here
                contours.append(_trace(lab, delta, pos, False))
        elif lab[pos - 1] in (_UNSEEN, _SEEN):  # 1 -> 0: a hole border
            contours.append(_trace(lab, delta, pos - 1, True))
    out = []
    for chain in contours:
        p = np.asarray(chain, np.int64)
        out.append(np.stack([p % Wp - 1, p // Wp - 1], -1).astype(np.int32))
    return out


def _trace(lab: list, delta: list, i0: int, hole: bool) -> list[int]:
    """Follow one border from ``i0`` (OpenCV's icvFetchContourEx): the
    flat positions of its pixels, marking each as seen, or as having a
    zero east neighbour that the search stepped over."""
    s = s_end = 0 if hole else 4
    while True:
        s = (s - 1) & 7
        i1 = i0 + delta[s]
        if lab[i1] or s == s_end:
            break
    if s == s_end:  # an isolated pixel
        lab[i0] = _RIGHT_ZERO
        return [i0]
    chain = []
    i3 = i0
    while True:
        s_end = s
        while s < 15:
            s += 1
            i4 = i3 + delta[s]
            if lab[i4]:
                break
        s &= 7
        if 1 <= s <= s_end:
            lab[i3] = _RIGHT_ZERO
        elif lab[i3] == _UNSEEN:
            lab[i3] = _SEEN
        chain.append(i3)
        if i4 == i0 and i3 == i1:
            return chain
        i3 = i4
        s = (s + 4) & 7


def approx_simple(chain: np.ndarray) -> np.ndarray:
    """The CHAIN_APPROX_SIMPLE form of a CHAIN_APPROX_NONE chain: the pixels
    where the chain turns (its step out differs from its step in, the last
    step leading back to the first pixel)."""
    chain = np.asarray(chain).reshape(-1, 2)
    if len(chain) < 3:
        return chain
    step_out = np.roll(chain, -1, axis=0) - chain
    step_in = np.roll(step_out, 1, axis=0)
    return chain[np.any(step_out != step_in, axis=1)]


def contour_area(contour: np.ndarray) -> float:
    """``cv2.contourArea(contour)``: the shoelace area in double, unsigned."""
    p = np.asarray(contour, np.float64).reshape(-1, 2)
    if len(p) < 3:
        return 0.0
    q = np.roll(p, 1, axis=0)
    return abs(float(np.sum(q[:, 0] * p[:, 1] - q[:, 1] * p[:, 0])) * 0.5)


def bounding_rect(contour: np.ndarray) -> tuple[int, int, int, int]:
    """``cv2.boundingRect`` of integer points: (x, y, w, h)."""
    p = np.asarray(contour).reshape(-1, 2)
    x0, y0 = (int(v) for v in p.min(axis=0))
    x1, y1 = (int(v) for v in p.max(axis=0))
    return x0, y0, x1 - x0 + 1, y1 - y0 + 1


def convex_hull(points: np.ndarray) -> np.ndarray:
    """``cv2.convexHull(points)`` of integer points: the strictly convex
    hull, int32 [M, 2], with positive signed area (the shoelace sum), in
    OpenCV's order: where the vertices' indices in ``points`` run
    cyclically up or down, the hull starts at the lowest (up) or highest
    (down) index, else at the point of largest x (largest y among them)."""
    p = np.asarray(points, np.int64).reshape(-1, 2)
    uniq, first = np.unique(p, axis=0, return_index=True)
    if len(uniq) <= 2:
        return uniq[::-1].astype(np.int32)
    pts = [tuple(v) for v in uniq.tolist()]  # sorted by x, then y

    def half(order):
        h = []
        for q in order:
            while len(h) >= 2 and ((pts[h[-1]][0] - pts[h[-2]][0]) * (pts[q][1] - pts[h[-2]][1])
                                   - (pts[h[-1]][1] - pts[h[-2]][1]) * (pts[q][0] - pts[h[-2]][0])) <= 0:
                h.pop()
            h.append(q)
        return h

    n = len(pts)
    ring = half(range(n))[:-1] + half(range(n - 1, -1, -1))[:-1]
    start = ring.index(n - 1)
    ring = ring[start:] + ring[:start]
    idx = [int(first[i]) for i in ring]
    m = len(idx)
    # OpenCV's cyclic shift towards an ascending or descending index run
    lo = min(range(m), key=idx.__getitem__)
    hi = max(range(m), key=idx.__getitem__)
    for i0, step in ((lo, 1), (hi, -1)):
        run = idx[i0:] + idx[:i0]
        if all((run[k] < run[k + 1]) == (step > 0) for k in range(m - 1)):
            ring = ring[i0:] + ring[:i0]
            break
    return np.asarray([pts[i] for i in ring], np.int32)


def min_area_rect(points: np.ndarray):
    """``cv2.minAreaRect(points)``: ((cx, cy), (w, h), angle) of the
    smallest rectangle around integer points, as floats of float32 values,
    angle in [-90, 0)."""
    hull = convex_hull(points).astype(np.float32)
    n = len(hull)
    f32 = np.float32
    if n > 2:
        ox, oy, w, h, ang = _calipers(hull)
    elif n == 2:
        (x0, y0), (x1, y1) = hull.astype(np.float64)
        ox, oy = f32((f32(x0) + f32(x1)) * f32(0.5)), f32((f32(y0) + f32(y1)) * f32(0.5))
        dx, dy = x1 - x0, y1 - y0
        w, h = f32(math.sqrt(dx * dx + dy * dy)), f32(0.0)
        ang = f32(math.atan2(dy, dx))
    elif n == 1:
        ox, oy, w, h, ang = hull[0, 0], hull[0, 1], f32(0), f32(0), f32(0)
    else:
        ox = oy = w = h = ang = f32(0)
    ang = f32(float(ang) * 180.0 / math.pi)
    while ang >= 0:
        ang, w, h = f32(ang - f32(90)), h, w
    while ang < -90:
        ang, w, h = f32(ang + f32(90)), h, w
    return (float(ox), float(oy)), (float(w), float(h)), float(ang)


def _calipers(pt: np.ndarray):
    """OpenCV's rotatingCalipers (CALIPERS_MINAREARECT) over a convex
    polygon, every step in float32 as OpenCV computes it; returns the
    rectangle's centre, the two side lengths and the angle (radians) of
    the first side."""
    f32 = np.float32
    n = len(pt)
    P = [(f32(x), f32(y)) for x, y in pt.tolist()]
    vect, inv_len = [], []
    left = bottom = right = top = 0
    lx = rx = P[0][0]
    ty = by = P[0][1]
    for i in range(n):
        x, y = P[i]
        if x < lx:
            lx, left = x, i
        if x > rx:
            rx, right = x, i
        if y > ty:
            ty, top = y, i
        if y < by:
            by, bottom = y, i
        nx, ny = P[(i + 1) % n]
        dx, dy = float(nx) - float(x), float(ny) - float(y)
        vect.append((f32(dx), f32(dy)))
        inv_len.append(f32(1.0 / math.sqrt(dx * dx + dy * dy)))
    orientation = f32(0)
    ax, ay = float(vect[-1][0]), float(vect[-1][1])
    for bx, byy in vect:
        conv = ax * float(byy) - ay * float(bx)
        if conv != 0:
            orientation = f32(1) if conv > 0 else f32(-1)
            break
        ax, ay = float(bx), float(byy)
    base_a, base_b = orientation, f32(0)
    seq = [bottom, right, top, left]
    minarea = f32(np.finfo(np.float32).max)
    best = None
    for _ in range(n):
        v = [vect[s] for s in seq]
        dp = [base_a * v[0][0] + base_b * v[0][1],
              -base_b * v[1][0] + base_a * v[1][1],
              -base_a * v[2][0] - base_b * v[2][1],
              base_b * v[3][0] - base_a * v[3][1]]
        main = 0
        maxcos = dp[0] * inv_len[seq[0]]
        for i in range(1, 4):
            c = dp[i] * inv_len[seq[i]]
            if c > maxcos:
                main, maxcos = i, c
        pi = seq[main]
        lead_x, lead_y = vect[pi][0] * inv_len[pi], vect[pi][1] * inv_len[pi]
        base_a, base_b = ((lead_x, lead_y), (lead_y, -lead_x),
                          (-lead_x, -lead_y), (-lead_y, lead_x))[main]
        seq[main] = (seq[main] + 1) % n
        dx = P[seq[1]][0] - P[seq[3]][0]
        dy = P[seq[1]][1] - P[seq[3]][1]
        width = dx * base_a + dy * base_b
        dx = P[seq[2]][0] - P[seq[0]][0]
        dy = P[seq[2]][1] - P[seq[0]][1]
        height = -dx * base_b + dy * base_a
        area = width * height
        if area <= minarea:
            minarea = area
            best = (seq[3], base_a, width, base_b, height, seq[0])
    i_left, a1, width, b1, height, i_bottom = best
    a2, b2 = -b1, a1
    c1 = a1 * P[i_left][0] + P[i_left][1] * b1
    c2 = a2 * P[i_bottom][0] + P[i_bottom][1] * b2
    idet = f32(1) / (a1 * b2 - a2 * b1)
    px = (c1 * b2 - c2 * b1) * idet
    py = (a1 * c2 - a2 * c1) * idet
    o1x, o1y = a1 * width, b1 * width
    o2x, o2y = a2 * height, b2 * height
    cx = px + (o1x + o2x) * f32(0.5)
    cy = py + (o1y + o2y) * f32(0.5)
    w = f32(math.sqrt(float(o1x) * float(o1x) + float(o1y) * float(o1y)))
    h = f32(math.sqrt(float(o2x) * float(o2x) + float(o2y) * float(o2y)))
    return cx, cy, w, h, f32(math.atan2(float(o1y), float(o1x)))


def box_points(rect) -> np.ndarray:
    """``cv2.boxPoints(rect)``: the rectangle's four corners, float32
    [4, 2], in OpenCV's order."""
    (cx, cy), (w, h), angle = rect
    f32 = np.float32
    cx, cy, w, h = f32(cx), f32(cy), f32(w), f32(h)
    a_rad = float(f32(angle)) * math.pi / 180.0
    b = f32(f32(math.cos(a_rad)) * f32(0.5))
    a = f32(f32(math.sin(a_rad)) * f32(0.5))
    p0 = (cx - a * h - b * w, cy + b * h - a * w)
    p1 = (cx + a * h - b * w, cy - b * h - a * w)
    p2 = (f32(2) * cx - p0[0], f32(2) * cy - p0[1])
    p3 = (f32(2) * cx - p1[0], f32(2) * cy - p1[1])
    return np.asarray([p0, p1, p2, p3], np.float32)
