"""Line, arrow and rectangle drawing in place of ``cv2.line``,
``cv2.arrowedLine`` and ``cv2.rectangle`` (LINE_8, shift 0), for the debug
overlays and the still-pair tools.  Host code on numpy images [H, W] or
[H, W, C]; each function draws in place and returns the image, as cv2
does.

Thickness 1 follows cv2 pixel for pixel: the segment is clipped to the
image by cv2's ``clipLine`` (integer arithmetic, truncating divisions),
then walked by its 8-connected ``LineIterator``, left to right.
``arrowed_line`` places the tip's two strokes as cv2 does: length
``tip_length * |p1 - p2|``, at +-45 degrees from the shaft, end points
rounded half to even.

Thicker lines follow OpenCV 5's ``ThickLine`` pixel for pixel too: the
segment, clipped to the image grown by the thickness on every side,
becomes a convex polygon of half-width thickness / 2 at 1/65536 px (its
outline walked by cv2's fixed-point ``Line2``, its scan lines filled
between two edges that step a constant x increment a row), with a filled
midpoint circle at each capped end.
"""
from __future__ import annotations

import math

import numpy as np


def _clip_line(W: int, H: int, x1: int, y1: int, x2: int, y2: int):
    """cv2's ``clipLine`` to [0, W-1] x [0, H-1]: the clipped end points, or
    None when the segment misses the image."""
    right, bottom = W - 1, H - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return x1, y1, x2, y2


def _line_pixels(W: int, H: int, pt1, pt2) -> tuple[np.ndarray, np.ndarray]:
    """(xs, ys) of the pixels cv2's 8-connected ``LineIterator`` visits from
    ``pt1`` to ``pt2`` (integer points) on a W x H image."""
    x1, y1 = int(pt1[0]), int(pt1[1])
    x2, y2 = int(pt2[0]), int(pt2[1])
    if not (0 <= x1 < W and 0 <= x2 < W and 0 <= y1 < H and 0 <= y2 < H):
        clipped = _clip_line(W, H, x1, y1, x2, y2)
        if clipped is None:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    step_x, step_y = 1, 1
    if dx < 0:  # left to right
        dx, dy = -dx, -dy
        x1, y1 = x2, y2
    if dy < 0:
        dy, step_y = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
        step_x, step_y = step_y, step_x
    # the major axis steps every pixel, the minor one where err < 0
    err = dx - 2 * dy
    count = dx + 1
    major = np.arange(count, dtype=np.int64) * step_x
    minor = np.zeros(count, np.int64)
    m = 0
    for k in range(1, count):
        if err < 0:
            m += step_y
            err += 2 * dx
        err -= 2 * dy
        minor[k] = m
    if vert:
        return x1 + minor, y1 + major
    return x1 + major, y1 + minor


def _paint(img: np.ndarray, xs, ys, color) -> None:
    c = np.asarray(color, img.dtype).reshape(-1)
    img[ys, xs] = c[: img.shape[2]] if img.ndim == 3 else c[0]


_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT
_HALF = _XY_ONE >> 1


def _tdiv(a: int, b: int) -> int:
    """C's integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _line2(mask: np.ndarray, p1, p2) -> None:
    """cv2's ``Line2``, the outline of its polygon fill: the segment between
    two 1/65536-px points clipped to the image at that resolution, then
    walked one pixel a step along its major axis with a fixed-point minor
    coordinate, and its end rounded."""
    H, W = mask.shape
    clipped = _clip_line(W << _XY_SHIFT, H << _XY_SHIFT, *p1, *p2)
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        step = _tdiv(dy << _XY_SHIFT, ax | 1)
        count = (x2 - x1) >> _XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        step = _tdiv(dx << _XY_SHIFT, ay | 1)
        count = (y2 - y1) >> _XY_SHIFT
    k = np.arange(max(count + 1, 0), dtype=np.int64)
    if ax > ay:
        xs = ((x1 + _HALF) >> _XY_SHIFT) + k
        ys = (y1 + _HALF + k * step) >> _XY_SHIFT
    else:
        xs = (x1 + _HALF + k * step) >> _XY_SHIFT
        ys = ((y1 + _HALF) >> _XY_SHIFT) + k
    xs = np.append(xs, (x2 + _HALF) >> _XY_SHIFT)
    ys = np.append(ys, (y2 + _HALF) >> _XY_SHIFT)
    ok = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
    mask[ys[ok], xs[ok]] = True


def _fill_convex_poly(mask: np.ndarray, v: list) -> None:
    """cv2's ``FillConvexPoly`` (LINE_8) of the 1/65536-px points ``v``: the
    outline by :func:`_line2`, then each scan line between the two edges,
    which step from vertex to vertex by a constant x increment a row."""
    H, W = mask.shape
    n = len(v)
    p0 = v[-1]
    imin = 0
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    for i, p in enumerate(v):
        if p[1] < ymin:
            ymin, imin = p[1], i
        ymax, xmax, xmin = max(ymax, p[1]), max(xmax, p[0]), min(xmin, p[0])
        _line2(mask, p0, p)
        p0 = p
    xmin, xmax = (xmin + _HALF) >> _XY_SHIFT, (xmax + _HALF) >> _XY_SHIFT
    ymin, ymax = (ymin + _HALF) >> _XY_SHIFT, (ymax + _HALF) >> _XY_SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= W or ymin >= H:
        return
    ymax = min(ymax, H - 1)
    # per edge: [vertex index, direction, x, dx, last row]
    edge = [[imin, 1, -_XY_ONE, 0, ymin], [imin, n - 1, -_XY_ONE, 0, ymin]]
    edges = n
    y = ymin
    while True:
        for e in edge:
            if y >= e[4]:
                idx0 = e[0]
                idx = (idx0 + e[1]) % n
                while True:
                    more = edges > 0
                    edges -= 1
                    if not more:
                        break
                    ty = (v[idx][1] + _HALF) >> _XY_SHIFT
                    if ty > y:
                        xs, xe = v[idx0][0], v[idx][0]
                        e[4] = ty
                        e[3] = _tdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e[2] = xs
                        e[0] = idx
                        break
                    idx0 = idx
                    idx = (idx + e[1]) % n
        if edges < 0:
            break
        if y >= 0:
            lx, rx = sorted((edge[0][2], edge[1][2]))
            x1, x2 = (lx + _HALF) >> _XY_SHIFT, (rx + _HALF) >> _XY_SHIFT
            if x2 >= 0 and x1 < W:
                mask[y, max(x1, 0):min(x2, W - 1) + 1] = True
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break


def _fill_circle(mask: np.ndarray, cx: int, cy: int, radius: int) -> None:
    """cv2's filled ``Circle``: the midpoint circle's spans."""
    H, W = mask.shape
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for yy, x_lo, x_hi in ((cy - dy, cx - dx, cx + dx), (cy + dy, cx - dx, cx + dx),
                               (cy - dx, cx - dy, cx + dy), (cy + dx, cx - dy, cx + dy)):
            if 0 <= yy < H and x_lo < W and x_hi >= 0:
                mask[yy, max(x_lo, 0):min(x_hi, W - 1) + 1] = True
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2


def _thick_line(mask: np.ndarray, pt1, pt2, thickness: int, flags: int) -> None:
    """cv2's ``ThickLine`` (LINE_8, shift 0) for thickness > 1: the segment,
    clipped to the image grown by ``thickness`` on every side, as a convex
    polygon of half-width thickness / 2 at 1/65536 px, and a filled circle
    at each end that ``flags`` names (1 the first, 2 the second)."""
    H, W = mask.shape
    t = thickness
    clipped = _clip_line(W + 2 * t, H + 2 * t, pt1[0] + t, pt1[1] + t,
                         pt2[0] + t, pt2[1] + t)
    if clipped is None:
        return
    pt1, pt2 = (clipped[0] - t, clipped[1] - t), (clipped[2] - t, clipped[3] - t)
    p0 = (pt1[0] << _XY_SHIFT, pt1[1] << _XY_SHIFT)
    p1 = (pt2[0] << _XY_SHIFT, pt2[1] << _XY_SHIFT)
    dx = (p0[0] - p1[0]) / _XY_ONE
    dy = (p1[1] - p0[1]) / _XY_ONE
    r = dx * dx + dy * dy
    half = thickness << (_XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (half + (thickness & 1) * _XY_ONE * 0.5) / math.sqrt(r)
        dpx, dpy = int(np.rint(dy * r)), int(np.rint(dx * r))
        _fill_convex_poly(mask, [(p0[0] + dpx, p0[1] + dpy), (p0[0] - dpx, p0[1] - dpy),
                                 (p1[0] - dpx, p1[1] - dpy), (p1[0] + dpx, p1[1] + dpy)])
    for i, p in enumerate((p0, p1)):
        if flags & (i + 1):
            _fill_circle(mask, (p[0] + _HALF) >> _XY_SHIFT, (p[1] + _HALF) >> _XY_SHIFT,
                         (half + _HALF) >> _XY_SHIFT)


def _draw(img: np.ndarray, segments, color, thickness: int) -> np.ndarray:
    """Draw ``segments`` [(pt1, pt2, cap flags)] of ``thickness``."""
    H, W = img.shape[:2]
    if thickness <= 1:
        for a, b, _ in segments:
            _paint(img, *_line_pixels(W, H, a, b), color)
        return img
    mask = np.zeros((H, W), bool)
    for a, b, flags in segments:
        _thick_line(mask, a, b, thickness, flags)
    ys, xs = np.nonzero(mask)
    _paint(img, xs, ys, color)
    return img


def _pt(p) -> tuple[int, int]:
    return int(p[0]), int(p[1])


def line(img: np.ndarray, pt1, pt2, color, thickness: int = 1) -> np.ndarray:
    """``cv2.line(img, pt1, pt2, color, thickness)`` with LINE_8."""
    return _draw(img, [(_pt(pt1), _pt(pt2), 3)], color, thickness)


def arrowed_line(img: np.ndarray, pt1, pt2, color, thickness: int = 1,
                 tip_length: float = 0.1) -> np.ndarray:
    """``cv2.arrowedLine(img, pt1, pt2, color, thickness,
    tipLength=tip_length)``: the shaft, then the tip's two strokes ending
    at ``pt2``."""
    x1, y1 = int(pt1[0]), int(pt1[1])
    x2, y2 = int(pt2[0]), int(pt2[1])
    tip = math.sqrt(float(x1 - x2) ** 2 + float(y1 - y2) ** 2) * tip_length
    line(img, (x1, y1), (x2, y2), color, thickness)
    angle = math.atan2(float(y1 - y2), float(x1 - x2))
    for side in (math.pi / 4, -math.pi / 4):
        p = (int(np.rint(x2 + tip * math.cos(angle + side))),
             int(np.rint(y2 + tip * math.sin(angle + side))))
        line(img, p, (x2, y2), color, thickness)
    return img


def rectangle(img: np.ndarray, pt1, pt2, color, thickness: int = 1) -> np.ndarray:
    """``cv2.rectangle(img, pt1, pt2, color, thickness)`` outline (thickness
    >= 1) with LINE_8: cv2's closed polyline through the four corners, each
    edge capped at its end."""
    (x1, y1), (x2, y2) = _pt(pt1), _pt(pt2)
    corners = [(x1, y1), (x2, y1), (x2, y2), (x1, y2)]
    return _draw(img, [(corners[i - 1], corners[i], 2) for i in range(4)],
                 color, thickness)
