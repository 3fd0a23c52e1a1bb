"""Plain Farneback flow: ``cv2.calcOpticalFlowFarneback`` with flags 0 (box
window), written out in PyTorch, fp32, one pair at a time.

Per pyramid level, coarsest first: each frame is blurred at full
resolution (cv2's ``GaussianBlur`` with sigma = (1/scale - 1)/2, reflect101
border) and resized bilinearly to the level; the polynomial expansion of
the level (poly_n, poly_sigma; replicate border) gives five planes (bx,
by, axx, ayy, qxy); ``iterations`` times, frame 1's planes are sampled at
x + flow, the normal equations are formed with cv2's border ramp, blurred
by the winsize box (replicate border) and solved for the flow.

``store`` rounds every array that crosses a stage boundary (the planes,
the normal equations, the flow): the identity for fp32, bfloat16 storage
for the lower-precision control (``bf16_store``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

RAMP = (0.14, 0.14, 0.4472, 0.4472, 0.4472)


def fp32_store(x: torch.Tensor) -> torch.Tensor:
    return x


def bf16_store(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def gaussian_taps(ksize: int, sigma: float) -> np.ndarray:
    """cv2 ``getGaussianKernel``: the fixed small kernels for sigma <= 0."""
    if sigma <= 0 and ksize in (1, 3, 5, 7):
        fixed = {1: [1.0], 3: [0.25, 0.5, 0.25],
                 5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
                 7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375,
                     0.03125]}
        return np.array(fixed[ksize])
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize) - (ksize - 1) * 0.5
    g = np.exp(-x * x / (2 * sigma * sigma))
    return g / g.sum()


def correlate(x: torch.Tensor, taps, dim: int) -> torch.Tensor:
    """Valid 1-D correlation of ``x`` along ``dim`` (already padded)."""
    n = x.shape[dim] - len(taps) + 1
    out = torch.zeros_like(x.narrow(dim, 0, n))
    for t, k in enumerate(taps):
        out = out + x.narrow(dim, t, n) * float(k)
    return out


def separable(x: torch.Tensor, taps, mode: str) -> torch.Tensor:
    """2-D separable correlation of [N, C, H, W] by ``taps`` in both axes,
    vertical first; ``mode`` is F.pad's ("reflect" is cv2's reflect101)."""
    r = len(taps) // 2
    x = correlate(F.pad(x, (0, 0, r, r), mode=mode), taps, 2)
    return correlate(F.pad(x, (r, r, 0, 0), mode=mode), taps, 3)


def num_levels(H: int, W: int, levels: int, pyr_scale: float) -> int:
    k, scale = 0, 1.0
    while k < levels:
        scale *= pyr_scale
        if W * scale < 32.0 or H * scale < 32.0:
            break
        k += 1
    return k


def level_size(H: int, W: int, scale: float) -> tuple[int, int]:
    return int(round(H * scale)), int(round(W * scale))


def resize(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """cv2 INTER_LINEAR: half-pixel centres, no antialiasing."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False)


def expansion(level: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """[N, 1, h, w] -> the five planes [N, 5, h, w] (bx, by, axx, ayy, qxy)
    of cv2's polynomial expansion, replicate border."""
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-x * x / (2 * sigma * sigma))
    g /= g.sum()
    m2, m4 = float((x * x * g).sum()), float((x ** 4 * g).sum())
    G = np.array([[1, 0, 0, m2, m2, 0], [0, m2, 0, 0, 0, 0],
                  [0, 0, m2, 0, 0, 0], [m2, 0, 0, m4, m2 * m2, 0],
                  [m2, 0, 0, m2 * m2, m4, 0], [0, 0, 0, 0, 0, m2 * m2]])
    iG = np.linalg.inv(G)
    p = F.pad(level, (n, n, n, n), mode="replicate")
    rows = {k: correlate(p, t, 2) for k, t in
            (("g", g), ("xg", x * g), ("xxg", x * x * g))}
    s0 = correlate(rows["g"], g, 3)
    sx = correlate(rows["g"], x * g, 3)
    sxx = correlate(rows["g"], x * x * g, 3)
    sy = correlate(rows["xg"], g, 3)
    sxy = correlate(rows["xg"], x * g, 3)
    syy = correlate(rows["xxg"], g, 3)
    return torch.cat([iG[1, 1] * sx, iG[1, 1] * sy,
                      iG[0, 3] * s0 + iG[3, 3] * sxx,
                      iG[0, 3] * s0 + iG[3, 3] * syy, iG[5, 5] * sxy], 1)


def level_planes(frames: torch.Tensor, k: int, p: dict, store) -> torch.Tensor:
    """[N, H, W] fp32 frames -> the planes of pyramid level ``k``."""
    H, W = frames.shape[-2:]
    scale = p["pyr_scale"] ** k
    sigma = (1.0 / scale - 1.0) * 0.5
    ksize = max(int(round(sigma * 5)) | 1, 3)
    blurred = separable(frames[:, None], gaussian_taps(ksize, sigma), "reflect")
    level = resize(blurred, level_size(H, W, scale))
    return store(expansion(level, p["poly_n"], p["poly_sigma"]))


def ramp(n: int) -> np.ndarray:
    w = np.ones(n, np.float32)
    for i in range(min(len(RAMP), n)):
        w[i] *= np.float32(RAMP[i])
        w[n - 1 - i] *= np.float32(RAMP[i])
    return w


def normal_equations(R0, R1, u, v):
    """Frame 1's planes sampled bilinearly at (x + u, y + v) (all four taps
    inside, else frame 0 alone and no data term), averaged with frame 0's,
    weighted by the border ramp: (G00, G01, G11, h1, h2) [N, 5, h, w]."""
    N, _, h, w = R0.shape
    dev = R0.device
    fx = torch.arange(w, device=dev, dtype=torch.float32) + u
    fy = torch.arange(h, device=dev, dtype=torch.float32)[:, None] + v
    x0, y0 = torch.floor(fx), torch.floor(fy)
    inside = (x0 >= 0) & (x0 < w - 1) & (y0 >= 0) & (y0 < h - 1)
    ax, ay = fx - x0, fy - y0
    xi = x0.clamp(0, w - 2).long()
    yi = y0.clamp(0, h - 2).long()
    b = torch.arange(N, device=dev)[:, None, None]
    R1s = []
    for c in range(5):
        plane = R1[:, c]
        R1s.append(plane[b, yi, xi] * (1 - ax) * (1 - ay)
                   + plane[b, yi, xi + 1] * ax * (1 - ay)
                   + plane[b, yi + 1, xi] * (1 - ax) * ay
                   + plane[b, yi + 1, xi + 1] * ax * ay)
    bx0, by0, axx0, ayy0, qxy0 = R0.unbind(1)
    bx1, by1, axx1, ayy1, qxy1 = R1s
    axx = torch.where(inside, (axx0 + axx1) * 0.5, axx0)
    ayy = torch.where(inside, (ayy0 + ayy1) * 0.5, ayy0)
    axy = torch.where(inside, (qxy0 + qxy1) * 0.25, qxy0 * 0.5)
    dbx = torch.where(inside, (bx0 - bx1) * 0.5, 0.0) + axx * u + axy * v
    dby = torch.where(inside, (by0 - by1) * 0.5, 0.0) + axy * u + ayy * v
    wgt = torch.from_numpy(ramp(h)[:, None] * ramp(w)[None, :]).to(dev)
    axx, ayy, axy, dbx, dby = (t * wgt for t in (axx, ayy, axy, dbx, dby))
    return torch.stack([axx * axx + axy * axy, (axx + ayy) * axy,
                        ayy * ayy + axy * axy, axx * dbx + axy * dby,
                        axy * dbx + ayy * dby], 1)


def solve(M: torch.Tensor, winsize: int):
    """Box blur of the normal equations over the window, then the 2x2
    solve with cv2's 1e-3 regulariser."""
    Mb = separable(M, np.ones(winsize) / winsize, "replicate")
    G00, G01, G11, h1, h2 = Mb.unbind(1)
    idet = 1.0 / (G00 * G11 - G01 * G01 + 1e-3)
    return (G11 * h1 - G01 * h2) * idet, (G00 * h2 - G01 * h1) * idet


def farneback_pairs(prev: torch.Tensor, nxt: torch.Tensor, params: dict,
                    store=fp32_store) -> torch.Tensor:
    """Flow [N, H, W, 2] from frames ``prev`` to ``nxt`` [N, H, W] (any
    dtype, cv2's 0-255 scale) with ``params`` (pyr_scale, levels, winsize,
    iterations, poly_n, poly_sigma)."""
    if params.get("flags", 0):
        raise ValueError("the reference computes flags 0 only")
    f0, f1 = prev.float(), nxt.float()
    N, H, W = f0.shape
    u = v = None
    for k in range(num_levels(H, W, params["levels"], params["pyr_scale"]),
                   -1, -1):
        h, w = level_size(H, W, params["pyr_scale"] ** k)
        if u is None:
            u = torch.zeros(N, h, w, device=f0.device)
            v = torch.zeros_like(u)
        else:
            u = store(resize(u[:, None], (h, w))[:, 0] / params["pyr_scale"])
            v = store(resize(v[:, None], (h, w))[:, 0] / params["pyr_scale"])
        R0 = level_planes(f0, k, params, store)
        R1 = level_planes(f1, k, params, store)
        for _ in range(params["iterations"]):
            M = store(normal_equations(R0, R1, u, v))
            u, v = (store(t) for t in solve(M, params["winsize"]))
    return torch.stack([u, v], -1)
