"""Shi-Tomasi corners, ``cv2.goodFeaturesToTrack`` parity (the port's own
copy of what the Lucas-Kanade node takes from cv2; the card's machine has
no cv2).

cv2's documented algorithm with its defaults (blockSize 3, gradientSize 3,
no Harris, no mask) on an 8-bit image:

1. ``cornerMinEigenVal``: 3x3 Sobel derivatives at cv2's 8-bit scale
   1 / (4 * 3 * 255), REFLECT_101 border; the products dx^2, dx dy, dy^2
   summed over 3x3 blocks (REFLECT_101); the smaller eigenvalue of each
   block's 2x2 matrix;
2. every value not above ``quality_level`` times the maximum set to zero;
3. candidates: the non-zero 3x3 local maxima, the 1-pixel border excluded;
4. candidates sorted by response, descending, ties by raster position,
   the later first (cv2's ``greaterThanPtr`` compares addresses);
5. a greedy pass in that order keeps a corner unless one already kept lies
   closer than ``min_distance`` (a grid of min_distance cells limits the
   search), until ``max_corners`` are kept.

Steps 1-3 run on the image's device as tensors, in the order of cv2's own
floating-point operations: the Sobel outputs are formed in float64 and
rounded once where cv2's vectorized filters fuse a multiply and an add, the
block sums in float64 as cv2's box filter sums them, the square root
correctly rounded.  On camera-like (smooth) images the responses equal
cv2's bit for bit, at widths that are a multiple of cv2's vector width (the
columns of its scalar tail round the Sobel dy row pass otherwise).  Where
the products of a block span more than ~2^29 (white noise), cv2's running
float64 column sums round, and the responses differ from these in the last
bits.  The candidates (a few thousand) come
to the host for steps 4-5.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .device import resolve_device

# cv2's derivative scale for an 8-bit image: 2^(ksize - 1) * blockSize * 255
_SCALE = np.float32(1.0 / (4 * 3 * 255.0))


def _reflect101(x: torch.Tensor) -> torch.Tensor:
    """[H, W] padded by 1 on each side, BORDER_REFLECT_101."""
    return F.pad(x[None, None], (1, 1, 1, 1), mode="reflect")[0, 0]


def corner_min_eig_val(gray: torch.Tensor) -> torch.Tensor:
    """``cv2.cornerMinEigenVal(gray, 3, ksize=3)`` of an 8-bit [H, W] image
    (any integer or float dtype holding the 8-bit values), fp32."""
    s = _SCALE
    p = _reflect101(gray.to(torch.float64))
    # Sobel dx: the row pass [-1, 0, 1] is exact in integers; the column
    # pass [s, 2s, s] is cv2's symmetric form, 2s * centre rounded, then
    # s * (up + down) fused into it
    rx = p[:, 2:] - p[:, :-2]
    dx = ((np.float32(2 * s) * rx[1:-1].float()).double()
          + float(s) * (rx[:-2] + rx[2:])).float()
    # Sobel dy: the row pass [s, 2s, s] is s times the exact integer sum,
    # rounded once; the column pass [-1, 0, 1] subtracts in fp32
    row = (float(s) * (p[:, :-2] + 2 * p[:, 1:-1] + p[:, 2:])).float()
    dy = row[2:] - row[:-2]
    H, W = gray.shape

    def block_sum(c: torch.Tensor) -> torch.Tensor:
        q = _reflect101(c.double())
        acc = None
        for i in range(3):
            for j in range(3):
                term = q[i:i + H, j:j + W]
                acc = term if acc is None else acc + term
        return acc.float()

    a = block_sum(dx * dx) * 0.5
    b = block_sum(dx * dy)
    c = block_sum(dy * dy) * 0.5
    t = a - c
    # a correctly rounded fp32 square root, as cv2's (torch's vectorized CPU
    # sqrt is not): through float64, whose rounding to fp32 is exact here
    return (a + c) - torch.sqrt((t * t + b * b).double()).float()


@torch.inference_mode()
def good_features_to_track(gray, max_corners: int, quality_level: float,
                           min_distance: float, *, device=None) -> np.ndarray:
    """``cv2.goodFeaturesToTrack(gray, max_corners, quality_level,
    min_distance)`` of an 8-bit [H, W] image (numpy or torch, values 0-255):
    the corners as a float32 [N, 2] (x, y) numpy array, strongest first
    (N = 0 when there are none; ``max_corners <= 0`` keeps every one).  The
    response map is computed on ``device`` (CUDA unless ``"cpu"``)."""
    dev = resolve_device(device)
    if not isinstance(gray, torch.Tensor):
        gray = torch.from_numpy(np.ascontiguousarray(gray))
    if gray.dim() != 2:
        raise ValueError(f"expected one [H, W] gray image, got {tuple(gray.shape)}")
    eig = corner_min_eig_val(gray.to(dev))
    H, W = eig.shape
    # cv2 thresholds at the fp32 rounding of max * quality (double)
    thresh = np.float32(float(eig.max()) * quality_level)
    eig = torch.where(eig > float(thresh), eig, 0.0)
    dil = F.max_pool2d(eig[None, None], 3, stride=1, padding=1)[0, 0]
    keep = (eig != 0) & (eig == dil)
    keep[0] = keep[-1] = False
    keep[:, 0] = keep[:, -1] = False
    lin = keep.flatten().nonzero().squeeze(1)
    val = eig.flatten()[lin].cpu().numpy()
    lin = lin.cpu().numpy()
    order = np.lexsort((-lin, -val))  # response descending, later first
    ys, xs = np.divmod(lin[order], W)
    n_max = max_corners if max_corners > 0 else len(order)
    if min_distance < 1:
        pts = np.stack([xs[:n_max], ys[:n_max]], -1)
        return pts.astype(np.float32).reshape(-1, 2)
    cell = int(np.rint(min_distance))  # cvRound
    gw = (W + cell - 1) // cell
    gh = (H + cell - 1) // cell
    grid: list[list[tuple[int, int]]] = [[] for _ in range(gw * gh)]
    d2 = float(min_distance) ** 2
    kept: list[tuple[int, int]] = []
    for x, y in zip(xs.tolist(), ys.tolist()):
        xc, yc = x // cell, y // cell
        good = True
        for yy in range(max(yc - 1, 0), min(yc + 1, gh - 1) + 1):
            for xx in range(max(xc - 1, 0), min(xc + 1, gw - 1) + 1):
                for px, py in grid[yy * gw + xx]:
                    if (x - px) ** 2 + (y - py) ** 2 < d2:
                        good = False
                        break
                if not good:
                    break
            if not good:
                break
        if good:
            grid[yc * gw + xc].append((x, y))
            kept.append((x, y))
            if len(kept) == n_max:
                break
    return np.asarray(kept, np.float32).reshape(-1, 2)
