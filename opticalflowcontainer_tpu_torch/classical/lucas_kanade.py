"""Sparse pyramidal Lucas-Kanade tracking, cv2.calcOpticalFlowPyrLK parity,
in PyTorch (the reference's ``classical/lucas_kanade.py``).

Bouguet-style pyramidal LK: for each point, at each pyramid level (coarse to
fine), iterate the 2x2 windowed least-squares solve
    G = sum_w [Ix^2, IxIy; IxIy, Iy^2],  d += G^-1 * sum_w [It*Ix, It*Iy]
with bilinear sampling of the image and of the Scharr-derivative planes at
sub-pixel positions.  Image windows read a REFLECT_101 border, derivative
windows read zeros outside the level (cv2's split in
``buildOpticalFlowPyramid``).  Float math throughout, as the reference.

Vectorized over points: every point's window is gathered as an [N, win, win]
stack (four taps a sample), and each level runs exactly ``max_iters``
solver steps with no host synchronization inside the loop.  A point whose
step falls below ``eps`` is frozen for that step only; the test is made
again at every step (the reference's ``fori_loop`` body), so a frozen point
can move again.  The reference's fat-row gather layouts
(``_unfold_pairrows``, ``_gather_windows_packed``) exist for the TPU's
gather cost and have no counterpart here.  The reference leaves the whole
tracker to XLA (no Pallas kernel), so it stays plain PyTorch on every
device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.device import cached_tensors, resolve_device
from ..core.filters import scharr_deriv
from ..core.pyramid import gaussian_pyramid


class LKResult(NamedTuple):
    pts: torch.Tensor  # [N, 2] tracked positions (x, y), fp32
    status: torch.Tensor  # [N] uint8: 1 = tracked
    err: torch.Tensor  # [N] fp32: mean absolute window residual (cv2-style)


@cached_tensors(16)
def _window_tables(win: int, device: torch.device):
    """On ``device``: the offsets -r..r [win] of a window's taps from its
    centre (fp32), and the steps (0, 1) [2, 1, 1] to a sample's second
    tap row or column."""
    r = win // 2
    offsets = torch.arange(-r, win - r, dtype=torch.float32)
    return offsets.to(device), torch.tensor([0, 1]).reshape(2, 1, 1).to(device)


def _reflect101(idx: torch.Tensor, n: int) -> torch.Tensor:
    """BORDER_REFLECT_101 index mapping (one reflection each side, enough
    for window overhangs below n - 1)."""
    idx = idx.abs()
    idx = torch.where(idx >= n, (2 * (n - 1) - idx).abs(), idx)
    return idx.clamp(0, n - 1)


def _gather_windows(img: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor,
                    win: int, border: str = "reflect101") -> torch.Tensor:
    """Bilinear-sampled [N, win, win] windows of ``img`` [H, W] centred at
    the fp32 positions (cx, cy) [N].  Off-image taps read REFLECT_101
    (``"reflect101"``, the pyramid levels) or zero (``"zeros"``, the
    derivative planes).

    A window's sample columns share their x and its rows their y, so
    coordinates, weights and border indices are formed per row and per
    column ([N, win]; the same fp32 values as the reference's per-tap
    ones) and the four taps of every sample are read with one ``take``."""
    H, W = img.shape
    offsets, steps = _window_tables(win, img.device)
    x = cx[:, None] + offsets  # x of window column j
    y = cy[:, None] + offsets  # y of window row i
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[:, None, :]
    wy = (y - y0)[:, :, None]
    ix = x0.long() + steps  # [2, N, win]: the left and right tap columns
    iy = y0.long() + steps  # the upper and lower tap rows
    if border == "reflect101":
        lin = (_reflect101(iy, H) * W)[:, None, :, :, None] + _reflect101(ix, W)[None, :, :, None, :]
        v = img.take(lin)  # [2 (row), 2 (column), N, win, win]
    else:
        ok = (((iy >= 0) & (iy < H))[:, None, :, :, None]
              & ((ix >= 0) & (ix < W))[None, :, :, None, :])
        lin = (iy.clamp(0, H - 1) * W)[:, None, :, :, None] + ix.clamp(0, W - 1)[None, :, :, None, :]
        v = torch.where(ok, img.take(lin), 0.0)
    # bilinear blend along x, then along y
    rows = v[:, 0] * (1 - wx) + v[:, 1] * wx
    return rows[0] * (1 - wy) + rows[1] * wy


def _in_bounds(qx, qy, r: int, win: int, H: int, W: int) -> torch.Tensor:
    """cv2 drops a point only when its window's origin is more than a full
    window outside the image: windows may hang off the edge."""
    return (qx - r >= -win) & (qx - r < W) & (qy - r >= -win) & (qy - r < H)


def _pyr_lk(prev_pyr, next_pyr, pts: torch.Tensor, init: torch.Tensor,
            win: int, max_iters: int, eps: float, levels: int,
            min_eig_threshold: float):
    N = pts.shape[0]
    dev = pts.device
    guess = init / (2.0 ** levels)  # at the coarsest level, in its coords
    status = torch.ones(N, dtype=torch.bool, device=dev)
    err = torch.zeros(N, dtype=torch.float32, device=dev)
    # the reference squares eps in fp32
    eps32 = torch.tensor(eps, dtype=torch.float32)
    eps2 = float(eps32 * eps32)
    r = win // 2
    for lvl in range(levels, -1, -1):
        I0 = prev_pyr[lvl]
        I1 = next_pyr[lvl]
        H, W = I0.shape
        gx, gy = scharr_deriv(I0)
        p_lvl = pts / (2.0 ** lvl)
        if lvl != levels:
            guess = guess * 2.0
        cx, cy = p_lvl[:, 0], p_lvl[:, 1]
        # template windows and gradients at the (fixed) prev-frame position
        T = _gather_windows(I0, cx, cy, win, "reflect101")
        Gx = _gather_windows(gx, cx, cy, win, "zeros")
        Gy = _gather_windows(gy, cx, cy, win, "zeros")
        gxx = (Gx * Gx).sum((1, 2))
        gxy = (Gx * Gy).sum((1, 2))
        gyy = (Gy * Gy).sum((1, 2))
        det = gxx * gyy - gxy * gxy
        # cv2 takes the eigenvalue of fixed-point Scharr sums (x32, FLT_SCALE
        # 2^-20): its scale is this one / 1024, so the default 1e-4
        # threshold keeps the same points
        min_eig = (gyy + gxx - torch.sqrt((gxx - gyy) ** 2 + 4.0 * gxy ** 2)) / (
            2.0 * win * win * 1024.0)
        inb0 = _in_bounds(cx, cy, r, win, H, W)
        solvable = (min_eig > min_eig_threshold) & (det > 1e-12)
        lvl_ok = inb0 & solvable
        idet = torch.where(det > 1e-12, 1.0 / det, 0.0)[:, None]
        # step = -adj(G) b / det, adj(G) = [[gyy, -gxy], [-gxy, gxx]]
        adj = torch.stack([torch.stack([gyy, -gxy], -1),
                           torch.stack([-gxy, gxx], -1)], 1)  # [N, 2, 2]
        G = torch.stack([Gx, Gy], 1)  # [N, 2, win, win]
        c = p_lvl
        d = guess
        for i in range(max_iters):
            q = c + d
            Jw = _gather_windows(I1, q[:, 0], q[:, 1], win)
            b = ((Jw - T)[:, None] * G).sum((2, 3))  # [N, 2]
            step = -(adj * b[:, None, :]).sum(-1) * idet
            # freeze, for this step only, points that converged or cannot
            # be solved (re-tested every step, as the reference does)
            move = lvl_ok if i == 0 else lvl_ok & ((step * step).sum(-1) >= eps2)
            d = d + torch.where(move[:, None], step, 0.0)
        if lvl == 0:
            # status and err are decided at level 0 only (cv2 semantics)
            qx, qy = cx + d[:, 0], cy + d[:, 1]
            status = status & inb0 & _in_bounds(qx, qy, r, win, H, W) & solvable
            Jw = _gather_windows(I1, qx, qy, win)
            err = (Jw - T).abs().sum((1, 2)) / (win * win)
        guess = d
    return pts + guess, status, err


def _as_f32(x, device: torch.device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device).float()


@torch.inference_mode()
def calc_optical_flow_pyr_lk(prev_img, next_img, prev_pts, next_pts=None,
                             win_size: tuple[int, int] = (21, 21),
                             max_level: int = 3,
                             criteria: tuple = (30, 0.01),
                             min_eig_threshold: float = 1e-4,
                             use_initial_flow: bool = False, *,
                             device=None) -> LKResult:
    """``cv2.calcOpticalFlowPyrLK`` parity (forward tracking).

    ``prev_img``, ``next_img``: [H, W] gray images (uint8 range, numpy or
    torch); ``prev_pts``: [N, 2] (x, y).  Returns :class:`LKResult` on
    ``device`` (CUDA unless ``device="cpu"``).  ``criteria`` is this API's
    ``(count, eps)`` or cv2's ``(type, count, eps)``.  ``next_pts`` seeds
    the search only with ``use_initial_flow=True`` (cv2's
    OPTFLOW_USE_INITIAL_FLOW; without it cv2 treats nextPts as an output
    buffer).  ``max_level`` is clamped to floor(log2(min(H, W) / 32)), as
    the reference does."""
    if win_size[0] != win_size[1]:
        raise NotImplementedError(
            f"win_size={win_size}: only square LK windows are implemented; "
            "silently using the width would change the G matrices and "
            "off-image sampling vs cv2")
    dev = resolve_device(device)
    prev_img = _as_f32(prev_img, dev)
    next_img = _as_f32(next_img, dev)
    if prev_img.dim() != 2 or prev_img.shape != next_img.shape:
        raise ValueError(f"prev {tuple(prev_img.shape)} and next "
                         f"{tuple(next_img.shape)} must be one [H, W] shape")
    H, W = prev_img.shape
    max_level = min(max_level,
                    int(np.floor(np.log2(max(min(H, W) / 32.0, 1.0)))))
    pts = _as_f32(prev_pts, dev).reshape(-1, 2)
    if next_pts is None or not use_initial_flow:
        init = torch.zeros_like(pts)
    else:
        init = _as_f32(next_pts, dev).reshape(-1, 2) - pts
    if len(criteria) == 3:  # cv2's (TERM_CRITERIA_* type, count, eps)
        criteria = criteria[1:]
    win = int(win_size[0])
    tracked, status, err = _pyr_lk(
        gaussian_pyramid(prev_img, max_level + 1),
        gaussian_pyramid(next_img, max_level + 1),
        pts, init, win, int(criteria[0]), float(criteria[1]), max_level,
        float(min_eig_threshold))
    return LKResult(tracked, status.to(torch.uint8), err)
