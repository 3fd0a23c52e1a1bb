"""Pixel flow -> metric velocity estimation (numpy only).

The port's own copy of the reference's ``runtime/velocity.py``:
``VelocityEstimator`` (mean or median of horizontal flow, optional boolean
mask, division by dt with the dt <= 0 -> 1e-3 clock-glitch guard, static or
dynamic pixel_to_meter = median_depth / fx, and deque smoothing) and
``junction_mask``.
"""
from __future__ import annotations

import collections

import numpy as np


class VelocityEstimator:
    def __init__(
        self,
        pixel_to_meter: float = 0.000857,
        aggregate: str = "mean",
        smooth_window: int = 5,
        max_speed: float | None = None,
    ):
        if aggregate not in ("mean", "median"):
            raise ValueError(f"aggregate must be 'mean' or 'median', got {aggregate!r}")
        self.pixel_to_meter = pixel_to_meter
        self.aggregate = aggregate
        self._smooth = collections.deque(maxlen=smooth_window)
        self.max_speed = max_speed
        self._fx: float | None = None
        self._depth: float | None = None

    # --- dynamic calibration inputs -------------------------------------
    def set_fx(self, fx: float) -> None:
        self._fx = fx
        self._update_scale()

    def set_depth(self, depth_m: float) -> None:
        self._depth = depth_m
        self._update_scale()

    def _update_scale(self) -> None:
        if self._fx and self._depth and self._fx > 0:
            self.pixel_to_meter = self._depth / self._fx

    # --- per-frame ------------------------------------------------------
    def update(
        self, flow: np.ndarray, dt: float, mask: np.ndarray | None = None
    ) -> tuple[float, float, float]:
        """Returns (vx_raw, vx_smooth, vy_raw) in m/s."""
        if dt <= 0:
            dt = 1e-3
        u = flow[..., 0]
        v = flow[..., 1]
        if mask is not None and mask.any():
            u = u[mask]
            v = v[mask]
        agg = np.mean if self.aggregate == "mean" else np.median
        vx = float(agg(u)) / dt * self.pixel_to_meter
        vy = float(agg(v)) / dt * self.pixel_to_meter
        if self.max_speed is not None:
            vx = float(np.clip(vx, -self.max_speed, self.max_speed))
            vy = float(np.clip(vy, -self.max_speed, self.max_speed))
        self._smooth.append(vx)
        return vx, float(np.mean(self._smooth)), vy

    def update_from_displacement(self, du_px: float, dt: float) -> tuple[float, float]:
        """Velocity from an already-aggregated pixel displacement (sparse
        trackers aggregate over tracked points, not a dense field).  Applies
        the same dt guard, scale, clamp and smoothing as :meth:`update`;
        returns (vx_raw, vx_smooth) in m/s."""
        if dt <= 0:
            dt = 1e-3
        vx = float(du_px) / dt * self.pixel_to_meter
        if self.max_speed is not None:
            vx = float(np.clip(vx, -self.max_speed, self.max_speed))
        self._smooth.append(vx)
        return vx, float(np.mean(self._smooth))


def junction_mask(
    shape: tuple[int, int], points: np.ndarray, box: int = 11
) -> np.ndarray:
    """Boolean mask of ``box`` x ``box`` squares centered on each junction
    point (x, y), clipped at the border; points outside the image mark
    nothing (reference ``runtime/velocity.py:82``)."""
    H, W = shape
    mask = np.zeros((H, W), bool)
    r = box // 2
    for x, y in np.asarray(points).reshape(-1, 2):
        xi, yi = int(round(x)), int(round(y))
        if 0 <= xi < W and 0 <= yi < H:
            mask[max(yi - r, 0) : yi + r + 1, max(xi - r, 0) : xi + r + 1] = True
    return mask
