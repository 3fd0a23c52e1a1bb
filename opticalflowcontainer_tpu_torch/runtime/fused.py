"""Streaming step on the device: uint8 BGR frame -> gray -> Farneback flow
against the previous frame's carried expansion -> aggregated horizontal
displacement (port of the reference's ``runtime/fused.py``).

Per frame the host sends one uint8 frame and receives one fp32 scalar; the
flow field never leaves the device.  :class:`FusedFarnebackStream` owns the
device-resident state (the previous frame's per-level expansion planes,
:func:`classical.farneback.farneback_stream_planes`), so every frame is
expanded once.  ``step()`` returns the displacement as an unsynced 0-dim
device tensor; ``float(du)`` syncs.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..classical.farneback import (
    FLOW_KWARGS,
    farneback_stream_planes,
    farneback_stream_step,
)
from ..core.color import bgr_to_gray
from ..core.device import resolve_device


def _aggregate_u(u: torch.Tensor, mask: torch.Tensor | None,
                 aggregate: str) -> torch.Tensor:
    """Mean or median of ``u`` over ``mask`` (all of ``u`` when the mask is
    None or all False, as ``VelocityEstimator.update`` does), NaN scrubbed.
    The median of an even count is the mean of the two middle values."""
    u = u.float()
    if aggregate == "mean":
        full = u.mean()
    else:
        full = torch.quantile(u.reshape(-1), 0.5)
    if mask is None:
        return torch.nan_to_num(full)
    # an all-False mask falls back to the full frame: without it an empty
    # junction mask yields NaN (median) / 0 (mean) and poisons the smoothing
    if aggregate == "mean":
        m = mask.float()
        masked = (u * m).sum() / m.sum().clamp_min(1.0)
    else:
        masked = torch.nanquantile(
            torch.where(mask, u, torch.nan).reshape(-1), 0.5)
    return torch.nan_to_num(torch.where(mask.any(), masked, full))


class FusedFarnebackStream:
    """Stateful streaming step.  ``step(frame)`` returns the aggregated
    pixel displacement du (0-dim device tensor, unsynced) or None on the
    first frame; ``step_many(frames)`` runs K frames from one upload."""

    def __init__(self, aggregate: str = "mean", *, device=None, **fb_kwargs):
        if aggregate not in ("mean", "median"):
            raise ValueError(f"aggregate must be 'mean' or 'median', got {aggregate!r}")
        unknown = set(fb_kwargs) - FLOW_KWARGS
        if unknown:
            raise TypeError(f"FusedFarnebackStream got unexpected keyword(s) "
                            f"{sorted(unknown)}; supported: {sorted(FLOW_KWARGS)}")
        self.aggregate = aggregate
        self.device = resolve_device(device)
        self.fb_kwargs = dict(fb_kwargs)
        self._state: tuple | None = None  # previous frame's planes

    def reset(self) -> None:
        self._state = None

    def warmup(self, frame: np.ndarray, mask: np.ndarray | None = None) -> None:
        """Run the first-frame and steady-state steps once (builds the
        kernels) and restore the state."""
        s0 = self._state
        self.step(frame, mask)
        self.step(frame, mask)
        self._state = s0

    def _upload(self, frames, mask):
        x = frames if isinstance(frames, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(frames))
        m = None
        if mask is not None:
            m = (mask if isinstance(mask, torch.Tensor)
                 else torch.from_numpy(np.ascontiguousarray(mask, dtype=bool)))
            m = m.to(self.device, torch.bool)
        return x.to(self.device), m

    def _gray(self, frame: torch.Tensor) -> torch.Tensor:
        f = frame.float()
        return bgr_to_gray(f) if f.dim() == 3 else f

    def _advance(self, frame: torch.Tensor, mask: torch.Tensor | None):
        gray = self._gray(frame)
        flow, self._state = farneback_stream_step(
            self._state, gray, device=self.device, **self.fb_kwargs)
        return _aggregate_u(flow[..., 0], mask, self.aggregate)

    def step(self, frame: np.ndarray, mask: np.ndarray | None = None):
        """du (0-dim device fp32 tensor, pixels), or None on the first frame."""
        x, m = self._upload(frame, mask)
        if self._state is None:
            self._state = farneback_stream_planes(
                self._gray(x), device=self.device, **self.fb_kwargs)
            return None
        return self._advance(x, m)

    def step_many(self, frames: np.ndarray, mask: np.ndarray | None = None):
        """``frames`` [K, H, W(, 3)] -> [K] displacements: one upload, then
        the per-frame step on each (the same numbers as K ``step`` calls)."""
        if self._state is None:
            raise RuntimeError("seed the stream with step(first_frame) "
                               "before step_many")
        x, m = self._upload(frames, mask)
        return torch.stack([self._advance(f, m) for f in x])


def make_fused_farneback_backend(aggregate: str = "mean", *, device=None,
                                 **fb_kwargs) -> Callable:
    """Flow-node backend wrapping :class:`FusedFarnebackStream`.

    Stateful: the previous frame's planes live on the device, so ``prev`` is
    used only to seed the first call.  Returns the aggregated pixel
    displacement (``returns_displacement``), which the node feeds to
    ``VelocityEstimator.update_from_displacement``."""
    stream = FusedFarnebackStream(aggregate=aggregate, device=device, **fb_kwargs)

    def backend(prev, cur, dt, mask=None):
        if stream._state is None:
            stream.step(prev, mask)
        return float(stream.step(cur, mask))

    backend.wants_color = True
    backend.returns_displacement = True
    backend.stream = stream
    return backend
