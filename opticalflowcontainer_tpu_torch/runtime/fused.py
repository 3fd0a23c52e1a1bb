"""Streaming steps on the device (port of the reference's
``runtime/fused.py``): uint8 BGR frame in, aggregated horizontal pixel
displacement out.

Per frame the host sends one uint8 frame and receives one fp32 scalar; the
flow field never leaves the device.  :class:`FusedFarnebackStream` carries
the previous frame's per-level expansion planes
(:func:`classical.farneback.farneback_stream_planes`), so every frame is
expanded once; :class:`FusedModelStream` carries the previous normalized
frame into a learned model's ``estimate``.  ``step()`` returns the
displacement as an unsynced 0-dim device tensor; ``float(du)`` syncs.
"""
from __future__ import annotations

import copy
from typing import Callable

import numpy as np
import torch

from ..classical.farneback import (
    check_flow_kwargs,
    farneback_stream_planes,
    farneback_stream_step,
)
from ..core import spans
from ..core.color import bgr_to_gray
from ..core.device import device_scope, resolve_device
from ..models.common import cast_params


def check_aggregate(aggregate: str) -> None:
    if aggregate not in ("mean", "median"):
        raise ValueError(f"aggregate must be 'mean' or 'median', got {aggregate!r}")


def _aggregate_u(u: torch.Tensor, mask: torch.Tensor | None,
                 aggregate: str) -> torch.Tensor:
    """Mean or median of ``u`` over ``mask`` (all of ``u`` when the mask is
    None or all False, as ``VelocityEstimator.update`` does), NaN scrubbed.
    The median of an even count is the mean of the two middle values."""
    with spans.annotate(spans.STREAM_AGGREGATE):
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


def _upload(frames, mask, device: torch.device):
    """Frames (numpy or tensor, uploaded as they are: uint8 stays uint8)
    and the optional boolean mask on ``device``."""
    with spans.annotate(spans.STREAM_UPLOAD):
        x = frames if isinstance(frames, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(frames))
        m = None
        if mask is not None:
            m = (mask if isinstance(mask, torch.Tensor)
                 else torch.from_numpy(np.ascontiguousarray(mask, dtype=bool)))
            m = m.to(device, torch.bool)
        return x.to(device), m


class FusedFarnebackStream:
    """Stateful streaming step.  ``step(frame)`` returns the aggregated
    pixel displacement du (0-dim device tensor, unsynced) or None on the
    first frame; ``step_many(frames)`` runs K frames from one upload."""

    def __init__(self, aggregate: str = "mean", *, device=None, **fb_kwargs):
        check_aggregate(aggregate)
        check_flow_kwargs("FusedFarnebackStream", fb_kwargs)
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
        with spans.annotate(spans.STREAM_STEP):
            x, m = _upload(frame, mask, self.device)
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
        x, m = _upload(frames, mask, self.device)
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
        with device_scope(stream.device):
            if stream._state is None:
                stream.step(prev, mask)
            du = stream.step(cur, mask)
            with spans.annotate(spans.STREAM_WAIT):
                return float(du)

    backend.wants_color = True
    backend.returns_displacement = True
    backend.stream = stream
    return backend


class FusedModelStream:
    """Learned-model streaming step: uint8 BGR frame in, aggregated pixel
    displacement out (the reference's ``FusedModelStream``).  The frame goes
    up once, is normalized to [0, 1] on the device (BGR kept, the models'
    convention; ``bgr_to_rgb=True`` flips it for RGB-trained nets), and the
    previous normalized frame stays on the device as the state.

    ``estimate_fn(model, img1, img2) -> flow [H, W, 2]`` is any of the zoo's
    ``estimate`` functions (the weights live in the module).  ``model`` must
    sit on ``device`` (the card unless ``"cpu"`` is asked for).

    ``bf16=True`` serves the model in bfloat16 (reference
    ``FusedModelStream(bf16=True)``): the stream casts a copy of the model
    once (``self.model``; the caller's stays as it was), normalizes each
    frame in fp32 on the device and then casts it; the flow and du stay
    fp32."""

    def __init__(self, model, estimate_fn: Callable, aggregate: str = "mean",
                 bgr_to_rgb: bool = False, bf16: bool = False, *, device=None):
        check_aggregate(aggregate)
        self.device = resolve_device(device)
        where = {p.device for p in model.parameters()}
        if where != {self.device}:
            raise ValueError(f"the model's parameters are on {sorted(map(str, where))}, "
                             f"the stream runs on {self.device}")
        self.dtype = torch.bfloat16 if bf16 else torch.float32
        if bf16:
            model = cast_params(copy.deepcopy(model), self.dtype)
        self.model = model
        self.estimate_fn = estimate_fn
        self.aggregate = aggregate
        self.bgr_to_rgb = bgr_to_rgb
        self._prev: torch.Tensor | None = None  # previous normalized frame

    def reset(self) -> None:
        self._prev = None

    def warmup(self, frame: np.ndarray, mask: np.ndarray | None = None) -> None:
        """Run the first-frame and steady-state steps once and restore the
        state."""
        s0 = self._prev
        self.step(frame, mask)
        self.step(frame, mask)
        self._prev = s0

    def _normalize(self, frame: torch.Tensor) -> torch.Tensor:
        # times the fp32 reciprocal, as the reference rounds it
        f = frame.float() * (1.0 / 255.0)
        return (f.flip(-1) if self.bgr_to_rgb else f).to(self.dtype)

    def _advance(self, frame: torch.Tensor, mask: torch.Tensor | None):
        f = self._normalize(frame)
        flow = self.estimate_fn(self.model, self._prev, f)
        self._prev = f
        return _aggregate_u(flow[..., 0], mask, self.aggregate)

    def step(self, frame: np.ndarray, mask: np.ndarray | None = None):
        """du (0-dim device fp32 tensor, pixels), or None on the first frame."""
        with spans.annotate(spans.STREAM_STEP):
            x, m = _upload(frame, mask, self.device)
            if self._prev is None:
                self._prev = self._normalize(x)
                return None
            return self._advance(x, m)

    def step_many(self, frames: np.ndarray, mask: np.ndarray | None = None):
        """``frames`` [K, H, W, 3] -> [K] displacements: one upload, then
        the per-frame step on each (the same numbers as K ``step`` calls)."""
        if self._prev is None:
            raise RuntimeError("seed the stream with step(first_frame) "
                               "before step_many")
        x, m = _upload(frames, mask, self.device)
        return torch.stack([self._advance(f, m) for f in x])


def make_fused_model_backend(model, estimate_fn: Callable,
                             aggregate: str = "mean", bgr_to_rgb: bool = False,
                             bf16: bool = False, *, device=None) -> Callable:
    """Flow-node backend wrapping :class:`FusedModelStream` (``bf16=True``
    serves the model in bfloat16): the previous normalized frame lives on
    the device, so ``prev`` only seeds the first call; returns the
    aggregated pixel displacement (``returns_displacement``)."""
    stream = FusedModelStream(model, estimate_fn, aggregate, bgr_to_rgb, bf16,
                              device=device)

    def backend(prev, cur, dt, mask=None):
        with device_scope(stream.device):
            if stream._prev is None:
                stream.step(prev, mask)
            du = stream.step(cur, mask)
            with spans.annotate(spans.STREAM_WAIT):
                return float(du)

    backend.wants_color = True
    backend.returns_displacement = True
    backend.stream = stream
    return backend
