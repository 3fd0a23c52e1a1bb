"""Multi-stream batched inference: N camera streams on one card (the port's
copy of the reference's ``runtime/multistream.py``; BASELINE config 5 is
2x1080p at 60 fps).

Each stream keeps a latest-frame-pair slot; one batcher thread takes every
ready pair, stacks them into one [n, H, W] batch and runs one batched flow
call, so the card sees n streams' work per launch, and each stream's
velocity is published from the batched result.  Streams share a
resolution.  The backends run exactly the ready rows, n <= n_streams (the
reference pads each batch to a fixed row count, ``runtime/multistream.py``
:180-189 and :254-330).
"""
from __future__ import annotations

import threading
import time
from typing import Callable

import numpy as np
import torch

from ..classical.farneback import (
    calc_optical_flow_farneback,
    check_flow_kwargs,
    farneback_stream_planes,
    farneback_stream_step,
)
from ..core.device import device_scope, resolve_device
from .bus import Bus
from .fused import _aggregate_u, check_aggregate
from .messages import Header, Vector3StampedMsg
from .nodes import _bgr_to_gray_np
from .velocity import VelocityEstimator


class _StreamSlot:
    """Latest-pair slot.  Under load the batcher may not take a pair before
    the next push overwrites it; ``take`` therefore also reports whether any
    pair was dropped since the last take, so stateful backends (whose device
    state holds the planes of the last *processed* frame) can reseed from the
    pair's actual prev frame instead of silently warping across the dropped
    interval (flow over a multi-frame gap divided by a single-pair dt).
    ``pairs_dropped`` counts every overwritten pair."""

    def __init__(self):
        self.lock = threading.Lock()
        self.prev: tuple[np.ndarray, float] | None = None
        self.pair: tuple[np.ndarray, np.ndarray, float, float] | None = None
        self._dropped = False
        self.pairs_dropped = 0

    def push(self, gray: np.ndarray, stamp: float):
        with self.lock:
            if self.prev is not None:
                if self.pair is not None:
                    self._dropped = True  # untaken pair overwritten
                    self.pairs_dropped += 1
                self.pair = (self.prev[0], gray, self.prev[1], stamp)
            self.prev = (gray, stamp)

    def take(self):
        """Returns (pair, dropped_since_last_take) or None."""
        with self.lock:
            pair, self.pair = self.pair, None
            dropped, self._dropped = self._dropped, False
            return None if pair is None else (pair, dropped)


class MultiStreamFlow:
    """``batched_backend``: (prev [n,H,W], cur [n,H,W]) -> flow [n,H,W,2]
    (e.g. :func:`make_batched_farneback`), or [n] displacements for the
    fused backends (``returns_displacement``), or with ``stateful`` also the
    rows' stream indices and dropped flags.  Each stream i publishes
    /optical_flow/<name><i>_velocity and ..._smooth_velocity on the shared
    bus.

    ``pipeline_depth=1`` (fused backends): the batcher queues batch n+1's
    device work before it brings batch n's displacements to the host, so
    that copy's wait overlaps the next batch's device work; publishing is
    one batch later.  ``pipeline_depth=0`` publishes each batch before
    taking the next."""

    def __init__(
        self,
        bus: Bus,
        batched_backend: Callable,
        n_streams: int,
        pixel_to_meter: float = 0.000566,
        name: str = "STREAM",
        aggregate: str = "mean",
        pipeline_depth: int = 1,
    ):
        self.bus = bus
        self.backend = batched_backend
        self.slots = [_StreamSlot() for _ in range(n_streams)]
        self.vels = [
            VelocityEstimator(pixel_to_meter, aggregate) for _ in range(n_streams)
        ]
        self.name = name
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.batches = 0
        self.fields = 0
        self.pipeline_depth = int(pipeline_depth)

    @property
    def pairs_dropped(self) -> int:
        return sum(s.pairs_dropped for s in self.slots)

    def push_frame(self, stream: int, frame: np.ndarray, stamp: float):
        """A stream's next frame: BGR (made gray on the host, BT.601) or
        gray."""
        gray = (
            _bgr_to_gray_np(frame)
            if frame.ndim == 3
            else frame.astype(np.float32)
        )
        self.slots[stream].push(gray, stamp)

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> bool:
        """Stop the batcher (publishing what it has dispatched); True when
        its thread has ended within ``timeout`` seconds."""
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=timeout)
            return not self._thread.is_alive()
        return True

    def _publish(self, ready, out):
        # the host copy (a device tensor waits for its batch here)
        out = out.cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
        fused = getattr(self.backend, "returns_displacement", False)
        self.batches += 1
        self.fields += len(ready)
        for k, (i, (_, _, t0, t1), _) in enumerate(ready):
            dt = t1 - t0
            if fused:
                # [n] displacements aggregated on the device
                vx, vx_s = self.vels[i].update_from_displacement(
                    float(out[k]), dt
                )
            else:
                vx, vx_s, _ = self.vels[i].update(out[k], dt)
            self.bus.publish(
                f"/optical_flow/{self.name}{i}_velocity",
                Vector3StampedMsg(Header(t1), vx),
            )
            self.bus.publish(
                f"/optical_flow/{self.name}{i}_smooth_velocity",
                Vector3StampedMsg(Header(t1), vx_s),
            )

    def _run(self):
        pending = None  # (ready, device_out): dispatched, not yet published
        fused = getattr(self.backend, "returns_displacement", False)
        while not self._stop.is_set():
            ready = []
            for i, slot in enumerate(self.slots):
                taken = slot.take()
                if taken is not None:
                    ready.append((i, taken[0], taken[1]))
            if not ready:
                if pending is not None:
                    self._publish(*pending)
                    pending = None
                time.sleep(0.001)
                continue
            idxs = [i for i, _, _ in ready]
            prev = np.stack([p[0] for _, p, _ in ready])
            cur = np.stack([p[1] for _, p, _ in ready])
            dropped = [d for _, _, d in ready]
            if getattr(self.backend, "stateful", False):
                out = self.backend(prev, cur, idxs, dropped)
            else:
                out = self.backend(prev, cur)
            if fused and self.pipeline_depth > 0:
                prev_pending, pending = pending, (ready, out)
                if prev_pending is not None:
                    self._publish(*prev_pending)
            else:
                self._publish(ready, out)
        if pending is not None:
            self._publish(*pending)


def _du_rows(flow: torch.Tensor, aggregate: str) -> torch.Tensor:
    """[n] aggregated u of [n, H, W, 2] flow, row by row: each row reduces
    exactly as a single stream's step does (:func:`.fused._aggregate_u`)."""
    return torch.stack([_aggregate_u(f[..., 0], None, aggregate) for f in flow])


def make_batched_farneback(n_streams: int, *, device=None, **kwargs) -> Callable:
    """Batched Farneback backend for MultiStreamFlow: (prev, cur) [n, H, W]
    gray -> flow [n, H, W, 2] numpy, n <= ``n_streams``, on ``device`` (the
    card unless ``"cpu"``)."""
    check_flow_kwargs("make_batched_farneback", kwargs)
    dev = resolve_device(device)

    def backend(prev, cur):
        if prev.shape[0] > n_streams:
            raise ValueError(f"{prev.shape[0]} rows for {n_streams} streams")
        with device_scope(dev):
            return calc_optical_flow_farneback(prev, cur, device=dev,
                                               **kwargs).cpu().numpy()

    return backend


def make_batched_fused_farneback(n_streams: int, aggregate: str = "mean", *,
                                 device=None, **kwargs) -> Callable:
    """Fused batched backend: flow and each row's horizontal-displacement
    aggregate on the device -- [n, H, W] pairs in, an unsynced [n] device
    tensor of pixel displacements out (``MultiStreamFlow._publish`` makes
    the one host copy)."""
    check_flow_kwargs("make_batched_fused_farneback", kwargs)
    check_aggregate(aggregate)
    dev = resolve_device(device)

    def backend(prev, cur):
        if prev.shape[0] > n_streams:
            raise ValueError(f"{prev.shape[0]} rows for {n_streams} streams")
        with device_scope(dev):
            flow = calc_optical_flow_farneback(prev, cur, device=dev, **kwargs)
            return _du_rows(flow, aggregate)

    backend.returns_displacement = True
    return backend


def make_stateful_batched_fused_farneback(n_streams: int,
                                          aggregate: str = "mean", *,
                                          device=None, **kwargs) -> Callable:
    """Planes-carrying batched fused backend: the device state holds every
    stream's previous-frame expansion, one [n_streams, 5, lh, lw] tensor per
    pyramid level (allocated at the first batch), so each streamed frame is
    expanded once.  Contract: ``backend(prev, cur, idxs, dropped=None)``
    with ``idxs`` the stream index of each row; the ready rows' state is
    taken with ``index_select``, stepped at B = n
    (``farneback_stream_step``) and written back with ``index_copy_``.
    Streams are seeded from ``prev`` on their first batch, and so are rows
    flagged ``dropped`` (their slot overwrote an untaken pair, so the
    stored planes are older than the pair's prev).  Returns an unsynced
    [n] device tensor of pixel displacements.  Frames of another size than
    the first batch's raise ``ValueError``."""
    check_flow_kwargs("make_stateful_batched_fused_farneback", kwargs)
    check_aggregate(aggregate)
    dev = resolve_device(device)
    state: list[torch.Tensor] | None = None
    seeded = np.zeros(n_streams, bool)
    res = None

    def backend(prev, cur, idxs, dropped=None):
        nonlocal state, res
        if res is None:
            res = tuple(cur.shape[-2:])
        elif tuple(cur.shape[-2:]) != res:
            raise ValueError(
                f"stateful backend was built for {res[0]}x{res[1]} frames, "
                f"got {cur.shape[-2]}x{cur.shape[-1]}; streams sharing a "
                f"backend must share a resolution (one state)")
        rows = np.asarray(idxs, np.int64)
        fresh = ~seeded[rows]
        if dropped is not None:
            fresh |= np.asarray(dropped, bool)
        with device_scope(dev):
            if fresh.any():
                # only the rows that need it: their prev frame's expansion
                f = np.flatnonzero(fresh)
                seeds = farneback_stream_planes(
                    np.ascontiguousarray(prev[f]), device=dev, **kwargs)
                if state is None:
                    state = [torch.zeros((n_streams,) + tuple(s.shape[1:]),
                                         dtype=s.dtype, device=dev)
                             for s in seeds]
                f_t = torch.from_numpy(rows[f]).to(dev)
                for L, S in zip(state, seeds):
                    L.index_copy_(0, f_t, S)
            idx = torch.from_numpy(rows).to(dev)
            R0 = tuple(L.index_select(0, idx) for L in state)
            flow, new = farneback_stream_step(R0, cur, device=dev, **kwargs)
            for L, P in zip(state, new):
                L.index_copy_(0, idx, P)
            seeded[rows] = True
            return _du_rows(flow, aggregate)

    backend.returns_displacement = True
    backend.stateful = True
    return backend
