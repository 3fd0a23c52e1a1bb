"""One camera node's backend called frame after frame in a closed loop:
the node hands the backend the next frame as soon as it returns the last
one's velocity scalar (the reference's latest-frame node with a camera
faster than the flow).  The frames walk the pool forwards and backwards
from a seeded start, so no two consecutive frames jump."""
from __future__ import annotations

import time

import numpy as np

from .. import frames
from .clip import sync


class Loop:
    kind = "stream"
    fields_per_call = 1

    def __init__(self, system, traffic: dict, seed: int, device):
        self.system = system
        self.pool = frames.make_pool(traffic, seed, device)
        self.dt = 1.0 / traffic["camera_fps"]
        self.order = frames.ping_pong(
            frames.Schedule(seed, len(self.pool)).next(), len(self.pool))
        self.prev = next(self.order)
        self.device = device
        self.enqueue_s: list[float] = []
        self._last_enqueue = None
        self.backend = None

    def _instrument(self, backend) -> None:
        """Time ``stream.step`` up to its return, before the host syncs on
        the scalar (the backend looks the method up on its stream)."""
        stream = getattr(backend, "stream", None)
        if stream is None:
            return
        step = stream.step

        def timed_step(*args, **kwargs):
            t0 = time.perf_counter()
            out = step(*args, **kwargs)
            self._last_enqueue = time.perf_counter() - t0
            return out

        stream.step = timed_step

    def warmup(self) -> None:
        self.backend = self.system.stream_backend()
        self._instrument(self.backend)
        self.backend(self.pool[0], self.pool[1], self.dt)
        self.backend(self.pool[1], self.pool[2], self.dt)
        sync(self.device)
        if hasattr(self.backend, "stream"):
            self.backend.stream.reset()

    def release(self) -> None:
        """Drop the backend and the frame it carries."""
        self.backend = None

    def call(self):
        cur = next(self.order)
        self._last_enqueue = None
        du = self.backend(self.pool[self.prev], self.pool[cur], self.dt)
        if self._last_enqueue is not None:
            self.enqueue_s.append(self._last_enqueue)
        key, self.prev = (self.prev, cur), cur
        return key, du

    def check(self, samples: list) -> dict:
        """Largest gap (px) between the program's du and the reference's,
        the mean of u over the reference's flow of the same pair."""
        keys = [k for k, _ in samples]
        ref = self.system.reference_pairs(
            np.stack([self.pool[a] for a, _ in keys]),
            np.stack([self.pool[b] for _, b in keys]))
        du_ref = ref[..., 0].mean(dim=(1, 2)).cpu().numpy()
        du = np.array([float(d) for _, d in samples])
        return {"du_max_abs_px": float(np.max(np.abs(du - du_ref)))}
