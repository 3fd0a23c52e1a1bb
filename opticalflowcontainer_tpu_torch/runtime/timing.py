"""Observability (the port's copy of the reference's ``runtime/timing.py``):
per-frame ``[timestamp, inference_time_s]`` CSV rows behind the node's
``write_csv`` flag, and PNG dumps of the frames whose velocity spikes."""
from __future__ import annotations

import os
import threading
import time


class CsvTimer:
    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(self.path, "w") as f:
            f.write("timestamp,inference_time_s\n")

    def record(self, stamp: float, elapsed: float) -> None:
        with self._lock, open(self.path, "a") as f:
            f.write(f"{stamp:.6f},{elapsed:.6f}\n")


class SpikeDumper:
    """Save the frame with its flow arrows (``viz.draw_flow_arrows``) as a
    PNG whenever |vx| exceeds ``threshold`` m/s, at most ``max_dumps``
    times."""

    def __init__(self, out_dir: str = "spike_images", threshold: float = 0.00075,
                 max_dumps: int = 100):
        self.out_dir = out_dir
        self.threshold = threshold
        self.max_dumps = max_dumps
        self._count = 0

    def maybe_dump(self, frame, flow, vx: float) -> str | None:
        """The path written, or None when |vx| is within the threshold or the
        dumps are used up."""
        if abs(vx) <= self.threshold or self._count >= self.max_dumps:
            return None
        import numpy as np

        from ..utils.png import imwrite
        from .viz import draw_flow_arrows

        os.makedirs(self.out_dir, exist_ok=True)
        self._count += 1
        path = os.path.join(self.out_dir,
                            f"spike_{self._count:04d}_{time.time():.3f}.png")
        imwrite(path, draw_flow_arrows(np.asarray(frame), np.asarray(flow)))
        return path
