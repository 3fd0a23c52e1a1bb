"""Per-frame CSV timing (the port's copy of the reference's
``runtime/timing.py`` ``CsvTimer``): ``[timestamp, inference_time_s]`` rows
behind the node's ``write_csv`` flag.  The reference's ``SpikeDumper``
draws with cv2 and is not ported yet (ROADMAP module item 3)."""
from __future__ import annotations

import os
import threading


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
