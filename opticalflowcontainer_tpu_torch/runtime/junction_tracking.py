"""Junction tracking: flow-predicted junction positions matched to fresh
detections (the port's copy of the reference's ``runtime/junction_tracking.py``).

Keeps a timestamp-keyed LRU of recent junction detections; each frame, the
previous junctions are advanced by the dense flow sampled at their
positions and matched to the current detections within a gate; velocity
comes from the mean matched displacement when enough matches survive.

The reference matches with scipy's ``cKDTree.query(...,
distance_upper_bound=gate)``; here a brute-force nearest neighbour in
float64 gives the same answers: a detection at exactly the gate is not a
match (the bound is strict), an exact tie goes to the lower index, and
several predictions may match one detection.
"""
from __future__ import annotations

import collections

import numpy as np


def nearest_within(queries: np.ndarray, points: np.ndarray,
                   gate: float) -> tuple[np.ndarray, np.ndarray]:
    """For each query, the index of its nearest point and whether it lies
    strictly within ``gate`` (squared float64 distances, ties to the lower
    index)."""
    q = np.asarray(queries, np.float64)[:, None, :]
    p = np.asarray(points, np.float64)[None, :, :]
    d2 = np.sum((q - p) ** 2, axis=-1)
    idx = np.argmin(d2, axis=1)
    best = d2[np.arange(len(idx)), idx]
    return idx, best < float(gate) ** 2


class JunctionTracker:
    def __init__(self, history: int = 10, match_gate_px: float = 5.0,
                 min_matches: int = 4):
        self.history: collections.OrderedDict[float, np.ndarray] = collections.OrderedDict()
        self.max_history = history
        self.gate = match_gate_px
        self.min_matches = min_matches

    def add_detection(self, stamp: float, points: np.ndarray) -> None:
        self.history[stamp] = np.asarray(points, np.float32).reshape(-1, 2)
        while len(self.history) > self.max_history:
            self.history.popitem(last=False)

    def latest_before(self, stamp: float):
        best = None
        for t, pts in self.history.items():
            if t <= stamp and (best is None or t > best[0]):
                best = (t, pts)
        return best

    def track(self, flow: np.ndarray, prev_stamp: float, cur_stamp: float):
        """Advance the junctions detected at/before ``prev_stamp`` by ``flow``
        [H, W, 2] and match them to the detections at/before ``cur_stamp``.

        Returns (mean displacement [2] or None, number of matches)."""
        prev = self.latest_before(prev_stamp)
        cur = self.latest_before(cur_stamp)
        if prev is None or cur is None or prev[0] == cur[0]:
            return None, 0
        prev_pts, cur_pts = prev[1], cur[1]
        if len(prev_pts) == 0 or len(cur_pts) == 0:
            return None, 0
        flow = np.asarray(flow)
        H, W = flow.shape[:2]
        xi = np.clip(prev_pts[:, 0].round().astype(int), 0, W - 1)
        yi = np.clip(prev_pts[:, 1].round().astype(int), 0, H - 1)
        predicted = prev_pts + flow[yi, xi]
        idx, matched = nearest_within(predicted, cur_pts, self.gate)
        n = int(matched.sum())
        if n < self.min_matches:
            return None, n
        disp = cur_pts[idx[matched]] - prev_pts[matched]
        return disp.mean(axis=0), n
