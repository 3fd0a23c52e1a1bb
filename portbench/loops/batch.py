"""Closed loop of batched pair calls: B + 1 consecutive frames of the pool
uploaded once, the B pairs they make estimated at once, one synchronise a
call."""
from __future__ import annotations

from .. import frames
from .clip import sync


class Loop:
    kind = "batch"

    def __init__(self, system, traffic: dict, seed: int, device):
        self.system = system
        self.B = traffic["batch"]
        self.pool = frames.make_pool(traffic, seed, device)
        self.schedule = frames.Schedule(seed, len(self.pool) - self.B)
        self.fields_per_call = self.B
        self.device = device

    def warmup(self) -> None:
        for s in (0, len(self.pool) - self.B - 1):
            self.system.pairs(self.pool[s:s + self.B + 1])
        sync(self.device)

    def call(self):
        s = self.schedule.next()
        out = self.system.pairs(self.pool[s:s + self.B + 1])
        sync(self.device)
        return s, out

    def check(self, samples: list) -> dict:
        """Mean end-point distance (px) between the program's flows and the
        reference's over every pair of the sampled calls."""
        epe = []
        for s, out in samples:
            ref = self.system.reference_pairs(self.pool[s:s + self.B],
                                              self.pool[s + 1:s + self.B + 1])
            epe.append(float((out.float() - ref).norm(dim=-1).mean()))
        return {"flow_epe_mean_px": sum(epe) / len(epe)}
