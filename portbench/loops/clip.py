"""Closed loop of clip calls: T consecutive frames of the pool (of every
camera recorded together) a call, one synchronise a call."""
from __future__ import annotations

import torch

from .. import frames


class Loop:
    kind = "clip"

    def __init__(self, system, traffic: dict, seed: int, device):
        self.system = system
        self.T = traffic["frames_per_call"]
        self.pool = frames.make_pool(traffic, seed, device)
        self.schedule = frames.Schedule(seed, len(self.pool) - self.T + 1)
        self.fields_per_call = (self.T - 1) * traffic.get("streams", 1)
        self.device = device

    def warmup(self) -> None:
        for s in (0, len(self.pool) - self.T):
            self.system.clip(self.pool[s:s + self.T])
        sync(self.device)

    def call(self):
        s = self.schedule.next()
        out = self.system.clip(self.pool[s:s + self.T])
        sync(self.device)
        return s, out

    def check(self, samples: list) -> dict:
        """Mean end-point distance (px) between the program's flows and the
        reference's over every field of the sampled calls."""
        epe = [float((out.float() - self.system.reference_clip(
            self.pool[s:s + self.T])).norm(dim=-1).mean()) for s, out in samples]
        return {"flow_epe_mean_px": sum(epe) / len(epe)}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
