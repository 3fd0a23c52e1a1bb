"""Farneback: ``classical.farneback.farneback_clip`` on uint8 gray clips,
judged by ``reference/farneback.py`` pair by pair (the reference expands
both frames of every pair, so it also checks the clip's sharing of each
frame's expansion between two pairs)."""
from __future__ import annotations

import numpy as np
import torch

from ..reference import farneback as ref

# pairs the reference computes at once: bounds its memory at 1080p
REF_BLOCK = 4


class System:
    def __init__(self, config: dict, device: torch.device):
        from opticalflowcontainer_tpu_torch.classical.farneback import farneback_clip
        self.params = dict(config["params"])
        self.device = device
        self._clip = farneback_clip

    def clip(self, frames: np.ndarray) -> torch.Tensor:
        """[T, (S,) H, W] uint8 -> flow [T-1, (S,) H, W, 2] on the device."""
        return self._clip(frames, device=self.device, **self.params)

    def reference_clip(self, frames: np.ndarray,
                       control: bool = False) -> torch.Tensor:
        """The same flow from the plain reference; ``control`` stores every
        array between stages in bfloat16."""
        x = torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)
        H, W = x.shape[-2:]
        prev, nxt = x[:-1].reshape(-1, H, W), x[1:].reshape(-1, H, W)
        store = ref.bf16_store if control else ref.fp32_store
        out = torch.cat([ref.farneback_pairs(prev[i:i + REF_BLOCK],
                                             nxt[i:i + REF_BLOCK],
                                             self.params, store)
                         for i in range(0, prev.shape[0], REF_BLOCK)])
        return out.reshape((x.shape[0] - 1,) + tuple(x.shape[1:]) + (2,))

    def use_control(self) -> None:
        """Put the reference, in bfloat16 storage, in the program's place."""
        self.clip = lambda frames: self.reference_clip(frames, control=True)
