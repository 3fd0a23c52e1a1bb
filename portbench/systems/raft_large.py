"""RAFT (large): ``models.raft.estimate`` at ``iters`` updates on the
packaged ``raft_large_synth.npz``, served as the port serves it (fp32
convolutions, the all-pairs volume and its packed lookup in plain PyTorch),
on batches of consecutive pairs; judged by ``reference/raft_large.py``,
which reads the same npz itself and computes a pair at a time."""
from __future__ import annotations

import pathlib

import numpy as np
import torch

from ..reference import raft_large as ref
from .pwcnet import normalize

ROOT = pathlib.Path(__file__).resolve().parents[2]
# pairs the reference computes at once: a 1080p pair's volume is 4.2 GB
REF_BLOCK = 1


class System:
    def __init__(self, config: dict, device: torch.device):
        from opticalflowcontainer_tpu_torch.models import convert, raft
        self.device = device
        self.iters = config["iters"]
        self.weights = ROOT / config["weights"]
        model = convert.load_raft_synth(device=device)
        if model is None:
            raise FileNotFoundError(f"{self.weights} is absent")
        self.model = model
        self._estimate = raft.estimate
        self._ref = None

    def pairs(self, frames: np.ndarray) -> torch.Tensor:
        """[B + 1, H, W, 3] uint8 consecutive frames, uploaded once ->
        flow [B, H, W, 2] of the B pairs on the device."""
        x = normalize(torch.from_numpy(frames).to(self.device))
        return self._estimate(self.model, x[:-1], x[1:], iters=self.iters)

    def release(self) -> None:
        """Drop the program's model before the reference runs."""
        self.model = None

    def reference_pairs(self, frames1: np.ndarray, frames2: np.ndarray,
                        control: bool = False) -> torch.Tensor:
        """Flow [B, H, W, 2] from the plain reference, ``REF_BLOCK`` pairs
        at a time; ``control`` rounds the operands of every convolution and
        of the all-pairs product to TF32."""
        if self._ref is None:
            self._ref = ref.load_weights(self.weights, self.device)
        net = ref.RAFTLargeRef(self._ref, control=control, iters=self.iters)
        out = []
        with torch.no_grad():
            for i in range(0, len(frames1), REF_BLOCK):
                a, b = (normalize(torch.from_numpy(np.ascontiguousarray(
                    f[i:i + REF_BLOCK])).to(self.device)) for f in (frames1, frames2))
                out.append(net.estimate(a, b))
        return torch.cat(out)

    def use_control(self) -> None:
        """Put the reference, with TF32 operands, in the program's place."""
        self.pairs = lambda frames: self.reference_pairs(
            frames[:-1], frames[1:], control=True)
