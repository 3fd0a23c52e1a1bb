"""PWC-Net: ``models.pwcnet.estimate`` on the packaged ``pwcnet_synth.npz``,
served as the port serves it (fp32 convolutions, K3 and K4), on batches
and through the camera node's fused backend; judged by
``reference/pwcnet.py``, which reads the same npz itself."""
from __future__ import annotations

import pathlib

import numpy as np
import torch

from ..reference import pwcnet as ref

ROOT = pathlib.Path(__file__).resolve().parents[2]
# pairs the reference computes at once
REF_BLOCK = 8


def normalize(x: torch.Tensor) -> torch.Tensor:
    """uint8 BGR -> [0, 1] fp32, BGR kept (the zoo's convention)."""
    return x.float() * (1.0 / 255.0)


class System:
    def __init__(self, config: dict, device: torch.device):
        from opticalflowcontainer_tpu_torch.models import convert, pwcnet
        from opticalflowcontainer_tpu_torch.runtime.fused import make_fused_model_backend
        self.device = device
        self.weights = ROOT / config["weights"]
        model = convert.load_pwcnet_synth(device=device)
        if model is None:
            raise FileNotFoundError(f"{self.weights} is absent")
        self.model = model
        self._estimate = pwcnet.estimate
        self._backend = make_fused_model_backend
        self._ref = None

    def pairs(self, frames: np.ndarray) -> torch.Tensor:
        """[B + 1, H, W, 3] uint8 consecutive frames, uploaded once ->
        flow [B, H, W, 2] of the B pairs on the device."""
        x = normalize(torch.from_numpy(frames).to(self.device))
        return self._estimate(self.model, x[:-1], x[1:])

    def stream_backend(self):
        """The camera node's backend: ``backend(prev, cur, dt) -> du``."""
        return self._backend(self.model, self._estimate, device=self.device)

    def release(self) -> None:
        """Drop the program's model before the reference runs."""
        self.model = None

    def reference_pairs(self, frames1: np.ndarray, frames2: np.ndarray,
                        control: bool = False) -> torch.Tensor:
        """Flow [B, H, W, 2] from the plain reference; ``control`` rounds
        the operands of every convolution and correlation to TF32."""
        if self._ref is None:
            self._ref = ref.load_weights(self.weights, self.device)
        net = ref.PWCNetRef(self._ref, ref.tf32_round if control
                            else ref.fp32_operand)
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
        self.stream_backend = lambda: _ControlBackend(self)


class _ControlStream:
    def __init__(self, system):
        self.system = system
        self.prev = None

    def reset(self) -> None:
        self.prev = None

    def step(self, frame):
        if self.prev is None:
            self.prev = frame
            return None
        flow = self.system.reference_pairs(self.prev[None], frame[None],
                                           control=True)
        self.prev = frame
        return flow[0, ..., 0].mean()


class _ControlBackend:
    """The node's backend contract over the control: ``prev`` seeds the
    first call, the stream carries the previous frame."""

    def __init__(self, system):
        self.stream = _ControlStream(system)

    def __call__(self, prev, cur, dt):
        if self.stream.prev is None:
            self.stream.step(prev)
        return float(self.stream.step(cur))
