"""The one traffic generator: seeded frame pools and call schedules.

A pool stands for a recorded video as a decoder hands it over: ``pool``
uint8 frames on the host, each camera (``streams``) a smooth random
texture moving by a constant subpixel shift a frame, drawn from the seed.
The texture is made on the device with a ``torch.Generator`` in a few
large calls and the frames are copied to the host once.  Every seed gives
the same sizes and the same amount of work; only the content and the
order of the calls change.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# octaves of the texture: (cells across the shorter side, weight)
OCTAVES = ((6, 0.5), (24, 0.3), (96, 0.15), (None, 0.05))


def _seeds(seed: int) -> tuple[int, int]:
    """(torch seed, numpy seed) of a run; any whole number is taken."""
    return seed % (2 ** 63), seed % (2 ** 63) + 1


def _texture(gen: torch.Generator, C: int, H: int, W: int,
             device) -> torch.Tensor:
    """[1, C, H, W] in [0, 1]: bilinear-upsampled noise of a few octaves."""
    tex = torch.zeros(1, C, H, W, device=device)
    for cells, weight in OCTAVES:
        if cells is None:
            noise = torch.rand(1, C, H, W, generator=gen, device=device)
        else:
            h = max(2, round(cells * H / min(H, W)))
            w = max(2, round(cells * W / min(H, W)))
            noise = F.interpolate(
                torch.rand(1, C, h, w, generator=gen, device=device),
                size=(H, W), mode="bicubic", align_corners=False)
        tex += weight * noise
    return tex.clamp(0.0, 1.0)


def make_pool(traffic: dict, seed: int, device) -> np.ndarray:
    """The cell's pool: uint8 [P, H, W] (gray, one camera), [P, S, H, W]
    (gray, S cameras recorded together) or [P, H, W, 3] (BGR)."""
    P, H, W = traffic["pool"], traffic["height"], traffic["width"]
    C, S = traffic["channels"], traffic.get("streams", 1)
    speed = float(traffic["max_shift_px"])
    gen = torch.Generator(device=device)
    gen.manual_seed(_seeds(seed)[0])
    margin = math.ceil(speed * P) + 2
    ys = torch.arange(H, device=device, dtype=torch.float32)[:, None]
    xs = torch.arange(W, device=device, dtype=torch.float32)[None, :]
    cams = []
    for _ in range(S):
        tex = _texture(gen, C, H + 2 * margin, W + 2 * margin, device)
        shift = (torch.rand(2, generator=gen, device=device) * 2 - 1) * speed
        Ht, Wt = tex.shape[-2:]
        frames = []
        for t in range(P):
            gx = (xs + margin + t * shift[0]) * (2.0 / (Wt - 1)) - 1.0
            gy = (ys + margin + t * shift[1]) * (2.0 / (Ht - 1)) - 1.0
            grid = torch.stack(torch.broadcast_tensors(gx, gy), -1)[None]
            frames.append(F.grid_sample(tex, grid, mode="bilinear",
                                        align_corners=True)[0])
        cams.append((torch.stack(frames) * 255.0).round().to(torch.uint8))
    x = torch.stack(cams, 1)  # [P, S, C, H, W]
    if C == 3:
        if S != 1:
            raise ValueError("colour pools hold one camera")
        return np.ascontiguousarray(x[:, 0].permute(0, 2, 3, 1).cpu().numpy())
    if C != 1:
        raise ValueError(f"channels must be 1 or 3, got {C}")
    x = x[:, :, 0]
    return np.ascontiguousarray((x[:, 0] if S == 1 else x).cpu().numpy())


class Schedule:
    """Seeded start indices into the pool, one per call, drawn in [0, n)."""

    def __init__(self, seed: int, n: int):
        self.rng = np.random.default_rng(_seeds(seed)[1])
        self.n = n

    def next(self) -> int:
        return int(self.rng.integers(0, self.n))


def ping_pong(start: int, P: int):
    """Frame indices of a stream walking the pool forwards and backwards
    from ``start`` (no jump between two consecutive frames)."""
    i, step = start, 1
    while True:
        yield i
        if not 0 <= i + step < P:
            step = -step
        i += step
