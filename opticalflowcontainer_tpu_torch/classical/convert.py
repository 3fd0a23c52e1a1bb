"""Carry a Farneback stream's state from the reference into the port.

Farneback has no weights; what a stream carries is the previous frame's
polynomial-expansion planes.  The reference's ``farneback_stream_planes``
keeps them per level as [N, 5, rows_p, cols_p] bf16 planes in its TPU warp
layout: the level's core placed at (pad_y, pad_x) inside a replicate-padded
frame whose rows and cols are rounded up to the warp block.  The port keeps
[N, 5, lh, lw] fp32 planes with no padding.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from .farneback import _check_share, _level_size, _num_levels

# The reference's warp layout (its classical/farneback.py BLOCK_WARP_BLOCK
# and BLOCK_WARP_PAD), copied so that this module imports nothing of it.
JAX_BLOCK = (48, 128)
JAX_PAD = (40, 192)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def stream_state_from_jax(planes, H: int, W: int, pyr_scale: float = 0.5,
                          levels: int = 3, share: str = "all", *,
                          device=None) -> tuple:
    """The port's stream state from the numpy form of the reference's
    ``farneback_stream_planes(gray [H, W], pyr_scale, levels, share="all")``
    output: a sequence, coarsest level to finest, of [N, 5, rows_p, cols_p]
    arrays (bf16 or fp32).  Returns a tuple of contiguous [N, 5, lh, lw]
    fp32 tensors on ``device``."""
    _check_share(share)
    dev = resolve_device(device)
    n_levels = _num_levels(H, W, levels, pyr_scale)
    if len(planes) != n_levels + 1:
        raise ValueError(f"expected {n_levels + 1} levels for {H}x{W}, got "
                         f"{len(planes)}")
    (bh, bw), (pad_y, pad_x) = JAX_BLOCK, JAX_PAD
    out = []
    for arr, k in zip(planes, range(n_levels, -1, -1)):
        lh, lw = _level_size(H, W, pyr_scale**k)
        a = np.asarray(arr, dtype=np.float32)
        rows_p = _round_up(lh, bh) + 2 * pad_y
        cols_p = _round_up(lw, bw) + 2 * pad_x
        if a.ndim != 4 or a.shape[1:] != (5, rows_p, cols_p):
            raise ValueError(f"level {k}: expected [N, 5, {rows_p}, {cols_p}], "
                             f"got {a.shape}")
        core = np.ascontiguousarray(a[:, :, pad_y:pad_y + lh, pad_x:pad_x + lw])
        out.append(torch.from_numpy(core).to(dev))
    return tuple(out)
