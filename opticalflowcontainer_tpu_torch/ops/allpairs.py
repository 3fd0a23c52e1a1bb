"""RAFT's all-pairs correlation volume, its pyramid and the windowed lookup
(reference ``ops/allpairs.py``).

1. :func:`all_pairs_correlation`: C(h, w, h', w') = <F1[h, w], F2[h', w']> /
   sqrt(C), one batched [HW, C] x [C, HW] product in fp32 (cuBLAS on the
   card; TF32 stays off, PyTorch's default for matmuls).
2. :func:`corr_pyramid`: the target dims average-pooled 2 x 2 per level,
   cropped to even sizes first.
3. :func:`corr_lookup`: for each source pixel and level, the volume sampled
   bilinearly on a (2r+1)^2 grid of integer offsets around the
   flow-displaced target (coordinates times 2^-level), each of the four
   taps of a sample reading zero outside the level; channels level-major,
   then row-major over (dy, dx).

The lookup is integer index arithmetic and one ``torch.gather`` over every
level at once (the levels packed side by side by :func:`pack_pyramid`, once
a frame pair), not ``F.grid_sample``: a level one pixel wide (RAFT's
coarsest at small inputs) would read ``v`` where the reference reads
``(1 - x) v``, and grid_sample's normalized round trip perturbs the
weights.  The reference computes all three outside any Pallas kernel, so
they stay plain PyTorch on every device.  Its TPU gather layouts
(``pack_corr_pyramid``, the row and packed window samplers) have no
counterpart.

Layout: features [B, C, H, W]; volume levels [B, H, W, h_l, w_l].
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core import spans
from ..core.device import cached_tensors


def all_pairs_correlation(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] x [B, C, H, W] -> [B, H, W, H, W], scaled by 1/sqrt(C)."""
    B, C, H, W = f1.shape
    a = f1.reshape(B, C, H * W).transpose(1, 2)
    b = f2.reshape(B, C, H * W)
    vol = torch.bmm(a.float(), b.float()) / math.sqrt(C)
    return vol.reshape(B, H, W, H, W)


def corr_pyramid(vol: torch.Tensor, levels: int = 4) -> list[torch.Tensor]:
    """``levels`` volumes [B, H, W, h_l, w_l]: the first is ``vol``, each
    next one the 2 x 2 mean of the one before over the target dims, cropped
    to even sizes first (a level may become empty at small inputs)."""
    pyr = [vol]
    for _ in range(levels - 1):
        v = pyr[-1]
        B, H, W, h, w = v.shape
        h2, w2 = h // 2, w // 2
        v = v[..., :h2 * 2, :w2 * 2].reshape(B, H, W, h2, 2, w2, 2).mean((4, 6))
        pyr.append(v)
    return pyr


class PackedPyramid(NamedTuple):
    """The pyramid's levels side by side: ``flat`` [B, H*W, sum h_l*w_l],
    and per level its first column, height and width."""

    flat: torch.Tensor
    sizes: tuple[tuple[int, int, int], ...]  # (first column, h_l, w_l)


def pack_pyramid(pyramid: list[torch.Tensor]) -> PackedPyramid:
    """The levels of :func:`corr_pyramid` side by side, once a frame pair,
    for :func:`lookup_packed`."""
    B, H, W = pyramid[0].shape[:3]
    sizes, col = [], 0
    for v in pyramid:
        h, w = v.shape[-2:]
        sizes.append((col, h, w))
        col += h * w
    flat = torch.cat([v.reshape(B, H * W, -1) for v in pyramid], -1)
    return PackedPyramid(flat, tuple(sizes))


@cached_tensors(32)
def _lookup_tables(radius: int, sizes: tuple, device: torch.device):
    """The lookup's constant tables on ``device``: per (level, offset)
    [L, T] the level's scale 2^-l and the offsets dy and dx (row-major);
    per (level, offset, tap) [L, T, 1] the level's first column, height and
    width; and the four taps' row and column steps [4]."""
    n = 2 * radius + 1
    oy, ox = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    L = len(sizes)
    ones = np.ones((L, n * n), np.float32)
    per_level = np.asarray(sizes, np.int64)
    tables = (ones * (0.5 ** np.arange(L, dtype=np.float32))[:, None],
              ones * oy.reshape(-1).astype(np.float32),
              ones * ox.reshape(-1).astype(np.float32),
              *(np.repeat(per_level[:, i:i + 1], n * n, 1)[..., None]
                for i in range(3)),
              np.array([0, 0, 1, 1]), np.array([0, 1, 0, 1]))
    return tuple(torch.from_numpy(np.ascontiguousarray(t)).to(device) for t in tables)


def lookup_packed(packed: PackedPyramid, flow: torch.Tensor,
                  radius: int) -> torch.Tensor:
    """:func:`corr_lookup` on a :class:`PackedPyramid`: one gather over
    every level, offset and tap, under the span ``ofc.raft.lookup``; each
    call counts one (``lookup_packed.calls``, RAFT's ``iters`` an
    estimate)."""
    lookup_packed.calls += 1
    with spans.annotate(spans.RAFT_LOOKUP):
        return _lookup_packed(packed, flow, radius)


lookup_packed.calls = 0


def _lookup_packed(packed: PackedPyramid, flow: torch.Tensor,
                   radius: int) -> torch.Tensor:
    B, _, H, W = flow.shape
    flat = packed.flat
    scale, oy, ox, col, hl, wl, tap_dy, tap_dx = _lookup_tables(
        radius, packed.sizes, flow.device)
    L, T = scale.shape
    ys = torch.arange(H, dtype=torch.float32, device=flow.device)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=flow.device)
    cx = (xs + flow[:, 0].float())[..., None, None]  # [B, H, W, 1, 1]
    cy = (ys + flow[:, 1].float())[..., None, None]
    x = cx * scale + ox  # [B, H, W, L, T], per offset, as the reference
    y = cy * scale + oy
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    # the four taps on a new last axis: (y0, x0), (y0, x0+1), (y0+1, x0),
    # (y0+1, x0+1)
    iy = y0.long()[..., None] + tap_dy
    ix = x0.long()[..., None] + tap_dx
    ok = (iy >= 0) & (iy < hl) & (ix >= 0) & (ix < wl)
    lin = (col + torch.minimum(iy.clamp(min=0), hl - 1) * wl
           + torch.minimum(ix.clamp(min=0), wl - 1))
    # an empty level's clamped index may leave the buffer; its taps are
    # masked out, so any in-range column serves
    lin = lin.clamp(0, flat.shape[-1] - 1)
    v = torch.gather(flat, 2, lin.reshape(B, H * W, -1)).reshape(lin.shape)
    v = torch.where(ok, v, 0.0)
    out = (v[..., 0] * (1 - wx) * (1 - wy)
           + v[..., 1] * wx * (1 - wy)
           + v[..., 2] * (1 - wx) * wy
           + v[..., 3] * wx * wy)
    return out.reshape(B, H, W, L * T).permute(0, 3, 1, 2).contiguous()


def corr_lookup(pyramid: list[torch.Tensor], flow: torch.Tensor,
                radius: int = 4) -> torch.Tensor:
    """Windowed multi-scale lookup of the volume ``pyramid`` (as
    :func:`corr_pyramid` returns it) around ``flow`` [B, 2, H, W] (u, v):
    [B, L * (2r+1)^2, H, W], level-major, then row-major over (dy, dx)."""
    return lookup_packed(pack_pyramid(pyramid), flow, radius)
