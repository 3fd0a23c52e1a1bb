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

The lookup runs over every level at once (the levels packed side by side
by :func:`pack_pyramid`, once a frame pair), not ``F.grid_sample``: a
level one pixel wide (RAFT's coarsest at small inputs) would read ``v``
where the reference reads ``(1 - x) v``, and grid_sample's normalized
round trip perturbs the weights.  The reference computes all three outside
any Pallas kernel.  Here the product and the pyramid stay plain PyTorch on
every device; the lookup is K6 on the card (:func:`lookup_packed`, the
CUDA source ``csrc/allpairs_lookup.cu``, whose header states the design
and the bound: bytes), one launch a lookup that writes the update's layout,
and on the CPU its plain version, integer index arithmetic and one
``torch.gather`` (:func:`_lookup_packed`).  The reference's TPU gather
layouts (``pack_corr_pyramid``, the row and packed window samplers) have
no counterpart.

Layout: features [B, C, H, W]; volume levels [B, H, W, h_l, w_l].
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..core import spans
from ..core.device import cached_tensors
from ._build import check_launch, load_kernels
from ._vjp import plain_vjp

MAX_RADIUS = 4  # the source's kMaxRadius
MAX_LEVELS = 8  # its kMaxLevels
MAX_SIDE = 65535  # a level's height and width, at most


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
    """:func:`corr_lookup` on a :class:`PackedPyramid` and ``flow``
    [B, 2, H, W] -> [B, L (2r+1)^2, H, W], under the span
    ``ofc.raft.lookup``; each call counts one (``lookup_packed.calls``,
    RAFT's ``iters`` an estimate).

    CUDA tensors launch K6 once on the current stream (counted in
    ``lookup_packed.launches``), through :class:`LookupFunction` where an
    input needs a gradient; the card takes fp32 volumes, a radius up to
    :data:`MAX_RADIUS` and up to :data:`MAX_LEVELS` levels, and raises on
    the rest.  CPU tensors take the plain version, :func:`_lookup_packed`."""
    lookup_packed.calls += 1
    with spans.annotate(spans.RAFT_LOOKUP):
        _check(packed, flow, radius)
        if flow.device.type == "cpu":
            return _lookup_packed(packed, flow, radius)
        if flow.device.type != "cuda":
            raise ValueError(f"unsupported device {flow.device}")
        flow = flow.float().contiguous()
        _check_kernel(packed, flow, radius)
        if torch.is_grad_enabled() and (packed.flat.requires_grad
                                        or flow.requires_grad):
            return LookupFunction.apply(packed.flat, flow, packed.sizes, radius)
        return _kernel(packed.flat, flow, packed.sizes, radius)


lookup_packed.calls = 0
lookup_packed.launches = 0


def _check(packed: PackedPyramid, flow: torch.Tensor, radius: int) -> None:
    """What any route needs: flow [B, 2, H, W] beside flat [B, H*W, K] on
    its device, and levels packed side by side over the K columns."""
    flat, sizes = packed
    if flow.dim() != 4 or flow.shape[1] != 2:
        raise ValueError(f"flow must be [B, 2, H, W], got {tuple(flow.shape)}")
    B, _, H, W = flow.shape
    if flat.dim() != 3 or tuple(flat.shape[:2]) != (B, H * W):
        raise ValueError(f"the packed volume must be [{B}, {H * W}, K] for a "
                         f"flow of {tuple(flow.shape)}, got {tuple(flat.shape)}")
    if flat.device != flow.device:
        raise ValueError(f"flow is on {flow.device}, the volume on {flat.device}")
    if radius < 0:
        raise ValueError(f"radius must be >= 0, got {radius}")
    col = 0
    for first, h, w in sizes:
        if first != col or h < 0 or w < 0:
            raise ValueError(f"levels {sizes} are not packed side by side")
        col += h * w
    if col != flat.shape[-1]:
        raise ValueError(f"levels {sizes} fill {col} columns, the volume has "
                         f"{flat.shape[-1]}")


def _check_kernel(packed: PackedPyramid, flow: torch.Tensor,
                  radius: int) -> None:
    """What K6 takes beyond :func:`_check`; the card's route raises on the
    rest."""
    flat, sizes = packed
    if flat.dtype != torch.float32:
        raise TypeError(f"the packed volume must be float32, got {flat.dtype}")
    if not flat.is_contiguous():
        raise ValueError("the packed volume must be contiguous")
    if radius > MAX_RADIUS:
        raise ValueError(f"the kernel takes a radius up to {MAX_RADIUS}, got {radius}")
    if not 1 <= len(sizes) <= MAX_LEVELS:
        raise ValueError(f"the kernel takes 1..{MAX_LEVELS} levels, got {len(sizes)}")
    if any(max(h, w) > MAX_SIDE for _, h, w in sizes):
        raise ValueError(f"a level's side exceeds {MAX_SIDE}: {sizes}")
    if flow.shape[0] > 65535:
        raise ValueError(f"batch {flow.shape[0]} exceeds the launch grid (65535)")


@functools.lru_cache(maxsize=32)
def _host_sizes(sizes: tuple):
    """The levels' (first column, h_l, w_l) as the launcher's int array."""
    flat = [v for level in sizes for v in level]
    return (ctypes.c_int * len(flat))(*flat)


def _kernel(flat: torch.Tensor, flow: torch.Tensor, sizes: tuple,
            radius: int) -> torch.Tensor:
    """K6's forward on checked CUDA tensors (``flow`` fp32 and contiguous),
    counted in ``lookup_packed.launches``."""
    B, _, H, W = flow.shape
    L = len(sizes)
    out = torch.empty((B, L * (2 * radius + 1) ** 2, H, W), dtype=torch.float32,
                      device=flow.device)
    if out.numel() == 0:
        return out
    # the launcher runs on the current device: select flow's for the call only
    with torch.cuda.device(flow.device):
        err = load_kernels().ofc_allpairs_lookup(
            flat.data_ptr(), flow.data_ptr(), out.data_ptr(), B, H, W,
            flat.shape[-1], radius, L, _host_sizes(tuple(sizes)),
            torch.cuda.current_stream(flow.device).cuda_stream)
    check_launch(err, "allpairs_lookup")
    lookup_packed.launches += 1
    return out


def _lookup_flat(flat: torch.Tensor, flow: torch.Tensor, sizes: tuple,
                 radius: int) -> torch.Tensor:
    return _lookup_packed(PackedPyramid(flat, sizes), flow, radius)


class LookupFunction(torch.autograd.Function):
    """K6 with a gradient: the forward is the kernel, the backward the
    autograd of the plain version on the saved inputs (RAFT-small trains
    through the volume)."""

    @staticmethod
    def forward(ctx, flat, flow, sizes, radius):
        ctx.save_for_backward(flat, flow)
        ctx.config = (sizes, radius)
        return _kernel(flat, flow, sizes, radius)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        return plain_vjp(_lookup_flat, ctx.saved_tensors,
                         ctx.needs_input_grad[:2], grad, *ctx.config)


def _lookup_packed(packed: PackedPyramid, flow: torch.Tensor,
                   radius: int) -> torch.Tensor:
    """The plain version of K6 (any device): integer index arithmetic over
    [B, H, W, L, (2r+1)^2, 4] temporaries and one gather."""
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
