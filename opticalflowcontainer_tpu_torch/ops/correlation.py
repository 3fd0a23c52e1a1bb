"""K4: local correlation cost volume (forward).

Replaces the TPU kernel ``opticalflowcontainer_tpu/ops/correlation_pallas.py``
``correlation_pallas``; the CUDA source is ``csrc/correlation.cu``.  Semantics
are the reference's ``ops/correlation.py`` ``correlation_lax`` in NCHW
layout:

    out[b, iy*K + ix, y, x] = (1/C) * sum_c f1[b, c, y*os, x*os]
                                          * f2[b, c, y*os + dy, x*os + dx]

with (dy, dx) = ((iy - D), (ix - D)) * disp_stride, K = 2D + 1,
D = max_disp // disp_stride, zeros outside the image, and channels
row-major over (dy, dx), the order converted weights rely on.  The model
zoo's configurations (max_disp, disp_stride, out_stride):

=====================  ==========  ========
user                   config      channels
=====================  ==========  ========
PWC-Net                (4, 1, 1)   81
LiteFlowNet levels 4-6 (3, 1, 1)   49
LiteFlowNet levels 2-3 (6, 2, 2)   49
LFN3 cross-correlation (4, 1, 1)   81
LFN3 self, level 4     (6, 2, 1)   49
LFN3 self, level 3     (8, 2, 1)   81
=====================  ==========  ========

The kernel.  Its bound is bytes: f1 and f2 read once and the K*K volume
written (~95 MB at PWC-Net's level 2, B=8: 28 us at 3.35 TB/s); its 2 C K*K
flops per pixel take less than half of that on the CUDA cores, so it sums in
fp32 FMAs and not on tensor cores.  A block stages chunks of channels of the
f2 window (and the f1 tile) in shared memory by ``cp.async``, whose
zero-fill form gives the zero padding, two buffers deep (one for a split
short enough to stage at once); not TMA, whose tensor maps need rows of a
multiple of 16 bytes (PWC-Net's level 6 is 10 floats wide).  A thread
owns 4 neighbouring outputs on one tap row and sums 4 K products per
channel from registers.  :func:`launch_config` sizes the grid to the level:
pixel tiles, then groups of tap rows, then channel splits where those give
an SM too few blocks.  Channel splits write partial sums to a workspace that
a second kernel adds in split order.  Reduction order: channels ascending
within a split, splits ascending, no atomics, so launches repeat bit for
bit.

``local_correlation`` launches the kernel for CUDA tensors and uses
:func:`correlation_plain` only for CPU tensors.  Where an input needs a
gradient, the kernel runs inside :class:`CorrelationFunction`, whose
backward is the plain version's autograd, recomputed from the saved inputs:
the reference's ``correlation_pallas`` is a ``jax.custom_vjp`` whose
backward is ``jax.vjp`` of ``correlation_lax`` (no backward kernel exists
there either).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..core.device import H100_SMS, sm_count
from ._build import check_launch, load_kernels
from ._vjp import plain_vjp

# the kernel is instantiated for these window sizes K = 2D + 1
KERNEL_K = (7, 9)
# dynamic shared memory a block gets without opting in
SMEM_LIMIT = 48 * 1024
STRIP = 4          # output pixels a thread owns, along x (kStrip)
TILE_W = 32        # widest pixel tile
TILE_H = 4         # tallest pixel tile
MAX_THREADS = 256  # threads per block the kernel takes (kMaxThreads)
BLOCKS_PER_SM = 4  # the least a launch should give each SM, where C allows
MIN_SPLIT_CHANNELS = 4    # channels per split, at least
ONE_STAGE_CHANNELS = 16   # splits of at most this many: one staged buffer
CHUNKS = (8, 4, 2, 1)     # channels per staged buffer, largest first


def _geometry(max_disp: int, disp_stride: int) -> tuple[int, int]:
    """(D, K) of a configuration."""
    if disp_stride < 1 or max_disp < 0 or max_disp % disp_stride:
        raise ValueError(f"max_disp {max_disp} must be a non-negative multiple "
                         f"of disp_stride {disp_stride}")
    D = max_disp // disp_stride
    return D, 2 * D + 1


def correlation_plain(f1: torch.Tensor, f2: torch.Tensor, max_disp: int,
                      disp_stride: int = 1,
                      out_stride: int = 1) -> torch.Tensor:
    """Plain PyTorch version of K4 (any device): f1, f2 [B, C, H, W] ->
    [B, K*K, ceil(H/os), ceil(W/os)], one shifted slice per displacement."""
    D, K = _geometry(max_disp, disp_stride)
    _, C, H, W = f1.shape
    P = max_disp
    f2p = F.pad(f2, (P, P, P, P))
    a = f1[..., ::out_stride, ::out_stride]
    outs = []
    for iy in range(K):
        for ix in range(K):
            dy = P + (iy - D) * disp_stride
            dx = P + (ix - D) * disp_stride
            sl = f2p[..., dy:dy + H:out_stride, dx:dx + W:out_stride]
            outs.append((a * sl).sum(1))
    return torch.stack(outs, 1) / C


def channel_ranges(C: int, splits: int) -> list[tuple[int, int]]:
    """The channels [begin, end) of each split, as the kernel takes them:
    split s holds s*C//splits up to (s+1)*C//splits."""
    return [(s * C // splits, (s + 1) * C // splits) for s in range(splits)]


def _window(tw: int, K: int, ds: int) -> tuple[int, int]:
    """(columns, row stride) in floats of the staged f2 window for a tile
    ``tw`` wide.  It starts ``pad`` = D*ds rounded up to 4 columns left of
    the tile (a 16-byte boundary) and spans D*ds right of it, rounded up to
    4.  The stride holds the columns and the last strip's 16-byte reads, a
    multiple of 4; for tiles narrower than 32, congruent to the tile width
    mod 32, so a quarter warp whose strips span rows reads distinct banks as
    in one contiguous row."""
    reach = K // 2 * ds
    pad = -(-reach // 4) * 4
    wc = -(-(tw + pad + reach) // 4) * 4
    span = pad - reach + STRIP + (K - 1) * ds
    ws = max(wc, tw - STRIP + 4 * -(-span // 4))
    if tw < 32:
        ws += (tw - ws) % 32
    return wc, ws


def make_config(max_disp: int, disp_stride: int, out_stride: int,
                tile: tuple[int, int], taps: int, splits: int, chunk: int,
                stages: int = 2, copy16: bool = True) -> dict:
    """A launch configuration with its derived window stride and shared
    memory: ``tile`` (width, a multiple of 4; height) of outputs, ``taps``
    tap rows per block, ``splits`` channel splits, ``chunk`` channels per
    staged buffer, ``stages`` buffers (1, or 2 to overlap the copy of the
    next chunk with the sums of this one), 16-byte copies where the
    inputs allow them (out_stride 1, W a multiple of 4) when ``copy16``."""
    _, K = _geometry(max_disp, disp_stride)
    if disp_stride % out_stride:
        raise ValueError(f"no CUDA kernel for disp_stride {disp_stride} with "
                         f"out_stride {out_stride}: it takes disp_stride a "
                         f"multiple of out_stride")
    ds = disp_stride // out_stride
    tw, th = tile
    _, ws = _window(tw, K, ds)
    wr = th + (taps - 1) * ds
    smem = stages * chunk * (wr * ws + th * tw) * 4
    return {"tile": (tw, th), "taps": taps, "splits": splits, "chunk": chunk,
            "stages": stages, "copy16": copy16, "ws": ws, "smem": smem,
            "threads": tw // STRIP * th * taps}


@functools.lru_cache(maxsize=256)
def launch_config(B: int, C: int, H: int, W: int, max_disp: int,
                  disp_stride: int = 1, out_stride: int = 1,
                  sms: int = H100_SMS) -> dict:
    """The kernel's launch configuration for f1, f2 [B, C, H, W], cached per
    shape and configuration (callers must not change the dict).  The
    parallelism, in this order:

    - a pixel tile sized to the level: at most ``TILE_W`` wide in as few
      columns of tiles as that allows (a multiple of 4), at most ``TILE_H``
      tall;
    - tap rows: K, K/3 or 1 (whole groups), the most a block of
      ``MAX_THREADS`` holds, then fewer, not below 3, while the blocks would
      leave an SM without one;
    - channel splits where those give an SM fewer than ``BLOCKS_PER_SM``
      blocks, each of ``MIN_SPLIT_CHANNELS`` channels at least.

    A split of at most ``ONE_STAGE_CHANNELS`` channels is staged at once
    (one buffer: a short block waits on memory once); otherwise two buffers
    of the largest ``CHUNKS`` entry that fits ``SMEM_LIMIT``.  Returned with
    the window stride, the bytes and the threads (:func:`make_config`).  The
    rule follows the fastest of the choices ``chip_smoke.py --variants``
    times at PWC-Net's levels and the B=8 shapes (PERF.md)."""
    _, K = _geometry(max_disp, disp_stride)
    Ho, Wo = -(-H // out_stride), -(-W // out_stride)
    tw = STRIP * -(-Wo // (STRIP * -(-Wo // TILE_W)))
    th = min(TILE_H, 1 << (Ho - 1).bit_length())
    tiles = B * -(-Wo // tw) * -(-Ho // th)
    fits = [t for t in (K, 3, 1)
            if K % t == 0 and tw // STRIP * th * t <= MAX_THREADS]
    taps = fits[0]
    for t in fits[1:]:
        if tiles * -(-K // taps) >= sms or t < 3:
            break
        taps = t
    blocks = tiles * -(-K // taps)
    splits = min(-(-BLOCKS_PER_SM * sms // blocks),
                 max(1, C // MIN_SPLIT_CHANNELS))
    per = -(-C // splits)
    if per <= ONE_STAGE_CHANNELS:
        cfg = make_config(max_disp, disp_stride, out_stride, (tw, th), taps,
                          splits, per, stages=1)
        if cfg["smem"] <= SMEM_LIMIT:
            return cfg
    for chunk in CHUNKS:
        cfg = make_config(max_disp, disp_stride, out_stride, (tw, th), taps,
                          splits, min(chunk, per))
        if cfg["smem"] <= SMEM_LIMIT:
            break
    return cfg


def _check(f1, f2, out_stride) -> None:
    if f1.dim() != 4:
        raise ValueError(f"f1 must be [B, C, H, W], got {tuple(f1.shape)}")
    if f2.shape != f1.shape:
        raise ValueError(f"f2 {tuple(f2.shape)} != f1 {tuple(f1.shape)}")
    if out_stride < 1:
        raise ValueError(f"out_stride must be >= 1, got {out_stride}")
    for name, t in (("f1", f1), ("f2", f2)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if f2.get_device() != f1.get_device():
        raise ValueError(f"f2 is on {f2.device}, f1 on {f1.device}")


def local_correlation(f1: torch.Tensor, f2: torch.Tensor, max_disp: int,
                      disp_stride: int = 1,
                      out_stride: int = 1) -> torch.Tensor:
    """K4: cost volume [B, K*K, ceil(H/os), ceil(W/os)] fp32 of f1, f2
    [B, C, H, W] fp32.

    CUDA tensors launch the kernel on the current stream (counted in
    ``local_correlation.launches``), through :class:`CorrelationFunction`
    where an input needs a gradient; CPU tensors take the plain version."""
    _check(f1, f2, out_stride)
    dev = f1.device
    if dev.type == "cpu":
        return correlation_plain(f1, f2, max_disp, disp_stride, out_stride)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if torch.is_grad_enabled() and (f1.requires_grad or f2.requires_grad):
        return CorrelationFunction.apply(f1, f2, max_disp, disp_stride,
                                         out_stride)
    return _kernel(f1, f2, max_disp, disp_stride, out_stride)


local_correlation.launches = 0


def _kernel(f1: torch.Tensor, f2: torch.Tensor, max_disp: int,
            disp_stride: int, out_stride: int) -> torch.Tensor:
    """The kernel's forward on checked CUDA tensors, counted in
    ``local_correlation.launches``."""
    _, K = _geometry(max_disp, disp_stride)
    dev = f1.device
    if K not in KERNEL_K:
        raise ValueError(f"no CUDA kernel for a {K}x{K} window (max_disp "
                         f"{max_disp}, disp_stride {disp_stride}); built for "
                         f"K in {KERNEL_K}")
    B, C, H, W = f1.shape
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the launch grid (65535)")
    cfg = launch_config(B, C, H, W, max_disp, disp_stride, out_stride,
                        sm_count(dev.index))
    out = launch(f1.contiguous(), f2.contiguous(), max_disp, disp_stride,
                 out_stride, cfg)
    local_correlation.launches += 1
    return out


class CorrelationFunction(torch.autograd.Function):
    """K4 with a gradient: the forward is the kernel, the backward the
    autograd of :func:`correlation_plain` on the saved inputs (the
    reference's ``custom_vjp``, ``ops/correlation_pallas.py`` :120-126)."""

    @staticmethod
    def forward(ctx, f1, f2, max_disp, disp_stride, out_stride):
        ctx.save_for_backward(f1, f2)
        ctx.config = (max_disp, disp_stride, out_stride)
        return _kernel(f1, f2, max_disp, disp_stride, out_stride)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        return plain_vjp(correlation_plain, ctx.saved_tensors,
                         ctx.needs_input_grad, grad, *ctx.config)


def launch(f1: torch.Tensor, f2: torch.Tensor, max_disp: int,
           disp_stride: int, out_stride: int, cfg: dict) -> torch.Tensor:
    """One launch of the kernel (and, with channel splits, of its reduction)
    with configuration ``cfg`` (:func:`make_config`) on contiguous CUDA
    tensors checked by the caller.  ``local_correlation`` passes
    :func:`launch_config`'s; ``chip_smoke.py --variants`` passes others to
    measure each choice apart.  Counts nothing."""
    _, K = _geometry(max_disp, disp_stride)
    B, C, H, W = f1.shape
    Ho, Wo = -(-H // out_stride), -(-W // out_stride)
    if cfg["smem"] > SMEM_LIMIT:
        raise ValueError(f"the launch needs {cfg['smem']} bytes of shared "
                         f"memory per block (limit {SMEM_LIMIT})")
    splits = cfg["splits"]
    dev = f1.device
    out = torch.empty((B, K * K, Ho, Wo), dtype=torch.float32, device=dev)
    work = (torch.empty((splits, B, K * K, Ho, Wo), dtype=torch.float32,
                        device=dev) if splits > 1 else None)
    tw, th = cfg["tile"]
    vec = (cfg["copy16"] and out_stride == 1 and W % 4 == 0
           and f1.data_ptr() % 16 == 0 and f2.data_ptr() % 16 == 0)
    args = (f1.data_ptr(), f2.data_ptr(), out.data_ptr(),
            None if work is None else work.data_ptr(), B, C, H, W, max_disp,
            disp_stride, out_stride, tw, th, cfg["taps"], splits, cfg["chunk"],
            cfg["ws"], int(vec), cfg["stages"], cfg["smem"])
    lib = load_kernels()
    # the launcher runs on the current device: select f1's only when it is
    # another.  The raw stream handle costs a tenth of a Stream object.
    index = f1.get_device()
    if index == torch.cuda.current_device():
        err = lib.ofc_correlation(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = lib.ofc_correlation(
                *args, torch._C._cuda_getCurrentRawStream(index))
    check_launch(err, "local_correlation")
    return out
