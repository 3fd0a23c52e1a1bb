"""K1: Farneback per-iteration update (normal equations of one level).

Replaces the TPU kernel ``opticalflowcontainer_tpu/ops/blockwarp.py``
``block_warp_farneback_update``; the CUDA source is
``csrc/farneback_update.cu``, whose header states the design and the bound
(bytes: ~17 fp32 values per pixel).  Semantics are the reference's exact CPU
path (``classical/farneback.py`` ``_update_matrices``) in plane-major layout.

``farneback_update`` launches the kernel for CUDA tensors and uses
:func:`farneback_update_plain` only for CPU tensors.  Storage is fp32.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import cached_tensors
from ._build import check_launch, load_kernels

# Edge ramp (5 px) that down-weights the expansion near the level's borders.
BORDER_RAMP = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472], np.float32)


def _ramp_vec(n: int) -> np.ndarray:
    """One axis of the separable border weight (reference
    ``_border_weight_vecs``): 1 inside, the ramp from each edge."""
    w = np.ones(n, np.float32)
    for i in range(min(len(BORDER_RAMP), n)):
        w[i] *= BORDER_RAMP[i]
        w[n - 1 - i] *= BORDER_RAMP[i]
    return w


def border_weight(H: int, W: int) -> np.ndarray:
    """[H, W] per-pixel down-weight, the product of the two axis ramps."""
    return _ramp_vec(H)[:, None] * _ramp_vec(W)[None, :]


@cached_tensors(64)
def _device_border_weight(H: int, W: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(border_weight(H, W)).to(device)


def farneback_update_plain(R0: torch.Tensor, R1: torch.Tensor,
                           u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1 (any device): R0, R1 [B, 5, H, W] frame 0
    and frame 1 expansion planes (bx, by, axx, ayy, qxy), u, v [B, H, W] ->
    M [B, 5, H, W] = (G00, G01, G11, h1, h2)."""
    B, _, H, W = R0.shape
    dev = R0.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    fx = xs + u
    fy = ys + v
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    # all four taps strictly in bounds, as cv2 requires
    inb = (x0 >= 0) & (x0 < W - 1) & (y0 >= 0) & (y0 < H - 1)
    wx = (fx - x0)[:, None]
    wy = (fy - y0)[:, None]
    xc = x0.clamp(0, W - 2).long()
    yc = y0.clamp(0, H - 2).long()
    lin = (yc * W + xc).reshape(B, 1, H * W).expand(B, 5, H * W)
    flat = R1.reshape(B, 5, H * W)

    def tap(off):
        return flat.gather(2, lin + off).reshape(B, 5, H, W)

    R1s = (tap(0) * (1 - wx) * (1 - wy) + tap(1) * wx * (1 - wy)
           + tap(W) * (1 - wx) * wy + tap(W + 1) * wx * wy)

    # A: mean of the two frames where the sample is valid, frame 0 alone
    # otherwise (and db = 0 there: no data term, only the prior)
    axx = torch.where(inb, (R0[:, 2] + R1s[:, 2]) * 0.5, R0[:, 2])
    ayy = torch.where(inb, (R0[:, 3] + R1s[:, 3]) * 0.5, R0[:, 3])
    axy = torch.where(inb, (R0[:, 4] + R1s[:, 4]) * 0.25, R0[:, 4] * 0.5)
    dbx = torch.where(inb, (R0[:, 0] - R1s[:, 0]) * 0.5, 0.0)
    dby = torch.where(inb, (R0[:, 1] - R1s[:, 1]) * 0.5, 0.0)
    dbx = dbx + axx * u + axy * v
    dby = dby + axy * u + ayy * v

    bw = _device_border_weight(H, W, dev)
    axx = axx * bw
    ayy = ayy * bw
    axy = axy * bw
    dbx = dbx * bw
    dby = dby * bw
    return torch.stack([axx * axx + axy * axy, (axx + ayy) * axy,
                        ayy * ayy + axy * axy, axx * dbx + axy * dby,
                        axy * dbx + ayy * dby], dim=1)


def _check(R0, R1, u, v) -> None:
    if R0.dim() != 4 or R0.shape[1] != 5:
        raise ValueError(f"R0 must be [B, 5, H, W], got {tuple(R0.shape)}")
    B, _, H, W = R0.shape
    if R1.shape != R0.shape:
        raise ValueError(f"R1 {tuple(R1.shape)} != R0 {tuple(R0.shape)}")
    for name, t in (("u", u), ("v", v)):
        if t.shape != (B, H, W):
            raise ValueError(f"{name} must be {(B, H, W)}, got {tuple(t.shape)}")
    if H < 2 or W < 2:
        raise ValueError(f"level {H}x{W} is smaller than one bilinear cell")
    for name, t in (("R0", R0), ("R1", R1), ("u", u), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != R0.device:
            raise ValueError(f"{name} is on {t.device}, R0 on {R0.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def farneback_update(R0: torch.Tensor, R1: torch.Tensor, u: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """K1: M [B, 5, H, W] fp32 from R0, R1 [B, 5, H, W] and u, v [B, H, W].

    CUDA tensors launch the kernel on the current stream (counted in
    ``farneback_update.launches``); CPU tensors take the plain version."""
    _check(R0, R1, u, v)
    if R0.device.type == "cpu":
        return farneback_update_plain(R0, R1, u, v)
    if R0.device.type != "cuda":
        raise ValueError(f"unsupported device {R0.device}")
    B, _, H, W = R0.shape
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the launch grid (65535)")
    M = torch.empty_like(R0)
    # the launcher runs on the current device: select R0's for the call only
    with torch.cuda.device(R0.device):
        err = load_kernels().ofc_farneback_update(
            R0.data_ptr(), R1.data_ptr(), u.data_ptr(), v.data_ptr(),
            M.data_ptr(), B, H, W,
            torch.cuda.current_stream(R0.device).cuda_stream)
    check_launch(err, "farneback_update")
    farneback_update.launches += 1
    return M


farneback_update.launches = 0
