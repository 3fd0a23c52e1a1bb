"""K3: exact bilinear backward warp, zeros or edge border, optional mask.

Replaces the TPU kernel ``opticalflowcontainer_tpu/ops/blockwarp.py``
``block_warp_bilinear``; the CUDA source is ``csrc/warp_bilinear.cu``, whose
header states the design and the bound (bytes).  Semantics are the
reference's exact samplers (``core/warp.py`` ``sample_bilinear_zeros`` and
``sample_bilinear_edge``) in NCHW layout, at any displacement: the TPU
kernel's block-mean ``slack`` window and finite ``pad`` are Mosaic mechanics
and have no counterpart.

``warp_bilinear`` launches the kernel for CUDA tensors and uses
:func:`warp_bilinear_plain` only for CPU tensors.  The kernel has no
backward: on the card it refuses inputs that require a gradient.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import check_launch, load_kernels

PADDINGS = ("zeros", "edge")


def sample_plain(src: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                 padding: str = "zeros",
                 mask_threshold: float | None = None) -> torch.Tensor:
    """Plain PyTorch bilinear sampler (any device): ``src`` [B, C, H, W] at
    pixel coordinates ``x``, ``y`` [B, h, w] -> [B, C, h, w].

    The four-tap form of the reference (``core/warp.py`` :98-110): zeros
    padding drops each tap outside the image; edge padding clamps the
    coordinate into the image first.  With ``mask_threshold`` the output is
    multiplied by (sum of the in-image tap weights > threshold), the weights
    summed in tap order as warping a channel of ones sums them."""
    B, C, H, W = src.shape
    h, w = x.shape[-2:]
    if padding == "edge":
        # NaN maps to 0, as fmaxf does in the kernel
        x = torch.nan_to_num(x, nan=0.0).clamp(0, W - 1)
        y = torch.nan_to_num(y, nan=0.0).clamp(0, H - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    ox = 1 - wx
    oy = 1 - wy
    flat = src.reshape(B, C, H * W)
    out = msum = None
    for t, wt in enumerate((ox * oy, wx * oy, ox * wy, wx * wy)):
        tx = x0 + (t & 1)
        ty = y0 + (t >> 1)
        if padding == "edge":
            ok = None
            ix = tx.clamp(max=W - 1).long()
            iy = ty.clamp(max=H - 1).long()
        else:
            ok = (tx >= 0) & (tx <= W - 1) & (ty >= 0) & (ty <= H - 1)
            ix = torch.where(ok, tx, 0).long()
            iy = torch.where(ok, ty, 0).long()
        idx = (iy * W + ix).reshape(B, 1, h * w).expand(B, C, h * w)
        term = flat.gather(2, idx).reshape(B, C, h, w) * wt[:, None]
        if ok is not None:
            term = torch.where(ok[:, None], term, 0.0)
            wt = torch.where(ok, wt, 0.0)
        out = term if out is None else out + term
        msum = wt if msum is None else msum + wt
    if mask_threshold is not None:
        out = out * (msum > mask_threshold).to(out.dtype)[:, None]
    return out


def warp_bilinear_plain(src: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                        padding: str = "zeros",
                        mask_threshold: float | None = None) -> torch.Tensor:
    """Plain PyTorch version of K3 (any device): ``src`` [B, C, H, W]
    sampled at (x + u, y + v), u, v [B, H, W] in pixels."""
    _, _, H, W = src.shape
    xs = torch.arange(W, dtype=torch.float32, device=src.device)
    ys = torch.arange(H, dtype=torch.float32, device=src.device)[:, None]
    return sample_plain(src, xs + u, ys + v, padding, mask_threshold)


def _check(src, u, v, padding) -> None:
    if padding not in PADDINGS:
        raise ValueError(f"padding must be one of {PADDINGS}, got {padding!r}")
    if src.dim() != 4:
        raise ValueError(f"src must be [B, C, H, W], got {tuple(src.shape)}")
    B, _, H, W = src.shape
    for name, t in (("u", u), ("v", v)):
        if t.shape != (B, H, W):
            raise ValueError(f"{name} must be {(B, H, W)}, got {tuple(t.shape)}")
    for name, t in (("src", src), ("u", u), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != src.device:
            raise ValueError(f"{name} is on {t.device}, src on {src.device}")


def warp_bilinear(src: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                  padding: str = "zeros",
                  mask_threshold: float | None = None) -> torch.Tensor:
    """K3: ``src`` [B, C, H, W] fp32 backward-warped by u, v [B, H, W]
    (pixels, x right, y down) -> [B, C, H, W] fp32.

    CUDA tensors launch the kernel on the current stream (counted in
    ``warp_bilinear.launches``); CPU tensors take the plain version."""
    _check(src, u, v, padding)
    if src.device.type == "cpu":
        return warp_bilinear_plain(src, u, v, padding, mask_threshold)
    if src.device.type != "cuda":
        raise ValueError(f"unsupported device {src.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (src, u, v)):
        raise RuntimeError(
            "warp_bilinear: the CUDA kernel has no backward; run under "
            "torch.inference_mode() or torch.no_grad(), or warp CPU tensors")
    B, C, H, W = src.shape
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the launch grid (65535)")
    src, u, v = src.contiguous(), u.contiguous(), v.contiguous()
    out = torch.empty_like(src)
    # the launcher runs on the current device: select src's for the call only
    with torch.cuda.device(src.device):
        err = load_kernels().ofc_warp_bilinear(
            src.data_ptr(), u.data_ptr(), v.data_ptr(), out.data_ptr(), B, C,
            H, W, int(padding == "edge"), int(mask_threshold is not None),
            ctypes.c_float(0.0 if mask_threshold is None else mask_threshold),
            torch.cuda.current_stream(src.device).cuda_stream)
    check_launch(err, "warp_bilinear")
    warp_bilinear.launches += 1
    return out


warp_bilinear.launches = 0
