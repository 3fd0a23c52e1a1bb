"""K4: local correlation cost volume (forward).

Replaces the TPU kernel ``opticalflowcontainer_tpu/ops/correlation_pallas.py``
``correlation_pallas``; the CUDA source is ``csrc/correlation.cu``, whose
header states the design and the bound (bytes).  Semantics are the
reference's ``ops/correlation.py`` ``correlation_lax`` in NCHW layout:

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

``local_correlation`` launches the kernel for CUDA tensors and uses
:func:`correlation_plain` only for CPU tensors.  The kernel is forward only
(its backward comes with training): on the card it refuses inputs that
require a gradient.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import check_launch, load_kernels

# the kernel is instantiated for these window sizes K = 2D + 1
KERNEL_K = (7, 9)
# dynamic shared memory a block gets without opting in
SMEM_LIMIT = 48 * 1024


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
    if f2.device != f1.device:
        raise ValueError(f"f2 is on {f2.device}, f1 on {f1.device}")


def local_correlation(f1: torch.Tensor, f2: torch.Tensor, max_disp: int,
                      disp_stride: int = 1,
                      out_stride: int = 1) -> torch.Tensor:
    """K4: cost volume [B, K*K, ceil(H/os), ceil(W/os)] fp32 of f1, f2
    [B, C, H, W] fp32.

    CUDA tensors launch the kernel on the current stream (counted in
    ``local_correlation.launches``); CPU tensors take the plain version."""
    _check(f1, f2, out_stride)
    _, K = _geometry(max_disp, disp_stride)
    if f1.device.type == "cpu":
        return correlation_plain(f1, f2, max_disp, disp_stride, out_stride)
    if f1.device.type != "cuda":
        raise ValueError(f"unsupported device {f1.device}")
    if torch.is_grad_enabled() and (f1.requires_grad or f2.requires_grad):
        raise RuntimeError(
            "local_correlation: the CUDA kernel is forward only (its backward "
            "comes with training); run under torch.inference_mode() or "
            "torch.no_grad(), or correlate CPU tensors")
    if K not in KERNEL_K:
        raise ValueError(f"no CUDA kernel for a {K}x{K} window (max_disp "
                         f"{max_disp}, disp_stride {disp_stride}); built for "
                         f"K in {KERNEL_K}")
    B, C, H, W = f1.shape
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the launch grid (65535)")
    lib = load_kernels()
    smem = lib.ofc_correlation_smem(out_stride, max_disp)
    if smem > SMEM_LIMIT:
        raise ValueError(f"max_disp {max_disp} with out_stride {out_stride} "
                         f"needs {smem} bytes of shared memory per block "
                         f"(limit {SMEM_LIMIT})")
    f1, f2 = f1.contiguous(), f2.contiguous()
    Ho, Wo = -(-H // out_stride), -(-W // out_stride)
    out = torch.empty((B, K * K, Ho, Wo), dtype=torch.float32, device=f1.device)
    # the launcher runs on the current device: select f1's for the call only
    with torch.cuda.device(f1.device):
        err = lib.ofc_correlation(
            f1.data_ptr(), f2.data_ptr(), out.data_ptr(), B, C, H, W, max_disp,
            disp_stride, out_stride,
            torch.cuda.current_stream(f1.device).cuda_stream)
    check_launch(err, "local_correlation")
    local_correlation.launches += 1
    return out


local_correlation.launches = 0
