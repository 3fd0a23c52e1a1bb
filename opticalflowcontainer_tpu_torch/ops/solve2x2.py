"""K2: Farneback winsize blur + per-pixel 2x2 solve.

Replaces the TPU kernel ``opticalflowcontainer_tpu/ops/solve2x2.py``
``blur_solve_2x2``; the CUDA source is ``csrc/blur_solve.cu``, whose header
states the design and the bound (bytes: 7 fp32 values per pixel).  Semantics
are the reference's ``classical/farneback.py`` ``_solve_flow_planes`` in
fp32.  Unlike the TPU kernel (winsize//2 <= 8), any winsize runs whose
smallest tile fits the card's shared memory.

``blur_solve`` launches the kernel for CUDA tensors and uses
:func:`blur_solve_plain` only for CPU tensors.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.filters import _sepconv
from ._build import check_launch, load_kernels

# Candidate output tiles (rows, cols), largest first; a block has 256 threads
# and each thread keeps at most 8 output pixels in registers.
TILES = ((32, 64), (16, 64), (8, 64), (8, 32), (4, 32), (2, 32), (1, 32))
DEFAULT_SMEM = 48 * 1024  # dynamic shared memory a block gets without opt-in


def blur_taps(winsize: int, gaussian: bool) -> np.ndarray:
    """The winsize blur's 2*(winsize//2)+1 taps (float64): box 1/winsize, or
    a Gaussian with sigma = 0.3 * (winsize // 2)."""
    if winsize < 1:
        raise ValueError(f"winsize must be >= 1, got {winsize}")
    if gaussian:
        m = winsize // 2
        k = np.exp(-0.5 * (np.arange(-m, m + 1) / (m * 0.3)) ** 2)
        return k / k.sum()
    if winsize % 2 == 0:
        # the reference's box blur changes the field's size for an even window
        raise ValueError(f"the box blur needs an odd winsize, got {winsize}")
    return np.ones(winsize, np.float64) / winsize


def smem_bytes(tile_h: int, tile_w: int, r: int) -> int:
    """Dynamic shared memory of one block: one plane's tile + halo, the
    vertical-pass buffer and the taps, in fp32."""
    return 4 * ((2 * tile_h + 2 * r) * (tile_w + 2 * r) + 2 * r + 1)


def choose_tile(r: int, smem_limit: int) -> tuple[int, int, int]:
    """(tile_h, tile_w, smem) for blur radius ``r``: the largest tile within
    the 48 KB default, else the largest within ``smem_limit`` (opt-in).
    Raises when even the smallest tile does not fit."""
    for limit in (DEFAULT_SMEM, smem_limit):
        for th, tw in TILES:
            need = smem_bytes(th, tw, r)
            if need <= limit:
                return th, tw, need
    th, tw = TILES[-1]
    raise ValueError(
        f"winsize {2 * r + 1} needs {smem_bytes(th, tw, r)} bytes of shared "
        f"memory even for a {th}x{tw} tile; this card allows {smem_limit} "
        f"per block")


def blur_solve_plain(M: torch.Tensor, winsize: int,
                     gaussian: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2 (any device): M [B, 5, H, W] ->
    (u, v) [B, H, W]."""
    k = blur_taps(winsize, gaussian)
    Mb = _sepconv(M, k, k, "replicate")
    G00, G01, G11, h1, h2 = Mb.unbind(1)
    idet = 1.0 / (G00 * G11 - G01 * G01 + 1e-3)
    return (G11 * h1 - G01 * h2) * idet, (G00 * h2 - G01 * h1) * idet


@functools.lru_cache(maxsize=32)
def _device_taps(winsize: int, gaussian: bool, device: torch.device):
    return torch.from_numpy(
        blur_taps(winsize, gaussian).astype(np.float32)).to(device)


@functools.lru_cache(maxsize=8)
def _smem_limit(device_index: int) -> int:
    limit = load_kernels().ofc_max_dynamic_smem(device_index)
    if limit <= 0:
        raise RuntimeError(f"cannot read the shared-memory limit of cuda:{device_index}")
    return limit


def _check(M: torch.Tensor) -> None:
    if M.dim() != 4 or M.shape[1] != 5:
        raise ValueError(f"M must be [B, 5, H, W], got {tuple(M.shape)}")
    if M.dtype != torch.float32:
        raise TypeError(f"M must be float32, got {M.dtype}")
    if not M.is_contiguous():
        raise ValueError("M must be contiguous")


def blur_solve(M: torch.Tensor, winsize: int,
               gaussian: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """K2: (u, v) [B, H, W] fp32 from the normal-equation planes M
    [B, 5, H, W].

    CUDA tensors launch the kernel on the current stream (counted in
    ``blur_solve.launches``); CPU tensors take the plain version."""
    _check(M)
    if M.device.type == "cpu":
        return blur_solve_plain(M, winsize, gaussian)
    if M.device.type != "cuda":
        raise ValueError(f"unsupported device {M.device}")
    B, _, H, W = M.shape
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the launch grid (65535)")
    taps = _device_taps(winsize, bool(gaussian), M.device)
    r = winsize // 2
    th, tw, smem = choose_tile(r, _smem_limit(M.device.index))
    u = torch.empty((B, H, W), dtype=torch.float32, device=M.device)
    v = torch.empty_like(u)
    # the launcher runs on the current device: select M's for the call only
    with torch.cuda.device(M.device):
        err = load_kernels().ofc_blur_solve(
            M.data_ptr(), taps.data_ptr(), u.data_ptr(), v.data_ptr(), B, H, W,
            r, th, tw, smem, torch.cuda.current_stream(M.device).cuda_stream)
    check_launch(err, "blur_solve")
    blur_solve.launches += 1
    return u, v


blur_solve.launches = 0
