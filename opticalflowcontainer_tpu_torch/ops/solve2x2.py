"""K2: Farneback winsize blur + per-pixel 2x2 solve.

Replaces the TPU kernel ``opticalflowcontainer_tpu/ops/solve2x2.py``
``blur_solve_2x2``; the CUDA source is ``csrc/blur_solve.cu``, whose header
states the design and the bound (bytes: 7 fp32 values per pixel).  Semantics
are the reference's ``classical/farneback.py`` ``_solve_flow_planes`` in
fp32.  Unlike the TPU kernel (winsize//2 <= 8), any winsize runs whose
smallest tile fits the card's shared memory.

``blur_solve`` launches a kernel for CUDA tensors and uses
:func:`blur_solve_plain` only for CPU tensors.  Two kernels compute it
(``csrc/blur_solve.cu``): a register-blocked one specialized for the radii
the callers use (:data:`REG_RADII`) and the generic one for every other
radius; :func:`variant` names the one a radius runs and :func:`choose_tile`
picks its tile from the radius, the card's shared memory and the grid.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core.device import H100_SMS, cached_tensors, sm_count
from ..core.filters import _sepconv
from ._build import check_launch, load_kernels

# radii with a register-blocked kernel: r = 7 (winsize 15, cv2's default,
# the clip's and the stream's) and r = 6 (winsize 13, the runtime's default)
REG_RADII = (6, 7)
# its output tiles (rows, cols), largest first: 32 rows, one per lane; the
# 8 warps of a block split the columns into runs of 14, 4 or 2
REG_TILES = ((32, 112), (32, 32), (32, 16))
# the generic kernel's tiles, largest first; a block has 256 threads and
# each thread keeps at most 8 output pixels in registers
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


def variant(r: int) -> str:
    """The kernel that blur radius ``r`` runs: "r6" or "r7" (register
    blocked) or "generic"."""
    return f"r{r}" if r in REG_RADII else "generic"


def smem_bytes(tile_h: int, tile_w: int, r: int) -> int:
    """Shared memory of one block in bytes.  Register-blocked kernel: two
    vertical-pass buffers of ``tile_h`` rows at an odd stride of at least
    tile_w + 2r floats (static).  Generic kernel: one plane's tile + halo,
    the vertical-pass buffer and the taps (dynamic)."""
    if r in REG_RADII:
        return 4 * 2 * tile_h * ((tile_w + 2 * r) | 1)
    return _generic_smem(tile_h, tile_w, r)


def _generic_smem(tile_h: int, tile_w: int, r: int) -> int:
    return 4 * ((2 * tile_h + 2 * r) * (tile_w + 2 * r) + 2 * r + 1)


def choose_tile(r: int, smem_limit: int, B: int, H: int, W: int,
                sms: int = H100_SMS) -> tuple[int, int, int]:
    """(tile_h, tile_w, smem) for blur radius ``r`` on a [B, 5, H, W] input:
    among the kernel's tiles that fit the 48 KB default (else, for the
    generic kernel, ``smem_limit`` with opt-in), the one whose busiest SM
    reads the fewest values: ceil(blocks / sms) tiles of (tile_h + 2r) x
    (tile_w + 2r), the larger tile on a tie.  Few blocks leave SMs idle,
    small tiles re-read their halo.  Raises when even the smallest tile
    does not fit."""
    tiles = REG_TILES if r in REG_RADII else TILES
    for limit in (DEFAULT_SMEM, smem_limit):
        fits = [(th, tw) for th, tw in tiles if smem_bytes(th, tw, r) <= limit]
        if fits:
            break
    else:
        th, tw = tiles[-1]
        raise ValueError(
            f"winsize {2 * r + 1} needs {smem_bytes(th, tw, r)} bytes of shared "
            f"memory even for a {th}x{tw} tile; this card allows {smem_limit} "
            f"per block")

    def busiest_sm(tile):
        th, tw = tile
        blocks = B * -(-H // th) * -(-W // tw)
        return -(-blocks // sms) * (th + 2 * r) * (tw + 2 * r)

    th, tw = min(fits, key=busiest_sm)  # the first (largest) of equals
    return th, tw, smem_bytes(th, tw, r)


def blur_solve_plain(M: torch.Tensor, winsize: int,
                     gaussian: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2 (any device): M [B, 5, H, W] ->
    (u, v) [B, H, W]."""
    k = blur_taps(winsize, gaussian)
    Mb = _sepconv(M, k, k, "replicate")
    G00, G01, G11, h1, h2 = Mb.unbind(1)
    idet = 1.0 / (G00 * G11 - G01 * G01 + 1e-3)
    return (G11 * h1 - G01 * h2) * idet, (G00 * h2 - G01 * h1) * idet


@cached_tensors(32)
def _device_taps(winsize: int, gaussian: bool, device: torch.device):
    return torch.from_numpy(
        blur_taps(winsize, gaussian).astype(np.float32)).to(device)


@functools.lru_cache(maxsize=32)
def _host_taps(winsize: int, gaussian: bool):
    taps = blur_taps(winsize, gaussian).astype(np.float32)
    return (ctypes.c_float * len(taps))(*taps.tolist())


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
    r = winsize // 2
    th, tw, _ = choose_tile(r, _smem_limit(M.device.index), B, H, W,
                            sm_count(M.device.index))
    u, v = launch(M, winsize, gaussian, r in REG_RADII, (th, tw))
    blur_solve.launches += 1
    return u, v


blur_solve.launches = 0


def launch(M: torch.Tensor, winsize: int, gaussian: bool, reg: bool,
           tile: tuple[int, int]) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch on a checked contiguous CUDA tensor: the register-blocked
    kernel (``reg``, radii in :data:`REG_RADII`, a tile of
    :data:`REG_TILES`) or the generic one, with ``tile``.  ``blur_solve``
    passes its choice; ``chip_smoke.py --variants`` passes others to measure
    them apart.  Counts nothing."""
    B, _, H, W = M.shape
    r = winsize // 2
    th, tw = tile
    u = torch.empty((B, H, W), dtype=torch.float32, device=M.device)
    v = torch.empty_like(u)
    stream = torch.cuda.current_stream(M.device).cuda_stream
    # the launcher runs on the current device: select M's for the call only
    with torch.cuda.device(M.device):
        if reg:
            err = load_kernels().ofc_blur_solve_reg(
                M.data_ptr(), _host_taps(winsize, bool(gaussian)), u.data_ptr(),
                v.data_ptr(), B, H, W, r, tw, stream)
        else:
            taps = _device_taps(winsize, bool(gaussian), M.device)
            err = load_kernels().ofc_blur_solve(
                M.data_ptr(), taps.data_ptr(), u.data_ptr(), v.data_ptr(), B,
                H, W, r, th, tw, _generic_smem(th, tw, r), stream)
    check_launch(err, "blur_solve")
    return u, v
