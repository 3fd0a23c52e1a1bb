"""K5: Farneback's prep stage of one pyramid level in one launch.

The reference leaves this stage to XLA, so K5 replaces no TPU kernel; the
CUDA source is ``csrc/farneback_prep.cu``, whose header states the design
and the bound (bytes: each frame read once a level, the five planes
written once).  It computes :func:`farneback_prep_plain`: the reflect101
Gaussian at full resolution, the bilinear resize to the level, and the
polynomial expansion into five planes (bx, by, axx, ayy, qxy), [N, H, W]
fp32 frames -> [N, 5, lh, lw] fp32 planes.

``farneback_prep`` launches the kernel for CUDA tensors and uses
:func:`farneback_prep_plain` only for CPU tensors.  The kernel unrolls
cv2's two documented expansion sizes, :data:`UNROLLED_POLY_N`; a variant
of it takes every other ``poly_n`` up to :data:`MAX_POLY_N` at run time,
and past that the wrapper raises on the card.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core.device import H100_SMS, cached_tensors, sm_count
from ..core.filters import _corr1d, _pad2d, _pad_index, _sepconv
from ..core.resize import _taps, resize_bilinear
from ._build import check_launch, load_kernels
from .solve2x2 import _smem_limit

UNROLLED_POLY_N = (5, 7)  # cv2's two documented poly_n
MAX_POLY_N = 15  # the source's kMaxPolyN
TILES = (16, 32)  # a block's output tile: tile x tile level pixels
STRIP_FLOATS = 8192  # the vertical blur's strip: at most 32 KB, two rows at least


@functools.lru_cache(maxsize=None)
def _poly_exp_inverse(n: int, sigma: float) -> tuple:
    """1-D kernels {g, x g, x^2 g} and the needed elements of the inverse
    Gaussian moment matrix for window half-size n."""
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    g /= g.sum()
    m2 = float((x * x * g).sum())
    m4 = float((x**4 * g).sum())
    G = np.array([
        [1.0, 0, 0, m2, m2, 0],
        [0, m2, 0, 0, 0, 0],
        [0, 0, m2, 0, 0, 0],
        [m2, 0, 0, m4, m2 * m2, 0],
        [m2, 0, 0, m2 * m2, m4, 0],
        [0, 0, 0, 0, 0, m2 * m2],
    ])
    invG = np.linalg.inv(G)
    return g, x * g, x * x * g, invG[1, 1], invG[0, 3], invG[3, 3], invG[5, 5]


def _poly_planes(img: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """Polynomial-expansion planes [..., 5, H, W] = (bx, by, axx, ayy, qxy)
    of [..., H, W] images; replicate border.  The six separable correlations
    share one padded image and three vertical passes."""
    g, xg, xxg, ig11, ig03, ig33, ig55 = _poly_exp_inverse(n, float(sigma))
    x = _pad2d(img.float(), n, n, "replicate")
    tg, txg, txxg = (_corr1d(x, k, x.dim() - 2) for k in (g, xg, xxg))
    w = x.dim() - 1
    s0, sx, sxx = (_corr1d(tg, k, w) for k in (g, xg, xxg))
    sy, sxy = _corr1d(txg, g, w), _corr1d(txg, xg, w)
    syy = _corr1d(txxg, g, w)
    return torch.stack([ig11 * sx, ig11 * sy, ig03 * s0 + ig33 * sxx,
                        ig03 * s0 + ig33 * syy, ig55 * sxy], dim=-3)


def farneback_prep_plain(img: torch.Tensor, size: tuple[int, int],
                         blur: np.ndarray, poly_n: int,
                         poly_sigma: float) -> torch.Tensor:
    """Plain PyTorch version of K5 (any device): [N, H, W] frames blurred by
    the separable ``blur`` taps (reflect101), resized bilinearly to ``size``
    = (lh, lw) and expanded -> [N, 5, lh, lw] planes, as shifted-slice
    sums."""
    level = resize_bilinear(_sepconv(img, blur, blur, "reflect101"), size)
    return _poly_planes(level, poly_n, poly_sigma).contiguous()


def span(src: int, dst: int, p: int, e: int) -> int:
    """Padded rows (or columns) that ``e`` consecutive level rows read
    through the resize from ``src`` to ``dst`` and a blur of 2p + 1 taps,
    at most: the resize's taps of level rows d0 < d1 lie at most
    (d1 - d0) src / dst + 2 apart (+ 2 for the fp32 coordinates), and never
    past the padded axis."""
    reach = e - 1 if src == dst else int(np.floor((e - 1) * src / dst)) + 4
    return min(src, reach + 1) + 2 * p


def launch_config(H: int, W: int, lh: int, lw: int, p: int, poly_n: int,
                  tile: int) -> dict:
    """The spans, the vertical blur's strip (row slots a pass) and one
    block's dynamic shared memory in bytes (the layout of the source's
    kernel) for a ``tile`` x ``tile`` output tile."""
    e = tile + 2 * poly_n
    rh = e * (1 if lh == H else 2)
    rw = e * (1 if lw == W else 2)
    span_h, span_w = span(H, lh, p, e), span(W, lw, p, e)
    # pairs of row slots: an even count, two at least
    strip_rows = max(2, min(rh, STRIP_FLOATS // span_w) // 2 * 2)
    words = (2 * p + 1 + span_h + span_w + rh + rw
             + max(strip_rows * span_w, 3 * tile * (e + 1)) + e * e)
    return {"span_h": span_h, "span_w": span_w, "strip_rows": strip_rows,
            "smem": 4 * words}


def choose_tile(frames: int, lh: int, lw: int, p: int,
                sms: int = H100_SMS) -> int:
    """The output tile's side: 16 where the blur is wide (p >= 5: a 32-tile
    block's blur is then long enough to leave SMs idle at the end), or
    where 32-tiles would give the card fewer than two blocks an SM; else
    32, whose narrower halo repeats less of the blur and the expansion.
    Measured on the H100 at 720p (7 frames), 1080p (14 and 2) and 480p (1),
    each level at both tiles (PERF.md)."""
    blocks = frames * -(-lh // 32) * -(-lw // 32)
    return 16 if p >= 5 or blocks < 2 * sms else 32


@functools.lru_cache(maxsize=32)
def _host_poly(poly_n: int, poly_sigma: float):
    """The expansion's taps g, xg, xxg and ig11, ig03, ig33, ig55, fp32."""
    g, xg, xxg, *ig = _poly_exp_inverse(poly_n, poly_sigma)
    vals = np.concatenate([g, xg, xxg, ig]).astype(np.float32)
    return (ctypes.c_float * len(vals))(*vals.tolist())


@cached_tensors(32)
def _device_blur(blur: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(blur, dtype=torch.float32).to(device)


def _check(img: torch.Tensor, size: tuple[int, int], blur: np.ndarray) -> None:
    if img.dim() != 3:
        raise ValueError(f"frames must be [N, H, W], got {tuple(img.shape)}")
    if img.dtype != torch.float32:
        raise TypeError(f"frames must be float32, got {img.dtype}")
    if not img.is_contiguous():
        raise ValueError("frames must be contiguous")
    lh, lw = size
    if not (1 <= lh <= img.shape[1] and 1 <= lw <= img.shape[2]):
        raise ValueError(f"level {size} is not a downscale of {tuple(img.shape[1:])}")
    if len(blur) % 2 != 1:
        raise ValueError(f"the blur needs an odd number of taps, got {len(blur)}")


def farneback_prep(img: torch.Tensor, size: tuple[int, int], blur: np.ndarray,
                   poly_n: int, poly_sigma: float) -> torch.Tensor:
    """K5: [N, 5, lh, lw] fp32 expansion planes of level ``size`` = (lh, lw)
    from [N, H, W] fp32 frames, ``blur`` the level's Gaussian taps.

    CUDA tensors launch the kernel on the current stream (counted in
    ``farneback_prep.launches``); ``poly_n`` must lie in 1 ..
    :data:`MAX_POLY_N` there.  CPU tensors take the plain version."""
    _check(img, size, blur)
    if img.device.type == "cpu":
        return farneback_prep_plain(img, size, blur, poly_n, poly_sigma)
    if img.device.type != "cuda":
        raise ValueError(f"unsupported device {img.device}")
    if not 1 <= poly_n <= MAX_POLY_N:
        raise ValueError(f"the kernel takes poly_n in 1..{MAX_POLY_N}, got {poly_n}")
    N, H, W = img.shape
    lh, lw = size
    out = torch.empty((N, 5, lh, lw), dtype=torch.float32, device=img.device)
    if N:
        launch(img, out, blur, poly_n, poly_sigma,
               choose_tile(N, lh, lw, len(blur) // 2, sm_count(img.device.index)))
        farneback_prep.launches += 1
    return out


farneback_prep.launches = 0


def launch(img: torch.Tensor, out: torch.Tensor, blur: np.ndarray,
           poly_n: int, poly_sigma: float, tile: int) -> None:
    """One launch on checked contiguous CUDA tensors, ``out`` [N, 5, lh,
    lw], with a ``tile`` of :data:`TILES`.  ``farneback_prep`` passes its
    choice; ``chip_smoke.py``'s K5 phase passes both to time them.  Counts
    nothing."""
    N, H, W = img.shape
    lh, lw = out.shape[-2:]
    p = len(blur) // 2
    cfg = launch_config(H, W, lh, lw, p, poly_n, tile)
    limit = _smem_limit(img.device.index)
    if cfg["smem"] > limit:
        raise ValueError(f"a {H}x{W} frame's level {(lh, lw)} needs {cfg['smem']} "
                         f"bytes of shared memory a block; this card allows {limit}")
    dev = img.device
    rows = _taps(H, lh, dev) if lh != H else (None, None, None)
    cols = _taps(W, lw, dev) if lw != W else (None, None, None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        err = load_kernels().ofc_farneback_prep(
            img.data_ptr(), out.data_ptr(), N, H, W, lh, lw,
            _pad_index(H, p, "reflect101", dev).data_ptr(),
            _pad_index(W, p, "reflect101", dev).data_ptr(),
            *(ptr(t) for t in rows), *(ptr(t) for t in cols),
            _device_blur(tuple(float(v) for v in blur), dev).data_ptr(), p,
            poly_n, _host_poly(poly_n, float(poly_sigma)), tile, cfg["span_h"],
            cfg["span_w"], cfg["strip_rows"], cfg["smem"],
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(err, "farneback_prep")
