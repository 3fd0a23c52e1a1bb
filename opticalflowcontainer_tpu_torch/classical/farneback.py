"""Dense Farneback optical flow, cv2.calcOpticalFlowFarneback parity, PyTorch.

Port of the reference's ``classical/farneback.py`` (Farneback 2003, with
OpenCV's operating conventions).  Per pyramid level, coarsest first:

1. each frame is blurred at full resolution (reflect101 Gaussian, sigma =
   (1/scale - 1)/2) and resized bilinearly to the level (cv2's pyramid, not a
   pyrDown chain);
2. polynomial expansion into 5 planes (bx, by, axx, ayy, qxy) by six
   separable replicate-border correlations;
3. ``iterations`` x (K1 ``farneback_update``: warp frame 1's planes by the
   current flow and form the normal equations; K2 ``blur_solve``: winsize
   blur and 2x2 solve for the total displacement).

Stages 1-2 are one launch of K5 ``farneback_prep`` a level on the card (the
reference leaves them to XLA) and its plain version's shifted-slice sums on
the CPU; stage 3 runs the two CUDA kernels on the card and their plain
versions on the CPU.
Layout is plane-major ([N, 5, lh, lw] expansion planes) and storage fp32.

The clip and stream entry points expand every frame once per level and
share the planes between its two pairs.  The reference's TPU-layout gates
(``CLIP_SHARE_ALL_MAX_PIXELS``, ``BLOCK_WARP_R0SRC``) have no counterpart:
there is one mode.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import spans
from ..core.device import resolve_device, upload
from ..core.filters import gaussian_kernel_1d
from ..core.resize import resize_bilinear
from ..ops.farneback_prep import _poly_planes, farneback_prep
from ..ops.farneback_update import farneback_update
from ..ops.solve2x2 import blur_solve

OPTFLOW_USE_INITIAL_FLOW = 4
OPTFLOW_FARNEBACK_GAUSSIAN = 256

# keyword arguments the flow entry points take besides the frames
FLOW_KWARGS = frozenset({"pyr_scale", "levels", "winsize", "iterations",
                         "poly_n", "poly_sigma", "flags"})


def check_flow_kwargs(caller: str, kwargs: dict) -> None:
    """Raise TypeError naming ``caller`` for keywords outside FLOW_KWARGS
    (a misspelt keyword forwarded to the flow would otherwise be lost)."""
    unknown = set(kwargs) - FLOW_KWARGS
    if unknown:
        raise TypeError(f"{caller} got unexpected keyword(s) {sorted(unknown)}; "
                        f"supported: {sorted(FLOW_KWARGS)}")


def poly_exp(img: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """Polynomial-expansion coefficients [..., H, W, 5] = (bx, by, axx, ayy,
    qxy): local model c + bx dx + by dy + axx dx^2 + ayy dy^2 + qxy dx dy
    (dx right, dy down).  Border: replicate."""
    return _poly_planes(img, n, sigma).movedim(-3, -1)


def _num_levels(H: int, W: int, levels: int, pyr_scale: float) -> int:
    """cv2 clamps the pyramid depth so the coarsest level stays >= ~32 px."""
    k = 0
    scale = 1.0
    while k < levels:
        scale *= pyr_scale
        if W * scale < 32.0 or H * scale < 32.0:
            break
        k += 1
    return k


def _level_size(H: int, W: int, scale: float) -> tuple[int, int]:
    # cvRound: round-half-to-even, same as python round()
    return int(round(H * scale)), int(round(W * scale))


def _level_taps(k: int, pyr_scale: float) -> np.ndarray:
    """Pyramid level ``k``'s Gaussian at full resolution: sigma =
    (1/scale - 1)/2, cv2's kernel size (at least 3 taps)."""
    sigma = (1.0 / pyr_scale**k - 1.0) * 0.5
    return gaussian_kernel_1d(max(int(round(sigma * 5)) | 1, 3), sigma)


def _level_planes(img: torch.Tensor, H: int, W: int, k: int, pyr_scale: float,
                  poly_n: int, poly_sigma: float) -> torch.Tensor:
    """[N, H, W] full-resolution frames -> [N, 5, lh, lw] expansion planes of
    pyramid level ``k``: reflect101 blur at full resolution, bilinear resize,
    polynomial expansion: K5 on the card, its plain version's
    shifted-slice sums on the CPU."""
    with spans.annotate(spans.FARNEBACK_PREP):
        kern = _level_taps(k, pyr_scale)
        size = _level_size(H, W, pyr_scale**k)
        return farneback_prep(img.contiguous(), size, kern, poly_n,
                              poly_sigma)


def _pyramid_flow(planes_at, N: int, H: int, W: int, n_levels: int,
                  pyr_scale: float, winsize: int, iterations: int,
                  use_gauss: bool, init_uv, device: torch.device):
    """Coarse-to-fine iterations.  ``planes_at(k)`` gives level k's (R0, R1)
    [N, 5, lh, lw] (its prep, before the level's solve span opens);
    ``init_uv`` is None or full-resolution (u, v) [N, H, W].  Returns (u, v)
    [N, H, W]."""
    u = v = None
    for k in range(n_levels, -1, -1):
        R0, R1 = planes_at(k)
        scale = pyr_scale**k
        lh, lw = _level_size(H, W, scale)
        with spans.annotate(spans.FARNEBACK_SOLVE):
            if u is None:
                if init_uv is not None:
                    u = resize_bilinear(init_uv[0], (lh, lw)) * scale
                    v = resize_bilinear(init_uv[1], (lh, lw)) * scale
                else:
                    u = torch.zeros((N, lh, lw), dtype=torch.float32, device=device)
                    v = torch.zeros_like(u)
            else:
                u = resize_bilinear(u, (lh, lw)) / pyr_scale
                v = resize_bilinear(v, (lh, lw)) / pyr_scale
            u, v = u.contiguous(), v.contiguous()
            for _ in range(iterations):
                M = farneback_update(R0, R1, u, v)
                u, v = blur_solve(M, winsize, use_gauss)
    return u, v


def _frames(x, device: torch.device) -> torch.Tensor:
    """Frames as fp32 on ``device`` (numpy arrays and tensors alike; integer
    frames are sent as they are, host arrays to the card through pinned
    memory by ``core.device.upload``, and converted on the device)."""
    with spans.annotate(spans.FARNEBACK_UPLOAD):
        return upload(x, device).float()


def _init_uv(flow, batch: tuple, H: int, W: int, device: torch.device):
    f0 = _frames(flow, device)
    N = int(np.prod(batch, dtype=np.int64)) if batch else 1
    if f0.shape[-3:] != (H, W, 2):
        raise ValueError(f"initial flow must be [..., {H}, {W}, 2], got "
                         f"{tuple(f0.shape)}")
    f0 = f0.expand(batch + (H, W, 2)).reshape(N, H, W, 2)
    return f0[..., 0], f0[..., 1]


def calc_optical_flow_farneback(prev, next, flow=None, pyr_scale: float = 0.5,
                                levels: int = 3, winsize: int = 15,
                                iterations: int = 3, poly_n: int = 5,
                                poly_sigma: float = 1.2, flags: int = 0, *,
                                device=None) -> torch.Tensor:
    """``cv2.calcOpticalFlowFarneback`` parity.  ``prev``/``next`` are
    single-channel [..., H, W] images (uint8 range, any leading batch dims,
    numpy or torch); returns flow [..., H, W, 2] (u = x-displacement,
    v = y-displacement) mapping prev -> next, on ``device`` (CUDA unless
    ``device="cpu"``).  ``flow`` seeds the coarsest level under
    ``OPTFLOW_USE_INITIAL_FLOW``."""
    dev = resolve_device(device)
    prev = _frames(prev, dev)
    next = _frames(next, dev)
    if prev.shape != next.shape:
        raise ValueError(f"prev {tuple(prev.shape)} != next {tuple(next.shape)}")
    H, W = prev.shape[-2], prev.shape[-1]
    batch = tuple(prev.shape[:-2])
    N = int(np.prod(batch, dtype=np.int64)) if batch else 1
    use_gauss = bool(flags & OPTFLOW_FARNEBACK_GAUSSIAN)
    use_init = bool(flags & OPTFLOW_USE_INITIAL_FLOW) and flow is not None
    init_uv = _init_uv(flow, batch, H, W, dev) if use_init else None
    p = prev.reshape(N, H, W)
    q = next.reshape(N, H, W)

    def planes_at(k):
        return (_level_planes(p, H, W, k, pyr_scale, poly_n, poly_sigma),
                _level_planes(q, H, W, k, pyr_scale, poly_n, poly_sigma))

    u, v = _pyramid_flow(planes_at, N, H, W,
                         _num_levels(H, W, levels, pyr_scale), pyr_scale,
                         winsize, iterations, use_gauss, init_uv, dev)
    return torch.stack([u, v], dim=-1).reshape(batch + (H, W, 2))


def farneback_batched(prev, next, **kwargs) -> torch.Tensor:
    """Batched Farneback: [B, H, W] x2 -> [B, H, W, 2] (the implementation is
    batch-native; this is the documented batch entry point)."""
    return calc_optical_flow_farneback(prev, next, **kwargs)


def farneback_clip(frames, flow=None, pyr_scale: float = 0.5, levels: int = 3,
                   winsize: int = 15, iterations: int = 3, poly_n: int = 5,
                   poly_sigma: float = 1.2, flags: int = 0, *,
                   device=None) -> torch.Tensor:
    """Dense flow over a clip: [T, ..., H, W] -> [T-1, ..., H, W, 2] for
    consecutive pairs, with ``calc_optical_flow_farneback``'s keywords (an
    explicit signature, so a misspelt keyword raises).  Each frame's
    expansion is computed once per level and shared between its roles as
    frame 1 of one pair and frame 0 of the next.  ``flow`` (with
    ``OPTFLOW_USE_INITIAL_FLOW``) is one [H, W, 2] seed for every pair or one
    per pair."""
    dev = resolve_device(device)
    fr = _frames(frames, dev)
    if fr.dim() < 3 or fr.shape[0] < 2:
        raise ValueError(f"a clip is [T >= 2, ..., H, W], got {tuple(fr.shape)}")
    T, H, W = fr.shape[0], fr.shape[-2], fr.shape[-1]
    pair_batch = (T - 1,) + tuple(fr.shape[1:-2])
    S = int(np.prod(fr.shape[1:-2], dtype=np.int64))  # streams per frame
    N = (T - 1) * S
    init_uv = None
    if flags & OPTFLOW_USE_INITIAL_FLOW and flow is not None:
        init_uv = _init_uv(flow, pair_batch, H, W, dev)
    flat = fr.reshape(T * S, H, W)

    def planes_at(k):
        P = _level_planes(flat, H, W, k, pyr_scale, poly_n, poly_sigma)
        return P[:N], P[S:]  # contiguous views: frames t and t+1

    u, v = _pyramid_flow(planes_at, N, H, W,
                         _num_levels(H, W, levels, pyr_scale), pyr_scale,
                         winsize, iterations,
                         bool(flags & OPTFLOW_FARNEBACK_GAUSSIAN), init_uv, dev)
    return torch.stack([u, v], dim=-1).reshape(pair_batch + (H, W, 2))


def _check_share(share: str) -> None:
    if share != "all":
        raise ValueError(f"share={share!r}: the port has one stream mode, "
                         "share='all' (every level's planes are carried)")


def farneback_stream_planes(gray, pyr_scale: float = 0.5, levels: int = 3,
                            poly_n: int = 5, poly_sigma: float = 1.2,
                            share: str = "all", *, device=None,
                            **_step_kwargs) -> tuple:
    """Per-level expansion planes of one frame, the device-resident state of
    :func:`farneback_stream_step`: a tuple, coarsest level to finest, of
    [N, 5, lh, lw] fp32 planes (N = 1 for an [H, W] frame, else the leading
    dim of [N, H, W]).  Extra keywords the step takes (winsize, ...) are
    accepted and unused, so one kwargs dict serves both calls."""
    _check_share(share)
    check_flow_kwargs("farneback_stream_planes", _step_kwargs)
    dev = resolve_device(device)
    g = _frames(gray, dev)
    H, W = g.shape[-2], g.shape[-1]
    g = g.reshape(-1, H, W)
    n_levels = _num_levels(H, W, levels, pyr_scale)
    return tuple(_level_planes(g, H, W, k, pyr_scale, poly_n, poly_sigma)
                 for k in range(n_levels, -1, -1))


def farneback_stream_step(prev_planes, gray, pyr_scale: float = 0.5,
                          levels: int = 3, winsize: int = 15,
                          iterations: int = 3, poly_n: int = 5,
                          poly_sigma: float = 1.2, flags: int = 0,
                          share: str = "all", *, device=None):
    """One streaming step with the previous frame's expansion carried as
    state: ``(prev_planes, gray [H, W]) -> (flow [H, W, 2], planes)``;
    batched ``gray [N, H, W] -> flow [N, H, W, 2]``.  The returned planes
    feed the next call, so each streamed frame is expanded exactly once;
    the flow equals ``calc_optical_flow_farneback(prev_gray, gray)``."""
    _check_share(share)
    dev = resolve_device(device)
    g = _frames(gray, dev)
    H, W = g.shape[-2], g.shape[-1]
    batched = g.dim() > 2
    g = g.reshape(-1, H, W)
    N = g.shape[0]
    n_levels = _num_levels(H, W, levels, pyr_scale)
    if len(prev_planes) != n_levels + 1:
        raise ValueError(f"state has {len(prev_planes)} levels, this frame "
                         f"size and these parameters need {n_levels + 1}")
    new_planes = []

    def planes_at(k):
        R1 = _level_planes(g, H, W, k, pyr_scale, poly_n, poly_sigma)
        R0 = prev_planes[n_levels - k]
        if R0.shape != R1.shape or R0.device != R1.device:
            raise ValueError(f"state level {n_levels - k} is "
                             f"{tuple(R0.shape)} on {R0.device}, the frame's "
                             f"is {tuple(R1.shape)} on {R1.device}")
        new_planes.append(R1)
        return R0, R1

    u, v = _pyramid_flow(planes_at, N, H, W, n_levels, pyr_scale, winsize,
                         iterations, bool(flags & OPTFLOW_FARNEBACK_GAUSSIAN),
                         None, dev)
    flow = torch.stack([u, v], dim=-1)
    return (flow if batched else flow[0]), tuple(new_planes)
