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

Stages 1-2 are plain PyTorch ops (the reference leaves them to XLA); stage 3
runs the two CUDA kernels on the card and their plain versions on the CPU.
Layout is plane-major ([N, 5, lh, lw] expansion planes) and storage fp32.

The clip and stream entry points expand every frame once per level and
share the planes between its two pairs.  The reference's TPU-layout gates
(``CLIP_SHARE_ALL_MAX_PIXELS``, ``BLOCK_WARP_R0SRC``) have no counterpart:
there is one mode.  :func:`farneback_traffic_breakdown` counts the bytes
this module's own stages move.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.filters import _corr1d, _pad2d, _sepconv, gaussian_kernel_1d
from ..core.resize import resize_bilinear
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


def _level_planes(img: torch.Tensor, H: int, W: int, k: int, pyr_scale: float,
                  poly_n: int, poly_sigma: float) -> torch.Tensor:
    """[N, H, W] full-resolution frames -> [N, 5, lh, lw] expansion planes of
    pyramid level ``k``: reflect101 blur at full resolution, bilinear resize,
    polynomial expansion."""
    scale = pyr_scale**k
    sigma = (1.0 / scale - 1.0) * 0.5
    smooth_sz = max(int(round(sigma * 5)) | 1, 3)
    kern = gaussian_kernel_1d(smooth_sz, sigma)
    level = resize_bilinear(_sepconv(img, kern, kern, "reflect101"),
                            _level_size(H, W, scale))
    return _poly_planes(level, poly_n, poly_sigma).contiguous()


def _pyramid_flow(planes_at, N: int, H: int, W: int, n_levels: int,
                  pyr_scale: float, winsize: int, iterations: int,
                  use_gauss: bool, init_uv, device: torch.device):
    """Coarse-to-fine iterations.  ``planes_at(k)`` gives level k's (R0, R1)
    [N, 5, lh, lw]; ``init_uv`` is None or full-resolution (u, v) [N, H, W].
    Returns (u, v) [N, H, W]."""
    u = v = None
    for k in range(n_levels, -1, -1):
        scale = pyr_scale**k
        lh, lw = _level_size(H, W, scale)
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
        R0, R1 = planes_at(k)
        for _ in range(iterations):
            M = farneback_update(R0, R1, u, v)
            u, v = blur_solve(M, winsize, use_gauss)
    return u, v


def _frames(x, device: torch.device) -> torch.Tensor:
    """Frames as fp32 on ``device`` (numpy arrays and tensors alike; integer
    frames are sent as they are and converted on the device)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device).float()


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
    unknown = set(_step_kwargs) - FLOW_KWARGS
    if unknown:
        raise TypeError(f"farneback_stream_planes got unexpected keyword(s) "
                        f"{sorted(unknown)}")
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


def _corr_passes(taps: int) -> int:
    """fp32 passes over the output of :func:`~..core.filters._corr1d` with
    ``taps`` taps: a multiply per tap (read, write) and an add per tap
    after the first (two reads, a write)."""
    return 2 * taps + 3 * (taps - 1)


def _pad_passes(rows: int, cols: int, p: int) -> int:
    """Values moved by ``_pad2d`` of [rows, cols] by p: one gather of the
    rows, one of the columns (each output value read and written)."""
    return 2 * (rows + 2 * p) * cols + 2 * (rows + 2 * p) * (cols + 2 * p)


def _resize_passes(src: tuple, dst: tuple) -> int:
    """Values moved by ``resize_bilinear`` from [src] to [dst]: per resized
    axis two gathers (read, write), two weightings (read, write) and an add
    (two reads, a write) over that pass's output."""
    (h0, w0), (h1, w1) = src, dst
    moved = 0
    if h1 != h0:
        moved += 11 * h1 * w0
    if w1 != w0:
        moved += 11 * h1 * w1
    return moved


def farneback_traffic_breakdown(H: int, W: int, levels: int = 3,
                                pyr_scale: float = 0.5, iterations: int = 3,
                                clip_frames: int | None = 5, *,
                                oob_share: float = 0.0) -> dict:
    """Device-memory bytes per computed flow field of this module's
    pipeline, by stage and by pyramid level: the numerator of the stage
    roofline (``tools/stage_roofline.py``).  Same name and keys as the
    reference's, counting the port's own traffic, every array fp32:

    - ``poly``, the prep stage of each level, as the shifted-slice sums run
      it: the reflect101 blur at full resolution (its pads, ``smooth_sz``
      taps down, then across), the bilinear resize to the level, and the
      polynomial expansion at cv2's default ``poly_n`` = 5, which every
      timed caller uses (its replicate pads, three vertical and six
      horizontal correlations of 11 taps, the five planes' weighted sums
      and their stack).  Every elementwise operation counts
      its inputs read and its output written once.  A clip of
      ``clip_frames`` frames expands each frame once for T - 1 fields (the
      port shares every level); pairs (``None``) expand two frames a field;
    - ``update``, K1's exact warp: R0's 5 planes, u, v and M's 5 per pixel,
      and R1's 5 where the sample is in bounds (``oob_share`` of the pixels
      are not: their R1 is not read; 0 counts every pixel), 68 bytes a
      pixel at most;
    - ``solve``, K2: M in, u and v out, 28 bytes a pixel (M's round trip
      between the two kernels is K1's write and K2's read);
    - ``resize``, the flow between levels: the coarsest level's zero u, v
      and each finer level's two resizes and scalings.  The final stack of
      (u, v) into the flow array is not counted.

    The reference's TPU counts (tile-quantized patch DMAs, phase copies,
    bf16 planes) have no counterpart here.  Returns ``{"poly", "update",
    "solve", "resize", "total", "levels": [{"k", "lh", "lw", "poly",
    "poly_per_expansion", "update_per_iter", "solve_per_iter", "resize"},
    ...]}`` in bytes per field, coarsest level first; the per-iteration
    entries are per field and per iteration."""
    T = clip_frames
    if T is not None and T < 2:
        raise ValueError(f"clip_frames={T}: need >= 2 frames (T-1 fields)")
    if not 0.0 <= oob_share <= 1.0:
        raise ValueError(f"oob_share={oob_share} is not a share")
    exp = T / (T - 1.0) if T else 2.0
    poly_n = 5
    taps = 2 * poly_n + 1
    f32 = 4
    n_levels = _num_levels(H, W, levels, pyr_scale)
    out = {"poly": 0.0, "update": 0.0, "solve": 0.0, "resize": 0.0,
           "levels": []}
    prev_size = None
    for k in range(n_levels, -1, -1):
        scale = pyr_scale**k
        lh, lw = _level_size(H, W, scale)
        n = lh * lw
        ks = max(int(round((1.0 / scale - 1.0) * 0.5 * 5)) | 1, 3)
        p = ks // 2
        blur = (_pad_passes(H, W, p) + _corr_passes(ks) * H * (W + 2 * p)
                + _corr_passes(ks) * H * W)
        expand = (_pad_passes(lh, lw, poly_n)
                  + 3 * _corr_passes(taps) * lh * (lw + 2 * poly_n)
                  + 6 * _corr_passes(taps) * n + 30 * n)
        poly = f32 * (blur + _resize_passes((H, W), (lh, lw)) + expand)
        upd = f32 * (12 + 5 * (1.0 - oob_share)) * n
        slv = f32 * 7 * n
        if prev_size is None:
            rsz = f32 * 2 * n  # the zero u, v
        else:  # u and v: resized, then divided by pyr_scale
            rsz = f32 * 2 * (_resize_passes(prev_size, (lh, lw)) + 2 * n)
        prev_size = (lh, lw)
        out["poly"] += exp * poly
        out["update"] += iterations * upd
        out["solve"] += iterations * slv
        out["resize"] += rsz
        out["levels"].append({
            "k": k, "lh": lh, "lw": lw, "poly": exp * poly,
            "poly_per_expansion": poly, "update_per_iter": upd,
            "solve_per_iter": slv, "resize": rsz})
    out["total"] = out["poly"] + out["update"] + out["solve"] + out["resize"]
    return out
