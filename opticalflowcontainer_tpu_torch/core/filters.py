"""cv2-parity separable filtering in plain PyTorch.

Counterpart of the reference's ``core/filters.py``: OpenCV's
``getGaussianKernel``, a separable correlation with OpenCV's border modes,
``GaussianBlur``, ``boxFilter`` and the 3x3 ``Sobel``, the Scharr
derivatives of the LK tracker, and the adaptive node's median, bilateral
and CLAHE filters.  Border conventions:

- ``BORDER_REFLECT_101`` == ``numpy.pad(mode="reflect")``  (GaussianBlur,
  pyrDown, Sobel)
- ``BORDER_REPLICATE``   == ``numpy.pad(mode="edge")``     (inside the
  Farneback polynomial expansion and the winsize blur, the Scharr
  derivatives)
- ``BORDER_REFLECT``     == ``numpy.pad(mode="symmetric")``
- ``BORDER_CONSTANT``    == zeros

Filters take ``[..., H, W]`` float tensors.  The correlation is a sum of
scaled shifted slices, the same order of operations as the reference's CPU
form, in fp32 throughout (no convolution op, so no TF32 on the card).
"""
from __future__ import annotations

import numpy as np
import torch

from .device import cached_tensors

_BORDER_TO_NP = {"reflect101": "reflect", "replicate": "edge",
                 "reflect": "symmetric"}


def gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    """OpenCV ``getGaussianKernel`` parity (float64, normalized).

    When ``sigma <= 0`` OpenCV derives it from the kernel size
    (``sigma = 0.3*((ksize-1)*0.5 - 1) + 0.8``), except for ksize <= 7 where
    it returns fixed binomial-style kernels.
    """
    if sigma <= 0 and ksize <= 7 and ksize % 2 == 1:
        fixed = {
            1: [1.0],
            3: [0.25, 0.5, 0.25],
            5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
            7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
        }
        return np.array(fixed[ksize], np.float64)
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return g / g.sum()


@cached_tensors(256)
def _pad_index(n: int, p: int, border: str, device: torch.device) -> torch.Tensor:
    """Source index of each padded position (numpy's pad modes, so any pad
    width behaves as the reference's ``jnp.pad``), kept on ``device``: an
    upload per call would synchronize the stream."""
    idx = np.pad(np.arange(n), p, mode=_BORDER_TO_NP[border])
    return torch.from_numpy(idx).to(device)


def _pad2d(img: torch.Tensor, ph: int, pw: int, border: str) -> torch.Tensor:
    """Pad the trailing two dims by (ph, pw) with an OpenCV border mode."""
    if border == "constant":
        return torch.nn.functional.pad(img, (pw, pw, ph, ph)) if ph or pw else img
    H, W = img.shape[-2], img.shape[-1]
    if ph:
        img = img.index_select(-2, _pad_index(H, ph, border, img.device))
    if pw:
        img = img.index_select(-1, _pad_index(W, pw, border, img.device))
    return img


def _corr1d(x: torch.Tensor, k: np.ndarray, dim: int) -> torch.Tensor:
    """VALID 1-D correlation along ``dim``: sum_t k[t] * x[i + t]."""
    n = x.shape[dim] - len(k) + 1
    out = None
    for t, kv in enumerate(k):
        term = x.narrow(dim, t, n) * float(kv)
        out = term if out is None else out + term
    return out


def _sepconv(img: torch.Tensor, kx: np.ndarray, ky: np.ndarray,
             border: str) -> torch.Tensor:
    """Separable 2-D correlation over the trailing [H, W] dims with an OpenCV
    border mode: vertical pass by ``ky``, then horizontal by ``kx``."""
    x = _pad2d(img.float(), len(ky) // 2, len(kx) // 2, border)
    x = _corr1d(x, ky, x.dim() - 2)
    return _corr1d(x, kx, x.dim() - 1)


def gaussian_blur(img: torch.Tensor, ksize: int, sigma: float,
                  border: str = "reflect101") -> torch.Tensor:
    """``cv2.GaussianBlur(img, (ksize, ksize), sigma)`` parity over the
    trailing [H, W], in fp32."""
    k = gaussian_kernel_1d(ksize, sigma)
    return _sepconv(img, k, k, border)


def box_filter(img: torch.Tensor, ksize: int, border: str = "reflect101",
               normalize: bool = True) -> torch.Tensor:
    """``cv2.boxFilter`` / ``cv2.blur`` parity (square ``ksize`` window)
    over the trailing [H, W], in fp32.  As in the reference, both sides
    are padded by ``ksize // 2``: an even window gives one more row and
    column than the input, and the first [H, W] are OpenCV's (its anchor
    at ``ksize // 2``)."""
    k = np.ones(ksize, np.float64)
    if normalize:
        k /= ksize
    return _sepconv(img, k, k, border)


def sobel(img: torch.Tensor, dx: int, dy: int, ksize: int = 3) -> torch.Tensor:
    """``cv2.Sobel`` parity for ksize 3 (the derivative [-1, 0, 1] along
    each axis with a derivative order, the smoothing [1, 2, 1] along the
    other), reflect101 border, over the trailing [H, W], in fp32.  Other
    kernel sizes raise, as in the reference."""
    if ksize != 3:
        raise ValueError(f"sobel: only ksize 3 is implemented, got {ksize}")
    smooth = np.array([1.0, 2.0, 1.0])
    deriv = np.array([-1.0, 0.0, 1.0])
    return _sepconv(img, deriv if dx else smooth, deriv if dy else smooth,
                    "reflect101")


def scharr_deriv(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """3x3 Scharr x and y derivatives scaled by 1/32, the gradient operator
    of OpenCV's LK tracker (``calcScharrDeriv``: smoothing [3, 10, 3] / 32,
    derivative [-1, 0, 1]), replicate border, over the trailing [H, W]."""
    smooth = np.array([3.0, 10.0, 3.0]) / 32.0
    deriv = np.array([-1.0, 0.0, 1.0])
    gx = _sepconv(img, deriv, smooth, "replicate")
    gy = _sepconv(img, smooth, deriv, "replicate")
    return gx, gy


# ------------------------------------------------ adaptive pre/post filters
# The reference's adaptive node (runtime/adaptive.py) filters the frames
# before the flow backend and the flow after it; these run on the tensor's
# device.

def median_filter(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """``cv2.medianBlur`` for odd ``ksize`` on [..., H, W] (border
    replicate): the middle of each sorted ksize x ksize neighbourhood."""
    r = ksize // 2
    x = _pad2d(img, r, r, "replicate")
    H, W = img.shape[-2], img.shape[-1]
    patches = torch.stack([x[..., i:i + H, j:j + W]
                           for i in range(ksize) for j in range(ksize)], dim=-1)
    return patches.sort(dim=-1).values[..., (ksize * ksize) // 2]


def bilateral_filter(img: torch.Tensor, d: int, sigma_color: float,
                     sigma_space: float) -> torch.Tensor:
    """``cv2.bilateralFilter`` equivalent on float [..., H, W]: a brute-force
    disc window of diameter ``d`` (from ``sigma_space`` when ``d <= 0``),
    replicate border, the reference's order of the sums.  ``sigma_color``
    is on the image's scale ([0, 255] or [0, 1])."""
    if d <= 0:
        d = int(round(sigma_space * 1.5)) * 2 + 1
    r = d // 2
    x = _pad2d(img, r, r, "replicate")
    H, W = img.shape[-2], img.shape[-1]
    num = torch.zeros_like(img)
    den = torch.zeros_like(img)
    inv_2sc = -0.5 / (sigma_color * sigma_color)
    for i in range(d):
        for j in range(d):
            di, dj = i - r, j - r
            if di * di + dj * dj > r * r:
                continue
            nb = x[..., i:i + H, j:j + W]
            w_s = float(np.float32(np.exp((di * di + dj * dj) * (-0.5)
                                          / (sigma_space * sigma_space))))
            w = w_s * torch.exp((nb - img) ** 2 * inv_2sc)
            num = num + w * nb
            den = den + w
    return num / den


def clahe(img: torch.Tensor, clip_limit=2.0, grid: int = 8) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalization of float [..., H, W]
    in the 0..255 range, ``cv2.createCLAHE(clip, (grid, grid))``'s
    analogue: tile histograms (integer counts), clipped and redistributed,
    their CDFs as LUTs, and each pixel's value bilinear between the four
    nearest tiles' LUTs.  H and W must be multiples of ``grid``.
    ``clip_limit`` may be a float or a 0-dim tensor on the image's device
    (the adaptive node computes it there)."""
    H, W = img.shape[-2], img.shape[-1]
    if H % grid or W % grid:
        raise ValueError(f"clahe needs H and W divisible by grid={grid}, got {H}x{W}")
    th, tw = H // grid, W // grid
    lead = tuple(img.shape[:-2])
    n_bins = 256
    dev = img.device
    # truncation toward zero of the clipped value, as astype(int32)
    pix = img.clamp(0, 255).to(torch.int64)
    tiles = pix.reshape(*lead, grid, th, grid, tw).movedim(-2, -3)
    tiles = tiles.reshape(*lead, grid * grid, th * tw)
    hist = torch.zeros(*lead, grid * grid, n_bins, device=dev, dtype=torch.float32)
    hist.scatter_add_(-1, tiles, torch.ones(tiles.shape, device=dev))
    clip = torch.as_tensor(clip_limit, dtype=torch.float32, device=dev)
    limit = torch.clamp(clip * (th * tw) / n_bins, min=1.0)
    excess = torch.relu(hist - limit).sum(-1, keepdim=True)
    hist = torch.minimum(hist, limit) + excess / n_bins
    cdf = hist.cumsum(-1)
    luts = (cdf / cdf[..., -1:] * 255.0).reshape(*lead, grid * grid * n_bins)

    ys = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) / th - 0.5
    xs = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) / tw - 0.5
    y0 = ys.floor().clamp(0, grid - 1).to(torch.int64)
    x0 = xs.floor().clamp(0, grid - 1).to(torch.int64)
    y1 = (y0 + 1).clamp(max=grid - 1)
    x1 = (x0 + 1).clamp(max=grid - 1)
    wy = (ys - y0).clamp(0.0, 1.0)[:, None]
    wx = (xs - x0).clamp(0.0, 1.0)[None, :]

    def lut_at(ty, tx):
        tile = ty[:, None] * grid + tx[None, :]  # [H, W]
        idx = (tile * n_bins + pix).reshape(*lead, H * W)
        return luts.gather(-1, idx).reshape(*lead, H, W)

    top = lut_at(y0, x0) * (1 - wx) + lut_at(y0, x1) * wx
    bot = lut_at(y1, x0) * (1 - wx) + lut_at(y1, x1) * wx
    return top * (1 - wy) + bot * wy
