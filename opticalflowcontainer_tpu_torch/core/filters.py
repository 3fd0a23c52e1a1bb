"""cv2-parity separable filtering in plain PyTorch.

Counterpart of the reference's ``core/filters.py`` for what the Farneback
path needs: OpenCV's ``getGaussianKernel`` and a separable correlation with
OpenCV's border modes.  Border conventions:

- ``BORDER_REFLECT_101`` == ``numpy.pad(mode="reflect")``  (GaussianBlur)
- ``BORDER_REPLICATE``   == ``numpy.pad(mode="edge")``     (inside the
  Farneback polynomial expansion and the winsize blur)

Filters take ``[..., H, W]`` float tensors.  The correlation is a sum of
scaled shifted slices, the same order of operations as the reference's CPU
form, in fp32 throughout (no convolution op, so no TF32 on the card).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

_BORDER_TO_NP = {"reflect101": "reflect", "replicate": "edge"}


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


@functools.lru_cache(maxsize=256)
def _pad_index(n: int, p: int, border: str, device: torch.device) -> torch.Tensor:
    """Source index of each padded position (numpy's pad modes, so any pad
    width behaves as the reference's ``jnp.pad``), kept on ``device``: an
    upload per call would synchronize the stream."""
    idx = np.pad(np.arange(n), p, mode=_BORDER_TO_NP[border])
    return torch.from_numpy(idx).to(device)


def _pad2d(img: torch.Tensor, ph: int, pw: int, border: str) -> torch.Tensor:
    """Pad the trailing two dims by (ph, pw) with an OpenCV border mode."""
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
