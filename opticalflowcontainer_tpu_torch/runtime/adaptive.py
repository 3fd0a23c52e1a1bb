"""Adaptive preprocessing + flow post-processing (the port's copy of the
reference's ``runtime/adaptive.py``, the reference system's adaptive node).

Preprocessing (before the flow backend):
- contrast-adaptive CLAHE: clip limit linearly interpolated from the frame's
  contrast (std/mean) between [clahe_min_clip, clahe_max_clip]
- optional bilateral filter

Flow post-processing (after the backend):
- median filter on each flow channel
- magnitude threshold (zero out |flow| below min / above max)
- intensity mask (ignore flow where the image is too dark)

Every step is a torch op on the backend's device; the clip limit stays a
device scalar, so a frame is uploaded once and nothing waits on the host.
A backend that offers ``flow_tensor`` (the port's Farneback and model
backends) takes the preprocessed frames and gives its flow on the device;
any other backend gets numpy frames and returns numpy flow, as the
node's backend contract says.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.device import device_scope, resolve_device
from ..core.filters import bilateral_filter, clahe, median_filter


@dataclasses.dataclass
class AdaptiveParams:
    use_clahe: bool = True
    clahe_min_clip: float = 1.0
    clahe_max_clip: float = 4.0
    contrast_low: float = 0.15   # std/mean at/below which max clip applies
    contrast_high: float = 0.5   # std/mean at/above which min clip applies
    clahe_grid: int = 8
    use_bilateral: bool = False
    bilateral_d: int = 5
    bilateral_sigma_color: float = 25.0
    bilateral_sigma_space: float = 5.0
    flow_median_ksize: int = 0        # 0 = off
    flow_min_mag: float = 0.0
    flow_max_mag: float = float("inf")
    intensity_mask_thresh: float = 0.0  # pixels darker than this get zero flow


class AdaptivePreprocessor:
    """The adaptive steps on ``device`` (the card unless ``"cpu"``)."""

    def __init__(self, params: AdaptiveParams | None = None, *, device=None):
        self.p = params or AdaptiveParams()
        self.device = resolve_device(device)

    def _tensor(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.float32)
        return torch.as_tensor(np.asarray(x, np.float32)).to(self.device)

    def preprocess(self, gray) -> torch.Tensor:
        """gray float [H, W] in 0..255 -> enhanced gray, on the device."""
        p = self.p
        out = self._tensor(gray)
        if p.use_clahe:
            mean = out.mean()
            std = out.std(correction=0)
            contrast = std / mean.clamp(min=1e-6)
            t = ((contrast - p.contrast_low)
                 / max(p.contrast_high - p.contrast_low, 1e-6)).clamp(0.0, 1.0)
            clip = p.clahe_max_clip + t * (p.clahe_min_clip - p.clahe_max_clip)
            H, W = out.shape
            Hc = (H // p.clahe_grid) * p.clahe_grid
            Wc = (W // p.clahe_grid) * p.clahe_grid
            if Hc and Wc:
                out = out.clone()
                out[:Hc, :Wc] = clahe(out[:Hc, :Wc], clip, p.clahe_grid)
        if p.use_bilateral:
            out = bilateral_filter(out, p.bilateral_d, p.bilateral_sigma_color,
                                   p.bilateral_sigma_space)
        return out

    def postprocess(self, flow, gray) -> torch.Tensor:
        """flow [H, W, 2] -> filtered and masked flow, on the device."""
        p = self.p
        out = self._tensor(flow)
        if p.flow_median_ksize >= 3:
            out = median_filter(out.permute(2, 0, 1), p.flow_median_ksize).permute(1, 2, 0)
        mag = torch.linalg.vector_norm(out, dim=-1)
        keep = (mag >= p.flow_min_mag) & (mag <= p.flow_max_mag)
        if p.intensity_mask_thresh > 0:
            keep &= self._tensor(gray) >= p.intensity_mask_thresh
        return out * keep[..., None]


def make_adaptive_backend(backend, params: AdaptiveParams | None = None, *,
                          device=None):
    """Wrap a flow backend with adaptive pre/post processing, on the
    backend's device (``backend.device``), else on ``device`` (the card
    unless ``"cpu"``).  Returns numpy flow, as every node backend does."""
    dev = getattr(backend, "device", None) if device is None else device
    proc = AdaptivePreprocessor(params, device=dev)
    flow_tensor = getattr(backend, "flow_tensor", None)
    last = [None, None]  # [frame ref, preprocessed] -- prev is last call's cur

    def wrapped(prev, cur, dt):
        with device_scope(proc.device):
            # streaming callers pass last call's cur as this call's prev:
            # reuse its preprocessed form instead of filtering twice per
            # frame (the kept reference makes the identity check safe
            # against id() reuse)
            prev_p = last[1] if last[0] is prev else proc.preprocess(prev)
            cur_t = proc._tensor(cur)
            cur_p = proc.preprocess(cur_t)
            last[0], last[1] = cur, cur_p
            if flow_tensor is not None:
                flow = flow_tensor(prev_p, cur_p, dt)
            else:
                flow = backend(prev_p.cpu().numpy(), cur_p.cpu().numpy(), dt)
            return proc.postprocess(flow, cur_t).cpu().numpy()

    return wrapped
