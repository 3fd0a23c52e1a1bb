"""LiteFlowNet3 (reference ``models/liteflownet3.py``), NCHW.

LiteFlowNet's trunk (:class:`~.liteflownet.Features`) and its three stages
per level, over levels 6..3 only, with what defines LFN3:

- confidence maps: Regularization at levels 5 and 4 emits a sigmoid
  confidence; Matching at levels 4 and 3 upsamples it (``upconf``), reads
  it beside a dilated self-correlation of feat1 (K4 (6,2,1) at level 4,
  (8,2,1) at level 3) into ``conf`` / ``disp`` heads;
- flow-field deformation: the upsampled flow is itself warped by the
  ``disp`` map (K3 on the 2-channel flow);
- the cross-correlation (K4 (4,1,1)) modulated by learned per-channel
  ``corr_scalar`` / ``corr_offset`` maps before the flow head;
- the half-pixel warp convention and a per-image mean subtracted from each
  frame.

bf16 serving as LiteFlowNet's: the flow fp32, K3 and K4 through
:func:`~.common.in_fp32`.

The net's output is the level-3 (quarter-resolution) flow x 20;
:func:`estimate` implements the resize-to-32 / resize-back / rescale
contract.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.warp import warp_half_pixel
from ..ops.correlation import local_correlation
from .common import Conv, Deconv, estimate_resized, in_fp32, leaky
from .liteflownet import _FLOW_SCALE, _HEAD_K, FEATURE_CH, Features, image_pyramid
from .liteflownet import Regularization as _Regularization

# self-correlation max displacement at levels 4 and 3 (disp_stride 2)
_AUTO_DISP = {3: 8, 4: 6}
_CORR_CH = 81
_MAIN_CH = (128, 128, 96, 64, 32)


class Matching(nn.Module):
    def __init__(self, level: int):
        super().__init__()
        self.level = level
        fch = FEATURE_CH[level - 1]
        if level <= 4:
            self.upconf = Deconv(1, 1, bias=False)
            auto_ch = (2 * (_AUTO_DISP[level] // 2) + 1) ** 2
            self.conf0 = Conv(auto_ch + 1, 128)
            self.conf1 = Conv(128, 64)
            self.conf2 = Conv(64, 32)
            self.conf_head = Conv(32, 1, kernel=5)
            self.disp_head = Conv(32, 2, kernel=5)
            self.corr0 = Conv(fch + _CORR_CH + 1, 128)
            self.corr1 = Conv(128, 64)
            self.corr_scalar0 = Conv(64, 32)
            self.corr_scalar1 = Conv(32, _CORR_CH, kernel=1, padding=0)
            self.corr_offset0 = Conv(64, 32)
            self.corr_offset1 = Conv(32, _CORR_CH, kernel=1, padding=0)
        if level < 6:
            self.upflow = Deconv(2, 2, bias=False, groups=2)
        cin = _CORR_CH
        for i, ch in enumerate(_MAIN_CH):
            self.add_module(f"main{i}", Conv(cin, ch))
            cin = ch
        self.head = Conv(32, 2, kernel=_HEAD_K[level])

    def forward(self, feat1, feat2, flow, conf):
        lvl = self.level
        if lvl <= 4:
            conf = self.upconf(conf)
            auto = leaky(in_fp32(local_correlation, feat1, feat1, _AUTO_DISP[lvl], 2))
            x = leaky(self.conf0(torch.cat([auto, conf], 1)))
            x = leaky(self.conf1(x))
            cf = leaky(self.conf2(x))
            conf = torch.sigmoid(self.conf_head(cf))
            disp = self.disp_head(cf)
        if flow is not None:
            flow = self.upflow(flow.to(feat1.dtype)).float()
            if lvl <= 4:
                # flow-field deformation: warp the flow field by the disp map
                flow = warp_half_pixel(flow, disp)
            feat2 = in_fp32(warp_half_pixel, feat2, flow * _FLOW_SCALE[lvl])
        corr = leaky(in_fp32(local_correlation, feat1, feat2, 4))
        if lvl <= 4:
            cfeat = leaky(self.corr0(torch.cat([feat1, corr, conf], 1)))
            cfeat = leaky(self.corr1(cfeat))
            scalar = self.corr_scalar1(leaky(self.corr_scalar0(cfeat)))
            offset = self.corr_offset1(leaky(self.corr_offset0(cfeat)))
            corr = scalar * corr + offset
        x = corr
        for i in range(len(_MAIN_CH)):
            x = leaky(getattr(self, f"main{i}")(x))
        res = self.head(x).float()
        return (res if flow is None else flow + res), conf


class Subpixel(nn.Module):
    def __init__(self, level: int):
        super().__init__()
        self.level = level
        cin = 2 * FEATURE_CH[level - 1] + 2
        for i, ch in enumerate(_MAIN_CH):
            self.add_module(f"main{i}", Conv(cin, ch))
            cin = ch
        self.head = Conv(32, 2, kernel=_HEAD_K[level])

    def forward(self, feat1, feat2, flow):
        warped = in_fp32(warp_half_pixel, feat2, flow * _FLOW_SCALE[self.level])
        x = torch.cat([feat1, warped, flow.to(feat1.dtype)], 1)
        for i in range(len(_MAIN_CH)):
            x = leaky(getattr(self, f"main{i}")(x))
        return flow + self.head(x).float()


class Regularization(_Regularization):
    """LiteFlowNet's Regularization with the half-pixel warp, and at levels
    4 and 5 a sigmoid confidence head on the ``main`` features."""

    def __init__(self, level: int):
        super().__init__(level, warp=warp_half_pixel)
        if level in (4, 5):
            self.conf_head = Conv(32, 1, kernel=5 if level == 4 else 3)

    def forward(self, img1, img2, feat1, flow):
        x = self.features(img1, img2, feat1, flow)
        conf = (torch.sigmoid(self.conf_head(x)) if self.level in (4, 5)
                else None)
        return self.smooth(x, flow), conf


class LiteFlowNet3(nn.Module):
    """(img1, img2) [B, 3, H, W] BGR in [0, 1], H and W multiples of 32 ->
    flow [B, 2, H/4, W/4] x 20 (level-3 resolution), and with
    ``return_pyramid`` the per-level flows."""

    def __init__(self):
        super().__init__()
        self.features = Features()
        for level in (6, 5, 4, 3):
            self.add_module(f"matching{level}", Matching(level))
            self.add_module(f"subpixel{level}", Subpixel(level))
            self.add_module(f"regularization{level}", Regularization(level))

    def forward(self, img1, img2, return_pyramid: bool = False):
        """``return_pyramid=True`` also returns the flow of each level
        {6: ..., 3: ...} in the net's /20 units at the level's own
        resolution (the reference's training supervision)."""
        # each image's own mean over its pixels, never over the batch
        img1 = img1 - img1.mean((2, 3), keepdim=True)
        img2 = img2 - img2.mean((2, 3), keepdim=True)
        B = img1.shape[0]
        feats = self.features(torch.cat([img1, img2], 0))
        feats1 = [f[:B] for f in feats]
        feats2 = [f[B:] for f in feats]
        im1 = image_pyramid(img1, feats1)
        im2 = image_pyramid(img2, feats2)
        flow = conf = None
        pyramid = {}
        for lvl in (6, 5, 4, 3):
            i = lvl - 1
            flow, conf = getattr(self, f"matching{lvl}")(feats1[i], feats2[i],
                                                         flow, conf)
            flow = getattr(self, f"subpixel{lvl}")(feats1[i], feats2[i], flow)
            flow, rconf = getattr(self, f"regularization{lvl}")(
                im1[i], im2[i], feats1[i], flow)
            if rconf is not None:
                conf = rconf
            pyramid[lvl] = flow
        return (flow * 20.0, pyramid) if return_pyramid else flow * 20.0


@torch.inference_mode()
def estimate(model: LiteFlowNet3, img1, img2) -> torch.Tensor:
    """The reference's estimate contract: ``img1``, ``img2`` [H, W, 3] or
    [B, H, W, 3] BGR in [0, 1] (numpy or tensor) are resized to multiples of
    32, run through the net, and the quarter-resolution flow is resized
    back to H x W with u and v rescaled by W/Wp and H/Hp.  Returns the flow
    [(B,) H, W, 2] on the model's device."""
    return estimate_resized(model, img1, img2, 32)
