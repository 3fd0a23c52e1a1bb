"""PWC-Net (reference ``models/pwcnet.py``), NCHW.

A 6-level feature extractor (16/32/64/96/128/196 channels), coarse-to-fine
DenseNet-style decoders at levels 6..2 (81-channel local correlation, K4;
masked backwarp, K3; 4x4/s2 upflow and upfeat deconvs; per-level flow
scale), and a dilated context refiner (1, 2, 4, 8, 16, 1) added to the
level-2 flow, all scaled by 20.  A model cast to bfloat16 serves in bf16,
K3 and K4 through :func:`~.common.in_fp32`; its output flow is fp32, as
the reference's.  The net's output is at 1/4 of its input;
:func:`estimate` implements the resize-to-64 / resize-back / rescale
contract.  Module and parameter names follow the reference's flax names,
which ``models/convert.py`` relies on.

An fp32 model runs its convolutions in fp32
(:func:`~.common.fp32_convolutions`), as RAFT and NeuFlow do: on the
packaged weights cuDNN's TF32 convolutions moved the flow of the first
easy fishnet pair at 640x480 by 1.4e-2 px on average against fp32, over
the 1e-2 px the zoo's served flows are held to (PERF.md).
"""
from __future__ import annotations

import torch
from torch import nn

from ..core import spans
from ..core.warp import warp_with_mask
from ..ops.correlation import local_correlation
from .common import Conv, Deconv, estimate_resized, fp32_convolutions, in_fp32, leaky

_EXTRACTOR_CH = (16, 32, 64, 96, 128, 196)
_DENSE_CH = (128, 128, 96, 64, 32)
_FLOW_SCALE = {5: 0.625, 4: 1.25, 3: 2.5, 2: 5.0}
_REFINER = ((128, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1))
MAX_DISP = 4
_CORR_CH = (2 * MAX_DISP + 1) ** 2


def _decoder_in(level: int) -> int:
    """Channels into a decoder's dense block: the cost volume, plus below
    level 6 the level's features and the upsampled flow and features."""
    return _CORR_CH if level == 6 else _CORR_CH + _EXTRACTOR_CH[level - 1] + 4


def _decoder_out(level: int) -> int:
    return _decoder_in(level) + sum(_DENSE_CH)


class _Level(nn.Module):
    def __init__(self, in_ch: int, ch: int):
        super().__init__()
        self.conv0 = Conv(in_ch, ch, stride=2)
        self.conv1 = Conv(ch, ch)
        self.conv2 = Conv(ch, ch)

    def forward(self, x):
        x = leaky(self.conv0(x))
        x = leaky(self.conv1(x))
        return leaky(self.conv2(x))


class Extractor(nn.Module):
    def __init__(self):
        super().__init__()
        for i, (cin, ch) in enumerate(zip((3,) + _EXTRACTOR_CH, _EXTRACTOR_CH)):
            self.add_module(f"level{i + 1}", _Level(cin, ch))

    def forward(self, x) -> list[torch.Tensor]:
        feats = []
        for level in self.children():
            x = level(x)
            feats.append(x)
        return feats


class Decoder(nn.Module):
    def __init__(self, level: int):
        super().__init__()
        self.level = level
        if level < 6:
            self.upflow = Deconv(2, 2)
            self.upfeat = Deconv(_decoder_out(level + 1), 2)
        cin = _decoder_in(level)
        for i, ch in enumerate(_DENSE_CH):
            self.add_module(f"dense{i}", Conv(cin, ch))
            cin += ch
        self.predict = Conv(cin, 2)

    def forward(self, feat1, feat2, prev):
        if prev is None:
            feat = leaky(in_fp32(local_correlation, feat1, feat2, MAX_DISP))
        else:
            prev_flow, prev_feat = prev
            flow_up = self.upflow(prev_flow)
            feat_up = self.upfeat(prev_feat)
            warped = in_fp32(warp_with_mask, feat2, flow_up * _FLOW_SCALE[self.level])
            corr = leaky(in_fp32(local_correlation, feat1, warped, MAX_DISP))
            feat = torch.cat([corr, feat1, flow_up, feat_up], 1)
        for i in range(len(_DENSE_CH)):
            dense = getattr(self, f"dense{i}")
            feat = torch.cat([leaky(dense(feat)), feat], 1)
        return self.predict(feat), feat


class Refiner(nn.Module):
    def __init__(self):
        super().__init__()
        cin = _decoder_out(2)
        for i, (ch, d) in enumerate(_REFINER):
            self.add_module(f"conv{i}", Conv(cin, ch, dilation=d))
            cin = ch
        self.conv6 = Conv(cin, 2)

    def forward(self, x):
        for i in range(len(_REFINER)):
            x = leaky(getattr(self, f"conv{i}")(x))
        return self.conv6(x)


class PWCNet(nn.Module):
    """(img1, img2) [B, 3, H, W] in [0, 1], H and W multiples of 64 ->
    flow [B, 2, H/4, W/4] in full-resolution pixels (and with
    ``return_pyramid`` the per-level flows)."""

    def __init__(self):
        super().__init__()
        self.extractor = Extractor()
        for level in (6, 5, 4, 3, 2):
            self.add_module(f"decoder{level}", Decoder(level))
        self.refiner = Refiner()

    def forward(self, img1, img2, return_pyramid: bool = False):
        """``return_pyramid=True`` also returns the flow of each level
        {6: ..., 2: ...} in the net's /20 units at the level's own
        resolution, level 2 after the refiner (the reference's training
        supervision)."""
        with fp32_convolutions():
            return self._forward(img1, img2, return_pyramid)

    def _forward(self, img1, img2, return_pyramid):
        B = img1.shape[0]
        with spans.annotate(spans.PWCNET_EXTRACTOR):
            # both frames through the extractor in one batch
            feats = self.extractor(torch.cat([img1, img2], 0))
        prev = None
        pyramid = {}
        for level in (6, 5, 4, 3, 2):
            f = feats[level - 1]
            with spans.annotate(spans.PWCNET_DECODER[level]):
                prev = getattr(self, f"decoder{level}")(f[:B], f[B:], prev)
            pyramid[level] = prev[0]
        flow, feat = prev
        with spans.annotate(spans.PWCNET_REFINER):
            pyramid[2] = flow.float() + self.refiner(feat).float()
            out = pyramid[2] * 20.0
        return (out, pyramid) if return_pyramid else out


@torch.inference_mode()
def estimate(model: PWCNet, img1, img2) -> torch.Tensor:
    """The reference's estimate contract: ``img1``, ``img2`` [H, W, 3] or
    [B, H, W, 3] in [0, 1] (numpy or tensor) are resized to multiples of 64,
    run through the net, and the quarter-resolution flow is resized back to
    H x W with u and v rescaled by W/Wp and H/Hp.  Returns the flow
    [(B,) H, W, 2] on the model's device."""
    return estimate_resized(model, img1, img2, 64)
