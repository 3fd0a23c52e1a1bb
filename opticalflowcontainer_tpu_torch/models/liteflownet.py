"""LiteFlowNet (reference ``models/liteflownet.py``), NCHW.

A 6-level trunk (:class:`Features`: 32 channels at 7x7, then 32 / 64 / 96 /
128 / 192 at strides 2..32), then per level 6..2 three stages:

- :class:`Matching`: a 49-channel cost volume (K4: (3,1,1) at levels 4-6;
  at levels 2-3 the strided (6,2,2), upsampled by a 49-group deconv and
  cropped) of feat1 against feat2 warped by the upsampled flow (K3), and a
  flow residual head;
- :class:`Subpixel`: a residual head on [feat1, warped feat2, flow];
- :class:`Regularization`: feature-driven distance weights over the flow's
  k x k neighbourhood, the new flow their normalized weighted sum
  (``ops/unfold.py``).

Warps are the align-corners pixel warp.  A model cast to bfloat16 serves
in bf16 with the flow kept fp32 (cast to bf16 where a convolution reads
it), K3 and K4 through :func:`~.common.in_fp32`.  The net's output is the
level-2 (half-resolution) flow x 20; :func:`estimate` implements the
resize-to-32 / resize-back / rescale contract.  Module and parameter names follow the
reference's flax names, which ``models/convert.py`` relies on.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.resize import resize_bilinear
from ..core.warp import warp_align_corners
from ..ops.correlation import local_correlation
from ..ops.unfold import neighbourhood_sum
from .common import AxisConv, Conv, Deconv, estimate_resized, in_fp32, leaky

# per-level constants, indexed by pyramid level (2..6)
_FLOW_SCALE = {2: 10.0, 3: 5.0, 4: 2.5, 5: 1.25, 6: 0.625}
_HEAD_K = {2: 7, 3: 5, 4: 5, 5: 3, 6: 3}
# trunk channels at levels 1..6
FEATURE_CH = (32, 32, 64, 96, 128, 192)
# fixed BGR means subtracted from the two frames (reference :30-31)
_MEAN_ONE = (0.411618, 0.434631, 0.454253)
_MEAN_TWO = (0.410782, 0.433645, 0.452793)
_CORR_CH = 49


class Features(nn.Module):
    """The 6-level trunk, shared with LiteFlowNet3: [l1, ..., l6]."""

    def __init__(self):
        super().__init__()
        self.conv1 = Conv(3, 32, kernel=7)
        self.conv2a = Conv(32, 32, stride=2)
        self.conv2b = Conv(32, 32)
        self.conv2c = Conv(32, 32)
        self.conv3a = Conv(32, 64, stride=2)
        self.conv3b = Conv(64, 64)
        self.conv4a = Conv(64, 96, stride=2)
        self.conv4b = Conv(96, 96)
        self.conv5 = Conv(96, 128, stride=2)
        self.conv6 = Conv(128, 192, stride=2)

    def forward(self, x) -> list[torch.Tensor]:
        l1 = leaky(self.conv1(x))
        y = leaky(self.conv2a(l1))
        y = leaky(self.conv2b(y))
        l2 = leaky(self.conv2c(y))
        y = leaky(self.conv3a(l2))
        l3 = leaky(self.conv3b(y))
        y = leaky(self.conv4a(l3))
        l4 = leaky(self.conv4b(y))
        l5 = leaky(self.conv5(l4))
        l6 = leaky(self.conv6(l5))
        return [l1, l2, l3, l4, l5, l6]


class Matching(nn.Module):
    def __init__(self, level: int):
        super().__init__()
        self.level = level
        if level == 2:
            self.feat = Conv(FEATURE_CH[1], 64, kernel=1, padding=0)
        if level < 6:
            self.upflow = Deconv(2, 2, bias=False, groups=2)
        if level < 4:
            self.upcorr = Deconv(_CORR_CH, _CORR_CH, bias=False, groups=_CORR_CH)
        self.main0 = Conv(_CORR_CH, 128)
        self.main1 = Conv(128, 64)
        self.main2 = Conv(64, 32)
        self.head = Conv(32, 2, kernel=_HEAD_K[level])

    def forward(self, feat1, feat2, flow):
        lvl = self.level
        if lvl == 2:
            feat1 = leaky(self.feat(feat1))
            feat2 = leaky(self.feat(feat2))
        if flow is not None:
            flow = self.upflow(flow.to(feat1.dtype)).float()
            feat2 = in_fp32(warp_align_corners, feat2, flow * _FLOW_SCALE[lvl])
        if lvl >= 4:
            corr = leaky(in_fp32(local_correlation, feat1, feat2, 3))
        else:
            # fine levels: strided correlation, learned 49-group upsample
            corr = leaky(in_fp32(local_correlation, feat1, feat2, 6, 2, 2))
            corr = self.upcorr(corr)[..., :feat1.shape[2], :feat1.shape[3]]
        x = leaky(self.main0(corr))
        x = leaky(self.main1(x))
        x = leaky(self.main2(x))
        res = self.head(x).float()
        return res if flow is None else flow + res


class Subpixel(nn.Module):
    def __init__(self, level: int):
        super().__init__()
        self.level = level
        if level == 2:
            self.feat = Conv(FEATURE_CH[1], 64, kernel=1, padding=0)
        # level 2's 1x1 feat conv widens its 32 channels to 64
        fch = 64 if level == 2 else FEATURE_CH[level - 1]
        self.main0 = Conv(2 * fch + 2, 128)
        self.main1 = Conv(128, 64)
        self.main2 = Conv(64, 32)
        self.head = Conv(32, 2, kernel=_HEAD_K[level])

    def forward(self, feat1, feat2, flow):
        lvl = self.level
        if lvl == 2:
            feat1 = leaky(self.feat(feat1))
            feat2 = leaky(self.feat(feat2))
        warped = in_fp32(warp_align_corners, feat2, flow * _FLOW_SCALE[lvl])
        x = torch.cat([feat1, warped, flow.to(feat1.dtype)], 1)
        x = leaky(self.main0(x))
        x = leaky(self.main1(x))
        x = leaky(self.main2(x))
        return flow + self.head(x).float()


class Regularization(nn.Module):
    """The distance-weighted local average of the flow.  Below level 5 a
    1x1 conv narrows feat1 to 128 channels and the distance conv splits into
    k x 1 then 1 x k.  ``warp`` is the net's warp convention."""

    def __init__(self, level: int, warp=warp_align_corners):
        super().__init__()
        self.level = level
        self.warp = warp
        k = _HEAD_K[level]
        fch = FEATURE_CH[level - 1]
        if level < 5:
            self.feat = Conv(fch, 128, kernel=1, padding=0)
            fch = 128
        cin = 3 + fch
        for i, ch in enumerate((128, 128, 64, 64, 32, 32)):
            self.add_module(f"main{i}", Conv(cin, ch))
            cin = ch
        if level >= 5:
            self.dist = Conv(32, k * k, kernel=k)
        else:
            self.dist_v = AxisConv(32, k * k, (k, 1))
            self.dist_h = AxisConv(k * k, k * k, (1, k))
        self.scale_x = Conv(k * k, 1, kernel=1, padding=0)
        self.scale_y = Conv(k * k, 1, kernel=1, padding=0)

    def features(self, img1, img2, feat1, flow) -> torch.Tensor:
        """The output of the last ``main`` conv, which the distance (and in
        LFN3 the confidence) heads read.  The photometric difference passes
        no gradient, as the reference's ``stop_gradient``."""
        with torch.no_grad():
            warped = in_fp32(self.warp, img2, flow * _FLOW_SCALE[self.level])
            diff = ((img1 - warped) ** 2).sum(1, keepdim=True).sqrt()
        if self.level < 5:
            feat1 = leaky(self.feat(feat1))
        # the flow's mean over each image's pixels, never over the batch
        centred = (flow - flow.mean((2, 3), keepdim=True)).to(feat1.dtype)
        x = torch.cat([diff, centred, feat1], 1)
        for i in range(6):
            x = leaky(getattr(self, f"main{i}")(x))
        return x

    def smooth(self, x, flow) -> torch.Tensor:
        """The new flow (fp32) from the ``main`` features ``x``: softmax
        weights of -dist^2 over the k x k taps, through ``scale_x`` /
        ``scale_y`` (bias added before the normalization, as the reference's
        1x1 conv)."""
        if self.level >= 5:
            dist = self.dist(x)
        else:
            dist = self.dist_h(self.dist_v(x))
        dist = -(dist ** 2)
        dist = torch.exp(dist - dist.amax(1, keepdim=True))
        divisor = 1.0 / dist.sum(1, keepdim=True)
        taps = torch.cat([self.scale_x.weight.reshape(1, -1),
                          self.scale_y.weight.reshape(1, -1)])
        bias = torch.cat([self.scale_x.bias, self.scale_y.bias])
        return (neighbourhood_sum(flow, dist, taps, bias) * divisor).float()

    def forward(self, img1, img2, feat1, flow):
        return self.smooth(self.features(img1, img2, feat1, flow), flow)


def image_pyramid(img: torch.Tensor, feats: list[torch.Tensor]) -> list[torch.Tensor]:
    """``img`` resized to each feature level's size, level 1 being ``img``."""
    out = [img]
    for f in feats[1:]:
        out.append(resize_bilinear(out[-1], tuple(f.shape[-2:])))
    return out


class LiteFlowNet(nn.Module):
    """(img1, img2) [B, 3, H, W] BGR in [0, 1], H and W multiples of 32 ->
    flow [B, 2, H/2, W/2] x 20 (level-2 resolution), and with
    ``return_pyramid`` the per-level flows."""

    def __init__(self):
        super().__init__()
        # on the model's device, so that a call uploads nothing; not in the
        # state dict, which holds the checkpoint's arrays only
        self.register_buffer("mean_one", torch.tensor(_MEAN_ONE).reshape(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("mean_two", torch.tensor(_MEAN_TWO).reshape(1, 3, 1, 1),
                             persistent=False)
        self.features = Features()
        for level in (6, 5, 4, 3, 2):
            self.add_module(f"matching{level}", Matching(level))
            self.add_module(f"subpixel{level}", Subpixel(level))
            self.add_module(f"regularization{level}", Regularization(level))

    def forward(self, img1, img2, return_pyramid: bool = False):
        """``return_pyramid=True`` also returns the flow of each level
        {6: ..., 2: ...} in the net's /20 units at the level's own
        resolution (the reference's training supervision)."""
        img1 = img1 - self.mean_one
        img2 = img2 - self.mean_two
        B = img1.shape[0]
        # both frames through the trunk in one batch
        feats = self.features(torch.cat([img1, img2], 0))
        feats1 = [f[:B] for f in feats]
        feats2 = [f[B:] for f in feats]
        im1 = image_pyramid(img1, feats1)
        im2 = image_pyramid(img2, feats2)
        flow = None
        pyramid = {}
        for lvl in (6, 5, 4, 3, 2):
            i = lvl - 1
            flow = getattr(self, f"matching{lvl}")(feats1[i], feats2[i], flow)
            flow = getattr(self, f"subpixel{lvl}")(feats1[i], feats2[i], flow)
            flow = getattr(self, f"regularization{lvl}")(im1[i], im2[i],
                                                         feats1[i], flow)
            pyramid[lvl] = flow
        return (flow * 20.0, pyramid) if return_pyramid else flow * 20.0


@torch.inference_mode()
def estimate(model: LiteFlowNet, img1, img2) -> torch.Tensor:
    """The reference's estimate contract: ``img1``, ``img2`` [H, W, 3] or
    [B, H, W, 3] BGR in [0, 1] (numpy or tensor) are resized to multiples of
    32, run through the net, and the half-resolution flow is resized back to
    H x W with u and v rescaled by W/Wp and H/Hp.  Returns the flow
    [(B,) H, W, 2] on the model's device."""
    return estimate_resized(model, img1, img2, 32)
