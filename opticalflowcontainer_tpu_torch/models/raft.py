"""RAFT (reference ``models/raft.py``), NCHW: an all-pairs correlation
volume and ConvGRU refinement.

- :class:`RAFTSmall`: bottleneck feature encoder (32/32/64/96 -> 128 at 1/8,
  InstanceNorm), context encoder (-> 96 hidden + 64 context), a 4-level
  correlation pyramid with a radius-3 lookup, the small motion encoder and
  a ConvGRU(96), bilinear 8x flow upsampling; 12 iterations.
- :class:`RAFT` (large): residual encoders -> 256 at 1/8, hidden and context
  128 each, a radius-4 lookup, a SepConvGRU(128), the learned convex 8x
  upsampling; 12 iterations.

The volume is one batched product and the lookup one launch a step of K6
on the card (``ops/allpairs.py``, a stage the reference leaves to XLA; no
Pallas kernel is on this path in the reference, so none of K1-K5 is
either).  InstanceNorm statistics are
fp32 and per image (both frames run the feature encoder as one batch of
2B); the flow, the volume and its lookup stay fp32.  A model served in
fp32 runs its convolutions in fp32 on the card too, their algorithms
chosen by timing (:func:`~.common.fp32_convolutions` around the forward):
on an H100, TF32 convolutions moved the 12-step flow of seeded weights by
2-3% of its RMS (PERF.md, "Findings"), where PWC-Net and the LiteFlowNets
stay within their bars with TF32.  A model cast to bfloat16
(:func:`~.common.cast_params`) runs its convolutions in bf16; the guard
then only chooses their algorithms by timing.  Module names follow
the reference's flax names, which ``models/convert.py`` relies on.
:func:`estimate` implements the resize-to-a-multiple-of-8 contract.
The forward records the spans ``ofc.raft.encode``, ``ofc.raft.volume``,
``ofc.raft.update`` (one an iteration; ``ofc.raft.lookup`` is the
lookup's own) and ``ofc.raft.upsample`` (``core/spans.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core import spans
from ..core.resize import resize_bilinear
from ..ops.allpairs import all_pairs_correlation, corr_pyramid, lookup_packed, pack_pyramid
from .common import AxisConv, Conv, estimate_resized, fp32_convolutions, upsample_convex


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d without affine parameters: per image and channel,
    biased variance, statistics in fp32."""
    return F.instance_norm(x.float(), eps=eps).to(x.dtype)


class BottleneckBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        f4 = features // 4
        self.conv1 = Conv(cin, f4, kernel=1, padding=0)
        self.conv2 = Conv(f4, f4, kernel=3, stride=stride)
        self.conv3 = Conv(f4, features, kernel=1, padding=0)
        if stride != 1 or cin != features:
            self.down = Conv(cin, features, kernel=1, padding=0, stride=stride)

    def forward(self, x):
        y = F.relu(instance_norm(self.conv1(x)))
        y = F.relu(instance_norm(self.conv2(y)))
        y = F.relu(instance_norm(self.conv3(y)))
        if hasattr(self, "down"):
            x = instance_norm(self.down(x))
        return F.relu(x + y)


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv(cin, features, stride=stride)
        self.conv2 = Conv(features, features)
        if stride != 1 or cin != features:
            self.down = Conv(cin, features, kernel=1, padding=0, stride=stride)

    def forward(self, x):
        y = F.relu(instance_norm(self.conv1(x)))
        y = F.relu(instance_norm(self.conv2(y)))
        if hasattr(self, "down"):
            x = instance_norm(self.down(x))
        return F.relu(x + y)


class Encoder(nn.Module):
    """The 1/8-resolution trunk: a 7x7/2 stem, three pairs of blocks at
    strides 1, 2, 2, and a 1x1 projection."""

    def __init__(self, layers: tuple[int, ...], out_features: int, block: str):
        super().__init__()
        Block = BottleneckBlock if block == "bottleneck" else ResidualBlock
        self.stem = Conv(3, layers[0], kernel=7, stride=2)
        cin = layers[0]
        for i, (ch, s) in enumerate(zip(layers[1:], (1, 2, 2))):
            self.add_module(f"block{i}a", Block(cin, ch, stride=s))
            self.add_module(f"block{i}b", Block(ch, ch))
            cin = ch
        self.proj = Conv(cin, out_features, kernel=1, padding=0)

    def forward(self, x):
        y = F.relu(instance_norm(self.stem(x)))
        for i in range(3):
            y = getattr(self, f"block{i}a")(y)
            y = getattr(self, f"block{i}b")(y)
        return self.proj(y)


class ConvGRU(nn.Module):
    def __init__(self, hidden: int, cin: int):
        super().__init__()
        self.convz = Conv(hidden + cin, hidden)
        self.convr = Conv(hidden + cin, hidden)
        self.convq = Conv(hidden + cin, hidden)

    def forward(self, h, x):
        hx = torch.cat([h, x], 1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], 1)))
        return (1.0 - z) * h + z * q


class SepConvGRU(nn.Module):
    """A horizontal (1x5) then a vertical (5x1) GRU update; bare flax convs
    (``convz_h`` ...), hence :class:`AxisConv`."""

    def __init__(self, hidden: int, cin: int):
        super().__init__()
        for suffix, k in (("h", (1, 5)), ("v", (5, 1))):
            for gate in ("z", "r", "q"):
                self.add_module(f"conv{gate}_{suffix}",
                                AxisConv(hidden + cin, hidden, k))

    def forward(self, h, x):
        for suffix in ("h", "v"):
            hx = torch.cat([h, x], 1)
            z = torch.sigmoid(getattr(self, f"convz_{suffix}")(hx))
            r = torch.sigmoid(getattr(self, f"convr_{suffix}")(hx))
            q = torch.tanh(getattr(self, f"convq_{suffix}")(torch.cat([r * h, x], 1)))
            h = (1.0 - z) * h + z * q
        return h


class SmallMotionEncoder(nn.Module):
    def __init__(self, corr_channels: int):
        super().__init__()
        self.convc1 = Conv(corr_channels, 96, kernel=1, padding=0)
        self.convf1 = Conv(2, 64, kernel=7)
        self.convf2 = Conv(64, 32)
        self.conv = Conv(96 + 32, 80)

    def forward(self, flow, corr):
        flow = flow.to(corr.dtype)
        c = F.relu(self.convc1(corr))
        f = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([c, f], 1)))
        return torch.cat([out, flow], 1)  # 82


class MotionEncoder(nn.Module):
    def __init__(self, corr_channels: int):
        super().__init__()
        self.convc1 = Conv(corr_channels, 256, kernel=1, padding=0)
        self.convc2 = Conv(256, 192)
        self.convf1 = Conv(2, 128, kernel=7)
        self.convf2 = Conv(128, 64)
        self.conv = Conv(192 + 64, 126)

    def forward(self, flow, corr):
        flow = flow.to(corr.dtype)
        c = F.relu(self.convc2(F.relu(self.convc1(corr))))
        f = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([c, f], 1)))
        return torch.cat([out, flow], 1)  # 128


class FlowHead(nn.Module):
    def __init__(self, cin: int, mid: int):
        super().__init__()
        self.conv1 = Conv(cin, mid)
        self.conv2 = Conv(mid, 2)

    def forward(self, h):
        return self.conv2(F.relu(self.conv1(h)))


class _RAFTBase(nn.Module):
    """(img1, img2) [B, 3, H, W] in [0, 1], H and W multiples of 8 -> the
    stack of per-iteration flows [iters, B, 2, H, W], or with
    ``final_only=True`` (the inference contract) only the last one."""

    small: bool
    corr_radius: int
    corr_levels = 4
    iters = 12

    def __init__(self):
        super().__init__()
        corr_ch = self.corr_levels * (2 * self.corr_radius + 1) ** 2
        if self.small:
            self.fnet = Encoder((32, 32, 64, 96), 128, "bottleneck")
            self.cnet = Encoder((32, 32, 64, 96), 160, "bottleneck")
            self.hidden, self.context = 96, 64
            self.motion = SmallMotionEncoder(corr_ch)
            self.gru = ConvGRU(self.hidden, self.context + 82)
            self.head = FlowHead(self.hidden, 128)
        else:
            self.fnet = Encoder((64, 64, 96, 128), 256, "residual")
            self.cnet = Encoder((64, 64, 96, 128), 256, "residual")
            self.hidden, self.context = 128, 128
            self.motion = MotionEncoder(corr_ch)
            self.gru = SepConvGRU(self.hidden, self.context + 128)
            self.head = FlowHead(self.hidden, 256)
            self.mask1 = Conv(self.hidden, 256)
            self.mask2 = Conv(256, 64 * 9, kernel=1, padding=0)

    def _upsample(self, flow, h):
        with spans.annotate(spans.RAFT_UPSAMPLE):
            if self.small:
                # half-pixel bilinear x8, displacements x8
                H, W = flow.shape[-2:]
                return resize_bilinear(flow, (8 * H, 8 * W)) * 8.0
            # the learned convex combination, its mask scaled by 0.25
            return upsample_convex(flow, self.mask2(F.relu(self.mask1(h))) * 0.25)

    def forward(self, img1, img2, iters: int | None = None,
                final_only: bool = False):
        with fp32_convolutions():
            return self._forward(img1, img2, iters, final_only)

    def _forward(self, img1, img2, iters, final_only):
        # an explicit iters=0 stays 0
        iters = self.iters if iters is None else iters
        B = img1.shape[0]
        with spans.annotate(spans.RAFT_ENCODE):
            img1 = img1 * 2.0 - 1.0
            img2 = img2 * 2.0 - 1.0
            # both frames through the feature encoder as one batch
            f12 = self.fnet(torch.cat([img1, img2], 0))
            f1, f2 = f12[:B], f12[B:]
            c = self.cnet(img1)
            h = torch.tanh(c[:, :self.hidden])
            ctx = F.relu(c[:, self.hidden:])
        with spans.annotate(spans.RAFT_VOLUME):
            packed = pack_pyramid(corr_pyramid(all_pairs_correlation(f1, f2),
                                               self.corr_levels))
        flow = torch.zeros((B, 2) + f1.shape[-2:], dtype=torch.float32,
                           device=f1.device)
        if final_only and iters < 1:
            # no refinement: the zero flow upsampled
            return self._upsample(flow, h)
        flows = []
        for it in range(iters):
            corr = lookup_packed(packed, flow, self.corr_radius).to(f1.dtype)
            with spans.annotate(spans.RAFT_UPDATE):
                m = self.motion(flow, corr)
                # [context, motion]: the reference's (and torchvision's) order
                h = self.gru(h, torch.cat([ctx, m], 1))
                flow = flow + self.head(h).float()
            if not final_only or it == iters - 1:
                flows.append(self._upsample(flow, h))
        if final_only:
            return flows[-1]
        return torch.stack(flows)


class RAFTSmall(_RAFTBase):
    small = True
    corr_radius = 3


class RAFT(_RAFTBase):
    small = False
    corr_radius = 4


@torch.inference_mode()
def estimate(model: _RAFTBase, img1, img2, iters: int = 12) -> torch.Tensor:
    """The reference's estimate contract: ``img1``, ``img2`` [H, W, 3] or
    [B, H, W, 3] in [0, 1] (numpy or tensor) are resized to multiples of 8,
    run through ``iters`` refinements (only the last flow upsampled), and
    the flow is resized back to H x W with u and v rescaled by W/Wp and
    H/Hp.  Returns the flow [(B,) H, W, 2] on the model's device."""
    return estimate_resized(model, img1, img2, 8, iters=iters, final_only=True)
