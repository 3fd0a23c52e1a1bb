"""NeuFlowLite (reference ``models/neuflow.py``), NCHW: global matching at
1/16 and cheap local refinement at 1/8.

- a 4-stage trunk (:class:`_Down`: conv/2 - InstanceNorm - leaky, then conv
  - InstanceNorm - leaky) to 16 / 32 / 64 / 96 channels at 1/2 .. 1/16;
- global matching at 1/16: 1x1 projections normalised to unit length, the
  all-pairs cosine similarity times a learned temperature, a softmax in
  fp32 over all target positions and its expectation (soft-argmax) minus
  the source position, times a learned gate;
- ``iters`` refinement steps at 1/8: f2 warped by the flow (K3), the
  radius-4 local correlation with f1 (K4, 81 channels), three convs to a
  flow residual;
- bilinear 8x upsampling.

The flow stays fp32; a model cast to bfloat16 runs its convolutions in bf16
and reaches K3 and K4 through :func:`~.common.in_fp32`.  The convolutions
of a model served in fp32 run in fp32 (:func:`~.common.fp32_convolutions`),
as RAFT's: the matching softmax and the recurrence carry rounding forward.
Module and parameter names follow the reference's flax names, which
``models/convert.py`` relies on.  :func:`estimate` implements the
resize-to-a-multiple-of-16 contract.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..core.resize import resize_bilinear
from ..core.warp import warp_bilinear
from ..ops.allpairs import all_pairs_correlation
from ..ops.correlation import local_correlation
from .common import Conv, estimate_resized, fp32_convolutions, in_fp32, leaky
from .raft import instance_norm

_TRUNK_CH = (16, 32, 64, 96)
MAX_DISP = 4
_CORR_CH = (2 * MAX_DISP + 1) ** 2


class _Down(nn.Module):
    """conv/2 - InstanceNorm - leaky, conv - InstanceNorm - leaky."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv0 = Conv(cin, features, stride=2)
        self.conv1 = Conv(features, features)

    def forward(self, x):
        x = leaky(instance_norm(self.conv0(x)))
        return leaky(instance_norm(self.conv1(x)))


def _unit(x: torch.Tensor) -> torch.Tensor:
    """``x`` [B, C, H, W] over the square root of its squared norm over C
    plus 1e-6."""
    return x * torch.rsqrt((x * x).sum(1, keepdim=True) + 1e-6)


class NeuFlowLite(nn.Module):
    """(img1, img2) [B, 3, H, W] in [0, 1], H and W multiples of 16 ->
    flow [B, 2, H, W] fp32 in pixels."""

    def __init__(self, iters: int = 2):
        super().__init__()
        self.iters = iters
        cin = 3
        for i, ch in enumerate(_TRUNK_CH):
            self.add_module(f"down{i + 1}", _Down(cin, ch))
            cin = ch
        self.proj1 = Conv(96, 96, kernel=1, padding=0)
        self.proj2 = Conv(96, 96, kernel=1, padding=0)
        self.match_temp = nn.Parameter(torch.empty(1))
        self.matching_gate = nn.Parameter(torch.empty(1))
        self.init_constants()
        self.ref0 = Conv(_CORR_CH + 64 + 2, 96)
        self.ref1 = Conv(96, 64)
        self.ref2 = Conv(64, 2)

    @torch.no_grad()
    def init_constants(self) -> list[nn.Parameter]:
        """The flax init of the matching constants: temperature 10, gate 0
        (training phases the matching in).  Returns them."""
        self.match_temp.fill_(10.0)
        self.matching_gate.zero_()
        return [self.match_temp, self.matching_gate]

    def features(self, x: torch.Tensor) -> list[torch.Tensor]:
        """The trunk's four stages of ``x`` in [0, 1]."""
        x = x * 2.0 - 1.0
        feats = []
        for i in range(len(_TRUNK_CH)):
            x = getattr(self, f"down{i + 1}")(x)
            feats.append(x)
        return feats

    def matching(self, g1: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
        """The gated soft-argmax flow [B, 2, h, w] (fp32, in 1/16 cells) of
        the 1/16 features ``g1``, ``g2`` [B, 96, h, w]."""
        g1, g2 = _unit(self.proj1(g1)), _unit(self.proj2(g2))
        B, C, h, w = g1.shape
        # the volume is scaled by 1/sqrt(C): undo it for the cosine
        vol = all_pairs_correlation(g1, g2).reshape(B, h * w, h * w) * math.sqrt(C)
        att = torch.softmax(vol.float() * self.match_temp.float(), -1)
        idx = torch.arange(h * w, dtype=torch.float32, device=g1.device)
        target = torch.stack([idx % w, idx // w], -1)  # (x, y) of each target
        expect = att @ target  # [B, h*w, 2]
        flow = (expect - target).transpose(1, 2).reshape(B, 2, h, w)
        return flow * self.matching_gate.float()

    def refine(self, f1: torch.Tensor, f2: torch.Tensor,
               flow: torch.Tensor) -> torch.Tensor:
        """One refinement step at 1/8: the flow (fp32) plus the residual
        read from the local correlation of f1 and the warped f2."""
        warped = in_fp32(warp_bilinear, f2, flow)
        corr = leaky(in_fp32(local_correlation, f1, warped, MAX_DISP))
        x = torch.cat([corr, f1, flow.to(f1.dtype)], 1)
        x = leaky(self.ref0(x))
        x = leaky(self.ref1(x))
        return flow + self.ref2(x).float()

    def forward(self, img1, img2, return_aux: bool = False):
        """``return_aux=True`` also returns the matching stage's flow
        before refinement, upsampled to the input's size in pixels (the
        reference's auxiliary training target)."""
        with fp32_convolutions():
            B = img1.shape[0]
            # both frames through the trunk as one batch (norms per image)
            feats = self.features(torch.cat([img1, img2], 0))
            f8, f16 = feats[2], feats[3]
            flow16 = self.matching(f16[:B], f16[B:])
            flow = resize_bilinear(flow16, tuple(f8.shape[-2:])) * 2.0
            for _ in range(self.iters):
                flow = self.refine(f8[:B], f8[B:], flow)
            size = tuple(img1.shape[-2:])
            out = resize_bilinear(flow, size) * 8.0
            if return_aux:
                return out, resize_bilinear(flow16, size) * 16.0
            return out


@torch.inference_mode()
def estimate(model: NeuFlowLite, img1, img2) -> torch.Tensor:
    """The reference's estimate contract: ``img1``, ``img2`` [H, W, 3] or
    [B, H, W, 3] in [0, 1] (numpy or tensor) are resized to multiples of 16,
    run through the net, and the flow is resized back to H x W with u and v
    rescaled by W/Wp and H/Hp.  Returns the flow [(B,) H, W, 2] fp32 on the
    model's device."""
    return estimate_resized(model, img1, img2, 16)
