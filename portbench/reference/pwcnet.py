"""Plain PWC-Net (Sun et al., CVPR 2018, arXiv:1709.02371) as
sniklaus/pytorch-pwc computes it, written out with ``torch.nn.functional``
in fp32, with its weights read from the packaged flat npz (flax keys and
layouts: HWIO convolution kernels, each transposed convolution stored as
the spatially flipped kernel of its input-dilated convolution).

The net: a six-level extractor (16/32/64/96/128/196 channels, three 3x3
convolutions a level, the first of stride 2); decoders at levels 6..2,
each a local correlation of 81 displacements (mean over the channels)
with the second frame's features backward-warped by the upsampled flow
(bilinear in pixels, zeros outside, gated by a warped ones channel above
0.999), a dense block
(128, 128, 96, 64, 32) and a flow prediction; a dilated context network
(1, 2, 4, 8, 16, 1) added to level 2's flow; the flow times 20.  The
estimate contract resizes the [0, 1] frames to multiples of 64, runs the
net, resizes the quarter-resolution flow back and rescales u and v.

``operand`` is applied to both operands of every convolution and of the
correlation: the identity for fp32, TF32 rounding (10-bit mantissa) for
the lower-precision control (``tf32_round``): the products of TF32
operands are exact in fp32 and the sums fp32, which is TF32's arithmetic.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

EXTRACTOR = (16, 32, 64, 96, 128, 196)
DENSE = (128, 128, 96, 64, 32)
REFINER_DILATION = (1, 2, 4, 8, 16, 1)
FLOW_SCALE = {5: 0.625, 4: 1.25, 3: 2.5, 2: 5.0}
MAX_DISP = 4


def fp32_operand(x: torch.Tensor) -> torch.Tensor:
    return x


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round fp32 to TF32 (1 + 10 mantissa bits), to nearest, ties even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -8192
    return i.view(torch.float32)


def load_weights(path, device) -> dict[str, torch.Tensor]:
    """The npz's arrays in torch layouts: convolutions OIHW, transposed
    convolutions [Cin, Cout, 4, 4]; biases as they are."""
    out = {}
    with np.load(path) as data:
        for key in data.files:
            a = data[key]
            if key.endswith("kernel") and ("upflow" in key or "upfeat" in key):
                a = np.ascontiguousarray(a[::-1, ::-1].transpose(2, 3, 0, 1))
            elif key.endswith("kernel"):
                a = np.ascontiguousarray(a.transpose(3, 2, 0, 1))
            out[key] = torch.from_numpy(a).to(device)
    return out


def leaky(x):
    return F.leaky_relu(x, 0.1)


class PWCNetRef:
    def __init__(self, weights: dict, operand=fp32_operand):
        self.w = weights
        self.op = operand

    def conv(self, name, x, stride=1, dilation=1):
        w = self.w[f"{name}/Conv_0/kernel"]
        pad = (w.shape[-1] // 2) * dilation
        return F.conv2d(self.op(x), self.op(w), self.w[f"{name}/Conv_0/bias"],
                        stride=stride, padding=pad, dilation=dilation)

    def deconv(self, name, x):
        return F.conv_transpose2d(self.op(x), self.op(self.w[f"{name}/kernel"]),
                                  self.w[f"{name}/bias"], stride=2, padding=1)

    def correlation(self, f1, f2):
        f1, f2 = self.op(f1), self.op(f2)
        H, W = f1.shape[-2:]
        D = MAX_DISP
        p = F.pad(f2, (D, D, D, D))
        return torch.stack([(f1 * p[:, :, dy:dy + H, dx:dx + W]).mean(1)
                            for dy in range(2 * D + 1)
                            for dx in range(2 * D + 1)], 1)

    @staticmethod
    def backwarp(x, flow):
        """x sampled bilinearly at p + flow (pixels), taps outside the image
        dropped, times (the warped ones channel > 0.999).  The ones channel
        is the sum of the in-image taps' weights, summed tap by tap in pixel
        coordinates: grid_sample's normalised coordinates round differently,
        and at the hard 0.999 threshold a flipped pixel moves the decoders'
        flow by up to 0.17 px over tens of thousands of pixels (PERF.md)."""
        B, C, H, W = x.shape
        px = torch.arange(W, device=x.device, dtype=torch.float32) + flow[:, 0]
        py = torch.arange(H, device=x.device, dtype=torch.float32)[:, None] + flow[:, 1]
        x0, y0 = torch.floor(px), torch.floor(py)
        ax, ay = px - x0, py - y0
        flat = x.reshape(B, C, H * W)
        out = torch.zeros_like(x)
        ones = torch.zeros_like(px)
        for dx, dy, wt in ((0, 0, (1 - ax) * (1 - ay)), (1, 0, ax * (1 - ay)),
                           (0, 1, (1 - ax) * ay), (1, 1, ax * ay)):
            tx, ty = x0 + dx, y0 + dy
            inside = (tx >= 0) & (tx <= W - 1) & (ty >= 0) & (ty <= H - 1)
            wt = torch.where(inside, wt, 0.0)
            idx = (ty.clamp(0, H - 1) * W + tx.clamp(0, W - 1)).long()
            out = out + flat.gather(2, idx.reshape(B, 1, -1).expand(B, C, -1)
                                    ).reshape(B, C, H, W) * wt[:, None]
            ones = ones + wt
        return out * (ones > 0.999).float()[:, None]

    def forward(self, img1, img2):
        B = img1.shape[0]
        x = torch.cat([img1, img2], 0)
        feats = []
        for lv in range(1, 7):
            x = leaky(self.conv(f"extractor/level{lv}/conv0", x, stride=2))
            x = leaky(self.conv(f"extractor/level{lv}/conv1", x))
            x = leaky(self.conv(f"extractor/level{lv}/conv2", x))
            feats.append(x)
        flow = feat = None
        for lv in (6, 5, 4, 3, 2):
            f1, f2 = feats[lv - 1][:B], feats[lv - 1][B:]
            d = f"decoder{lv}"
            if flow is None:
                x = leaky(self.correlation(f1, f2))
            else:
                up_flow = self.deconv(f"{d}/upflow", flow)
                up_feat = self.deconv(f"{d}/upfeat", feat)
                warped = self.backwarp(f2, up_flow * FLOW_SCALE[lv])
                x = torch.cat([leaky(self.correlation(f1, warped)), f1,
                               up_flow, up_feat], 1)
            for i in range(len(DENSE)):
                x = torch.cat([leaky(self.conv(f"{d}/dense{i}", x)), x], 1)
            flow, feat = self.conv(f"{d}/predict", x), x
        x = feat
        for i, dil in enumerate(REFINER_DILATION):
            x = leaky(self.conv(f"refiner/conv{i}", x, dilation=dil))
        return (flow + self.conv("refiner/conv6", x)) * 20.0

    def estimate(self, img1, img2):
        """[B, H, W, 3] frames in [0, 1] -> flow [B, H, W, 2] in pixels,
        with cuDNN's TF32 off (PyTorch's default leaves it on)."""
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=False, allow_tf32=False):
            return self._estimate(img1, img2)

    def _estimate(self, img1, img2):
        x1, x2 = (i.float().permute(0, 3, 1, 2) for i in (img1, img2))
        H, W = x1.shape[-2:]
        Hp, Wp = -(-H // 64) * 64, -(-W // 64) * 64
        x1, x2 = (F.interpolate(x, size=(Hp, Wp), mode="bilinear",
                                align_corners=False) if (Hp, Wp) != (H, W)
                  else x for x in (x1, x2))
        flow = F.interpolate(self.forward(x1, x2), size=(H, W),
                             mode="bilinear", align_corners=False)
        return torch.stack([flow[:, 0] * (W / Wp), flow[:, 1] * (H / Hp)], -1)
