"""Plain RAFT, the large model (Teed & Deng, ECCV 2020, arXiv:2003.12039),
as github.com/princeton-vl/RAFT computes it (``core/raft.py``,
``core/corr.py``, ``core/update.py``, ``core/extractor.py``), written out
with ``torch.nn.functional`` in fp32 with TF32 off, its weights read from
the packaged flat npz (flax keys, HWIO kernels).

The net, as published: the feature encoder (a 7x7/2 stem of 64, residual
blocks of 64, 96 and 128 at strides 1, 2, 2, a 1x1 projection to 256, all
InstanceNorm) on both frames; the context encoder of the same trunk split
into 128 hidden (tanh) and 128 context (relu); the all-pairs volume
<f1, f2> / sqrt(256) of the 1/8 features and its 4-level ``F.avg_pool2d``
pyramid (``CorrBlock``); 20 updates, each a radius-4 window of 81 samples a
level looked up around ``coords1`` with ``F.grid_sample`` (align_corners,
zeros outside; ``bilinear_sampler``), the motion encoder (324 -> 256 ->
192 on the volume, 2 -> 128 -> 64 on the flow, -> 126, the flow appended),
the SepConvGRU(128) (1x5 then 5x1 gates over [hidden, context, motion]) and
the flow head (128 -> 256 -> 2), ``coords1`` advanced by its output; then
the convex 8x upsampling, its mask (128 -> 256 -> 576) scaled by 0.25, a
softmax over 3x3 neighbours of the flow times 8 (``upsample_flow``).

Departures from the published code, each as the packaged weights were
trained:

- the context encoder's norm is InstanceNorm, not BatchNorm (at inference
  BatchNorm is a per-channel affine);
- the 81 window channels run row-major over (dy, dx), the y offset the
  slower; the published ``meshgrid(dy, dx)`` added to (x, y) makes the x
  offset the slower;
- the 576 mask channels are ordered (a, b, k): output pixel (8h + a,
  8w + b), neighbour k; the published ``view(N, 1, 9, 8, 8, H, W)`` puts k
  first;
- the frames are resized (bilinear, half-pixel) to multiples of 8 and the
  flow resized back, where the published demo pads; at sizes that are
  multiples of 8 neither acts.

With ``control`` both operands of every convolution and of the all-pairs
product are rounded to TF32 (``tf32_round``), the control's precision.
The frames are estimated one pair at a time, so that a 1080p pair's
4.2 GB volume and its pyramid are alive alone.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

HIDDEN = 128
LEVELS = 4
RADIUS = 4
ITERS = 20
MASK_SCALE = 0.25


def fp32_operand(x: torch.Tensor) -> torch.Tensor:
    return x


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round fp32 to TF32 (1 + 10 mantissa bits), to nearest, ties even: the
    products of TF32 operands are exact in fp32 and the sums fp32, which is
    TF32's arithmetic."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -8192
    return i.view(torch.float32)


def weights_from_flat(flat, device) -> dict[str, torch.Tensor]:
    """The flat npz's arrays (``a/b/c`` keys) in torch layouts: every kernel
    HWIO -> OIHW (RAFT has no transposed convolution), biases as they are."""
    out = {}
    for key, a in flat.items():
        a = np.asarray(a)
        if key.endswith("kernel"):
            a = np.ascontiguousarray(a.transpose(3, 2, 0, 1))
        out[key] = torch.from_numpy(np.array(a, np.float32)).to(device)
    return out


def load_weights(path, device) -> dict[str, torch.Tensor]:
    with np.load(path) as data:
        return weights_from_flat({k: data[k] for k in data.files}, device)


@contextlib.contextmanager
def fp32_math():
    """cuDNN's convolutions and cuBLAS's products in fp32: both TF32
    switches off for the block, then restored."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=False, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


def instance_norm(x):
    return F.instance_norm(x, eps=1e-5)


class RAFTLargeRef:
    def __init__(self, weights: dict, control: bool = False, iters: int = ITERS):
        self.w = weights
        self.op = tf32_round if control else fp32_operand
        self.iters = iters

    def conv(self, name, x, stride=1):
        """The convolution ``name``: a flax ``Conv`` module's ``Conv_0`` or,
        for the GRU's gates, a bare one; padding k // 2 on each axis."""
        key = name if f"{name}/kernel" in self.w else f"{name}/Conv_0"
        w = self.w[f"{key}/kernel"]
        return F.conv2d(self.op(x), self.op(w), self.w[f"{key}/bias"],
                        stride=stride, padding=(w.shape[2] // 2, w.shape[3] // 2))

    # ------------------------------------------------------------ encoders
    def residual(self, name, x, stride):
        y = F.relu(instance_norm(self.conv(f"{name}/conv1", x, stride)))
        y = F.relu(instance_norm(self.conv(f"{name}/conv2", y)))
        if f"{name}/down/Conv_0/kernel" in self.w:
            x = instance_norm(self.conv(f"{name}/down", x, stride))
        return F.relu(x + y)

    def encoder(self, name, x):
        x = F.relu(instance_norm(self.conv(f"{name}/stem", x, 2)))
        for i, stride in enumerate((1, 2, 2)):
            x = self.residual(f"{name}/block{i}a", x, stride)
            x = self.residual(f"{name}/block{i}b", x, 1)
        return self.conv(f"{name}/proj", x)

    # ---------------------------------------------------------- CorrBlock
    def corr_pyramid(self, f1, f2):
        """[h*w, 1, h_l, w_l] per level: the all-pairs volume of one pair
        over sqrt(C), then 2x2 average pools."""
        _, C, h, w = f1.shape
        a = self.op(f1.reshape(C, h * w).t())
        b = self.op(f2.reshape(C, h * w))
        corr = (a @ b / math.sqrt(C)).reshape(h * w, 1, h, w)
        pyr = [corr]
        for _ in range(LEVELS - 1):
            pyr.append(F.avg_pool2d(pyr[-1], 2, stride=2))
        return pyr

    @staticmethod
    def lookup(pyr, coords):
        """The windows around ``coords`` [1, 2, h, w] (x, y) at every level:
        [1, LEVELS * 81, h, w], level-major, row-major over (dy, dx)."""
        _, _, h, w = coords.shape
        d = torch.arange(-RADIUS, RADIUS + 1, device=coords.device,
                         dtype=torch.float32)
        dy, dx = torch.meshgrid(d, d, indexing="ij")
        delta = torch.stack([dx, dy], -1).reshape(1, 2 * RADIUS + 1,
                                                  2 * RADIUS + 1, 2)
        centroid = coords.permute(0, 2, 3, 1).reshape(h * w, 1, 1, 2)
        out = []
        for i, corr in enumerate(pyr):
            hl, wl = corr.shape[-2:]
            xy = centroid / 2 ** i + delta
            grid = torch.stack([2 * xy[..., 0] / (wl - 1) - 1,
                                2 * xy[..., 1] / (hl - 1) - 1], -1)
            s = F.grid_sample(corr, grid, mode="bilinear", padding_mode="zeros",
                              align_corners=True)
            out.append(s.reshape(h, w, -1))
        return torch.cat(out, -1).permute(2, 0, 1)[None]

    # --------------------------------------------------- BasicUpdateBlock
    def motion(self, flow, corr):
        c = F.relu(self.conv("motion/convc1", corr))
        c = F.relu(self.conv("motion/convc2", c))
        f = F.relu(self.conv("motion/convf1", flow))
        f = F.relu(self.conv("motion/convf2", f))
        out = F.relu(self.conv("motion/conv", torch.cat([c, f], 1)))
        return torch.cat([out, flow], 1)

    def gru(self, h, x):
        for axis in ("h", "v"):
            hx = torch.cat([h, x], 1)
            z = torch.sigmoid(self.conv(f"gru/convz_{axis}", hx))
            r = torch.sigmoid(self.conv(f"gru/convr_{axis}", hx))
            q = torch.tanh(self.conv(f"gru/convq_{axis}", torch.cat([r * h, x], 1)))
            h = (1 - z) * h + z * q
        return h

    def upsample(self, flow, h):
        """``upsample_flow`` with the mask of the last hidden state."""
        _, _, hc, wc = flow.shape
        mask = MASK_SCALE * self.conv("mask2", F.relu(self.conv("mask1", h)))
        mask = torch.softmax(mask.reshape(1, 8, 8, 9, hc, wc), dim=3)
        up = F.unfold(8 * flow, [3, 3], padding=1).reshape(1, 2, 1, 1, 9, hc, wc)
        up = (mask[:, None] * up).sum(4)  # [1, 2, 8, 8, hc, wc]
        return up.permute(0, 1, 4, 2, 5, 3).reshape(1, 2, 8 * hc, 8 * wc)

    def forward(self, img1, img2):
        """One pair [1, 3, H, W] in [0, 1], H and W multiples of 8 -> the
        flow [1, 2, H, W] after ``iters`` updates."""
        img1, img2 = 2 * img1 - 1, 2 * img2 - 1
        f1, f2 = (self.encoder("fnet", x) for x in (img1, img2))
        c = self.encoder("cnet", img1)
        h, ctx = torch.tanh(c[:, :HIDDEN]), F.relu(c[:, HIDDEN:])
        pyr = self.corr_pyramid(f1, f2)
        _, _, hc, wc = f1.shape
        ys, xs = torch.meshgrid(torch.arange(hc, device=f1.device, dtype=torch.float32),
                                torch.arange(wc, device=f1.device, dtype=torch.float32),
                                indexing="ij")
        coords0 = torch.stack([xs, ys])[None]
        coords1 = coords0.clone()
        for _ in range(self.iters):
            corr = self.lookup(pyr, coords1)
            flow = coords1 - coords0
            h = self.gru(h, torch.cat([ctx, self.motion(flow, corr)], 1))
            delta = self.conv("head/conv2", F.relu(self.conv("head/conv1", h)))
            coords1 = coords1 + delta
        return self.upsample(coords1 - coords0, h)

    def estimate(self, img1, img2):
        """[B, H, W, 3] frames in [0, 1] -> flow [B, H, W, 2] in pixels, a
        pair at a time, TF32 off."""
        with fp32_math():
            return torch.cat([self._estimate(img1[i:i + 1], img2[i:i + 1])
                              for i in range(img1.shape[0])])

    def _estimate(self, img1, img2):
        x1, x2 = (i.float().permute(0, 3, 1, 2) for i in (img1, img2))
        H, W = x1.shape[-2:]
        Hp, Wp = -(-H // 8) * 8, -(-W // 8) * 8
        x1, x2 = (F.interpolate(x, size=(Hp, Wp), mode="bilinear",
                                align_corners=False) if (Hp, Wp) != (H, W)
                  else x for x in (x1, x2))
        flow = self.forward(x1, x2)
        if (Hp, Wp) != (H, W):
            flow = F.interpolate(flow, size=(H, W), mode="bilinear",
                                 align_corners=False)
        return torch.stack([flow[:, 0] * (W / Wp), flow[:, 1] * (H / Hp)], -1)
