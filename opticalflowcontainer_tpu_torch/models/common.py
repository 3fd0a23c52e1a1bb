"""Building blocks shared by the model zoo (reference ``models/common.py``).

torch-parity notes that converted weights depend on:

- :class:`Conv` pads ``(k // 2) * dilation`` on every side explicitly, as
  the reference's flax ``Conv`` does (XLA ``SAME`` would pad a strided conv
  of an even input (0, 1) and shift it by one pixel).
- :class:`Deconv` is ``ConvTranspose2d(kernel=4, stride=2, padding=1)``,
  grouped or not, with or without a bias.  The reference stores its kernel
  as the spatially flipped HWIO kernel of the equivalent input-dilated
  (grouped) conv; ``models/convert.py`` carries it back.
- :class:`AxisConv` is a bare flax ``nn.Conv`` with a k x 1 or 1 x k kernel
  and padding on that axis only (LiteFlowNet's separable ``dist_v`` /
  ``dist_h``); its keys have no ``Conv_0`` level.

Serving dtype: a model serves in its parameters' dtype (float32, or
bfloat16 after :func:`cast_params`), and :func:`estimate_resized` hands it
frames in that dtype.  The flow stays fp32 in every family; K3 and K4 take
fp32 only and are reached through :func:`in_fp32`.

Layout: NCHW activations, torch's OIHW / IOHW weights.
"""
from __future__ import annotations

import contextlib
import math
import threading

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core import spans
from ..core.resize import resize_bilinear
from ..ops.unfold import unfold


def leaky(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=slope)


class Conv(nn.Conv2d):
    """Conv2d with the reference's explicit symmetric padding.  Its weights
    come from the flax key ``<path>/Conv_0``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, padding: int | None = None,
                 dilation: int = 1, bias: bool = True):
        p = padding if padding is not None else (kernel // 2) * dilation
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=p,
                         dilation=dilation, bias=bias)


class AxisConv(nn.Conv2d):
    """Conv2d with a (kh, kw) kernel and padding (kh // 2, kw // 2), a bare
    flax ``nn.Conv``: its weights come from the flax key ``<path>``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: tuple[int, int]):
        kh, kw = kernel
        super().__init__(in_ch, out_ch, kernel, padding=(kh // 2, kw // 2))


class Deconv(nn.ConvTranspose2d):
    """2x upsampling transposed conv, torch ``ConvTranspose2d(kernel=4,
    stride=2, padding=1)``, grouped with ``groups``.  Its weights come from
    the flax key ``<path>``."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 4,
                 bias: bool = True, groups: int = 1):
        super().__init__(in_ch, out_ch, kernel, stride=2, padding=1, bias=bias,
                         groups=groups)


_fp32_lock = threading.Lock()
_fp32_depth = 0
_fp32_saved = (False, True)


@contextlib.contextmanager
def fp32_convolutions():
    """cuDNN convolutions in fp32 (no TF32) for the block, each algorithm
    chosen by timing (``cudnn.benchmark``): on an H100 cuDNN's fp32
    heuristics made RAFT's B=8 estimate 2-6x slower (PERF.md,
    "Findings").  RAFT, NeuFlow and PWC-Net run their forward in it: TF32
    moved their flows past the 1e-2 px bar (RAFT's seeded ones, PWC-Net's
    packaged ones).  The switches are PyTorch's process-wide
    ``torch.backends.cudnn.benchmark`` and ``allow_tf32``: blocks entered
    from several threads at once are counted, the first saves the settings
    and the last restores them, and convolutions that other threads run
    meanwhile get the same settings.  TF32 concerns fp32 only: a bf16
    model's convolutions stay bf16, their algorithms chosen by timing."""
    global _fp32_depth, _fp32_saved
    cudnn = torch.backends.cudnn
    with _fp32_lock:
        if _fp32_depth == 0:
            _fp32_saved = (cudnn.benchmark, cudnn.allow_tf32)
            cudnn.benchmark, cudnn.allow_tf32 = True, False
        _fp32_depth += 1
    try:
        yield
    finally:
        with _fp32_lock:
            _fp32_depth -= 1
            if _fp32_depth == 0:
                cudnn.benchmark, cudnn.allow_tf32 = _fp32_saved


def cast_params(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast ``module``'s parameters and floating buffers to ``dtype`` for
    reduced-precision serving (reference ``models/common.py`` ``cast_params``:
    bfloat16 halves the weights' and activations' bytes and runs the
    convolutions on the tensor cores).  In place, as ``Module.to``; returns
    ``module``."""
    return module.to(dtype)


def fuse_conv_bn(weight, bias, gamma, beta, mean, var, eps: float = 1e-5):
    """Fold an eval-mode BatchNorm (``gamma``, ``beta``, running ``mean``
    and ``var``) into the convolution before it, in numpy (reference
    ``models/common.py`` ``fuse_conv_bn``, the NeuFlow node's Conv+BN
    fusion).  ``weight`` is torch's OIHW layout (the reference takes flax's
    HWIO), ``bias`` the conv's [O] bias or None.  Returns (weight', bias')
    with ``conv(x, weight') + bias' == bn(conv(x, weight) + bias)``.  A
    utility for imported checkpoints: no model of the zoo has a
    BatchNorm."""
    scale = np.asarray(gamma) / np.sqrt(np.asarray(var) + eps)
    w = np.asarray(weight) * scale[:, None, None, None]
    b = (np.asarray(bias) if bias is not None else 0.0) - np.asarray(mean)
    return w, b * scale + np.asarray(beta)


def in_fp32(kernel, x: torch.Tensor, *args, **kwargs) -> torch.Tensor:
    """``kernel(x, *args, **kwargs)`` on fp32 copies of ``x`` and of the
    tensors in ``args``, its result cast back to ``x``'s dtype (the serving
    dtype).  K3 and K4 take fp32 only, so a bf16 model reaches its kernels
    through this; on fp32 tensors the casts are no-ops."""
    args = [a.float() if isinstance(a, torch.Tensor) else a for a in args]
    return kernel(x.float(), *args, **kwargs).to(x.dtype)


def upsample_convex(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The learned convex-combination 8x upsampling of RAFT and NeuFlow-v2,
    in the reference's layout: ``mask`` [B, 576, Hc, Wc] channel a*72 + b*9
    + k weighs 3x3 neighbour k (dy*3 + dx) of the coarse ``flow`` [B, 2,
    Hc, Wc] (x 8) for output pixel (8h + a, 8w + b), the weights a softmax
    over k in fp32.  Returns the flow [B, 2, 8Hc, 8Wc] in fp32."""
    B, _, Hc, Wc = flow.shape
    mask = torch.softmax(mask.float().reshape(B, 8, 8, 9, Hc, Wc), dim=3)
    patches = unfold(flow.float() * 8.0, 3)  # [B, 2, 9, Hc, Wc]
    up = (mask[:, None] * patches[:, :, None, None]).sum(4)  # [B, 2, 8, 8, Hc, Wc]
    return up.permute(0, 1, 4, 2, 5, 3).reshape(B, 2, 8 * Hc, 8 * Wc)


# the standard deviation of a unit normal truncated to [-2, 2]: flax's
# truncated-normal variance scaling divides by it
_TRUNC_STD = 0.87962566103423978


def _truncated_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """Unit normal draws truncated to [-2, 2] (float64, on the CPU), by the
    inverse CDF as ``jax.random.truncated_normal`` draws them."""
    lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    x = math.sqrt(2) * torch.erfinv(lo + u * (hi - lo))
    return x.clamp(-2.0, 2.0)


def flax_init(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise ``model``'s parameters as the reference's ``model.init``
    does, drawing from ``generator`` (a CPU generator; the draws are copied
    to the parameters' device).  In place; returns ``model``.

    - Convolution, transposed convolution and linear weights: flax's
      ``lecun_normal``, ``variance_scaling(1.0, "fan_in",
      "truncated_normal")``: std sqrt(1 / fan_in) / 0.8796 of a normal
      truncated at two std.  The fan-in is flax's for the kernel each
      module holds: kH * kW * Cin / groups for a convolution and for the
      reference's transposed one (``models/common.py`` ``Deconv``), the
      input width for a linear layer.
    - Biases 0; LayerNorm scale 1, bias 0.
    - A module's own constants by its ``init_constants`` method
      (NeuFlowLite's temperature 10 and gate 0).

    The numbers differ from JAX's PRNG draws; the distribution is the
    same.  Raises when a parameter is left uninitialised."""
    done = set()
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                w = module.weight
                if isinstance(module, nn.ConvTranspose2d):
                    fan_in = w.shape[0] // module.groups * w[0, 0].numel()
                else:
                    fan_in = w[0].numel()
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                w.copy_(_truncated_normal(w.shape, generator) * std)
                done.add(w)
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                done.add(module.weight)
            if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear,
                                   nn.LayerNorm)) and module.bias is not None:
                module.bias.zero_()
                done.add(module.bias)
            if hasattr(module, "init_constants"):
                done.update(module.init_constants())
    left = [name for name, p in model.named_parameters() if p not in done]
    if left:
        raise ValueError(f"flax_init: no initialiser for {left[:10]}")
    return model


def _pad_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def _to_nchw(img, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    x = torch.as_tensor(np.ascontiguousarray(img) if isinstance(img, np.ndarray)
                        else img)
    return x.to(device, dtype).permute(0, 3, 1, 2)


def estimate_resized(model: nn.Module, img1, img2, multiple: int,
                     **forward_kwargs) -> torch.Tensor:
    """The reference's estimate contract, shared by the zoo: ``img1``,
    ``img2`` [H, W, 3] or [B, H, W, 3] (numpy or tensor) are resized to
    multiples of ``multiple``, run through ``model`` (with
    ``forward_kwargs``), and its flow (at any
    fraction of the input's size) is resized back to H x W with u and v
    rescaled by W/Wp and H/Hp.  The frames go in the model's serving dtype
    (its parameters'); the flow comes back fp32 [(B,) H, W, 2] on the
    model's device.  Callers run it under ``torch.inference_mode()``."""
    param = next(model.parameters())
    batched = np.ndim(img1) == 4
    with spans.annotate(spans.MODEL_RESIZE_IN):
        x1, x2 = (_to_nchw(i if batched else i[None], param.device, param.dtype)
                  for i in (img1, img2))
        H, W = x1.shape[-2:]
        Hp, Wp = _pad_to(H, multiple), _pad_to(W, multiple)
        x1, x2 = resize_bilinear(x1, (Hp, Wp)), resize_bilinear(x2, (Hp, Wp))
    with spans.annotate(spans.MODEL_FORWARD):
        flow = model(x1, x2, **forward_kwargs)
    with spans.annotate(spans.MODEL_RESIZE_OUT):
        flow = resize_bilinear(flow, (H, W))
        # Python scalars are rounded to fp32 first, as the reference's fp32 scale
        flow = torch.stack([flow[:, 0] * (W / Wp), flow[:, 1] * (H / Hp)], -1)
        return flow if batched else flow[0]
