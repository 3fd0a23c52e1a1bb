"""NeuFlow-v2 (reference ``models/neuflow_v2.py``), NCHW: the published
architecture (Zhang et al., 2024) at the reference's widths.

- :class:`BackboneV2`: per scale of an image pyramid (half-pixel bilinear)
  a conv stage whose output joins the trunk, to 1/8 and 1/16 features;
- :class:`CrossAttention` at 1/16, one layer with shared weights applied
  both ways (post-norm, GELU MLP), with a fixed 2-D sinusoidal position
  embedding (:func:`_pos_embed_2d`);
- :func:`global_matching_flow`: the expectation of the target position
  under a softmax over the all-pairs correlation, minus the source;
- :class:`FlowAttention`: self-attention that propagates that flow;
- :class:`RefineBlock` at 1/16 (``iters_s16``) then 1/8 (``iters_s8``):
  f2 warped by the flow (K3), the radius-4 local correlation (K4), a
  ConvGRU and a flow head;
- :class:`ConvexUpsample`: the learned 8x convex upsampling.

The attention is plain ``torch.matmul`` and ``softmax`` in the reference's
order (it reaches no Pallas kernel there).  flax defaults that differ from
torch's are kept: the GELU's tanh approximation, LayerNorm eps 1e-6.  The
flow stays fp32, the softmaxes and norm statistics run in fp32; a model
cast to bfloat16 runs its convolutions and matmuls in bf16 and reaches K3
and K4 through :func:`~.common.in_fp32`.  A model served in fp32 runs its
convolutions in fp32 (:func:`~.common.fp32_convolutions`), as RAFT's.

Module and parameter names follow the reference's flax names, which
``models/convert.py`` relies on.  :func:`convert_neuflow_v2` maps a torch
checkpoint of the published model onto :class:`NeuFlowV2`.
:func:`estimate` implements the resize-to-a-multiple-of-16 contract.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import cached_tensors
from ..core.resize import resize_bilinear
from ..core.warp import warp_bilinear
from ..ops.allpairs import all_pairs_correlation
from ..ops.correlation import local_correlation
from .common import Conv, estimate_resized, fp32_convolutions, in_fp32, upsample_convex
from .raft import instance_norm


@dataclasses.dataclass(frozen=True)
class NeuFlowV2Config:
    dim_s16: int = 128      # feature width at 1/16 (matching stage)
    dim_s8: int = 128       # feature width at 1/8 (refinement stage)
    hidden: int = 128       # recurrent hidden state width
    corr_radius: int = 4    # local correlation radius in refinement
    iters_s16: int = 1      # refinement iterations at 1/16
    iters_s8: int = 8       # refinement iterations at 1/8
    heads: int = 1          # cross-attention heads


class _ConvBlock(nn.Module):
    """conv/2 - InstanceNorm - relu, conv - InstanceNorm - relu."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.down = Conv(cin, features, stride=2)
        self.conv = Conv(features, features)

    def forward(self, x):
        x = F.relu(instance_norm(self.down(x)))
        return F.relu(instance_norm(self.conv(x)))


class BackboneV2(nn.Module):
    """[B, 3, H, W] in [-1, 1] -> (1/8 features [B, dim_s8], 1/16 features
    [B, dim_s16]); the image at 1/2, 1/4 and 1/8 joins the trunk."""

    def __init__(self, dim_s8: int = 128, dim_s16: int = 128):
        super().__init__()
        self.block1 = _ConvBlock(3, 32)
        self.block2 = _ConvBlock(32 + 3, 48)
        self.block4 = _ConvBlock(48 + 3, 64)
        self.conv8 = Conv(64 + 3, dim_s8)
        self.block8 = _ConvBlock(dim_s8, dim_s16)
        self.conv16 = Conv(dim_s16, dim_s16, kernel=1, padding=0)

    def forward(self, img):
        H, W = img.shape[-2:]
        i2, i4, i8 = (resize_bilinear(img, (H // s, W // s)) for s in (2, 4, 8))
        f2 = self.block1(img)
        f4 = self.block2(torch.cat([f2, i2], 1))
        f8 = self.block4(torch.cat([f4, i4], 1))
        s8 = F.relu(instance_norm(self.conv8(torch.cat([f8, i8], 1))))
        return s8, self.conv16(self.block8(s8))


def _pos_embed_2d(H: int, W: int, dim: int) -> np.ndarray:
    """Fixed sinusoidal 2-D position embedding [H, W, dim] (GMFlow's): x's
    sines and cosines in the first half of the channels, y's in the
    second, zeros where dim is not a multiple of 4."""
    d4 = dim // 4
    omega = 1.0 / (10000.0 ** (np.arange(d4, dtype=np.float64) / max(d4, 1)))
    ys = np.arange(H, dtype=np.float64)[:, None] * omega[None]
    xs = np.arange(W, dtype=np.float64)[:, None] * omega[None]
    ey = np.concatenate([np.sin(ys), np.cos(ys)], -1)  # [H, dim/2]
    ex = np.concatenate([np.sin(xs), np.cos(xs)], -1)  # [W, dim/2]
    out = np.zeros((H, W, dim), np.float32)
    out[..., :d4 * 2] = ex[None, :, :]
    out[..., d4 * 2:d4 * 4] = ey[:, None, :]
    return out


@cached_tensors(32)
def _pos_embed(H: int, W: int, dim: int, device: torch.device,
               dtype: torch.dtype) -> torch.Tensor:
    """:func:`_pos_embed_2d` as a [dim, H, W] tensor kept on ``device``: an
    upload per call would synchronize the stream."""
    pe = torch.from_numpy(_pos_embed_2d(H, W, dim)).permute(2, 0, 1)
    return pe.to(device, dtype)


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, H*W, C]."""
    return x.flatten(2).transpose(1, 2)


class CrossAttention(nn.Module):
    """One global attention layer at 1/16: queries from ``q_feat``, keys and
    values from ``kv_feat`` [B, C, H, W]; the position embedding is added to
    the queries' and keys' inputs.  Post-norm: LayerNorm(x + attention),
    then LayerNorm(y + MLP(y))."""

    def __init__(self, dim: int, heads: int = 1):
        super().__init__()
        self.heads = heads
        for name in ("q", "k", "v", "proj"):
            self.add_module(name, nn.Linear(dim, dim))
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp1 = nn.Linear(dim, 2 * dim)
        self.mlp2 = nn.Linear(2 * dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, q_feat, kv_feat):
        B, C, H, W = q_feat.shape
        N, nh = H * W, self.heads
        hd = C // nh
        pe = _pos_embed(H, W, C, q_feat.device, q_feat.dtype)
        qin = _tokens(q_feat + pe)
        kin = _tokens(kv_feat + pe)
        vin = _tokens(kv_feat)
        q, k, v = (lin(x).reshape(B, N, nh, hd).transpose(1, 2)
                   for lin, x in ((self.q, qin), (self.k, kin), (self.v, vin)))
        att = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(hd)
        att = torch.softmax(att, -1).to(v.dtype)
        out = self.proj(torch.matmul(att, v).transpose(1, 2).reshape(B, N, C))
        y = self.norm1(qin + out)
        z = self.mlp2(F.gelu(self.mlp1(y), approximate="tanh"))
        y = self.norm2(y + z)
        return y.transpose(1, 2).reshape(B, C, H, W)


def _coords(H: int, W: int, device) -> torch.Tensor:
    """[H*W, 2] (x, y) of each position, row-major, fp32."""
    idx = torch.arange(H * W, dtype=torch.float32, device=device)
    return torch.stack([idx % W, idx // W], -1)


def global_matching_flow(f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    """GMFlow's global matching: the expectation of the target position
    under a softmax (fp32) over the all-pairs correlation, minus the source
    position.  f1, f2 [B, C, H, W] -> flow [B, 2, H, W] fp32."""
    B, _, H, W = f1.shape
    prob = torch.softmax(all_pairs_correlation(f1, f2).reshape(B, H * W, H * W), -1)
    grid = _coords(H, W, f1.device)
    return (prob @ grid - grid).transpose(1, 2).reshape(B, 2, H, W)


class FlowAttention(nn.Module):
    """Self-attention flow propagation (GMFlow): the flow [B, 2, H, W]
    averaged under a softmax (fp32) of the features' self-similarity."""

    def __init__(self, dim: int):
        super().__init__()
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)

    def forward(self, feat, flow):
        B, C, H, W = feat.shape
        x = _tokens(feat)
        att = torch.matmul(self.q(x), self.k(x).transpose(-1, -2)).float()
        att = torch.softmax(att / math.sqrt(C), -1)
        out = att @ _tokens(flow.float())
        return out.transpose(1, 2).reshape(B, 2, H, W)


class RefineBlock(nn.Module):
    """One recurrent refinement step: f2 warped by the flow (K3), the local
    correlation at ``radius`` (K4), an encoder conv, a ConvGRU on the
    hidden state and a flow head; returns (hidden, flow + delta), the flow
    fp32."""

    def __init__(self, hidden: int, feat_ch: int, radius: int = 4):
        super().__init__()
        self.radius = radius
        self.enc1 = Conv((2 * radius + 1) ** 2 + feat_ch + 2, hidden)
        self.convz = Conv(2 * hidden, hidden)
        self.convr = Conv(2 * hidden, hidden)
        self.convq = Conv(2 * hidden, hidden)
        self.head1 = Conv(hidden, 96)
        self.flow_head = Conv(96, 2)

    def forward(self, h, f1, f2, flow):
        f2w = in_fp32(warp_bilinear, f2, flow)
        corr = in_fp32(local_correlation, f1, f2w, self.radius)
        x = F.relu(self.enc1(torch.cat([corr, f1, flow.to(f1.dtype)], 1)))
        hx = torch.cat([h, x], 1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], 1)))
        h = (1.0 - z) * h + z * q
        delta = self.flow_head(F.relu(self.head1(h)))
        return h, flow + delta.float()


class ConvexUpsample(nn.Module):
    """The learned 8x convex upsampling of the 1/8 flow, its mask read from
    the hidden state."""

    def __init__(self, hidden: int):
        super().__init__()
        self.mask1 = Conv(hidden, 128)
        self.mask2 = Conv(128, 64 * 9, kernel=1, padding=0)

    def forward(self, flow, h):
        return upsample_convex(flow, self.mask2(F.relu(self.mask1(h))) * 0.25)


class NeuFlowV2(nn.Module):
    """(img1, img2) [B, 3, H, W] in [0, 1], H and W multiples of 16 ->
    flow [B, 2, H, W] fp32 in pixels, after ``iters_s8`` refinements at 1/8
    (the config's by default)."""

    def __init__(self, config: NeuFlowV2Config = NeuFlowV2Config()):
        super().__init__()
        cfg = self.config = config
        self.backbone = BackboneV2(cfg.dim_s8, cfg.dim_s16)
        self.cross_attn = CrossAttention(cfg.dim_s16, cfg.heads)
        self.flow_attn = FlowAttention(cfg.dim_s16)
        self.init_h16 = Conv(cfg.dim_s16, cfg.hidden)
        self.refine16 = RefineBlock(cfg.hidden, cfg.dim_s16, cfg.corr_radius)
        self.init_h8 = Conv(cfg.dim_s8, cfg.hidden)
        self.refine8 = RefineBlock(cfg.hidden, cfg.dim_s8, cfg.corr_radius)
        self.up = ConvexUpsample(cfg.hidden)

    def forward(self, img1, img2, iters_s8: int | None = None,
                return_aux: bool = False):
        """``return_aux=True`` also returns the refined 1/16 matching flow
        upsampled to the input's size in pixels (the reference's auxiliary
        training target)."""
        with fp32_convolutions():
            return self._forward(img1, img2, iters_s8, return_aux)

    def _forward(self, img1, img2, iters_s8, return_aux):
        cfg = self.config
        B = img1.shape[0]
        # both frames through the backbone as one batch (norms per image)
        s8, s16 = self.backbone(torch.cat([img1, img2], 0) * 2.0 - 1.0)
        f1_8, f2_8 = s8[:B], s8[B:]
        # the cross-attention both ways as one batch: shared weights
        g = self.cross_attn(s16, torch.cat([s16[B:], s16[:B]], 0))
        g1, g2 = g[:B], g[B:]
        flow16 = self.flow_attn(g1, global_matching_flow(g1, g2))
        h16 = torch.tanh(self.init_h16(g1))
        for _ in range(cfg.iters_s16):
            h16, flow16 = self.refine16(h16, g1, g2, flow16)
        flow8 = resize_bilinear(flow16, tuple(f1_8.shape[-2:])) * 2.0
        h8 = torch.tanh(self.init_h8(f1_8))
        # an explicit iters_s8=0 stays 0
        for _ in range(cfg.iters_s8 if iters_s8 is None else iters_s8):
            h8, flow8 = self.refine8(h8, f1_8, f2_8, flow8)
        out = self.up(flow8, h8)
        if return_aux:
            return out, resize_bilinear(flow16, tuple(img1.shape[-2:])) * 16.0
        return out


@torch.inference_mode()
def estimate(model: NeuFlowV2, img1, img2, iters_s8: int = 8) -> torch.Tensor:
    """The reference's estimate contract: ``img1``, ``img2`` [H, W, 3] or
    [B, H, W, 3] in [0, 1] (numpy or tensor) are resized to multiples of 16,
    run through the net with ``iters_s8`` refinements at 1/8, and the flow
    is resized back to H x W with u and v rescaled by W/Wp and H/Hp.
    Returns the flow [(B,) H, W, 2] fp32 on the model's device."""
    return estimate_resized(model, img1, img2, 16, iters_s8=int(iters_s8))


# ------------------------------------------------------------- converter

# torch checkpoint top-level prefix -> the model's top-level module
_GROUP_MAP = {
    "backbone": "backbone",
    "cross_attn": "cross_attn", "transformer": "cross_attn",
    "flow_attn": "flow_attn",
    "refine_s16": "refine16", "refine16": "refine16",
    "refine_s8": "refine8", "refine8": "refine8",
    "conv_s16": "init_h16", "init_h16": "init_h16",
    "conv_s8": "init_h8", "init_h8": "init_h8",
    "upsample": "up", "up": "up",
}
# name parts that carry no identity (every conv has a weight): matching on
# them would make unrelated parameters look alike
_GENERIC = {"weight", "bias", "kernel", "scale", "params", "running_mean",
            "running_var", "w", "b"}
# a checkpoint's leaf name -> the model's leaf names it may fill, a
# tiebreak between parameters of one module (a norm's weight and bias)
_LEAF_COMPAT = {"weight": {"weight"}, "w": {"weight"}, "kernel": {"weight"},
                "scale": {"weight"}}


def _parts(key: str) -> list[str]:
    return [t for t in key.replace("'", ".").replace("[", ".").replace("]", ".")
            .split(".") if t]


def _name_tokens(key: str) -> set[str]:
    return set(_parts(key)) - _GENERIC


def convert_neuflow_v2(state_dict: dict, model: NeuFlowV2 | None = None) -> NeuFlowV2:
    """``model`` (a new :class:`NeuFlowV2` by default) with the weights of
    a torch checkpoint of the published model, matched by module group and
    shape (the reference's converter, for the port's torch layout: no
    transposes).

    Each checkpoint tensor goes to the group its top-level prefix names
    (``_GROUP_MAP``).  Within a group the checkpoint's and the model's
    shapes must be the same multiset; a shape held by one tensor matches
    directly, and tensors that share a shape (q/k/v/proj, convz/convr/
    convq, biases beside norm weights) match by the name parts they share,
    never by position: a checkpoint lists its tensors in the order its
    modules were defined.  Raises, listing both sides, on a prefix with no
    group, a group whose shapes differ, a key that does not name-match
    exactly one parameter, or a model parameter left unfilled."""
    model = model or NeuFlowV2()
    own = model.state_dict()
    groups: dict[str, list[tuple[str, torch.Tensor]]] = {}
    for k, v in state_dict.items():
        dst = _GROUP_MAP.get(k.split(".")[0])
        if dst is None:
            raise KeyError(f"unmapped checkpoint module {k.split('.')[0]!r} "
                           f"(key {k}); extend _GROUP_MAP, known: "
                           f"{sorted(_GROUP_MAP)}")
        groups.setdefault(dst, []).append((k, v))

    out: dict[str, torch.Tensor] = {}
    for dst, items in groups.items():
        leaves = [(n, p) for n, p in own.items() if n.split(".")[0] == dst]
        shapes_t = [tuple(a.shape) for _, a in items]
        shapes_m = [tuple(p.shape) for _, p in leaves]
        if sorted(shapes_t) != sorted(shapes_m):
            raise ValueError(f"group {dst!r}: checkpoint shapes {shapes_t} != "
                             f"model shapes {shapes_m}; fix _GROUP_MAP or the "
                             f"dims in NeuFlowV2Config")
        by_shape: dict[tuple, list[str]] = {}
        for n, p in leaves:
            by_shape.setdefault(tuple(p.shape), []).append(n)
        t_by_shape: dict[tuple, list[tuple[str, torch.Tensor]]] = {}
        for k, a in items:
            t_by_shape.setdefault(tuple(a.shape), []).append((k, a))
        for shape, t_items in t_by_shape.items():
            names = by_shape[shape]
            if len(t_items) == 1:
                out[names[0]] = t_items[0][1]
                continue
            taken: set[str] = set()
            for k, a in t_items:
                tk = _name_tokens(k) - {dst}
                leaf = _parts(k)[-1]
                ok_leaves = _LEAF_COMPAT.get(leaf, {leaf})
                cands = [n for n in names if n not in taken]
                scores = {n: 2 * len(tk & _name_tokens(n))
                          + (_parts(n)[-1] in ok_leaves) for n in cands}
                best = max(scores.values(), default=0)
                hits = [n for n in cands if scores[n] == best]
                if best == 0 or len(hits) != 1:
                    raise ValueError(
                        f"group {dst!r}: {len(t_items)} checkpoint tensors share "
                        f"shape {shape} and key {k!r} does not name-match "
                        f"exactly one model parameter (candidates: {cands}); "
                        f"refusing to match positionally, extend _GROUP_MAP "
                        f"with per-parameter names for this module")
                taken.add(hits[0])
                out[hits[0]] = a
    unfilled = sorted(set(own) - set(out))
    if unfilled:
        raise ValueError(f"model parameters left unfilled: {unfilled[:10]} "
                         f"(checkpoint groups: {sorted(groups)})")
    model.load_state_dict({n: t.detach().to(own[n].dtype) for n, t in out.items()})
    return model
