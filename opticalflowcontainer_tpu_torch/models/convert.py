"""Carry the reference's flax weights (flat npz, ``a/b/c`` keys) into the
port's modules (reference ``models/common.py`` ``load_flat_npz`` and
``models/raft.py`` ``_load_weights_npz``): PWC-Net, LiteFlowNet,
LiteFlowNet3, RAFT-small, RAFT (large), NeuFlowLite and NeuFlow-v2.

Names map one to one: the module at ``decoder2.dense0`` takes the flax
parameters under ``decoder2/dense0``.  A :class:`~.common.Conv` wraps a
flax ``nn.Conv`` (keys ``<path>/Conv_0/kernel`` HWIO -> OIHW); an
:class:`~.common.AxisConv` is a bare ``nn.Conv`` (keys ``<path>/kernel``);
a :class:`~.common.Deconv` stores the flipped HWIO kernel of the equivalent
input-dilated, possibly grouped, conv (``<path>/kernel``), the inverse of
the reference's ``convert_torch_deconv``.  An ``nn.Linear`` is a flax
``Dense`` (``<path>/kernel`` [in, out] -> weight [out, in], ``bias``), an
``nn.LayerNorm`` a flax ``LayerNorm`` (``scale`` -> weight, ``bias``), and a
module's own ``nn.Parameter`` a bare flax ``self.param`` (``<path>/<name>``,
NeuFlowLite's ``match_temp`` and ``matching_gate``).

The reference's converters of torch checkpoints (sniklaus' PWC-Net,
LiteFlowNet and LiteFlowNet3, and this repo's RAFT-small naming) are here
too, as :func:`convert_pwcnet` and the rest: each takes such a
``state_dict`` and returns the port's.  They walk the reference's tables,
which name each torch module and the model path it fills (the port's copy
below).  The port's modules keep torch's layouts (OIHW convolutions,
ConvTranspose2d's [Cin, Cout/g, kH, kW]), so an entry only renames.
"""
from __future__ import annotations

import functools
import pathlib
from typing import Mapping, NamedTuple

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device
from .common import AxisConv, Conv, Deconv
from .liteflownet import LiteFlowNet
from .liteflownet3 import LiteFlowNet3
from .neuflow import NeuFlowLite
from .neuflow_v2 import NeuFlowV2
from .pwcnet import PWCNet
from .raft import RAFT, RAFTSmall

# The reference package keeps its packaged weights here; they are read as
# data files, never imported.
WEIGHTS_DIR = (pathlib.Path(__file__).resolve().parents[2]
               / "opticalflowcontainer_tpu" / "models" / "weights")


def load_flat_npz(path) -> dict[str, np.ndarray]:
    """Every array of a flat-npz checkpoint, by its ``a/b/c`` key."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def conv_weight(kernel: np.ndarray) -> np.ndarray:
    """flax HWIO conv kernel -> torch OIHW."""
    return np.transpose(kernel, (3, 2, 0, 1))


def deconv_weight(kernel: np.ndarray, groups: int = 1) -> np.ndarray:
    """The reference Deconv's flipped HWIO kernel [kH, kW, Cin/g, Cout] of
    ``groups`` = g groups -> torch ConvTranspose2d's (Cin, Cout/g, kH, kW):
    the grouped branch of the reference's ``convert_torch_deconv`` run
    backwards (its output channel g * Cout/g + o is group g's o-th)."""
    kh, kw, cpg, cout = kernel.shape
    k = kernel.reshape(kh, kw, cpg, groups, cout // groups)
    k = np.transpose(k, (3, 2, 4, 0, 1)).reshape(groups * cpg, cout // groups,
                                                 kh, kw)
    return k[:, :, ::-1, ::-1]


def flax_conv_kernel(weight: np.ndarray) -> np.ndarray:
    """torch OIHW -> the flax HWIO kernel (the inverse of
    :func:`conv_weight`)."""
    return np.transpose(weight, (2, 3, 1, 0))


def flax_deconv_kernel(weight: np.ndarray, groups: int = 1) -> np.ndarray:
    """torch ConvTranspose2d's (Cin, Cout/g, kH, kW) -> the reference
    Deconv's flipped HWIO kernel [kH, kW, Cin/g, Cout] (its
    ``convert_torch_deconv``; the inverse of :func:`deconv_weight`)."""
    w = weight[:, :, ::-1, ::-1]
    cin, cog, kh, kw = w.shape
    k = w.reshape(groups, cin // groups, cog, kh, kw)
    return np.transpose(k, (3, 4, 1, 0, 2)).reshape(kh, kw, cin // groups,
                                                    groups * cog)


def _flax_key(name: str, module: nn.Module, pname: str,
              to_flax: bool = False) -> tuple[str, object]:
    """The flax key of parameter ``pname`` of the module at ``name`` (empty
    for the root) and the map of its array to the parameter's layout, or
    with ``to_flax`` the map back to the flax layout."""
    path = name.split(".") if name else []
    if isinstance(module, Deconv):
        prefix, weight_map = path, functools.partial(
            flax_deconv_kernel if to_flax else deconv_weight,
            groups=module.groups)
    elif isinstance(module, AxisConv):
        prefix, weight_map = path, flax_conv_kernel if to_flax else conv_weight
    elif isinstance(module, Conv):
        prefix = path + ["Conv_0"]
        weight_map = flax_conv_kernel if to_flax else conv_weight
    elif isinstance(module, nn.Linear):
        prefix, weight_map = path, np.transpose
    elif isinstance(module, nn.LayerNorm):
        return "/".join(path + ["scale" if pname == "weight" else pname]), None
    else:
        return "/".join(path + [pname]), None
    if pname == "weight":
        return "/".join(prefix + ["kernel"]), weight_map
    return "/".join(prefix + [pname]), None


def flax_to_torch_state_dict(flat: dict[str, np.ndarray],
                             model: nn.Module) -> dict[str, torch.Tensor]:
    """The state dict of ``model`` from the flat flax parameters ``flat``.

    Raises on a parameter with no npz key, a shape mismatch, a module
    parameter left unfilled, or an npz key left unused."""
    out: dict[str, torch.Tensor] = {}
    used: set[str] = set()
    for name, module in model.named_modules():
        for pname, param in module.named_parameters(recurse=False):
            key, weight_map = _flax_key(name, module, pname)
            if key not in flat:
                raise KeyError(f"{name}.{pname}: no key {key!r} in the npz")
            arr = flat[key]
            if weight_map is not None:
                arr = weight_map(arr)
            if arr.shape != tuple(param.shape):
                raise ValueError(f"{name}.{pname}: npz {key!r} gives shape "
                                 f"{arr.shape}, the module wants "
                                 f"{tuple(param.shape)}")
            # a C-ordered copy: the flipped views and read-only arrays stay put
            out[f"{name}.{pname}" if name else pname] = torch.from_numpy(arr.copy())
            used.add(key)
    unfilled = sorted(set(model.state_dict()) - set(out))
    if unfilled:
        raise ValueError(f"module parameters left unfilled: {unfilled[:10]}")
    unused = sorted(set(flat) - used)
    if unused:
        raise ValueError(f"npz keys left unused: {unused[:10]}")
    return out


def torch_to_flax_flat(model: nn.Module) -> dict[str, np.ndarray]:
    """The flat flax parameters (``a/b/c`` keys, float32 arrays in flax's
    layouts) of ``model``: the inverse of :func:`flax_to_torch_state_dict`,
    the npz that the reference's ``tools/train_flow.py`` exports and both
    packages' loaders read.  Raises on a module parameter that maps to no
    key of its own, as the forward map raises on one left unfilled."""
    out: dict[str, np.ndarray] = {}
    for name, module in model.named_modules():
        for pname, param in module.named_parameters(recurse=False):
            key, to_flax = _flax_key(name, module, pname, to_flax=True)
            if key in out:
                raise ValueError(f"{name}.{pname}: flax key {key!r} is taken "
                                 f"by another parameter")
            arr = param.detach().float().cpu().numpy()
            out[key] = np.ascontiguousarray(arr if to_flax is None
                                            else to_flax(arr))
    unmapped = sorted(set(model.state_dict()) - {
        f"{n}.{p}" if n else p for n, m in model.named_modules()
        for p, _ in m.named_parameters(recurse=False)})
    if unmapped:
        raise ValueError(f"state entries with no flax key: {unmapped[:10]}")
    return out


def save_flat_npz(model: nn.Module, path) -> None:
    """Write ``model``'s parameters as the flat npz at ``path`` (the
    reference's ``train_flow`` export)."""
    np.savez(path, **torch_to_flax_flat(model))


def _load_synth(name: str, model: nn.Module, device) -> nn.Module | None:
    path = WEIGHTS_DIR / name
    if not path.exists():
        return None
    model.load_state_dict(flax_to_torch_state_dict(load_flat_npz(path), model))
    return model.to(resolve_device(device)).eval()


def load_pwcnet_synth(device=None) -> PWCNet | None:
    """The port's :class:`PWCNet` with the packaged ``pwcnet_synth.npz``
    weights, in eval mode on ``device`` (the card unless ``"cpu"`` is asked
    for), or None when the file is absent."""
    return _load_synth("pwcnet_synth.npz", PWCNet(), device)


def load_liteflownet_synth(device=None) -> LiteFlowNet | None:
    """:class:`LiteFlowNet` with the packaged ``liteflownet_synth.npz``, as
    :func:`load_pwcnet_synth`."""
    return _load_synth("liteflownet_synth.npz", LiteFlowNet(), device)


def load_liteflownet3_synth(device=None) -> LiteFlowNet3 | None:
    """:class:`LiteFlowNet3` with the packaged ``liteflownet3_synth.npz``,
    as :func:`load_pwcnet_synth`."""
    return _load_synth("liteflownet3_synth.npz", LiteFlowNet3(), device)


def load_raft_small_synth(device=None) -> RAFTSmall | None:
    """:class:`RAFTSmall` with the packaged ``raft_small_synth.npz``, as
    :func:`load_pwcnet_synth`."""
    return _load_synth("raft_small_synth.npz", RAFTSmall(), device)


def load_raft_synth(device=None) -> RAFT | None:
    """:class:`RAFT` (large) with the packaged ``raft_large_synth.npz``, as
    :func:`load_pwcnet_synth`."""
    return _load_synth("raft_large_synth.npz", RAFT(), device)


def load_neuflow_lite_synth(device=None) -> NeuFlowLite | None:
    """:class:`NeuFlowLite` with the packaged ``neuflow_lite_synth.npz``,
    as :func:`load_pwcnet_synth`."""
    return _load_synth("neuflow_lite_synth.npz", NeuFlowLite(), device)


def load_neuflow_v2_synth(device=None) -> NeuFlowV2 | None:
    """:class:`NeuFlowV2` with the packaged ``neuflow_v2_synth.npz``, as
    :func:`load_pwcnet_synth`."""
    return _load_synth("neuflow_v2_synth.npz", NeuFlowV2(), device)


# ------------------------------------------ reference torch checkpoints

class Entry(NamedTuple):
    torch_name: str          # the checkpoint's module prefix (<name>.weight/.bias)
    flax_path: tuple[str, ...]  # the model's module path
    kind: str                # 'conv' (a Conv), 'rawconv' (an AxisConv), 'deconv'
    groups: int = 1


def pwcnet_table() -> list[Entry]:
    t: list[Entry] = []
    levels = ["netOne", "netTwo", "netThr", "netFou", "netFiv", "netSix"]
    for i, lname in enumerate(levels):
        for j in range(3):
            t.append(Entry(f"netExtractor.{lname}.{j * 2}",
                           ("extractor", f"level{i + 1}", f"conv{j}"), "conv"))
    decoders = {2: "netTwo", 3: "netThr", 4: "netFou", 5: "netFiv", 6: "netSix"}
    dense = ["netOne", "netTwo", "netThr", "netFou", "netFiv"]
    for lvl, dname in decoders.items():
        if lvl < 6:
            t.append(Entry(f"{dname}.netUpflow", (f"decoder{lvl}", "upflow"), "deconv"))
            t.append(Entry(f"{dname}.netUpfeat", (f"decoder{lvl}", "upfeat"), "deconv"))
        for i, sub in enumerate(dense):
            t.append(Entry(f"{dname}.{sub}.0", (f"decoder{lvl}", f"dense{i}"), "conv"))
        t.append(Entry(f"{dname}.netSix.0", (f"decoder{lvl}", "predict"), "conv"))
    for i in range(7):
        t.append(Entry(f"netRefiner.netMain.{i * 2}", ("refiner", f"conv{i}"), "conv"))
    return t


_FEATURE_MAP = [
    ("netOne.0", "conv1"),
    ("netTwo.0", "conv2a"), ("netTwo.2", "conv2b"), ("netTwo.4", "conv2c"),
    ("netThr.0", "conv3a"), ("netThr.2", "conv3b"),
    ("netFou.0", "conv4a"), ("netFou.2", "conv4b"),
    ("netFiv.0", "conv5"),
    ("netSix.0", "conv6"),
]


def _features_entries() -> list[Entry]:
    return [Entry(f"netFeatures.{tn}", ("features", ours), "conv")
            for tn, ours in _FEATURE_MAP]


def liteflownet_table() -> list[Entry]:
    """ModuleList index i is level [2, 3, 4, 5, 6][i]."""
    t = _features_entries()
    for idx, lvl in enumerate((2, 3, 4, 5, 6)):
        m, s, r = f"netMatching.{idx}", f"netSubpixel.{idx}", f"netRegularization.{idx}"
        if lvl == 2:
            t.append(Entry(f"{m}.netFeat.0", (f"matching{lvl}", "feat"), "conv"))
            t.append(Entry(f"{s}.netFeat.0", (f"subpixel{lvl}", "feat"), "conv"))
        if lvl != 6:
            t.append(Entry(f"{m}.netUpflow", (f"matching{lvl}", "upflow"), "deconv", 2))
        if lvl < 4:
            t.append(Entry(f"{m}.netUpcorr", (f"matching{lvl}", "upcorr"), "deconv", 49))
        for i in range(3):
            t.append(Entry(f"{m}.netMain.{i * 2}", (f"matching{lvl}", f"main{i}"), "conv"))
            t.append(Entry(f"{s}.netMain.{i * 2}", (f"subpixel{lvl}", f"main{i}"), "conv"))
        t.append(Entry(f"{m}.netMain.6", (f"matching{lvl}", "head"), "conv"))
        t.append(Entry(f"{s}.netMain.6", (f"subpixel{lvl}", "head"), "conv"))
        if lvl < 5:
            t.append(Entry(f"{r}.netFeat.0", (f"regularization{lvl}", "feat"), "conv"))
        for i in range(6):
            t.append(Entry(f"{r}.netMain.{i * 2}", (f"regularization{lvl}", f"main{i}"), "conv"))
        if lvl >= 5:
            t.append(Entry(f"{r}.netDist.0", (f"regularization{lvl}", "dist"), "conv"))
        else:
            t.append(Entry(f"{r}.netDist.0", (f"regularization{lvl}", "dist_v"), "rawconv"))
            t.append(Entry(f"{r}.netDist.1", (f"regularization{lvl}", "dist_h"), "rawconv"))
        t.append(Entry(f"{r}.netScaleX", (f"regularization{lvl}", "scale_x"), "conv"))
        t.append(Entry(f"{r}.netScaleY", (f"regularization{lvl}", "scale_y"), "conv"))
    return t


def liteflownet3_table() -> list[Entry]:
    """ModuleList index i is level [3, 4, 5, 6][i]."""
    t = _features_entries()
    for idx, lvl in enumerate((3, 4, 5, 6)):
        m, s, r = f"netMatching.{idx}", f"netSubpixel.{idx}", f"netRegularization.{idx}"
        if lvl <= 4:
            t.append(Entry(f"{m}.netUpconf", (f"matching{lvl}", "upconf"), "deconv"))
            for i in range(3):
                t.append(Entry(f"{m}.confFeat.{i * 2}", (f"matching{lvl}", f"conf{i}"), "conv"))
            t.append(Entry(f"{m}.confNet.0", (f"matching{lvl}", "conf_head"), "conv"))
            t.append(Entry(f"{m}.dispNet.0", (f"matching{lvl}", "disp_head"), "conv"))
            for i in range(2):
                t.append(Entry(f"{m}.corrFeat.{i * 2}", (f"matching{lvl}", f"corr{i}"), "conv"))
            t.append(Entry(f"{m}.corrScalar.0", (f"matching{lvl}", "corr_scalar0"), "conv"))
            t.append(Entry(f"{m}.corrScalar.2", (f"matching{lvl}", "corr_scalar1"), "conv"))
            t.append(Entry(f"{m}.corrOffset.0", (f"matching{lvl}", "corr_offset0"), "conv"))
            t.append(Entry(f"{m}.corrOffset.2", (f"matching{lvl}", "corr_offset1"), "conv"))
        if lvl != 6:
            t.append(Entry(f"{m}.netUpflow", (f"matching{lvl}", "upflow"), "deconv", 2))
        for i in range(5):
            t.append(Entry(f"{m}.netMain.{i * 2}", (f"matching{lvl}", f"main{i}"), "conv"))
            t.append(Entry(f"{s}.netMain.{i * 2}", (f"subpixel{lvl}", f"main{i}"), "conv"))
        t.append(Entry(f"{m}.netMain.10", (f"matching{lvl}", "head"), "conv"))
        t.append(Entry(f"{s}.netMain.10", (f"subpixel{lvl}", "head"), "conv"))
        if lvl <= 4:
            t.append(Entry(f"{r}.netFeat.0", (f"regularization{lvl}", "feat"), "conv"))
        for i in range(6):
            t.append(Entry(f"{r}.netMain.{i * 2}", (f"regularization{lvl}", f"main{i}"), "conv"))
        if lvl >= 5:
            t.append(Entry(f"{r}.netDist.0", (f"regularization{lvl}", "dist"), "conv"))
        else:
            t.append(Entry(f"{r}.netDist.0", (f"regularization{lvl}", "dist_v"), "rawconv"))
            t.append(Entry(f"{r}.netDist.1", (f"regularization{lvl}", "dist_h"), "rawconv"))
        if lvl in (4, 5):
            t.append(Entry(f"{r}.confNet.0", (f"regularization{lvl}", "conf_head"), "conv"))
        t.append(Entry(f"{r}.netScaleX", (f"regularization{lvl}", "scale_x"), "conv"))
        t.append(Entry(f"{r}.netScaleY", (f"regularization{lvl}", "scale_y"), "conv"))
    return t


def raft_small_table() -> list[Entry]:
    """RAFT-small's convolutions under this repo's module naming; a
    torchvision ``raft_small`` checkpoint would need its prefixes renamed
    first (feature_encoder -> fnet, update_block.motion_encoder -> motion,
    ...)."""
    t: list[Entry] = []
    for enc in ("fnet", "cnet"):
        t.append(Entry(f"{enc}.stem", (enc, "stem"), "conv"))
        for i, (cin, ch, s) in enumerate(((32, 32, 1), (32, 64, 2), (64, 96, 2))):
            for blk, bcin, bs in ((f"block{i}a", cin, s), (f"block{i}b", ch, 1)):
                for c in ("conv1", "conv2", "conv3"):
                    t.append(Entry(f"{enc}.{blk}.{c}", (enc, blk, c), "conv"))
                if bs != 1 or bcin != ch:
                    t.append(Entry(f"{enc}.{blk}.down", (enc, blk, "down"), "conv"))
        t.append(Entry(f"{enc}.proj", (enc, "proj"), "conv"))
    for m in ("convc1", "convf1", "convf2", "conv"):
        t.append(Entry(f"motion.{m}", ("motion", m), "conv"))
    for g in ("convz", "convr", "convq"):
        t.append(Entry(f"gru.{g}", ("gru", g), "conv"))
    t.append(Entry("head.conv1", ("head", "conv1"), "conv"))
    t.append(Entry("head.conv2", ("head", "conv2"), "conv"))
    return t


def _rename(sd: Mapping) -> dict:
    # every occurrence, as the reference's loaders replace: real sniklaus
    # checkpoints nest module-prefixed names (moduleExtractor.moduleOne.0)
    return {k.replace("module", "net"): v for k, v in sd.items()}


def _tensor(v) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, np.float32)).clone().contiguous()


def apply_table(sd: Mapping, table: list[Entry]) -> dict[str, torch.Tensor]:
    """The port's state dict from the reference checkpoint ``sd`` (names to
    arrays or tensors): each entry's weight and, where the checkpoint has
    one, bias, under the model's module path, as float32."""
    sd = _rename(sd)
    out: dict[str, torch.Tensor] = {}
    for e in table:
        name = ".".join(e.flax_path)
        out[f"{name}.weight"] = _tensor(sd[f"{e.torch_name}.weight"])
        bias = sd.get(f"{e.torch_name}.bias")
        if bias is not None:
            out[f"{name}.bias"] = _tensor(bias)
    return out


def invert_entry(e: Entry, weight, bias=None) -> dict[str, np.ndarray]:
    """The checkpoint's arrays of entry ``e`` from the port module's weight
    and bias (the layouts agree, so only the names change)."""
    out = {f"{e.torch_name}.weight": np.ascontiguousarray(np.asarray(weight))}
    if bias is not None:
        out[f"{e.torch_name}.bias"] = np.ascontiguousarray(np.asarray(bias))
    return out


def convert_pwcnet(sd: Mapping) -> dict[str, torch.Tensor]:
    return apply_table(sd, pwcnet_table())


def convert_liteflownet(sd: Mapping) -> dict[str, torch.Tensor]:
    return apply_table(sd, liteflownet_table())


def convert_liteflownet3(sd: Mapping) -> dict[str, torch.Tensor]:
    return apply_table(sd, liteflownet3_table())


def convert_raft_small(sd: Mapping) -> dict[str, torch.Tensor]:
    return apply_table(sd, raft_small_table())
