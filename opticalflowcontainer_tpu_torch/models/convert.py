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
"""
from __future__ import annotations

import functools
import pathlib

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


def _flax_key(name: str, module: nn.Module, pname: str) -> tuple[str, object]:
    """The flax key of parameter ``pname`` of the module at ``name`` (empty
    for the root) and the map of its array to the parameter's layout."""
    path = name.split(".") if name else []
    if isinstance(module, Deconv):
        prefix, weight_map = path, functools.partial(deconv_weight,
                                                     groups=module.groups)
    elif isinstance(module, AxisConv):
        prefix, weight_map = path, conv_weight
    elif isinstance(module, Conv):
        prefix, weight_map = path + ["Conv_0"], conv_weight
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
