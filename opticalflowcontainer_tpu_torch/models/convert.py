"""Carry the reference's flax weights (flat npz, ``a/b/c`` keys) into the
port's modules (reference ``models/common.py`` ``load_flat_npz`` and
``models/raft.py`` ``_load_weights_npz``).

Names map one to one: the module at ``decoder2.dense0`` takes the flax
parameters under ``decoder2/dense0``.  A :class:`~.common.Conv` wraps a
flax ``nn.Conv`` (keys ``<path>/Conv_0/kernel`` HWIO -> OIHW); a
:class:`~.common.Deconv` stores the flipped HWIO kernel of the equivalent
input-dilated conv (``<path>/kernel``), the inverse of the reference's
``convert_torch_deconv``: transpose to (Cin, Cout, kH, kW), then flip back.
"""
from __future__ import annotations

import pathlib

import numpy as np
import torch
from torch import nn

from ..core.device import resolve_device
from .common import Conv, Deconv
from .pwcnet import PWCNet

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


def deconv_weight(kernel: np.ndarray) -> np.ndarray:
    """The reference Deconv's flipped HWIO kernel -> torch ConvTranspose2d's
    (Cin, Cout, kH, kW)."""
    return np.transpose(kernel, (2, 3, 0, 1))[:, :, ::-1, ::-1]


def _flax_prefix(name: str, module: nn.Module) -> tuple[list[str], object] | None:
    """The flax key path of a module's parameters (empty for the root) and
    the map of its kernel, or None for a module without parameters of its
    own."""
    path = name.split(".") if name else []
    if isinstance(module, Deconv):
        return path, deconv_weight
    if isinstance(module, Conv):
        return path + ["Conv_0"], conv_weight
    return None


def flax_to_torch_state_dict(flat: dict[str, np.ndarray],
                             model: nn.Module) -> dict[str, torch.Tensor]:
    """The state dict of ``model`` from the flat flax parameters ``flat``.

    Raises on a parameter with no npz key, a shape mismatch, a module
    parameter left unfilled, or an npz key left unused."""
    out: dict[str, torch.Tensor] = {}
    used: set[str] = set()
    for name, module in model.named_modules():
        found = _flax_prefix(name, module)
        if found is None:
            continue
        prefix, weight_map = found
        for pname, param in module.named_parameters(recurse=False):
            key = "/".join(prefix + ["kernel" if pname == "weight" else pname])
            if key not in flat:
                raise KeyError(f"{name}.{pname}: no key {key!r} in the npz")
            arr = flat[key]
            if pname == "weight":
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


def load_pwcnet_synth(device=None) -> PWCNet | None:
    """The port's :class:`PWCNet` with the packaged ``pwcnet_synth.npz``
    weights, in eval mode on ``device`` (the card unless ``"cpu"`` is asked
    for), or None when the file is absent."""
    path = WEIGHTS_DIR / "pwcnet_synth.npz"
    if not path.exists():
        return None
    model = PWCNet()
    model.load_state_dict(flax_to_torch_state_dict(load_flat_npz(path), model))
    return model.to(resolve_device(device)).eval()
