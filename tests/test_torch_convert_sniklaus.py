"""The port's converters of reference torch checkpoints (sniklaus' PWC-Net,
LiteFlowNet and LiteFlowNet3, and RAFT-small under this repo's naming)
against the JAX converters followed by the port's
``flax_to_torch_state_dict``.

The checkpoints are built here from the packaged npz weights with the JAX
package's ``invert_entry`` (the reference's flax -> torch layout), their
``net`` prefixes renamed to the old ``module`` spelling that the
converters undo.  Bar: every tensor bit-equal (the conversions only move
data), and the result equal to the npz's own weights."""
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from opticalflowcontainer_tpu.models import convert as jconvert
from opticalflowcontainer_tpu_torch.models import convert as pconvert
from opticalflowcontainer_tpu_torch.models import (LiteFlowNet, LiteFlowNet3, PWCNet,
                                                   RAFTSmall)

FAMILIES = {
    "pwcnet": (PWCNet, "pwcnet_synth.npz"),
    "liteflownet": (LiteFlowNet, "liteflownet_synth.npz"),
    "liteflownet3": (LiteFlowNet3, "liteflownet3_synth.npz"),
    "raft_small": (RAFTSmall, "raft_small_synth.npz"),
}


def reference_checkpoint(name: str) -> dict:
    """A reference-format state dict of family ``name`` holding its
    packaged npz weights (numpy arrays, ``module``-prefixed names)."""
    flat = pconvert.load_flat_npz(pconvert.WEIGHTS_DIR / FAMILIES[name][1])
    sd = {}
    for e in getattr(jconvert, f"{name}_table")():
        prefix = "/".join(e.flax_path + (("Conv_0",) if e.kind == "conv" else ()))
        sd.update(jconvert.invert_entry(e, flat[f"{prefix}/kernel"],
                                        flat.get(f"{prefix}/bias")))
    return {k.replace("net", "module"): v for k, v in sd.items()}


@pytest.mark.parametrize("name", list(FAMILIES))
def test_converter_equals_jax_then_flax_to_torch(name):
    cls, npz = FAMILIES[name]
    sd = reference_checkpoint(name)
    tree = getattr(jconvert, f"convert_{name}")(sd)
    flat = {"/".join(k): np.asarray(v) for k, v in flatten_dict(tree["params"]).items()}
    want = pconvert.flax_to_torch_state_dict(flat, cls())
    got = getattr(pconvert, f"convert_{name}")(sd)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k
    packaged = pconvert.flax_to_torch_state_dict(
        pconvert.load_flat_npz(pconvert.WEIGHTS_DIR / npz), cls())
    assert all(torch.equal(got[k], packaged[k]) for k in packaged)
    cls().load_state_dict(got)  # strict: every parameter filled


@pytest.mark.parametrize("name", list(FAMILIES))
def test_tables_equal_jax_and_invert_entry_undoes_the_converter(name):
    jt, pt = (getattr(m, f"{name}_table")() for m in (jconvert, pconvert))
    assert [tuple(e) for e in pt] == [tuple(e) for e in jt]
    got = getattr(pconvert, f"convert_{name}")(reference_checkpoint(name))
    back = {}
    for e in pt:
        key = ".".join(e.flax_path)
        back.update(pconvert.invert_entry(e, got[f"{key}.weight"].numpy(),
                                          got[f"{key}.bias"].numpy()
                                          if f"{key}.bias" in got else None))
    again = pconvert.apply_table(back, pt)
    assert all(torch.equal(again[k], got[k]) for k in got)
