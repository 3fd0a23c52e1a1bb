"""The frozen references against the port's plain paths at small sizes on
the CPU (a test may import both; the references import nothing of the
port), and the references' lower-precision controls."""
import ast
import pathlib

import numpy as np
import pytest
import torch

from opticalflowcontainer_tpu_torch.classical.farneback import (
    calc_optical_flow_farneback, farneback_clip)
from opticalflowcontainer_tpu_torch.models import convert, pwcnet
from portbench import frames
from portbench.reference import farneback as rf
from portbench.reference import pwcnet as rp
from portbench.systems.pwcnet import ROOT

HERE = pathlib.Path(__file__).resolve().parents[1]
PARAMS = {"pyr_scale": 0.5, "levels": 3, "winsize": 15, "iterations": 3,
          "poly_n": 5, "poly_sigma": 1.2, "flags": 0}
NPZ = ROOT / "opticalflowcontainer_tpu" / "models" / "weights" / "pwcnet_synth.npz"
FORBIDDEN = ("jax", "jaxlib", "flax", "opticalflowcontainer_tpu",
             "opticalflowcontainer_tpu_torch", "portbench")


def _pool(h, w, channels, streams=1, n=8, seed=5):
    return frames.make_pool({"pool": n, "height": h, "width": w,
                             "channels": channels, "streams": streams,
                             "max_shift_px": 2.0}, seed, "cpu")


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"{path.name}: a relative import"
            mods.add(node.module)
    assert not [m for m in mods if m.split(".")[0] in FORBIDDEN]


@pytest.mark.parametrize("hw", [(72, 96), (61, 83)])
def test_farneback_reference_matches_the_port_clip(hw):
    clip = _pool(*hw, 1, n=5)
    port = farneback_clip(clip, device="cpu", **PARAMS)
    ref = rf.farneback_pairs(torch.from_numpy(clip[:-1]),
                             torch.from_numpy(clip[1:]), PARAMS)
    epe = (port - ref).norm(dim=-1)
    assert float(epe.mean()) < 1e-5 and float(epe.max()) < 1e-3
    assert float(port.norm(dim=-1).mean()) > 0.3  # the frames move


def test_farneback_reference_matches_the_port_on_two_cameras():
    clip = _pool(64, 80, 1, streams=2, n=4)
    port = farneback_clip(clip, device="cpu", **PARAMS)
    pair = calc_optical_flow_farneback(clip[1, 1], clip[2, 1], device="cpu", **PARAMS)
    ref = rf.farneback_pairs(torch.from_numpy(clip[:-1].reshape(-1, 64, 80)),
                             torch.from_numpy(clip[1:].reshape(-1, 64, 80)), PARAMS)
    assert float((port.reshape(ref.shape) - ref).norm(dim=-1).mean()) < 1e-5
    assert float((pair - ref[3]).norm(dim=-1).mean()) < 1e-5


def test_farneback_control_is_bf16_storage():
    x = torch.tensor([1.0 + 2 ** -9, 3.0])
    assert rf.bf16_store(x).tolist() == [1.0, 3.0]
    clip = _pool(72, 96, 1, n=3)
    a, b = torch.from_numpy(clip[:-1]), torch.from_numpy(clip[1:])
    gap = (rf.farneback_pairs(a, b, PARAMS, rf.bf16_store)
           - rf.farneback_pairs(a, b, PARAMS)).norm(dim=-1).mean()
    assert float(gap) > 1e-3


def test_tf32_round():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -(1.0 + 2 ** -10),
                      1.0 + 2 ** -12])
    assert rp.tf32_round(x).tolist() == [1.0, 1.0 + 2 ** -9, -(1.0 + 2 ** -10), 1.0]


@pytest.fixture(scope="module")
def nets():
    return (convert.load_pwcnet_synth(device="cpu"),
            rp.PWCNetRef(rp.load_weights(NPZ, "cpu")))


@pytest.mark.parametrize("hw", [(64, 64), (50, 70)])
def test_pwcnet_reference_matches_the_port(nets, hw):
    model, ref = nets
    pool = _pool(*hw, 3, n=3)
    x = torch.from_numpy(pool).float() * (1.0 / 255.0)
    port = pwcnet.estimate(model, x[:-1], x[1:])
    want = ref.estimate(x[:-1], x[1:])
    assert port.shape == want.shape == (2,) + hw + (2,)
    assert float((port - want).norm(dim=-1).mean()) < 1e-4
    tf32 = rp.PWCNetRef(ref.w, rp.tf32_round).estimate(x[:-1], x[1:])
    assert float((tf32 - want).norm(dim=-1).mean()) > 1e-3
