"""The port's LiteFlowNet3 held against the JAX package on the CPU with the
packaged ``liteflownet3_synth.npz``: each stage per level against the JAX
submodule applied with its own parameters (Matching with its confidence
and displacement heads, self-correlation and flow-field deformation,
Subpixel, Regularization with its confidence head), the whole net and
``estimate``.  The converter's LFN3 cases and batched-equals-single are in
``tests/test_torch_liteflownet.py`` beside LiteFlowNet's.  On the CPU the
net's K3 and K4 calls run their plain versions.

Tolerances: 1e-5 of the output's scale per stage, as for LiteFlowNet.  The
whole net is looser than PWC-Net's 1e-4 px mean: LFN3 amplifies fp32
rounding more.  On three seeded 64x64 pairs the JAX net's own fp32 flow
differed from an fp64 evaluation of the same weights by up to 1.4e-4 px
mean and 2.9e-4 px max, the port's by up to 4.4e-5 px mean; two fp32
evaluations may differ by the sum of the two.  LFN3_MEAN_PX allows about
three times that sum; the max keeps PWC-Net's 1e-2 px.
"""
import jax
import numpy as np
import pytest
import torch

from opticalflowcontainer_tpu.models import liteflownet3 as jlfn3
from opticalflowcontainer_tpu_torch.models import convert
from opticalflowcontainer_tpu_torch.models import liteflownet3 as tlfn3
from opticalflowcontainer_tpu_torch.ops import correlation as k4
from opticalflowcontainer_tpu_torch.ops import warp_bilinear as k3
from test_torch_liteflownet import (
    assert_close, hwc_to_nchw, images, level_inputs, nchw_to_hwc, run_stage)
from test_torch_pwcnet import MAX_PX
from test_torch_threads import one_torch_thread  # noqa: F401

LFN3_MEAN_PX = 5e-4


def assert_flow_close(got, want):
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert d.mean() <= LFN3_MEAN_PX and d.max() <= MAX_PX, (d.mean(), d.max())


@pytest.fixture(scope="module")
def jax_lfn3():
    loaded = jlfn3.load_liteflownet3_synth()
    assert loaded is not None, "packaged liteflownet3_synth.npz missing"
    return loaded


@pytest.fixture(scope="module")
def torch_lfn3():
    model = convert.load_liteflownet3_synth(device="cpu")
    assert model is not None, "packaged liteflownet3_synth.npz missing"
    return model


@pytest.mark.parametrize("level", [6, 5, 4, 3])
@pytest.mark.parametrize("stage", ["matching", "subpixel", "regularization"])
def test_stage_matches_jax(stage, level, jax_lfn3, torch_lfn3, rng):
    """Each stage at each level, flow and confidence alike: Matching from
    the coarser level's flow and confidence (none at level 6, the flow
    alone at 5), Subpixel and Regularization at the level's own flow."""
    _, params = jax_lfn3
    f1, f2, coarse, flow, i1, i2 = level_inputs(rng, level)
    jp = params["params"][f"{stage}{level}"]
    tmod = getattr(torch_lfn3, f"{stage}{level}")
    if stage == "matching":
        conf = (rng.uniform(0, 1, (4, 6, 1)).astype(np.float32)
                if level <= 4 else None)
        got, want = run_stage(jlfn3.Matching(level), jp, tmod, f1, f2, coarse, conf)
    elif stage == "subpixel":
        got, want = run_stage(jlfn3.Subpixel(level), jp, tmod, f1, f2, flow)
        got, want = [got], [want]
    else:
        got, want = run_stage(jlfn3.Regularization(level), jp, tmod, i1, i2, f1, flow)
    assert got[0].shape == (8, 12, 2)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert_close(g, w)
    # the confidence leaves Matching at levels 4 and 3 and Regularization
    # at levels 5 and 4
    has_conf = {"matching": level <= 4, "regularization": level in (4, 5),
                "subpixel": False}[stage]
    assert (len(want) == 2 and want[1] is not None) == has_conf


def test_liteflownet3_forward_matches_jax(jax_lfn3, torch_lfn3, rng):
    """The whole net at 64x64: quarter-resolution flow == the reference's;
    on CPU tensors no kernel launches."""
    model, params = jax_lfn3
    a, b = images(rng, 64, 64)
    want = np.asarray(jax.jit(model.apply)(params, a, b))
    before = k3.warp_bilinear.launches, k4.local_correlation.launches
    with torch.inference_mode():
        got = torch_lfn3(hwc_to_nchw(a), hwc_to_nchw(b))
    assert (k3.warp_bilinear.launches, k4.local_correlation.launches) == before
    assert got.shape == (1, 2, 16, 16)
    assert_flow_close(nchw_to_hwc(got), want)


@pytest.mark.parametrize("H,W", [(64, 64), (50, 70)])
def test_estimate_matches_jax(H, W, jax_lfn3, torch_lfn3, rng):
    """``estimate`` (resize to multiples of 32, forward, resize back,
    rescale u and v) == the reference's, at 64x64 and 50x70 (64x96
    inside)."""
    model, params = jax_lfn3
    a, b = images(rng, H, W)
    want = np.asarray(jlfn3.estimate(model, params, a, b))
    got = tlfn3.estimate(torch_lfn3, a, b)
    assert got.shape == (H, W, 2)
    assert_flow_close(got.numpy(), want)
