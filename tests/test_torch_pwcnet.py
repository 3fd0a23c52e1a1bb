"""The port's PWC-Net slice held against the JAX package on the CPU: the
building blocks (``Conv``, ``Deconv``), the weight converter on the packaged
``pwcnet_synth.npz``, the whole net and ``estimate`` with those weights, and
the learned-model stream backend.  On the CPU the net's K3 and K4 calls run
their plain versions.  Inputs are made with numpy from a seed.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from opticalflowcontainer_tpu.models import common as jcommon
from opticalflowcontainer_tpu.models import pwcnet as jpwc
from opticalflowcontainer_tpu.runtime import nodes as jnodes
from opticalflowcontainer_tpu_torch.models import common as tcommon
from opticalflowcontainer_tpu_torch.models import convert
from opticalflowcontainer_tpu_torch.models import pwcnet as tpwc
from opticalflowcontainer_tpu_torch.ops import correlation as k4
from opticalflowcontainer_tpu_torch.ops import warp_bilinear as k3
from opticalflowcontainer_tpu_torch.runtime import nodes as tnodes
from test_torch_threads import one_torch_thread  # noqa: F401

NPZ = convert.WEIGHTS_DIR / "pwcnet_synth.npz"
# Whole-net bounds, in px.  Measured ~2e-6 mean and ~1e-5 max (64x64 and
# 50x70): fp32 convolutions summed in another order.  The max is looser
# because the masked warp's hard 0.999 threshold can flip a pixel whose
# in-image weight is within rounding of it, changing that pixel's features.
MEAN_PX, MAX_PX = 1e-4, 1e-2


@pytest.fixture(scope="module")
def jax_pwc():
    loaded = jpwc.load_pwcnet_synth()
    assert loaded is not None, f"packaged weights missing: {NPZ}"
    return loaded


@pytest.fixture(scope="module")
def torch_pwc():
    model = convert.load_pwcnet_synth(device="cpu")
    assert model is not None, f"packaged weights missing: {NPZ}"
    return model


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _flat(params):
    """flax params as flat ``a/b/c`` keys, the npz checkpoint format."""
    leaves = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    return {"/".join(k.key for k in path): np.asarray(v) for path, v in leaves}


def _perturbed_init(module, x):
    """flax params with nonzero biases, so the bias carry-over is tested."""
    params = module.init(jax.random.PRNGKey(0), x)
    return jax.tree_util.tree_map(
        lambda p: p + 0.1 * jax.random.normal(jax.random.PRNGKey(1), p.shape),
        params)


def _images(rng, H, W):
    a = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    return a, np.roll(a, (1, 2), (0, 1))


def _assert_flow_close(got, want):
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert d.mean() <= MEAN_PX and d.max() <= MAX_PX, (d.mean(), d.max())


@pytest.mark.parametrize("kernel,stride,dilation,padding", [
    (3, 1, 1, None), (3, 2, 1, None), (3, 1, 4, None), (1, 1, 1, 0),
    (7, 1, 1, None)])
def test_conv_matches_flax(kernel, stride, dilation, padding, rng):
    """``Conv`` (strided, dilated, 1x1, 7x7) with converted weights == the
    reference's flax ``Conv`` on an odd-sized input.  Tolerance 1e-5 of
    the output's scale: fp32 sums of up to 7*7*6 products in another
    order."""
    x = rng.standard_normal((2, 12, 15, 6)).astype(np.float32)
    jmod = jcommon.Conv(5, kernel=kernel, stride=stride, padding=padding,
                        dilation=dilation)
    params = _perturbed_init(jmod, x)
    want = np.asarray(jmod.apply(params, x))
    tmod = tcommon.Conv(6, 5, kernel=kernel, stride=stride, padding=padding,
                        dilation=dilation)
    tmod.load_state_dict(convert.flax_to_torch_state_dict(_flat(params), tmod))
    with torch.no_grad():
        got = tmod(_nchw(x)).numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("H,W", [(5, 7), (8, 8)])
def test_deconv_matches_flax(H, W, rng):
    """``Deconv`` with the kernel carried back from the reference's flipped
    HWIO form == the reference's flax ``Deconv`` (2x upsampling).
    Tolerance as above."""
    x = rng.standard_normal((2, H, W, 6)).astype(np.float32)
    jmod = jcommon.Deconv(3)
    params = _perturbed_init(jmod, x)
    want = np.asarray(jmod.apply(params, x))
    tmod = tcommon.Deconv(6, 3)
    tmod.load_state_dict(convert.flax_to_torch_state_dict(_flat(params), tmod))
    with torch.no_grad():
        got = tmod(_nchw(x)).numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 2 * H, 2 * W, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_packaged_weights_use_every_key_once():
    """All 126 arrays of pwcnet_synth.npz fill the 126 parameters of the
    port's PWCNet, one key each, with the deconv kernels carried back."""
    flat = convert.load_flat_npz(NPZ)
    model = tpwc.PWCNet()
    sd = convert.flax_to_torch_state_dict(flat, model)
    assert len(flat) == len(sd) == len(model.state_dict()) == 126
    assert set(sd) == set(model.state_dict())
    np.testing.assert_array_equal(
        sd["decoder2.upfeat.weight"].numpy(),
        np.transpose(flat["decoder2/upfeat/kernel"], (2, 3, 0, 1))[:, :, ::-1, ::-1])
    np.testing.assert_array_equal(
        sd["refiner.conv6.weight"].numpy(),
        np.transpose(flat["refiner/conv6/Conv_0/kernel"], (3, 2, 0, 1)))


@pytest.mark.parametrize("fault", ["extra", "missing", "shape"])
def test_converter_refuses_a_mismatched_checkpoint(fault):
    flat = convert.load_flat_npz(NPZ)
    if fault == "extra":
        flat["decoder2/extra/kernel"] = np.zeros(1, np.float32)
        err, match = ValueError, "unused"
    elif fault == "missing":
        del flat["decoder3/dense1/Conv_0/bias"]
        err, match = KeyError, "decoder3/dense1/Conv_0/bias"
    else:
        flat["decoder4/upflow/kernel"] = np.zeros((3, 3, 2, 2), np.float32)
        err, match = ValueError, "shape"
    with pytest.raises(err, match=match):
        convert.flax_to_torch_state_dict(flat, tpwc.PWCNet())


def test_load_returns_none_without_the_file(monkeypatch, tmp_path):
    monkeypatch.setattr(convert, "WEIGHTS_DIR", tmp_path)
    assert convert.load_pwcnet_synth(device="cpu") is None


def test_pwcnet_forward_matches_jax(jax_pwc, torch_pwc, rng):
    """The whole net at 64x64 with the packaged weights: quarter-resolution
    flow == the reference's (bounds MEAN_PX, MAX_PX above)."""
    model, params = jax_pwc
    a, b = _images(rng, 64, 64)
    want = np.asarray(jpwc._run(model, params, a, b))
    k3_before, k4_before = k3.warp_bilinear.launches, k4.local_correlation.launches
    with torch.inference_mode():
        got = torch_pwc(_nchw(a[None]), _nchw(b[None]))
    assert (k3.warp_bilinear.launches, k4.local_correlation.launches) == (
        k3_before, k4_before)  # CPU tensors: the plain versions
    _assert_flow_close(got[0].numpy().transpose(1, 2, 0), want)


@pytest.mark.parametrize("H,W", [(64, 64), (50, 70)])
def test_estimate_matches_jax(H, W, jax_pwc, torch_pwc, rng):
    """``estimate`` (resize to multiples of 64, forward, resize back,
    rescale u and v) == the reference's, at 64x64 and at the odd 50x70 of
    tests/test_models.py (bounds MEAN_PX, MAX_PX above)."""
    model, params = jax_pwc
    a, b = _images(rng, H, W)
    want = np.asarray(jpwc.estimate(model, params, a, b))
    got = tpwc.estimate(torch_pwc, a, b)
    assert got.shape == (H, W, 2)
    _assert_flow_close(got.numpy(), want)


def test_estimate_batched_equals_single(torch_pwc, rng):
    """[B, H, W, 3] in, [B, H, W, 2] out, each row the single pair's flow.
    Tolerance 1e-5 px: the same net, convolutions batched differently."""
    pairs = [_images(rng, 50, 70) for _ in range(2)]
    batch = tpwc.estimate(torch_pwc, np.stack([p[0] for p in pairs]),
                          np.stack([p[1] for p in pairs]))
    assert batch.shape == (2, 50, 70, 2)
    for i, (a, b) in enumerate(pairs):
        np.testing.assert_allclose(batch[i].numpy(),
                                   tpwc.estimate(torch_pwc, a, b).numpy(),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("colour", ["bgr", "rgb", "gray"])
def test_model_backend_matches_jax(colour, jax_pwc, torch_pwc, rng):
    """``make_model_backend`` on two uint8 frames (BGR kept, flipped to RGB,
    or gray stacked to 3 channels) == the reference's backend (bounds
    MEAN_PX, MAX_PX above); the flow comes back as numpy [H, W, 2]."""
    model, params = jax_pwc
    shape = (50, 70) if colour == "gray" else (50, 70, 3)
    prev = rng.integers(0, 256, shape, dtype=np.uint8)
    cur = np.roll(prev, 2, 1)
    rgb = colour == "rgb"
    jb = jnodes.make_model_backend(functools.partial(jpwc.estimate, model, params),
                                   bgr_to_rgb=rgb)
    tb = tnodes.make_model_backend(functools.partial(tpwc.estimate, torch_pwc),
                                   bgr_to_rgb=rgb, device="cpu")
    assert tb.wants_color
    got = tb(prev, cur, 1 / 30)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    _assert_flow_close(got, jb(prev, cur, 1 / 30))


def test_model_backend_needs_a_card_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tnodes.make_model_backend(lambda a, b: a)
