"""The port's LiteFlowNet held against the JAX package on the CPU: the new
building blocks (grouped and bias-free ``Deconv``, the one-axis
``AxisConv``, the Regularization's neighbourhood sum), the converter on the
packaged ``liteflownet_synth.npz`` and ``liteflownet3_synth.npz``, each
stage per level against the JAX submodule applied with its own parameters,
the whole net and ``estimate``.  On the CPU the net's K3 and K4 calls run
their plain versions.  Inputs are made with numpy from a seed.

Tolerances: 1e-5 of the output's scale for layers and stages (fp32 sums
in another order; measured up to ~1e-6 of it); for the whole net and
``estimate``, PWC-Net's bounds (``tests/test_torch_pwcnet.py``), which the
measured ~1e-6 px mean and ~4e-6 px max sit well inside.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowcontainer_tpu.models import common as jcommon
from opticalflowcontainer_tpu.models import liteflownet as jlfn
from opticalflowcontainer_tpu.ops import unfold as junfold  # the function
from opticalflowcontainer_tpu_torch.models import common as tcommon
from opticalflowcontainer_tpu_torch.models import convert
from opticalflowcontainer_tpu_torch.models import liteflownet as tlfn
from opticalflowcontainer_tpu_torch.models import liteflownet3 as tlfn3
from opticalflowcontainer_tpu_torch.ops.unfold import neighbourhood_sum
from test_torch_pwcnet import MAX_PX, MEAN_PX, _flat, _nchw, _perturbed_init
from test_torch_threads import one_torch_thread  # noqa: F401

LAYER_TOL = 1e-5
# (file, model class, npz keys) of the two packaged LiteFlowNet checkpoints
PACKAGED = {"liteflownet": ("liteflownet_synth.npz", tlfn.LiteFlowNet, 212),
            "liteflownet3": ("liteflownet3_synth.npz", tlfn3.LiteFlowNet3, 249)}


@pytest.fixture(scope="module")
def jax_lfn():
    loaded = jlfn.load_liteflownet_synth()
    assert loaded is not None, "packaged liteflownet_synth.npz missing"
    return loaded


@pytest.fixture(scope="module")
def torch_lfn():
    model = convert.load_liteflownet_synth(device="cpu")
    assert model is not None, "packaged liteflownet_synth.npz missing"
    return model


def hwc_to_nchw(a):
    """[H, W, C] numpy -> [1, C, H, W] tensor (None stays None)."""
    return None if a is None else _nchw(a[None])


def nchw_to_hwc(t):
    return t[0].numpy().transpose(1, 2, 0)


def assert_close(got, want, tol=LAYER_TOL):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def assert_flow_close(got, want):
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert d.mean() <= MEAN_PX and d.max() <= MAX_PX, (d.mean(), d.max())


def images(rng, H, W):
    a = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    return a, np.roll(a, (1, 2), (0, 1))


def run_stage(jmod, jparams, tmod, *inputs):
    """A JAX stage applied with its own parameters and the port's stage, on
    the same [H, W, C] inputs (None passed through); both outputs as
    numpy, tuples kept."""
    want = jmod.apply({"params": jparams}, *inputs)
    with torch.inference_mode():
        got = tmod(*(hwc_to_nchw(x) for x in inputs))
    if isinstance(want, tuple):
        return ([None if g is None else nchw_to_hwc(g) for g in got],
                [None if w is None else np.asarray(w) for w in want])
    return nchw_to_hwc(got), np.asarray(want)


def level_inputs(rng, level, h=8, w=12):
    """feat1, feat2 [h, w, C] (the trunk's channels at ``level``, leaky
    outputs in [0, 1)), the coarser level's flow [h/2, w/2, 2] (None at
    level 6), this level's flow [h, w, 2], in the net's /20 units, and two
    images [h, w, 3]."""
    C = tlfn.FEATURE_CH[level - 1]
    f1, f2 = (rng.uniform(0, 1, (h, w, C)).astype(np.float32) for _ in range(2))
    coarse = (None if level == 6 else
              rng.uniform(-0.3, 0.3, (h // 2, w // 2, 2)).astype(np.float32))
    flow = rng.uniform(-0.3, 0.3, (h, w, 2)).astype(np.float32)
    i1, i2 = (rng.uniform(0, 1, (h, w, 3)).astype(np.float32) for _ in range(2))
    return f1, f2, coarse, flow, i1, i2


@pytest.mark.parametrize("cin,cout,groups,bias", [
    (2, 2, 2, False), (49, 49, 49, False), (1, 1, 1, False), (6, 4, 2, True)])
@pytest.mark.parametrize("H,W", [(5, 7), (8, 8)])
def test_grouped_deconv_matches_flax(cin, cout, groups, bias, H, W, rng):
    """``Deconv`` grouped (LiteFlowNet's upflow, groups 2, and upcorr,
    groups 49; a grouped one with 2 channels a group) and bias-free (LFN3's
    single-channel upconf), the kernel carried back from the reference's
    flipped grouped HWIO form == the flax ``Deconv``."""
    x = rng.standard_normal((2, H, W, cin)).astype(np.float32)
    jmod = jcommon.Deconv(cout, use_bias=bias, groups=groups)
    params = _perturbed_init(jmod, x)
    want = np.asarray(jmod.apply(params, x))
    tmod = tcommon.Deconv(cin, cout, bias=bias, groups=groups)
    tmod.load_state_dict(convert.flax_to_torch_state_dict(_flat(params), tmod))
    with torch.no_grad():
        got = tmod(_nchw(x)).numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 2 * H, 2 * W, cout)
    assert_close(got, want)


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("axis", ["v", "h"])
def test_axis_conv_matches_flax(k, axis, rng):
    """``AxisConv`` (k x 1 padded (k//2, 0), or 1 x k padded (0, k//2))
    with the weights of a bare flax ``nn.Conv`` (keys without ``Conv_0``)
    == that conv, on an odd-sized input."""
    import flax.linen as nn

    x = rng.standard_normal((2, 9, 13, 6)).astype(np.float32)
    p = k // 2
    shape, pad = ((k, 1), ((p, p), (0, 0))) if axis == "v" else ((1, k), ((0, 0), (p, p)))
    jmod = nn.Conv(5, shape, padding=pad)
    params = _perturbed_init(jmod, x)
    want = np.asarray(jmod.apply(params, x))
    tmod = tcommon.AxisConv(6, 5, shape)
    flat = _flat(params)
    assert set(flat) == {"kernel", "bias"}
    tmod.load_state_dict(convert.flax_to_torch_state_dict(flat, tmod))
    with torch.no_grad():
        got = tmod(_nchw(x)).numpy().transpose(0, 2, 3, 1)
    assert_close(got, want)


@pytest.mark.parametrize("k", [3, 5, 7])
def test_neighbourhood_sum_matches_jax_unfold(k, rng):
    """The tap-by-tap weighted sum == the reference's materialized form:
    ``unfold`` of the flow, times the weights, through a 1x1 conv per
    channel (weights per tap and a bias), on a 2-image batch whose borders
    take the zero padding."""
    B, H, W = 2, 9, 11
    flow = rng.standard_normal((B, H, W, 2)).astype(np.float32)
    weights = rng.uniform(0, 1, (B, H, W, k * k)).astype(np.float32)
    taps = rng.standard_normal((2, k * k)).astype(np.float32)
    bias = rng.standard_normal(2).astype(np.float32)
    un = junfold(jnp.asarray(flow), k)  # [B, H, W, k*k, 2]
    want = np.stack([np.asarray((weights * un[..., c]) @ taps[c] + bias[c])
                     for c in range(2)], -1)
    got = neighbourhood_sum(_nchw(flow), _nchw(weights), torch.from_numpy(taps),
                            torch.from_numpy(bias))
    assert_close(got.numpy().transpose(0, 2, 3, 1), want)
    with pytest.raises(ValueError, match="odd k x k"):
        neighbourhood_sum(_nchw(flow), _nchw(weights[..., :8]),
                          torch.from_numpy(taps[:, :8]), torch.from_numpy(bias))


def test_features_match_jax(jax_lfn, torch_lfn, rng):
    """The shared trunk's six levels at 64 x 96."""
    _, params = jax_lfn
    x = rng.uniform(-0.5, 0.5, (64, 96, 3)).astype(np.float32)
    want = jlfn.Features().apply({"params": params["params"]["features"]}, x)
    with torch.inference_mode():
        got = torch_lfn.features(hwc_to_nchw(x))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert_close(nchw_to_hwc(g), np.asarray(w))


@pytest.mark.parametrize("level", [6, 5, 4, 3, 2])
@pytest.mark.parametrize("stage", ["matching", "subpixel", "regularization"])
def test_stage_matches_jax(stage, level, jax_lfn, torch_lfn, rng):
    """Each stage at each level with the packaged weights, so that a fault
    names its layer: Matching from the coarser level's flow (none at level
    6; the strided correlation and 49-group upsample at levels 2-3),
    Subpixel and Regularization at the level's own flow."""
    _, params = jax_lfn
    f1, f2, coarse, flow, i1, i2 = level_inputs(rng, level)
    jp = params["params"][f"{stage}{level}"]
    tmod = getattr(torch_lfn, f"{stage}{level}")
    if stage == "matching":
        got, want = run_stage(jlfn.Matching(level), jp, tmod, f1, f2, coarse)
    elif stage == "subpixel":
        got, want = run_stage(jlfn.Subpixel(level), jp, tmod, f1, f2, flow)
    else:
        got, want = run_stage(jlfn.Regularization(level), jp, tmod, i1, i2, f1, flow)
    assert got.shape == (8, 12, 2)
    assert_close(got, want)


def test_liteflownet_forward_matches_jax(jax_lfn, torch_lfn, rng):
    """The whole net at 64x64: half-resolution flow == the reference's."""
    model, params = jax_lfn
    a, b = images(rng, 64, 64)
    want = np.asarray(jax.jit(model.apply)(params, a, b))
    with torch.inference_mode():
        got = torch_lfn(hwc_to_nchw(a), hwc_to_nchw(b))
    assert got.shape == (1, 2, 32, 32)
    assert_flow_close(nchw_to_hwc(got), want)


@pytest.mark.parametrize("H,W", [(64, 64), (50, 70)])
def test_estimate_matches_jax(H, W, jax_lfn, torch_lfn, rng):
    """``estimate`` (resize to multiples of 32, forward, resize back,
    rescale u and v) == the reference's, at 64x64 and 50x70 (64x96
    inside)."""
    model, params = jax_lfn
    a, b = images(rng, H, W)
    want = np.asarray(jlfn.estimate(model, params, a, b))
    got = tlfn.estimate(torch_lfn, a, b)
    assert got.shape == (H, W, 2)
    assert_flow_close(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(PACKAGED))
def test_batched_equals_single(name, rng):
    """[2, H, W, 3] in, each row the single pair's flow, for two different
    pairs: a mean taken over the batch (LFN3's image means, both nets'
    flow means in Regularization) would mix them.  Tolerance 1e-5 px: the
    same net, convolutions batched differently."""
    _, cls, _ = PACKAGED[name]
    model = getattr(convert, f"load_{name}_synth")(device="cpu")
    est = tlfn.estimate if cls is tlfn.LiteFlowNet else tlfn3.estimate
    pairs = [images(rng, 64, 64), tuple(np.clip(x * 0.5 + 0.4, 0, 1)
                                        for x in images(rng, 64, 64))]
    batch = est(model, np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]))
    assert batch.shape == (2, 64, 64, 2)
    for i, (a, b) in enumerate(pairs):
        np.testing.assert_allclose(batch[i].numpy(), est(model, a, b).numpy(),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", sorted(PACKAGED))
def test_packaged_weights_use_every_key_once(name):
    """Every array of the npz fills one parameter of the port's net, the
    grouped deconvs and the bare one-axis convs carried back."""
    fname, cls, n_keys = PACKAGED[name]
    flat = convert.load_flat_npz(convert.WEIGHTS_DIR / fname)
    model = cls()
    sd = convert.flax_to_torch_state_dict(flat, model)
    assert len(flat) == len(sd) == len(model.state_dict()) == n_keys
    np.testing.assert_array_equal(
        sd["matching3.upflow.weight"].numpy(),
        np.transpose(flat["matching3/upflow/kernel"], (3, 2, 0, 1))[:, :, ::-1, ::-1])
    np.testing.assert_array_equal(
        sd["regularization3.dist_v.weight"].numpy(),
        np.transpose(flat["regularization3/dist_v/kernel"], (3, 2, 0, 1)))


@pytest.mark.parametrize("name", sorted(PACKAGED))
@pytest.mark.parametrize("fault", ["extra", "missing", "shape"])
def test_converter_refuses_a_mismatched_checkpoint(name, fault):
    fname, cls, _ = PACKAGED[name]
    flat = convert.load_flat_npz(convert.WEIGHTS_DIR / fname)
    if fault == "extra":
        flat["matching3/extra/kernel"] = np.zeros(1, np.float32)
        err, match = ValueError, "unused"
    elif fault == "missing":
        del flat["regularization4/dist_h/bias"]
        err, match = KeyError, "regularization4/dist_h/bias"
    else:
        flat["matching4/upflow/kernel"] = np.zeros((4, 4, 2, 2), np.float32)
        err, match = ValueError, "shape"
    with pytest.raises(err, match=match):
        convert.flax_to_torch_state_dict(flat, cls())


@pytest.mark.parametrize("name", sorted(PACKAGED))
def test_load_returns_none_without_the_file(name, monkeypatch, tmp_path):
    monkeypatch.setattr(convert, "WEIGHTS_DIR", tmp_path)
    assert getattr(convert, f"load_{name}_synth")(device="cpu") is None
