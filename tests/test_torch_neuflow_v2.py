"""The port's NeuFlow-v2 held against the JAX package on the CPU with the
packaged ``neuflow_v2_synth.npz``: ``_pos_embed_2d``, and ``BackboneV2``,
``CrossAttention``, ``global_matching_flow``, ``FlowAttention``,
``RefineBlock`` and ``ConvexUpsample`` against the flax modules with the
same parameters; the net and ``estimate`` at 64x64 and 50x70 and at
``iters_s8`` other than 8; the loader; and ``convert_neuflow_v2`` against
the reference's converter on a torch checkpoint with the published
model's module prefixes, and on the three faults it refuses.  Inputs are
made with numpy from a seed; each JAX reference is computed once, in a
module-scoped fixture.

Tolerances: a module's output within 1e-5 of its largest value (fp32 sums
in another order, as ``tests/test_torch_pwcnet.py``).  The whole net and
``estimate``: the flow within 1e-5 px mean and 2e-4 px max of JAX's
(measured 4.8e-7 to 5.3e-7 px mean and 2.5e-6 to 2.6e-6 px max on flows of
~1.8 px mean and 3.1 px max: fp32 rounding through the attention, the
global softmax and nine recurrent steps, RAFT's bars).
"""
import jax
import numpy as np
import pytest
import torch

from opticalflowcontainer_tpu.models import neuflow_v2 as jv2
from opticalflowcontainer_tpu_torch.models import convert
from opticalflowcontainer_tpu_torch.models import neuflow_v2 as tv2
from test_torch_neuflow import assert_close, assert_flow_close, nchw, smooth_pair
from test_torch_threads import one_torch_thread  # noqa: F401

N_KEYS, N_PARAMS = 72, 3_665_492
# the published model's module prefixes for each flax module
# (``_GROUP_MAP``'s aliases)
OFFICIAL_PREFIX = {"backbone": "backbone", "cross_attn": "transformer",
                   "flow_attn": "flow_attn", "refine16": "refine_s16",
                   "refine8": "refine_s8", "init_h16": "conv_s16",
                   "init_h8": "conv_s8", "up": "upsample"}



@pytest.fixture(scope="module")
def nets():
    jm, tm = jv2.load_neuflow_v2_synth(), convert.load_neuflow_v2_synth(device="cpu")
    assert jm is not None and tm is not None, "packaged neuflow_v2_synth.npz missing"
    return jm, tm


@pytest.fixture(scope="module")
def pairs():
    rng = np.random.default_rng(0)
    return {(H, W): smooth_pair(rng, H, W) for H, W in ((64, 64), (50, 70))}


@pytest.fixture(scope="module")
def jax_estimates(nets, pairs):
    """JAX ``estimate`` on each pair at iters_s8 8, and at 3 on 64x64,
    computed once."""
    (jm, jp), _ = nets
    out = {(hw, 8): np.asarray(jv2.estimate(jm, jp, a, b)) for hw, (a, b) in pairs.items()}
    a, b = pairs[(64, 64)]
    out[((64, 64), 3)] = np.asarray(jv2.estimate(jm, jp, a, b, iters_s8=3))
    return out


def sub(jp, name):
    return {"params": jp["params"][name]}


def feats(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("H,W,dim", [(27, 48, 128), (5, 7, 10), (3, 4, 2)])
def test_pos_embed_equals_jax(H, W, dim):
    """The same float64 sines rounded to fp32; dims not a multiple of 4
    zero-padded."""
    np.testing.assert_array_equal(tv2._pos_embed_2d(H, W, dim), jv2._pos_embed_2d(H, W, dim))


def test_backbone_matches_flax(nets, pairs):
    (_, jp), tm = nets
    a, _ = pairs[(64, 64)]
    img = a * 2.0 - 1.0
    w8, w16 = jv2.BackboneV2().apply(sub(jp, "backbone"), img)
    with torch.inference_mode():
        s8, s16 = tm.backbone(nchw(img[None]))
    assert_close(s8[0].numpy(), np.moveaxis(np.asarray(w8), -1, 0))
    assert_close(s16[0].numpy(), np.moveaxis(np.asarray(w16), -1, 0))


def test_cross_attention_matches_flax(nets):
    """Queries from one feature map, keys and values from another, the
    position embedding on both, post-norm with flax's eps 1e-6 and the
    tanh GELU."""
    (_, jp), tm = nets
    q, kv = feats(1, 4, 6, 128), feats(2, 4, 6, 128)
    want = np.asarray(jv2.CrossAttention(128, 1).apply(sub(jp, "cross_attn"), q, kv))
    with torch.inference_mode():
        got = tm.cross_attn(nchw(q[None]), nchw(kv[None]))
    assert_close(got[0].numpy(), np.moveaxis(want, -1, 0))


def test_global_matching_flow_matches_jax():
    """Parameter free: features of a shifted random field, so that the
    softmax peaks."""
    f1 = feats(3, 6, 8, 32) * 2.0
    f2 = np.roll(f1, 2, axis=1)
    want = np.asarray(jv2.global_matching_flow(f1, f2))
    got = tv2.global_matching_flow(nchw(f1[None]), nchw(f2[None]))
    assert_close(got[0].numpy(), np.moveaxis(want, -1, 0))
    assert np.abs(want[..., 0]).max() > 1.0


def test_flow_attention_matches_flax(nets):
    (_, jp), tm = nets
    f, flow = feats(4, 4, 6, 128), feats(5, 4, 6, 2) * 3.0
    want = np.asarray(jv2.FlowAttention().apply(sub(jp, "flow_attn"), f, flow))
    with torch.inference_mode():
        got = tm.flow_attn(nchw(f[None]), nchw(flow[None]))
    assert_close(got[0].numpy(), np.moveaxis(want, -1, 0))


def test_refine_block_matches_flax(nets):
    """One recurrent step of ``refine8``: a K3 warp at flows of a few px
    (taps leave the 8 x 12 map) and the radius-4 K4 correlation."""
    (_, jp), tm = nets
    h = np.tanh(feats(6, 8, 12, 128))
    f1, f2 = feats(7, 8, 12, 128), feats(8, 8, 12, 128)
    flow = feats(9, 8, 12, 2) * 3.0
    wh, wflow = jv2.RefineBlock(128, 4).apply(sub(jp, "refine8"), h, f1, f2, flow)
    with torch.inference_mode():
        gh, gflow = tm.refine8(*(nchw(x[None]) for x in (h, f1, f2, flow)))
    assert gflow.dtype == torch.float32
    assert_close(gh[0].numpy(), np.moveaxis(np.asarray(wh), -1, 0))
    assert_close(gflow[0].numpy(), np.moveaxis(np.asarray(wflow), -1, 0))


def test_convex_upsample_matches_flax(nets):
    (_, jp), tm = nets
    flow, h = feats(10, 5, 7, 2) * 2.0, np.tanh(feats(11, 5, 7, 128))
    want = np.asarray(jv2.ConvexUpsample().apply(sub(jp, "up"), flow, h))
    with torch.inference_mode():
        got = tm.up(nchw(flow[None]), nchw(h[None]))
    assert got.shape == (1, 2, 40, 56)
    assert_close(got[0].numpy(), np.moveaxis(want, -1, 0))


@pytest.mark.parametrize("H,W,iters", [(64, 64, 8), (50, 70, 8), (64, 64, 3)])
def test_estimate_matches_jax(nets, pairs, jax_estimates, H, W, iters):
    """The resize-to-16 contract at 64x64 and 50x70 (64x80 inside), at the
    default 8 refinements at 1/8 and at 3."""
    _, tm = nets
    a, b = pairs[(H, W)]
    want = jax_estimates[((H, W), iters)]
    got = tv2.estimate(tm, a, b, iters_s8=iters)
    assert got.shape == (H, W, 2) and got.dtype == torch.float32
    assert_flow_close(got.numpy(), want)
    assert np.abs(want).mean() > 0.5  # the flow is not trivially 0


def test_net_without_refinement_at_1_8_matches_jax(nets, pairs):
    """``iters_s8=0``: the 1/16 stage (matching, propagation, one refinement)
    convex-upsampled, through the module's forward."""
    (jm, jp), tm = nets
    a, b = pairs[(64, 64)]
    want = np.asarray(jm.apply(jp, a, b, 0))
    with torch.inference_mode():
        got = tm(nchw(a[None]), nchw(b[None]), iters_s8=0)
    assert got.shape == (1, 2, 64, 64)
    assert_flow_close(got[0].permute(1, 2, 0).numpy(), want)


def test_loader_uses_every_key_once(tmp_path, monkeypatch):
    """Each npz key fills one parameter (Dense kernels transposed, LayerNorm
    scales as weights); without the file the loader returns None."""
    flat = convert.load_flat_npz(convert.WEIGHTS_DIR / "neuflow_v2_synth.npz")
    assert len(flat) == N_KEYS
    model = tv2.NeuFlowV2()
    sd = convert.flax_to_torch_state_dict(flat, model)
    assert len(sd) == N_KEYS == len(model.state_dict())
    assert sum(v.numel() for v in sd.values()) == N_PARAMS
    np.testing.assert_array_equal(sd["cross_attn.q.weight"].numpy(),
                                  flat["cross_attn/q/kernel"].T)
    np.testing.assert_array_equal(sd["cross_attn.norm1.weight"].numpy(),
                                  flat["cross_attn/norm1/scale"])
    monkeypatch.setattr(convert, "WEIGHTS_DIR", tmp_path)
    assert convert.load_neuflow_v2_synth(device="cpu") is None


def official_state_dict(jp, anonymous=False):
    """A torch checkpoint of the packaged weights as the published model
    would name it: the official module prefixes, no ``Conv_0`` level,
    ``weight`` for kernels and norm scales, OIHW convs and [out, in]
    linears, listed in reverse order (a checkpoint's order is its modules'
    definition order, not flax's).  ``anonymous`` keeps only the prefix."""
    flat = jax.tree_util.tree_flatten_with_path(jp["params"])[0]
    sd = {}
    for i, (path, a) in enumerate(flat[::-1]):
        parts = [p.key for p in path if p.key != "Conv_0"]
        parts[0] = OFFICIAL_PREFIX[parts[0]]
        parts[-1] = {"kernel": "weight", "scale": "weight"}.get(parts[-1], parts[-1])
        a = np.asarray(a)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif a.ndim == 2:
            a = a.T
        key = f"{parts[0]}.m{i}.w" if anonymous else ".".join(parts)
        sd[key] = torch.tensor(a)
    return sd


def test_converter_matches_jax(nets, pairs, jax_estimates):
    """The official-style checkpoint through the port's and the reference's
    converters: the port's model gets exactly the packaged weights, and both
    converted models give the packaged model's flow."""
    (jm, jp), tm = nets
    sd = official_state_dict(jp)
    assert any(k.startswith("transformer.") for k in sd)
    got = tv2.convert_neuflow_v2(sd)
    for name, t in tm.state_dict().items():
        torch.testing.assert_close(got.state_dict()[name], t, rtol=0, atol=0)
    _, jconv = jv2.convert_neuflow_v2(sd, jm)
    a, b = pairs[(64, 64)]
    want = np.asarray(jv2.estimate(jm, jconv, a, b))
    np.testing.assert_array_equal(want, jax_estimates[((64, 64), 8)])
    assert_flow_close(tv2.estimate(got.eval(), a, b).numpy(), want)


def _faults(jp):
    return {
        # same-shape tensors with no usable names (q/k/v/proj all [C, C])
        "anonymous": (official_state_dict(jp, anonymous=True), ValueError,
                      "refusing to match positionally"),
        "unknown module": ({"bogus.w": torch.zeros(3, 3)}, KeyError,
                           "unmapped checkpoint module"),
        "shape mismatch": ({"up.mask1.weight": torch.zeros(1, 2, 3, 4)},
                           (ValueError, KeyError), None),
    }


@pytest.mark.parametrize("fault", ["anonymous", "unknown module", "shape mismatch"])
def test_converter_raises_where_jax_does(nets, fault):
    (jm, jp), _ = nets
    sd, exc, match = _faults(jp)[fault]
    with pytest.raises(exc, match=match):
        tv2.convert_neuflow_v2(sd)
    with pytest.raises(exc, match=match):
        jv2.convert_neuflow_v2(sd, jm)
