"""The port's NeuFlowLite held against the JAX package on the CPU with the
packaged ``neuflow_lite_synth.npz``: the trunk block ``_Down`` against the
flax submodule with the same parameters, the global-matching stage (the
reference's auxiliary output) with the packaged gate and with the gate at 1,
one refinement step (``iters=1``), the whole net and ``estimate`` at 64x64
and 50x70, batched == single, the loader and the demo's ``--model neuflow``
backend.  Inputs are made with numpy from a seed; each JAX reference is
computed once, in a module-scoped fixture.

Tolerances: a module's output within 1e-5 of its largest value (fp32 sums
in another order, as ``tests/test_torch_pwcnet.py``; measured ~1e-7 of it).
The whole net and ``estimate``: the flow within 1e-5 px mean and 2e-4 px max
of JAX's (measured 4.4e-7 to 4.7e-7 px mean and 1.9e-6 to 2.5e-6 px max on
flows of ~1.5 px mean and 2.3-3.2 px max: fp32 rounding through the
soft-argmax and two refinement steps, RAFT's bars).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowcontainer_tpu.models import neuflow as jneuflow
from opticalflowcontainer_tpu_torch.core.resize import resize_bilinear
from opticalflowcontainer_tpu_torch.models import convert
from opticalflowcontainer_tpu_torch.models import neuflow as tneuflow
from opticalflowcontainer_tpu_torch.runtime import demo
from test_torch_threads import one_torch_thread  # noqa: F401

OP_TOL = 1e-5
MEAN_PX, MAX_PX = 1e-5, 2e-4
N_KEYS, N_PARAMS = 28, 412_756



def smooth_pair(rng, H, W, shift=(1, 2)):
    """A smooth random image in [0, 1] and itself rolled by ``shift``
    (rows, cols)."""
    a = rng.uniform(0, 1, (H + 8, W + 8, 3)).astype(np.float32)
    k = np.ones(5, np.float32) / 5
    for axis in (0, 1):
        a = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), axis, a)
    a = a[4:4 + H, 4:4 + W]
    a = ((a - a.min()) / (a.max() - a.min())).astype(np.float32)
    return a, np.roll(a, shift, (0, 1))


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3)))


def assert_close(got, want, tol=OP_TOL):
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def assert_flow_close(got, want):
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert d.mean() <= MEAN_PX and d.max() <= MAX_PX, (d.mean(), d.max())


@pytest.fixture(scope="module")
def nets():
    """JAX (model, params) and the port's model on the CPU, both from the
    packaged npz."""
    jm, tm = jneuflow.load_neuflow_lite_synth(), convert.load_neuflow_lite_synth(device="cpu")
    assert jm is not None and tm is not None, "packaged neuflow_lite_synth.npz missing"
    return jm, tm


@pytest.fixture(scope="module")
def pairs():
    rng = np.random.default_rng(0)
    return {(H, W): smooth_pair(rng, H, W) for H, W in ((64, 64), (50, 70))}


@pytest.fixture(scope="module")
def jax_estimates(nets, pairs):
    """JAX ``estimate`` on each pair, computed once."""
    (jm, jp), _ = nets
    return {hw: np.asarray(jneuflow.estimate(jm, jp, a, b)) for hw, (a, b) in pairs.items()}


def test_down_block_matches_flax(nets):
    """``down2`` (16 -> 32 channels, stride 2) on random features, its
    packaged weights on both sides."""
    (_, jp), tm = nets
    x = np.random.default_rng(1).standard_normal((2, 24, 40, 16)).astype(np.float32)
    want = np.asarray(jneuflow._Down(32).apply({"params": jp["params"]["down2"]}, x))
    with torch.inference_mode():
        got = tm.down2(nchw(x)).numpy()
    assert_close(got, np.moveaxis(want, -1, 1))


@pytest.mark.parametrize("gate", [None, 1.0], ids=["packaged-gate", "gate-1"])
def test_matching_stage_matches_jax(nets, pairs, gate):
    """The gated soft-argmax flow at 1/16, read through the reference's
    auxiliary output (the 1/16 flow resized to full size, x16); with the
    packaged gate (-0.022) and with the gate at 1, where the flow is the
    soft-argmax's whole field."""
    (jm, jp), tm = nets
    a, b = pairs[(64, 64)]
    if gate is not None:
        jp = jax.tree_util.tree_map(lambda x: x, jp)
        jp["params"]["matching_gate"] = jnp.full((1,), gate, jnp.float32)
    _, want = jm.apply(jp, a, b, return_aux=True)
    x = torch.cat([nchw(a[None]), nchw(b[None])])
    with torch.inference_mode():
        if gate is not None:
            tm = convert.load_neuflow_lite_synth(device="cpu")
            tm.matching_gate.fill_(gate)
        f16 = tm.features(x)[3]
        got = resize_bilinear(tm.matching(f16[:1], f16[1:]), (64, 64)) * 16.0
    assert_close(got[0].permute(1, 2, 0).numpy(), np.asarray(want))


def test_one_refinement_step_matches_jax(nets, pairs):
    """The net with ``iters=1``: the matching flow plus one K3 warp, K4
    correlation and refinement."""
    (_, jp), _ = nets
    a, b = pairs[(64, 64)]
    want = np.asarray(jneuflow.NeuFlowLite(iters=1).apply(jp, a, b))
    one = convert._load_synth("neuflow_lite_synth.npz", tneuflow.NeuFlowLite(iters=1), "cpu")
    with torch.inference_mode():
        got = one(nchw(a[None]), nchw(b[None]))
    assert_flow_close(got[0].permute(1, 2, 0).numpy(), want)


def test_net_matches_jax(nets, pairs):
    (jm, jp), tm = nets
    a, b = pairs[(64, 64)]
    want = np.asarray(jm.apply(jp, a, b))
    with torch.inference_mode():
        got = tm(nchw(a[None]), nchw(b[None]))
    assert got.shape == (1, 2, 64, 64) and got.dtype == torch.float32
    assert_flow_close(got[0].permute(1, 2, 0).numpy(), want)


@pytest.mark.parametrize("H,W", [(64, 64), (50, 70)])
def test_estimate_matches_jax(nets, pairs, jax_estimates, H, W):
    """The resize-to-16 contract at 64x64 and at 50x70 (64x80 inside)."""
    _, tm = nets
    a, b = pairs[(H, W)]
    want = jax_estimates[(H, W)]
    got = tneuflow.estimate(tm, a, b)
    assert got.shape == (H, W, 2) and got.dtype == torch.float32
    assert_flow_close(got.numpy(), want)
    assert np.abs(want).mean() > 0.5  # the flow is not trivially 0


def test_batched_equals_single(nets, pairs):
    """Instance norms and the matching are per image: a batch of 2 equals
    the single calls."""
    _, tm = nets
    (a, b), (c, d) = pairs[(64, 64)], smooth_pair(np.random.default_rng(2), 64, 64, (-2, 1))
    both = tneuflow.estimate(tm, np.stack([a, c]), np.stack([b, d]))
    for i, (p, q) in enumerate(((a, b), (c, d))):
        np.testing.assert_allclose(both[i].numpy(), tneuflow.estimate(tm, p, q).numpy(),
                                   rtol=0, atol=1e-5)


def test_loader_uses_every_key_once(tmp_path, monkeypatch):
    """Each npz key fills one parameter (the two scalars included); without
    the file the loader returns None."""
    flat = convert.load_flat_npz(convert.WEIGHTS_DIR / "neuflow_lite_synth.npz")
    assert len(flat) == N_KEYS
    model = tneuflow.NeuFlowLite()
    sd = convert.flax_to_torch_state_dict(flat, model)
    assert len(sd) == N_KEYS == len(model.state_dict())
    assert sum(v.numel() for v in sd.values()) == N_PARAMS
    np.testing.assert_array_equal(sd["matching_gate"].numpy(), flat["matching_gate"])
    monkeypatch.setattr(convert, "WEIGHTS_DIR", tmp_path)
    assert convert.load_neuflow_lite_synth(device="cpu") is None


def test_demo_neuflow_on_the_cpu(capsys):
    """The demo's self-check with ``--model neuflow`` (NeuFlowLite through
    the fused model stream) on the CPU at 96x128."""
    r = demo.run(["--cpu", "--model", "neuflow", "--frames", "10", "--width", "128",
                  "--height", "96", "--fps", "100"])
    out = capsys.readouterr().out
    assert r["exit_code"] == 0 and r["frames_failed"] == 0, out
    assert "velocity error" in out and "OK" in out
