"""The port's streaming path (runtime/fused.py, the carried expansion state,
the JAX-state converter, VelocityEstimator) held against the JAX package on
the CPU."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import opticalflowcontainer_tpu.classical.farneback as jfb
from opticalflowcontainer_tpu.runtime import fused as jfused
from opticalflowcontainer_tpu.runtime.velocity import VelocityEstimator as JVel
from opticalflowcontainer_tpu_torch.classical import farneback as tfb
from opticalflowcontainer_tpu_torch.classical.convert import stream_state_from_jax
from opticalflowcontainer_tpu_torch.runtime import fused as tfused
from opticalflowcontainer_tpu_torch.runtime.velocity import VelocityEstimator
from test_torch_threads import one_torch_thread  # noqa: F401

FB = dict(levels=2, winsize=13, iterations=2)


def _frames(n=5, h=64, w=96, seed=0, step=2):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (h, w + step * n, 3)).astype(np.uint8)
    return [np.ascontiguousarray(base[:, step * i:step * i + w]) for i in range(n)]


@pytest.mark.parametrize("aggregate", ["mean", "median"])
def test_stream_du_matches_jax_stream(aggregate):
    """Five frames through the JAX stream (CPU: gray carried, pairwise flow)
    and the port's (planes carried).  Same fp32 arithmetic: du within 1e-4
    px, the bound the reference puts between its fused and unfused paths."""
    f = _frames()
    mask = np.zeros(f[0].shape[:2], bool)
    mask[10:40, 20:70] = True
    js = jfused.FusedFarnebackStream(aggregate=aggregate, **FB)
    ts = tfused.FusedFarnebackStream(aggregate=aggregate, device="cpu", **FB)
    m = mask if aggregate == "median" else None
    assert js.step(f[0], m) is None and ts.step(f[0], m) is None
    for frame in f[1:]:
        want = float(js.step(frame, m))
        got = float(ts.step(frame, m))
        assert got == pytest.approx(want, abs=1e-4)
        assert got == pytest.approx(-2.0, abs=0.05)  # content moves 2 px left


def test_step_many_equals_step_bitwise():
    f = _frames(n=6)
    a = tfused.FusedFarnebackStream(device="cpu", **FB)
    b = tfused.FusedFarnebackStream(device="cpu", **FB)
    a.step(f[0])
    b.step(f[0])
    per_frame = torch.stack([a.step(x) for x in f[1:]])
    chunk = b.step_many(np.stack(f[1:]))
    assert torch.equal(per_frame, chunk)
    for sa, sb in zip(a._state, b._state):
        assert torch.equal(sa, sb)
    with pytest.raises(RuntimeError, match="seed the stream"):
        tfused.FusedFarnebackStream(device="cpu").step_many(np.stack(f))


@pytest.mark.parametrize("seeded", [False, True], ids=["unseeded", "seeded"])
def test_warmup_keeps_the_state_and_reset_clears_it(seeded):
    """``warmup`` runs the first-frame and steady-state steps and puts the
    state back as it found it (None, or the seeding frame's planes, the same
    tensors), so the next du is that of a stream never warmed up; ``reset``
    clears the state and the next step seeds again."""
    f = _frames(n=3)
    a = tfused.FusedFarnebackStream(device="cpu", **FB)
    b = tfused.FusedFarnebackStream(device="cpu", **FB)
    if seeded:
        a.step(f[0])
        b.step(f[0])
    before = a._state
    a.warmup(f[2])
    assert a._state is before
    if not seeded:
        assert a.step(f[0]) is None and b.step(f[0]) is None
    assert torch.equal(a.step(f[1]), b.step(f[1]))
    a.reset()
    assert a._state is None
    assert a.step(f[1]) is None and a._state is not None


def test_stream_step_equals_pairwise_flow():
    """Carrying the planes changes nothing: the step's flow is the pairwise
    flow, exactly, and the returned state is the new frame's planes."""
    g = [x[..., 1].astype(np.float32) for x in _frames(n=3)]
    state = tfb.farneback_stream_planes(g[0], device="cpu", **FB)
    for a, b in zip(g, g[1:]):
        flow, state = tfb.farneback_stream_step(state, b, device="cpu", **FB)
        pair = tfb.calc_optical_flow_farneback(a, b, device="cpu", **FB)
        assert torch.equal(flow, pair)
    own = tfb.farneback_stream_planes(g[-1], device="cpu", **FB)
    assert all(torch.equal(x, y) for x, y in zip(state, own))
    with pytest.raises(ValueError, match="one stream mode"):
        tfb.farneback_stream_planes(g[0], share="finest", device="cpu")


def test_stream_state_from_jax_carries_into_the_port():
    """The JAX stream's state (bf16 planes in the TPU warp layout) carried
    into the port: each level's core equals the port's own fp32 planes to
    bf16 precision, and the next step's flow matches the JAX
    farneback_stream_step (block warp in interpret mode, bf16 planes and
    normal equations) to that precision: mean |d| < 5e-3 px, max < 0.05 px,
    the reference's own block-vs-exact bound."""
    H, W = 128, 160
    rng = np.random.default_rng(3)
    base = rng.uniform(0, 255, (H + 16, W + 16)).astype(np.float32)
    g0 = base[8:8 + H, 8:8 + W]
    g1 = base[7:7 + H, 6:6 + W]  # (+2, +1) px shift
    kw = dict(pyr_scale=0.5, levels=3)
    jstate = jfb.farneback_stream_planes(jnp.asarray(g0), **kw)
    state = stream_state_from_jax([np.asarray(p) for p in jstate], H, W,
                                  device="cpu", **kw)
    own = tfb.farneback_stream_planes(g0, device="cpu", **kw)
    assert len(state) == len(own) == 3
    for s, o in zip(state, own):
        assert s.shape == o.shape and s.dtype == torch.float32
        assert (s - o).abs().max() <= 1e-2 * o.abs().max()
    want, _ = jfb.farneback_stream_step(jstate, jnp.asarray(g1), **kw)
    got, _ = tfb.farneback_stream_step(state, g1, device="cpu", **kw)
    d = np.linalg.norm(got.numpy() - np.asarray(want), axis=-1)
    assert d.mean() < 5e-3 and d.max() < 0.05, (d.mean(), d.max())
    with pytest.raises(ValueError, match="expected"):
        stream_state_from_jax([np.asarray(p) for p in jstate][1:], H, W,
                              device="cpu", **kw)


@pytest.mark.parametrize("aggregate", ["mean", "median"])
@pytest.mark.parametrize("mask_kind", ["none", "some", "empty"])
def test_aggregate_matches_jax(aggregate, mask_kind, rng):
    u = rng.normal(size=(24, 30)).astype(np.float32)
    mask = np.zeros((24, 30), bool)
    if mask_kind == "some":
        mask[3:11, 5:18] = True
    masked = mask_kind != "none"
    want = float(jfused._aggregate_u(jnp.asarray(u), jnp.asarray(mask),
                                     aggregate, masked))
    got = float(tfused._aggregate_u(torch.from_numpy(u),
                                    torch.from_numpy(mask) if masked else None,
                                    aggregate))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-7)


def test_backend_and_velocity_match_jax():
    """The flow-node backend returns the JAX backend's displacement, and the
    port's VelocityEstimator turns it into the same m/s."""
    f = _frames(n=4)
    jb = jfused.make_fused_farneback_backend(**FB)
    tb = tfused.make_fused_farneback_backend(device="cpu", **FB)
    assert tb.wants_color and tb.returns_displacement
    jv, tv = JVel(smooth_window=3), VelocityEstimator(smooth_window=3)
    for a, b in zip(f, f[1:]):
        du_j, du_t = jb(a, b, 1 / 15), tb(a, b, 1 / 15)
        assert du_t == pytest.approx(du_j, abs=1e-4)
        assert tv.update_from_displacement(du_t, 1 / 15) == pytest.approx(
            jv.update_from_displacement(du_t, 1 / 15))
    flow = np.random.default_rng(1).normal(size=(20, 24, 2)).astype(np.float32)
    mask = np.zeros((20, 24), bool)
    mask[2:9, 4:15] = True
    for m in (None, mask, np.zeros_like(mask)):
        assert tv.update(flow, 0.0, m) == jv.update(flow, 0.0, m)
    with pytest.raises(ValueError, match="aggregate"):
        VelocityEstimator(aggregate="mode")
    with pytest.raises(TypeError, match="unexpected keyword"):
        tfused.FusedFarnebackStream(device="cpu", winsze=13)
