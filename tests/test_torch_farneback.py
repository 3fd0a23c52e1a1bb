"""The port's Farneback slice (calc_optical_flow_farneback, farneback_batched,
farneback_clip) held against the JAX package on the CPU, against the JAX
TPU block path run in interpret mode, and against cv2 at the bars of
tests/test_farneback.py.  On the CPU the port runs its kernels' plain
versions."""
import functools

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import opticalflowcontainer_tpu.classical.farneback as jfb
from opticalflowcontainer_tpu_torch.classical import farneback as tfb
from opticalflowcontainer_tpu_torch.ops import farneback_prep as k5
from test_torch_threads import one_torch_thread  # noqa: F401

DEFAULTS = dict(pyr_scale=0.5, levels=3, winsize=15, iterations=3, poly_n=5,
                poly_sigma=1.2)


def _pair(rng, H, W, M):
    base = cv2.GaussianBlur(
        rng.uniform(0, 255, (H + 80, W + 80)).astype(np.float32), (0, 0), 2.5)
    f1 = base[40:40 + H, 40:40 + W].astype(np.uint8)
    f2 = cv2.warpAffine(base, M, (W + 80, H + 80))[40:40 + H, 40:40 + W]
    return f1, f2.astype(np.uint8)


def _jax_flow(prev, nxt, flow=None, **kw):
    """The JAX CPU path, jitted (compiling the whole pyramid once is ~4x
    faster than dispatching its ops one by one)."""
    fn = jax.jit(functools.partial(jfb.calc_optical_flow_farneback, **kw))
    return fn(jnp.asarray(prev), jnp.asarray(nxt), flow)


def _port(*args, **kw):
    return tfb.calc_optical_flow_farneback(*args, device="cpu", **kw).numpy()


def _close_to_jax(got, want):
    """Port vs the JAX CPU path: both are fp32 with the same operations in
    the same order (the JAX path's exact gather is the port's K1 plain
    version), so the bar is tight: mean |d| <= 1e-3 px, max <= 1e-2 px."""
    d = np.abs(got - np.asarray(want))
    assert d.mean() <= 1e-3 and d.max() <= 1e-2, (d.mean(), d.max())


@pytest.mark.parametrize("flags", [0, tfb.OPTFLOW_FARNEBACK_GAUSSIAN])
def test_flow_matches_jax(flags, rng):
    f1, f2 = _pair(rng, 128, 160, np.float32([[1, 0, -2.3], [0, 1, 1.7]]))
    a, b = f1.astype(np.float32), f2.astype(np.float32)
    want = _jax_flow(a, b, flags=flags, **DEFAULTS)
    _close_to_jax(_port(a, b, flags=flags, **DEFAULTS), want)


def test_initial_flow_and_batch_match_jax(rng):
    f1, f2 = _pair(rng, 128, 160, np.float32([[1, 0, 1.5], [0, 1, -0.5]]))
    g1, g2 = _pair(rng, 128, 160, np.float32([[1, 0, -1.0], [0, 1, 2.0]]))
    prev = np.stack([f1, g1]).astype(np.float32)
    nxt = np.stack([f2, g2]).astype(np.float32)
    seed = np.stack([np.full((128, 160, 2), 0.7, np.float32),
                     np.full((128, 160, 2), -0.4, np.float32)])
    kw = dict(DEFAULTS, flags=tfb.OPTFLOW_USE_INITIAL_FLOW)
    want = _jax_flow(prev, nxt, jnp.asarray(seed), **kw)
    got = tfb.farneback_batched(prev, nxt, flow=seed, device="cpu", **kw)
    _close_to_jax(got.numpy(), want)


def test_clip_matches_jax_and_pairwise(rng):
    """The clip shares each frame's planes between its two pairs; the flow
    is the same as pairwise calls, exactly (same planes, same kernels)."""
    base = cv2.GaussianBlur(rng.uniform(0, 255, (128, 180)).astype(np.float32),
                            (0, 0), 2.0)
    frames = np.stack([base[:, 2 * t:2 * t + 160] for t in range(4)])
    kw = dict(DEFAULTS, levels=2)
    want = _jax_flow(frames[:-1], frames[1:], **kw)  # the reference's clip on CPU
    got = tfb.farneback_clip(frames, device="cpu", **kw).numpy()
    assert got.shape == (3, 128, 160, 2)
    _close_to_jax(got, want)
    for t in range(3):
        pair = _port(frames[t], frames[t + 1], **kw)
        assert np.abs(got[t] - pair).max() == 0.0


def test_clip_initial_flow_and_validation():
    """An [H, W, 2] seed applies to every pair (as the reference's clip
    does), and a misspelt keyword raises instead of being ignored."""
    rng = np.random.default_rng(7)
    base = rng.uniform(0, 255, (40, 64)).astype(np.float32)
    fr = np.stack([base, np.roll(base, 1, 1), np.roll(base, 2, 1)])
    seed = np.full((40, 64, 2), 0.5, np.float32)
    clip = tfb.farneback_clip(fr, flow=seed, flags=tfb.OPTFLOW_USE_INITIAL_FLOW,
                              device="cpu")
    assert clip.shape == (2, 40, 64, 2)
    for k in range(2):
        pair = _port(fr[k], fr[k + 1], flow=seed,
                     flags=tfb.OPTFLOW_USE_INITIAL_FLOW)
        assert np.abs(clip[k].numpy() - pair).max() == 0.0
    with pytest.raises(TypeError, match="unexpected keyword"):
        tfb.farneback_clip(fr, winsze=15, device="cpu")


def test_matches_jax_block_path_interpret(rng, monkeypatch):
    """The JAX TPU path (block-patch warp kernel in interpret mode, bf16
    planes and normal equations) vs the port.  The block warp's window and
    bf16 storage are its only approximations, so the bound is the one the
    reference's own test puts between its block path and its exact path:
    mean < 5e-3 px, max < 0.05 px."""
    H, W = 96, 128
    base = rng.uniform(0, 255, (H + 16, W + 16)).astype(np.float32)
    a = base[8:8 + H, 8:8 + W].astype(np.uint8).astype(np.float32)
    b = base[8:8 + H, 5:5 + W].astype(np.uint8).astype(np.float32)
    monkeypatch.setattr(jfb, "BLOCK_WARP_INTERPRET", True)
    monkeypatch.setattr(jfb, "_on_tpu", lambda: True)
    block = np.asarray(jfb.calc_optical_flow_farneback(
        jnp.asarray(a), jnp.asarray(b), **DEFAULTS))
    d = np.linalg.norm(_port(a, b, **DEFAULTS) - block, axis=-1)
    assert d.mean() < 5e-3 and d.max() < 0.05, (d.mean(), d.max())


def test_poly_exp_matches_jax(rng):
    img = rng.uniform(0, 255, (2, 30, 41)).astype(np.float32)
    for n, sigma in ((5, 1.2), (7, 1.5)):
        want = np.asarray(jfb.poly_exp(jnp.asarray(img), n, sigma))
        got = tfb.poly_exp(torch.from_numpy(img), n, sigma).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_pyramid_helpers_match_jax():
    for H, W, levels, s in ((720, 1280, 3, 0.5), (480, 640, 3, 0.5),
                            (96, 128, 3, 0.5), (121, 159, 4, 0.8)):
        assert tfb._num_levels(H, W, levels, s) == jfb._num_levels(H, W, levels, s)
        for k in range(4):
            assert tfb._level_size(H, W, s**k) == jfb._level_size(H, W, s**k)
    for n, sigma in ((5, 1.2), (7, 1.5)):
        for x, y in zip(k5._poly_exp_inverse(n, sigma),
                        jfb._poly_exp_inverse(n, sigma)):
            np.testing.assert_array_equal(x, y)


# cv2 bars of tests/test_farneback.py, applied to the port
CV2_CASES = {
    "translation": ((120, 160), np.float32([[1, 0, -2.3], [0, 1, 1.7]]), 0,
                    DEFAULTS, 0.01),
    "rotation_zoom": ((160, 200), cv2.getRotationMatrix2D((100, 80), 2.0, 1.02),
                      0, DEFAULTS, 0.1),
    "gaussian_flag": ((120, 160), np.float32([[1, 0, -1.4], [0, 1, 2.8]]),
                      tfb.OPTFLOW_FARNEBACK_GAUSSIAN, DEFAULTS, 0.05),
    "nondefault_params": ((121, 159), np.float32([[1, 0, 2.0], [0, 1, 1.0]]), 0,
                          dict(pyr_scale=0.8, levels=4, winsize=13,
                               iterations=2, poly_n=7, poly_sigma=1.5), 0.05),
}


@pytest.mark.parametrize("case", sorted(CV2_CASES))
def test_cv2_parity(case, rng):
    (H, W), M, flags, args, bar = CV2_CASES[case]
    f1, f2 = _pair(rng, H, W, M)
    ref = cv2.calcOpticalFlowFarneback(f1, f2, None, flags=flags, **args)
    ours = _port(f1, f2, flags=flags, **args)
    epe = float(np.linalg.norm(ours - ref, axis=-1).mean())
    assert epe < bar, epe
    if case == "translation":
        assert abs(float(ours[..., 0].mean()) - ref[..., 0].mean()) < 0.01


def test_batched_matches_single(rng):
    f1a, f2a = _pair(rng, 96, 128, np.float32([[1, 0, 1.5], [0, 1, -0.5]]))
    f1b, f2b = _pair(rng, 96, 128, np.float32([[1, 0, -1.0], [0, 1, 2.0]]))
    prev = np.stack([f1a, f1b]).astype(np.float32)
    nxt = np.stack([f2a, f2b]).astype(np.float32)
    args = dict(pyr_scale=0.5, levels=2, winsize=11, iterations=2, poly_n=5,
                poly_sigma=1.1)
    batched = tfb.farneback_batched(prev, nxt, device="cpu", **args).numpy()
    single = _port(prev[1], nxt[1], **args)
    np.testing.assert_allclose(batched[1], single, atol=1e-5)
