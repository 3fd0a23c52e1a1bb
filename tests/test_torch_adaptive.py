"""The port's adaptive filters and wrapper held against the JAX package and
cv2 on the CPU: the median filter exactly, the bilateral filter and CLAHE
within stated bars, AdaptivePreprocessor and make_adaptive_backend over
the port's Farneback against the JAX wrapper over the JAX Farneback
(tests/test_aux_capabilities.py's oracle).

Bars: the median is a selection, so it is exact.  The bilateral filter
sums the same float32 terms, but exp differs between the two libraries by
an ulp and XLA may fuse the products: 1e-4 on the 0..255 scale (a few
float32 ulps of 255).  CLAHE's histogram counts are exact (integers on
both sides); only the clipped histogram's sum and cumulative sum run in
another float32 order, a few ulps of the 255-scale LUTs: 2e-4."""
import cv2
import jax
import numpy as np
import pytest
import torch

from opticalflowcontainer_tpu.core import filters as jfilters
from opticalflowcontainer_tpu.runtime import adaptive as jadaptive
from opticalflowcontainer_tpu.runtime import nodes as jnodes
from opticalflowcontainer_tpu_torch.core import filters as tfilters
from opticalflowcontainer_tpu_torch.runtime import adaptive as tadaptive
from opticalflowcontainer_tpu_torch.runtime import nodes as tnodes
from test_torch_threads import one_torch_thread  # noqa: F401

BILATERAL_BAR = 1e-4
CLAHE_BAR = 2e-4


@pytest.mark.parametrize("ksize", [3, 5])
def test_median_filter_equals_jax_and_cv2(ksize):
    rng = np.random.default_rng(ksize)
    img = rng.uniform(-20, 20, (2, 33, 47)).astype(np.float32)
    want = np.asarray(jfilters.median_filter(jax.numpy.asarray(img), ksize))
    got = tfilters.median_filter(torch.from_numpy(img), ksize).numpy()
    np.testing.assert_array_equal(got, want)
    u8 = rng.integers(0, 256, (40, 52), dtype=np.uint8)
    got = tfilters.median_filter(torch.from_numpy(u8.astype(np.float32)), ksize).numpy()
    r = ksize // 2
    np.testing.assert_array_equal(got[r:-r, r:-r], cv2.medianBlur(u8, ksize)[r:-r, r:-r])


@pytest.mark.parametrize("d,sigma_space", [(5, 5.0), (0, 2.0), (3, 1.0)])
def test_bilateral_filter_matches_jax(d, sigma_space):
    rng = np.random.default_rng(d)
    img = rng.uniform(0, 255, (2, 30, 41)).astype(np.float32)
    want = np.asarray(jfilters.bilateral_filter(jax.numpy.asarray(img), d, 25.0, sigma_space))
    got = tfilters.bilateral_filter(torch.from_numpy(img), d, 25.0, sigma_space).numpy()
    assert np.abs(got - want).max() <= BILATERAL_BAR


@pytest.mark.parametrize("clip,grid,shape", [(1.0, 8, (64, 96)), (2.5, 8, (2, 48, 64)),
                                             (4.0, 4, (120, 160)), (0.01, 8, (64, 64))])
def test_clahe_matches_jax(clip, grid, shape):
    """Including a clip so small that every bin is clipped to the floor of
    1, and a batch."""
    rng = np.random.default_rng(int(clip * 10) + grid)
    img = rng.uniform(0, 255, shape).astype(np.float32)
    img[..., :8, :8] = 255.7  # clipped to 255 before the bins
    want = np.asarray(jfilters.clahe(jax.numpy.asarray(img), clip, grid))
    got = tfilters.clahe(torch.from_numpy(img), clip, grid).numpy()
    assert np.abs(got - want).max() <= CLAHE_BAR
    got_t = tfilters.clahe(torch.from_numpy(img), torch.tensor(clip), grid).numpy()
    np.testing.assert_array_equal(got_t, got)
    with pytest.raises(ValueError):
        tfilters.clahe(torch.from_numpy(img[..., :-1]), clip, grid)


def _params():
    return [jadaptive.AdaptiveParams(),
            jadaptive.AdaptiveParams(use_bilateral=True, flow_median_ksize=3,
                                     flow_min_mag=0.5, flow_max_mag=3.0,
                                     intensity_mask_thresh=60.0),
            jadaptive.AdaptiveParams(use_clahe=False, flow_median_ksize=5)]


@pytest.mark.parametrize("i", range(3))
def test_preprocessor_matches_jax(i):
    """pre- and post-processing, on a frame whose size is not a multiple of
    the CLAHE grid (the rest passes through)."""
    jp = _params()[i]
    tp = tadaptive.AdaptiveParams(**vars(jp))
    rng = np.random.default_rng(i)
    gray = rng.uniform(20, 230, (61, 83)).astype(np.float32)
    flow = rng.uniform(-4, 4, (61, 83, 2)).astype(np.float32)
    jproc = jadaptive.AdaptivePreprocessor(jp)
    tproc = tadaptive.AdaptivePreprocessor(tp, device="cpu")
    bar = BILATERAL_BAR + CLAHE_BAR
    got = tproc.preprocess(gray).numpy()
    assert np.abs(got - jproc.preprocess(gray)).max() <= bar
    np.testing.assert_array_equal(tproc.postprocess(flow, gray).numpy(),
                                  jproc.postprocess(flow, gray))


def test_adaptive_backend_pre_and_post_as_jax():
    """tests/test_aux_capabilities.py's case: a numpy backend gets numpy
    frames; the outlier goes, the flow stays."""
    calls = {}

    def backend(prev, cur, dt):
        calls["types"] = (type(prev), type(cur))
        flow = np.zeros(prev.shape + (2,), np.float32)
        flow[..., 0] = 2.0
        flow[10, 10] = (100.0, 0.0)  # outlier
        return flow

    params = dict(use_clahe=True, flow_median_ksize=3, flow_max_mag=50.0)
    gray = np.random.default_rng(0).uniform(0, 255, (64, 64)).astype(np.float32)
    want = jadaptive.make_adaptive_backend(backend, jadaptive.AdaptiveParams(**params))(
        gray, gray, 0.03)
    got = tadaptive.make_adaptive_backend(backend, tadaptive.AdaptiveParams(**params),
                                          device="cpu")(gray, gray, 0.03)
    assert calls["types"] == (np.ndarray, np.ndarray)
    assert got.shape == (64, 64, 2) and abs(got[32, 32, 0] - 2.0) < 1e-5
    assert got[10, 10, 0] < 50.0
    np.testing.assert_array_equal(got, want)


def test_adaptive_backend_over_farneback_matches_jax():
    """Over each package's Farneback (levels 2, winsize 13, 2 iterations) on
    a translating texture, three frames streamed (the second reuses the
    first call's preprocessed frame): the flows within the port's
    card-vs-CPU bar (mean 1e-3, max 1e-2 px), the preprocessed frames
    being within CLAHE's bar of each other."""
    rng = np.random.default_rng(3)
    base = cv2.GaussianBlur(rng.uniform(0, 255, (80, 140)).astype(np.float32), (0, 0), 1.5)
    frames = [np.ascontiguousarray(base[:, 2 * t:2 * t + 96]) for t in range(3)]
    kw = dict(levels=2, winsize=13, iterations=2)
    params = dict(flow_median_ksize=3, flow_max_mag=50.0)
    jw = jadaptive.make_adaptive_backend(jnodes.make_farneback_backend(**kw),
                                         jadaptive.AdaptiveParams(**params))
    tback = tnodes.make_farneback_backend(device="cpu", **kw)
    seen = []
    inner = tback.flow_tensor
    tback.flow_tensor = lambda a, b, dt: (seen.append((a, b)), inner(a, b, dt))[1]
    tw = tadaptive.make_adaptive_backend(tback, tadaptive.AdaptiveParams(**params))
    for a, b in zip(frames, frames[1:]):
        want = jw(a, b, 1 / 30)
        got = tw(a, b, 1 / 30)
        d = np.abs(got - want)
        assert d.mean() <= 1e-3 and d.max() <= 1e-2, (d.mean(), d.max())
        assert abs(got[20:-20, 20:-20, 0].mean() + 2.0) < 0.3  # the texture moves -2 px
    assert seen[1][0] is seen[0][1]  # the second call reused the first's cur
    assert all(isinstance(x, torch.Tensor) for pair in seen for x in pair)
