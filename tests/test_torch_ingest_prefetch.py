"""The port's frame ingest and prefetch held against the JAX package on the
CPU (oracle tests/test_ingest_prefetch.py): preprocess_frames for every
flag combination and its two refusals, pad_to_multiple, and the
DevicePrefetcher's order and content."""
import itertools

import jax
import numpy as np
import pytest
import torch

from opticalflowcontainer_tpu.core import ingest as jingest
from opticalflowcontainer_tpu.runtime.prefetch import DevicePrefetcher as JPrefetcher
from opticalflowcontainer_tpu_torch.core import ingest as tingest
from opticalflowcontainer_tpu_torch.runtime.prefetch import DevicePrefetcher
from test_torch_threads import one_torch_thread  # noqa: F401

FRAMES = np.random.default_rng(0).integers(0, 256, (2, 48, 64, 3), dtype=np.uint8)
COMBOS = [c for c in itertools.product([None, (24, 32), (61, 47)], [False, True],
                                       [False, True], [False, True],
                                       [None, (0.4, 0.45, 0.5)])
          if not (c[4] is not None and (c[1] or not c[3]))]


@pytest.mark.parametrize("out_hw,to_gray,to_rgb,normalize,mean", COMBOS)
def test_preprocess_frames_matches_jax(out_hw, to_gray, to_rgb, normalize, mean):
    """Within 1e-6 of the 0-1 scale (2.6e-4 on the 0-255 one): the same
    float32 operations, the resize's taps formed alike; XLA may fuse a
    multiply-add."""
    kw = dict(out_hw=out_hw, to_gray=to_gray, to_rgb=to_rgb, normalize=normalize, mean=mean)
    want = np.asarray(jingest.preprocess_frames(jax.numpy.asarray(FRAMES), **kw))
    got = tingest.preprocess_frames(FRAMES, device="cpu", **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    bar = 1e-6 if normalize else 255e-6
    assert np.abs(got.numpy() - want).max() <= bar
    got_t = tingest.preprocess_frames(torch.from_numpy(FRAMES), device="cpu", **kw)
    np.testing.assert_array_equal(got_t.numpy(), got.numpy())


def test_preprocess_frames_refusals():
    for kw in (dict(mean=(0.4, 0.4, 0.4), to_gray=True),
               dict(mean=(0.4, 0.4, 0.4), normalize=False)):
        with pytest.raises(ValueError):
            jingest.preprocess_frames(FRAMES, **kw)
        with pytest.raises(ValueError):
            tingest.preprocess_frames(FRAMES, device="cpu", **kw)


@pytest.mark.parametrize("shape,mult,channel_last", [((30, 50, 3), 32, True),
                                                     ((2, 30, 50), 8, False),
                                                     ((32, 64, 3), 32, True),
                                                     ((1, 5, 7, 2), 4, True)])
def test_pad_to_multiple_matches_jax(shape, mult, channel_last):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want, want_hw = jingest.pad_to_multiple(jax.numpy.asarray(x), mult, channel_last)
    got, got_hw = tingest.pad_to_multiple(x, mult, channel_last)
    assert got_hw == want_hw
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefetcher_order_and_content_on_the_cpu():
    """The source's items, unchanged and in order (arrays, tuples and dicts
    of them), as the JAX prefetcher yields them."""
    rng = np.random.default_rng(2)
    items = [rng.standard_normal((8, 8)).astype(np.float32) for _ in range(5)]
    got = list(DevicePrefetcher(iter(items), depth=2, device="cpu"))
    want = [np.asarray(x) for x in JPrefetcher(iter(items), depth=2)]
    assert len(got) == len(want) == 5
    for g, w, src in zip(got, want, items):
        assert g is src
        np.testing.assert_array_equal(g, w)
    tree = [{"img": i, "pair": (i, i + 1)} for i in items[:3]]
    assert list(DevicePrefetcher(iter(tree), device="cpu")) == tree


def test_prefetcher_ends_and_reports_a_failing_source():
    """An exhausted prefetcher stays exhausted; a source that raises ends
    the iteration with a RuntimeError from its exception."""
    it = DevicePrefetcher(iter(range(3)), device="cpu")
    assert list(it) == [0, 1, 2]
    with pytest.raises(StopIteration):
        next(it)

    def failing():
        yield 1
        raise KeyError("camera lost")

    it = DevicePrefetcher(failing(), device="cpu")
    assert next(it) == 1
    with pytest.raises(RuntimeError) as err:
        next(it)
    assert isinstance(err.value.__cause__, KeyError)
