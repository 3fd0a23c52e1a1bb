"""The port's multi-stream batcher (``runtime/multistream.py``) held against
the JAX package's on the CPU: the stateful batched fused backend (every
stream's previous-frame expansion carried on the device, only the ready
rows run) against the JAX stateless ``make_batched_fused_farneback``
through late joins, partial batches and a dropped-pair reseed; against
per-stream ``FusedFarnebackStream``s bit for bit; ``_StreamSlot``'s drop
flag; and ``MultiStreamFlow`` end to end at both pipeline depths.

Tolerance against JAX: 1e-6 px.  The port's Farneback equals the JAX
one op by op on the CPU; the JAX backend is jitted, and XLA's fusion moves
these 96x128 fields' mean u by up to 4.8e-7 px (2 ulp at 3 px)."""
import threading

import numpy as np
import pytest
import torch

from opticalflowcontainer_tpu.runtime import multistream as jms
from opticalflowcontainer_tpu_torch.runtime import multistream as tms
from opticalflowcontainer_tpu_torch.runtime.bus import Bus
from opticalflowcontainer_tpu_torch.runtime.fused import FusedFarnebackStream
from test_torch_threads import one_torch_thread  # noqa: F401

KW = dict(levels=2, winsize=13, iterations=2)
H, W = 96, 128
DU_PX = 1e-6


def _clips(n_streams=3, n=5, seed=2):
    """[n, n_streams, H, W] fp32 gray: stream i's texture moves i+1 px a
    frame (so flow over a gap differs from flow over one pair)."""
    rng = np.random.default_rng(seed)
    out = np.empty((n, n_streams, H, W), np.float32)
    for s in range(n_streams):
        base = rng.uniform(0, 255, (H, W + 4 * n)).astype(np.float32)
        base = (base + np.roll(base, 1, 1) + np.roll(base, 1, 0)) / 3.0
        for t in range(n):
            out[t, s] = base[:, (s + 1) * t:(s + 1) * t + W]
    return out


@pytest.fixture(scope="module")
def jax_ref():
    """One JAX backend for the module (one compile at n_streams rows)."""
    return jms.make_batched_fused_farneback(3, **KW)


def test_stateful_matches_jax_through_joins_partials_and_drops(jax_ref):
    """Batch 1: streams 0 and 1 (2 joins late: a partial batch); batch 2:
    all three, 2 seeded from its prev; batch 3: streams 0 and 2 (stream
    1's pair (2, 3) was overwritten before the batcher took it); batch 4:
    all three, stream 1 flagged dropped: its state holds frame 2, its pair
    is (3, 4), so it is reseeded from frame 3."""
    f = _clips()
    st = tms.make_stateful_batched_fused_farneback(3, device="cpu", **KW)
    assert st.stateful and st.returns_displacement
    for idxs, t, dropped in (([0, 1], 1, None), ([0, 1, 2], 2, None),
                             ([0, 2], 3, None), ([0, 1, 2], 4, [0, 1, 0])):
        prev, cur = f[t - 1][idxs], f[t][idxs]
        want = np.asarray(jax_ref(prev, cur))
        got = st(prev, cur, idxs, dropped)
        assert isinstance(got, torch.Tensor) and got.shape == (len(idxs),)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=DU_PX)


def test_dropped_flag_reseeds_and_stale_state_differs():
    """Without the dropped flag the stored planes (frame 1) warp against
    frame 3: flow over two frames' motion, which the reseed prevents."""
    f = _clips(n_streams=1)
    want = float(np.asarray(jms.make_batched_fused_farneback(1, **KW)(f[2], f[3]))[0])
    st = tms.make_stateful_batched_fused_farneback(1, device="cpu", **KW)
    st(f[0], f[1], [0])
    assert float(st(f[2], f[3], [0], [True])[0]) == pytest.approx(want, abs=DU_PX)
    stale = tms.make_stateful_batched_fused_farneback(1, device="cpu", **KW)
    stale(f[0], f[1], [0])
    assert abs(float(stale(f[2], f[3], [0], [False])[0]) - want) > 0.5


def test_stateful_equals_per_stream_streams_bitwise():
    """Each row equals its own FusedFarnebackStream on the same frames, bit
    for bit: every operation is per pixel, and each row is reduced as a
    single stream reduces."""
    f = _clips(n_streams=2)
    st = tms.make_stateful_batched_fused_farneback(2, device="cpu", **KW)
    streams = [FusedFarnebackStream(device="cpu", **KW) for _ in range(2)]
    for s, x in zip(streams, f[0]):
        s.step(x)
    for t in range(1, 4):
        got = st(f[t - 1], f[t], [0, 1])
        want = torch.stack([s.step(x) for s, x in zip(streams, f[t])])
        assert torch.equal(got, want)


@pytest.mark.parametrize("aggregate", ["mean", "median"])
def test_stateless_backends_match_jax(aggregate):
    f = _clips(n_streams=2)
    fused = tms.make_batched_fused_farneback(2, aggregate, device="cpu", **KW)
    flows = tms.make_batched_farneback(2, device="cpu", **KW)(f[0], f[1])
    ref = jms.make_batched_fused_farneback(2, aggregate, **KW)
    got = fused(f[0], f[1]).numpy()
    np.testing.assert_allclose(got, np.asarray(ref(f[0], f[1])), rtol=0, atol=DU_PX)
    agg = np.mean if aggregate == "mean" else np.median
    np.testing.assert_allclose(got, [agg(x[..., 0]) for x in flows], rtol=1e-6)
    assert fused(f[0][:1], f[1][:1]).shape == (1,)  # a partial batch
    with pytest.raises(ValueError, match="rows for 2 streams"):
        fused(np.concatenate([f[0]] * 2), np.concatenate([f[1]] * 2))


def test_stateful_refuses_a_new_resolution_and_bad_arguments():
    """A new frame size, a misspelt keyword or an unknown aggregate raise;
    so does every batcher without a card unless the CPU is asked for."""
    if not torch.cuda.is_available():
        for make in (tms.make_batched_farneback, tms.make_batched_fused_farneback,
                     tms.make_stateful_batched_fused_farneback):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make(2, **KW)
    st = tms.make_stateful_batched_fused_farneback(1, device="cpu", **KW)
    g = np.zeros((1, 64, 80), np.float32)
    st(g, g, [0])
    with pytest.raises(ValueError, match="share a resolution"):
        st(np.zeros((1, 48, 80), np.float32), np.zeros((1, 48, 80), np.float32), [0])
    with pytest.raises(TypeError, match="unexpected keyword"):
        tms.make_stateful_batched_fused_farneback(1, device="cpu", winsze=3)
    with pytest.raises(ValueError, match="aggregate"):
        tms.make_batched_fused_farneback(1, "mode", device="cpu")


def test_stream_slot_drop_flag_and_count():
    """Pushes 0..3 with takes after 1 and 3: pair (1, 2) is overwritten,
    the next take says so once, and the slot counts it."""
    f = [np.full((2, 2), float(i), np.float32) for i in range(5)]
    slot = tms._StreamSlot()
    slot.push(f[0], 0.0)
    assert slot.take() is None
    slot.push(f[1], 1.0)
    pair, dropped = slot.take()
    assert not dropped and pair[1] is f[1]
    slot.push(f[2], 2.0)
    slot.push(f[3], 3.0)
    pair, dropped = slot.take()
    assert dropped and pair[0] is f[2] and pair[1] is f[3] and pair[2:] == (2.0, 3.0)
    slot.push(f[4], 4.0)
    pair, dropped = slot.take()
    assert not dropped and slot.pairs_dropped == 1


@pytest.mark.parametrize("depth", [0, 1])
def test_multistream_flow_end_to_end(depth):
    """Two streams of BGR frames through MultiStreamFlow and the stateful
    backend: every pushed pair is published (dt = 1 s, 1 m per px, so vx
    is the displacement) with the per-stream stream's du; the batcher
    thread ends on stop()."""
    f = _clips(n_streams=2)
    bus = Bus(namespace="")
    ms = tms.MultiStreamFlow(
        bus, tms.make_stateful_batched_fused_farneback(2, device="cpu", **KW),
        n_streams=2, pixel_to_meter=1.0, pipeline_depth=depth)
    got = {0: [], 1: []}
    done = threading.Event()
    # pair t (frames t-1, t) published on both streams
    published = {t: threading.Event() for t in range(1, 4)}

    def on(i, m):
        got[i].append(m.x)
        t = min(len(got[0]), len(got[1]))
        if t in published:
            published[t].set()
        if len(got[0]) == len(got[1]) == 3:
            done.set()

    for i in range(2):
        bus.subscribe(f"/optical_flow/STREAM{i}_velocity", lambda m, i=i: on(i, m))
    ms.start()
    try:
        for t in range(4):
            for i in range(2):
                bgr = np.repeat(f[t, i][..., None], 3, -1).round().astype(np.uint8)
                ms.push_frame(i, bgr, stamp=float(t))
            # the batcher takes pair t before frame t + 1 could overwrite it
            if t:
                assert published[t].wait(timeout=30.0)
        assert done.wait(timeout=30.0)
    finally:
        assert ms.stop(timeout=10.0)
    assert ms.fields == 6 and ms.pairs_dropped == 0
    for i in range(2):
        s = FusedFarnebackStream(device="cpu", **KW)
        frames = [np.repeat(f[t, i][..., None], 3, -1).round().astype(np.uint8)
                  for t in range(4)]
        s.step(tms._bgr_to_gray_np(frames[0]))
        want = [float(s.step(tms._bgr_to_gray_np(x))) for x in frames[1:]]
        assert got[i] == pytest.approx(want, abs=1e-6)
