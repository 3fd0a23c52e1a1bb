"""The port's junction pipeline held against the JAX package on the CPU:
the plain detector against the JAX cv2 fallback (the same junctions), the
golden image's recall and precision, no silent fallback from the compiled
detector, the detector node's topic contract, JunctionTracker against the
JAX tracker (scipy's cKDTree), and bringup_junction /
bringup_junction_remote against the JAX bringup on the fishnet moving 2 px
a frame.  Every wait has a timeout and waits on an event, not a sleep."""
import os
import threading

import cv2
import numpy as np
import pytest

import opticalflowcontainer_tpu.native as jnative
from opticalflowcontainer_tpu.runtime import junction_tracking as jtrack
from opticalflowcontainer_tpu.runtime import launch as jlaunch
from opticalflowcontainer_tpu.runtime import messages as jmsg
from opticalflowcontainer_tpu.runtime import nodes as jnodes
from opticalflowcontainer_tpu.runtime.bus import Bus as JBus
import opticalflowcontainer_tpu_torch.native as tnative
from opticalflowcontainer_tpu_torch.ops import _build
from opticalflowcontainer_tpu_torch.runtime import junction_tracking as ttrack
from opticalflowcontainer_tpu_torch.runtime import launch as tlaunch
from opticalflowcontainer_tpu_torch.runtime import nodes as tnodes
from opticalflowcontainer_tpu_torch.runtime.bus import Bus
from opticalflowcontainer_tpu_torch.runtime.messages import Header, ImageMsg
from test_torch_threads import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "data")


def _fishnet(shift=0, cell=24, H=240, W=320):
    """tests/test_launch.py's fishnet frame (cv2 lines on blue water)."""
    img = np.full((H, W + 64, 3), (180, 120, 60), np.uint8)
    for y in range(12, H, cell):
        cv2.line(img, (0, y), (W + 64, y), (30, 40, 50), 2)
    for x in range(12, W + 64, cell):
        cv2.line(img, (x, 0), (x, H), (30, 40, 50), 2)
    return np.ascontiguousarray(img[:, 32 - shift:32 - shift + W])


def _gap(a, b):
    """Largest distance from a point of ``a`` to its nearest in ``b``, and
    back (the two detectors find contours in another order)."""
    d = np.linalg.norm(a[:, None] - b[None], axis=-1)
    return max(d.min(axis=1).max(), d.min(axis=0).max())


def _match_frac(a, b, tol):
    if len(a) == 0:
        return 0.0
    return float((np.linalg.norm(a[:, None] - b[None], axis=-1).min(axis=1) < tol).mean())


@pytest.fixture(scope="module")
def golden():
    img = cv2.imread(os.path.join(DATA, "fishnet_golden.png"))
    gt = np.load(os.path.join(DATA, "fishnet_golden_gt.npy"))
    want = jnative.detect_junctions(img, grid_area=26.0 ** 2, rotated=True,
                                    force_python=True)
    got = tnative.detect_junctions(img, grid_area=26.0 ** 2, rotated=True,
                                   force_python=True)
    return img, gt, want, got


@pytest.mark.parametrize("shift,cell,area", [(0, 24, 22.0 ** 2), (5, 24, 22.0 ** 2),
                                             (0, 30, 28.0 ** 2)])
def test_plain_detector_matches_jax_axis_aligned(shift, cell, area):
    """Axis-aligned boxes: the same count, each junction within 1e-4 px of
    one of the JAX fallback's (integer corners, float32 means of a few)."""
    img = _fishnet(shift, cell)
    want = jnative.detect_junctions(img, grid_area=area, force_python=True)
    got = tnative.detect_junctions(img, grid_area=area, force_python=True)
    assert len(got) == len(want) > 40
    assert _gap(got, want) <= 1e-4


def test_plain_detector_matches_jax_on_golden(golden):
    """Rotated cells on the golden image (noise, an illumination gradient,
    a tilted net): the same count, each junction within 1e-3 px (float32
    box corners averaged in another order)."""
    _, _, want, got = golden
    assert len(got) == len(want) > 300
    assert _gap(got, want) <= 1e-3
    img = golden[0]
    a = jnative.detect_junctions(img, grid_area=26.0 ** 2, force_python=True)
    b = tnative.detect_junctions(img, grid_area=26.0 ** 2, force_python=True)
    assert len(a) == len(b) and _gap(a, b) <= 1e-4


def test_golden_recall_and_precision(golden):
    """tests/test_native_junction.py's bars at 5 px, and the axis-aligned
    variant missing the rotated net."""
    img, gt, _, got = golden
    recall = _match_frac(gt, got, 5.0)
    assert recall > 0.85, recall
    assert _match_frac(got, gt, 5.0) > 0.95
    axis = tnative.detect_junctions(img, grid_area=26.0 ** 2, force_python=True)
    assert _match_frac(gt, axis, 5.0) < recall - 0.2


def test_blank_image_gives_no_junctions():
    img = np.full((120, 160, 3), (180, 120, 60), np.uint8)
    assert tnative.detect_junctions(img, force_python=True).shape == (0, 2)
    with pytest.raises(ValueError):
        tnative.detect_junctions(img[..., 0], force_python=True)


def test_compiled_detector_raises_without_nvcc(monkeypatch, tmp_path):
    """The default (compiled) detector raises when its library cannot be
    built, and nothing falls back to the plain version."""
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_lib", None)
    calls = []
    monkeypatch.setattr(tnative, "_detect_plain", lambda *a: calls.append(a))
    with pytest.raises(RuntimeError, match="nvcc"):
        tnative.detect_junctions(_fishnet())
    with pytest.raises(RuntimeError, match="nvcc"):
        tnodes.JunctionDetectorNode(Bus()).bus.publish(
            "/camera/color/image_raw", ImageMsg(Header(1.0), _fishnet()))
    assert calls == []


def test_detector_node_contract_matches_jax():
    """Image in -> /junction_detector/junctions out, the same points as the
    JAX node's, the same header, nothing below min_publish or for a gray
    image."""
    got, want = [], []
    bus, jbus = Bus(), JBus()
    tnodes.JunctionDetectorNode(bus, grid_area=22.0 ** 2, force_python=True)
    jnodes.JunctionDetectorNode(jbus, grid_area=22.0 ** 2, force_python=True)
    bus.subscribe("/junction_detector/junctions", got.append)
    jbus.subscribe("/junction_detector/junctions", want.append)
    blank = np.full((120, 160, 3), (180, 120, 60), np.uint8)
    for t, img in enumerate([_fishnet(), blank, _fishnet(3)[..., 0], _fishnet(4)]):
        bus.publish("/camera/color/image_raw", ImageMsg(Header(float(t)), img))
        jbus.publish("/camera/color/image_raw", jmsg.ImageMsg(jmsg.Header(float(t)), img))
    assert [m.header.stamp for m in got] == [m.header.stamp for m in want] == [0.0, 3.0]
    for a, b in zip(got, want):
        assert a.points.dtype == np.float32 and len(a.points) == len(b.points)
        assert _gap(a.points, b.points) <= 1e-4
    # fewer junctions than min_publish: nothing is published
    node = tnodes.JunctionDetectorNode(Bus(), min_publish=10 ** 6, force_python=True)
    out = []
    node.bus.subscribe("/junction_detector/junctions", out.append)
    node.bus.publish("/camera/color/image_raw", ImageMsg(Header(0.0), _fishnet()))
    assert out == []
    node.stop()


# ---------------------------------------------------------------- tracker
def _both(history=10, gate=5.0, min_matches=4):
    return (ttrack.JunctionTracker(history, gate, min_matches),
            jtrack.JunctionTracker(history, gate, min_matches))


def _same(a, b):
    (da, na), (db, nb) = a, b
    assert na == nb
    if db is None:
        assert da is None
    else:
        np.testing.assert_array_equal(da, db)


def test_tracker_matches_jax_on_random_clouds():
    rng = np.random.default_rng(0)
    for t in range(30):
        tr, jr = _both(gate=float(rng.uniform(2, 8)), min_matches=int(rng.integers(1, 6)))
        H, W = 60, 80
        flow = rng.uniform(-3, 3, (H, W, 2)).astype(np.float32)
        prev = rng.uniform(-2, [W + 1, H + 1], (int(rng.integers(0, 40)), 2)).astype(np.float32)
        cur = rng.uniform(0, [W, H], (int(rng.integers(0, 40)), 2)).astype(np.float32)
        for r in (tr, jr):
            r.add_detection(1.0, prev)
            r.add_detection(2.0, cur)
        for stamps in ((1.0, 2.0), (1.5, 2.5), (2.0, 2.0), (0.5, 2.0)):
            _same(tr.track(flow, *stamps), jr.track(flow, *stamps))


def test_tracker_gate_ties_and_many_to_one():
    """A detection at exactly the gate is no match (the bound is strict), an
    exact tie goes to the lower index, several predictions may match one
    detection, fewer than min_matches gives None with the count."""
    flow = np.zeros((50, 50, 2), np.float32)
    prev = np.array([[10, 10], [20, 20], [30, 30], [21, 20], [40, 40]], np.float32)
    cur = np.array([[15, 10],            # exactly 5 px from prev 0: unmatched
                    [20, 22], [20, 18],  # a tie for prev 1 (2 px each)
                    [30, 31],            # prev 2
                    [40, 44.9]], np.float32)
    for gate, min_matches in ((5.0, 1), (5.0, 4), (5.0, 5), (5.0001, 5), (2.0, 1)):
        tr, jr = _both(gate=gate, min_matches=min_matches)
        for r in (tr, jr):
            r.add_detection(1.0, prev)
            r.add_detection(2.0, cur)
        _same(tr.track(flow, 1.0, 2.0), jr.track(flow, 1.0, 2.0))
    tr, _ = _both(min_matches=1)
    tr.add_detection(1.0, prev)
    tr.add_detection(2.0, cur)
    disp, n = tr.track(flow, 1.0, 2.0)
    assert n == 4  # prev 1 and prev 3 both match cur 1 (the lower of the tie)


def test_tracker_history_eviction_and_flow_sampling():
    """The LRU keeps the last ``history`` stamps; junctions are advanced by
    the flow at their rounded (half to even), clipped positions."""
    tr, jr = _both(history=3, min_matches=1)
    rng = np.random.default_rng(1)
    flow = rng.uniform(-2, 2, (20, 30, 2)).astype(np.float32)
    pts = np.array([[0.5, 1.5], [2.5, 3.5], [29.6, 19.6], [-3.0, 25.0]], np.float32)
    for t in range(6):
        for r in (tr, jr):
            r.add_detection(float(t), pts + np.float32(0.3 * t))
    assert list(tr.history) == list(jr.history) == [3.0, 4.0, 5.0]
    for stamps in ((3.0, 5.0), (1.0, 4.0), (4.0, 4.5), (9.0, 9.0)):
        _same(tr.track(flow, *stamps), jr.track(flow, *stamps))


# ---------------------------------------------------------------- bringups
def _drive_jax(n):
    bus, node, _ = jlaunch.bringup_junction(grid_area=22.0 ** 2, force_python_detector=True)
    node.vel.pixel_to_meter = 1.0
    vels = []
    bus.subscribe("/optical_flow/JUNCTION_velocity", lambda m: vels.append(m.x))
    for f in range(n):
        bus.publish("/camera/color/image_raw", jmsg.ImageMsg(jmsg.Header(float(f)),
                                                              _fishnet(2 * f)))
    return np.array(vels)


def test_bringup_junction_matches_jax():
    """The port's bringup (plain detector, Farneback on the CPU) recovers
    the 2 px a frame within 0.3 and equals the JAX bringup's velocities
    within 1e-5 px/frame (its Farneback equals the JAX one's bit for bit on
    the CPU, and so do the detectors' axis-aligned junctions)."""
    n = 5
    bus, node, det = tlaunch.bringup_junction(grid_area=22.0 ** 2,
                                              force_python_detector=True, device="cpu")
    node.vel.pixel_to_meter = 1.0
    vels, clouds = [], []
    bus.subscribe("/optical_flow/JUNCTION_velocity", lambda m: vels.append(m.x))
    bus.subscribe("/junction_detector/junctions", clouds.append)
    try:
        for f in range(n):
            bus.publish("/camera/color/image_raw", ImageMsg(Header(float(f)), _fishnet(2 * f)))
    finally:
        node.stop()
        det.stop()
    assert len(vels) == n - 1 and len(clouds) == n and node.frames_failed == 0
    assert abs(np.mean(vels) - 2.0) < 0.3
    np.testing.assert_allclose(vels, _drive_jax(n), rtol=0, atol=1e-5)


def test_bringup_junction_remote_cross_process():
    """The detector in its own OS process over the TCP bridge: junction
    clouds come back, every synced pair gives a velocity, and they recover
    the translation as the in-process bringup does."""
    bus, node, server, child = tlaunch.bringup_junction_remote(
        grid_area=22.0 ** 2, force_python_detector=True, device="cpu")
    try:
        node.vel.pixel_to_meter = 1.0
        vels, arrived = [], threading.Semaphore(0)
        bus.subscribe("/optical_flow/JUNCTION_velocity", lambda m: vels.append(m.x))
        bus.subscribe("/junction_detector/junctions", lambda m: arrived.release())
        for f in range(5):
            bus.publish("/camera/color/image_raw", ImageMsg(Header(float(f)), _fishnet(2 * f)))
            assert arrived.acquire(timeout=60.0), "no junctions from the detector process"
        assert len(vels) == 4 and node.frames_failed == 0
        assert abs(np.mean(vels) - 2.0) < 0.3
        np.testing.assert_allclose(vels, _drive_jax(5), rtol=0, atol=1e-5)
    finally:
        child.stdin.close()
        child.wait(timeout=30)
        server.close()
        node.stop()
    assert child.returncode == 0


def test_bringup_junction_remote_tears_down_on_failed_start(monkeypatch):
    """A child that never prints READY is killed, the server closed and the
    node stopped, then RuntimeError."""
    import subprocess
    import sys

    real = subprocess.Popen

    def fake(cmd, **kw):
        return real([sys.executable, "-c", "print('NOPE', flush=True)"], **kw)

    monkeypatch.setattr(subprocess, "Popen", fake)
    bus = Bus()
    with pytest.raises(RuntimeError, match="NOPE"):
        tlaunch.bringup_junction_remote(bus=bus, force_python_detector=True,
                                        device="cpu", ready_timeout=30.0)
    assert not any(bus._subs.values())


def test_detector_source_is_built_with_the_kernels():
    """The compiled detector's host C++ goes through the kernels' one nvcc
    call (and so into the library's hash), with no tabs or trailing
    whitespace, as the hygiene test holds the CUDA sources."""
    src = _build.CSRC / "junction_detect.cpp"
    assert src in _build._sources()
    assert "ofc_detect_junctions" in _build._SIGNATURES
    for i, line in enumerate(src.read_text().splitlines(), 1):
        assert "\t" not in line and line == line.rstrip(), f"line {i}"
