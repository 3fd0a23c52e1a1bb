"""The port's streaming runtime (``runtime/`` bus, messages, sources, nodes,
launch, demo, tracing, the latency measurement, and the resize, colour and
mask helpers it needs) held against the JAX package's runtime and cv2 on
the CPU.  The same seeded numpy inputs go to both; each test states its
tolerance.  Every wait and join in these tests has a timeout, and every
node started is stopped in ``finally``."""
import threading
import time

import cv2
import numpy as np
import pytest
import torch

import opticalflowcontainer_tpu.runtime as jrt
from opticalflowcontainer_tpu.core import color as jcolor
from opticalflowcontainer_tpu.runtime import nodes as jnodes
from opticalflowcontainer_tpu.runtime import sources as jsources
from opticalflowcontainer_tpu.runtime import velocity as jvelocity
from opticalflowcontainer_tpu.runtime import viz as jviz
import opticalflowcontainer_tpu_torch.runtime as trt
from opticalflowcontainer_tpu_torch.core import color as tcolor
from opticalflowcontainer_tpu_torch.core.resize import resize_area, resize_nearest
from opticalflowcontainer_tpu_torch.runtime import demo, launch, tracing
from opticalflowcontainer_tpu_torch.runtime import nodes as tnodes
from opticalflowcontainer_tpu_torch.runtime import sources as tsources
from opticalflowcontainer_tpu_torch.runtime import velocity as tvelocity
from opticalflowcontainer_tpu_torch.runtime import viz as tviz
from opticalflowcontainer_tpu_torch.runtime.bus import (
    ApproximateTimeSynchronizer,
    Bus,
)
from opticalflowcontainer_tpu_torch.runtime.messages import (
    CameraInfoMsg,
    Header,
    ImageMsg,
    PointCloudMsg,
)
from test_torch_threads import one_torch_thread  # noqa: F401

FB = dict(levels=2, winsize=13, iterations=2)  # the runtime's default
H, W = 96, 128


# ------------------------------------------------------------------ bus

def test_bus_pubsub_and_depth_limit():
    bus = Bus()
    got = []
    bus.subscribe("/t", got.append, depth=3)
    for i in range(5):
        bus.publish("/t", i)
    assert got == [0, 1, 2, 3, 4]  # direct mode delivers everything


def test_bus_threaded_delivery_drops_oldest_and_close_stops_threads():
    """A threaded subscription keeps the newest ``depth`` messages while its
    callback is busy, and ``close()`` ends its dispatcher thread."""
    bus = Bus()
    gate = threading.Event()
    got = []

    def slow(m):
        gate.wait(5.0)
        got.append(m)

    sub = bus.subscribe("/t", slow, depth=2, direct=False)
    bus.publish("/t", 0)
    time.sleep(0.2)  # the dispatcher takes 0 and blocks in the callback
    for i in range(1, 6):
        bus.publish("/t", i)
    gate.set()
    deadline = time.monotonic() + 5.0
    while len(got) < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert got == [0, 4, 5]
    bus.close()
    assert not sub._thread.is_alive()


def test_bus_latched():
    bus = Bus()
    bus.publish("/info", "hello", latch=True)
    got = []
    bus.subscribe("/info", got.append)
    assert got == ["hello"]


def test_bus_latched_delivery_releases_lock():
    """A direct callback that publishes from the latched delivery must not
    deadlock on the bus lock."""
    bus = Bus(namespace="")
    bus.publish("/a", 42, latch=True)
    got_b = []
    bus.subscribe("/b", got_b.append)
    bus.subscribe("/a", lambda msg: bus.publish("/b", msg + 1))
    assert got_b == [43]


def test_bus_namespace_isolation_and_env(monkeypatch):
    bus_a = Bus(namespace="/robot_a")
    bus_shared = Bus(namespace="")
    got_a, got_plain = [], []
    bus_a.subscribe("/t", got_a.append)
    bus_shared.subscribe("/t", got_plain.append)
    bus_a.publish("/t", 1)
    bus_shared.publish("/t", 2)
    bus_a.publish("/t", 3)
    assert got_a == [1, 3] and got_plain == [2]
    monkeypatch.setenv("OFC_BUS_NAMESPACE", "/dom22")
    assert Bus().namespace == "/dom22" == jrt.Bus().namespace
    assert Bus(namespace="").namespace == ""
    monkeypatch.delenv("OFC_BUS_NAMESPACE")
    assert Bus().namespace == ""


def test_time_synchronizer_joins_like_jax():
    """The same stamped sequence through the JAX and the port's
    synchronizers gives the same joins: slop 0.01 s, nearest match, used
    messages removed."""
    stamps = [("/a", 1.000), ("/b", 1.005), ("/a", 2.000), ("/b", 2.100),
              ("/b", 3.003), ("/a", 3.000), ("/a", 3.009), ("/b", 3.010),
              ("/a", 4.0), ("/a", 4.004), ("/b", 4.005)]
    joins = {}
    for name, mod_bus, mod_sync, msgs in (
            ("jax", jrt.Bus, jrt.ApproximateTimeSynchronizer, jrt.messages),
            ("port", Bus, ApproximateTimeSynchronizer, trt.messages)):
        bus = mod_bus(namespace="")
        out = []
        mod_sync(bus, ["/a", "/b"],
                 lambda a, b: out.append((a.header.stamp, b.header.stamp)),
                 slop=0.01)
        for topic, t in stamps:
            bus.publish(topic, msgs.ImageMsg(msgs.Header(t), np.zeros(1)))
        joins[name] = out
    assert joins["port"] == joins["jax"]
    assert joins["port"][0] == (1.000, 1.005) and len(joins["port"]) == 4


# -------------------------------------------------------- small helpers

@pytest.mark.parametrize("points", [
    [[10.0, 10.0]], [[0.4, 0.2], [19.6, 5.0]], [[2.0, 18.9], [-3.0, 4.0]],
    [[25.0, 3.0]], np.zeros((0, 2))], ids=["inside", "corners", "edge",
                                          "outside", "none"])
def test_junction_mask_matches_jax(points):
    """Boxes straddling the border are clipped, points outside mark
    nothing: equal to the JAX mask."""
    pts = np.asarray(points, np.float32)
    for box in (5, 11):
        want = jvelocity.junction_mask((20, 24), pts, box)
        got = tvelocity.junction_mask((20, 24), pts, box)
        assert got.dtype == bool and np.array_equal(got, want)


@pytest.mark.parametrize("velocity", [0.05, -0.05, 0.3])
def test_synthetic_camera_frames_equal_jax(velocity):
    """frame_at is the same numpy on both sides: bit-equal, including the
    negative-velocity walk, which keeps moving for the whole clip."""
    kw = dict(width=64, height=48, velocity_mps=velocity, n_frames=30, seed=3)
    jc, tc = jsources.SyntheticCamera(**kw), tsources.SyntheticCamera(**kw)
    for i in (0, 1, 10, 29):
        assert np.array_equal(tc.frame_at(i), jc.frame_at(i))
    f = [tc.frame_at(i).astype(np.float32) for i in (0, 10, 20)]
    assert np.abs(f[1] - f[0]).mean() > 1.0 and np.abs(f[2] - f[1]).mean() > 1.0
    assert [x.shape for x in tc.frames()] == [(48, 64, 3)] * 30


@pytest.mark.parametrize("max_mag", [None, 3.0])
def test_flow_to_hsv_rgb_matches_jax(max_mag, rng):
    """Within 1e-6 (fp32 atan2 and divisions on both sides), including
    zero, axis-aligned and negative-angle vectors; flow_to_bgr's uint8
    within 1 (the cast truncates)."""
    flow = rng.normal(0, 2, (2, 17, 23, 2)).astype(np.float32)
    flow[0, 0, :4] = [[0, 0], [1, 0], [0, -1], [-1, -1e-9]]
    want = np.asarray(jcolor.flow_to_hsv_rgb(flow, max_mag))
    got = tcolor.flow_to_hsv_rgb(torch.from_numpy(flow), max_mag).numpy()
    assert got.shape == want.shape and np.abs(got - want).max() <= 1e-6
    bgr_j, bgr_t = jviz.flow_to_bgr(flow[1], max_mag), tviz.flow_to_bgr(flow[1], max_mag)
    assert bgr_t.dtype == np.uint8 and bgr_t.shape == (17, 23, 3)
    assert np.abs(bgr_t.astype(int) - bgr_j.astype(int)).max() <= 1


# ----------------------------------------------------------------- resize

@pytest.mark.parametrize("src,dst", [((480, 640), (240, 320)),
                                     ((720, 1280), (432, 768)),
                                     ((60, 80), (96, 128))],
                         ids=["integer", "non-integer", "upscale"])
@pytest.mark.parametrize("channels", [0, 3])
def test_resize_area_matches_cv2(src, dst, channels, rng):
    """resize_area vs cv2.resize(INTER_AREA) on fp32 0-255 images: within
    1e-3 (cv2 stores its overlap weights in fp32 and sums in another
    order).  Upscaling takes cv2's bilinear form with area coefficients."""
    shape = src + ((channels,) if channels else ())
    img = rng.uniform(0, 255, shape).astype(np.float32)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA)
    got = resize_area(img, dst)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-3
    t = resize_area(torch.from_numpy(img), dst)
    assert isinstance(t, torch.Tensor) and np.array_equal(t.numpy(), got)


@pytest.mark.parametrize("src,dst", [((480, 640), (240, 320)),
                                     ((720, 1280), (432, 768)),
                                     ((60, 80), (96, 128)), ((97, 131), (40, 77))])
def test_resize_nearest_matches_cv2(src, dst, rng):
    """resize_nearest vs cv2.resize(INTER_NEAREST): exact."""
    mask = (rng.uniform(size=src) > 0.7).astype(np.uint8)
    want = cv2.resize(mask, dst[::-1], interpolation=cv2.INTER_NEAREST)
    got = resize_nearest(mask, dst)
    assert got.dtype == np.uint8 and np.array_equal(got, want)


# ------------------------------------------------------------ flow nodes

def _camera_frames(n=6, velocity=0.05, fps=30.0, w=W, h=H):
    cam = tsources.SyntheticCamera(width=w, height=h, fps=fps, n_frames=n,
                                   velocity_mps=velocity)
    return [cam.frame_at(i) for i in range(n)]


def _drive(node_cls, msgs, backend, params, bus_cls, sync_points=None):
    """Publish ``msgs`` (uint8 BGR frames, stamped 0.1 s apart) to a node
    attached with direct delivery; return its (velocity, smoothed) pairs."""
    bus = bus_cls(namespace="")
    node = node_cls(backend, params, bus).attach(direct=True)
    vels, smooth = [], []
    name = params.name
    bus.subscribe(f"/optical_flow/{name}_velocity", lambda m: vels.append(m.x))
    bus.subscribe(f"/optical_flow/{name}_smooth_velocity",
                  lambda m: smooth.append(m.x))
    mod = jrt.messages if bus_cls is jrt.Bus else trt.messages
    try:
        for i, frame in enumerate(msgs):
            t = 0.1 * i
            bus.publish("/camera/color/image_raw",
                        mod.ImageMsg(mod.Header(t), frame))
            if sync_points is not None:
                bus.publish("/junction_detector/junctions",
                            mod.PointCloudMsg(mod.Header(t + 0.004), sync_points))
    finally:
        node.stop()
    return np.array(vels), np.array(smooth), node


@pytest.mark.parametrize("net", [None, (60, 80)], ids=["frame-size", "net-size"])
def test_flow_node_topic_mode_matches_jax(net):
    """96x128 camera frames through the JAX FlowNode (its jitted Farneback
    backend, cv2 resize) and the port's (Farneback on the CPU, its own
    resize): the velocity sequences agree to 1e-6 relative.  The port's
    Farneback equals the JAX one op by op; XLA's fusion of the jitted
    reference moves the mean flow by at most ~4e-7 relative.  With a net
    size the velocities stay in source-pixel units on both sides."""
    frames = _camera_frames()
    kw = dict(pixel_to_meter=0.000857, name="FB", smooth_window=3)
    if net is not None:
        kw.update(net_height=net[0], net_width=net[1])
    want_v, want_s, _ = _drive(jnodes.FlowNode, frames,
                               jnodes.make_farneback_backend(**FB),
                               jnodes.NodeParams(**kw), jrt.Bus)
    got_v, got_s, node = _drive(tnodes.FlowNode, frames,
                                tnodes.make_farneback_backend(device="cpu", **FB),
                                tnodes.NodeParams(**kw), Bus)
    assert len(got_v) == len(want_v) == 5 and node.frames_processed == 5
    np.testing.assert_allclose(got_v, want_v, rtol=1e-6)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-6)
    gt = 0.05 / (30 * 0.1)  # the camera's 30 fps motion over 0.1 s stamps
    assert abs(np.median(got_v) - gt) < 0.1 * gt


def test_net_size_resize_keeps_source_pixel_units():
    """A backend that reports 2 px at net scale 160 wide is 4 px at the
    320-wide source; the backend sees net-size frames."""
    seen = []

    def backend(prev, nxt, dt):
        seen.append(nxt.shape)
        flow = np.zeros(nxt.shape[:2] + (2,), np.float32)
        flow[..., 0] = 2.0
        return flow

    bus = Bus(namespace="")
    node = tnodes.FlowNode(backend, tnodes.NodeParams(
        pixel_to_meter=1.0, name="NS", net_width=160, net_height=120)).attach(bus)
    vels = []
    bus.subscribe("/optical_flow/NS_velocity", lambda m: vels.append(m.x))
    frame = np.zeros((240, 320, 3), np.uint8)
    for f in range(3):
        bus.publish("/camera/color/image_raw", ImageMsg(Header(float(f)), frame))
    node.stop()
    assert seen == [(120, 160)] * 2
    assert len(vels) == 2 and all(abs(v - 4.0) < 1e-6 for v in vels)
    with pytest.raises(ValueError, match="together"):
        tnodes.NodeParams(net_width=160)


def test_depth_node_drives_pixel_to_meter():
    """depth image -> median distance -> pixel_to_meter = depth / fx, as in
    the JAX node; the first frame primes, the second publishes."""
    bus, node, depth = launch.bringup_flow(
        params=tnodes.NodeParams(pixel_to_meter=1.0, name="FB2",
                                 aggregate="median"),
        backend=tnodes.make_farneback_backend(device="cpu", levels=1,
                                              winsize=11, iterations=1))
    try:
        vels, ranges = [], []
        bus.subscribe("/optical_flow/FB2_velocity", vels.append)
        bus.subscribe("/camera/depth/median_distance", lambda m: ranges.append(m.range))
        bus.publish("/camera/color/camera_info", CameraInfoMsg(Header(0.0), fx=500.0))
        d = np.full((100, 100), 2000, np.uint16)
        d[:5] = 0  # invalid pixels are left out of the median
        bus.publish("/camera/aligned_depth_to_color/image_raw",
                    ImageMsg(Header(0.0), d, "16UC1"))
        assert ranges == [2.0]
        assert node.vel.pixel_to_meter == pytest.approx(2.0 / 500.0, abs=1e-12)
        img = np.random.default_rng(0).uniform(0, 255, (64, 64, 3)).astype(np.uint8)
        bus.publish("/camera/color/image_raw", ImageMsg(Header(1.0), img))
        bus.publish("/camera/color/image_raw", ImageMsg(Header(1.1), img))
        assert len(vels) == 1 and abs(vels[0].x) < 1e-3  # identical frames
    finally:
        node.stop()


@pytest.mark.parametrize("points", [[[64.0, 48.0], [10.0, 90.0]], [[-50.0, 500.0]]],
                         ids=["masked", "empty-mask"])
def test_junction_mask_node_matches_jax(points):
    """Synced image + PointCloud pairs: the backend receives the junction
    mask (all False falls back to the whole frame), and the masked
    velocities equal the JAX node's to 1e-6 relative (as the frame-size
    node test)."""
    pts = np.asarray(points, np.float32)
    frames = _camera_frames(n=4)
    params = dict(pixel_to_meter=1.0, name="J", aggregate="median")
    want, _, _ = _drive(jnodes.JunctionMaskFlowNode, frames,
                        jnodes.make_farneback_backend(**FB),
                        jnodes.NodeParams(**params), jrt.Bus, pts)
    got, _, node = _drive(tnodes.JunctionMaskFlowNode, frames,
                          tnodes.make_farneback_backend(device="cpu", **FB),
                          tnodes.NodeParams(**params), Bus, pts)
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-6)

    masks = []

    def backend(prev, cur, dt):
        flow = np.zeros(cur.shape + (2,), np.float32)
        flow[..., 0] = np.arange(cur.shape[1], dtype=np.float32)  # u = x
        return flow

    jn = tnodes.JunctionMaskFlowNode(backend, tnodes.NodeParams(**params))
    orig = jn.vel.update
    jn.vel.update = lambda flow, dt, mask: masks.append(mask) or orig(flow, dt, mask)
    bus = Bus(namespace="")
    jn.attach(bus)
    vel = []
    bus.subscribe("/optical_flow/J_velocity", lambda m: vel.append(m.x))
    for t in (1.0, 2.0):
        bus.publish("/camera/color/image_raw", ImageMsg(Header(t), frames[0]))
        bus.publish("/junction_detector/junctions", PointCloudMsg(Header(t + 0.004), pts))
    jn.stop()
    assert len(masks) == 1 and masks[0].shape == (H, W)
    assert np.array_equal(masks[0], tvelocity.junction_mask((H, W), pts, 11))
    # median x over the mask, or over the whole frame for an empty mask
    xs = np.nonzero(masks[0])[1] if masks[0].any() else np.arange(W)
    assert vel[0] == pytest.approx(float(np.median(xs)), abs=1e-6)


def test_color_backend_receives_bgr_classical_gets_bt601_gray():
    """Model backends get the uint8 BGR frame; classical backends the
    host-side BT.601 gray, bit-equal to the JAX node's."""
    frame = np.zeros((8, 8, 3), np.uint8)
    frame[..., 0], frame[..., 1], frame[..., 2] = 10, 100, 200
    seen = {}

    def fake_estimate(i1, i2):
        seen["img"] = i2.numpy()
        return torch.zeros(i2.shape[:2] + (2,))

    node = tnodes.FlowNode(tnodes.make_model_backend(fake_estimate, device="cpu"),
                           tnodes.NodeParams(name="M"))
    node._image_callback(ImageMsg(Header(0.0), frame))
    node._image_callback(ImageMsg(Header(0.1), frame))
    np.testing.assert_allclose(seen["img"][0, 0] * 255.0, [10, 100, 200], atol=1e-4)

    got = {}
    def gray_backend(prev, cur, dt):
        got["img"] = cur
        return np.zeros(cur.shape + (2,), np.float32)

    node2 = tnodes.FlowNode(gray_backend, tnodes.NodeParams(name="G"))
    node2._image_callback(ImageMsg(Header(0.0), frame))
    node2._image_callback(ImageMsg(Header(0.1), frame))
    rnd = np.random.default_rng(1).integers(0, 256, (5, 7, 3), dtype=np.uint8)
    assert np.array_equal(tnodes._bgr_to_gray_np(rnd), jnodes._bgr_to_gray_np(rnd))
    assert got["img"].dtype == np.float32
    assert np.array_equal(got["img"], jnodes._bgr_to_gray_np(frame))


def test_node_counts_failures_and_refuses_compressed_frames(tmp_path, capsys):
    """A frame whose processing raises is counted and its traceback
    printed; a compressed frame that does not decode is dropped without
    raising, as the JAX node drops it, and counted.  Debug images, the
    timing CSV and the memory CSV are written."""
    calls = []

    def backend(prev, cur, dt):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("launch failed")
        return np.ones(cur.shape + (2,), np.float32)

    p = tnodes.NodeParams(name="F", publish_debug_images=True, write_csv=True,
                          write_accel_csv=True, csv_dir=str(tmp_path))
    bus = Bus(namespace="")
    node = tnodes.FlowNode(backend, p, bus).attach()
    images = []
    bus.subscribe("/optical_flow/image_flow", lambda m: images.append(m.data))
    f = np.zeros((16, 24, 3), np.uint8)
    for t in range(4):
        bus.publish("/camera/color/image_raw", ImageMsg(Header(float(t)), f))
    assert node._process(ImageMsg(Header(5.0), b"\xff\xd8", "jpeg")) is None
    node.stop()
    assert (node.frames_processed, node.frames_failed) == (2, 2)
    assert "launch failed" in capsys.readouterr().err
    assert len(images) == 2 and images[0].shape == (16, 24, 3)
    rows = (tmp_path / "f_640x480.csv").read_text().splitlines()
    assert rows[0] == "timestamp,inference_time_s" and len(rows) == 3
    head = (tmp_path / "accel_usage_f.log").read_text().splitlines()[0]
    assert head == "timestamp,device,bytes_in_use,peak_bytes_in_use,bytes_limit"


def test_stream_mode_converges_restarts_and_ends_its_threads():
    """Producer/consumer mode recovers the camera's ground truth, runs
    again after its source is exhausted, and leaves no thread behind."""
    bus = Bus(namespace="restart")
    gt, p2m, fps = 0.05, 0.000857, 30.0
    node = tnodes.FlowNode(tnodes.make_farneback_backend(device="cpu", **FB),
                           tnodes.NodeParams(pixel_to_meter=p2m, name="S",
                                             smooth_window=3), bus)
    vels = []
    bus.subscribe("/optical_flow/S_velocity", lambda m: vels.append(m.x))
    try:
        for run in range(2):
            before, dropped = node.frames_processed, node.frames_dropped
            cam = tsources.SyntheticCamera(bus, width=W, height=H, fps=fps,
                                           n_frames=10, velocity_mps=gt,
                                           pixel_to_meter=p2m)
            node.start_stream(cam)
            assert node.wait(timeout=30.0)
            assert node.frames_processed > before
            # every frame is processed or dropped (the first of all primes)
            assert (node.frames_processed - before + node.frames_dropped
                    - dropped) == 10 - (run == 0)
    finally:
        node.stop()
    assert not any(t.is_alive() for t in node._threads)
    assert node.frames_failed == 0
    assert abs(np.median(vels) - gt) < 0.01


# --------------------------------------------------------- launch, demo

def test_bringup_flow_defaults_and_device():
    """The default backend runs on the card, so without one it raises
    unless the CPU is asked for; a misspelt Farneback keyword raises."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch.bringup_flow()
    with pytest.raises(TypeError, match="unexpected keyword"):
        tnodes.make_farneback_backend(device="cpu", winsze=13)
    bus, node, depth = launch.bringup_flow(device="cpu", with_depth=False)
    assert depth is None and node.p.name == "FLOW"
    node.stop()


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_demo_runs_on_the_cpu(fused, capsys):
    """The demo's self-check passes on the CPU; without ``--cpu`` it runs
    on the card, so with no card it raises."""
    argv = ["--frames", "12", "--width", "128", "--height", "96",
            "--fps", "200"] + (["--fused"] if fused else [])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            demo.main(argv)
    assert demo.main(["--cpu"] + argv) == 0
    out = capsys.readouterr().out
    assert "velocity error" in out and "OK" in out


# -------------------------------------------------------------- latency

def test_tracing_on_the_cpu(tmp_path):
    if not torch.cuda.is_available():
        assert tracing.device_memory_stats() == []
    with tracing.trace(str(tmp_path)):
        with tracing.annotate("step"):
            torch.ones(4).sum()
    assert (tmp_path / "trace.json").stat().st_size > 0
    stop = tracing.start_memory_monitor(str(tmp_path / "m.csv"), interval=0.05)
    stop()
    assert (tmp_path / "m.csv").read_text().startswith("timestamp,device,")


def test_exports_are_the_jax_names_less_what_waits():
    """The port exports the JAX runtime's names but one: the stream latency
    driver, which the benchmark's stream loop replaced
    (``portbench/loops/stream.py``) and whose removal ROADMAP.md records."""
    import pathlib

    port, ref = set(trt.__all__), set(jrt.__all__)
    assert port <= ref
    roadmap = (pathlib.Path(__file__).resolve().parent.parent / "ROADMAP.md").read_text()
    missing = sorted(ref - port)
    assert missing == ["measure_stream_latency"]
    assert all(name in roadmap for name in missing)
    assert all(getattr(trt, name) is not None for name in port)
