"""Runtime nodes: the per-frame pipeline stages (the port's copy of the
reference's ``runtime/nodes.py``).

:class:`FlowNode` is the centerpiece, the equivalent of the reference
system's ``*_node.py`` family.  One class covers both execution styles:

- topic-driven (``node.attach(bus)`` subscribes to the image topic);
- producer/consumer streaming (``node.start_stream(source)`` runs capture
  and inference on separate threads joined by a bounded drop-newest queue).

Flow backends are callables ``(prev_gray_or_bgr, cur, dt) -> flow [H, W,
2]`` numpy; :func:`make_farneback_backend` and :func:`make_model_backend`
build them on a device (the card unless ``device="cpu"``), and the fused
backends of :mod:`.fused` return one aggregated displacement instead.  A
backend binds its device when it is built and makes it current in whatever
thread runs it.  The nodes never pick a device.  Velocity estimation,
depth/fx-driven scaling, junction masking, smoothing, debug-image topics
and CSV timing hang off the node.  :class:`LKVelocityNode` is the sparse
Lucas-Kanade counterpart, and :class:`JunctionDetectorNode` publishes the
junctions the masked node (:class:`JunctionMaskFlowNode`) joins with its
frames.
"""
from __future__ import annotations

import dataclasses
import queue as queue_mod
import threading
import time
import traceback
from typing import Callable

import numpy as np
import torch

from ..classical.farneback import calc_optical_flow_farneback, check_flow_kwargs
from ..classical.lucas_kanade import calc_optical_flow_pyr_lk
from ..core.corners import good_features_to_track
from ..core.device import device_scope, resolve_device
from ..core.resize import resize_area, resize_nearest
from ..utils.imcodec import imdecode
from .bus import ApproximateTimeSynchronizer, Bus
from .messages import (
    FlowMsg,
    Header,
    ImageMsg,
    PointCloudMsg,
    RangeMsg,
    Vector3StampedMsg,
)
from .timing import CsvTimer
from .velocity import VelocityEstimator, junction_mask


@dataclasses.dataclass
class NodeParams:
    """declare_parameter-equivalent config of a flow node."""

    width: int = 640
    height: int = 480
    fps: float = 30.0
    pixel_to_meter: float = 0.000857
    aggregate: str = "mean"  # mean | median
    smooth_window: int = 5
    max_speed: float | None = None
    name: str = "FLOW"
    write_csv: bool = False
    write_accel_csv: bool = False  # the card's memory, sampled to a CSV
    csv_dir: str = "."
    publish_debug_images: bool = False
    junction_box: int = 11
    queue_size: int = 2
    # Fixed net input size (None = run at frame size).  Frames are resized
    # on the host (INTER_AREA, the mask INTER_NEAREST) and the displacement
    # is scaled back by frame_w / net_w, so velocities stay in SOURCE-pixel
    # units.
    net_width: int | None = None
    net_height: int | None = None

    def __post_init__(self):
        # setting only one of net_width/net_height would silently run at
        # frame size (the resize guard needs both) -- fail loudly instead
        if (self.net_width is None) != (self.net_height is None):
            raise ValueError(
                "net_width and net_height must be set together "
                f"(got net_width={self.net_width}, "
                f"net_height={self.net_height})")


class FlowNode:
    """image in -> velocity out.

    Topics out: /optical_flow/<NAME>_velocity, /optical_flow/<NAME>_smooth_velocity,
    /optical_flow/<NAME>_flow (flow-field backends), plus image_live_feed /
    image_flow debug topics when enabled.
    Topics in (attach): /camera/color/image_raw, /camera/color/camera_info,
    /camera/depth/median_distance.

    Calibration: ``params.pixel_to_meter`` seeds the estimator at construction;
    at runtime it is owned by ``self.vel`` (updated dynamically from depth/fx
    topics) -- change ``node.vel.pixel_to_meter``, not ``node.p``, after init.

    Compressed frames (encoding ``"jpeg"`` or ``"compressed"``: the bytes
    of a JPEG or PNG file, as a ROS CompressedImage carries them) are
    decoded to BGR as ``cv2.imdecode(..., IMREAD_COLOR)`` decodes them, by
    the port's compiled decoders unless ``force_python_decoder`` asks for
    the plain ones (``utils.imcodec``).

    Counters: ``frames_processed`` (velocities published), ``frames_dropped``
    (stream mode: frames the full queue refused) and ``frames_failed``
    (frames whose processing raised, whose traceback is printed, and
    compressed frames that do not decode, which are dropped quietly as the
    reference drops them; the node goes on, as the reference's nodes do).
    """

    def __init__(self, backend: Callable, params: NodeParams | None = None,
                 bus: Bus | None = None, force_python_decoder: bool = False):
        self.backend = backend
        self.force_python_decoder = force_python_decoder
        self.p = params or NodeParams()
        self.bus = bus or Bus()
        self.vel = VelocityEstimator(
            self.p.pixel_to_meter, self.p.aggregate, self.p.smooth_window,
            self.p.max_speed,
        )
        self.timer = CsvTimer(
            f"{self.p.csv_dir}/{self.p.name.lower()}_{self.p.width}x{self.p.height}.csv"
        ) if self.p.write_csv else None
        self._accel_stop = None
        if self.p.write_accel_csv:
            from .tracing import start_memory_monitor

            self._accel_stop = start_memory_monitor(
                f"{self.p.csv_dir}/accel_usage_{self.p.name.lower()}.log"
            )
        self._prev: tuple[np.ndarray, float] | None = None
        self._subs = []
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._queue: queue_mod.Queue = queue_mod.Queue(maxsize=self.p.queue_size)
        self.frames_processed = 0
        self.frames_dropped = 0
        self.frames_failed = 0

    # ---------------------------------------------------------- topic mode
    def attach(self, bus: Bus | None = None, direct: bool = True):
        if bus is not None:
            self.bus = bus
        self._subs.append(
            self.bus.subscribe("/camera/color/image_raw", self._image_callback,
                               depth=10, direct=direct)
        )
        self._subscribe_calibration(direct)
        return self

    def _subscribe_calibration(self, direct: bool) -> None:
        self._subs.append(
            self.bus.subscribe("/camera/color/camera_info",
                               lambda m: self.vel.set_fx(m.fx), direct=direct)
        )
        self._subs.append(
            self.bus.subscribe("/camera/depth/median_distance",
                               lambda m: self.vel.set_depth(m.range), direct=direct)
        )

    def _image_callback(self, msg: ImageMsg, mask: np.ndarray | None = None):
        try:
            self._process(msg, mask)
        except Exception:  # per-frame fault boundary (reference style)
            self.frames_failed += 1
            traceback.print_exc()

    # ------------------------------------------------------- stream mode
    def start_stream(self, source):
        """Producer/consumer: capture thread fills a bounded queue (dropping
        the newest frame on overflow), inference thread drains it."""
        # _stop latches when a source exhausts (or on stop()); clear it so a
        # second start_stream on the same node processes frames again
        self._stop.clear()

        def producer():
            # pace at the source's fps, like a real camera delivers frames,
            # and stamp each frame with its capture time on that clock: a
            # producer thread that runs late (the interpreter lock, a busy
            # host) then catches up without squeezing the frames' stamps,
            # which would inflate the velocity of every pair it squeezed
            period = 1.0 / getattr(source, "fps", self.p.fps)
            t_next = time.monotonic()
            for frame in source.frames():
                if self._stop.is_set():
                    return
                msg = ImageMsg(Header(t_next), frame, "bgr8")
                try:
                    self._queue.put_nowait(msg)
                except queue_mod.Full:
                    self.frames_dropped += 1  # drop-newest backpressure
                t_next += period
                delay = t_next - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
            self._stop.set()

        def consumer():
            while not (self._stop.is_set() and self._queue.empty()):
                try:
                    msg = self._queue.get(timeout=0.1)
                except queue_mod.Empty:
                    continue
                self._image_callback(msg)

        self._threads = [
            threading.Thread(target=producer, daemon=True),
            threading.Thread(target=consumer, daemon=True),
        ]
        for t in self._threads:
            t.start()
        return self

    def wait(self, timeout: float = 60.0) -> bool:
        """Join the stream's threads, ``timeout`` seconds for all; True when
        every one has ended."""
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(max(deadline - time.monotonic(), 0.0))
        return not any(t.is_alive() for t in self._threads)

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)
        for s in self._subs:
            self.bus.unsubscribe(s)
        self._subs = []
        if self._accel_stop is not None:
            self._accel_stop()
            self._accel_stop = None

    # ------------------------------------------------------------ core
    def _process(self, msg: ImageMsg, mask: np.ndarray | None = None):
        t0 = time.perf_counter()
        frame = msg.data
        if msg.encoding in ("jpeg", "compressed"):
            frame = imdecode(frame, self.force_python_decoder)
            if frame is None:
                self.frames_failed += 1
                return
        # Learned-model backends see the full color frame; classical
        # backends get BT.601 grayscale (what cv2.cvtColor BGR2GRAY computes).
        wants_color = bool(getattr(self.backend, "wants_color", False))
        if frame.ndim == 3 and frame.shape[-1] == 3:
            obs = frame if wants_color else _bgr_to_gray_np(frame)
        elif frame.ndim == 3:
            obs = frame[..., 0].astype(np.float32)
        else:
            obs = frame.astype(np.float32)
        u_scale = v_scale = 1.0
        net_resized = False
        if (self.p.net_width is not None and self.p.net_height is not None
                and obs.shape[:2] != (self.p.net_height, self.p.net_width)):
            net_resized = True
            net = (self.p.net_height, self.p.net_width)
            u_scale = obs.shape[1] / float(self.p.net_width)
            v_scale = obs.shape[0] / float(self.p.net_height)
            obs = resize_area(np.ascontiguousarray(obs, np.float32), net)
            if mask is not None:
                mask = resize_nearest(mask.astype(np.uint8), net).astype(bool)
        if self._prev is None:
            self._prev = (obs, msg.header.stamp)
            return
        prev, t_prev = self._prev
        self._prev = (obs, msg.header.stamp)
        dt = msg.header.stamp - t_prev

        if getattr(self.backend, "returns_displacement", False):
            # fused device path (runtime.fused): the backend aggregates the
            # horizontal displacement on the device and returns one scalar
            du = self.backend(prev, obs, dt, mask)
            vx, vx_smooth = self.vel.update_from_displacement(
                du * u_scale if net_resized else du, dt)
            flow = None
        else:
            flow = np.asarray(self.backend(prev, obs, dt))
            if net_resized:
                flow = flow * np.asarray([u_scale, v_scale], np.float32)
            vx, vx_smooth, _vy = self.vel.update(flow, dt, mask)
        name = self.p.name
        self.bus.publish(
            f"/optical_flow/{name}_velocity",
            Vector3StampedMsg(msg.header, vx),
        )
        self.bus.publish(
            f"/optical_flow/{name}_smooth_velocity",
            Vector3StampedMsg(msg.header, vx_smooth),
        )
        if flow is not None:
            self.bus.publish(f"/optical_flow/{name}_flow", FlowMsg(msg.header, flow))
        if self.p.publish_debug_images:
            self.bus.publish("/optical_flow/image_live_feed", ImageMsg(msg.header, frame))
            if flow is not None:
                from .viz import flow_to_bgr

                self.bus.publish(
                    "/optical_flow/image_flow",
                    ImageMsg(msg.header, flow_to_bgr(flow)),
                )
        if self.timer:
            self.timer.record(msg.header.stamp, time.perf_counter() - t0)
        self.frames_processed += 1


class DepthNode:
    """Depth image in -> median distance out: median over a central ROI (or
    the whole image), times depth_scale, published as RangeMsg."""

    def __init__(self, bus: Bus, depth_scale: float = 0.001, roi: int = 250,
                 depth_mode: str = "roi", direct: bool = True):
        self.bus = bus
        self.depth_scale = depth_scale
        self.roi = roi
        self.depth_mode = depth_mode
        self._sub = bus.subscribe(
            "/camera/aligned_depth_to_color/image_raw", self._callback, direct=direct
        )

    def _callback(self, msg: ImageMsg):
        depth = msg.data
        if self.depth_mode == "roi":
            H, W = depth.shape[:2]
            r = self.roi // 2
            cy, cx = H // 2, W // 2
            depth = depth[max(cy - r, 0) : cy + r, max(cx - r, 0) : cx + r]
        valid = depth[depth > 0]
        if valid.size == 0:
            return
        median = float(np.median(valid)) * self.depth_scale
        self.bus.publish(
            "/camera/depth/median_distance", RangeMsg(msg.header, median)
        )


class JunctionMaskFlowNode(FlowNode):
    """Junction-masked flow: time-synchronized image + junction PointCloud,
    flow aggregated only over ``junction_box`` squares around each junction
    (all of the frame when the mask is empty)."""

    def attach(self, bus: Bus | None = None, direct: bool = True):
        if bus is not None:
            self.bus = bus
        self._sync = ApproximateTimeSynchronizer(
            self.bus,
            ["/camera/color/image_raw", "/junction_detector/junctions"],
            self._synced_callback,
            queue_size=10,
            slop=0.01,
            direct=direct,
        )
        self._subs.extend(self._sync._subs)
        self._subscribe_calibration(direct)
        return self

    def _synced_callback(self, img_msg: ImageMsg, junc_msg: PointCloudMsg):
        mask = junction_mask(
            img_msg.data.shape[:2], junc_msg.points, self.p.junction_box
        )
        if self.p.publish_debug_images:
            self.bus.publish(
                "/optical_flow/image_mask",
                ImageMsg(img_msg.header, (mask * 255).astype(np.uint8), "mono8"),
            )
        self._image_callback(img_msg, mask)


class JunctionDetectorNode:
    """Image in -> junction PointCloud out (the reference's C++ detector
    node).  Publishes only when at least ``min_publish`` junctions are
    found, as the reference does.  The detector is the compiled one unless
    ``force_python`` asks for the plain one (``native.detect_junctions``);
    ``rotated`` fits minimum-area rectangles to the cells."""

    def __init__(self, bus: Bus, grid_area: float = 200.0, area_tol: float = 2.0,
                 cluster_eps: float = 6.0, min_publish: int = 4,
                 direct: bool = True, force_python: bool = False,
                 rotated: bool = False):
        from ..native import detect_junctions

        self._detect = detect_junctions
        self.bus = bus
        self.grid_area = grid_area
        self.area_tol = area_tol
        self.cluster_eps = cluster_eps
        self.min_publish = min_publish
        self.force_python = force_python
        self.rotated = rotated
        self._sub = bus.subscribe("/camera/color/image_raw", self._callback,
                                  direct=direct)

    def stop(self) -> None:
        self.bus.unsubscribe(self._sub)

    def _callback(self, msg: ImageMsg):
        img = msg.data
        if img.ndim != 3 or img.shape[2] != 3:
            return
        pts = self._detect(
            img, grid_area=self.grid_area, area_tol=self.area_tol,
            cluster_eps=self.cluster_eps, force_python=self.force_python,
            rotated=self.rotated,
        )
        if len(pts) >= self.min_publish:
            self.bus.publish(
                "/junction_detector/junctions", PointCloudMsg(msg.header, pts)
            )


class LKVelocityNode:
    """Sparse Lucas-Kanade velocity node: track good features between frames
    and publish the median (or mean) of their x-displacement as metric
    velocity: the reference's classical ``lucas_kanade_node`` (BASELINE
    config 2).

    Corners are re-detected every ``redetect_every`` frames, and whenever
    fewer than 4 points survive, with :func:`~..core.corners.good_features_to_track`
    (cv2's ``goodFeaturesToTrack(gray, max_corners, 0.01, 8)``) and tracked
    by :func:`~..classical.lucas_kanade.calc_optical_flow_pyr_lk` in
    between.  The point count is padded to ``max_corners`` with the image
    centre (one static shape for the stream); the padded rows are masked out
    of the velocity.  The node binds its device when it is built (the card
    unless ``device="cpu"``) and makes it current in whatever thread runs
    its callback.  Frames whose processing raises are counted in
    ``frames_failed`` (the traceback is printed and the node goes on, as
    :class:`FlowNode`)."""

    def __init__(self, bus: Bus, params: NodeParams | None = None,
                 max_corners: int = 200, redetect_every: int = 10,
                 win_size: int = 21, max_level: int = 3, direct: bool = True,
                 *, device=None):
        self.device = resolve_device(device)
        self.bus = bus
        self.p = params or NodeParams(name="LK", aggregate="median")
        self.vel = VelocityEstimator(
            self.p.pixel_to_meter, self.p.aggregate, self.p.smooth_window,
            self.p.max_speed,
        )
        self.max_corners = max_corners
        self.redetect_every = redetect_every
        self.win_size = win_size
        self.max_level = max_level
        self._prev: tuple[torch.Tensor, float] | None = None
        self._pts: np.ndarray | None = None
        self._n_valid = 0
        self._since_detect = 0
        self.frames_processed = 0
        self.frames_failed = 0
        self._subs = [
            bus.subscribe("/camera/color/image_raw", self._callback, direct=direct),
            bus.subscribe("/camera/color/camera_info",
                          lambda m: self.vel.set_fx(m.fx), direct=direct),
            bus.subscribe("/camera/depth/median_distance",
                          lambda m: self.vel.set_depth(m.range), direct=direct),
        ]

    def stop(self) -> None:
        for s in self._subs:
            self.bus.unsubscribe(s)
        self._subs = []

    def _detect(self, gray: torch.Tensor) -> np.ndarray:
        # the 8-bit image cv2 would be given: the fp32 gray truncated
        pts = good_features_to_track(gray.to(torch.uint8), self.max_corners,
                                     0.01, 8, device=self.device)
        n = min(len(pts), self.max_corners)
        H, W = gray.shape
        out = np.empty((self.max_corners, 2), np.float32)
        out[:n] = pts[:n]
        # padding tracks a harmless interior point, masked out of the velocity
        out[n:] = (W / 2.0, H / 2.0)
        self._n_valid = n
        return out

    def _callback(self, msg: ImageMsg):
        try:
            with device_scope(self.device):
                self._process(msg)
        except Exception:  # per-frame fault boundary, as FlowNode's
            self.frames_failed += 1
            traceback.print_exc()

    def _process(self, msg: ImageMsg):
        frame = msg.data
        gray = _bgr_to_gray_np(frame) if frame.ndim == 3 else frame.astype(np.float32)
        gray = torch.from_numpy(np.ascontiguousarray(gray)).to(self.device)
        if (self._prev is None or self._pts is None
                or self._since_detect >= self.redetect_every):
            self._pts = self._detect(gray)
            self._since_detect = 0
            if self._prev is None:
                self._prev = (gray, msg.header.stamp)
                return
        prev, t_prev = self._prev
        self._prev = (gray, msg.header.stamp)
        dt = msg.header.stamp - t_prev
        res = calc_optical_flow_pyr_lk(
            prev, gray, self._pts, win_size=(self.win_size, self.win_size),
            max_level=self.max_level, device=self.device)
        tracked = res.pts.cpu().numpy()
        ok = res.status.cpu().numpy().astype(bool)
        ok[self._n_valid:] = False
        disp = tracked[ok] - self._pts[ok]
        self._since_detect += 1
        if len(disp) < 4:
            self._pts = None  # re-detect on the next frame
            return
        agg = np.median if self.p.aggregate == "median" else np.mean
        vx, vx_smooth = self.vel.update_from_displacement(
            float(agg(disp[:, 0])), dt)
        name = self.p.name
        self.bus.publish(f"/optical_flow/{name}_velocity",
                         Vector3StampedMsg(msg.header, vx))
        self.bus.publish(f"/optical_flow/{name}_smooth_velocity",
                         Vector3StampedMsg(msg.header, vx_smooth))
        # keep tracking from the new positions
        new_pts = self._pts.copy()
        new_pts[ok] = tracked[ok]
        self._pts = new_pts
        self.frames_processed += 1


# ---------------------------------------------------------------- backends

def make_farneback_backend(*, device=None, **kwargs) -> Callable:
    """Farneback flow-node backend ``(prev, cur, dt) -> flow [H, W, 2]``
    numpy: ``classical.calc_optical_flow_farneback`` with ``kwargs`` on
    ``device`` (the card unless ``"cpu"`` is asked for), the frames being
    the node's host-side BT.601 gray.  ``backend.flow_tensor`` is the same
    call with the flow left on ``backend.device`` (what the adaptive
    wrapper chains on the device)."""
    check_flow_kwargs("make_farneback_backend", kwargs)
    dev = resolve_device(device)

    def flow_tensor(prev, cur, dt):
        with device_scope(dev):
            return calc_optical_flow_farneback(prev, cur, device=dev, **kwargs)

    def backend(prev, cur, dt):
        return flow_tensor(prev, cur, dt).cpu().numpy()

    backend.device = dev
    backend.flow_tensor = flow_tensor
    return backend


def _bgr_to_gray_np(frame: np.ndarray) -> np.ndarray:
    """Host-side BT.601 gray in fp32 (cv2 BGR2GRAY's weights, the
    reference's order of the sum)."""
    f = frame.astype(np.float32)
    return 0.114 * f[..., 0] + 0.587 * f[..., 1] + 0.299 * f[..., 2]


def make_model_backend(estimate_fn: Callable, bgr_to_rgb: bool = False, *,
                       device=None) -> Callable:
    """Wrap a model ``estimate``-style callable (img1, img2) -> flow as a
    flow-node backend ``(prev, cur, dt) -> flow`` [H, W, 2] numpy.

    The node hands over uint8 BGR frames (``backend.wants_color``); they are
    uploaded as they are and turned into float [0, 1] HWC on ``device`` (the
    card unless ``"cpu"`` is asked for).  The models take BGR, so the default
    keeps it; ``bgr_to_rgb=True`` flips the channels for RGB-trained nets.
    Gray frames are stacked to 3 channels.  NaN and Inf in the flow become
    0, as the reference scrubs them."""
    dev = resolve_device(device)

    def prep(frame) -> torch.Tensor:
        if not isinstance(frame, torch.Tensor):
            frame = torch.as_tensor(np.ascontiguousarray(frame))
        x = frame.to(dev).float() / 255.0
        if x.dim() == 2:
            return x[..., None].expand(*x.shape, 3)
        return x.flip(-1) if bgr_to_rgb else x

    def flow_tensor(prev, cur, dt):
        with device_scope(dev):
            flow = estimate_fn(prep(prev), prep(cur))
            return torch.nan_to_num(flow, nan=0.0, posinf=0.0, neginf=0.0)

    def backend(prev, cur, dt):
        return flow_tensor(prev, cur, dt).cpu().numpy()

    backend.wants_color = True
    backend.device = dev
    backend.flow_tensor = flow_tensor
    return backend
