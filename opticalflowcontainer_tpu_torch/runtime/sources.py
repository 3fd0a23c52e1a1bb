"""Frame sources: stand-ins for the RealSense camera (the port's copy of the
reference's ``runtime/sources.py``).

:class:`SyntheticCamera` renders a procedurally textured scene translating
at a known metric velocity; the ground truth makes end-to-end velocity
tests self-checking.  :class:`VideoFileSource` plays an AVI file (Motion
JPEG or uncompressed 24-bit) through the port's own demuxer and JPEG
decoder (``utils.avi``), :class:`FrameDirectorySource` a directory of PNG
frames in name order, read by the port's own PNG reader, and
:class:`RealSenseSource` a live RealSense camera (it needs
``pyrealsense2``).  A source can ``run()`` on a thread, publishing
``ImageMsg`` to a bus topic with host-timebase stamps, or be iterated
synchronously.
"""
from __future__ import annotations

import glob
import os
import threading
import time
from typing import Iterator

import numpy as np

from .bus import Bus
from .messages import CameraInfoMsg, Header, ImageMsg


class _BaseSource:
    topic = "/camera/color/image_raw"
    info_topic = "/camera/color/camera_info"

    def __init__(self, bus: Bus | None = None, fps: float = 30.0, fx: float = 600.0):
        self.bus = bus
        self.fps = fps
        self.fx = fx
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def frames(self) -> Iterator[np.ndarray]:  # pragma: no cover - abstract
        raise NotImplementedError

    def start(self):
        assert self.bus is not None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def _run(self):
        self.bus.publish(
            self.info_topic,
            CameraInfoMsg(Header(time.monotonic()), fx=self.fx),
            latch=True,
        )
        period = 1.0 / self.fps
        t_next = time.monotonic()
        for frame in self.frames():
            if self._stop.is_set():
                break
            # the frame's capture time on the source's clock (see
            # FlowNode.start_stream): a late thread does not squeeze stamps
            self.bus.publish(self.topic, ImageMsg(Header(t_next), frame, "bgr8"))
            t_next += period
            delay = t_next - time.monotonic()
            if delay > 0:
                time.sleep(delay)


class SyntheticCamera(_BaseSource):
    """Textured scene translating at ``velocity_mps`` given ``pixel_to_meter``
    (so expected mean flow = velocity / (pixel_to_meter * fps))."""

    def __init__(
        self,
        bus: Bus | None = None,
        width: int = 640,
        height: int = 480,
        fps: float = 30.0,
        n_frames: int = 60,
        velocity_mps: float = 0.1,
        pixel_to_meter: float = 0.000857,
        seed: int = 0,
        fx: float = 600.0,
    ):
        super().__init__(bus, fps, fx)
        self.width = width
        self.height = height
        self.n_frames = n_frames
        self.velocity_mps = velocity_mps
        self.pixel_to_meter = pixel_to_meter
        rng = np.random.default_rng(seed)
        self.px_per_frame = velocity_mps / (pixel_to_meter * fps)
        # canvas wide enough for the full wrap-free travel of the window
        travel = int(np.ceil(abs(self.px_per_frame) * n_frames)) + 4
        canvas = rng.uniform(0, 255, (height + 8, width + travel + 4)).astype(np.float32)
        # smooth it so flow estimators have gradients to lock onto
        k = np.ones(5) / 5.0
        canvas = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, canvas)
        canvas = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, canvas)
        self._canvas = canvas
        self._travel = travel

    def frame_at(self, idx: int) -> np.ndarray:
        # window slides LEFT over the canvas as idx grows => scene content
        # appears to move RIGHT: positive u, positive vx, matching the sign of
        # ``velocity_mps``.
        # start at the end of the canvas that leaves idx*|ppf| of travel in
        # the window's direction: positive velocity walks shift travel -> 0,
        # negative walks 0 -> travel (a fixed positive start would clamp
        # after ~2 frames and freeze the scene while GT stays nonzero)
        start = self._travel if self.px_per_frame >= 0 else 0
        shift = start - idx * self.px_per_frame
        x0 = int(np.floor(shift))
        frac = shift - x0
        x0 = max(min(x0, self._canvas.shape[1] - self.width - 2), 0)
        a = self._canvas[: self.height, x0 : x0 + self.width]
        b = self._canvas[: self.height, x0 + 1 : x0 + 1 + self.width]
        gray = (1 - frac) * a + frac * b
        return np.repeat(gray[..., None], 3, axis=-1).astype(np.uint8)

    def frames(self):
        for i in range(self.n_frames):
            yield self.frame_at(i)


class VideoFileSource(_BaseSource):
    """The frames of the AVI file at ``path`` as BGR uint8 until the file
    ends, as the reference's ``cv2.VideoCapture`` playback yields them
    (``utils.avi.AviReader``: Motion JPEG decoded bit for bit as
    ``cv2.imdecode`` decodes each frame, or uncompressed 24-bit frames; any
    other coding raises ``ValueError`` naming it).  The JPEG decoder is the
    compiled one unless ``force_python`` asks for the plain one.  ``fps``
    paces ``run()``; the file's own rate is ``file_fps``."""

    def __init__(self, path: str, bus: Bus | None = None, fps: float = 30.0,
                 fx: float = 600.0, force_python: bool = False):
        from ..utils.avi import AviReader

        super().__init__(bus, fps, fx)
        self.path = path
        self._reader = AviReader(path, force_python=force_python)
        self.file_fps = self._reader.fps

    def frames(self):
        yield from self._reader.frames()


class FrameDirectorySource(_BaseSource):
    """The PNG files of ``directory`` matching ``pattern``, in sorted order,
    as BGR uint8 frames (``utils.png.imread``, what ``cv2.imread``
    returns)."""

    def __init__(self, directory: str, bus: Bus | None = None, fps: float = 30.0,
                 pattern: str = "*.png", fx: float = 600.0):
        super().__init__(bus, fps, fx)
        self.files = sorted(glob.glob(os.path.join(directory, pattern)))

    def frames(self):
        from ..utils.png import imread

        for f in self.files:
            yield imread(f)


class RealSenseSource(_BaseSource):
    """Live RealSense camera source (the reference's primary input).
    Requires ``pyrealsense2``, which the card's machine does not have, so
    construction raises a clear error there; the synthetic / video /
    directory sources are the drop-in stand-ins."""

    def __init__(self, bus: Bus | None = None, width: int = 640, height: int = 480,
                 fps: float = 30.0):
        try:
            import pyrealsense2 as rs  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "pyrealsense2 not available; use SyntheticCamera / "
                "VideoFileSource / FrameDirectorySource instead"
            ) from e
        super().__init__(bus, fps)
        self.width = width
        self.height = height

    def frames(self):  # pragma: no cover - requires hardware
        import pyrealsense2 as rs

        pipeline = rs.pipeline()
        cfg = rs.config()
        cfg.enable_stream(rs.stream.color, self.width, self.height,
                          rs.format.bgr8, int(self.fps))
        profile = pipeline.start(cfg)
        intr = (
            profile.get_stream(rs.stream.color)
            .as_video_stream_profile()
            .get_intrinsics()
        )
        self.fx = intr.fx
        try:
            while True:
                frames = pipeline.wait_for_frames()
                color = frames.get_color_frame()
                if color:
                    yield np.asanyarray(color.get_data())
        finally:
            pipeline.stop()
