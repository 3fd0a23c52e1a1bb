"""Typed message payloads (sensor_msgs/geometry_msgs equivalents), the
port's copy of the reference's ``runtime/messages.py``.

Plain dataclasses over numpy arrays on the host: the bus moves references
between threads of one process, and payloads never live on the card.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Header:
    stamp: float  # seconds (host timebase)
    frame_id: str = ""


@dataclasses.dataclass(frozen=True)
class ImageMsg:
    """sensor_msgs/Image equivalent; ``data`` HWC uint8 (bgr8) or HW uint16
    (16UC1 depth), per ``encoding``."""

    header: Header
    data: np.ndarray
    encoding: str = "bgr8"


@dataclasses.dataclass(frozen=True)
class CameraInfoMsg:
    header: Header
    fx: float
    fy: float = 0.0
    width: int = 0
    height: int = 0


@dataclasses.dataclass(frozen=True)
class RangeMsg:
    """sensor_msgs/Range equivalent (the depth nodes publish median depth on
    it — reference depth_subandpub_node.py:16-85)."""

    header: Header
    range: float
    min_range: float = 0.0
    max_range: float = 10.0


@dataclasses.dataclass(frozen=True)
class Float32Msg:
    data: float


@dataclasses.dataclass(frozen=True)
class Vector3StampedMsg:
    """geometry_msgs/Vector3Stamped equivalent; vx in m/s on ``x``."""

    header: Header
    x: float
    y: float = 0.0
    z: float = 0.0


@dataclasses.dataclass(frozen=True)
class PointCloudMsg:
    """sensor_msgs/PointCloud equivalent: junction points [(x, y), ...]."""

    header: Header
    points: np.ndarray  # [N, 2] float32


@dataclasses.dataclass(frozen=True)
class FlowMsg:
    header: Header
    flow: np.ndarray  # [H, W, 2] float32
