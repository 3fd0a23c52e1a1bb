"""Streaming runtime: the ROS2-node-equivalent layer (the port's copy of the
reference's ``runtime`` package, on the port's Farneback and models).

A thread-safe pub/sub :class:`~.bus.Bus` with depth-limited subscriptions
and approximate-time joins stands in for DDS; :class:`SyntheticCamera`
stands in for the RealSense; nodes reproduce the per-frame pipeline --
flow estimation, depth-driven pixel-to-meter scaling, junction masking,
velocity smoothing, debug-image topics, CSV timing; :class:`MultiStreamFlow`
batches N camera streams into one flow call.  Flow runs on the card unless
a backend is built with ``device="cpu"``.

Topic names follow the reference system:

- ``/camera/color/image_raw``            (ImageMsg)
- ``/camera/color/camera_info``          (CameraInfoMsg: fx)
- ``/camera/aligned_depth_to_color/image_raw`` (ImageMsg uint16)
- ``/camera/depth/median_distance``      (RangeMsg)
- ``/junction_detector/junctions``       (PointCloudMsg)
- ``/optical_flow/<MODEL>_velocity`` and ``..._smooth_velocity``
  (Vector3StampedMsg, vx in m/s)
- ``/optical_flow/image_live_feed|image_flow|image_mask`` (ImageMsg)

The junction detector runs on the host (``native.detect_junctions``), in
process (:class:`JunctionDetectorNode`) or in its own process over the TCP
bus bridge (``launch.bringup_junction_remote``).  :class:`VideoFileSource`
plays Motion-JPEG and uncompressed AVI files through the port's own
demuxer and JPEG decoder, and :class:`FlowNode` decodes compressed (JPEG
or PNG) frames with the port's own decoders.
"""
from .bus import Bus, Subscription, ApproximateTimeSynchronizer
from .messages import (
    ImageMsg,
    CameraInfoMsg,
    RangeMsg,
    Float32Msg,
    Vector3StampedMsg,
    PointCloudMsg,
    FlowMsg,
)
from .sources import FrameDirectorySource, SyntheticCamera, VideoFileSource
from .nodes import (
    FlowNode,
    DepthNode,
    JunctionMaskFlowNode,
    JunctionDetectorNode,
    LKVelocityNode,
    NodeParams,
    make_farneback_backend,
    make_model_backend,
)
from .multistream import (
    MultiStreamFlow,
    make_batched_farneback,
    make_batched_fused_farneback,
    make_stateful_batched_fused_farneback,
)
from .fused import (
    FusedFarnebackStream,
    FusedModelStream,
    make_fused_farneback_backend,
    make_fused_model_backend,
)
from .junction_tracking import JunctionTracker
from .adaptive import AdaptiveParams, make_adaptive_backend
from .velocity import VelocityEstimator

__all__ = [
    "Bus",
    "Subscription",
    "ApproximateTimeSynchronizer",
    "ImageMsg",
    "CameraInfoMsg",
    "RangeMsg",
    "Float32Msg",
    "Vector3StampedMsg",
    "PointCloudMsg",
    "FlowMsg",
    "SyntheticCamera",
    "FrameDirectorySource",
    "VideoFileSource",
    "FlowNode",
    "DepthNode",
    "JunctionMaskFlowNode",
    "JunctionDetectorNode",
    "LKVelocityNode",
    "NodeParams",
    "make_farneback_backend",
    "make_model_backend",
    "MultiStreamFlow",
    "make_batched_farneback",
    "make_batched_fused_farneback",
    "make_stateful_batched_fused_farneback",
    "FusedFarnebackStream",
    "FusedModelStream",
    "make_fused_farneback_backend",
    "make_fused_model_backend",
    "JunctionTracker",
    "AdaptiveParams",
    "make_adaptive_backend",
    "VelocityEstimator",
]
