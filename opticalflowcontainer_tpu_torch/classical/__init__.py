"""Classical optical flow with cv2-parity APIs (Farneback)."""
from .farneback import (
    OPTFLOW_FARNEBACK_GAUSSIAN,
    OPTFLOW_USE_INITIAL_FLOW,
    calc_optical_flow_farneback,
    farneback_batched,
    farneback_clip,
    farneback_stream_planes,
    farneback_stream_step,
)

__all__ = [
    "OPTFLOW_FARNEBACK_GAUSSIAN",
    "OPTFLOW_USE_INITIAL_FLOW",
    "calc_optical_flow_farneback",
    "farneback_batched",
    "farneback_clip",
    "farneback_stream_planes",
    "farneback_stream_step",
]
