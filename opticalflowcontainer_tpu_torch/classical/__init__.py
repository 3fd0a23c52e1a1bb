"""Classical optical flow with cv2-parity APIs (Farneback, pyramidal
Lucas-Kanade)."""
from .farneback import (
    OPTFLOW_FARNEBACK_GAUSSIAN,
    OPTFLOW_USE_INITIAL_FLOW,
    calc_optical_flow_farneback,
    farneback_batched,
    farneback_clip,
    farneback_stream_planes,
    farneback_stream_step,
)
from .lucas_kanade import LKResult, calc_optical_flow_pyr_lk

__all__ = [
    "OPTFLOW_FARNEBACK_GAUSSIAN",
    "OPTFLOW_USE_INITIAL_FLOW",
    "LKResult",
    "calc_optical_flow_farneback",
    "calc_optical_flow_pyr_lk",
    "farneback_batched",
    "farneback_clip",
    "farneback_stream_planes",
    "farneback_stream_step",
]
