"""Middlebury ``.flo`` flow-file IO (the port's copy of the reference's
``utils/flo.py``): the 'PIEH' float magic (bytes 80, 73, 69, 72), int32
width and height, then the [H, W, 2] float32 flow, little-endian."""
from __future__ import annotations

import numpy as np

_MAGIC = 202021.25  # 'PIEH' read as a float32


def write_flo(path: str, flow) -> None:
    flow = np.asarray(flow, np.float32)
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"flow must be [H, W, 2], got {flow.shape}")
    H, W = flow.shape[:2]
    with open(path, "wb") as f:
        np.float32(_MAGIC).tofile(f)
        np.int32(W).tofile(f)
        np.int32(H).tofile(f)
        flow.tofile(f)


def read_flo(path: str) -> np.ndarray:
    """The [H, W, 2] float32 flow of a ``.flo`` file."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, 1)
        if magic.size != 1 or magic[0] != np.float32(_MAGIC):
            raise ValueError(f"{path}: bad .flo magic {magic}")
        W = int(np.fromfile(f, np.int32, 1)[0])
        H = int(np.fromfile(f, np.int32, 1)[0])
        data = np.fromfile(f, np.float32, H * W * 2)
    if data.size != H * W * 2:
        raise ValueError(f"{path}: {data.size} floats for a {W}x{H} flow")
    return data.reshape(H, W, 2)
