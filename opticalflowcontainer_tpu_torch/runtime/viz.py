"""Debug visualizations (the port's copy of the reference's
``runtime/viz.py``): the dense HSV flow image the flow node publishes on
``/optical_flow/image_flow``, and the arrow overlays of the spike dumps and
the NeuFlow node, drawn with the port's cv2-exact rasterizer
(``core/draw.py``)."""
from __future__ import annotations

import numpy as np
import torch

from ..core.color import flow_to_hsv_rgb
from ..core.draw import arrowed_line


def flow_to_bgr(flow, max_mag: float | None = None) -> np.ndarray:
    """[H, W, 2] flow (numpy or tensor) -> uint8 BGR [H, W, 3] on the host:
    hue = direction, value = magnitude (scaled by the field's largest one
    when ``max_mag`` is None)."""
    f = flow if isinstance(flow, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(flow, np.float32))
    rgb = flow_to_hsv_rgb(f, max_mag).cpu().numpy()
    return (rgb[..., ::-1] * 255).astype(np.uint8)


def draw_flow_arrows(frame: np.ndarray, flow: np.ndarray, step: int = 16,
                     scale: float = 1.0,
                     outlier_sigma: float | None = None) -> np.ndarray:
    """A copy of ``frame`` (gray made BGR) with a green arrow every ``step``
    px along the flow times ``scale``; with ``outlier_sigma`` only the
    arrows whose magnitude exceeds mean + sigma * std of the field."""
    img = frame.copy()
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    flow = np.asarray(flow)
    H, W = flow.shape[:2]
    mag = np.linalg.norm(flow, axis=-1)
    thresh = None
    if outlier_sigma is not None:
        thresh = mag.mean() + outlier_sigma * mag.std()
    for y in range(step // 2, H, step):
        for x in range(step // 2, W, step):
            if thresh is not None and mag[y, x] <= thresh:
                continue
            dx, dy = flow[y, x] * scale
            arrowed_line(img, (x, y), (int(x + dx), int(y + dy)), (0, 255, 0), 1,
                         tip_length=0.3)
    return img


def grid_mean_arrows(frame: np.ndarray, flow: np.ndarray, grid: int = 3) -> np.ndarray:
    """A copy of ``frame`` with a red arrow from each of ``grid`` x ``grid``
    cells' centre along 5 times the cell's mean flow, 2 px thick (the
    NeuFlow node's overlay)."""
    img = frame.copy()
    flow = np.asarray(flow)
    H, W = flow.shape[:2]
    gh, gw = H // grid, W // grid
    for gy in range(grid):
        for gx in range(grid):
            cell = flow[gy * gh:(gy + 1) * gh, gx * gw:(gx + 1) * gw]
            mu = cell.reshape(-1, 2).mean(axis=0)
            cx, cy = gx * gw + gw // 2, gy * gh + gh // 2
            arrowed_line(img, (cx, cy), (int(cx + mu[0] * 5), int(cy + mu[1] * 5)),
                         (0, 0, 255), 2, tip_length=0.3)
    return img
