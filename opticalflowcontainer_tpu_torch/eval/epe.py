"""Flow accuracy metrics (the port's copy of the reference's
``eval/epe.py``): end-point error and the statistics derived from it, on
host arrays."""
from __future__ import annotations

import numpy as np


def _errors(flow, gt, valid) -> np.ndarray:
    d = np.linalg.norm(np.asarray(flow) - np.asarray(gt), axis=-1)
    return d[np.asarray(valid, bool)] if valid is not None else d


def epe(flow, gt, valid=None) -> float:
    """Mean end-point error |flow - gt| over the (optionally masked) pixels;
    NaN when the mask keeps none."""
    d = _errors(flow, gt, valid)
    return float(d.mean()) if d.size else float("nan")


def epe_stats(flow, gt, valid=None) -> dict:
    """Mean EPE, its median and 95th percentile, and the fractions of pixels
    under 1, 3 and 5 px.  Every value is NaN when the mask keeps no pixel
    (a KITTI ``flow_occ`` frame whose valid channel is all zero)."""
    d = _errors(flow, gt, valid)
    if d.size == 0:
        nan = float("nan")
        return {"epe": nan, "p50": nan, "p95": nan,
                "1px": nan, "3px": nan, "5px": nan}
    return {
        "epe": float(d.mean()),
        "p50": float(np.percentile(d, 50)),
        "p95": float(np.percentile(d, 95)),
        "1px": float((d < 1.0).mean()),
        "3px": float((d < 3.0).mean()),
        "5px": float((d < 5.0).mean()),
    }


def outlier_rate(flow, gt, valid=None, abs_thresh: float = 3.0,
                 rel_thresh: float = 0.05) -> float:
    """KITTI Fl-all: the fraction of pixels whose EPE exceeds both 3 px and
    5% of |gt|; NaN when the mask keeps none."""
    flow, gt = np.asarray(flow), np.asarray(gt)
    d = np.linalg.norm(flow - gt, axis=-1)
    mag = np.linalg.norm(gt, axis=-1)
    out = (d > abs_thresh) & (d > rel_thresh * mag)
    if valid is not None:
        out = out[np.asarray(valid, bool)]
    return float(out.mean()) if out.size else float("nan")
