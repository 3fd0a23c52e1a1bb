"""Operations and bytes computed from shapes, one module per configuration's
``system`` (``counts(config, traffic) -> dict``, every entry per flow
field), and the table of peaks (``peaks.json``).

A roofline share is the least time the card could take, the larger of the
operations over the fp32 peak and the bytes over the HBM peak, divided by
the measured device time.  Bytes count each input read once and each
output written once, whatever the kernel reads again."""
from __future__ import annotations

import json
import pathlib

PEAKS = pathlib.Path(__file__).resolve().parent / "peaks.json"


def peaks(kind: str) -> dict | None:
    """The data sheet's peaks of the card named ``kind``, or None."""
    return json.loads(PEAKS.read_text())["devices"].get(kind)


def least_seconds(flops: float, nbytes: float, peak: dict) -> float:
    return max(flops / peak["fp32_flop_per_s"], nbytes / peak["hbm_byte_per_s"])
