"""The program's own spans in the traced window: the idle time, the launches
and the lengths inside the spans that the port records by name
(``ofc.farneback.prep``, ``ofc.stream.step``, ...; listed in the port's
``core/spans.py``), on the trace's clock.  The spans are host events of the
window's thread (``Summary._host``), matched by name; nothing of the port is
imported.  Each function returns None where the trace holds no span of
that name, as a program that records none gives."""
from __future__ import annotations

import bisect

import numpy as np

# the host's calls that put an operation on the card's queue: a kernel
# launch (through `cuda*` or the lower-level `cu*` entry points), an
# asynchronous copy or memset
LAUNCHES = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                      "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync"})


class Spans:
    """The union of the spans named ``name`` in ``summary`` (a span nested
    in another of its name counted once)."""

    def __init__(self, summary, name: str):
        self.summary = summary
        self.lengths_ns = [e - s for n, s, e in summary._host if n == name]
        merged: list[list[int]] = []
        for _, s, e in sorted(h for h in summary._host if h[0] == name):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self._merged = merged
        self._starts = [s for s, _ in merged]

    def __bool__(self) -> bool:
        return bool(self._merged)

    def holds(self, t: int) -> bool:
        i = bisect.bisect_right(self._starts, t) - 1
        return i >= 0 and t <= self._merged[i][1]

    def idle_s(self) -> float:
        """The card's idle seconds whose gap has its midpoint inside the
        spans (as ``Summary.breakdown`` puts a gap down to the host)."""
        return sum(e - s for s, e in self.summary.gaps
                   if self.holds((s + e) // 2)) * 1e-9

    def launches(self) -> int:
        """Launches (:data:`LAUNCHES`) that start inside the spans."""
        return sum(1 for n, s, _ in self.summary._host
                   if n in LAUNCHES and self.holds(s))


def idle_ms_per(ctx, name: str, per: int) -> float | None:
    """Idle ms inside the spans ``name`` over ``per`` (fields or frames)."""
    spans = Spans(ctx.trace, name)
    if not spans or per <= 0:
        return None
    return 1e3 * spans.idle_s() / per


def launches_per(ctx, name: str, per: int) -> float | None:
    """Launches inside the spans ``name`` over ``per``."""
    spans = Spans(ctx.trace, name)
    if not spans or per <= 0:
        return None
    return spans.launches() / per


def median_ms(ctx, name: str) -> float | None:
    """The median length (ms) of the spans ``name``."""
    lengths = Spans(ctx.trace, name).lengths_ns
    if not lengths:
        return None
    return float(np.median(lengths)) * 1e-6
