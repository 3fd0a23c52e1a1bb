"""The traced window: ``torch.profiler`` over the host and the card, reduced
in memory (no trace file is written) to the device's operations, its busy
time, its idle gaps and what the host was doing in them."""
from __future__ import annotations

import bisect
import contextlib

import torch

WINDOW_SPAN = "portbench.window"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
# the longest host-side scan for the event open at an idle gap
SCAN_LIMIT = 20000
NAME_CHARS = 120


class Summary:
    """What a metric reader gets of the trace.  ``ops`` are the device's
    operations in the window as (name, start_ns, duration_ns, activity),
    the activity one of :data:`DEVICE_ACTIVITIES`; ``busy_s`` is their
    union's length, ``window_s`` the window's."""

    def __init__(self, ops, window, host):
        self.ops = ops
        self.window_s = (window[1] - window[0]) * 1e-9
        merged = []
        for _, start, dur, _ in sorted(ops, key=lambda o: o[1]):
            end = start + dur
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        self.busy_s = sum(e - s for s, e in merged) * 1e-9
        edges = [window[0]] + [x for iv in merged for x in iv] + [window[1]]
        self.gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                     if edges[i + 1] > edges[i]]
        self._host = sorted(host, key=lambda h: h[1])
        self._host_starts = [h[1] for h in self._host]

    def kernel_seconds(self, match) -> float:
        """Seconds of the kernels whose name ``match`` accepts."""
        return sum(d for n, _, d, a in self.ops
                   if a == "kernel" and match(n)) * 1e-9

    def host_at(self, t: int) -> str:
        """The innermost host event open at ``t`` (ns); the window's own span
        (Python between two operations) reads "host: between operations"."""
        i = bisect.bisect_right(self._host_starts, t)
        for j in range(i - 1, max(i - 1 - SCAN_LIMIT, -1), -1):
            name, start, end = self._host[j]
            if end >= t:
                return "host: between operations" if name == WINDOW_SPAN else name
        return "host: between operations"

    def breakdown(self) -> dict:
        """The ten device operations that took most time, and the idle time
        summed by the host event open at each gap's midpoint, ten largest."""
        by_op: dict[str, float] = {}
        for n, _, d, _ in self.ops:
            by_op[n] = by_op.get(n, 0.0) + d * 1e-9
        by_host: dict[str, float] = {}
        for s, e in self.gaps:
            n = self.host_at((s + e) // 2)
            by_host[n] = by_host.get(n, 0.0) + (e - s) * 1e-9
        top = lambda d: [[k[:NAME_CHARS], v] for k, v in
                         sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(by_op), "idle_gaps": top(by_host)}


@contextlib.contextmanager
def traced(enabled: bool):
    """``with traced(on) as box:`` profiles the block when ``on``; after
    it, ``box[0]`` is the :class:`Summary` (None when off)."""
    box = [None]
    if not enabled:
        yield box
        return
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW_SPAN):
            yield box
    box[0] = summarize(prof.profiler.kineto_results.events())


def _activity(e) -> str:
    """The event's kineto activity ("kernel", "gpu_memcpy", "user_annotation",
    ...); PyTorch builds without ``activity_type`` are told by device and
    name."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    if not str(e.device_type()).endswith("CPU"):
        name = e.name()
        if name == WINDOW_SPAN:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    return "user_annotation" if e.name() == WINDOW_SPAN else "cpu_op"


def summarize(events) -> Summary:
    """The window is the :data:`WINDOW_SPAN` span; host events are those of
    its thread."""
    acts = [_activity(e) for e in events]
    spans = [e for e, a in zip(events, acts)
             if a == "user_annotation" and e.name() == WINDOW_SPAN]
    if len(spans) != 1:
        raise RuntimeError(f"the trace holds {len(spans)} {WINDOW_SPAN} spans")
    w = spans[0]
    window = (w.start_ns(), w.start_ns() + w.duration_ns())
    ops, host = [], []
    for e, act in zip(events, acts):
        if act in DEVICE_ACTIVITIES:
            ops.append((e.name(), e.start_ns(), e.duration_ns(), act))
        elif (str(e.device_type()).endswith("CPU")
              and e.start_thread_id() == w.start_thread_id()):
            host.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    ops = [(n, max(s, window[0]), min(s + d, window[1]) - max(s, window[0]), a)
           for n, s, d, a in ops if s < window[1] and s + d > window[0]]
    return Summary(ops, window, host)
