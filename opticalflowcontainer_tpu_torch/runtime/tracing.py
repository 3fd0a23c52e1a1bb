"""Device tracing and memory sampling on the card (the port's counterpart of
the reference's ``runtime/tracing.py``, which wraps ``jax.profiler``):

- :func:`trace` -- context manager writing a Chrome trace of the host and
  the card (``torch.profiler``);
- :func:`annotate` -- a named span on that trace's timeline, free when no
  profiler runs (``core.spans.annotate``; the program's own spans, named
  ``ofc.*``, are listed there);
- :func:`device_memory_stats` -- per CUDA device, the memory PyTorch's
  allocator holds now and at its peak, and the card's total;
- :func:`start_memory_monitor` -- those stats sampled into a CSV from a
  thread (the node's ``write_accel_csv``).
"""
from __future__ import annotations

import contextlib
import os
import threading
import time

import torch

from ..core.spans import annotate  # noqa: F401  (the package's span primitive)


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace(dir): run_steps()`` writes ``dir/trace.json`` (Chrome
    trace format; the card's kernels and copies where CUDA is present)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_memory_stats() -> list[dict]:
    """One entry per CUDA device (none without CUDA): bytes the caching
    allocator has allocated now and at its peak, and the card's total
    memory."""
    out = []
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        _free, total = torch.cuda.mem_get_info(i)
        out.append({
            "device": f"cuda:{i}",
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": total,
        })
    return out


def start_memory_monitor(path: str, interval: float = 1.0):
    """Sample :func:`device_memory_stats` every ``interval`` seconds into a
    CSV from a daemon thread (the accelerator leg of the reference's
    monitor.sh, which samples ``nvidia-smi`` per node).  Returns ``stop()``,
    which ends the sampling, joins the thread and closes the file."""
    stop_event = threading.Event()
    f = open(path, "w")
    f.write("timestamp,device,bytes_in_use,peak_bytes_in_use,bytes_limit\n")

    def run():
        try:
            while not stop_event.is_set():
                now = time.time()
                for s in device_memory_stats():
                    f.write(f"{now:.3f},{s['device']},{s['bytes_in_use']},"
                            f"{s['peak_bytes_in_use']},{s['bytes_limit']}\n")
                f.flush()
                stop_event.wait(interval)
        finally:
            f.close()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def stop():
        stop_event.set()
        thread.join(timeout=max(2.0, 2 * interval))

    return stop
