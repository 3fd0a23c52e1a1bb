"""Double-buffered host->device prefetch (the port's copy of the
reference's ``runtime/prefetch.py``).

The next frame's host-to-device copy overlaps the current frame's compute:
a prefetch thread copies each incoming item into pinned host memory and
from there to the card on a side CUDA stream, recording an event after the
copy; the consumer's stream waits on that event (not on the whole device)
before it uses the item, and each tensor is marked as used by the
consumer's stream (``record_stream``) so its memory is not reused while
that stream may still read it.  Items are numpy arrays or tensors, or
tuples, lists and dicts of them.  On the CPU the items pass through
unchanged and in order.
"""
from __future__ import annotations

import queue as queue_mod
import threading
from typing import Iterator

import numpy as np
import torch

from ..core.device import device_scope, resolve_device


def _tree_map(fn, item):
    if isinstance(item, dict):
        return {k: _tree_map(fn, v) for k, v in item.items()}
    if isinstance(item, (list, tuple)):
        return type(item)(_tree_map(fn, v) for v in item)
    return fn(item)


def _leaves(item):
    if isinstance(item, dict):
        for v in item.values():
            yield from _leaves(v)
    elif isinstance(item, (list, tuple)):
        for v in item:
            yield from _leaves(v)
    else:
        yield item


class DevicePrefetcher:
    """Wrap a host-side iterator; yields its items on ``device`` (the card
    unless ``"cpu"``), the copy of item i+1 overlapping the consumer's work
    on item i.  ``depth`` items are in flight at most.  An exception the
    source raises ends the iteration with a RuntimeError from it."""

    def __init__(self, it: Iterator, depth: int = 2, device=None):
        self._it = iter(it)
        self._device = resolve_device(device)
        self._q: queue_mod.Queue = queue_mod.Queue(maxsize=depth)
        self._done = object()
        self._error: BaseException | None = None
        self._copy_stream = (torch.cuda.Stream(self._device)
                            if self._device.type == "cuda" else None)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _to_device(self, a):
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a))
        if not isinstance(a, torch.Tensor):
            return a
        if a.device.type == "cpu":
            a = a.pin_memory()
        return a.to(self._device, non_blocking=True)

    def _run(self):
        try:
            if self._copy_stream is None:
                for item in self._it:
                    self._q.put((item, None))
                return
            with device_scope(self._device), torch.cuda.stream(self._copy_stream):
                for item in self._it:
                    moved = _tree_map(self._to_device, item)
                    done = torch.cuda.Event()
                    done.record(self._copy_stream)
                    self._q.put((moved, done))
        except BaseException as e:  # handed to the consumer by __next__
            self._error = e
        finally:
            self._q.put((self._done, None))

    def __iter__(self):
        return self

    def __next__(self):
        item, done = self._q.get()
        if item is self._done:
            self._q.put((item, None))  # stay exhausted on later calls
            if self._error is not None:
                raise RuntimeError("the prefetched iterator failed") from self._error
            raise StopIteration
        if done is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(done)
            for leaf in _leaves(item):
                if isinstance(leaf, torch.Tensor):
                    leaf.record_stream(consumer)
        return item
