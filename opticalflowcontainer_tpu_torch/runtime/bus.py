"""Thread-safe pub/sub topic bus + approximate-time synchronizer, the port's
copy of the reference's ``runtime/bus.py`` (host-side, no torch).

The DDS-equivalent backbone: typed topics, per-subscription bounded
history (QoS depth 10 default, drop-oldest), cross-thread delivery.  Two
delivery modes:

- ``direct=True`` (default): callbacks run synchronously on the publisher's
  thread -- deterministic, what unit tests and single-process pipelines want.
- ``direct=False``: each subscription gets a dispatcher thread draining its
  own bounded deque, the executor/queue decoupling of the reference runtime
  (backpressure drops the oldest message, never blocks the producer).
  ``Bus.close()`` stops every such thread, joining each with a timeout.

:class:`ApproximateTimeSynchronizer` reproduces
``message_filters.ApproximateTimeSynchronizer``: joins one message per
topic within ``slop`` seconds and fires a joint callback on the latest
arrival.
"""
from __future__ import annotations

import collections
import os
import threading
from typing import Callable, Sequence

_NO_MSG = object()  # latched-message sentinel (None is a valid message)


class Subscription:
    def __init__(self, topic: str, callback, depth: int, direct: bool):
        self.topic = topic
        self.callback = callback
        self.depth = depth
        self.direct = direct
        self._queue: collections.deque = collections.deque(maxlen=depth)
        self._cv = threading.Condition()
        self._stop = False
        self._thread: threading.Thread | None = None
        if not direct:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()

    def _deliver(self, msg):
        if self.direct:
            self.callback(msg)
        else:
            with self._cv:
                self._queue.append(msg)  # deque drops oldest at maxlen
                self._cv.notify()

    def _run(self):
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait(timeout=0.1)
                if self._stop:
                    return
                msg = self._queue.popleft()
            try:
                self.callback(msg)
            except Exception:  # noqa: BLE001 - per-frame fault boundary
                import traceback

                traceback.print_exc()

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify()
        if self._thread is not None:
            self._thread.join(timeout=1.0)


class Bus:
    """Named-topic pub/sub.

    ``namespace`` prefixes every topic, isolating pipelines that share a
    process -- the in-process analogue of ROS_DOMAIN_ID partitioning;
    separate Bus instances are fully isolated regardless.
    ``namespace=None`` (default) reads ``$OFC_BUS_NAMESPACE`` (the
    deployment-level domain selection), empty if unset.
    """

    def __init__(self, namespace: str | None = None):
        if namespace is None:
            namespace = os.environ.get("OFC_BUS_NAMESPACE", "")
        self.namespace = namespace
        self._subs: dict[str, list[Subscription]] = {}
        self._lock = threading.Lock()
        self._latched: dict[str, object] = {}

    def _resolve(self, topic: str) -> str:
        return f"{self.namespace}{topic}" if self.namespace else topic

    def subscribe(
        self, topic: str, callback: Callable, depth: int = 10, direct: bool = True
    ) -> Subscription:
        topic = self._resolve(topic)
        sub = Subscription(topic, callback, depth, direct)
        with self._lock:
            self._subs.setdefault(topic, []).append(sub)
            latched = self._latched.get(topic, _NO_MSG)
        # deliver the latched message OUTSIDE the lock (publish() already
        # does): a direct callback that publishes would otherwise deadlock
        # on this non-reentrant lock
        if latched is not _NO_MSG:
            sub._deliver(latched)
        return sub

    def publish(self, topic: str, msg, latch: bool = False) -> None:
        topic = self._resolve(topic)
        with self._lock:
            subs = list(self._subs.get(topic, ()))
            if latch:
                self._latched[topic] = msg
        for sub in subs:
            sub._deliver(msg)

    def unsubscribe(self, sub: Subscription) -> None:
        with self._lock:
            lst = self._subs.get(sub.topic, [])
            if sub in lst:
                lst.remove(sub)
        sub.close()

    def close(self):
        with self._lock:
            subs = [s for lst in self._subs.values() for s in lst]
            self._subs.clear()
        for s in subs:
            s.close()


class ApproximateTimeSynchronizer:
    """Join N topics on nearly-equal header stamps (within ``slop`` s)."""

    def __init__(
        self,
        bus: Bus,
        topics: Sequence[str],
        callback: Callable,
        queue_size: int = 10,
        slop: float = 0.01,
        direct: bool = True,
    ):
        self.callback = callback
        self.slop = slop
        self._lock = threading.Lock()
        self._queues = {t: collections.deque(maxlen=queue_size) for t in topics}
        self._subs = [
            bus.subscribe(t, (lambda m, _t=t: self._on_msg(_t, m)), queue_size, direct)
            for t in topics
        ]

    def _on_msg(self, topic: str, msg) -> None:
        fire = None
        with self._lock:
            self._queues[topic].append(msg)
            stamp = msg.header.stamp
            picks = {}
            for t, q in self._queues.items():
                if t == topic:
                    picks[t] = msg
                    continue
                best = None
                for m in q:
                    d = abs(m.header.stamp - stamp)
                    if d <= self.slop and (best is None or d < abs(best.header.stamp - stamp)):
                        best = m
                if best is None:
                    break
                picks[t] = best
            if len(picks) == len(self._queues):
                for t, m in picks.items():
                    try:
                        self._queues[t].remove(m)
                    except ValueError:
                        pass
                fire = [picks[t] for t in self._queues]
        if fire is not None:
            self.callback(*fire)
