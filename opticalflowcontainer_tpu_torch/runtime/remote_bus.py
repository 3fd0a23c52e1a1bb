"""Cross-process / cross-host topic transport: a TCP bridge between Buses
(the port's copy of the reference's ``runtime/remote_bus.py``, byte for
byte the same wire format, so a port process and a reference process
bridge to each other).

The reference system's DDS backbone is cross-process (a C++ detector node
beside Python flow nodes); the in-process :class:`~.bus.Bus` gains that
through this bridge:

- :class:`BusBridgeServer` accepts connections and re-publishes every
  message received onto the local bus; it forwards selected local topics to
  all connected peers.
- :class:`BusBridgeClient` connects out, with the same forwarding.

Wire format (data only, deliberately not pickle: a malicious peer can at
worst deliver a malformed message, never run code):

    >I total payload length
    >I JSON header length
    JSON header  {"topic": str, "msg": <encoded>}
    raw little-endian array buffers, in encounter order

where ``<encoded>`` encodes the dataclasses of :mod:`.messages` as
``{"__msg__": <registered type name>, "fields": {...}}``, numpy arrays as
``{"__nd__": i, "dtype": ..., "shape": ...}`` referencing the i-th raw
buffer (dtype from a numeric whitelist), and scalars as JSON natives.  Only
registered message types are constructed on receive; the names are the
class names, the same in both packages.  A message above 1 GiB is refused.

Binds are restricted to loopback unless ``allow_external=True`` is passed:
the bridge carries no authentication.

Loop protection: a message arriving from a peer is re-published locally
with a thread-local note of its topic; the forwarder of that same topic
skips it, but messages a subscriber publishes on other forwarded topics in
response still propagate (a node that turns a bridged image into flow must
have that flow forwarded).
"""
from __future__ import annotations

import dataclasses
import ipaddress
import json
import socket
import struct
import threading

import numpy as np

from . import messages as _messages
from .bus import Bus

_HDR = struct.Struct(">I")

# Closed registry of constructible message types (data-only deserialization).
_MSG_TYPES = {
    cls.__name__: cls
    for cls in vars(_messages).values()
    if dataclasses.is_dataclass(cls) and isinstance(cls, type)
}

_DTYPE_WHITELIST = {
    "bool", "uint8", "uint16", "uint32", "uint64",
    "int8", "int16", "int32", "int64", "float16", "float32", "float64",
}

_MAX_MSG_BYTES = 1 << 30


def register_message_type(cls: type) -> type:
    """Allow a user-defined dataclass message type across the bridge."""
    if not (dataclasses.is_dataclass(cls) and isinstance(cls, type)):
        raise TypeError("register_message_type expects a dataclass type")
    _MSG_TYPES[cls.__name__] = cls
    return cls


def _encode(topic: str, msg) -> bytes:
    buffers: list[bytes] = []

    def enc(v):
        if isinstance(v, np.ndarray):
            if str(v.dtype) not in _DTYPE_WHITELIST:
                raise TypeError(f"array dtype {v.dtype} not bridgeable")
            a = np.ascontiguousarray(v)
            buffers.append(a.tobytes())
            return {"__nd__": len(buffers) - 1, "dtype": str(a.dtype),
                    "shape": list(a.shape)}
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            name = type(v).__name__
            if _MSG_TYPES.get(name) is not type(v):
                raise TypeError(f"message type {name} not registered for bridging")
            return {"__msg__": name,
                    "fields": {f.name: enc(getattr(v, f.name))
                               for f in dataclasses.fields(v)}}
        if isinstance(v, (np.floating, np.integer)):
            return v.item()
        if v is None or isinstance(v, (bool, int, float, str)):
            return v
        raise TypeError(f"value of type {type(v).__name__} not bridgeable")

    head = json.dumps({"topic": topic, "msg": enc(msg)}).encode()
    return b"".join([_HDR.pack(len(head)), head, *buffers])


def _decode(payload: bytes):
    (hlen,) = _HDR.unpack_from(payload, 0)
    head = json.loads(payload[4 : 4 + hlen].decode())
    buffers = memoryview(payload)[4 + hlen:]

    offsets = [0]  # filled lazily as arrays appear in encounter order

    def dec(v):
        if isinstance(v, dict) and "__nd__" in v:
            dtype = str(v["dtype"])
            if dtype not in _DTYPE_WHITELIST:
                raise ValueError(f"array dtype {dtype} not allowed")
            shape = tuple(int(s) for s in v["shape"])
            n = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
            start = offsets[-1]
            offsets.append(start + n)
            return np.frombuffer(
                buffers[start : start + n], dtype=dtype
            ).reshape(shape).copy()
        if isinstance(v, dict) and "__msg__" in v:
            cls = _MSG_TYPES.get(str(v["__msg__"]))
            if cls is None:
                raise ValueError(f"unknown message type {v['__msg__']!r}")
            return cls(**{str(k): dec(x) for k, x in v["fields"].items()})
        if v is None or isinstance(v, (bool, int, float, str)):
            return v
        raise ValueError("malformed wire value")

    return str(head["topic"]), dec(head["msg"])


def _send_msg(sock: socket.socket, topic: str, msg) -> None:
    payload = _encode(topic, msg)
    sock.sendall(_HDR.pack(len(payload)) + payload)


def _recv_msg(sock: socket.socket):
    hdr = b""
    while len(hdr) < 4:
        chunk = sock.recv(4 - len(hdr))
        if not chunk:
            return None
        hdr += chunk
    (n,) = _HDR.unpack(hdr)
    if n > _MAX_MSG_BYTES:
        raise OSError(f"bridge message too large ({n} bytes)")
    parts = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            return None
        parts.append(chunk)
        got += len(chunk)
    return _decode(b"".join(parts))


def _is_loopback(host: str) -> bool:
    if host in ("localhost", ""):
        return host == "localhost"
    try:
        return ipaddress.ip_address(host).is_loopback
    except ValueError:
        return False


class _BridgeBase:
    def __init__(self, bus: Bus, forward_topics: list[str]):
        self.bus = bus
        self.forward_topics = forward_topics
        self._peers: list[socket.socket] = []
        self._peers_lock = threading.Lock()
        self._stop = threading.Event()
        self._delivering = threading.local()  # .topic = bridged topic in flight
        self._subs = [self.bus.subscribe(t, self._make_forwarder(t))
                      for t in forward_topics]

    def _make_forwarder(self, topic: str):
        def forward(msg):
            # Echo guard is per-topic: only the topic that just arrived from a
            # peer is suppressed; derived messages published synchronously on
            # OTHER forwarded topics still propagate.
            if getattr(self._delivering, "topic", None) == topic:
                return
            with self._peers_lock:
                peers = list(self._peers)
            for p in peers:
                try:
                    _send_msg(p, topic, msg)
                except OSError:
                    with self._peers_lock:
                        if p in self._peers:
                            self._peers.remove(p)

        return forward

    def _pump(self, sock: socket.socket):
        while not self._stop.is_set():
            try:
                item = _recv_msg(sock)
            except (OSError, ValueError, KeyError, TypeError, struct.error):
                # disconnected or malformed peer data: drop the peer
                # (struct.error is NOT a ValueError — a <4-byte payload
                # would otherwise kill the pump without the cleanup below)
                break
            if item is None:
                break
            topic, msg = item
            prev = getattr(self._delivering, "topic", None)
            self._delivering.topic = topic
            try:
                self.bus.publish(topic, msg)
            finally:
                self._delivering.topic = prev
        with self._peers_lock:
            if sock in self._peers:
                self._peers.remove(sock)
        sock.close()

    def close(self):
        self._stop.set()
        for sub in self._subs:
            self.bus.unsubscribe(sub)
        self._subs = []
        with self._peers_lock:
            for p in self._peers:
                try:
                    p.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                p.close()
            self._peers.clear()


class BusBridgeServer(_BridgeBase):
    def __init__(self, bus: Bus, port: int = 0, host: str = "127.0.0.1",
                 forward_topics: list[str] | None = None,
                 allow_external: bool = False):
        if not allow_external and not _is_loopback(host):
            raise ValueError(
                f"refusing to bind bridge to non-loopback host {host!r}: the "
                "bridge is unauthenticated; pass allow_external=True only "
                "behind your own transport security"
            )
        super().__init__(bus, forward_topics or [])
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen()
        self.port = self._srv.getsockname()[1]
        self._accept_thread = threading.Thread(target=self._accept, daemon=True)
        self._accept_thread.start()

    def _accept(self):
        while not self._stop.is_set():
            try:
                sock, _ = self._srv.accept()
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._peers_lock:
                self._peers.append(sock)
            threading.Thread(target=self._pump, args=(sock,), daemon=True).start()

    def close(self):
        super().close()
        try:
            self._srv.close()
        except OSError:
            pass


class BusBridgeClient(_BridgeBase):
    def __init__(self, bus: Bus, host: str, port: int,
                 forward_topics: list[str] | None = None):
        super().__init__(bus, forward_topics or [])
        sock = socket.create_connection((host, port), timeout=10)
        # create_connection's timeout would persist as the timeout of every
        # recv: a bridge idle for 10 s (a warm-up between connect and the
        # first publish) would lose its peer.  Connect bounded, then block.
        sock.settimeout(None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        with self._peers_lock:
            self._peers.append(sock)
        threading.Thread(target=self._pump, args=(sock,), daemon=True).start()
