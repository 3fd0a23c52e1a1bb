"""The port's TCP bus bridge held against the JAX bridge: the wire bytes of
every message type equal, a port server with a JAX client and a JAX server
with a port client over loopback (both directions each), unregistered,
malformed and oversized payloads refused, non-loopback binds refused, and
derived-topic forwarding without echo storms.  Waits are on events with
timeouts."""
import json
import socket
import struct
import threading
import time

import numpy as np
import pytest

from opticalflowcontainer_tpu.runtime import messages as jmsg
from opticalflowcontainer_tpu.runtime import remote_bus as jrb
from opticalflowcontainer_tpu.runtime.bus import Bus as JBus
from opticalflowcontainer_tpu_torch.runtime import messages as tmsg
from opticalflowcontainer_tpu_torch.runtime import remote_bus as trb
from opticalflowcontainer_tpu_torch.runtime.bus import Bus


def _messages(m):
    """One message of every type, built from module ``m``'s classes."""
    H = m.Header
    return [
        m.ImageMsg(H(1.5, "cam"), np.arange(24, dtype=np.uint8).reshape(2, 4, 3)),
        m.ImageMsg(H(2.0), np.ones((3, 4), np.uint16), encoding="16UC1"),
        m.CameraInfoMsg(H(0.0), fx=600.0, fy=601.0, width=640, height=480),
        m.RangeMsg(H(3.0), range=1.25),
        m.Float32Msg(0.5),
        m.Vector3StampedMsg(H(4.0), x=0.125, y=-1.0),
        m.PointCloudMsg(H(5.0), np.array([[1, 2], [3, 4]], np.float32)),
        m.FlowMsg(H(6.0), np.linspace(-1, 1, 8, dtype=np.float32).reshape(2, 2, 2)),
        m.PointCloudMsg(H(7.0), np.zeros((0, 2), np.float32)),
    ]


def _equal(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in a.__dataclass_fields__:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
        elif hasattr(y, "__dataclass_fields__"):
            _equal(x, y)
        else:
            assert x == y


def test_encode_is_byte_equal_to_jax():
    for t, j in zip(_messages(tmsg), _messages(jmsg)):
        assert trb._encode("/t", t) == jrb._encode("/t", j)
        topic, back = jrb._decode(trb._encode("/t", t))  # JAX reads the port's
        assert topic == "/t"
        _equal(back, j)
        topic, back = trb._decode(jrb._encode("/t", j))  # and the port reads JAX's
        assert type(back) is type(t)
        _equal(back, t)


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return False


class _Inbox:
    """Collects messages; ``get`` waits on an event for the next one."""

    def __init__(self):
        self.items, self._ev = [], threading.Event()

    def __call__(self, msg):
        self.items.append(msg)
        self._ev.set()

    def get(self, n=1, timeout=10.0):
        deadline = time.monotonic() + timeout
        while len(self.items) < n:
            self._ev.clear()
            if len(self.items) >= n or not self._ev.wait(max(deadline - time.monotonic(), 0)):
                break
        return self.items


@pytest.mark.parametrize("server_side", ["port", "jax"])
def test_bridge_between_port_and_jax(server_side):
    """Junctions one way, velocities the other, across the two packages."""
    pbus, jbus = Bus(), JBus()
    if server_side == "port":
        server = trb.BusBridgeServer(pbus, forward_topics=["/junction_detector/junctions"])
        client = jrb.BusBridgeClient(jbus, "127.0.0.1", server.port,
                                     forward_topics=["/optical_flow/X_velocity"])
        src_bus, src_m, dst_bus, dst_m = pbus, tmsg, jbus, jmsg
    else:
        server = jrb.BusBridgeServer(jbus, forward_topics=["/junction_detector/junctions"])
        client = trb.BusBridgeClient(pbus, "127.0.0.1", server.port,
                                     forward_topics=["/optical_flow/X_velocity"])
        src_bus, src_m, dst_bus, dst_m = jbus, jmsg, pbus, tmsg
    try:
        assert _wait(lambda: len(server._peers) == 1)
        junctions, vels = _Inbox(), _Inbox()
        dst_bus.subscribe("/junction_detector/junctions", junctions)
        src_bus.subscribe("/optical_flow/X_velocity", vels)
        pts = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
        src_bus.publish("/junction_detector/junctions",
                        src_m.PointCloudMsg(src_m.Header(1.0), pts))
        got = junctions.get()
        assert len(got) == 1 and type(got[0]) is dst_m.PointCloudMsg
        np.testing.assert_array_equal(got[0].points, pts)
        dst_bus.publish("/optical_flow/X_velocity",
                        dst_m.Vector3StampedMsg(dst_m.Header(2.0), 0.5))
        got = vels.get()
        assert len(got) == 1 and type(got[0]) is src_m.Vector3StampedMsg and got[0].x == 0.5
        # a marker after the first two: no echo arrived before it
        src_bus.publish("/junction_detector/junctions",
                        src_m.PointCloudMsg(src_m.Header(3.0), pts))
        assert [m.header.stamp for m in junctions.get(2)] == [1.0, 3.0]
        assert len(vels.items) == 1
    finally:
        client.close()
        server.close()


def test_decode_rejects_unregistered_and_malformed():
    class NotRegistered:
        pass

    with pytest.raises(TypeError):
        trb._encode("/t", NotRegistered())
    with pytest.raises(TypeError):
        trb._encode("/t", tmsg.FlowMsg(tmsg.Header(0.0), np.zeros(2, np.complex64)))
    with pytest.raises(TypeError):  # the JAX package's class is another type
        trb._encode("/t", jmsg.Float32Msg(1.0))
    for head in ({"topic": "/t", "msg": {"__msg__": "Popen", "fields": {}}},
                 {"topic": "/t", "msg": {"__nd__": 0, "dtype": "object", "shape": [1]}},
                 {"topic": "/t", "msg": [1, 2]}):
        raw = json.dumps(head).encode()
        with pytest.raises(ValueError):
            trb._decode(struct.pack(">I", len(raw)) + raw)


def test_register_message_type():
    import dataclasses

    @dataclasses.dataclass
    class Custom:
        value: float
        data: np.ndarray

    with pytest.raises(TypeError):
        trb._encode("/c", Custom(1.0, np.zeros(2, np.float32)))
    with pytest.raises(TypeError):
        trb.register_message_type(int)
    trb.register_message_type(Custom)
    try:
        topic, back = trb._decode(trb._encode("/c", Custom(1.0, np.arange(3, dtype=np.int16))))
        assert topic == "/c" and back.value == 1.0
        np.testing.assert_array_equal(back.data, np.arange(3, dtype=np.int16))
    finally:
        trb._MSG_TYPES.pop("Custom")


def test_oversized_and_truncated_payloads_drop_the_peer():
    """A length above 1 GiB is refused before anything is read; a peer that
    sends it, or garbage, is dropped and the server keeps serving."""
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack(">I", (1 << 30) + 1))
        with pytest.raises(OSError):
            trb._recv_msg(b)
    finally:
        a.close()
        b.close()
    bus = Bus()
    server = trb.BusBridgeServer(bus)
    try:
        for payload in (struct.pack(">I", 3) + b"abc", struct.pack(">I", (1 << 30) + 5)):
            s = socket.create_connection(("127.0.0.1", server.port), timeout=10)
            s.sendall(payload)
            s.settimeout(10)
            assert s.recv(1) == b""  # the server closed its end
            s.close()
        assert _wait(lambda: not server._peers)
    finally:
        server.close()


def test_server_refuses_non_loopback_bind():
    with pytest.raises(ValueError):
        trb.BusBridgeServer(Bus(), host="0.0.0.0")
    with pytest.raises(ValueError):
        trb.BusBridgeServer(Bus(), host="")
    assert trb._is_loopback("localhost") and trb._is_loopback("::1")


def test_derived_topic_published_during_bridged_delivery_still_forwards():
    """A node that reacts to a bridged topic by publishing on another
    forwarded topic has that message propagate, once."""
    bus_a, bus_b = Bus(), Bus()
    server = trb.BusBridgeServer(bus_a, forward_topics=["/img", "/vel"])
    client = trb.BusBridgeClient(bus_b, "127.0.0.1", server.port,
                                 forward_topics=["/img", "/vel"])
    try:
        assert _wait(lambda: len(server._peers) == 1)
        bus_a.subscribe("/img", lambda m: bus_a.publish(
            "/vel", tmsg.Vector3StampedMsg(m.header, 9.0)))
        vel_b, img_a = _Inbox(), _Inbox()
        bus_b.subscribe("/vel", vel_b)
        bus_a.subscribe("/img", img_a)
        bus_b.publish("/img", tmsg.ImageMsg(tmsg.Header(1.0), np.zeros((2, 2, 3), np.uint8)))
        assert [m.x for m in vel_b.get()] == [9.0]
        bus_b.publish("/img", tmsg.ImageMsg(tmsg.Header(2.0), np.zeros((2, 2, 3), np.uint8)))
        assert [m.header.stamp for m in vel_b.get(2)] == [1.0, 2.0]
        assert [m.header.stamp for m in img_a.get(2)] == [1.0, 2.0]
    finally:
        client.close()
        server.close()
    assert not any(bus_a._subs.get("/vel", []))  # the forwarders went with close
