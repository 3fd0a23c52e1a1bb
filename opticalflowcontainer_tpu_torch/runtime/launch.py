"""Launch presets: node compositions mirroring the reference system's launch
files (the port's copy of the reference's ``runtime/launch.py``).

Each ``bringup_*`` wires nodes onto one Bus and returns them; callers attach
a source (camera-direct) or publish image topics (bag-replay style).
"""
from __future__ import annotations

import os
import subprocess
import sys
import threading

from .bus import Bus
from .nodes import (
    DepthNode,
    FlowNode,
    JunctionDetectorNode,
    JunctionMaskFlowNode,
    NodeParams,
    make_farneback_backend,
)


def bringup_flow(
    bus: Bus | None = None,
    backend=None,
    params: NodeParams | None = None,
    with_depth: bool = True,
    direct: bool = True,
    *,
    device=None,
):
    """Plain flow pipeline: image topic -> FlowNode (+DepthNode).  The
    default backend is Farneback (levels 2, winsize 13, 2 iterations) on
    ``device`` (the card unless ``"cpu"``); a given ``backend`` carries its
    own device.  Returns (bus, node, depth node or None)."""
    bus = bus or Bus()
    backend = backend or make_farneback_backend(
        levels=2, winsize=13, iterations=2, device=device)
    node = FlowNode(backend, params or NodeParams(name="FLOW"), bus).attach(
        direct=direct
    )
    depth = DepthNode(bus, direct=direct) if with_depth else None
    return bus, node, depth


def bringup_junction(
    bus: Bus | None = None,
    backend=None,
    params: NodeParams | None = None,
    grid_area: float = 200.0,
    direct: bool = True,
    force_python_detector: bool = False,
    *,
    device=None,
):
    """Junction-masked pipeline: image topic -> junction detector (compiled
    unless ``force_python_detector``) + time-synced junction-masked
    FlowNode (median of the masked flow), the reference system's flagship
    composition.  The default backend is bringup_flow's, on ``device``.
    Returns (bus, node, detector)."""
    bus = bus or Bus()
    backend = backend or make_farneback_backend(
        levels=2, winsize=13, iterations=2, device=device)
    detector = JunctionDetectorNode(
        bus, grid_area=grid_area, direct=direct,
        force_python=force_python_detector,
    )
    node = JunctionMaskFlowNode(
        backend, params or NodeParams(name="JUNCTION", aggregate="median"), bus
    ).attach(direct=direct)
    return bus, node, detector


def bringup_junction_remote(
    bus: Bus | None = None,
    backend=None,
    params: NodeParams | None = None,
    grid_area: float = 200.0,
    force_python_detector: bool = False,
    spawn: bool = True,
    ready_timeout: float = 60.0,
    *,
    device=None,
):
    """Junction-masked pipeline with the detector in its own OS process,
    composed over the TCP bus bridge: the reference system's process split
    (:mod:`.detector_process` plays the detector process, :mod:`.remote_bus`
    plays DDS).  The compiled detector's library is built here, before the
    child starts, so two processes never build it at once.

    Returns ``(bus, node, server, child)``; ``child`` is the detector
    ``subprocess.Popen`` (``None`` with ``spawn=False``: then connect your
    own ``python -m ...runtime.detector_process --port server.port``).
    Close with ``child.stdin.close(); child.wait(); server.close()``.  A
    child that does not print READY within ``ready_timeout`` seconds is
    killed, everything built here is torn down, and RuntimeError is raised.
    """
    from .remote_bus import BusBridgeServer

    if spawn and not force_python_detector:
        from ..ops._build import build

        build()  # raises with nvcc's output when the detector cannot be built
    bus = bus or Bus()
    backend = backend or make_farneback_backend(
        levels=2, winsize=13, iterations=2, device=device)
    node = JunctionMaskFlowNode(
        backend, params or NodeParams(name="JUNCTION", aggregate="median"), bus
    ).attach(direct=True)
    server = BusBridgeServer(
        bus, port=0, forward_topics=["/camera/color/image_raw"]
    )
    child = None
    if spawn:
        cmd = [sys.executable, "-m",
               "opticalflowcontainer_tpu_torch.runtime.detector_process",
               "--port", str(server.port), "--grid-area", str(grid_area)]
        if force_python_detector:
            cmd.append("--force-python")
        # the child imports this package from the checkout it came from
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, env.get("PYTHONPATH")) if p)
        child = subprocess.Popen(
            cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            env=env)
        got: list[str] = []
        reader = threading.Thread(
            target=lambda: got.append(child.stdout.readline().strip()),
            daemon=True)
        reader.start()
        reader.join(ready_timeout)
        if not got or got[0] != "READY":
            # tear down everything built above: a caller retrying bringup
            # must not accumulate leaked server sockets or attached nodes
            child.kill()
            child.wait(timeout=5.0)
            server.close()
            node.stop()
            raise RuntimeError(
                "detector process failed to start "
                f"(got {got[0] if got else 'timeout'!r})")
    return bus, node, server, child
