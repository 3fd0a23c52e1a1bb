"""Launch presets: node compositions mirroring the reference system's launch
files (the port's copy of the reference's ``runtime/launch.py``).

Each ``bringup_*`` wires nodes onto one Bus and returns them; callers attach
a source (camera-direct) or publish image topics (bag-replay style).  The
reference's junction presets need the junction detector, which is not
ported yet (ROADMAP module item 3).
"""
from __future__ import annotations

from .bus import Bus
from .nodes import DepthNode, FlowNode, NodeParams, make_farneback_backend


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
