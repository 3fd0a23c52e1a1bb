"""Standalone junction-detector process: the reference system's process
split (the port's copy of the reference's ``runtime/detector_process.py``).

The reference system runs its C++ junction detector as a separate OS
process that talks DDS to the Python flow node.  This module is that
detector process: it connects a :class:`~.remote_bus.BusBridgeClient` to a
parent's :class:`~.remote_bus.BusBridgeServer`, receives
``/camera/color/image_raw`` over the bridge, runs
:class:`~.nodes.JunctionDetectorNode` (the compiled detector unless
``--force-python``), and forwards ``/junction_detector/junctions`` back:
the composition gets the reference's process-isolation fault boundary.

Run:  python -m opticalflowcontainer_tpu_torch.runtime.detector_process \\
          --port <parent server port> [--grid-area A] [--force-python]

Prints ``READY`` on stdout once subscribed, then serves until stdin closes
(the parent owning the pipe exiting tears the child down) or SIGTERM.
The compiled detector needs the kernel library; a parent that spawns this
process builds it first (``launch.bringup_junction_remote``), so two
processes never run the build at once.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--grid-area", type=float, default=200.0)
    ap.add_argument("--area-tol", type=float, default=2.0)
    ap.add_argument("--cluster-eps", type=float, default=6.0)
    ap.add_argument("--min-publish", type=int, default=4)
    ap.add_argument("--force-python", action="store_true")
    ap.add_argument("--rotated", action="store_true")
    ap.add_argument("--verbose", action="store_true",
                    help="log every image received / junction cloud sent "
                         "to stderr (debugging the bridge composition)")
    args = ap.parse_args(argv)

    from .bus import Bus
    from .nodes import JunctionDetectorNode
    from .remote_bus import BusBridgeClient

    if not args.force_python:
        from ..ops._build import load_kernels

        load_kernels()  # fail before READY when the detector cannot run
    bus = Bus()
    if args.verbose:
        bus.subscribe("/camera/color/image_raw", lambda m: print(
            f"img t={m.header.stamp}", file=sys.stderr, flush=True))
        bus.subscribe("/junction_detector/junctions", lambda m: print(
            f"junctions n={len(m.points)} t={m.header.stamp}",
            file=sys.stderr, flush=True))
    detector = JunctionDetectorNode(
        bus, grid_area=args.grid_area, area_tol=args.area_tol,
        cluster_eps=args.cluster_eps, min_publish=args.min_publish,
        force_python=args.force_python, rotated=args.rotated,
    )
    client = BusBridgeClient(
        bus, args.host, args.port,
        forward_topics=["/junction_detector/junctions"],
    )
    print("READY", flush=True)
    try:
        # serve until the parent closes our stdin (its exit) or interrupts
        sys.stdin.read()
    except KeyboardInterrupt:
        pass
    finally:
        client.close()
        detector.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
