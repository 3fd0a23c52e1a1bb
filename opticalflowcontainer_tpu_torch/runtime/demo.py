"""End-to-end runtime demo: synthetic camera -> flow node (Farneback, or
NeuFlowLite / RAFT-small / RAFT on the packaged weights) -> velocity
topics, on the card (``--cpu`` for the CPU):

    python -m opticalflowcontainer_tpu_torch.runtime.demo [--fused] [--cpu]
        [--model farneback|neuflow|raft|raft_large] [--bf16]

The synthetic scene translates at a known metric velocity, so the printed
velocities should converge to the ground truth: a self-checking run of the
whole streaming path (capture thread -> bounded queue -> inference thread
-> velocity estimation -> pub/sub).  Exits 1 when nothing was published or
the final smoothed velocity misses the ground truth by 10 mm/s or more.
"""
from __future__ import annotations

import argparse
import functools
import time


def run(argv=None) -> dict:
    """Parse ``argv``, run the demo, print its lines and return its numbers
    (frames processed, dropped and failed, velocities published, seconds,
    final smoothed velocity and its error) with ``exit_code``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--velocity", type=float, default=0.05, help="ground truth m/s")
    ap.add_argument("--fps", type=float, default=30.0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    ap.add_argument("--fused", action="store_true",
                    help="fused device path: frame -> flow -> velocity scalar "
                         "on the device, one scalar to the host per frame "
                         "(runtime.fused)")
    ap.add_argument("--model", default="farneback",
                    choices=("farneback", "neuflow", "raft", "raft_large"),
                    help="flow backend; the learned models (neuflow: "
                         "NeuFlowLite) use the packaged weights and the fused "
                         "model path (RAFT at 8 iterations)")
    ap.add_argument("--bf16", action="store_true",
                    help="serve the learned model in bfloat16 (FusedModelStream"
                         "(bf16=True)); the flow and the velocity stay fp32")
    args = ap.parse_args(argv)
    if args.bf16 and args.model == "farneback":
        ap.error("--bf16 serves a learned model (--model neuflow, raft or "
                 "raft_large); the Farneback backend, plain or --fused, runs "
                 "in fp32")

    from .bus import Bus
    from .fused import make_fused_farneback_backend, make_fused_model_backend
    from .nodes import FlowNode, NodeParams, make_farneback_backend
    from .sources import SyntheticCamera

    device = "cpu" if args.cpu else None
    bus = Bus()
    pixel_to_meter = 0.000857
    cam = SyntheticCamera(
        bus,
        width=args.width,
        height=args.height,
        fps=args.fps,
        n_frames=args.frames,
        velocity_mps=args.velocity,
        pixel_to_meter=pixel_to_meter,
    )
    fb_kwargs = dict(levels=2, winsize=13, iterations=2)
    out = {"frames": args.frames, "frames_processed": 0, "frames_dropped": 0,
           "frames_failed": 0, "published": 0, "seconds": 0.0, "ended": True,
           "final_vx": None, "error_mps": None, "exit_code": 1}
    if args.model != "farneback":
        from ..models import convert, neuflow, raft

        load, estimate = {
            "neuflow": (convert.load_neuflow_lite_synth, neuflow.estimate),
            "raft": (convert.load_raft_small_synth,
                     functools.partial(raft.estimate, iters=8)),
            "raft_large": (convert.load_raft_synth,
                           functools.partial(raft.estimate, iters=8)),
        }[args.model]
        model = load(device=device)
        if model is None:
            print(f"no packaged weights for {args.model}")
            return out
        backend = make_fused_model_backend(model, estimate, bf16=args.bf16,
                                           device=device)
    elif args.fused:
        backend = make_fused_farneback_backend(device=device, **fb_kwargs)
    else:
        backend = make_farneback_backend(device=device, **fb_kwargs)
    node = FlowNode(
        backend,
        NodeParams(width=args.width, height=args.height,
                   pixel_to_meter=pixel_to_meter, name="FARNEBACK"),
        bus,
    )

    # warm up (the kernels' library loads, the allocator fills) before
    # streaming, so that no frame is dropped to it
    f0, f1 = cam.frame_at(0), cam.frame_at(1)
    if args.fused or args.model != "farneback":
        backend.stream.warmup(f0)
        backend.stream.reset()
    else:
        node.backend(f0.mean(-1).astype("float32"), f1.mean(-1).astype("float32"),
                     1 / args.fps)

    received = []
    sub = bus.subscribe(
        "/optical_flow/FARNEBACK_smooth_velocity",
        lambda m: received.append(m) or print(
            f"t={m.header.stamp:9.3f}  vx={m.x:+.4f} m/s  (gt {args.velocity:+.4f})"
        ),
    )

    t0 = time.time()
    node.start_stream(cam)
    ended = node.wait(timeout=60)
    node.stop()
    bus.unsubscribe(sub)
    elapsed = time.time() - t0
    out.update(frames_processed=node.frames_processed,
               frames_dropped=node.frames_dropped,
               frames_failed=node.frames_failed, published=len(received),
               seconds=elapsed, ended=ended)
    if not received:
        print("no velocities produced (all frames dropped or failed?)")
        return out
    err = abs(received[-1].x - args.velocity)
    print(
        f"processed {node.frames_processed}/{args.frames} frames in {elapsed:.2f}s "
        f"({node.frames_processed / elapsed:.1f} fps vs camera {args.fps:g}; "
        f"dropped {node.frames_dropped}, failed {node.frames_failed}); "
        f"final smooth vx = {received[-1].x:+.4f} m/s vs gt {args.velocity:+.4f}"
    )
    print(f"velocity error: {err * 1000:.2f} mm/s ({'OK' if err < 0.01 else 'HIGH'})")
    out.update(final_vx=received[-1].x, error_mps=err,
               exit_code=0 if err < 0.01 else 1)
    return out


def main(argv=None) -> int:
    return run(argv)["exit_code"]


if __name__ == "__main__":
    raise SystemExit(main())
