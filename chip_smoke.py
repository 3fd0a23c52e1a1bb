#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and hold its kernels against their
plain PyTorch versions.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card, nvcc and
PyTorch built for CUDA (no JAX, no cv2).  Phases, each printed with its
seconds:

0. the device: name, count, and nvidia-smi's name and power limit;
1. the build: one nvcc call over opticalflowcontainer_tpu_torch/ops/csrc/*.cu
   (build seconds and the ptxas register/shared-memory lines);
2. K1 farneback_update vs its plain version at the 720p finest level, B=6,
   with flows that put taps out of bounds; timed beside its bound;
3. K2 blur_solve vs its plain version at 720p, B=6: box and Gaussian at
   winsize 15, box at 41 (above the TPU kernel's limit) and 101 (opt-in
   shared memory); timed beside its bound;
4. the main path: farneback_clip on a 720p T=7 clip of a texture with a
   known subpixel translation: EPE against it, the kernel launch counts of
   one call, ms per call and fields/s; and the clip on the card vs the CPU
   on a small input;
5. the stream at 640x480: FusedFarnebackStream and the flow-node backend on
   uint8 BGR frames with a known shift; VelocityEstimator m/s; step_many ==
   step bit for bit; per-frame latency (p50, p99) over a 400-frame window.

Phases 4 and 5 also run their path once under torch.profiler: device busy
time, idle share, how much of the idle time the device spent waiting for
the host to launch its next operation, and the stream synchronizations and
host-to-device copies made.  ``--trace DIR`` keeps those two profiles there
as Chrome traces.

Then one JSON line with every kernel's launches, error, times and bound, and
as the last line {"ok": true, "device": {...}}.  Without a CUDA device, or
without the package beside it, or when any phase fails, it exits non-zero
and prints no result line.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 (non-tensor) flop/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


@contextlib.contextmanager
def phase(name: str):
    print(f"== phase {name}", flush=True)
    t0 = time.perf_counter()
    try:
        yield
    except BaseException:
        print(f"== phase {name} FAILED after {time.perf_counter() - t0:.2f} s",
              flush=True)
        raise
    print(f"== phase {name} ok in {time.perf_counter() - t0:.2f} s", flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call of ``fn`` on the card, CUDA events around ``reps``
    calls after ``warmup``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def plane_waves(torch, H: int, W: int, shifts, seed: int, device) -> "torch.Tensor":
    """Frames [len(shifts), H, W] fp32 on ``device`` of one band-limited
    texture (a sum of plane waves, wavelengths 6-24 px, parameters drawn
    with numpy from ``seed``) translated exactly by each (dx, dy), computed
    in fp64.  Longer waves leave Farneback (and cv2) short of the shift by
    ~10%."""
    rng = np.random.default_rng(seed)
    n = 12
    theta = rng.uniform(0, np.pi, n)
    k = 2 * np.pi / rng.uniform(6, 24, n)
    kx, ky = (k * np.cos(theta)).tolist(), (k * np.sin(theta)).tolist()
    phi = rng.uniform(0, 2 * np.pi, n).tolist()
    amp = rng.uniform(4, 12, n).tolist()
    x = torch.arange(W, dtype=torch.float64, device=device)
    y = torch.arange(H, dtype=torch.float64, device=device)[:, None]
    out = torch.empty((len(shifts), H, W), dtype=torch.float32, device=device)
    for t, (dx, dy) in enumerate(shifts):
        f = torch.full((H, W), 128.0, dtype=torch.float64, device=device)
        for i in range(n):
            f += amp[i] * torch.sin(kx[i] * (x - dx) + ky[i] * (y - dy) + phi[i])
        out[t] = f
    return out


def device_phase(torch) -> dict:
    from opticalflowcontainer_tpu_torch.core.device import capabilities

    caps = capabilities()
    print(json.dumps(caps))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    for line in smi.stdout.strip().splitlines():
        print(line.strip())
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def build_phase() -> None:
    from opticalflowcontainer_tpu_torch.ops import _build

    info = _build.build()
    print(f"library {info.path.name}: {'cached' if info.cached else 'built'} "
          f"in {info.seconds:.2f} s (one nvcc call)")
    for line in info.ptxas:
        print(f"  {line}")
    _build.load_kernels()


def k1_phase(torch, dev, B=6, H=720, W=1280, seed=0) -> dict:
    from opticalflowcontainer_tpu_torch.ops.farneback_update import (
        farneback_update, farneback_update_plain)

    rng = np.random.default_rng(seed)
    R0 = torch.from_numpy(rng.standard_normal((B, 5, H, W), np.float32)).to(dev)
    R1 = torch.from_numpy(rng.standard_normal((B, 5, H, W), np.float32)).to(dev)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    # up to ~7 px of smooth flow plus noise: taps leave the level near its
    # borders, so both branches of the update run
    u = np.stack([6 * np.sin(2 * np.pi * (xx / W + b / B)) for b in range(B)])
    v = np.stack([4 * np.cos(2 * np.pi * (yy / H + b / B)) for b in range(B)])
    u = torch.from_numpy((u + rng.uniform(-1, 1, u.shape)).astype(np.float32)).to(dev)
    v = torch.from_numpy((v + rng.uniform(-1, 1, v.shape)).astype(np.float32)).to(dev)
    got = farneback_update(R0, R1, u, v)
    want = farneback_update_plain(R0, R1, u, v)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    fx = torch.arange(W, device=dev) + u
    fy = torch.arange(H, device=dev)[:, None] + v
    inb = ((fx.floor() >= 0) & (fx.floor() < W - 1)
           & (fy.floor() >= 0) & (fy.floor() < H - 1))
    n_inb = int(inb.sum())
    n_pix = B * H * W
    # R0 (5), u, v (2) and M (5) per pixel; R1's 5 planes where in bounds
    n_bytes = 4 * (12 * n_pix + 5 * n_inb)
    n_flops = 80 * n_inb + 45 * (n_pix - n_inb)
    tol = 1e-5
    print(f"K1 [B={B}, 5, {H}, {W}]: out-of-bounds share "
          f"{1 - n_inb / n_pix:.4f}; max|d| {err:.3e}, max|d|/max|plain| "
          f"{err / scale:.3e} (tolerance {tol:.0e}: fp32, FMA contraction "
          f"and operation order differ)")
    require(err <= tol * scale, "K1 agrees with its plain version")
    ms = cuda_ms(lambda: farneback_update(R0, R1, u, v), reps=20)
    plain_ms = cuda_ms(lambda: farneback_update_plain(R0, R1, u, v), reps=5)
    b_ms, by = bound_ms(n_bytes, n_flops)
    print(f"K1 {ms:.4f} ms per launch (plain {plain_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms by {by}: {n_bytes / 1e6:.1f} MB)")
    return {"name": "farneback_update", "route": "cuda",
            "source": "opticalflowcontainer_tpu_torch/ops/csrc/farneback_update.cu",
            "replaces": "opticalflowcontainer_tpu/ops/blockwarp.py:612",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None}


def k2_phase(torch, dev, B=6, H=720, W=1280, seed=1) -> dict:
    from opticalflowcontainer_tpu_torch.ops.solve2x2 import (
        blur_solve, blur_solve_plain)

    rng = np.random.default_rng(seed)
    a, b, c = (rng.standard_normal((B, H, W), np.float32) for _ in range(3))
    # normal-equation planes shaped like the real ones: G positive definite
    M = torch.from_numpy(np.stack([a * a + 0.5, 0.3 * a * b, b * b + 0.5, c,
                                   a * c], axis=1)).to(dev)
    del a, b, c
    tol = 1e-4
    worst = 0.0
    for winsize, gaussian in ((15, False), (15, True), (41, False), (101, False)):
        got = blur_solve(M, winsize, gaussian)
        want = blur_solve_plain(M, winsize, gaussian)
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        scale = max(float(w.abs().max()) for w in want)
        worst = max(worst, err)
        print(f"K2 winsize {winsize} {'gaussian' if gaussian else 'box'}: "
              f"max|d| {err:.3e}, max|d|/max|plain| {err / scale:.3e} "
              f"(tolerance {tol:.0e}: fp32 sums of up to 101 taps in another "
              f"order, then a division)")
        require(err <= tol * scale, f"K2 winsize {winsize} agrees with its plain version")
    ms = cuda_ms(lambda: blur_solve(M, 15, False), reps=20)
    plain_ms = cuda_ms(lambda: blur_solve_plain(M, 15, False), reps=5)
    n_pix = B * H * W
    # M (5) in, u, v (2) out; 2 passes x 5 planes x 15 taps x 2 flops + solve
    b_ms, by = bound_ms(4 * 7 * n_pix, (2 * 5 * 15 * 2 + 15) * n_pix)
    print(f"K2 winsize 15 box: {ms:.4f} ms per launch (plain {plain_ms:.4f} ms, "
          f"bound {b_ms:.4f} ms by {by})")
    return {"name": "blur_solve", "route": "cuda",
            "source": "opticalflowcontainer_tpu_torch/ops/csrc/blur_solve.cu",
            "replaces": "opticalflowcontainer_tpu/ops/solve2x2.py:96",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None}


def clip_phase(torch, dev, trace_dir, H=720, W=1280, T=7, reps=5) -> dict:
    from opticalflowcontainer_tpu_torch.classical import farneback as fb
    from opticalflowcontainer_tpu_torch.ops.farneback_update import farneback_update
    from opticalflowcontainer_tpu_torch.ops.solve2x2 import blur_solve

    shift = (1.25, -0.6)  # px per frame
    frames = plane_waves(torch, H, W, [(t * shift[0], t * shift[1]) for t in range(T)],
                         seed=2, device=dev)
    fb.farneback_clip(frames, device=dev)  # warm-up: library load, allocator
    torch.cuda.synchronize()
    farneback_update.launches = 0
    blur_solve.launches = 0
    flow = fb.farneback_clip(frames, device=dev)
    torch.cuda.synchronize()
    launches = {"farneback_update": farneback_update.launches,
                "blur_solve": blur_solve.launches}
    expect = (fb._num_levels(H, W, 3, 0.5) + 1) * 3
    print(f"one farneback_clip call launched {launches} (expected {expect} each)")
    require(all(n == expect for n in launches.values()),
            "each kernel launched (levels+1)*iterations times per call")
    require(tuple(flow.shape) == (T - 1, H, W, 2), f"flow shape {tuple(flow.shape)}")
    require(bool(torch.isfinite(flow).all()), "flow is finite")
    m = 40
    inner = flow[:, m:-m, m:-m]
    truth = torch.tensor(shift, device=dev)
    epe = float((inner - truth).norm(dim=-1).mean())
    bar = 0.05
    print(f"{H}x{W} clip: mean interior EPE vs the known shift {epe:.5f} px "
          f"(bar {bar}), mean flow {inner.mean((0, 1, 2)).tolist()}")
    require(epe < bar, "the clip recovers the known translation")
    call_ms = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fb.farneback_clip(frames, device=dev)
        end.record()
        end.synchronize()
        call_ms.append(start.elapsed_time(end))
    ms = float(np.median(call_ms))
    print(f"{H}x{W} T={T} clip: {ms:.3f} ms per call (median of {reps}: "
          f"{[round(x, 3) for x in call_ms]}), {(T - 1) / ms * 1e3:.2f} fields/s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    profile_path(torch, "one clip call",
                 lambda: fb.farneback_clip(frames, device=dev), trace_dir, "clip")

    # the same entry point on the card and on the CPU (plain versions), small
    small = plane_waves(torch, 96, 128, [(0, 0), (1.5, 0.5), (3.0, 1.0)], seed=3,
                        device="cpu").numpy()
    on_card = fb.farneback_clip(small, device=dev).cpu().numpy()
    on_cpu = fb.farneback_clip(small, device="cpu").numpy()
    d = np.abs(on_card - on_cpu)
    print(f"96x128 clip, card vs CPU: mean|d| {d.mean():.2e}, max|d| {d.max():.2e} px "
          f"(bar 1e-3 / 1e-2)")
    require(d.mean() <= 1e-3 and d.max() <= 1e-2, "card agrees with the CPU")
    return launches


def host_wait(trace_path: str) -> tuple[float, float]:
    """(idle ms, host-wait ms) of a Chrome trace from torch.profiler: the
    device's idle time between consecutive operations, and the part of it
    in gaps where the host's launch call for the next operation had not
    returned when the previous one ended (the device waited on the host)."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    ops = sorted((e for e in events
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")),
                 key=lambda e: e["ts"])
    launch_end = {e["args"]["correlation"]: e["ts"] + e["dur"] for e in events
                  if e.get("cat") == "cuda_runtime"
                  and "correlation" in e.get("args", {})}
    idle = waited = 0.0
    for a, b in zip(ops, ops[1:]):
        end = a["ts"] + a["dur"]
        gap = b["ts"] - end
        if gap > 0:
            idle += gap
            if launch_end.get(b["args"].get("correlation"), -1.0) > end:
                waited += gap
    return idle / 1e3, waited / 1e3


def profile_path(torch, label: str, fn, trace_dir, trace_name: str) -> None:
    """Where the time of ``fn()`` goes, under torch.profiler: device time by
    kernel name, the device's busy share of the wall time, how long the idle
    device waited on the host's launches, and the host's stream
    synchronizations and host-to-device copies (each pageable upload also
    synchronizes the stream)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(trace_dir or tmp, f"{trace_name}_trace.json")
        prof.export_chrome_trace(path)
        if trace_dir:
            print(f"profiler trace: {path}")
        idle_ms, waited_ms = host_wait(path)
    events = prof.key_averages()
    # device-side events only: an aten op's entry repeats its kernels' time
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    syncs = sum(e.count for e in events if e.device_type == DeviceType.CPU
                and e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize"))
    h2d = sum(e.count for e in kernels if "HtoD" in e.key)
    if not kernels:
        print(f"profiler, {label}: no device time recorded; breakdown not measured")
        return
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"profiler, {label}: {sum(e.count for e in kernels)} device "
          f"operations, busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall "
          f"(idle share {1 - busy_ms / wall_ms:.3f}, profiler on); "
          f"{syncs} stream synchronizations, {h2d} host-to-device copies")
    print(f"  idle between device operations {idle_ms:.3f} ms, of it "
          f"{waited_ms:.3f} ms with the next launch not yet issued by the host")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")


def stream_phase(torch, dev, trace_dir, H=480, W=640, n=401, dx=1.5,
                 fps=30.0) -> None:
    from opticalflowcontainer_tpu_torch.classical import farneback as fb
    from opticalflowcontainer_tpu_torch.ops.farneback_update import farneback_update
    from opticalflowcontainer_tpu_torch.ops.solve2x2 import blur_solve
    from opticalflowcontainer_tpu_torch.runtime.fused import (
        FusedFarnebackStream, make_fused_farneback_backend)
    from opticalflowcontainer_tpu_torch.runtime.velocity import VelocityEstimator

    # uint8 BGR camera frames in host memory, as a capture loop hands them on
    gray = plane_waves(torch, H, W, [(t * dx, 0.0) for t in range(n)], seed=4,
                       device=dev)
    gains = torch.tensor([0.9, 1.0, 1.1], device=dev)  # B, G, R
    frames = (gray[..., None] * gains).clamp(0, 255).round().to(torch.uint8)
    frames = frames.cpu().numpy()
    del gray
    s = FusedFarnebackStream(device=dev)
    s.warmup(frames[0])
    farneback_update.launches = 0
    blur_solve.launches = 0
    require(s.step(frames[0]) is None, "first frame seeds the state")
    dus, lat = [], []
    for f in frames[1:]:
        t0 = time.perf_counter()
        du = s.step(f)
        du_px = float(du)  # syncs
        lat.append((time.perf_counter() - t0) * 1e3)
        dus.append(du_px)
        require(abs(du_px - dx) < 0.1, f"stream du {du_px:.4f} near the shift {dx}")
    per_frame = (fb._num_levels(H, W, 3, 0.5) + 1) * 3
    expect = per_frame * (n - 1)
    lat = np.array(lat)
    print(f"{W}x{H} stream, {n - 1} frames: du min {min(dus):.4f}, max "
          f"{max(dus):.4f} px (shift {dx}); launches {farneback_update.launches}, "
          f"{blur_solve.launches} (expected {expect} each)")
    print(f"{W}x{H} stream per-frame latency over {len(lat)} frames (host clock, "
          f"numpy frame to synced du): p50 {np.percentile(lat, 50):.3f} ms, p99 "
          f"{np.percentile(lat, 99):.3f} ms, mean {lat.mean():.3f} ms, min "
          f"{lat.min():.3f} ms, max {lat.max():.3f} ms")
    require(farneback_update.launches == blur_solve.launches == expect,
            f"the stream launched both kernels {per_frame} times per frame")
    k = 8
    s1 = FusedFarnebackStream(device=dev)
    s1.step(frames[0])
    one_by_one = torch.stack([s1.step(f) for f in frames[1:k + 1]])
    s2 = FusedFarnebackStream(device=dev)
    s2.step(frames[0])
    chunk = s2.step_many(frames[1:k + 1])
    require(torch.equal(chunk, one_by_one), "step_many == step bit for bit")

    def ten_steps():
        for f in frames[k + 1:k + 11]:
            float(s1.step(f))

    profile_path(torch, "ten stream steps", ten_steps, trace_dir, "stream")
    p2m = 0.000857
    vel = VelocityEstimator(pixel_to_meter=p2m)
    vx, _ = vel.update_from_displacement(dus[-1], 1.0 / fps)
    want = dx * fps * p2m
    print(f"velocity {vx:.6f} m/s (known {want:.6f} m/s)")
    require(abs(vx - want) < 0.05 * want, "VelocityEstimator gives the known m/s")
    backend = make_fused_farneback_backend(device=dev)
    du_b = backend(frames[0], frames[1], 1.0 / fps)
    require(abs(du_b - dx) < 0.1, f"backend du {du_b:.4f} near the shift")


def main() -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", metavar="DIR",
                    help="write the profiled clip call and stream steps as "
                         "Chrome traces into DIR")
    args = ap.parse_args()
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to drive", file=sys.stderr)
        return 1
    # the package sits beside this script; without it there is nothing to run
    import opticalflowcontainer_tpu_torch  # noqa: F401

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    with phase("0 device"):
        device = device_phase(torch)
    with phase("1 build"):
        build_phase()
    with phase("2 K1 farneback_update vs plain"):
        k1 = k1_phase(torch, dev)
    with phase("3 K2 blur_solve vs plain"):
        k2 = k2_phase(torch, dev)
    with phase("4 720p T=7 clip (main path)"):
        launches = clip_phase(torch, dev, args.trace)
    with phase("5 640x480 stream"):
        stream_phase(torch, dev, args.trace)
    for k in (k1, k2):
        k["launches"] = launches[k["name"]]
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [k1, k2]}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
