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
   step bit for bit; per-frame latency (p50, p99) over a 400-frame window;
6. K3 warp_bilinear vs its plain version, zeros and edge padding, mask off
   and on, at PWC-Net's level 2 (B=8) and on Farneback's 720p planes (B=6),
   with flows that put taps out of the image and a column that straddles
   the mask threshold; timed beside its bound and F.grid_sample;
7. K4 local_correlation vs its plain version in the six configurations of
   the model zoo, at the channels and level sizes each model has at
   640x480, B=1 and B=8; timed beside its bound;
8. the PWC-Net path at 640x480 on seeded weights (the packaged npz is not
   read, so the run needs no weights file): K3 and K4 launches per estimate call; the
   kernel path vs the plain path on the card and vs the CPU; latency at
   B=1, pairs/s at B=8, and a 200-frame uint8 BGR stream through
   make_model_backend and VelocityEstimator (p50, p99 per frame).

Phases 4, 5 and 8 also run their path once under torch.profiler: device
busy time, idle share, how much of the idle time the device spent waiting
for the host to launch its next operation, and the stream synchronizations
and host-to-device copies made.  ``--trace DIR`` keeps those profiles there
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


def k3_phase(torch, dev, seed=5) -> dict:
    import torch.nn.functional as F

    from opticalflowcontainer_tpu_torch.ops.warp_bilinear import (
        warp_bilinear, warp_bilinear_plain)

    rng = np.random.default_rng(seed)
    tol = 1e-6
    worst = 0.0
    entry = None
    # PWC-Net's level-2 warp at 640x480, B=8; Farneback's 720p planes, B=6
    for B, C, H, W in ((8, 32, 128, 160), (6, 5, 720, 1280)):
        src = torch.from_numpy(rng.standard_normal((B, C, H, W), np.float32)).to(dev)
        src += 3.0  # no exact zeros: a zero output is a gated or empty pixel
        yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
        # smooth flow up to ~8 px plus noise: taps leave the image near its
        # borders; the last column straddles the 0.999 mask threshold
        u = np.stack([6 * np.sin(2 * np.pi * (yy / H + b / B)) for b in range(B)])
        v = np.stack([4 * np.cos(2 * np.pi * (xx / W + b / B)) for b in range(B)])
        u = (u + rng.uniform(-2, 2, u.shape)).astype(np.float32)
        v = (v + rng.uniform(-2, 2, v.shape)).astype(np.float32)
        u[:, :, -1] = 0.001 + rng.uniform(-1e-6, 1e-6, (B, H))
        v[:, :, -1] = 0.0
        u, v = torch.from_numpy(u).to(dev), torch.from_numpy(v).to(dev)
        scale = float(src.abs().max())
        for padding in ("zeros", "edge"):
            for thr in (None, 0.999):
                got = warp_bilinear(src, u, v, padding, thr)
                want = warp_bilinear_plain(src, u, v, padding, thr)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                worst = max(worst, err)
                gates = bool(torch.equal(got == 0, want == 0))
                empty = float((want == 0).all(1).float().mean())
                print(f"K3 [{B}, {C}, {H}, {W}] {padding} mask "
                      f"{'on' if thr else 'off'}: zero share {empty:.4f}; max|d| "
                      f"{err:.3e}, /max|src| {err / scale:.3e} (tolerance {tol:.0e}: "
                      f"FMA contraction of the tap sum); gates equal: {gates}")
                require(gates and err <= tol * scale,
                        f"K3 {padding} mask {thr} agrees with its plain version")
        # one PyTorch call computing the same warp: grid_sample on the
        # align_corners=True grid that maps onto these pixel coordinates
        gx = 2 * (torch.arange(W, device=dev) + u) / (W - 1) - 1
        gy = 2 * (torch.arange(H, device=dev)[:, None] + v) / (H - 1) - 1
        grid = torch.stack([gx, gy], -1)
        lib = F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros",
                            align_corners=True)
        lib_err = float((lib - warp_bilinear(src, u, v)).abs().max())
        print(f"K3 vs F.grid_sample(align_corners=True): max|d| {lib_err:.3e} "
              f"(the normalized grid's rounding)")
        require(lib_err <= 1e-3 * scale, "grid_sample computes the same warp")
        ms = cuda_ms(lambda: warp_bilinear(src, u, v), reps=20)
        masked_ms = cuda_ms(lambda: warp_bilinear(src, u, v, "zeros", 0.999), reps=20)
        edge_ms = cuda_ms(lambda: warp_bilinear(src, u, v, "edge"), reps=20)
        plain_ms = cuda_ms(lambda: warp_bilinear_plain(src, u, v), reps=5)
        lib_ms = cuda_ms(lambda: F.grid_sample(
            src, grid, mode="bilinear", padding_mode="zeros", align_corners=True),
            reps=20)
        n_pix = B * H * W
        # src read once, u and v read, out written; 4 taps x 2 flops per value
        n_bytes = 4 * (2 * C * n_pix + 2 * n_pix)
        b_ms, by = bound_ms(n_bytes, 8 * C * n_pix)
        print(f"K3 [{B}, {C}, {H}, {W}] zeros: {ms:.4f} ms per launch (mask on "
              f"{masked_ms:.4f} ms, edge {edge_ms:.4f} ms; plain {plain_ms:.4f} ms, "
              f"grid_sample {lib_ms:.4f} ms, bound {b_ms:.4f} ms by {by}: "
              f"{n_bytes / 1e6:.1f} MB)")
        if entry is None:
            entry = {"name": "warp_bilinear", "route": "cuda",
                     "source": "opticalflowcontainer_tpu_torch/ops/csrc/warp_bilinear.cu",
                     "replaces": "opticalflowcontainer_tpu/ops/blockwarp.py:519",
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": by, "library_ms": lib_ms}
        del src, u, v, grid, lib, got, want
    entry["max_abs_err"] = worst
    return entry


# (max_disp, disp_stride, out_stride, channels, level H, level W) of every
# user of the correlation at 640x480: PWC-Net pads to 640x512 and correlates
# at 1/4 (pwcnet.py); LiteFlowNet and LFN3 pad to 640x480 and correlate at
# the levels of their shared trunk (32/32/64/96/128/192 channels at
# 1/1..1/32; liteflownet.py, liteflownet3.py), largest level of each listed
CORR_AT_640x480 = {
    "pwc": (4, 1, 1, 32, 128, 160),
    "lfn_levels4to6": (3, 1, 1, 96, 60, 80),
    "lfn_levels2to3": (6, 2, 2, 64, 240, 320),
    "lfn3_cross": (4, 1, 1, 64, 120, 160),
    "lfn3_self_level4": (6, 2, 1, 96, 60, 80),
    "lfn3_self_level3": (8, 2, 1, 64, 120, 160),
}


def k4_phase(torch, dev, seed=6) -> dict:
    from opticalflowcontainer_tpu_torch.ops.correlation import (
        correlation_plain, local_correlation)

    rng = np.random.default_rng(seed)
    tol = 1e-6
    worst = 0.0
    entry = None
    for name, (md, ds, os_, C, H, W) in CORR_AT_640x480.items():
        for B in (1, 8):
            f1, f2 = (torch.from_numpy(rng.standard_normal((B, C, H, W), np.float32))
                      .to(dev) for _ in range(2))
            got = local_correlation(f1, f2, md, ds, os_)
            want = correlation_plain(f1, f2, md, ds, os_)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            scale = float(f1.abs().max() * f2.abs().max())
            worst = max(worst, err)
            print(f"K4 {name} {(md, ds, os_)} [{B}, {C}, {H}, {W}] -> "
                  f"{tuple(got.shape)}: max|d| {err:.3e}, /max|f1|max|f2| "
                  f"{err / scale:.3e} (tolerance {tol:.0e}: a mean of {C} fp32 "
                  f"products in another order)")
            require(got.shape == want.shape and err <= tol * scale,
                    f"K4 {name} B={B} agrees with its plain version")
        K2 = got.shape[1]
        Ho, Wo = got.shape[2:]
        ms = cuda_ms(lambda: local_correlation(f1, f2, md, ds, os_), reps=20)
        # f1 (at the output stride) and f2 read once, the volume written
        n_bytes = 4 * (C * B * Ho * Wo + C * B * H * W + K2 * B * Ho * Wo)
        b_ms, by = bound_ms(n_bytes, 2 * C * K2 * B * Ho * Wo)
        line = (f"K4 {name} B=8: {ms:.4f} ms per launch, bound {b_ms:.4f} ms "
                f"by {by} ({n_bytes / 1e6:.1f} MB)")
        if name == "pwc":
            plain_ms = cuda_ms(lambda: correlation_plain(f1, f2, md, ds, os_), reps=5)
            line += f", plain {plain_ms:.4f} ms; no single PyTorch call computes it"
            entry = {"name": "local_correlation", "route": "cuda",
                     "source": "opticalflowcontainer_tpu_torch/ops/csrc/correlation.cu",
                     "replaces": "opticalflowcontainer_tpu/ops/correlation_pallas.py:67",
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": by, "library_ms": None}
        print(line)
        del f1, f2, got, want
    entry["max_abs_err"] = worst
    return entry


def seeded_pwcnet(torch, seed: int, device):
    """PWC-Net at full width with He-normal weights (std sqrt(2 / fan_in))
    from a seeded torch.Generator and zero biases: flows of a few to ~40 px
    at 640x480, so the masked warps reach out of the image."""
    from opticalflowcontainer_tpu_torch.models.pwcnet import PWCNet

    g = torch.Generator().manual_seed(seed)
    model = PWCNet()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.ConvTranspose2d):
                fan_in = m.weight.shape[0] * 4  # 2x2 taps of the 4x4/s2 kernel
            elif isinstance(m, torch.nn.Conv2d):
                fan_in = m.weight[0].numel()
            else:
                continue
            m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                           * (2.0 / fan_in) ** 0.5)
            m.bias.zero_()
    return model.to(device).eval()


@contextlib.contextmanager
def plain_kernels():
    """The PWC-Net path with K3 and K4 replaced by their plain versions
    (for comparing the kernels' path with the plain one on the card)."""
    from unittest import mock

    from opticalflowcontainer_tpu_torch.models import pwcnet
    from opticalflowcontainer_tpu_torch.ops import correlation as k4
    from opticalflowcontainer_tpu_torch.ops import warp_bilinear as k3

    with mock.patch.object(k3, "warp_bilinear", k3.warp_bilinear_plain), \
            mock.patch.object(pwcnet, "local_correlation", k4.correlation_plain):
        yield


def pwc_phase(torch, dev, trace_dir, H=480, W=640, n=201, seed=7) -> dict:
    import functools

    from opticalflowcontainer_tpu_torch.models.pwcnet import estimate
    from opticalflowcontainer_tpu_torch.ops.correlation import local_correlation
    from opticalflowcontainer_tpu_torch.ops.warp_bilinear import warp_bilinear
    from opticalflowcontainer_tpu_torch.runtime.nodes import make_model_backend
    from opticalflowcontainer_tpu_torch.runtime.velocity import VelocityEstimator

    model = seeded_pwcnet(torch, seed, dev)
    n_params = sum(p.numel() for p in model.parameters())
    gains = torch.tensor([0.9, 1.0, 1.1], device=dev)  # B, G, R

    def pair(h, w, batch, device):
        g = plane_waves(torch, h, w, [(1.5 * t, 0.5 * t) for t in range(2 * batch)],
                        seed=8, device=device)
        img = (g[..., None] * gains.to(device) / 255.0).clamp(0, 1)
        return img[0::2].contiguous(), img[1::2].contiguous()

    i1, i2 = pair(H, W, 1, dev)
    estimate(model, i1, i2)  # warm-up: library load, cuDNN heuristics
    torch.cuda.synchronize()
    warp_bilinear.launches = 0
    local_correlation.launches = 0
    flow = estimate(model, i1, i2)
    torch.cuda.synchronize()
    launches = {"warp_bilinear": warp_bilinear.launches,
                "local_correlation": local_correlation.launches}
    print(f"PWC-Net ({n_params} parameters, seeded) one estimate call at "
          f"{W}x{H} launched {launches} (expected 4 and 5)")
    require(launches == {"warp_bilinear": 4, "local_correlation": 5},
            "each estimate call runs 4 masked warps and 5 correlations")
    require(tuple(flow.shape) == (1, H, W, 2), f"flow shape {tuple(flow.shape)}")
    require(bool(torch.isfinite(flow).all()), "flow is finite")
    print(f"flow |u|,|v| mean {flow.abs().mean((0, 1, 2)).tolist()}, max "
          f"{float(flow.abs().max()):.3f} px")

    def latency(x1, x2, reps, warm=5):
        """ms of each of ``reps`` estimate calls after ``warm``, CUDA events."""
        out = []
        for _ in range(warm + reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            estimate(model, x1, x2)
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        return np.array(out[warm:])

    mean_bar, max_bar = 1e-3, 5e-2
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # fp32 convolutions to compare
    try:
        kern = estimate(model, i1, i2)
        with plain_kernels():
            plain = estimate(model, i1, i2)
        d = (kern - plain).abs()
        print(f"{W}x{H} kernel path vs plain path on the card: mean|d| "
              f"{float(d.mean()):.3e}, max|d| {float(d.max()):.3e} px (bars "
              f"{mean_bar} / {max_bar}: fp32 sums in another order; the max "
              f"allows a masked-warp threshold flip)")
        require(float(d.mean()) <= mean_bar and float(d.max()) <= max_bar,
                "the kernels' path agrees with the plain path")
        s1, s2 = pair(128, 192, 1, "cpu")
        on_card = estimate(model, s1, s2).cpu()
        on_cpu = estimate(seeded_pwcnet(torch, seed, "cpu"), s1, s2)
        d = (on_card - on_cpu).abs()
        print(f"192x128 card vs CPU (plain versions, fp32): mean|d| "
              f"{float(d.mean()):.3e}, max|d| {float(d.max()):.3e} px (bars "
              f"{mean_bar} / {max_bar})")
        require(float(d.mean()) <= mean_bar and float(d.max()) <= max_bar,
                "card agrees with the CPU")
        fp32_ms = latency(i1, i2, 50)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    lat = latency(i1, i2, 50)
    print(f"{W}x{H} estimate at B=1, CUDA events over 50 calls: median "
          f"{np.median(lat):.3f} ms, p90 {np.percentile(lat, 90):.3f} ms "
          f"(PyTorch defaults, cuDNN TF32 {tf32}); with fp32 convolutions "
          f"median {np.median(fp32_ms):.3f} ms")
    b1, b2 = pair(H, W, 8, dev)
    torch.cuda.reset_peak_memory_stats()
    lat8 = latency(b1, b2, 10)
    print(f"{W}x{H} estimate at B=8: median {np.median(lat8):.3f} ms per call, "
          f"{8e3 / np.median(lat8):.2f} pairs/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del b1, b2

    profile_path(torch, "one PWC-Net estimate at B=1",
                 lambda: estimate(model, i1, i2), trace_dir, "pwcnet")

    # the stream: uint8 BGR camera frames in host memory through the
    # learned-model backend into the velocity estimator
    g = plane_waves(torch, H, W, [(1.5 * t, 0.0) for t in range(n)], seed=9,
                    device=dev)
    frames = (g[..., None] * gains).clamp(0, 255).round().to(torch.uint8).cpu().numpy()
    del g
    backend = make_model_backend(functools.partial(estimate, model), device=dev)
    vel = VelocityEstimator()
    backend(frames[0], frames[1], 1 / 30)  # warm-up
    warp_bilinear.launches = 0
    local_correlation.launches = 0
    times = []
    for prev, cur in zip(frames[:-1], frames[1:]):
        t0 = time.perf_counter()
        f = backend(prev, cur, 1 / 30)
        vx, _, _ = vel.update(f, 1 / 30)
        times.append((time.perf_counter() - t0) * 1e3)
        require(f.shape == (H, W, 2) and np.isfinite(f).all() and np.isfinite(vx),
                "the stream's flow and velocity are finite")
    times = np.array(times)
    print(f"{W}x{H} PWC-Net stream, {n - 1} uint8 BGR frames (host clock, frame "
          f"to numpy flow and m/s): p50 {np.percentile(times, 50):.3f} ms, p99 "
          f"{np.percentile(times, 99):.3f} ms, mean {times.mean():.3f} ms, min "
          f"{times.min():.3f} ms, max {times.max():.3f} ms; launches "
          f"{warp_bilinear.launches}, {local_correlation.launches} (expected "
          f"{4 * (n - 1)}, {5 * (n - 1)})")
    require(warp_bilinear.launches == 4 * (n - 1)
            and local_correlation.launches == 5 * (n - 1),
            "the stream ran both kernels on every frame")
    return launches


def main() -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", metavar="DIR",
                    help="write the profiled clip call, stream steps and "
                         "PWC-Net estimate as Chrome traces into DIR")
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
    with phase("6 K3 warp_bilinear vs plain"):
        k3 = k3_phase(torch, dev)
    with phase("7 K4 local_correlation vs plain"):
        k4 = k4_phase(torch, dev)
    with phase("8 PWC-Net 640x480 (correlation path)"):
        launches.update(pwc_phase(torch, dev, args.trace))
    for k in (k1, k2, k3, k4):
        k["launches"] = launches[k["name"]]
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [k1, k2, k3, k4]}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
