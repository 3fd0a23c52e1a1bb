#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and hold its kernels against their
plain PyTorch versions.

    python3 chip_smoke.py

Run from the repository root on a machine with one CUDA card, nvcc and
PyTorch built for CUDA (no JAX, no cv2).  Phases, each printed with its
seconds:

0. the device: name, count, and nvidia-smi's name and power limit;
1. the build: one nvcc call over opticalflowcontainer_tpu_torch/ops/csrc/*.cu
   and the host-only *.cpp (build seconds and the ptxas register/shared-memory
   lines);
2. K1 farneback_update vs its plain version at the 720p finest level, B=6,
   with flows that put taps out of bounds; timed beside its bound;
3. K2 blur_solve vs its plain version, box and Gaussian, at the clip's
   finest level (720p, B=6; winsize 15 and 13) and the stream's four
   levels, and box at 41 (above the TPU kernel's limit) and 101 (opt-in
   shared memory) at 720p, each naming the kernel variant and tile that
   ran; timed beside its bound at each of those shapes;
4. the main path: farneback_clip on a 720p T=7 clip of a texture with a
   known subpixel translation: EPE against it, the kernel launch counts of
   one call, ms per call and fields/s; and the clip on the card vs the CPU
   on a small input;
5. the stream at 640x480: FusedFarnebackStream and the flow-node backend on
   uint8 BGR frames with a known shift; VelocityEstimator m/s; step_many ==
   step bit for bit; per-frame latency (p50, p99) over a 400-frame window;
6. K3 warp_bilinear vs its plain version, zeros and edge padding, mask off
   and on, at PWC-Net's level 2 (B=8), on Farneback's 720p planes (B=6), at
   PWC-Net's four warps at B=1 and at LiteFlowNet's and LFN3's B=1 shapes
   (LFN3's flow deformation at C=2, the image warp at C=3, LiteFlowNet's
   level-2 feature warp at C=64), at NeuFlowLite's 1/8 warp at 640x480
   (C=64) and NeuFlow-v2's 1/16 and 1/8 warps at 768x432 (C=128), with
   flows that put taps out of the image
   and a column that straddles the mask threshold; timed beside its bound
   and F.grid_sample at each shape;
7. K4 local_correlation vs its plain version in the six configurations of
   the model zoo, at the channels and level sizes each model has at
   640x480, B=1 and B=8, and at every correlation PWC-Net (five),
   LiteFlowNet (five) and LFN3 (six) make at B=1, and NeuFlowLite's (at
   640x480) and NeuFlow-v2's two (at 768x432, radius 4); each launch run twice and
   the two held bit for bit; timed beside its bound at B=8 and at each B=1
   correlation;
8. the PWC-Net path at 640x480 on seeded weights (the packaged npz is not
   read, so the run needs no weights file): K3 and K4 launches per estimate call; the
   kernel path vs the plain path on the card and vs the CPU; latency at
   B=1, pairs/s at B=8, and a 200-frame uint8 BGR stream through
   make_model_backend and VelocityEstimator (p50, p99 per frame); and the
   served flow (cuDNN TF32 convolutions, PyTorch's default) against fp32
   convolutions on the same pair;
9. and 10. the LiteFlowNet3 and LiteFlowNet paths at 640x480 on seeded
   weights, each with phase 8's checks: K3 and K4 launches per estimate
   (13 and 6, 14 and 5), kernel path vs plain path and card vs CPU, the
   served convolutions vs fp32, latency at B=1 and pairs/s at B=8;
11. the device-resident model stream: FusedModelStream over LFN3 at 640x480
   on 200 uint8 BGR frames, p50 and p99 per frame, du against
   make_model_backend + VelocityEstimator on the same frames, step_many ==
   step bit for bit, and one upload and one scalar download per frame
   counted under the profiler;
12. the node graph at 640x480: the demo (plain and --fused) and
   bringup_flow with depth and camera_info;
13. MultiStreamFlow: two 1080p gray streams at 60 fps for 6 s;
14. the LFN3 JunctionMaskFlowNode at 640x480 in topic mode;
15. measure_stream_latency at 640x480 for Farneback and LFN3;
16. Lucas-Kanade at 640x480 with cv2's defaults: up to 500 corners of
   good_features_to_track tracked on a pair with a known subpixel shift
   (the interior error, the card against the CPU, ms per call and its
   device operations), then LKVelocityNode on the SyntheticCamera at 30 fps
   for 90 frames (every frame processed, none failed, the velocity within
   10 mm/s of the ground truth);
17. and 18. RAFT-small and RAFT (large) at 640x480 on seeded weights:
   estimate at iters=12, the card against the CPU with fp32 convolutions,
   the served flow (fp32 convolutions, which RAFT holds) against fp32 and
   what TF32 would give (bars relative to the flow's RMS), final_only
   against the stacked flows, B=1 latency, B=8
   pairs/s and the device time by part (all-pairs product, pyramid,
   lookup, convolutions, the rest); RAFT-small also as a 200-frame
   FusedModelStream at iters=8, the demo's.  Phases 16-18 launch none of
   K1-K4 (their wrappers' counters hold it);
19. and 20. NeuFlowLite at 640x480 and NeuFlow-v2 at 768x432 (the
   reference NeuFlow node's size) on seeded weights: K3 and K4 launches
   per estimate (2 and 2, 9 and 9), the kernel path against the plain path
   and the card against the CPU (bars relative to the flow's RMS), what
   TF32 convolutions would give, B=1 latency, B=8 pairs/s, the profile
   (NeuFlow-v2: device time by part: backbone, attention and matching,
   refinement, upsampling), a 200-frame FusedModelStream (p50/p99); for
   NeuFlowLite also the demo --model neuflow at 640x480, 30 fps, 90 frames
   (every frame processed or dropped, none failed; its velocity error is
   printed: seeded weights make it no accuracy figure);
21. bf16 serving: each of the seven families through
   FusedModelStream(bf16=True) at its phase's size over 100 frames, p50/p99
   beside the fp32 stream's, the bf16 flow (fp32, finite) against the fp32
   flow on one pair, and K3/K4 launches equal to the fp32 stream's;
22. the offline eval and tools: run_eval --method farneback on the easy
   fishnet suite (640x480, 32 pairs; its JSON row, the mean EPE beside
   README.md's JAX figure, K1/K2 launches a pair, pairs 0-1 on the card
   against the CPU), pwcnet and neuflow on 4 fishnet pairs (K3/K4 launches
   a pair; seeded weights where the npz is absent, said on its own line),
   --time-device for farneback and pwcnet, run_pair and fish_speed on two
   PNGs of a known subpixel shift written by the port's imwrite (the .flo's
   interior mean u within 0.05 px of it), and zoo_latency --quick;
23. training at train_flow's defaults (B=8, 96x128, --iters 8): every
   PWC-Net parameter's gradient through the kernels (K3/K4 forward, their
   plain versions' autograd backward) against the plain path, cuDNN in
   fp32 (at 128x192: PWC-Net's sizes are multiples of 64); each of the
   seven families trained for 30 steps through
   train_flow.main from its seeded init (finite losses, K3/K4 launches a
   step, steps/s, peak memory, a checkpoint, the exported npz loaded back
   and served at 640x480); RAFT-small's loss on a fixed batch falling
   below 0.7x in 8 steps (tests/test_training.py's recipe); PWC-Net's and
   LFN3's forward and backward device time and the share of K3/K4's
   plain backward in it;
24. the junction pipeline at 640x480: the compiled junction detector (host
   C++ from ops/csrc/junction_detect.cpp, built by the same nvcc call)
   against the plain one on tests/data/fishnet_golden.png (rotated cells;
   recall and precision against its ground truth) and on a drawn fishnet,
   ms per frame of each; bringup_junction on the card with the default
   Farneback backend (K1/K2) on the fishnet moving 2 px a frame (the mean
   velocity within 0.3 px/frame), then with LFN3's model backend on seeded
   weights (13/6 K3/K4 launches a pair), the detector's ms per frame and
   image publish -> velocity p50/p99; bringup_junction_remote (the detector
   in its own process over the TCP bridge, the same velocity bar, the
   round trip p50/p99); make_adaptive_backend around Farneback (CLAHE,
   median 3, the magnitude mask), the card against the CPU and ms a frame
   with and without it; preprocess_frames, the card against the CPU; and
   DevicePrefetcher over 100 frames (order and bytes; under the profiler
   its copies on its side stream);
25. the scale-out: one NCCL rank in this process on a 1x1 mesh runs the
   sharded flow, spatial and stream callables at [2, 1080, 1920] (BASELINE
   config 5's frames, cv2's defaults), each against farneback_batched /
   farneback_stream_step (1e-5 px; K1/K2 launch inside each as in the
   unsharded call), and the sharded RAFT-small train step (full width,
   seeded, B=8, 96x128, iters=8, 5 steps) against train_step step by step
   from the same state (each loss within 1e-5, each update within 1e-6
   where the gradient counts); then two spawned ranks on the one card
   (gloo: NCCL refuses two ranks on a device) run the three inference
   legs on meshes (2, 1) and (1, 2), each against the one-rank results;
   the sharded and unsharded ms and the collectives' share;
26. the stage roofline: tools/stage_roofline.py at its defaults (720p, T=5,
   64 calls a timed graph): the ceilings measured on
   the card (HBM reads at 128-1024 MB, read+write at 256 MB and inside the
   L2, matmuls in fp32/TF32/bf16, an FMA chain) below the data sheet, every
   leg finite, and no stage's GB/s above 105% of the measured HBM
   read+write ceiling (a reading over it is a wrong byte count), or of the
   L2's for a stage whose whole traffic in a call fits in the L2.

Seeded weights cannot measure accuracy: the nets' accuracy is held on the
CPU against the JAX package with the packaged npz
(tests/test_torch_pwcnet.py, test_torch_liteflownet*.py,
test_torch_raft.py, test_torch_neuflow*.py, test_torch_bf16_serving.py).
Here they
measure the kernels' path against the plain one, the card against the CPU,
and time.

Kernel times are CUDA events around back-to-back wrapper calls (``ms``,
what a caller waits for, the wrapper's host time included) and device time
by CUDA-graph replay (``graph_ms``: at the B=1 shapes a kernel is shorter
than its own Python dispatch).

Phases 4, 5, 8-14 and 16-20 also run their path once under
torch.profiler: device busy time, idle share, how much of the idle time
the device spent waiting for the host to launch its next operation, and
the stream synchronizations and host-to-device copies made.  ``--trace DIR`` keeps those profiles there
as Chrome traces.

Then one JSON line with every kernel's launches, error, times and bound, and
as the last line {"ok": true, "device": {...}}.  Without a CUDA device, or
without the package beside it, or when any phase fails, it exits non-zero
and prints no result line.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
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


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device ms per call of ``fn``: ``reps`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so the host's
    launch cost between the calls drops out (a kernel of a few microseconds
    is shorter than its own Python dispatch)."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * replays)


def estimate_ms(torch, estimate, model, x1, x2, reps: int, warm: int = 5) -> np.ndarray:
    """ms of each of ``reps`` ``estimate(model, x1, x2)`` calls after
    ``warm``, CUDA events around each."""
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


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def plane_waves(torch, H: int, W: int, shifts, seed: int, device,
                wavelengths=(6, 24)) -> "torch.Tensor":
    """Frames [len(shifts), H, W] fp32 on ``device`` of one band-limited
    texture (a sum of plane waves, wavelengths drawn from ``wavelengths``
    px, parameters drawn with numpy from ``seed``) translated exactly by
    each (dx, dy), computed in fp64.  Longer waves than 6-24 px leave
    Farneback (and cv2) short of the shift by ~10%; shorter ones alias in
    LK's 8x-reduced coarsest level."""
    rng = np.random.default_rng(seed)
    n = 12
    theta = rng.uniform(0, np.pi, n)
    k = 2 * np.pi / rng.uniform(*wavelengths, n)
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


GAINS_BGR = (0.9, 1.0, 1.1)


def image_pairs(torch, h, w, batch, device, seed=8):
    """``batch`` pairs [batch, h, w, 3] in [0, 1] of a band-limited texture
    moved (1.5, 0.5) px from each image to its pair."""
    g = plane_waves(torch, h, w, [(1.5 * t, 0.5 * t) for t in range(2 * batch)],
                    seed=seed, device=device)
    img = (g[..., None] * torch.tensor(GAINS_BGR, device=device) / 255.0).clamp(0, 1)
    return img[0::2].contiguous(), img[1::2].contiguous()


def bgr_frames(torch, H, W, n, dx, seed, device) -> np.ndarray:
    """``n`` uint8 BGR camera frames [n, H, W, 3] in host memory, a texture
    moving ``dx`` px per frame, as a capture loop hands them on."""
    g = plane_waves(torch, H, W, [(dx * t, 0.0) for t in range(n)], seed=seed,
                    device=device)
    gains = torch.tensor(GAINS_BGR, device=device)
    return (g[..., None] * gains).clamp(0, 255).round().to(torch.uint8).cpu().numpy()


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0].strip()


def device_phase(torch) -> dict:
    from opticalflowcontainer_tpu_torch.core.device import capabilities

    caps = capabilities()
    print(json.dumps(caps))
    print(card_line())
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


# [B, H, W] K1 is checked and timed at: the clip's finest level (720p, B=6)
# and the 2x1080p batcher's finest level (B=2)
K1_SHAPES = ((6, 720, 1280), (2, 1080, 1920))


def k1_phase(torch, dev, seed=0) -> dict:
    from opticalflowcontainer_tpu_torch.ops.farneback_update import (
        farneback_update, farneback_update_plain)

    rng = np.random.default_rng(seed)
    tol = 1e-5
    shapes = []
    for B, H, W in K1_SHAPES:
        R0 = torch.from_numpy(rng.standard_normal((B, 5, H, W), np.float32)).to(dev)
        R1 = torch.from_numpy(rng.standard_normal((B, 5, H, W), np.float32)).to(dev)
        yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
        # up to ~7 px of smooth flow plus noise: taps leave the level near
        # its borders, so both branches of the update run
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
        print(f"K1 [B={B}, 5, {H}, {W}]: out-of-bounds share "
              f"{1 - n_inb / n_pix:.4f}; max|d| {err:.3e}, max|d|/max|plain| "
              f"{err / scale:.3e} (tolerance {tol:.0e}: fp32, FMA contraction "
              f"and operation order differ)")
        require(err <= tol * scale, f"K1 [{B}, 5, {H}, {W}] agrees with its plain version")
        ms = cuda_ms(lambda: farneback_update(R0, R1, u, v), reps=20)
        g_ms = graph_ms(lambda: farneback_update(R0, R1, u, v))
        plain_ms = cuda_ms(lambda: farneback_update_plain(R0, R1, u, v), reps=5)
        b_ms, by = bound_ms(n_bytes, n_flops)
        print(f"K1 [B={B}, 5, {H}, {W}] {ms:.4f} ms per launch, events (graph "
              f"replay {g_ms:.4f} ms; plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"by {by}: {n_bytes / 1e6:.1f} MB; {b_ms / g_ms:.1%} of it by graph)")
        shapes.append({"shape": [B, 5, H, W], "max_abs_err": err, "ms": ms,
                       "graph_ms": g_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                       "bound_by": by})
        del R0, R1, u, v, got, want
    head = shapes[0]
    return {"name": "farneback_update", "route": "cuda",
            "source": "opticalflowcontainer_tpu_torch/ops/csrc/farneback_update.cu",
            "replaces": "opticalflowcontainer_tpu/ops/blockwarp.py:612",
            "max_abs_err": max(x["max_abs_err"] for x in shapes), "ms": head["ms"],
            "graph_ms": head["graph_ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None, "shapes": shapes}


# (B, H, W, winsize) K2 is timed at: the clip's finest level (720p, B=6),
# the 640x480 stream's four levels (B=1), at cv2's default winsize 15 and the
# runtime's default 13, and the 2x1080p batcher's finest level (B=2)
K2_SHAPES = ((6, 720, 1280, 15), (6, 720, 1280, 13), (1, 480, 640, 15),
             (1, 480, 640, 13), (1, 240, 320, 15), (1, 120, 160, 15),
             (1, 60, 80, 15), (2, 1080, 1920, 15))


def normal_eq(torch, rng, B, H, W, dev) -> "torch.Tensor":
    """Normal-equation planes [B, 5, H, W] shaped like the real ones: G
    positive definite."""
    a, b, c = (rng.standard_normal((B, H, W), np.float32) for _ in range(3))
    return torch.from_numpy(np.stack([a * a + 0.5, 0.3 * a * b, b * b + 0.5, c,
                                      a * c], axis=1)).to(dev)


def k2_phase(torch, dev, seed=1) -> dict:
    from opticalflowcontainer_tpu_torch.core.device import sm_count
    from opticalflowcontainer_tpu_torch.ops import solve2x2 as k2
    from opticalflowcontainer_tpu_torch.ops.solve2x2 import (
        blur_solve, blur_solve_plain)

    rng = np.random.default_rng(seed)
    tol = 1e-4
    worst = 0.0

    def check(M, winsize, gaussian):
        """Hold the launch blur_solve makes against the plain version."""
        nonlocal worst
        b, _, h, w = M.shape
        got = blur_solve(M, winsize, gaussian)
        want = blur_solve_plain(M, winsize, gaussian)
        torch.cuda.synchronize()
        err = max(float((g - x).abs().max()) for g, x in zip(got, want))
        scale = max(float(x.abs().max()) for x in want)
        worst = max(worst, err)
        tile = k2.choose_tile(winsize // 2, k2._smem_limit(dev.index), b, h, w,
                              sm_count(dev.index))[:2]
        print(f"K2 [{b}, 5, {h}, {w}] winsize {winsize} "
              f"{'gaussian' if gaussian else 'box'} ({k2.variant(winsize // 2)} "
              f"kernel, tile {tile}): max|d| {err:.3e}, max|d|/max|plain| "
              f"{err / scale:.3e} (tolerance {tol:.0e}: fp32 sums of up to 101 "
              f"taps in another order, then a division)")
        require(err <= tol * scale,
                f"K2 [{b}, 5, {h}, {w}] winsize {winsize} gaussian {gaussian} "
                f"agrees with its plain version")
        return tile

    shapes = []
    for b, h, w, winsize in K2_SHAPES:
        M = normal_eq(torch, rng, b, h, w, dev)
        for gaussian in (False, True):
            tile = check(M, winsize, gaussian)
        ms = cuda_ms(lambda: blur_solve(M, winsize, False), reps=20)
        g_ms = graph_ms(lambda: blur_solve(M, winsize, False))
        n_pix = b * h * w
        # M (5) in, u, v (2) out; 2 passes x 5 planes x winsize taps x 2
        # flops + the solve
        b_ms, by = bound_ms(4 * 7 * n_pix, (2 * 5 * winsize * 2 + 15) * n_pix)
        print(f"K2 [{b}, 5, {h}, {w}] winsize {winsize} box "
              f"({k2.variant(winsize // 2)} kernel, tile {tile}): {ms:.4f} ms "
              f"per launch back to back with events, {g_ms:.4f} ms by graph "
              f"replay (device time); bound {b_ms:.4f} ms by {by}: "
              f"{b_ms / ms:.1%} / {b_ms / g_ms:.1%} of it")
        shapes.append({"shape": [b, 5, h, w], "winsize": winsize,
                       "variant": k2.variant(winsize // 2), "tile": list(tile),
                       "ms": ms, "graph_ms": g_ms, "bound_ms": b_ms,
                       "bound_by": by})
        if not shapes[1:]:
            plain_ms = cuda_ms(lambda: blur_solve_plain(M, winsize, False), reps=5)
            # above the TPU kernel's limit, and above 48 KB of shared memory
            for big in (41, 101):
                check(M, big, False)
        del M
    head = shapes[0]
    print(f"K2 winsize 15 box [6, 5, 720, 1280]: {head['ms']:.4f} ms per launch "
          f"(events; graph replay {head['graph_ms']:.4f} ms; plain {plain_ms:.4f} "
          f"ms, bound {head['bound_ms']:.4f} ms)")
    return {"name": "blur_solve", "route": "cuda",
            "source": "opticalflowcontainer_tpu_torch/ops/csrc/blur_solve.cu",
            "replaces": "opticalflowcontainer_tpu/ops/solve2x2.py:96",
            "max_abs_err": worst, "ms": head["ms"], "graph_ms": head["graph_ms"],
            "plain_ms": plain_ms, "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": None, "shapes": shapes}


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


def profile_path(torch, label: str, fn, trace_dir, trace_name: str) -> dict | None:
    """Where the time of ``fn()`` goes, under torch.profiler: device time by
    kernel name, the device's busy share of the wall time, how long the idle
    device waited on the host's launches, and the host's stream
    synchronizations and copies each way (each pageable upload also
    synchronizes the stream).  Returns those counts and times, or None when
    the profiler recorded no device time."""
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
    d2h = sum(e.count for e in kernels if "DtoH" in e.key)
    if not kernels:
        print(f"profiler, {label}: no device time recorded; breakdown not measured")
        return None
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_ops = sum(e.count for e in kernels)
    print(f"profiler, {label}: {n_ops} device "
          f"operations, busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall "
          f"(idle share {1 - busy_ms / wall_ms:.3f}, profiler on); "
          f"{syncs} stream synchronizations, {h2d} host-to-device and {d2h} "
          f"device-to-host copies")
    print(f"  idle between device operations {idle_ms:.3f} ms, of it "
          f"{waited_ms:.3f} ms with the next launch not yet issued by the host")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")
    # the port's own kernels, each summed over its instantiations
    ours = []
    for name in ("farneback_update", "blur_solve", "warp_bilinear", "correlation"):
        mine = [e for e in kernels if f"::{name}_" in e.key]
        if mine:
            ours.append(f"{name} {sum(e.self_device_time_total for e in mine) / 1e3:.3f} "
                        f"ms x{sum(e.count for e in mine)}")
    print(f"  the port's kernels: {', '.join(ours) or 'none'}")
    return {"ops": n_ops, "busy_ms": busy_ms, "wall_ms": wall_ms,
            "idle_ms": idle_ms, "host_wait_ms": waited_ms, "syncs": syncs,
            "h2d": h2d, "d2h": d2h}


def stream_phase(torch, dev, trace_dir, H=480, W=640, n=401, dx=1.5,
                 fps=30.0) -> None:
    from opticalflowcontainer_tpu_torch.classical import farneback as fb
    from opticalflowcontainer_tpu_torch.ops.farneback_update import farneback_update
    from opticalflowcontainer_tpu_torch.ops.solve2x2 import blur_solve
    from opticalflowcontainer_tpu_torch.runtime.fused import (
        FusedFarnebackStream, make_fused_farneback_backend)
    from opticalflowcontainer_tpu_torch.runtime.velocity import VelocityEstimator

    frames = bgr_frames(torch, H, W, n, dx, seed=4, device=dev)
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


# [B, C, H, W] of the K3 launches the main paths make at 640x480, first the
# headline: PWC-Net's level-2 warp at B=8, Farneback's 720p planes (B=6),
# PWC-Net's four warps at B=1 (levels 5, 4, 3, 2), the stream node's unit,
# then LFN3's level-3 flow deformation (C=2), LiteFlowNet's level-2 image
# warp (C=3) and level-2 feature warp (C=64) at B=1, then NeuFlowLite's
# 1/8 warp at 640x480 and NeuFlow-v2's 1/16 and 1/8 warps at 768x432 (B=1)
K3_SHAPES = ((8, 32, 128, 160), (6, 5, 720, 1280), (1, 128, 16, 20),
             (1, 96, 32, 40), (1, 64, 64, 80), (1, 32, 128, 160),
             (1, 2, 120, 160), (1, 3, 240, 320), (1, 64, 240, 320),
             (1, 64, 60, 80), (1, 128, 27, 48), (1, 128, 54, 96))


def k3_inputs(torch, rng, B, C, H, W, dev):
    """src [B, C, H, W] (no exact zeros: a zero output is a gated or empty
    pixel) and u, v [B, H, W]: smooth flow up to ~8 px plus noise, so taps
    leave the image near its borders, and a last column whose in-image
    weight straddles the 0.999 mask threshold."""
    src = torch.from_numpy(rng.standard_normal((B, C, H, W), np.float32)).to(dev)
    src += 3.0
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    u = np.stack([6 * np.sin(2 * np.pi * (yy / H + b / B)) for b in range(B)])
    v = np.stack([4 * np.cos(2 * np.pi * (xx / W + b / B)) for b in range(B)])
    u = (u + rng.uniform(-2, 2, u.shape)).astype(np.float32)
    v = (v + rng.uniform(-2, 2, v.shape)).astype(np.float32)
    u[:, :, -1] = 0.001 + rng.uniform(-1e-6, 1e-6, (B, H))
    v[:, :, -1] = 0.0
    return src, torch.from_numpy(u).to(dev), torch.from_numpy(v).to(dev)


def k3_phase(torch, dev, seed=5) -> dict:
    import torch.nn.functional as F

    from opticalflowcontainer_tpu_torch.core.device import sm_count
    from opticalflowcontainer_tpu_torch.ops import warp_bilinear as k3
    from opticalflowcontainer_tpu_torch.ops.warp_bilinear import (
        warp_bilinear, warp_bilinear_plain)

    rng = np.random.default_rng(seed)
    tol = 1e-6
    worst = 0.0
    entry = None
    shapes = []
    for B, C, H, W in K3_SHAPES:
        src, u, v = k3_inputs(torch, rng, B, C, H, W, dev)
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
                      f"fp32 products and sums rounded in the plain version's "
                      f"order, so 0 is expected); gates equal: {gates}")
                require(gates and err <= tol * scale,
                        f"K3 {padding} mask {thr} agrees with its plain version")
        # one PyTorch call computing the same warp: grid_sample on the
        # align_corners=True grid that maps onto these pixel coordinates
        gx = 2 * (torch.arange(W, device=dev) + u) / (W - 1) - 1
        gy = 2 * (torch.arange(H, device=dev)[:, None] + v) / (H - 1) - 1
        grid = torch.stack([gx, gy], -1)
        lib_err = float((F.grid_sample(src, grid, mode="bilinear",
                                       padding_mode="zeros", align_corners=True)
                         - warp_bilinear(src, u, v)).abs().max())
        print(f"K3 vs F.grid_sample(align_corners=True): max|d| {lib_err:.3e} "
              f"(the normalized grid's rounding)")
        require(lib_err <= 1e-3 * scale, "grid_sample computes the same warp")
        def lib():
            return F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros",
                                 align_corners=True)

        # back to back with events (what a caller waits for, the wrappers'
        # host time included), then device time by graph replay; the kernel
        # and grid_sample in turns
        ms = cuda_ms(lambda: warp_bilinear(src, u, v), reps=20)
        lib_ms = cuda_ms(lib, reps=20)
        g_ms = graph_ms(lambda: warp_bilinear(src, u, v))
        lib_g_ms = graph_ms(lib)
        g_ms = min(g_ms, graph_ms(lambda: warp_bilinear(src, u, v)))
        lib_g_ms = min(lib_g_ms, graph_ms(lib))
        masked_g_ms = graph_ms(lambda: warp_bilinear(src, u, v, "zeros", 0.999))
        n_pix = B * H * W
        # src read once, u and v read, out written; 4 taps x 2 flops per value
        n_bytes = 4 * (2 * C * n_pix + 2 * n_pix)
        b_ms, by = bound_ms(n_bytes, 8 * C * n_pix)
        groups = k3.launch_config(B, C, H, W, sm_count(dev.index))["groups"]
        print(f"K3 [{B}, {C}, {H}, {W}] zeros ({groups} channel groups): events "
              f"{ms:.4f} ms per launch, grid_sample {lib_ms:.4f} ms; graph replay "
              f"(device time) {g_ms:.4f} ms (mask on {masked_g_ms:.4f} ms), "
              f"grid_sample {lib_g_ms:.4f} ms ({lib_g_ms / g_ms:.2f}x K3's time); "
              f"bound {b_ms:.4f} ms by {by} ({n_bytes / 1e6:.1f} MB): "
              f"{b_ms / ms:.1%} / {b_ms / g_ms:.1%} of it")
        shapes.append({"shape": [B, C, H, W], "groups": groups, "ms": ms,
                       "graph_ms": g_ms, "masked_graph_ms": masked_g_ms,
                       "library_ms": lib_ms, "library_graph_ms": lib_g_ms,
                       "bound_ms": b_ms, "bound_by": by})
        if entry is None:
            edge_g_ms = graph_ms(lambda: warp_bilinear(src, u, v, "edge"))
            plain_ms = cuda_ms(lambda: warp_bilinear_plain(src, u, v), reps=5)
            print(f"K3 [{B}, {C}, {H}, {W}]: edge {edge_g_ms:.4f} ms (graph "
                  f"replay), plain {plain_ms:.4f} ms (events)")
            entry = {"name": "warp_bilinear", "route": "cuda",
                     "source": "opticalflowcontainer_tpu_torch/ops/csrc/warp_bilinear.cu",
                     "replaces": "opticalflowcontainer_tpu/ops/blockwarp.py:519",
                     "ms": ms, "graph_ms": g_ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms,
                     "library_graph_ms": lib_g_ms}
        del src, u, v, grid, got, want
    entry["max_abs_err"] = worst
    entry["shapes"] = shapes
    return entry


def variants_phase(torch, dev, seed=10) -> dict:
    """The launch choices of K3, K2 and K4 measured apart: device ms (graph
    replay) of the chosen launch configuration beside the others the
    kernels take, at every shape phases 3 and 6 time and K4's shapes
    (``k4_variants``), in two passes (forward, then reversed order; the
    lesser time kept).  Each K3 and K2 variant's output must equal the
    chosen one's bit for bit."""
    import torch.nn.functional as F

    from opticalflowcontainer_tpu_torch.core.device import sm_count
    from opticalflowcontainer_tpu_torch.ops import solve2x2 as k2
    from opticalflowcontainer_tpu_torch.ops import warp_bilinear as k3

    rng = np.random.default_rng(seed)
    sms = sm_count(dev.index)
    out = {"k3": [], "k2": []}
    for B, C, H, W in K3_SHAPES:
        src, u, v = k3_inputs(torch, rng, B, C, H, W, dev)
        chosen = k3.launch_config(B, C, H, W, sms)
        # two blocks per SM where the pixels alone give fewer, as many
        # channels per group as that leaves
        pixel_blocks = B * -(-(H * W) // k3.THREADS)
        fill_only = min(C, max(1, -(-2 * sms // pixel_blocks)))
        variants = {
            "chosen": chosen,
            "1 channel group": dict(chosen, groups=1),
            "channel groups only to fill the card": dict(chosen, groups=fill_only),
            "64-bit offsets": dict(chosen, wide=True),
        }
        gx = 2 * (torch.arange(W, device=dev) + u) / (W - 1) - 1
        gy = 2 * (torch.arange(H, device=dev)[:, None] + v) / (H - 1) - 1
        grid = torch.stack([gx, gy], -1)
        runs = {}
        for thr in (None, 0.999):
            want = k3.launch(src, u, v, "zeros", thr, **chosen)
            for name, cfg in variants.items():
                got = k3.launch(src, u, v, "zeros", thr, **cfg)
                require(torch.equal(got, want), f"K3 variant {name} equals the chosen one")
                runs[(name, thr)] = lambda cfg=cfg, thr=thr: k3.launch(
                    src, u, v, "zeros", thr, **cfg)
        runs[("grid_sample", None)] = lambda: F.grid_sample(
            src, grid, mode="bilinear", padding_mode="zeros", align_corners=True)
        # the channel-group counts (the offsets as chosen)
        for g in (1, 2, 4, 8, 16, 32, 64, 128):
            if g <= C:
                cfg = dict(chosen, groups=g)
                runs[(f"groups {g}", None)] = (
                    lambda cfg=cfg: k3.launch(src, u, v, "zeros", None, **cfg))
        keys = list(runs)
        times = {k: graph_ms(runs[k]) for k in keys}
        for k in reversed(keys):
            times[k] = min(times[k], graph_ms(runs[k]))
        print(f"K3 variants [{B}, {C}, {H}, {W}], chosen {chosen}: device ms, "
              f"mask off / on")
        for name in variants:
            print(f"  {name:38s} {times[(name, None)]:.5f} / "
                  f"{times[(name, 0.999)]:.5f}")
        print(f"  {'grid_sample':38s} {times[('grid_sample', None)]:.5f}")
        grid_keys = [k for k in keys if k[0].startswith("groups ")]
        print("  channel groups, mask off: " + ", ".join(
            f"{k[0][7:]}: {times[k]:.5f}" for k in grid_keys))
        out["k3"].append({"shape": [B, C, H, W],
                          "ms": {f"{n} mask {'on' if t else 'off'}": ms
                                 for (n, t), ms in times.items()}})
        del src, u, v, grid
    for b, h, w, winsize in K2_SHAPES:
        M = normal_eq(torch, rng, b, h, w, dev)
        r = winsize // 2
        th, tw, _ = k2.choose_tile(r, k2._smem_limit(dev.index), b, h, w, sms)
        variants = {f"register-blocked, tile {t}": (True, t) for t in k2.REG_TILES}
        variants["generic, tile (32, 64)"] = (False, (32, 64))
        want = k2.launch(M, winsize, False, True, (th, tw))
        for name, (reg, tile) in variants.items():
            got = k2.launch(M, winsize, False, reg, tile)
            if reg:
                require(all(torch.equal(g, x) for g, x in zip(got, want)),
                        f"K2 variant {name} equals the chosen one")
        keys = list(variants)
        times = {k: graph_ms(lambda k=k: k2.launch(M, winsize, False, *variants[k]))
                 for k in keys}
        for k in reversed(keys):
            times[k] = min(times[k], graph_ms(
                lambda k=k: k2.launch(M, winsize, False, *variants[k])))
        print(f"K2 variants [{b}, 5, {h}, {w}] winsize {winsize} box, chosen "
              f"tile {(th, tw)}: device ms")
        for name in keys:
            print(f"  {name:34s} {times[name]:.5f}")
        out["k2"].append({"shape": [b, 5, h, w], "winsize": winsize, "ms": times})
        del M
    out["k4"] = k4_variants(torch, dev, rng, sms)
    return out


def k4_variant_configs(md, ds, os_, C, W, chosen) -> dict:
    """K4's launch choices beside the chosen one: channel splits halved,
    doubled and none; tile heights 2 and 8; tap rows per block one step
    more and fewer; one staged buffer (the cp.async pipeline off), of the
    chosen chunk or of the whole split, or two of 8 channels (on); 4-byte
    copies where the 16-byte ones apply.  Those the kernel cannot take
    (over 256 threads or 48 KB of shared memory) are left out."""
    from opticalflowcontainer_tpu_torch.ops import correlation as k4

    K = 2 * (md // ds) + 1
    options = sorted({-(-K // g) for g in range(1, K + 1)}, reverse=True)
    tw, th = chosen["tile"]
    taps, splits = chosen["taps"], chosen["splits"]

    def cfg(**kw):
        a = {"tile": (tw, th), "taps": taps, "splits": splits,
             "chunk": chosen["chunk"], "stages": chosen["stages"],
             "copy16": True} | kw
        a["chunk"] = min(a["chunk"], -(-C // a["splits"]))
        return k4.make_config(md, ds, os_, a["tile"], a["taps"], a["splits"],
                              a["chunk"], a["stages"], a["copy16"])

    i = options.index(taps)
    per = -(-C // splits)
    out = {"chosen": chosen,
           "channel splits x2": cfg(splits=min(C, 2 * splits)),
           "channel splits /2": cfg(splits=max(1, splits // 2)),
           "1 channel split": cfg(splits=1),
           "tile height 2": cfg(tile=(tw, 2)),
           "tile height 8": cfg(tile=(tw, 8)),
           "more tap rows a block": cfg(taps=options[max(0, i - 1)]),
           "fewer tap rows a block": cfg(taps=options[min(len(options) - 1, i + 1)]),
           "one buffer (no overlap)": cfg(stages=1),
           "one buffer, whole split": cfg(chunk=per, stages=1),
           "two buffers of 8": cfg(chunk=8, stages=2)}
    if os_ == 1 and W % 4 == 0:
        out["4-byte copies"] = cfg(copy16=False)
    keep = {}
    for name, c in out.items():
        if (c["smem"] <= k4.SMEM_LIMIT and c["threads"] <= k4.MAX_THREADS
                and c not in keep.values()):
            keep[name] = c
    return keep


def k4_variants(torch, dev, rng, sms) -> list:
    """K4's launch choices (``k4_variant_configs``) timed apart by graph
    replay at PWC-Net's five B=1 levels, its level 2 at B=8 and LiteFlowNet's
    (6,2,2) at B=8, two passes, the lesser time kept.  A variant with the
    chosen number of channel splits sums in the same order and must equal
    the chosen launch bit for bit; one with another number of splits must
    agree with the plain version at phase 7's tolerance.  TMA is not built
    (PERF.md: a tensor map needs 16-byte rows, and PWC-Net's level 6 has
    W = 10)."""
    from opticalflowcontainer_tpu_torch.ops import correlation as k4

    out = []
    shapes = [(4, 1, 1, *s) for s in PWC_LEVELS_B1]
    shapes += [(4, 1, 1, 8, 32, 128, 160), (6, 2, 2, 8, 64, 240, 320)]
    for md, ds, os_, B, C, H, W in shapes:
        f1, f2 = (torch.from_numpy(rng.standard_normal((B, C, H, W), np.float32))
                  .to(dev) for _ in range(2))
        chosen = k4.launch_config(B, C, H, W, md, ds, os_, sms)
        variants = k4_variant_configs(md, ds, os_, C, W, chosen)
        want = k4.launch(f1, f2, md, ds, os_, chosen)
        plain = k4.correlation_plain(f1, f2, md, ds, os_)
        scale = float(f1.abs().max() * f2.abs().max())
        for name, cfg in variants.items():
            got = k4.launch(f1, f2, md, ds, os_, cfg)
            if cfg["splits"] == chosen["splits"]:
                require(torch.equal(got, want),
                        f"K4 variant {name} equals the chosen one bit for bit")
            else:
                require(float((got - plain).abs().max()) <= 1e-6 * scale,
                        f"K4 variant {name} agrees with the plain version")
        keys = list(variants)
        times = {k: graph_ms(lambda k=k: k4.launch(f1, f2, md, ds, os_, variants[k]))
                 for k in keys}
        for k in reversed(keys):
            times[k] = min(times[k], graph_ms(
                lambda k=k: k4.launch(f1, f2, md, ds, os_, variants[k])))
        print(f"K4 variants {(md, ds, os_)} [{B}, {C}, {H}, {W}], chosen tile "
              f"{chosen['tile']}, {chosen['taps']} tap rows, {chosen['splits']} "
              f"splits, chunk {chosen['chunk']} x {chosen['stages']}: device ms")
        for k in keys:
            c = variants[k]
            print(f"  {k:26s} {times[k]:.5f}  (tile {c['tile']}, taps {c['taps']}, "
                  f"splits {c['splits']}, chunk {c['chunk']} x {c['stages']}, "
                  f"{c['threads']} threads)")
        out.append({"shape": [B, C, H, W], "config": [md, ds, os_],
                    "ms": times})
        del f1, f2, want, plain
    return out


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


# [B, C, H, W] of PWC-Net's five correlations at 640x480 (640x512 inside),
# levels 6 to 2, at B=1: the stream node's unit of work
PWC_LEVELS_B1 = ((1, 196, 8, 10), (1, 128, 16, 20), (1, 96, 32, 40),
                 (1, 64, 64, 80), (1, 32, 128, 160))

# (what, (max_disp, disp_stride, out_stride), [B, C, H, W]) of every
# correlation an estimate call makes at 640x480, B=1: PWC-Net's five,
# LiteFlowNet's five (level 2 after its 1x1 feat conv to 64 channels),
# LFN3's six (four cross, two self) and NeuFlowLite's one shape (at 1/8);
# and NeuFlow-v2's two at 768x432 (1/16 and 1/8)
CORR_B1 = (
    tuple((f"PWC-Net level {6 - i}", (4, 1, 1), s)
          for i, s in enumerate(PWC_LEVELS_B1))
    + (("LiteFlowNet level 6", (3, 1, 1), (1, 192, 15, 20)),
       ("LiteFlowNet level 5", (3, 1, 1), (1, 128, 30, 40)),
       ("LiteFlowNet level 4", (3, 1, 1), (1, 96, 60, 80)),
       ("LiteFlowNet level 3", (6, 2, 2), (1, 64, 120, 160)),
       ("LiteFlowNet level 2", (6, 2, 2), (1, 64, 240, 320)),
       ("LFN3 level 6", (4, 1, 1), (1, 192, 15, 20)),
       ("LFN3 level 5", (4, 1, 1), (1, 128, 30, 40)),
       ("LFN3 level 4", (4, 1, 1), (1, 96, 60, 80)),
       ("LFN3 level 3", (4, 1, 1), (1, 64, 120, 160)),
       ("LFN3 self level 4", (6, 2, 1), (1, 96, 60, 80)),
       ("LFN3 self level 3", (8, 2, 1), (1, 64, 120, 160)),
       ("NeuFlowLite level 3", (4, 1, 1), (1, 64, 60, 80)),
       ("NeuFlow-v2 level 4", (4, 1, 1), (1, 128, 27, 48)),
       ("NeuFlow-v2 level 3", (4, 1, 1), (1, 128, 54, 96))))


def k4_bytes_flops(C, H, W, B, K2, Ho, Wo, same=False) -> tuple[int, int]:
    """Bytes (f1 at the output stride and f2 read once, the volume written;
    a self-correlation, ``same``, reads its one input once) and flops of one
    correlation."""
    f1 = 0 if same else C * B * Ho * Wo
    return (4 * (f1 + C * B * H * W + K2 * B * Ho * Wo),
            2 * C * K2 * B * Ho * Wo)


def k4_phase(torch, dev, seed=6) -> dict:
    from opticalflowcontainer_tpu_torch.core.device import sm_count
    from opticalflowcontainer_tpu_torch.ops.correlation import (
        correlation_plain, launch_config, local_correlation)

    rng = np.random.default_rng(seed)
    tol = 1e-6
    worst = 0.0
    entry = None

    def check(f1, f2, md, ds, os_, what):
        """The wrapper's launch against the plain version, and a second
        launch bit for bit against the first."""
        nonlocal worst
        got = local_correlation(f1, f2, md, ds, os_)
        want = correlation_plain(f1, f2, md, ds, os_)
        again = local_correlation(f1, f2, md, ds, os_)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(f1.abs().max() * f2.abs().max())
        worst = max(worst, err)
        same = bool(torch.equal(got, again))
        B, C, H, W = f1.shape
        cfg = launch_config(B, C, H, W, md, ds, os_, sm_count(dev.index))
        print(f"K4 {what} {(md, ds, os_)} [{B}, {C}, {H}, {W}] -> "
              f"{tuple(got.shape)} (tile {cfg['tile']}, {cfg['taps']} tap rows, "
              f"{cfg['splits']} channel splits, chunk {cfg['chunk']} x "
              f"{cfg['stages']}): max|d| {err:.3e}, /max|f1|max|f2| "
              f"{err / scale:.3e} (tolerance {tol:.0e}: a mean of {C} fp32 "
              f"products in another order); second launch bit-equal: {same}")
        require(got.shape == want.shape and err <= tol * scale,
                f"K4 {what} [{B}, {C}, {H}, {W}] agrees with its plain version")
        require(same, f"K4 {what} [{B}, {C}, {H}, {W}]: two launches bit-equal")
        return got, cfg

    def times(f1, f2, md, ds, os_, got):
        B, C, H, W = f1.shape
        K2, Ho, Wo = got.shape[1:]
        ms = cuda_ms(lambda: local_correlation(f1, f2, md, ds, os_), reps=20)
        g_ms = graph_ms(lambda: local_correlation(f1, f2, md, ds, os_))
        n_bytes, n_flops = k4_bytes_flops(C, H, W, B, K2, Ho, Wo, f1 is f2)
        b_ms, by = bound_ms(n_bytes, n_flops)
        return ms, g_ms, b_ms, by, n_bytes

    for name, (md, ds, os_, C, H, W) in CORR_AT_640x480.items():
        for B in (1, 8):
            f1, f2 = (torch.from_numpy(rng.standard_normal((B, C, H, W), np.float32))
                      .to(dev) for _ in range(2))
            got, _ = check(f1, f2, md, ds, os_, name)
        ms, g_ms, b_ms, by, n_bytes = times(f1, f2, md, ds, os_, got)
        line = (f"K4 {name} B=8: {ms:.4f} ms per launch, events (graph replay "
                f"{g_ms:.4f} ms), bound {b_ms:.4f} ms by {by} ({n_bytes / 1e6:.1f} "
                f"MB): {b_ms / g_ms:.1%} of it by graph")
        if name == "pwc":
            plain_ms = cuda_ms(lambda: correlation_plain(f1, f2, md, ds, os_), reps=5)
            line += f", plain {plain_ms:.4f} ms; no single PyTorch call computes it"
            entry = {"name": "local_correlation", "route": "cuda",
                     "source": "opticalflowcontainer_tpu_torch/ops/csrc/correlation.cu",
                     "replaces": "opticalflowcontainer_tpu/ops/correlation_pallas.py:67",
                     "ms": ms, "graph_ms": g_ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": by, "library_ms": None}
        print(line)
        del f1, f2, got
    b1 = {}
    for what, (md, ds, os_), (B, C, H, W) in CORR_B1:
        f1, f2 = (torch.from_numpy(rng.standard_normal((B, C, H, W), np.float32))
                  .to(dev) for _ in range(2))
        # a self-correlation passes one tensor as f1 and f2
        if "self" in what:
            f2 = f1
        got, cfg = check(f1, f2, md, ds, os_, what)
        ms, g_ms, b_ms, by, n_bytes = times(f1, f2, md, ds, os_, got)
        print(f"K4 {what} {(md, ds, os_)} [{B}, {C}, {H}, {W}]: events {ms:.4f} ms "
              f"per launch, graph replay {g_ms:.4f} ms (device time); bound "
              f"{b_ms:.5f} ms by {by} ({n_bytes / 1e6:.3f} MB): {b_ms / g_ms:.1%} "
              f"of it by graph")
        net = what.split(" level")[0].split(" self")[0]
        b1.setdefault(net, []).append(
            {"what": what, "config": [md, ds, os_], "shape": [B, C, H, W],
             "ms": ms, "graph_ms": g_ms, "bound_ms": b_ms, "bound_by": by,
             "splits": cfg["splits"]})
        del f1, f2, got
    for net, levels in b1.items():
        total = {k: sum(x[k] for x in levels) for k in ("ms", "graph_ms", "bound_ms")}
        print(f"K4 {net}'s {len(levels)} B=1 correlations together: events "
              f"{total['ms']:.4f} ms, graph replay {total['graph_ms']:.4f} ms, "
              f"bound {total['bound_ms']:.5f} ms")
    entry["max_abs_err"] = worst
    entry["b1_correlations"] = b1
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


def seeded_liteflownet(torch, cls, seed: int, device):
    """LiteFlowNet or LiteFlowNet3 (``cls``) at full width, seeded: every
    convolution He-normal (std sqrt(2 / fan_in)) from a seeded
    torch.Generator with zero biases, as seeded_pwcnet; the bias-free 2x
    deconvolutions (upflow, upcorr, upconf) bilinear upsampling kernels;
    and each Regularization's scale_x / scale_y 1x1 convs all ones, so that
    the new flow is a normalized weighted average of its neighbourhood.
    Random deconvolutions and scale convs would scramble the flow at every
    one of the five (four) levels.  At 640x480 this gives flows of a few
    px to ~10 px (phases 9 and 10 print the range)."""
    g = torch.Generator().manual_seed(seed)
    model = cls()
    bilinear = torch.tensor([0.25, 0.75, 0.75, 0.25])
    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, torch.nn.ConvTranspose2d):
                m.weight.copy_((bilinear[:, None] * bilinear).expand_as(m.weight))
            elif isinstance(m, torch.nn.Conv2d):
                if name.rsplit(".", 1)[-1] in ("scale_x", "scale_y"):
                    m.weight.fill_(1.0)
                else:
                    m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                                   * (2.0 / m.weight[0].numel()) ** 0.5)
                m.bias.zero_()
    return model.to(device).eval()


@contextlib.contextmanager
def plain_kernels():
    """The model zoo's paths with K3 and K4 replaced by their plain versions
    (for comparing the kernels' path with the plain one on the card)."""
    from unittest import mock

    from opticalflowcontainer_tpu_torch.models import (
        liteflownet, liteflownet3, neuflow, neuflow_v2, pwcnet)
    from opticalflowcontainer_tpu_torch.ops import correlation as k4
    from opticalflowcontainer_tpu_torch.ops import warp_bilinear as k3

    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(k3, "warp_bilinear",
                                              k3.warp_bilinear_plain))
        for mod in (pwcnet, liteflownet, liteflownet3, neuflow, neuflow_v2):
            stack.enter_context(mock.patch.object(mod, "local_correlation",
                                                  k4.correlation_plain))
        yield


def net_phase(torch, dev, trace_dir, label, model, cpu_model, estimate,
              expect: dict, H=480, W=640) -> dict:
    """One model's estimate path at HxW on the card: K3 and K4 launches per
    call against ``expect``, the kernels' path against the plain path on the
    card and the card against the CPU (``cpu_model``, the same weights) at
    192x128, the served convolutions against fp32 ones, B=1 latency, B=8
    pairs/s and one call under the profiler.  Returns the launches."""
    from opticalflowcontainer_tpu_torch.ops.correlation import local_correlation
    from opticalflowcontainer_tpu_torch.ops.warp_bilinear import warp_bilinear

    n_params = sum(p.numel() for p in model.parameters())
    i1, i2 = image_pairs(torch, H, W, 1, dev)
    estimate(model, i1, i2)  # warm-up: library load, cuDNN heuristics
    torch.cuda.synchronize()
    warp_bilinear.launches = 0
    local_correlation.launches = 0
    flow = estimate(model, i1, i2)
    torch.cuda.synchronize()
    launches = {"warp_bilinear": warp_bilinear.launches,
                "local_correlation": local_correlation.launches}
    print(f"{label} ({n_params} parameters, seeded) one estimate call at "
          f"{W}x{H} launched {launches} (expected {expect['warp_bilinear']} and "
          f"{expect['local_correlation']})")
    require(launches == expect,
            f"each {label} estimate call runs {expect['warp_bilinear']} warps and "
            f"{expect['local_correlation']} correlations")
    require(tuple(flow.shape) == (1, H, W, 2), f"flow shape {tuple(flow.shape)}")
    require(bool(torch.isfinite(flow).all()), "flow is finite")
    print(f"flow |u|,|v| mean {flow.abs().mean((0, 1, 2)).tolist()}, max "
          f"{float(flow.abs().max()):.3f} px")

    latency = functools.partial(estimate_ms, torch, estimate, model)

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
        s1, s2 = image_pairs(torch, 128, 192, 1, "cpu")
        on_card = estimate(model, s1, s2).cpu()
        on_cpu = estimate(cpu_model, s1, s2)
        d = (on_card - on_cpu).abs()
        print(f"192x128 card vs CPU (plain versions, fp32): mean|d| "
              f"{float(d.mean()):.3e}, max|d| {float(d.max()):.3e} px (bars "
              f"{mean_bar} / {max_bar})")
        require(float(d.mean()) <= mean_bar and float(d.max()) <= max_bar,
                "card agrees with the CPU")
        fp32_ms = latency(i1, i2, 50)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    # the flow estimate serves: PyTorch's default convolutions (cuDNN TF32,
    # 10-bit mantissas) against fp32 ones on the same weights and pair.  Bar:
    # mean 1e-2 px, a hundredth of a pixel over the field, far below the
    # px-scale EPE of a flow network and the 0.05 px the Farneback clip
    # recovers a shift to; the max is printed, not bounded: a pixel whose
    # masked-warp weight sits at the 0.999 threshold flips its gate
    served = estimate(model, i1, i2)
    d = (served - kern).abs()
    tf32_bar = 1e-2
    print(f"{W}x{H} served convolutions (cuDNN TF32 {tf32}) vs fp32: mean|d| "
          f"{float(d.mean()):.3e}, p99 {float(d.flatten().kthvalue(int(0.99 * d.numel())).values):.3e}, "
          f"max|d| {float(d.max()):.3e} px (bar: mean {tf32_bar} px)")
    require(float(d.mean()) <= tf32_bar, "served TF32 flow within the bar of fp32")
    lat = latency(i1, i2, 50)
    print(f"{W}x{H} estimate at B=1, CUDA events over 50 calls: median "
          f"{np.median(lat):.3f} ms, p90 {np.percentile(lat, 90):.3f} ms "
          f"(PyTorch defaults, cuDNN TF32 {tf32}); with fp32 convolutions "
          f"median {np.median(fp32_ms):.3f} ms")
    b1, b2 = image_pairs(torch, H, W, 8, dev)
    torch.cuda.reset_peak_memory_stats()
    lat8 = latency(b1, b2, 10)
    print(f"{W}x{H} estimate at B=8: median {np.median(lat8):.3f} ms per call, "
          f"{8e3 / np.median(lat8):.2f} pairs/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del b1, b2
    profile_path(torch, f"one {label} estimate at B=1",
                 lambda: estimate(model, i1, i2), trace_dir,
                 label.lower().replace("-", ""))
    return launches


def pwc_phase(torch, dev, trace_dir, H=480, W=640, n=201, seed=7) -> dict:
    from opticalflowcontainer_tpu_torch.models.pwcnet import estimate
    from opticalflowcontainer_tpu_torch.ops.correlation import local_correlation
    from opticalflowcontainer_tpu_torch.ops.warp_bilinear import warp_bilinear
    from opticalflowcontainer_tpu_torch.runtime.nodes import make_model_backend
    from opticalflowcontainer_tpu_torch.runtime.velocity import VelocityEstimator

    model = seeded_pwcnet(torch, seed, dev)
    launches = net_phase(torch, dev, trace_dir, "PWC-Net", model,
                         seeded_pwcnet(torch, seed, "cpu"), estimate,
                         {"warp_bilinear": 4, "local_correlation": 5}, H, W)

    # the stream: uint8 BGR camera frames in host memory through the
    # learned-model backend into the velocity estimator
    frames = bgr_frames(torch, H, W, n, 1.5, seed=9, device=dev)
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


# K3 and K4 launches per estimate call, counted from the reference's code:
# LiteFlowNet warps feat2 in Matching at levels 5-2 (4), in Subpixel (5)
# and img2 in Regularization (5), and correlates at its five levels; LFN3
# warps 1+2+2 in Matching (the flow deformation at levels 4 and 3), 4 in
# Subpixel and 4 in Regularization, and correlates 4 cross + 2 self
LFN_LAUNCHES = {"warp_bilinear": 14, "local_correlation": 5}
LFN3_LAUNCHES = {"warp_bilinear": 13, "local_correlation": 6}


def lfn_phase(torch, dev, trace_dir, three: bool, seed=11) -> dict:
    """Phase 9 (LFN3, ``three``) or 10 (LiteFlowNet) at 640x480."""
    from opticalflowcontainer_tpu_torch.models import liteflownet, liteflownet3

    mod, cls, label, expect = (
        (liteflownet3, liteflownet3.LiteFlowNet3, "LFN3", LFN3_LAUNCHES) if three
        else (liteflownet, liteflownet.LiteFlowNet, "LiteFlowNet", LFN_LAUNCHES))
    return net_phase(torch, dev, trace_dir, label,
                     seeded_liteflownet(torch, cls, seed, dev),
                     seeded_liteflownet(torch, cls, seed, "cpu"), mod.estimate,
                     expect)


def model_stream_phase(torch, dev, trace_dir, H=480, W=640, n=201, dx=1.5,
                       seed=11) -> dict:
    """FusedModelStream over LFN3: one uint8 frame up and one scalar down a
    frame, against make_model_backend (the flow field to numpy) and
    VelocityEstimator on the same frames."""
    from opticalflowcontainer_tpu_torch.models.liteflownet3 import LiteFlowNet3, estimate
    from opticalflowcontainer_tpu_torch.ops.correlation import local_correlation
    from opticalflowcontainer_tpu_torch.ops.warp_bilinear import warp_bilinear
    from opticalflowcontainer_tpu_torch.runtime.fused import FusedModelStream
    from opticalflowcontainer_tpu_torch.runtime.nodes import make_model_backend
    from opticalflowcontainer_tpu_torch.runtime.velocity import VelocityEstimator

    model = seeded_liteflownet(torch, LiteFlowNet3, seed, dev)
    frames = bgr_frames(torch, H, W, n, dx, seed=12, device=dev)
    s = FusedModelStream(model, estimate, device=dev)
    s.warmup(frames[0])
    warp_bilinear.launches = 0
    local_correlation.launches = 0
    require(s.step(frames[0]) is None, "first frame seeds the state")
    dus, lat = [], []
    for f in frames[1:]:
        t0 = time.perf_counter()
        du = float(s.step(f))  # syncs
        lat.append((time.perf_counter() - t0) * 1e3)
        dus.append(du)
    launches = {"warp_bilinear": warp_bilinear.launches,
                "local_correlation": local_correlation.launches}
    want = {k: v * (n - 1) for k, v in LFN3_LAUNCHES.items()}
    lat = np.array(lat)
    print(f"{W}x{H} LFN3 FusedModelStream, {n - 1} uint8 BGR frames (host clock, "
          f"numpy frame to synced du): p50 {np.percentile(lat, 50):.3f} ms, p99 "
          f"{np.percentile(lat, 99):.3f} ms, mean {lat.mean():.3f} ms, min "
          f"{lat.min():.3f} ms, max {lat.max():.3f} ms; du {min(dus):.4f} .. "
          f"{max(dus):.4f} px; launches {launches} (expected {want})")
    require(launches == want, "the stream ran both kernels on every frame")
    require(all(np.isfinite(dus)), "the stream's du is finite")

    # the same frames through the flow-node backend that brings the flow
    # field back to numpy, into VelocityEstimator (1 m per px, no
    # smoothing, so its vx * dt is the mean u)
    backend = make_model_backend(functools.partial(estimate, model), device=dev)
    vel = VelocityEstimator(pixel_to_meter=1.0, smooth_window=1)
    dt = 1 / 30
    backend(frames[0], frames[1], dt)  # warm-up
    ref, ref_lat = [], []
    for prev, cur in zip(frames[:-1], frames[1:]):
        t0 = time.perf_counter()
        vx, _, _ = vel.update(backend(prev, cur, dt), dt)
        ref_lat.append((time.perf_counter() - t0) * 1e3)
        ref.append(vx * dt)
    d = np.abs(np.array(dus) - np.array(ref))
    bar = 1e-3
    print(f"du vs make_model_backend + VelocityEstimator on the same frames: "
          f"max|d| {d.max():.3e}, mean|d| {d.mean():.3e} px (bar {bar} px: the "
          f"same estimate on the same card; the stream scales frames by the "
          f"fp32 reciprocal of 255 and takes the mean of u on the card, the "
          f"backend divides by 255 and numpy takes the mean); that path p50 "
          f"{np.percentile(ref_lat, 50):.3f} ms, p99 "
          f"{np.percentile(ref_lat, 99):.3f} ms per frame")
    require(d.max() <= bar, "the fused stream's du agrees with the flow-node path")

    k = 8
    s1 = FusedModelStream(model, estimate, device=dev)
    s1.step(frames[0])
    one_by_one = torch.stack([s1.step(f) for f in frames[1:k + 1]])
    s2 = FusedModelStream(model, estimate, device=dev)
    s2.step(frames[0])
    chunk = s2.step_many(frames[1:k + 1])
    require(torch.equal(chunk, one_by_one), "step_many == step bit for bit")

    def ten_steps():
        for f in frames[k + 1:k + 11]:
            float(s1.step(f))

    # the profiler can miss the window's first upload (the Farneback
    # stream's ten steps counted 9 in one run, 10 in another), so uploads
    # are held to at most one a step
    prof = profile_path(torch, "ten LFN3 stream steps", ten_steps, trace_dir,
                        "lfn3_stream")
    require(prof is not None and prof["d2h"] == 10 and prof["h2d"] <= 10,
            "one scalar download and at most one frame upload per step")
    return launches


def kernel_counts() -> dict:
    """The four wrappers' launch counts (read after a path's run)."""
    from opticalflowcontainer_tpu_torch.ops.correlation import local_correlation
    from opticalflowcontainer_tpu_torch.ops.farneback_update import farneback_update
    from opticalflowcontainer_tpu_torch.ops.solve2x2 import blur_solve
    from opticalflowcontainer_tpu_torch.ops.warp_bilinear import warp_bilinear

    return {f.__name__: f.launches for f in (farneback_update, blur_solve,
                                             warp_bilinear, local_correlation)}


def reset_counts() -> None:
    from opticalflowcontainer_tpu_torch.ops.correlation import local_correlation
    from opticalflowcontainer_tpu_torch.ops.farneback_update import farneback_update
    from opticalflowcontainer_tpu_torch.ops.solve2x2 import blur_solve
    from opticalflowcontainer_tpu_torch.ops.warp_bilinear import warp_bilinear

    for f in (farneback_update, blur_solve, warp_bilinear, local_correlation):
        f.launches = 0


def node_phase(torch, dev, H=480, W=640, n=90, fps=30.0) -> dict:
    """The node graph at 640x480: the demo (synthetic camera -> FlowNode in
    stream mode -> velocity topics), plain and fused, each required to
    return 0 with every frame processed or dropped and none failed, and
    its kernel launches equal to the frames it processed; then
    bringup_flow in topic mode, where depth and camera_info set the scale
    the velocities follow."""
    import io

    from opticalflowcontainer_tpu_torch.classical import farneback as fb
    from opticalflowcontainer_tpu_torch.runtime import demo, launch
    from opticalflowcontainer_tpu_torch.runtime.messages import (
        CameraInfoMsg, Header, ImageMsg)
    from opticalflowcontainer_tpu_torch.runtime.sources import SyntheticCamera

    per_frame = (fb._num_levels(H, W, 2, 0.5) + 1) * 2  # levels 2, 2 iterations
    by_path = {}
    for fused in (False, True):
        label = "node_fused_farneback" if fused else "node_farneback"
        argv = ["--frames", str(n), "--width", str(W), "--height", str(H),
                "--fps", str(fps)] + (["--fused"] if fused else [])
        out = io.StringIO()
        reset_counts()
        with contextlib.redirect_stdout(out):  # one line a frame: keep the tail
            r = demo.run(argv)
        counts = kernel_counts()
        for line in out.getvalue().strip().splitlines()[-2:]:
            print(f"demo {' '.join(argv)}: {line}")
        print(f"  {label}: processed {r['frames_processed']}, dropped "
              f"{r['frames_dropped']}, failed {r['frames_failed']} of {n} frames, "
              f"{r['published']} smoothed velocities, "
              f"{r['frames_processed'] / r['seconds']:.2f} fps achieved in "
              f"{r['seconds']:.3f} s, final smoothed velocity "
              f"{r['final_vx']} m/s, error {r['error_mps']} m/s; launches {counts}")
        require(r["exit_code"] == 0, f"the demo ({label}) returns 0")
        require(r["ended"] and r["frames_failed"] == 0, "no frame failed, threads ended")
        require(r["published"] == r["frames_processed"] > 0
                and r["frames_processed"] + r["frames_dropped"] == n - 1,
                "one velocity per processed frame; every frame processed or dropped")
        # one warm-up flow, then one flow per processed frame
        want = per_frame * (r["frames_processed"] + 1)
        require(counts["farneback_update"] == counts["blur_solve"] == want,
                f"K1 and K2 launched {want} times ({per_frame} a flow)")
        by_path[label] = counts

    # where a frame's time goes: ten frames through each demo backend
    from opticalflowcontainer_tpu_torch.runtime.fused import make_fused_farneback_backend
    from opticalflowcontainer_tpu_torch.runtime.nodes import (
        _bgr_to_gray_np, make_farneback_backend)

    cam = SyntheticCamera(width=W, height=H, fps=fps, n_frames=12)
    bgr = [cam.frame_at(i) for i in range(12)]
    gray = [_bgr_to_gray_np(f) for f in bgr]
    plain = make_farneback_backend(device=dev, levels=2, winsize=13, iterations=2)
    fused_b = make_fused_farneback_backend(device=dev, levels=2, winsize=13, iterations=2)
    plain(gray[0], gray[1], 1 / fps)
    fused_b(bgr[0], bgr[1], 1 / fps)
    profile_path(torch, "ten demo frames, Farneback backend (flow to numpy)",
                 lambda: [plain(a, b, 1 / fps) for a, b in zip(gray[1:], gray[2:])],
                 None, "node_plain")
    profile_path(torch, "ten demo frames, fused Farneback backend (du to the host)",
                 lambda: [fused_b(a, b, 1 / fps) for a, b in zip(bgr[1:], bgr[2:])],
                 None, "node_fused")

    # topic mode: depth and fx set pixel_to_meter, the velocity follows
    bus, node, depth = launch.bringup_flow(device=dev)
    cam = SyntheticCamera(width=W, height=H, fps=fps, n_frames=6, velocity_mps=0.05,
                          pixel_to_meter=0.000857)
    vels, mean_u = [], []
    bus.subscribe("/optical_flow/FLOW_velocity", lambda m: vels.append(m.x))
    bus.subscribe("/optical_flow/FLOW_flow",
                  lambda m: mean_u.append(float(m.flow[..., 0].mean())))
    node.backend(cam.frame_at(0)[..., 0].astype(np.float32),
                 cam.frame_at(1)[..., 0].astype(np.float32), 1 / fps)  # warm-up
    reset_counts()
    try:
        bus.publish("/camera/color/camera_info", CameraInfoMsg(Header(0.0), fx=600.0))
        for i, mm in enumerate((1500, 1500, 3000, 3000, 3000)):
            bus.publish("/camera/aligned_depth_to_color/image_raw",
                        ImageMsg(Header(i / fps), np.full((H, W), mm, np.uint16),
                                 "16UC1"))
            require(abs(node.vel.pixel_to_meter - mm * 1e-3 / 600.0) < 1e-12,
                    "pixel_to_meter = median depth / fx")
            bus.publish("/camera/color/image_raw",
                        ImageMsg(Header(i / fps), cam.frame_at(i)))
    finally:
        node.stop()
    counts = kernel_counts()
    want = [cam.px_per_frame * fps * mm * 1e-3 / 600.0 for mm in (1500, 3000, 3000, 3000)]
    print(f"bringup_flow topic mode at {W}x{H}: velocities {[round(v, 5) for v in vels]} "
          f"m/s for depth 1.5 m then 3 m at fx 600 (expected "
          f"{[round(v, 5) for v in want]}); frames failed {node.frames_failed}; "
          f"launches {counts}")
    require(len(vels) == len(mean_u) == 4 and node.frames_failed == 0,
            "one velocity a frame after the first")
    # exactly the published flow's mean u over dt at depth / fx, and near
    # the camera's ground truth
    scale = [mm * 1e-3 / 600.0 for mm in (1500, 3000, 3000, 3000)]
    require(all(abs(v - u * fps * p) <= 1e-6 * abs(v)
                for v, u, p in zip(vels, mean_u, scale)),
            "the velocity is the flow's mean u at the depth-driven scale")
    require(all(abs(v - w) < 0.1 * w for v, w in zip(vels, want)),
            "the velocity is near the camera's ground truth")
    require(counts["farneback_update"] == counts["blur_solve"] == 4 * per_frame,
            "K1 and K2 ran on every frame")
    by_path["bringup_flow_topic"] = counts
    return by_path


def batcher_phase(torch, dev, trace_dir, H=1080, W=1920, fps=60.0, seconds=6.0,
                  dx=1.5, n_cycle=32) -> dict:
    """MultiStreamFlow over the stateful batched fused Farneback backend
    (bench.py's levels 3, winsize 15, 3 iterations) on two 1080p streams:
    first the backend's du against one FusedFarnebackStream per stream on a
    deterministic sequence with a late join and a dropped-pair reseed;
    then both streams pushed at 60 fps for ``seconds`` with
    pipeline_depth=1: fields/s, batches, dropped pairs, velocities per
    stream, and the device time of a batch."""
    from opticalflowcontainer_tpu_torch.classical import farneback as fb
    from opticalflowcontainer_tpu_torch.runtime.bus import Bus
    from opticalflowcontainer_tpu_torch.runtime.fused import FusedFarnebackStream
    from opticalflowcontainer_tpu_torch.runtime.multistream import (
        MultiStreamFlow, make_stateful_batched_fused_farneback)

    kw = dict(levels=3, winsize=15, iterations=3)
    per_batch = (fb._num_levels(H, W, 3, 0.5) + 1) * 3
    # gray frames as a decoder's luma plane hands them on: stream s moves
    # (s + 1) * dx px a frame, n_cycle frames pushed in a cycle
    frames = [plane_waves(torch, H, W, [((s + 1) * dx * t, 0.0) for t in range(n_cycle)],
                          seed=20 + s, device=dev).cpu().numpy() for s in range(2)]
    backend = make_stateful_batched_fused_farneback(2, device=dev, **kw)
    refs = [FusedFarnebackStream(device=dev, **kw) for _ in range(2)]
    worst = 0.0
    for idxs, t, dropped in (([0], 1, None), ([0, 1], 2, None), ([0], 3, None),
                             ([0, 1], 4, [False, True]), ([0, 1], 5, None)):
        prev = np.stack([frames[i][t - 1] for i in idxs])
        cur = np.stack([frames[i][t] for i in idxs])
        got = backend(prev, cur, idxs, dropped).cpu()
        want = []
        for k, i in enumerate(idxs):
            if refs[i]._state is None or (dropped and dropped[k]):
                refs[i].reset()
                refs[i].step(frames[i][t - 1])
            want.append(float(refs[i].step(frames[i][t])))
        d = float((got - torch.tensor(want)).abs().max())
        worst = max(worst, d)
        require(all(abs(g - (i + 1) * dx) < 0.1 for g, i in zip(got.tolist(), idxs)),
                f"batch du {got.tolist()} near the shifts")
    tol = 1e-4
    print(f"2x{W}x{H} stateful batcher vs one FusedFarnebackStream per stream "
          f"(late join, partial batches, a dropped-pair reseed): max|du d| "
          f"{worst:.3e} px (tolerance {tol:.0e} px)")
    require(worst <= tol, "the batcher's du matches per-stream streams")

    bus = Bus(namespace="")
    backend = make_stateful_batched_fused_farneback(2, device=dev, **kw)
    pair = np.stack([frames[0][0], frames[1][0]]), np.stack([frames[0][1], frames[1][1]])
    backend(*pair, [0, 1])  # warm-up: the allocator, the state
    reseeded = []

    def counting(prev, cur, idxs, dropped=None):
        reseeded.append(sum(dropped or ()))
        return backend(prev, cur, idxs, dropped)

    counting.stateful = counting.returns_displacement = True
    ms = MultiStreamFlow(bus, counting, n_streams=2, pixel_to_meter=1.0,
                         pipeline_depth=1)
    got = {0: [], 1: []}
    for i in range(2):
        bus.subscribe(f"/optical_flow/STREAM{i}_velocity",
                      lambda m, i=i: got[i].append(m.x))
    n_push = int(seconds * fps)
    push_ms = []
    reset_counts()
    ms.start()
    t0 = time.perf_counter()
    try:
        for k in range(n_push):
            delay = t0 + k / fps - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            t_push = time.perf_counter()
            for s in range(2):
                ms.push_frame(s, frames[s][k % n_cycle], stamp=time.monotonic())
            push_ms.append((time.perf_counter() - t_push) * 1e3)
    finally:
        ended = ms.stop(timeout=30.0)
    elapsed = time.perf_counter() - t0
    counts = kernel_counts()
    print(f"2x{W}x{H} at {fps:g} fps for {elapsed:.3f} s: {ms.fields} fields in "
          f"{ms.batches} batches ({ms.fields / elapsed:.2f} fields/s of "
          f"{2 * fps:g} pushed, {ms.fields / max(ms.batches, 1):.3f} fields a batch), "
          f"{ms.pairs_dropped} pairs dropped of {2 * (n_push - 1)}, {sum(reseeded)} "
          f"rows reseeded after a drop; velocities per "
          f"stream {len(got[0])}, {len(got[1])}; pushing two frames took p50 "
          f"{np.percentile(push_ms, 50):.3f} ms; launches {counts}")
    require(ended, "the batcher thread ended")
    require(all(len(v) >= seconds for v in got.values()),
            "at least one velocity per stream per second")
    require(ms.fields == len(got[0]) + len(got[1]), "every field published")
    require(counts["farneback_update"] == counts["blur_solve"] == per_batch * ms.batches,
            f"K1 and K2 launched {per_batch} times a batch")

    ms_batch = cuda_ms(lambda: backend(*pair, [0, 1]), reps=10)
    ms_reseed = cuda_ms(lambda: backend(*pair, [0, 1], [True, True]), reps=10)
    print(f"2x{W}x{H} one batch (upload, flow, du on the card), CUDA events over 10 "
          f"back-to-back batches: {ms_batch:.3f} ms ({2e3 / ms_batch:.2f} fields/s "
          f"unpaced); with both rows reseeded after a drop {ms_reseed:.3f} ms "
          f"({2e3 / ms_reseed:.2f} fields/s)")
    profile_path(torch, "one 2x1080p batch", lambda: backend(*pair, [0, 1]),
                 trace_dir, "batcher")
    profile_path(torch, "one 2x1080p batch, both rows reseeded",
                 lambda: backend(*pair, [0, 1], [True, True]), None, "batcher_reseed")
    return {"batcher_2x1080p": counts}


def junction_phase(torch, dev, trace_dir, H=480, W=640, n=100, dx=1.5,
                   fps=30.0, seed=11) -> dict:
    """The junction-masked LFN3 node at 640x480 on seeded weights, topic
    mode: ``n`` image + junction PointCloud pairs (a grid of junctions
    moving with the texture, boxes at the border clipped), one velocity per
    synced pair, and du equal to FusedModelStream.step(frame, junction_mask)
    on the same frames."""
    from opticalflowcontainer_tpu_torch.models.liteflownet3 import LiteFlowNet3, estimate
    from opticalflowcontainer_tpu_torch.runtime.bus import Bus
    from opticalflowcontainer_tpu_torch.runtime.fused import (
        FusedModelStream, make_fused_model_backend)
    from opticalflowcontainer_tpu_torch.runtime.messages import (
        Header, ImageMsg, PointCloudMsg)
    from opticalflowcontainer_tpu_torch.runtime.nodes import (
        JunctionMaskFlowNode, NodeParams)
    from opticalflowcontainer_tpu_torch.runtime.velocity import junction_mask

    model = seeded_liteflownet(torch, LiteFlowNet3, seed, dev)
    frames = bgr_frames(torch, H, W, n, dx, seed=13, device=dev)
    gx, gy = np.meshgrid(np.arange(4.0, W, 48.0), np.arange(2.0, H, 48.0))
    grid = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)
    points = [grid + np.float32([dx * t, 0.0]) for t in range(n)]
    stamps = [t / fps for t in range(n)]
    backend = make_fused_model_backend(model, estimate, aggregate="median", device=dev)
    backend.stream.warmup(frames[0], junction_mask((H, W), points[0]))
    backend.stream.reset()
    bus = Bus(namespace="")
    node = JunctionMaskFlowNode(backend, NodeParams(
        width=W, height=H, name="JUNCTION", aggregate="median", pixel_to_meter=1.0,
        smooth_window=1), bus).attach()
    vels, lat = [], []
    bus.subscribe("/optical_flow/JUNCTION_velocity", lambda m: vels.append(m.x))
    reset_counts()
    try:
        for t in range(n):
            bus.publish("/camera/color/image_raw", ImageMsg(Header(stamps[t]), frames[t]))
            t0 = time.perf_counter()
            bus.publish("/junction_detector/junctions",
                        PointCloudMsg(Header(stamps[t]), points[t]))
            lat.append((time.perf_counter() - t0) * 1e3)
    finally:
        node.stop()
    counts = kernel_counts()
    lat = np.array(lat[1:])
    print(f"{W}x{H} LFN3 JunctionMaskFlowNode, {n} image + junction pairs "
          f"({len(grid)} junctions, box 11): {len(vels)} velocities, "
          f"{node.frames_failed} failed; per synced pair (host clock, junctions "
          f"published to velocity published) p50 {np.percentile(lat, 50):.3f} ms, "
          f"p99 {np.percentile(lat, 99):.3f} ms; launches {counts}")
    require(len(vels) == n - 1 and node.frames_failed == 0, "one velocity per synced pair")
    require(counts["warp_bilinear"] == LFN3_LAUNCHES["warp_bilinear"] * (n - 1)
            and counts["local_correlation"] == LFN3_LAUNCHES["local_correlation"] * (n - 1),
            "K3 and K4 ran on every pair")
    ref = FusedModelStream(model, estimate, aggregate="median", device=dev)
    ref.step(frames[0])
    want = [float(ref.step(frames[t], junction_mask((H, W), points[t])))
            for t in range(1, n)]
    # the node published vx = du / dt with 1 m per px, dt from the stamps
    du = [v * (stamps[t] - stamps[t - 1]) for t, v in zip(range(1, n), vels)]
    d = np.abs(np.subtract(du, want))
    print(f"node du vs FusedModelStream.step(frame, junction_mask) on the same "
          f"frames: max|d| {d.max():.3e} px (bar 1e-6 px); du {min(du):.4f} .. "
          f"{max(du):.4f} px")
    require(d.max() <= 1e-6, "the node's du equals the stream's with the same mask")

    bus2 = Bus(namespace="")
    node2 = JunctionMaskFlowNode(backend, node.p, bus2).attach()

    def ten_pairs():
        for t in range(11):  # the first primes the node
            bus2.publish("/camera/color/image_raw", ImageMsg(Header(stamps[t]), frames[t]))
            bus2.publish("/junction_detector/junctions",
                         PointCloudMsg(Header(stamps[t]), points[t]))

    try:
        profile_path(torch, "ten junction-node pairs", ten_pairs, trace_dir, "junction")
    finally:
        node2.stop()
    return {"junction_lfn3": counts}


def latency_phase(torch, dev, H=480, W=640, n=401, fps=30.0, seed=11) -> None:
    """measure_stream_latency at 640x480, 400 frames paced at 30 fps, for
    the Farneback stream (cv2's defaults, as phase 5) and for a
    FusedModelStream over LFN3 (as phase 11); and measure_device_stream_ms."""
    from opticalflowcontainer_tpu_torch.models.liteflownet3 import LiteFlowNet3, estimate
    from opticalflowcontainer_tpu_torch.runtime.fused import (
        FusedModelStream, measure_device_stream_ms, measure_stream_latency)

    model = seeded_liteflownet(torch, LiteFlowNet3, seed, dev)
    for label, stream in (("Farneback", None),
                          ("LFN3", FusedModelStream(model, estimate, device=dev))):
        r = measure_stream_latency(H, W, fps=fps, n_frames=n, stream=stream, device=dev)
        print(f"measure_stream_latency {label} {W}x{H}, {r['n_measured']} frames at "
              f"{fps:g} fps: p50 {r['p50_ms']:.3f} ms, p99 {r['p99_ms']:.3f} ms, "
              f"mean {r['mean_ms']:.3f} ms, sustained {r['sustained_fps']:.2f} fps, "
              f"held {r['held_rate']} (device {r['device']})")
        require(r["n_measured"] == n - 1 and np.isfinite(r["p99_ms"]),
                "every frame measured")
    d_ms = measure_device_stream_ms(H, W, n_steps=30, device=dev)
    print(f"measure_device_stream_ms Farneback {W}x{H}: {d_ms:.3f} ms a frame "
          f"(30 chained steps between CUDA events, host dispatch gaps included)")


def assert_no_kernel_launches(what: str) -> None:
    """The paths of phases 16-18 reach none of K1-K4 (the reference's LK and
    RAFT reach no Pallas kernel): a stray route through one shows here."""
    counts = kernel_counts()
    print(f"  {what}: launches of K1-K4 {counts} (expected none)")
    require(not any(counts.values()), f"{what} launches none of K1-K4")


def lk_phase(torch, dev, trace_dir, H=480, W=640, shift=(1.37, -0.62), n=90,
             fps=30.0, velocity=0.05, seed=14) -> None:
    """Phase 16: Lucas-Kanade at 640x480 with cv2's defaults (win 21,
    max_level 3, 30 iterations, eps 0.01): up to 500 corners of
    good_features_to_track tracked on a pair with a known subpixel shift
    (interior error, card vs CPU, ms per call, device operations), then
    LKVelocityNode on the SyntheticCamera at 30 fps for ``n`` frames."""
    from opticalflowcontainer_tpu_torch.classical.lucas_kanade import (
        calc_optical_flow_pyr_lk)
    from opticalflowcontainer_tpu_torch.core.corners import good_features_to_track
    from opticalflowcontainer_tpu_torch.runtime.bus import Bus
    from opticalflowcontainer_tpu_torch.runtime.messages import Header, ImageMsg
    from opticalflowcontainer_tpu_torch.runtime.nodes import LKVelocityNode, NodeParams
    from opticalflowcontainer_tpu_torch.runtime.sources import SyntheticCamera

    # waves of 12-48 px: the default 6-24 px alias at the coarsest of LK's
    # four levels (8x reduced), and cv2 fails there as the port does
    g = plane_waves(torch, H, W, [(0.0, 0.0), shift], seed=seed, device=dev,
                    wavelengths=(12, 48))
    f1, f2 = g.clamp(0, 255).round().to(torch.uint8)
    good_features_to_track(f1, 500, 0.01, 8, device=dev)  # warm-up
    reset_counts()
    pts = good_features_to_track(f1, 500, 0.01, 8, device=dev)
    calc_optical_flow_pyr_lk(f1, f2, pts, device=dev)  # warm-up
    torch.cuda.synchronize()
    res = calc_optical_flow_pyr_lk(f1, f2, pts, device=dev)
    tracked, status = res.pts.cpu().numpy(), res.status.cpu().numpy()
    assert_no_kernel_launches("good_features_to_track + calc_optical_flow_pyr_lk")
    r = 21 // 2 + 2
    inner = ((pts[:, 0] >= r) & (pts[:, 0] < W - r) & (pts[:, 1] >= r)
             & (pts[:, 1] < H - r))
    ok = inner & (status == 1)
    err = np.linalg.norm(tracked[ok] - (pts[ok] + np.float32(shift)), axis=-1)
    print(f"{W}x{H} LK: {len(pts)} corners, {inner.sum()} interior, {ok.sum()} of "
          f"them tracked; error against the shift {shift}: mean {err.mean():.4f}, "
          f"p99 {np.percentile(err, 99):.4f}, max {err.max():.4f} px (bars: >= 95% "
          f"tracked, mean < 0.05 px, cv2's parity bar)")
    require(len(pts) >= 100, "at least 100 corners found")
    require(ok.sum() >= 0.95 * inner.sum() and err.mean() < 0.05,
            "LK recovers the known shift at the interior corners")
    on_cpu = calc_optical_flow_pyr_lk(f1.cpu(), f2.cpu(), pts, device="cpu")
    st_cpu = on_cpu.status.numpy()
    both = (status == 1) & (st_cpu == 1)
    d = np.linalg.norm(tracked[both] - on_cpu.pts.numpy()[both], axis=-1)
    agree = float((status == st_cpu).mean())
    print(f"{W}x{H} LK card vs CPU: status agreement {agree:.4f} (bar 0.99), "
          f"distance among points both track mean {d.mean():.3e}, max {d.max():.3e} px "
          f"(bars 1e-3 / 1e-2: fp32 sums in another order over 30 steps a level)")
    require(agree >= 0.99 and d.mean() <= 1e-3 and d.max() <= 1e-2,
            "the card's LK agrees with the CPU's")

    def lk():
        calc_optical_flow_pyr_lk(f1, f2, pts, device=dev)

    lk_ms = [cuda_ms(lk, reps=1, warmup=0) for _ in range(20)]
    gf_ms = [cuda_ms(lambda: good_features_to_track(f1, 500, 0.01, 8, device=dev),
                     reps=1, warmup=0) for _ in range(10)]
    print(f"{W}x{H} calc_optical_flow_pyr_lk, {len(pts)} points, CUDA events over 20 "
          f"calls: median {np.median(lk_ms):.3f} ms, min {np.min(lk_ms):.3f} ms; "
          f"good_features_to_track (500 corners, greedy pass on the host): median "
          f"{np.median(gf_ms):.3f} ms")
    profile_path(torch, "one calc_optical_flow_pyr_lk call", lk, trace_dir, "lk")

    # the node: the synthetic camera at 30 fps on its own thread, the node's
    # callback in that thread (direct delivery), frames stamped on capture
    bus = Bus(namespace="")
    p2m = 0.000857
    cam = SyntheticCamera(bus, width=W, height=H, fps=fps, n_frames=n,
                          velocity_mps=velocity, pixel_to_meter=p2m)
    t_in, t_out, smooth = {}, {}, []
    bus.subscribe("/camera/color/image_raw",
                  lambda m: t_in.setdefault(m.header.stamp, time.perf_counter()))
    node = LKVelocityNode(bus, NodeParams(name="LK", aggregate="median",
                                          pixel_to_meter=p2m), device=dev)
    bus.subscribe("/optical_flow/LK_velocity",
                  lambda m: t_out.setdefault(m.header.stamp, time.perf_counter()))
    bus.subscribe("/optical_flow/LK_smooth_velocity", lambda m: smooth.append(m.x))
    # warm the node's shapes (200 padded points) outside the run
    warm = Bus(namespace="")
    wnode = LKVelocityNode(warm, node.p, device=dev)
    for i in range(2):
        warm.publish("/camera/color/image_raw", ImageMsg(Header(i / fps), cam.frame_at(i)))
    wnode.stop()
    reset_counts()
    t0 = time.perf_counter()
    try:
        cam.start()
        cam._thread.join(timeout=120)
        require(not cam._thread.is_alive(), "the camera's thread ended")
    finally:
        cam.stop()
        node.stop()
    wall = time.perf_counter() - t0
    assert_no_kernel_launches("LKVelocityNode")
    lat = np.array([(t_out[k] - t_in[k]) * 1e3 for k in t_out])
    err = abs(smooth[-1] - velocity) if smooth else float("inf")
    print(f"{W}x{H} LKVelocityNode, SyntheticCamera {n} frames at {fps:g} fps: "
          f"processed {node.frames_processed}, failed {node.frames_failed}, "
          f"{len(smooth)} smoothed velocities in {wall:.3f} s; per frame (host clock, "
          f"image published to velocity published) p50 {np.percentile(lat, 50):.3f} "
          f"ms, p99 {np.percentile(lat, 99):.3f} ms; final smoothed velocity "
          f"{smooth[-1] if smooth else None} m/s vs {velocity} m/s: error "
          f"{err * 1e3:.3f} mm/s (bar 10 mm/s)")
    require(node.frames_failed == 0 and node.frames_processed == n - 1,
            "every frame after the first processed, none failed")
    require(err < 0.01, "the node's velocity within 10 mm/s of the ground truth")


def seeded_raft(torch, cls, seed: int, device):
    """RAFT-small or RAFT (``cls``) at the packaged architecture's full
    width, every convolution He-normal (std sqrt(2 / fan_in)) from a seeded
    torch.Generator with zero biases, as seeded_pwcnet."""
    g = torch.Generator().manual_seed(seed)
    model = cls()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                               * (2.0 / m.weight[0].numel()) ** 0.5)
                m.bias.zero_()
    return model.to(device).eval()


@contextlib.contextmanager
def profiler_ranges(torch, patches):
    """Each (object, attribute, range name) of ``patches``: the callable
    run inside a profiler range of that name (a class's ``forward`` too)."""
    from unittest import mock

    def ranged(name, fn):
        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return wrapper

    with contextlib.ExitStack() as stack:
        for obj, attr, name in patches:
            stack.enter_context(mock.patch.object(
                obj, attr, ranged(name, getattr(obj, attr))))
        yield


def split_by_ranges(torch, fn, patches, parts: dict) -> dict | None:
    """Device ms of one ``fn()`` call by part: ``parts`` maps a part to the
    profiler range (of ``patches``, see profiler_ranges) or aten operation
    whose kernels it sums; "rest" is the busy time left over.  None when the
    profiler recorded no device time.  A part is the device time of the
    kernels launched inside its range (the ranges' own spans on the device
    timeline, idle gaps included, are left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ranges = {name for _, _, name in patches}
    torch.cuda.synchronize()
    with profiler_ranges(torch, patches), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA and e.key not in ranges) / 1e3
    if busy <= 0:
        return None

    def total(key):
        return sum(e.device_time_total for e in events
                   if e.key == key and e.device_type == DeviceType.CPU) / 1e3

    split = {part: total(key) for part, key in parts.items()}
    split["rest"] = busy - sum(split.values())
    split["busy"] = busy
    return split


def raft_split(torch, fn) -> dict | None:
    """Device ms of one RAFT estimate by part: the all-pairs product, the
    pyramid (with the packing), the lookup, the convolutions (cuDNN's
    kernels and layout transposes) and the rest."""
    from opticalflowcontainer_tpu_torch.models import raft

    patches = [(raft, "all_pairs_correlation", "raft::allpairs_product"),
               (raft, "corr_pyramid", "raft::pyramid"),
               (raft, "pack_pyramid", "raft::pyramid"),
               (raft, "lookup_packed", "raft::lookup")]
    return split_by_ranges(torch, fn, patches, {
        "allpairs_product": "raft::allpairs_product", "pyramid": "raft::pyramid",
        "lookup": "raft::lookup", "convolutions": "aten::convolution"})


def raft_phase(torch, dev, trace_dir, large: bool, H=480, W=640, iters=12,
               n=201, seed=17) -> None:
    """Phase 17 (RAFT-small) or 18 (RAFT, ``large``) at 640x480 on seeded
    weights: estimate at iters=12 launches none of K1-K4; card vs CPU with
    fp32 convolutions at 192x128; the served flow (the model holds its
    convolutions in fp32) against fp32, and what TF32 convolutions would
    give; final_only against the stacked flows; B=1 latency over 50 calls,
    B=8 pairs/s; the device time by part; and for RAFT-small a 200-frame
    FusedModelStream at iters=8, as the demo serves it."""
    from unittest import mock

    from opticalflowcontainer_tpu_torch.models import raft
    from opticalflowcontainer_tpu_torch.runtime.fused import FusedModelStream

    cls, label = (raft.RAFT, "RAFT") if large else (raft.RAFTSmall, "RAFT-small")
    model = seeded_raft(torch, cls, seed, dev)
    n_params = sum(p.numel() for p in model.parameters())
    est = functools.partial(raft.estimate, iters=iters)
    i1, i2 = image_pairs(torch, H, W, 1, dev)
    est(model, i1, i2)  # warm-up: library load, cuDNN heuristics
    torch.cuda.synchronize()
    reset_counts()
    flow = est(model, i1, i2)
    torch.cuda.synchronize()
    assert_no_kernel_launches(f"{label} estimate")
    require(tuple(flow.shape) == (1, H, W, 2), f"flow shape {tuple(flow.shape)}")
    require(bool(torch.isfinite(flow).all()), "flow is finite")
    rms = float(flow.square().mean().sqrt())
    print(f"{label} ({n_params} parameters, seeded) at {W}x{H}, iters={iters}: flow "
          f"RMS {rms:.3f} px, max |.| {float(flow.abs().max()):.3f} px")

    latency = functools.partial(estimate_ms, torch, est, model)

    # Random weights make absolute pixels meaningless, so the bars are
    # relative to the flow's RMS (PERF.md's findings say why these): the card
    # against the CPU in fp32, mean 1e-3 and max 5e-2 of it (fp32 sums in
    # another order, carried through 12 recurrent steps); the served flow
    # against fp32 convolutions, mean 1e-2 of it.  RAFT serves fp32
    # convolutions (models/raft.py): TF32 ones missed that bar here
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        fp32 = est(model, i1, i2)
        with torch.inference_mode():
            x1, x2 = (t.permute(0, 3, 1, 2) for t in (i1, i2))
            stacked = model(x1, x2, iters=iters)
            final = model(x1, x2, iters=iters, final_only=True)
        require(torch.equal(final, stacked[-1]),
                "final_only equals the last of the stacked flows")
        s1, s2 = image_pairs(torch, 128, 192, 1, "cpu")
        cpu_model = seeded_raft(torch, cls, seed, "cpu")
        on_card = est(model, s1, s2).cpu()
        on_cpu = est(cpu_model, s1, s2)
        ref = float(on_cpu.square().mean().sqrt())
        d = (on_card - on_cpu).abs()
        print(f"192x128 card vs CPU (fp32 convolutions): mean|d| {float(d.mean()):.3e}, "
              f"max|d| {float(d.max()):.3e} px on a flow of RMS {ref:.3f} px (bars "
              f"1e-3 / 5e-2 of the RMS)")
        require(float(d.mean()) <= 1e-3 * ref and float(d.max()) <= 5e-2 * ref,
                "card agrees with the CPU")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    d = (flow - fp32).abs()
    print(f"{W}x{H} served flow vs fp32 convolutions: mean|d| {float(d.mean()):.3e} "
          f"px, max {float(d.max()):.3e} px (bar: mean 1e-2 of the RMS)")
    require(float(d.mean()) <= 1e-2 * rms, "the served flow within the bar of fp32")
    lat = latency(i1, i2, 50)
    # what TF32 convolutions (PyTorch's default for cuDNN) would give
    with mock.patch.object(raft, "fp32_convolutions", contextlib.nullcontext):
        require(torch.backends.cudnn.allow_tf32, "cuDNN's TF32 is PyTorch's default")
        d = (est(model, i1, i2) - fp32).abs()
        tf32_ms = latency(i1, i2, 50)
    print(f"{W}x{H} TF32 convolutions (not served) vs fp32: mean|d| "
          f"{float(d.mean()):.3e} px ({float(d.mean()) / rms:.3e} of the RMS), p99 "
          f"{float(d.flatten().kthvalue(int(0.99 * d.numel())).values):.3e}, max "
          f"{float(d.max()):.3e} px (the served bar: mean 1e-2 of the RMS)")
    print(f"{W}x{H} {label} estimate at B=1, iters={iters}, CUDA events over 50 "
          f"calls: median {np.median(lat):.3f} ms, p90 {np.percentile(lat, 90):.3f} "
          f"ms (served: fp32 convolutions); with TF32 convolutions median "
          f"{np.median(tf32_ms):.3f} ms")
    b1, b2 = image_pairs(torch, H, W, 8, dev)
    torch.cuda.reset_peak_memory_stats()
    lat8 = latency(b1, b2, 10)
    print(f"{W}x{H} {label} estimate at B=8: median {np.median(lat8):.3f} ms per "
          f"call, {8e3 / np.median(lat8):.2f} pairs/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    tag = "raft_large" if large else "raft_small"
    for batch, x1, x2 in ((1, i1, i2), (8, b1, b2)):
        profile_path(torch, f"one {label} estimate at B={batch}",
                     lambda: est(model, x1, x2), trace_dir, f"{tag}_b{batch}")
        split = raft_split(torch, lambda: est(model, x1, x2))
        print(f"{label} device time by part, one estimate at B={batch} (profiler "
              f"on): " + ("not measured (no device time recorded)" if split is None
                          else ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())))
    del b1, b2
    if large:
        return

    frames = bgr_frames(torch, H, W, n, 1.5, seed=18, device=dev)
    stream = FusedModelStream(model, functools.partial(raft.estimate, iters=8),
                              device=dev)
    stream.warmup(frames[0])
    reset_counts()
    require(stream.step(frames[0]) is None, "first frame seeds the state")
    dus, lat = [], []
    for f in frames[1:]:
        t0 = time.perf_counter()
        dus.append(float(stream.step(f)))  # syncs
        lat.append((time.perf_counter() - t0) * 1e3)
    assert_no_kernel_launches("the RAFT-small FusedModelStream")
    lat = np.array(lat)
    print(f"{W}x{H} RAFT-small FusedModelStream (iters=8, the demo's), {n - 1} uint8 "
          f"BGR frames (host clock, numpy frame to synced du): p50 "
          f"{np.percentile(lat, 50):.3f} ms, p99 {np.percentile(lat, 99):.3f} ms, "
          f"mean {lat.mean():.3f} ms, min {lat.min():.3f} ms, max {lat.max():.3f} ms; "
          f"du {min(dus):.4f} .. {max(dus):.4f} px")
    require(all(np.isfinite(dus)), "the stream's du is finite")

    def ten_steps():
        for f in frames[1:11]:
            float(stream.step(f))

    prof = profile_path(torch, "ten RAFT-small stream steps", ten_steps, trace_dir,
                        "raft_stream")
    require(prof is not None and prof["d2h"] == 10 and prof["h2d"] <= 10,
            "one scalar download and at most one frame upload per step")


def seeded_neuflow(torch, cls, seed: int, device):
    """NeuFlowLite or NeuFlow-v2 (``cls``) at the packaged architecture's
    full width, seeded: every convolution He-normal (std sqrt(2 / fan_in))
    and every linear layer LeCun-normal (std sqrt(1 / fan_in)) from a seeded
    torch.Generator, zero biases, LayerNorms at 1 and 0.  NeuFlowLite's
    matching gate is 0.05, not the reference's initial 0 (which would
    multiply the global-matching stage by 0): on seeded features the
    soft-argmax gives a centroid field of ~10 cells RMS at 1/16, which the
    gate makes a flow of a few px (the whole net's ~10 px RMS at 640x480)."""
    g = torch.Generator().manual_seed(seed)
    model = cls()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                std = (2.0 / m.weight[0].numel()) ** 0.5
            elif isinstance(m, torch.nn.Linear):
                std = (1.0 / m.weight.shape[1]) ** 0.5
            else:
                continue
            m.weight.copy_(torch.randn(m.weight.shape, generator=g) * std)
            m.bias.zero_()
        if hasattr(model, "matching_gate"):
            model.matching_gate.fill_(0.05)
    return model.to(device).eval()


# K3 and K4 launches per estimate call: NeuFlowLite warps and correlates
# once in each of its 2 refinement steps, NeuFlow-v2 in each of its 1 + 8
NEUFLOW_LAUNCHES = {"neuflow_lite": {"warp_bilinear": 2, "local_correlation": 2},
                    "neuflow_v2": {"warp_bilinear": 9, "local_correlation": 9}}


def neuflow_split(torch, fn) -> dict | None:
    """Device ms of one NeuFlow-v2 estimate by part: the backbone, the
    attention and matching (cross-attention, global matching, flow
    propagation), the refinement (its K3 and K4 launches included), the
    convex upsampling, and the rest (the hidden states' init convs, the
    resizes)."""
    from opticalflowcontainer_tpu_torch.models import neuflow_v2 as v2

    patches = [(v2.BackboneV2, "forward", "neuflow_v2::backbone"),
               (v2.CrossAttention, "forward", "neuflow_v2::attention_matching"),
               (v2, "global_matching_flow", "neuflow_v2::attention_matching"),
               (v2.FlowAttention, "forward", "neuflow_v2::attention_matching"),
               (v2.RefineBlock, "forward", "neuflow_v2::refinement"),
               (v2.ConvexUpsample, "forward", "neuflow_v2::upsampling")]
    return split_by_ranges(torch, fn, patches, {
        "backbone": "neuflow_v2::backbone",
        "attention_matching": "neuflow_v2::attention_matching",
        "refinement": "neuflow_v2::refinement",
        "upsampling": "neuflow_v2::upsampling"})


def neuflow_phase(torch, dev, trace_dir, v2: bool, n=201, fps=30.0) -> dict:
    """Phase 19 (NeuFlowLite at 640x480) or 20 (NeuFlow-v2, ``v2``, at
    768x432, the reference NeuFlow node's fixed size) on seeded weights: K3
    and K4 launches per estimate; the kernels' path against the plain path
    on the card and the card against the CPU at 192x128 (fp32 convolutions,
    which the NeuFlow nets serve; bars relative to the flow's RMS, as
    RAFT's); what TF32 convolutions would give; B=1 latency over 50 calls,
    B=8 pairs/s; one estimate under the profiler (NeuFlow-v2: its device
    time by part); a 200-frame FusedModelStream (p50/p99, launches, one
    upload and one download a step); NeuFlowLite also the demo
    ``--model neuflow`` at 640x480, 30 fps, 90 frames.  Returns the
    launches by path."""
    import io
    from unittest import mock

    from opticalflowcontainer_tpu_torch.models import convert, neuflow, neuflow_v2
    from opticalflowcontainer_tpu_torch.runtime import demo
    from opticalflowcontainer_tpu_torch.runtime.fused import FusedModelStream

    mod, cls, label, tag, (H, W), seed = (
        (neuflow_v2, neuflow_v2.NeuFlowV2, "NeuFlow-v2", "neuflow_v2", (432, 768), 20)
        if v2 else
        (neuflow, neuflow.NeuFlowLite, "NeuFlowLite", "neuflow_lite", (480, 640), 19))
    est = mod.estimate
    expect = dict(farneback_update=0, blur_solve=0, **NEUFLOW_LAUNCHES[tag])
    model = seeded_neuflow(torch, cls, seed, dev)
    n_params = sum(p.numel() for p in model.parameters())
    i1, i2 = image_pairs(torch, H, W, 1, dev)
    est(model, i1, i2)  # warm-up: library load, cuDNN's timed algorithms
    torch.cuda.synchronize()
    reset_counts()
    flow = est(model, i1, i2)
    torch.cuda.synchronize()
    launches = kernel_counts()
    print(f"{label} ({n_params} parameters, seeded) one estimate call at {W}x{H} "
          f"launched {launches} (expected {expect})")
    require(launches == expect, f"each {label} estimate call runs "
            f"{expect['warp_bilinear']} warps and {expect['local_correlation']} "
            f"correlations, and no Farneback kernel")
    require(tuple(flow.shape) == (1, H, W, 2) and flow.dtype == torch.float32,
            f"flow {tuple(flow.shape)} {flow.dtype}")
    require(bool(torch.isfinite(flow).all()), "flow is finite")
    rms = float(flow.square().mean().sqrt())
    print(f"flow RMS {rms:.3f} px, |u|,|v| mean {flow.abs().mean((0, 1, 2)).tolist()}, "
          f"max {float(flow.abs().max()):.3f} px")

    latency = functools.partial(estimate_ms, torch, est, model)

    # bars relative to the flow's RMS, as RAFT's (seeded weights make
    # absolute pixels meaningless): mean 1e-3, max 5e-2 of it
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        kern = est(model, i1, i2)
        with plain_kernels():
            plain = est(model, i1, i2)
        d = (kern - plain).abs()
        print(f"{W}x{H} kernel path vs plain path on the card: mean|d| "
              f"{float(d.mean()):.3e}, max|d| {float(d.max()):.3e} px on a flow of RMS "
              f"{rms:.3f} px (bars 1e-3 / 5e-2 of the RMS: fp32 sums in another order)")
        require(float(d.mean()) <= 1e-3 * rms and float(d.max()) <= 5e-2 * rms,
                "the kernels' path agrees with the plain path")
        s1, s2 = image_pairs(torch, 128, 192, 1, "cpu")
        on_card = est(model, s1, s2).cpu()
        on_cpu = est(seeded_neuflow(torch, cls, seed, "cpu"), s1, s2)
        ref = float(on_cpu.square().mean().sqrt())
        d = (on_card - on_cpu).abs()
        print(f"192x128 card vs CPU (fp32 convolutions): mean|d| {float(d.mean()):.3e}, "
              f"max|d| {float(d.max()):.3e} px on a flow of RMS {ref:.3f} px (bars "
              f"1e-3 / 5e-2 of the RMS)")
        require(float(d.mean()) <= 1e-3 * ref and float(d.max()) <= 5e-2 * ref,
                "card agrees with the CPU")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    d = (flow - kern).abs()
    print(f"{W}x{H} served flow vs fp32 convolutions: mean|d| {float(d.mean()):.3e} px, "
          f"max {float(d.max()):.3e} px (the model holds fp32 convolutions)")
    require(float(d.mean()) <= 1e-2 * rms, "the served flow within the bar of fp32")
    lat = latency(i1, i2, 50)
    b1, b2 = image_pairs(torch, H, W, 8, dev)
    torch.cuda.reset_peak_memory_stats()
    lat8 = latency(b1, b2, 10)
    peak = torch.cuda.max_memory_allocated() / 2**30
    # what PyTorch's default (TF32, cuDNN's heuristics) would give
    with mock.patch.object(mod, "fp32_convolutions", contextlib.nullcontext):
        d = (est(model, i1, i2) - kern).abs()
        tf32_ms = latency(i1, i2, 50)
        tf32_8 = latency(b1, b2, 10)
    print(f"{W}x{H} TF32 convolutions (not served) vs fp32: mean|d| {float(d.mean()):.3e} "
          f"px ({float(d.mean()) / rms:.3e} of the RMS), max {float(d.max()):.3e} px")
    print(f"{W}x{H} {label} estimate at B=1, CUDA events over 50 calls: median "
          f"{np.median(lat):.3f} ms, p90 {np.percentile(lat, 90):.3f} ms (served: fp32 "
          f"convolutions); with TF32 convolutions median {np.median(tf32_ms):.3f} ms")
    print(f"{W}x{H} {label} estimate at B=8: median {np.median(lat8):.3f} ms per call, "
          f"{8e3 / np.median(lat8):.2f} pairs/s, peak memory {peak:.2f} GiB; with TF32 "
          f"convolutions median {np.median(tf32_8):.3f} ms, "
          f"{8e3 / np.median(tf32_8):.2f} pairs/s")
    for batch, x1, x2 in ((1, i1, i2), (8, b1, b2)):
        profile_path(torch, f"one {label} estimate at B={batch}",
                     lambda: est(model, x1, x2), trace_dir, f"{tag}_b{batch}")
        if v2:
            split = neuflow_split(torch, lambda: est(model, x1, x2))
            print(f"{label} device time by part, one estimate at B={batch} (profiler "
                  f"on): " + ("not measured (no device time recorded)" if split is None
                              else ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())))
    del b1, b2

    frames = bgr_frames(torch, H, W, n, 1.5, seed=seed + 1, device=dev)
    stream = FusedModelStream(model, est, device=dev)
    stream.warmup(frames[0])
    reset_counts()
    require(stream.step(frames[0]) is None, "first frame seeds the state")
    dus, lat = [], []
    for f in frames[1:]:
        t0 = time.perf_counter()
        dus.append(float(stream.step(f)))  # syncs
        lat.append((time.perf_counter() - t0) * 1e3)
    stream_counts = kernel_counts()
    want = {k: v * (n - 1) for k, v in expect.items()}
    lat = np.array(lat)
    print(f"{W}x{H} {label} FusedModelStream, {n - 1} uint8 BGR frames (host clock, "
          f"numpy frame to synced du): p50 {np.percentile(lat, 50):.3f} ms, p99 "
          f"{np.percentile(lat, 99):.3f} ms, mean {lat.mean():.3f} ms, min {lat.min():.3f} "
          f"ms, max {lat.max():.3f} ms; du {min(dus):.4f} .. {max(dus):.4f} px; launches "
          f"{stream_counts} (expected {want})")
    require(stream_counts == want, "the stream ran both kernels on every frame")
    require(all(np.isfinite(dus)), "the stream's du is finite")

    def ten_steps():
        for f in frames[1:11]:
            float(stream.step(f))

    prof = profile_path(torch, f"ten {label} stream steps", ten_steps, trace_dir,
                        f"{tag}_stream")
    require(prof is not None and prof["d2h"] == 10 and prof["h2d"] <= 10,
            "one scalar download and at most one frame upload per step")
    by_path = {tag: launches, f"{tag}_stream": stream_counts}
    if v2:
        return by_path

    # the demo's neuflow backend, its loader handing over the seeded model
    # (the run reads no weights file)
    n_demo = 90
    argv = ["--model", "neuflow", "--frames", str(n_demo), "--width", str(W),
            "--height", str(H), "--fps", str(fps)]
    out = io.StringIO()
    reset_counts()
    with mock.patch.object(convert, "load_neuflow_lite_synth", lambda device=None: model), \
            contextlib.redirect_stdout(out):  # one line a frame: keep the tail
        r = demo.run(argv)
    counts = kernel_counts()
    for line in out.getvalue().strip().splitlines()[-2:]:
        print(f"demo {' '.join(argv)}: {line}")
    print(f"  demo_neuflow: processed {r['frames_processed']}, dropped "
          f"{r['frames_dropped']}, failed {r['frames_failed']} of {n_demo} frames, "
          f"{r['published']} smoothed velocities, "
          f"{r['frames_processed'] / r['seconds']:.2f} fps achieved in "
          f"{r['seconds']:.3f} s, final smoothed velocity {r['final_vx']} m/s, "
          f"error {r['error_mps']} m/s (seeded weights: not an accuracy figure; "
          f"the 10 mm/s bar is held with the packaged npz on the CPU, "
          f"tests/test_torch_neuflow.py); launches {counts}")
    require(r["ended"] and r["frames_failed"] == 0, "no frame failed, threads ended")
    require(r["published"] == r["frames_processed"] > 0
            and r["frames_processed"] + r["frames_dropped"] == n_demo - 1,
            "one velocity per processed frame; every frame processed or dropped")
    require(r["final_vx"] is not None and np.isfinite(r["final_vx"]),
            "the final smoothed velocity is finite")
    # the warm-up's estimate, then one per processed frame
    want = {k: v * (r["frames_processed"] + 1) for k, v in expect.items()}
    require(counts == want, f"the demo launched {want}")
    by_path["demo_neuflow"] = counts
    return by_path


def bf16_families(torch, dev) -> list:
    """(label, path tag, seeded model on ``dev``, estimate, (H, W)) of every
    family at its phase's size and seed; RAFT at the demo's 8 iterations."""
    from opticalflowcontainer_tpu_torch.models import (
        liteflownet, liteflownet3, neuflow, neuflow_v2, pwcnet, raft)

    raft8 = functools.partial(raft.estimate, iters=8)
    return [
        ("PWC-Net", "pwcnet", lambda: seeded_pwcnet(torch, 7, dev), pwcnet.estimate,
         (480, 640)),
        ("LiteFlowNet", "liteflownet",
         lambda: seeded_liteflownet(torch, liteflownet.LiteFlowNet, 11, dev),
         liteflownet.estimate, (480, 640)),
        ("LFN3", "liteflownet3",
         lambda: seeded_liteflownet(torch, liteflownet3.LiteFlowNet3, 11, dev),
         liteflownet3.estimate, (480, 640)),
        ("RAFT-small", "raft_small", lambda: seeded_raft(torch, raft.RAFTSmall, 17, dev),
         raft8, (480, 640)),
        ("RAFT", "raft", lambda: seeded_raft(torch, raft.RAFT, 17, dev), raft8,
         (480, 640)),
        ("NeuFlowLite", "neuflow_lite",
         lambda: seeded_neuflow(torch, neuflow.NeuFlowLite, 19, dev), neuflow.estimate,
         (480, 640)),
        ("NeuFlow-v2", "neuflow_v2",
         lambda: seeded_neuflow(torch, neuflow_v2.NeuFlowV2, 20, dev),
         neuflow_v2.estimate, (432, 768)),
    ]


def bf16_phase(torch, dev, n=101) -> dict:
    """Phase 21: each family served in bfloat16 through
    FusedModelStream(bf16=True) at its phase's size over 100 uint8 BGR
    frames beside an fp32 stream on the same frames, the two stepped in
    turns frame by frame (p50/p99 of each); K3 and K4 launches equal to the
    fp32 stream's (the kernels, not their plain versions, serve bf16); du
    fp32 and finite; ten steps of each under the profiler; the bf16 flow
    (fp32, finite) against the fp32 flow on one pair, mean and max change.
    Seeded weights make the change a precision figure, not an accuracy one
    (the bars on trained weights are the CPU tests').  Returns the bf16
    streams' launches by path (each step's launches read around it)."""
    from opticalflowcontainer_tpu_torch.runtime.fused import FusedModelStream

    def ten_steps(s, frames):
        for f in frames:
            float(s.step(f))

    by_path = {}
    for label, tag, build, est, (H, W) in bf16_families(torch, dev):
        model = build()
        frames = bgr_frames(torch, H, W, n, 1.5, seed=21, device=dev)
        streams = {name: FusedModelStream(model, est, bf16=name == "bf16", device=dev)
                   for name in ("fp32", "bf16")}
        lat = {name: [] for name in streams}
        counts = {name: dict.fromkeys(kernel_counts(), 0) for name in streams}
        for s in streams.values():
            s.warmup(frames[0])
            require(s.step(frames[0]) is None, "first frame seeds the state")
        reset_counts()
        for f in frames[1:]:
            for name, s in streams.items():
                before = kernel_counts()
                t0 = time.perf_counter()
                du = s.step(f)
                val = float(du)  # syncs
                lat[name].append((time.perf_counter() - t0) * 1e3)
                after = kernel_counts()
                for k in after:
                    counts[name][k] += after[k] - before[k]
                require(du.dtype == torch.float32 and np.isfinite(val),
                        f"{label}: the {name} stream's du is fp32 and finite")
        for name, s in streams.items():
            profile_path(torch, f"ten {label} {name} stream steps",
                         lambda: ten_steps(s, frames[1:11]), None, f"{tag}_{name}")
        bmodel = streams["bf16"].model
        require(all(p.dtype == torch.bfloat16 for p in bmodel.parameters()),
                f"{label}: the bf16 stream's parameters are bf16")
        i1, i2 = image_pairs(torch, H, W, 1, dev)
        f32, f16 = est(model, i1, i2), est(bmodel, i1, i2)
        require(f16.dtype == torch.float32 and bool(torch.isfinite(f16).all()),
                f"{label}: the bf16 flow is fp32 and finite")
        d = (f16 - f32).abs()
        rms = float(f32.square().mean().sqrt())
        p50 = {k: np.percentile(v, 50) for k, v in lat.items()}
        p99 = {k: np.percentile(v, 99) for k, v in lat.items()}
        print(f"bf16 {label} {W}x{H}, {n - 1} frames in turns with fp32: p50 "
              f"{p50['bf16']:.3f} ms, p99 {p99['bf16']:.3f} ms (fp32 stream p50 "
              f"{p50['fp32']:.3f}, p99 {p99['fp32']:.3f} ms); flow vs fp32 on one pair: "
              f"mean|d| {float(d.mean()):.4f} px, max {float(d.max()):.4f} px on a flow "
              f"of RMS {rms:.3f} px; launches {counts['bf16']} (fp32 stream "
              f"{counts['fp32']})")
        require(counts["bf16"] == counts["fp32"], f"{label}: the bf16 stream "
                f"launched K3 and K4 as the fp32 stream did")
        by_path[f"bf16_{tag}_stream"] = counts["bf16"]
        del model, bmodel, streams
    return by_path


def eval_rows(run_eval, argv) -> list:
    """The JSON rows ``run_eval.main(argv)`` prints, printed here too."""
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        require(run_eval.main(argv) == 0, f"run_eval {' '.join(argv)} returns 0")
    rows = [json.loads(line) for line in out.getvalue().splitlines()
            if line.startswith("{")]
    for row in rows:
        print(f"run_eval {' '.join(argv)}: {json.dumps(row)}")
    return rows


# K3 and K4 launches per eval pair of the learned methods phase 22 drives
EVAL_LAUNCHES = {"pwcnet": {"warp_bilinear": 4, "local_correlation": 5},
                 "neuflow": {"warp_bilinear": 2, "local_correlation": 2}}
README_FARNEBACK_FISHNET_EPE = 0.094  # README.md's table: the JAX package's


def eval_phase(torch, dev, H=480, W=640, n=32, shift=1.37) -> dict:
    """The offline eval and tools on the card: run_eval --method farneback
    on the easy fishnet suite at 640x480 (32 pairs; K1 and K2 launched
    (levels + 1) x 3 times a pair; pairs 0-1 against the CPU at phase 4's
    bars), pwcnet and neuflow on 4 fishnet pairs (K3 / K4 launches a
    pair), --time-device for farneback and pwcnet, run_pair and fish_speed
    on two 640x480 PNGs of a known subpixel shift written by the port's
    imwrite (the .flo's interior mean u within 0.05 px of the shift, the
    PNGs decoded by the port's imread), and zoo_latency --quick."""
    import io

    from opticalflowcontainer_tpu_torch.classical import farneback as fb
    from opticalflowcontainer_tpu_torch.eval import run_eval
    from opticalflowcontainer_tpu_torch.eval.datasets import fishnet_eval_pairs
    from opticalflowcontainer_tpu_torch.models import convert
    from opticalflowcontainer_tpu_torch.tools import fish_speed, run_pair, zoo_latency
    from opticalflowcontainer_tpu_torch.utils import imread, imwrite, read_flo

    by_path = {}
    per_pair = (fb._num_levels(H, W, 3, 0.5) + 1) * 3  # cv2's defaults
    reset_counts()
    t0 = time.perf_counter()
    (row,) = eval_rows(run_eval, ["--method", "farneback", "--fishnet", "--n", str(n)])
    counts = kernel_counts()
    print(f"  farneback, {n} fishnet pairs at {W}x{H} in {time.perf_counter() - t0:.2f} s "
          f"(pairs made on the host included); launches {counts}")
    print(f"  farneback fishnet mean EPE {row['epe']:.4f} px on the card; README.md's "
          f"{README_FARNEBACK_FISHNET_EPE} is the JAX package's (accuracy, no bar)")
    require(row["n"] == n and all(np.isfinite(row[k]) for k in ("epe", "p50", "p95")),
            "a finite farneback row over every pair")
    require(counts["farneback_update"] == counts["blur_solve"] == per_pair * n,
            f"K1 and K2 launched {per_pair} times a pair")
    by_path["eval_farneback"] = counts

    pairs = fishnet_eval_pairs(2, H, W)
    card = run_eval._make_method("farneback", None, False, device=dev)
    cpu = run_eval._make_method("farneback", None, False, device="cpu")
    for i, (img1, img2, gt, _) in enumerate(pairs):
        d = np.abs(card(img1, img2) - cpu(img1, img2))
        print(f"  farneback pair {i}: card vs CPU mean {d.mean():.3e}, max {d.max():.3e} px")
        require(d.mean() <= 1e-3 and d.max() <= 1e-2,
                "farneback on the card within 1e-3 px mean, 1e-2 px max of the CPU")

    for method, tag in (("pwcnet", "pwcnet_synth.npz"), ("neuflow", "neuflow_lite_synth.npz")):
        weights = "packaged" if (convert.WEIGHTS_DIR / tag).exists() else "seeded"
        print(f"  {method} weights: {weights}" + (
            " (the npz is absent: its EPE measures the path, not accuracy)"
            if weights == "seeded" else ""))
        reset_counts()
        (row,) = eval_rows(run_eval, ["--method", method, "--fishnet", "--n", "4"])
        counts = kernel_counts()
        want = {k: 4 * v for k, v in EVAL_LAUNCHES[method].items()}
        print(f"  {method}: launches {counts} over 4 pairs")
        require(np.isfinite(row["epe"]), f"a finite {method} row")
        require(all(counts[k] == v for k, v in want.items()),
                f"{method}: K3 / K4 launched {EVAL_LAUNCHES[method]} a pair")
        by_path[f"eval_{method}"] = counts

    card_name = card_line()
    for row in eval_rows(run_eval, ["--method", "farneback,pwcnet", "--fishnet", "--n",
                                    "1", "--time-device"]):
        print(f"  {row['method']}: {row['device_ms_per_frame']} ms a pair at {W}x{H} "
              f"({row['timer']}{', unreliable' if row['unreliable'] else ''}) on "
              f"{card_name}")
        require(row["device_ms_per_frame"] > 0, "a device time")

    g = plane_waves(torch, H, W, [(0.0, 0.0), (shift, 0.0)], seed=23, device=dev)
    frames = (g[..., None] * torch.tensor(GAINS_BGR, device=dev)).clamp(0, 255).round()
    frames = frames.to(torch.uint8).cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        a, b = os.path.join(tmp, "a.png"), os.path.join(tmp, "b.png")
        imwrite(a, frames[0])
        imwrite(b, frames[1])
        flo, hsv = os.path.join(tmp, "f.flo"), os.path.join(tmp, "f.png")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            require(run_pair.main([a, b, "--out-flo", flo, "--out-png", hsv]) == 0,
                    "run_pair returns 0")
            require(fish_speed.main([a, b, "--out-prefix", os.path.join(tmp, "fs")]) == 0,
                    "fish_speed returns 0")
        for line in out.getvalue().splitlines():
            print(f"  {line.replace(tmp, '<tmp>')}")
        flow = read_flo(flo)
        u = float(flow[40:-40, 40:-40, 0].mean())
        print(f"  run_pair: interior mean u {u:.4f} px, shift {shift} px")
        require(flow.shape == (H, W, 2) and abs(u - shift) <= 0.05,
                "run_pair's .flo interior mean u within 0.05 px of the shift")
        for path in (hsv, *(os.path.join(tmp, f"fs{p}.png") for p in ("_one", "_two", "_flow"))):
            img = imread(path)
            require(img.shape == (H, W, 3) and img.dtype == np.uint8,
                    f"{os.path.basename(path)} decodes to a {W}x{H} BGR image")

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rows = zoo_latency.main(["--quick", "--models", "pwcnet,neuflow_lite"])
    for row in rows:
        print(f"  zoo_latency --quick: {json.dumps(row)} on {card_name}")
    require([r["model"] for r in rows] == ["pwcnet", "neuflow_lite"],
            "zoo_latency prints a row a model")
    return by_path


# the training size of each family: train_flow's default 96x128, PWC-Net
# at 128x192 (its sizes are multiples of 64; the reference trained it there)
TRAIN_SIZE = {"pwcnet": (128, 192)}
# K3 and K4 launches per training step (one forward) of the families that
# run them, at train_flow's defaults (NeuFlow-v2 refines --iters 8 times)
TRAIN_LAUNCHES = {"pwcnet": (4, 5), "liteflownet": (14, 5),
                  "liteflownet3": (13, 6), "neuflow_lite": (2, 2),
                  "neuflow_v2": (9, 9), "raft_small": (0, 0),
                  "raft_large": (0, 0)}
# kernel path vs plain path, every parameter's gradient at PWC-Net's
# training shapes: the backward is the same plain autograd on both paths,
# at forward activations that differ by K4's fp32 summation order (~1e-7
# relative).  Where that moves a leaky ReLU across its kink or a warp
# coordinate across a whole pixel, the gradient of that element jumps, so
# a tensor of small gradients can move by 1e-3 of its own scale (PWC-Net's
# decoder3.upflow moved 1.5e-3 on an H100).  The bars are therefore on
# the model's scale: each tensor's largest difference within 1e-4 of the
# largest gradient of the model, and the whole gradient within 1e-4 in L2
TRAIN_GRAD_REL = 1e-4


def train_batch(torch, dev, B=8, H=96, W=128, seed=23) -> dict:
    """One of train_flow's batches at its defaults, on the card."""
    from opticalflowcontainer_tpu_torch.parallel.train import batch_to_device
    from opticalflowcontainer_tpu_torch.tools.train_flow import make_affine_batch

    return batch_to_device(make_affine_batch(np.random.default_rng(seed), B, H, W), dev)


def trainer_init(torch, name: str, dev, seed=23):
    """Family ``name`` as train_flow initialises it (flax's init; the
    pyramid families' 1.55 rescale), on the card, in training mode."""
    from opticalflowcontainer_tpu_torch.models.common import flax_init
    from opticalflowcontainer_tpu_torch.tools import train_flow

    model = flax_init(train_flow.build_model(name), torch.Generator().manual_seed(seed))
    if name in train_flow.PYRAMID_MODELS:
        train_flow._kaiming_rescale(model)
    return model.to(dev).train()


@contextlib.contextmanager
def exact_convolutions(torch):
    """cuDNN in fp32 (no TF32), deterministic algorithms, for the block:
    the two paths' gradients then differ by the kernels alone."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark)
    cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark = False, True, False
    try:
        yield
    finally:
        cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark = saved


@contextlib.contextmanager
def deterministic_algorithms(torch):
    """PyTorch's deterministic algorithms for the block (cuDNN's
    deterministic convolutions, a gather's backward without atomics);
    an operation that has none warns and runs as it would."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])


def train_grads(torch, model, loss_fn, batch):
    loss = loss_fn(model, batch)
    params = [p for p in model.parameters() if p.requires_grad]
    return loss.detach(), torch.autograd.grad(loss, params)


def grad_gap(torch, got, want) -> tuple[float, float]:
    """(the largest |got - want| of any tensor over the largest |want| of
    the model, |got - want| over |want| as one vector in L2)."""
    scale = max(float(w.abs().max()) for w in want)
    worst = max(float((g - w).abs().max()) for g, w in zip(got, want))
    diff = sum(float((g - w).double().square().sum()) for g, w in zip(got, want))
    norm = sum(float(w.double().square().sum()) for w in want)
    return worst / scale, (diff / norm) ** 0.5


def backward_split(torch, model, loss_fn, batch) -> dict | None:
    """Device ms of one training step's forward and backward (profiler busy
    time: the forward alone, then forward and backward), and of K3's and
    K4's plain backward inside it (the profiler ranges around their
    ``plain_vjp``).  None when the profiler saw no device time."""
    from opticalflowcontainer_tpu_torch.ops import correlation as k4
    from opticalflowcontainer_tpu_torch.ops import warp_bilinear as k3

    params = [p for p in model.parameters() if p.requires_grad]

    def forward():
        with torch.no_grad():
            loss_fn(model, batch)

    def step():
        torch.autograd.grad(loss_fn(model, batch), params)

    fwd = split_by_ranges(torch, forward, [], {})
    patches = [(k3, "plain_vjp", "train::k3_plain_backward"),
               (k4, "plain_vjp", "train::k4_plain_backward")]
    both = split_by_ranges(torch, step, patches, {
        "k3_backward": "train::k3_plain_backward",
        "k4_backward": "train::k4_plain_backward"})
    if fwd is None or both is None:
        return None
    back = both["busy"] - fwd["busy"]
    plain = both["k3_backward"] + both["k4_backward"]
    return {"forward_ms": fwd["busy"], "backward_ms": back,
            "k3_plain_backward_ms": both["k3_backward"],
            "k4_plain_backward_ms": both["k4_backward"],
            "plain_share_of_backward": plain / back if back > 0 else None}


def train_step_events(torch, model, loss_fn, batch, reps=5) -> tuple[float, float]:
    """ms of the forward and of the backward of one step, CUDA events
    around each (the device's waits on the host included), mean of
    ``reps`` after two warm-up steps."""
    params = [p for p in model.parameters() if p.requires_grad]
    fwd, bwd = [], []
    for i in range(reps + 2):
        e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        e[0].record()
        loss = loss_fn(model, batch)
        e[1].record()
        torch.autograd.grad(loss, params)
        e[2].record()
        e[2].synchronize()
        if i >= 2:
            fwd.append(e[0].elapsed_time(e[1]))
            bwd.append(e[1].elapsed_time(e[2]))
    return float(np.mean(fwd)), float(np.mean(bwd))


def train_log(line: str) -> tuple[int, float, float] | None:
    """(step, loss, steps/s) of one of train_flow's step lines."""
    parts = line.split()
    if len(parts) == 8 and parts[0] == "step" and parts[7] == "steps/s":
        return int(parts[1]), float(parts[3]), float(parts[6])
    return None


def training_phase(torch, dev, steps=30, seed=23) -> dict:
    """Phase 23, training on the card at train_flow's defaults (B=8,
    96x128, --iters 8; PWC-Net at 128x192): K3/K4's backward (kernel path
    vs plain path, every PWC-Net parameter's gradient), each family trained
    through train_flow.main from its seeded init, the export served at
    640x480, RAFT-small's loss falling on a fixed batch, and the
    timings."""
    import io
    import tempfile

    from opticalflowcontainer_tpu_torch.models import convert
    from opticalflowcontainer_tpu_torch.parallel import checkpoint
    from opticalflowcontainer_tpu_torch.parallel.train import make_train_state, train_step
    from opticalflowcontainer_tpu_torch.tools import train_flow

    card_name = card_line()
    by_path = {}
    batches = {"pwcnet": train_batch(torch, dev, 8, *TRAIN_SIZE["pwcnet"], seed=seed),
               "liteflownet3": train_batch(torch, dev, seed=seed)}
    batch = batches["pwcnet"]

    # K3 and K4 backward at PWC-Net's training shapes
    model = trainer_init(torch, "pwcnet", dev, seed)
    loss_fn = train_flow.make_loss("pwcnet")
    with exact_convolutions(torch):
        reset_counts()
        loss_k, grads_k = train_grads(torch, model, loss_fn, batch)
        counts = kernel_counts()
        with plain_kernels():
            loss_p, grads_p = train_grads(torch, model, loss_fn, batch)
            _, grads_q = train_grads(torch, model, loss_fn, batch)
    worst, l2 = grad_gap(torch, grads_k, grads_p)
    repeat = grad_gap(torch, grads_q, grads_p)
    own = max(float((gk - gp).abs().max() / gp.abs().max()) for gk, gp in zip(grads_k, grads_p))
    dl = abs(float(loss_k) - float(loss_p))
    print(f"  PWC-Net training loss at B=8, 128x192: kernels {float(loss_k):.8f}, "
          f"plain {float(loss_p):.8f}; {len(grads_k)} gradients: largest difference "
          f"{worst:.3e} of the model's largest gradient, {l2:.3e} in L2 (bars "
          f"{TRAIN_GRAD_REL}), {own:.3e} of a tensor's own largest; the plain path "
          f"against itself {repeat[0]:.3e}, {repeat[1]:.3e}; launches {counts}")
    require(counts["warp_bilinear"] == 4 and counts["local_correlation"] == 5,
            "the kernel path's step launches K3 4 and K4 5 times")
    require(dl <= 1e-5 * abs(float(loss_p)), "the kernel path's loss within 1e-5 of the plain")
    require(worst <= TRAIN_GRAD_REL and l2 <= TRAIN_GRAD_REL,
            "the gradients within the bars of the plain path's")

    # the host's part of a step: one of train_flow's batches
    from opticalflowcontainer_tpu_torch.tools.train_flow import make_affine_batch

    rng = np.random.default_rng(seed)
    for kw in ({}, {"mesh_prob": 1.0}):
        t0 = time.perf_counter()
        for _ in range(5):
            make_affine_batch(rng, 8, 96, 128, **kw)
        print(f"  make_affine_batch at B=8, 96x128 {kw or ''}: "
              f"{(time.perf_counter() - t0) / 5 * 1e3:.1f} ms on the host")

    # each family through train_flow.main, exported, loaded, served
    with tempfile.TemporaryDirectory() as tmp:
        for name, (n3, n4) in TRAIN_LAUNCHES.items():
            out = os.path.join(tmp, f"{name}.npz")
            H, W = TRAIN_SIZE.get(name, (96, 128))
            argv = ["--model", name, "--steps", str(steps), "--log-every", "10",
                    "--height", str(H), "--width", str(W),
                    "--ckpt-every", str(steps), "--ckpt-dir",
                    os.path.join(tmp, f"ckpt_{name}"), "--out", out]
            log = io.StringIO()
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(log):
                require(train_flow.main(argv) == 0, f"train_flow {name} returns 0")
            wall = time.perf_counter() - t0
            counts = kernel_counts()
            peak = torch.cuda.max_memory_allocated() / 2**20
            rows = [r for r in map(train_log, log.getvalue().splitlines()) if r]
            losses = [loss for _, loss, _ in rows]
            rate = rows[-1][2]
            print(f"  train_flow --model {name}: {steps} steps at B=8, {H}x{W} in "
                  f"{wall:.2f} s; losses {losses}; {rate:.2f} steps/s; peak "
                  f"{peak:.0f} MiB; launches {counts} ({card_name})")
            require(rows[-1][0] == steps and all(np.isfinite(losses)),
                    f"{name}: a finite loss at every logged step")
            require(counts["warp_bilinear"] == n3 * steps
                    and counts["local_correlation"] == n4 * steps
                    and counts["farneback_update"] == counts["blur_solve"] == 0,
                    f"{name}: K3 {n3} and K4 {n4} launches a step, no K1/K2")
            require(checkpoint.latest_checkpoint(os.path.join(tmp, f"ckpt_{name}"))
                    is not None, f"{name}: a checkpoint")
            by_path[f"train_{name}"] = counts
            net = train_flow.build_model(name)
            net.load_state_dict(convert.flax_to_torch_state_dict(
                convert.load_flat_npz(out), net))
            served = serve_pair(torch, name, net.to(dev).eval())
            print(f"  {name} export served at 640x480: flow {tuple(served.shape)}, "
                  f"|flow| max {float(served.abs().max()):.3f} px")
            require(tuple(served.shape) == (480, 640, 2)
                    and bool(torch.isfinite(served).all()),
                    f"{name}: the loaded export serves a finite 640x480 flow")

    # the recipe of tests/test_training.py::test_raft_training_loss_decreases
    from opticalflowcontainer_tpu_torch.models import RAFTSmall

    state = make_train_state(RAFTSmall().to(dev), torch.Generator().manual_seed(0), lr=1e-3)
    fixed = shifted_batch(np.random.default_rng(0))
    losses = []
    for _ in range(8):
        state, loss = train_step(state, fixed, iters=2)
        losses.append(float(loss))
    print(f"  RAFT-small train_step x8 on a fixed batch: losses {losses}")
    require(np.isfinite(losses).all() and losses[-1] < 0.7 * losses[0] and state.step == 8,
            "RAFT-small's loss after 8 steps below 0.7 of the first")

    # forward / backward device time and the plain backward's share
    for name, batch in batches.items():
        model = trainer_init(torch, name, dev, seed)
        loss_fn = train_flow.make_loss(name)
        fwd_ms, bwd_ms = train_step_events(torch, model, loss_fn, batch)
        split = backward_split(torch, model, loss_fn, batch)
        H, W = batch["img1"].shape[-2:]
        print(f"  {name} training step at B=8, {H}x{W}: forward {fwd_ms:.3f} ms, "
              f"backward {bwd_ms:.3f} ms by events; device busy "
              f"{json.dumps(split)} ({card_name})")
    return by_path


def shifted_batch(rng, B=2, H=32, W=32, max_shift=3) -> dict:
    """tests/test_training.py's batch: a blurred random texture shifted by
    a whole number of px in x (the port's GaussianBlur in place of cv2's)."""
    from opticalflowcontainer_tpu_torch.core.affine import gaussian_blur

    img1 = np.zeros((B, H, W, 3), np.float32)
    img2 = np.zeros((B, H, W, 3), np.float32)
    flow = np.zeros((B, H, W, 2), np.float32)
    for i in range(B):
        base = gaussian_blur(rng.uniform(0, 1, (H + 16, W + 16)).astype(np.float32), 1.5)
        dx = int(rng.integers(-max_shift, max_shift + 1))
        img1[i] = np.repeat(base[8:8 + H, 8:8 + W, None], 3, -1)
        img2[i] = np.repeat(base[8:8 + H, 8 - dx:8 + W - dx, None], 3, -1)
        flow[i, ..., 0] = dx
    return {"img1": img1, "img2": img2, "flow": flow}


def serve_pair(torch, name: str, model) -> "torch.Tensor":
    """The family's estimate of one 640x480 pair (image_pairs' texture)."""
    import importlib

    module = {"raft_small": "raft", "raft_large": "raft", "neuflow_lite": "neuflow",
              "neuflow_v2": "neuflow_v2", "pwcnet": "pwcnet",
              "liteflownet3": "liteflownet3", "liteflownet": "liteflownet"}[name]
    estimate = importlib.import_module(
        f"opticalflowcontainer_tpu_torch.models.{module}").estimate
    x1, x2 = image_pairs(torch, 480, 640, 1, next(model.parameters()).device)
    return estimate(model, x1[0], x2[0])


# ------------------------------------------------------------ phase 24
REPO = os.path.dirname(os.path.abspath(__file__))
_FISHNET: dict = {}


def fishnet_frame(shift: int, H=480, W=640, cell=24, margin=160) -> np.ndarray:
    """tests/test_launch.py's fishnet (2 px lines of (30, 40, 50) every
    ``cell`` px on blue water), drawn with the port's core/draw.py ``margin``
    px wider and cropped so that the net moves ``shift`` px to the right."""
    from opticalflowcontainer_tpu_torch.core.draw import line

    key = (H, W, cell, margin)
    if key not in _FISHNET:
        img = np.full((H, W + margin, 3), (180, 120, 60), np.uint8)
        for y in range(12, H, cell):
            line(img, (0, y), (W + margin, y), (30, 40, 50), 2)
        for x in range(12, W + margin, cell):
            line(img, (x, 0), (x, H), (30, 40, 50), 2)
        _FISHNET[key] = img
    return np.ascontiguousarray(_FISHNET[key][:, margin - shift:margin - shift + W])


def match_frac(a: np.ndarray, b: np.ndarray, tol: float) -> float:
    """Share of the points of ``a`` with a point of ``b`` within ``tol``."""
    if len(a) == 0 or len(b) == 0:
        return 0.0
    d = np.linalg.norm(a[:, None] - b[None], axis=-1).min(axis=1)
    return float((d < tol).mean())


def detector_checks() -> None:
    """The compiled detector against the plain one on the golden image
    (rotated cells) and on a drawn 640x480 fishnet (axis-aligned): the same
    count and every point within 1e-3 px; the golden recall and precision
    at 5 px (tests/test_native_junction.py's bars); ms per frame of each."""
    from opticalflowcontainer_tpu_torch.native import detect_junctions
    from opticalflowcontainer_tpu_torch.utils.png import imread

    golden = imread(os.path.join(REPO, "tests", "data", "fishnet_golden.png"))
    gt = np.load(os.path.join(REPO, "tests", "data", "fishnet_golden_gt.npy"))
    cases = (("golden 640x480, rotated", golden, dict(grid_area=26.0 ** 2, rotated=True)),
             ("drawn fishnet 640x480", fishnet_frame(0), dict(grid_area=22.0 ** 2)))
    for label, img, kw in cases:
        compiled = detect_junctions(img, **kw)
        plain = detect_junctions(img, force_python=True, **kw)
        t_c = []
        for _ in range(20):
            t0 = time.perf_counter()
            detect_junctions(img, **kw)
            t_c.append((time.perf_counter() - t0) * 1e3)
        t_p = []
        for _ in range(3):
            t0 = time.perf_counter()
            detect_junctions(img, force_python=True, **kw)
            t_p.append((time.perf_counter() - t0) * 1e3)
        gap = float(np.abs(compiled - plain).max()) if len(compiled) == len(plain) > 0 else None
        print(f"detector, {label}: compiled {len(compiled)} junctions, plain "
              f"{len(plain)}; largest gap {gap} px (bar 1e-3); ms per frame on "
              f"the host: compiled {np.median(t_c):.3f} (median of 20), plain "
              f"{np.median(t_p):.3f} (median of 3)")
        require(len(compiled) == len(plain) > 0, f"{label}: compiled and plain agree in count")
        require(gap <= 1e-3, f"{label}: compiled = plain within 1e-3 px")
        if label.startswith("golden"):
            recall, precision = match_frac(gt, compiled, 5.0), match_frac(compiled, gt, 5.0)
            print(f"  against fishnet_golden_gt.npy ({len(gt)} junctions): recall "
                  f"{recall:.4f} (bar > 0.85), precision {precision:.4f} (bar > 0.95) at 5 px")
            require(recall > 0.85 and precision > 0.95, "the golden recall and precision")


def run_junction_bringup(bus, node, det, frames, label: str) -> dict:
    """Publish ``frames`` (stamps 1 s apart) into a junction bringup in topic
    mode; every synced pair must give a velocity.  Prints the velocities'
    mean (px/frame at pixel_to_meter 1), the detector's ms per frame and
    image-publish -> velocity-publish p50/p99; returns the launch counts."""
    node.vel.pixel_to_meter = 1.0
    vels, t_vel = [], []
    bus.subscribe(f"/optical_flow/{node.p.name}_velocity",
                  lambda m: (vels.append(m.x), t_vel.append(time.perf_counter())))
    detect, det_ms = det._detect, []

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = detect(*a, **kw)
        det_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    det._detect = timed
    from opticalflowcontainer_tpu_torch.runtime.messages import Header, ImageMsg

    lat = []
    reset_counts()
    try:
        for t, frame in enumerate(frames):
            t0 = time.perf_counter()
            n_before = len(vels)
            bus.publish("/camera/color/image_raw", ImageMsg(Header(float(t)), frame))
            if len(vels) > n_before:
                lat.append((t_vel[-1] - t0) * 1e3)
    finally:
        node.stop()
        det.stop()
    counts = kernel_counts()
    v = np.array(vels)
    print(f"bringup_junction {label}, {len(frames)} frames: {len(v)} velocities, "
          f"{node.frames_failed} failed; mean {v.mean() if len(v) else float('nan'):.4f} "
          f"px/frame; detector node {np.median(det_ms):.3f} ms per frame (median); "
          f"image publish -> velocity publish p50 {np.percentile(lat, 50):.3f} ms, "
          f"p99 {np.percentile(lat, 99):.3f} ms; launches {counts}")
    require(len(v) == len(frames) - 1 and node.frames_failed == 0,
            "every synced pair processed, none failed")
    return {"vels": v, "counts": counts}


def junction_pipeline_phase(torch, dev, trace_dir, n=61, seed=11) -> dict:
    """Phase 24: the junction pipeline at 640x480 (see the docstring)."""
    from opticalflowcontainer_tpu_torch.classical import farneback as fb
    from opticalflowcontainer_tpu_torch.models.liteflownet3 import LiteFlowNet3, estimate
    from opticalflowcontainer_tpu_torch.runtime import launch
    from opticalflowcontainer_tpu_torch.runtime.messages import Header, ImageMsg
    from opticalflowcontainer_tpu_torch.runtime.nodes import make_model_backend

    H, W = 480, 640
    detector_checks()
    frames = [fishnet_frame(2 * t) for t in range(n)]
    by_path = {}

    # the default bringup: compiled detector + Farneback (K1/K2) on the card
    bus, node, det = launch.bringup_junction(grid_area=22.0 ** 2, device=dev)
    g0, g1 = (f.mean(-1).astype(np.float32) for f in frames[:2])
    node.backend(g0, g1, 1.0)  # warm-up
    r = run_junction_bringup(bus, node, det, frames, "Farneback")
    per_frame = (fb._num_levels(H, W, 2, 0.5) + 1) * 2
    require(r["counts"]["farneback_update"] == r["counts"]["blur_solve"]
            == per_frame * (n - 1), f"K1 and K2 launched {per_frame} times a pair")
    require(abs(r["vels"].mean() - 2.0) < 0.3, "the mean velocity within 0.3 px/frame of 2")
    by_path["junction_farneback"] = r["counts"]

    # LFN3's model backend (K3/K4) on seeded weights
    model = seeded_liteflownet(torch, LiteFlowNet3, seed, dev)
    backend = make_model_backend(functools.partial(estimate, model), device=dev)
    backend(frames[0], frames[1], 1.0)  # warm-up
    k = 21
    bus, node, det = launch.bringup_junction(backend=backend, grid_area=22.0 ** 2)
    r = run_junction_bringup(bus, node, det, frames[:k], "LFN3 (seeded)")
    require(r["counts"]["warp_bilinear"] == LFN3_LAUNCHES["warp_bilinear"] * (k - 1)
            and r["counts"]["local_correlation"]
            == LFN3_LAUNCHES["local_correlation"] * (k - 1),
            "K3 and K4 ran 13 and 6 times a pair")
    by_path["junction_lfn3"] = r["counts"]

    # the detector in its own process, over the TCP bridge
    import threading

    t0 = time.perf_counter()
    bus, node, server, child = launch.bringup_junction_remote(grid_area=22.0 ** 2,
                                                              device=dev)
    print(f"bringup_junction_remote: the detector process READY in "
          f"{time.perf_counter() - t0:.2f} s")
    try:
        node.vel.pixel_to_meter = 1.0
        node.backend(g0, g1, 1.0)
        vels, arrived, rtt = [], threading.Semaphore(0), []
        bus.subscribe("/optical_flow/JUNCTION_velocity", lambda m: vels.append(m.x))
        bus.subscribe("/junction_detector/junctions", lambda m: arrived.release())
        m = 31
        reset_counts()
        for t in range(m):
            bus.publish("/camera/color/image_raw", ImageMsg(Header(float(t)), frames[t]))
            require(arrived.acquire(timeout=30.0), "junctions came back over the bridge")
        counts = kernel_counts()
        failed = node.frames_failed
        node.stop()  # the round trip alone: image out, junctions back
        for t in range(m):
            t0 = time.perf_counter()
            bus.publish("/camera/color/image_raw", ImageMsg(Header(float(m + t)), frames[t]))
            require(arrived.acquire(timeout=30.0), "junctions came back over the bridge")
            rtt.append((time.perf_counter() - t0) * 1e3)
    finally:
        child.stdin.close()
        child.wait(timeout=30)
        server.close()
        node.stop()
    v = np.array(vels)
    print(f"bringup_junction_remote, {m} frames: {len(v)} velocities, {failed} "
          f"failed, mean {v.mean():.4f} px/frame; round trip image -> junctions "
          f"(bridge, the compiled detector in its process, bridge) p50 "
          f"{np.percentile(rtt, 50):.3f} ms, p99 {np.percentile(rtt, 99):.3f} ms over "
          f"{m} frames; detector exit code {child.returncode}; launches {counts}")
    require(len(v) == m - 1 and failed == 0, "every synced pair processed")
    require(abs(v.mean() - 2.0) < 0.3, "the remote mean velocity within 0.3 of 2")
    require(child.returncode == 0, "the detector process exits 0")
    by_path["junction_remote"] = counts

    by_path["junction_adaptive"] = adaptive_checks(torch, dev)
    ingest_checks(torch, dev)
    prefetch_checks(torch, dev, trace_dir)
    return by_path


def adaptive_checks(torch, dev, H=480, W=640, reps=20) -> dict:
    """make_adaptive_backend (CLAHE, median 3, the magnitude mask) around the
    Farneback backend: the card against the CPU (phase 4's bars) and ms a
    frame with and without the wrapper."""
    from opticalflowcontainer_tpu_torch.runtime.adaptive import (
        AdaptiveParams, make_adaptive_backend)
    from opticalflowcontainer_tpu_torch.runtime.nodes import make_farneback_backend

    # a list, so that a frame passed twice is the same object (the wrapper
    # reuses the previous frame's preprocessed form by identity)
    g = list(plane_waves(torch, H, W, [(1.5 * t, 0.5 * t) for t in range(reps + 2)],
                         seed=17, device="cpu").numpy())
    params = AdaptiveParams(flow_median_ksize=3, flow_max_mag=50.0)
    kw = dict(levels=2, winsize=13, iterations=2)
    plain_card = make_farneback_backend(device=dev, **kw)
    card = make_adaptive_backend(plain_card, params)
    cpu = make_adaptive_backend(make_farneback_backend(device="cpu", **kw), params)
    reset_counts()
    got = card(g[0], g[1], 1 / 30)
    counts = kernel_counts()
    want = cpu(g[0], g[1], 1 / 30)
    d = np.abs(got - want)
    t_wrap, t_plain = [], []
    for t in range(reps):
        t0 = time.perf_counter()
        card(g[t + 1], g[t + 2], 1 / 30)
        t_wrap.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        plain_card(g[t + 1], g[t + 2], 1 / 30)
        t_plain.append((time.perf_counter() - t0) * 1e3)
    print(f"make_adaptive_backend(Farneback) {W}x{H}: card vs CPU mean|d| "
          f"{d.mean():.3e}, max|d| {d.max():.3e} px (bars 1e-3, 1e-2); u "
          f"{got[..., 0].mean():.4f} px (texture moved 1.5); ms a frame (host "
          f"clock, flow to numpy, median of {reps}): wrapped {np.median(t_wrap):.3f}, "
          f"bare {np.median(t_plain):.3f}; launches {counts}")
    require(d.mean() <= 1e-3 and d.max() <= 1e-2, "adaptive: the card agrees with the CPU")
    return counts


def ingest_checks(torch, dev) -> None:
    """preprocess_frames on the card against the CPU, for gray + resize and
    RGB + mean."""
    from opticalflowcontainer_tpu_torch.core.ingest import preprocess_frames

    rng = np.random.default_rng(21)
    frames = rng.integers(0, 256, (4, 480, 640, 3), dtype=np.uint8)
    for kw in (dict(out_hw=(240, 320), to_gray=True), dict(to_rgb=True, mean=(0.4, 0.45, 0.5)),
               dict(out_hw=(384, 512), normalize=False)):
        got = preprocess_frames(frames, device=dev, **kw).cpu().numpy()
        want = preprocess_frames(frames, device="cpu", **kw).numpy()
        d = float(np.abs(got - want).max())
        scale = 1.0 if kw.get("normalize", True) else 255.0
        print(f"preprocess_frames {kw}: {got.shape}, card vs CPU max|d| {d:.3e} "
              f"(bar {1e-5 * scale:g})")
        require(got.shape == want.shape and d <= 1e-5 * scale,
                "preprocess_frames: the card agrees with the CPU")


def prefetch_checks(torch, dev, trace_dir, n=100) -> None:
    """DevicePrefetcher over ``n`` 640x480 uint8 frames: the source's order
    and bytes; under the profiler, its host-to-device copies on its side
    stream, not on the stream that consumes them."""
    from opticalflowcontainer_tpu_torch.runtime.prefetch import DevicePrefetcher

    rng = np.random.default_rng(22)
    frames = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8) for _ in range(n)]
    t0 = time.perf_counter()
    got = [x.float().mean() for x in DevicePrefetcher(iter(frames), device=dev)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    same = [x.cpu().numpy() for x in DevicePrefetcher(iter(frames), device=dev)]
    require(len(same) == n and all(np.array_equal(a, b) for a, b in zip(same, frames)),
            "the prefetcher yields the source's frames, in order, byte for byte")
    want = [float(f.astype(np.float64).mean()) for f in frames]
    require(all(abs(float(a) - b) < 1e-2 for a, b in zip(got, want)),
            "the consumer read each frame after its copy")
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for x in DevicePrefetcher(iter(frames[:20]), device=dev):
            x.float().mean()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(trace_dir or tmp, "prefetch_trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    h2d = [e["args"].get("stream") for e in events
           if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    kern = {e["args"].get("stream") for e in events if e.get("cat") == "kernel"}
    print(f"DevicePrefetcher, {n} frames 640x480 uint8: order and bytes equal; "
          f"{ms:.3f} ms for the {n} (host clock, a mean a frame); profiled 20 "
          f"frames: {len(h2d)} host-to-device copies recorded (the profiler may "
          f"drop some), on streams {sorted(set(h2d))}; the consumer's kernels on "
          f"streams {sorted(kern)}")
    if not events:
        print("  profiler recorded no device events: the copies' stream not measured")
        return
    # the profiler can miss activity records (PERF.md section 7), so the
    # check is on the copies it recorded: each on the side stream
    require(h2d and not set(h2d) & kern,
            "every recorded copy ran on the side stream, none on the consumer's")



# ------------------------------------------------- phase 25: scale-out

SCALEOUT_TOL = 1e-5  # px: the sharded program against the unsharded one


def max_gap(torch, got, want) -> float:
    return float((torch.as_tensor(got).cpu() - torch.as_tensor(want).cpu()).abs().max())


def scaleout_one_rank(torch, dev, frames, g0, g1, init_method) -> tuple:
    """One NCCL rank in this process, a 1x1 mesh: the three inference legs
    at 1080p and the sharded RAFT-small train step, each against the
    unsharded program.  Returns (the reference results, each leg's K1/K2
    launches)."""
    import copy

    import torch.distributed as dist

    from opticalflowcontainer_tpu_torch.classical import farneback as fb
    from opticalflowcontainer_tpu_torch.parallel import (
        batch_sharding, init_distributed, local_shard, make_mesh,
        make_sharded_flow_fn, make_sharded_stream_fn, make_sharded_train_step,
        make_spatial_sharded_flow_fn)
    from opticalflowcontainer_tpu_torch.parallel.train import (
        TrainState, make_optimizer, train_step)
    from opticalflowcontainer_tpu_torch.tools.train_flow import make_affine_batch

    init_distributed(0, 1, init_method, device_type="cuda")
    by_path = {}
    try:
        mesh = make_mesh(1, data=1, model=1)
        require(dist.get_backend(mesh.get_group("data")) == "nccl",
                "the 1x1 mesh runs NCCL")
        rows = batch_sharding(mesh)
        prev, cur = frames[0::2].contiguous(), frames[1::2].contiguous()
        flow_fn = functools.partial(fb.farneback_batched, device=dev)

        def counted(path, fn):
            reset_counts()
            out = fn()
            torch.cuda.synchronize()
            by_path[path] = kernel_counts()
            return out

        flow_ref = counted("farneback_batched_2x1080p", lambda: flow_fn(prev, cur))
        sharded = make_sharded_flow_fn(flow_fn, mesh)
        flow_s, mean_u = counted("sharded_flow_fn", lambda: sharded(
            local_shard(prev, mesh, rows), local_shard(cur, mesh, rows)))
        d = max_gap(torch, flow_s, flow_ref)
        mean_ref = float(flow_ref[..., 0].mean())
        print(f"sharded flow [2, 1080, 1920], 1x1 NCCL mesh: max|d| {d:.3e} px "
              f"against farneback_batched (bitwise: {bool(torch.equal(flow_s, flow_ref))}; "
              f"bar {SCALEOUT_TOL}); mean_u {float(mean_u):.6f}, the flow's mean "
              f"{mean_ref:.6f}; K1/K2 launches {by_path['sharded_flow_fn']} "
              f"(unsharded {by_path['farneback_batched_2x1080p']})")
        require(d <= SCALEOUT_TOL, "the sharded flow equals the unsharded one")
        require(abs(float(mean_u) - mean_ref) <= 1e-5 * max(abs(mean_ref), 1e-3),
                "mean_u is the flow's mean")
        require(by_path["sharded_flow_fn"] == by_path["farneback_batched_2x1080p"]
                and by_path["sharded_flow_fn"]["farneback_update"] > 0,
                "K1/K2 launch inside the sharded flow fn as in the unsharded call")
        flow_ms = cuda_ms(lambda: sharded(prev, cur), reps=5)
        plain_ms = cuda_ms(lambda: flow_fn(prev, cur), reps=5)
        stats = torch.zeros(2, device=dev)
        coll_ms = cuda_ms(lambda: dist.all_reduce(stats, group=mesh.get_group("data")),
                          reps=20)
        print(f"  sharded {flow_ms:.3f} ms, unsharded {plain_ms:.3f} ms a call "
              f"(events); the all-reduce {coll_ms:.4f} ms, "
              f"{coll_ms / flow_ms:.2%} of the sharded call")

        spatial = make_spatial_sharded_flow_fn(flow_fn, mesh)
        band = batch_sharding(mesh, spatial_dim=1)
        flow_sp = counted("spatial_sharded_flow_fn", lambda: spatial(
            local_shard(prev, mesh, band), local_shard(cur, mesh, band)))
        d = max_gap(torch, flow_sp, flow_ref)
        print(f"spatial-sharded flow, 1x1 mesh: max|d| {d:.3e} px; launches "
              f"{by_path['spatial_sharded_flow_fn']}")
        require(d <= SCALEOUT_TOL, "the spatial-sharded flow equals the unsharded one")
        require(by_path["spatial_sharded_flow_fn"] == by_path["farneback_batched_2x1080p"],
                "K1/K2 launch inside the spatial form as in the unsharded call")

        state = fb.farneback_stream_planes(g0, device=dev)
        flow_st, _ = counted("farneback_stream_step_2x1080p",
                             lambda: fb.farneback_stream_step(state, g1, device=dev))
        du_ref = flow_st[..., 0].mean(dim=(1, 2))
        stream = make_sharded_stream_fn(mesh)
        du, _ = counted("sharded_stream_fn", lambda: stream(state, g1))
        d = max_gap(torch, du, du_ref)
        print(f"sharded stream, 2 streams at 1080p: du {du.tolist()}, max|d| "
              f"{d:.3e} px against farneback_stream_step; launches "
              f"{by_path['sharded_stream_fn']}")
        require(d <= SCALEOUT_TOL, "the sharded stream's du equals the step's")
        require(by_path["sharded_stream_fn"] == by_path["farneback_stream_step_2x1080p"]
                and by_path["sharded_stream_fn"]["blur_solve"] > 0,
                "K1/K2 launch inside the sharded stream fn")
        stream_ms = cuda_ms(lambda: stream(state, g1), reps=5)
        print(f"  sharded stream {stream_ms:.3f} ms a step (events)")

        # the sharded train step on RAFT-small at full width against the
        # plain train_step on the same batches: step by step from the same
        # state (the plain state loaded from the sharded one before each
        # step) with deterministic algorithms, so that the two updates
        # differ by the step's code alone; then both free-running from the
        # init, in the default algorithms, beside a second plain run, whose
        # gap to the first is the backward's own noise (cuDNN's weight
        # gradients and the lookup's scatter-adds sum in no fixed order)
        model = trainer_init(torch, "raft_small", dev)
        n_params = sum(p.numel() for p in model.parameters())
        init = copy.deepcopy(model.state_dict())

        def fresh():
            m = trainer_init(torch, "raft_small", dev)
            m.load_state_dict(init)
            return TrainState(m, make_optimizer(dict(m.named_parameters())))

        tstate = TrainState(model, make_optimizer(dict(model.named_parameters())))
        step = make_sharded_train_step(tstate, mesh, iters=8)
        plain = fresh()
        rng = np.random.default_rng(29)
        batches = [make_affine_batch(rng, 8, 96, 128) for _ in range(5)]
        gaps, param_gaps, losses = [], [], []
        with deterministic_algorithms(torch):
            for b in batches:
                plain.model.load_state_dict(tstate.model.state_dict())
                plain.optimizer.load_state_dict(tstate.optimizer.state_dict())
                tstate, loss = step(tstate, b)
                plain, ploss = train_step(plain, b, iters=8)
                losses.append(float(loss))
                gaps.append(abs(float(loss) - float(ploss)) / abs(float(ploss)))
                # the updates where the gradient is above 1e-3 of the largest
                # (elsewhere Adam's step is lr times the sign of rounding noise)
                named = dict(plain.model.named_parameters())
                gmax = max(float(p.grad.abs().max()) for p in tstate.model.parameters())
                param_gaps.append(max(
                    float(torch.where(p.grad.abs() > 1e-3 * gmax,
                                      (p.detach() - named[n].detach()).abs(), 0.0).max())
                    for n, p in tstate.model.named_parameters()))
        free = [fresh(), fresh()]
        free_losses = [[float(train_step(s, b, iters=8)[1]) for b in batches]
                       for s in free]
        drift = [abs(a - c) / abs(c) for a, c in zip(losses, free_losses[0])]
        noise = [abs(a - c) / abs(c) for a, c in zip(*free_losses)]
        print(f"sharded train step, RAFT-small ({n_params} parameters), B=8, "
              f"96x128, iters=8: losses {[round(x, 5) for x in losses]}; step "
              f"by step from the same state, relative gaps to train_step "
              f"{[f'{g:.1e}' for g in gaps]} (bar 1e-5), largest update gap "
              f"{max(param_gaps):.1e} (bar 1e-6); free-running, sharded vs plain "
              f"{[f'{g:.1e}' for g in drift]}, plain vs plain "
              f"{[f'{g:.1e}' for g in noise]}")
        require(n_params == 990162, "RAFT-small at full width")
        require(all(np.isfinite(losses)) and max(gaps) <= 1e-5,
                "each sharded loss within 1e-5 of train_step's")
        require(max(param_gaps) <= 1e-6, "each sharded update equals train_step's")
        b = batches[0]
        t_sh = cuda_ms(lambda: step(tstate, b), reps=3, warmup=1)
        t_pl = cuda_ms(lambda: train_step(free[0], b, iters=8), reps=3, warmup=1)
        bucket = torch.zeros(n_params + 1, device=dev)
        t_ar = cuda_ms(lambda: dist.all_reduce(bucket, group=mesh.get_group("data")),
                       reps=20)
        print(f"  sharded step {t_sh:.2f} ms, train_step {t_pl:.2f} ms (events); "
              f"the gradient all-reduce {t_ar:.4f} ms, {t_ar / t_sh:.2%} of the step")
    finally:
        dist.destroy_process_group()
    return {"flow": flow_ref, "du": du_ref}, by_path


def scaleout_two_ranks(torch, frames, g0, g1, ref) -> None:
    """Two spawned ranks on the one card (gloo: NCCL refuses two ranks on
    one device), meshes (2, 1) and (1, 2) through the three inference
    legs, each against the 1-rank results."""
    from opticalflowcontainer_tpu_torch.parallel.dryrun import spawn

    host = lambda t: t.cpu().numpy()  # noqa: E731
    fb_kw = {}
    payload = {"meshes": [(2, 1), (1, 2)], "reps": 3,
               "flow": {"kw": fb_kw, "prev": host(frames[0::2]), "cur": host(frames[1::2])},
               "spatial": {"kw": fb_kw, "prev": host(frames[0::2]), "cur": host(frames[1::2])},
               "stream": {"kw": fb_kw, "g0": host(g0), "g1": host(g1)}}
    t0 = time.perf_counter()
    ranks = spawn(2, "infer", payload, cpu=False, backend="gloo", threads=None,
                  timeout_s=300)
    print(f"two ranks on one card (gloo), spawned and run in "
          f"{time.perf_counter() - t0:.1f} s")
    want = {"flow": host(ref["flow"]), "du": host(ref["du"])}
    for i, (data, model) in enumerate(payload["meshes"]):
        per = [r[i] for r in ranks]
        # rebuild the global arrays: batch rows on data; a model group's
        # ranks hold the same rows
        firsts = [per[r * model] for r in range(data)]
        flow = np.concatenate([p["flow"] for p in firsts])
        spatial = np.concatenate([p["spatial"] for p in firsts])
        du = np.concatenate([p["du"] for p in firsts])
        gaps = {"flow": float(np.abs(flow - want["flow"]).max()),
                "spatial": float(np.abs(spatial - want["flow"]).max()),
                "stream": float(np.abs(du - want["du"]).max())}
        mean_u = [p["mean_u"] for p in per]
        print(f"mesh ({data}, {model}): max|d| against one rank {gaps}; mean_u "
              f"{mean_u}; K1/K2 launches by rank {[p['launches'] for p in per]}")
        for r, p in enumerate(per):
            print(f"  rank {r}: ms {p['ms']}, collectives alone "
                  f"{p['collective_ms']}")
        require(max(gaps.values()) <= SCALEOUT_TOL,
                f"mesh ({data}, {model}) equals the one-rank result")
        require(all(abs(m - float(want["flow"][..., 0].mean())) <= 1e-5
                    * max(abs(float(want["flow"][..., 0].mean())), 1e-3)
                    for m in mean_u), "every rank's mean_u is the global mean")
        require(all(p["launches"][leg]["farneback_update"] > 0 for p in per
                    for leg in ("flow", "spatial", "stream")),
                "K1/K2 launch in every rank's legs")


def scaleout_phase(torch, dev) -> dict:
    """Phase 25, the scale-out on the card: one NCCL rank in process (a 1x1
    mesh) at BASELINE config 5's frames, then two ranks on the one card."""
    H, W = 1080, 1920
    frames = plane_waves(torch, H, W, [(1.25 * t, -0.6 * t) for t in range(4)],
                         seed=31, device=dev)
    g0, g1 = frames[0::2].contiguous(), frames[1::2].contiguous()
    with tempfile.TemporaryDirectory() as tmp:
        ref, by_path = scaleout_one_rank(torch, dev, frames, g0, g1,
                                         f"file://{tmp}/store")
    scaleout_two_ranks(torch, frames, g0, g1, ref)
    return by_path


# ------------------------------------------- phase 26: the stage roofline

def roofline_phase(torch, trace_dir) -> None:
    """Phase 26: tools.stage_roofline at its defaults (720p, T=5, 64 calls
    a graph: a few seconds, so nothing is cut); every leg finite, the
    measured ceilings below the data sheet, no stage above 105% of the
    measured HBM read+write ceiling, unless all it moves in a call (each
    array it reads and writes, once) fits in the L2: replayed, such a
    stage is served from the L2 and is held to the L2's ceiling."""
    from opticalflowcontainer_tpu_torch.tools import stage_roofline as sr

    out_dir = trace_dir or tempfile.mkdtemp()
    path = os.path.join(out_dir, "stage_roofline.json")
    if os.path.exists(path):
        os.remove(path)
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        sr.main(["--out", path])
    with open(path) as f:
        legs = [json.loads(line) for line in f]
    by = {leg["leg"]: leg for leg in legs}
    print(f"stage roofline: {len(legs)} legs ({by['device']['card']}, "
          f"graph replay, {by['device']['reps']} calls a graph)")
    numbers = [v for leg in legs for k, v in leg.items()
               if isinstance(v, float)]
    require(all(np.isfinite(numbers)), "every leg finite")
    ds = sr.DATASHEET
    ceil = {k: by[f"ceiling_{k}"] for k in ("read_128mb", "read_512mb",
                                          "read_1024mb", "rw_256mb",
                                          "rw_l2_16mb", "matmul_fp32",
                                          "matmul_tf32", "matmul_bf16",
                                          "fma_fp32")}
    for k, leg in ceil.items():
        rate = leg.get("gbps", leg.get("tflops"))
        unit = "GB/s" if "gbps" in leg else "TFLOP/s"
        print(f"  ceiling {k}: {rate:.1f} {unit} ({leg['ms_per_rep']:.4f} ms a rep)")
    for k in ("read_128mb", "read_512mb", "read_1024mb", "rw_256mb"):
        require(ceil[k]["gbps"] < ds["hbm_gbps"], f"{k} below the data sheet")
    for k, sheet in (("matmul_fp32", "fp32_tflops"), ("matmul_tf32", "tf32_tflops"),
                     ("matmul_bf16", "bf16_tflops"), ("fma_fp32", "fp32_tflops")):
        require(ceil[k]["tflops"] < ds[sheet], f"{k} below the data sheet")
    hbm, l2 = ceil["rw_256mb"]["gbps"], ceil["rw_l2_16mb"]["gbps"]
    l2_mb = by["device"]["l2_mb"]
    stages = [leg for leg in legs if leg["leg"].split("_")[0] in
              ("poly", "update", "solve", "resize", "full")]
    total = by["full_clip"]["ms"]
    over = []
    for leg in stages:
        print(f"  {leg['leg']:10s} {leg['ms']:.4f} ms ({leg['ms'] / total:.1%} of "
              f"the clip call), {leg['model_mb']:.1f} MB, {leg['gbps']:.1f} GB/s: "
              f"{leg['gbps'] / hbm:.1%} of the measured HBM read+write ceiling, "
              f"{leg['gbps'] / l2:.1%} of the L2's, {leg['of_datasheet']:.1%} of "
              f"the data sheet")
        if leg["gbps"] > 1.05 * (l2 if leg["model_mb"] <= l2_mb else hbm):
            over.append(leg["leg"])
    require(not over, f"no stage above 105% of the measured read+write ceiling: "
                      f"the HBM's, the L2's where all it moves fits in the "
                      f"{l2_mb:.1f} MB L2 ({over})")


def main() -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", metavar="DIR",
                    help="write the profiled clip call, stream steps, model "
                         "estimates and model stream steps as Chrome traces "
                         "into DIR")
    ap.add_argument("--variants", action="store_true",
                    help="instead of the phases after the build, time the "
                         "launch choices of K3, K2 and K4 apart and print "
                         "them as one JSON line")
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
    if args.variants:
        with phase("variants of K3, K2 and K4"):
            times = variants_phase(torch, dev)
        print(json.dumps({"variants": times}))
        return 0
    with phase("2 K1 farneback_update vs plain"):
        k1 = k1_phase(torch, dev)
    with phase("3 K2 blur_solve vs plain"):
        k2 = k2_phase(torch, dev)
    with phase("4 720p T=7 clip (main path)"):
        by_path = {"farneback_clip": clip_phase(torch, dev, args.trace)}
    with phase("5 640x480 stream"):
        stream_phase(torch, dev, args.trace)
    with phase("6 K3 warp_bilinear vs plain"):
        k3 = k3_phase(torch, dev)
    with phase("7 K4 local_correlation vs plain"):
        k4 = k4_phase(torch, dev)
    with phase("8 PWC-Net 640x480 (correlation path)"):
        by_path["pwcnet"] = pwc_phase(torch, dev, args.trace)
    with phase("9 LiteFlowNet3 640x480"):
        by_path["liteflownet3"] = lfn_phase(torch, dev, args.trace, three=True)
    with phase("10 LiteFlowNet 640x480"):
        by_path["liteflownet"] = lfn_phase(torch, dev, args.trace, three=False)
    with phase("11 LFN3 FusedModelStream 640x480"):
        by_path["liteflownet3_stream"] = model_stream_phase(torch, dev, args.trace)
    with phase("12 node graph 640x480 (demo, bringup_flow)"):
        by_path.update(node_phase(torch, dev))
    with phase("13 MultiStreamFlow 2x1080p at 60 fps"):
        by_path.update(batcher_phase(torch, dev, args.trace))
    with phase("14 LFN3 JunctionMaskFlowNode 640x480"):
        by_path.update(junction_phase(torch, dev, args.trace))
    with phase("15 measure_stream_latency 640x480"):
        latency_phase(torch, dev)
    with phase("16 Lucas-Kanade 640x480 (calc_optical_flow_pyr_lk, LKVelocityNode)"):
        lk_phase(torch, dev, args.trace)
    with phase("17 RAFT-small 640x480 (estimate, FusedModelStream)"):
        raft_phase(torch, dev, args.trace, large=False)
    with phase("18 RAFT 640x480"):
        raft_phase(torch, dev, args.trace, large=True)
    with phase("19 NeuFlowLite 640x480 (estimate, FusedModelStream, demo)"):
        by_path.update(neuflow_phase(torch, dev, args.trace, v2=False))
    with phase("20 NeuFlow-v2 768x432 (estimate, FusedModelStream)"):
        by_path.update(neuflow_phase(torch, dev, args.trace, v2=True))
    with phase("21 bf16 serving, seven families (FusedModelStream(bf16=True))"):
        by_path.update(bf16_phase(torch, dev))
    with phase("22 offline eval and tools (run_eval, run_pair, fish_speed, zoo_latency)"):
        by_path.update(eval_phase(torch, dev))
    with phase("23 training (K3/K4 backward, train_flow.main for seven families)"):
        by_path.update(training_phase(torch, dev))
    with phase("24 junction pipeline 640x480"):
        by_path.update(junction_pipeline_phase(torch, dev, args.trace))
    with phase("25 scale-out (1-rank NCCL mesh at 2x1080p and RAFT-small, two ranks on one card)"):
        by_path.update(scaleout_phase(torch, dev))
    with phase("26 stage roofline 720p T=5 (measured ceilings)"):
        roofline_phase(torch, args.trace)
    # each path's counts were set to 0 just before its run and read after
    for k in (k1, k2, k3, k4):
        k["launches_by_path"] = {p: n[k["name"]] for p, n in by_path.items()
                                 if n.get(k["name"])}
        k["launches"] = sum(k["launches_by_path"].values())
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [k1, k2, k3, k4]}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
