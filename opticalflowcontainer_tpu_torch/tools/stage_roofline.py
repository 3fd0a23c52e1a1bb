"""Per-stage roofline of the port's Farneback pipeline on the card
(reference ``tools/stage_roofline.py``).

The kernels' bounds elsewhere divide bytes by the data sheet's 3.35 TB/s.
This tool measures what the card reaches, then holds each stage of the
720p clip (T=5) against it:

1. **ceilings**: HBM read rate at 128, 512 and 1024 MB and a 256 MB
   read+write chain (every array above the H100's 50 MB L2, so each pass
   comes from device memory), the same read+write chain at 16 MB (inside
   the L2), ``torch.matmul`` rates in fp32, TF32 and bf16, and an fp32
   fused multiply-add chain (a probe compiled at run time by PyTorch's
   jiterator on the card; the same chain in plain PyTorch ops on the CPU);
2. **device time of each stage** at every pyramid level: the prep stage
   (blur, resize, polynomial expansion of the clip's frames), K1, K2, the
   inter-level flow resizes and the whole clip call, each by CUDA-graph
   replay (``reps`` calls captured in one graph, replayed between CUDA
   events, best of three);
3. **GB/s of each stage** from ``classical.farneback.
   farneback_traffic_breakdown``'s bytes (K1's from its inputs' in-bounds
   count), against the measured read+write ceilings and the data sheet.

Each result is one JSON object a line, appended to ``--out`` as it lands
and printed.  The first line names the device (and the card's name and
power limit from nvidia-smi).  ``--cpu`` runs the same legs on the CPU by
the wall clock: a check of the harness, not a device measurement, so
there the ceilings' arrays are 64 times smaller and the matmuls n=512.

    python -m opticalflowcontainer_tpu_torch.tools.stage_roofline --out r.json
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

# NVIDIA's H100 SXM data sheet: HBM bytes/s, dense TFLOP/s
DATASHEET = {"hbm_gbps": 3350.0, "fp32_tflops": 67.0, "tf32_tflops": 495.0,
             "bf16_tflops": 989.0}
FB = dict(pyr_scale=0.5, levels=3, winsize=15, iterations=3, poly_n=5,
          poly_sigma=1.2)
FMA_STEPS = 1024  # fused multiply-adds a value in the FMA chain
FMA_CODE = f"""
template <typename T> T fma_chain(T x) {{
  T a = T(0.999999f), b = T(1e-7f);
  for (int i = 0; i < {FMA_STEPS}; ++i) {{ x = x * a + b; }}
  return x;
}}
"""


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0].strip()


def timer(device: torch.device, reps: int):
    """ms per call of a function: CUDA-graph replay on the card (a call
    that cannot be captured raises), the wall clock on the CPU."""
    from ..eval.run_eval import _graph_ms, _wall_ms

    def ms(fn) -> float:
        fn()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            return _graph_ms(fn, reps, 3)
        return _wall_ms(fn, reps, 3)
    return ms


def fma_chain(device: torch.device):
    """``x -> FMA_STEPS`` dependent fused multiply-adds of each value."""
    if device.type == "cuda":
        return torch.cuda.jiterator._create_jit_fn(FMA_CODE)

    def plain(x):
        y = x.clone()
        for _ in range(FMA_STEPS):
            y.mul_(0.999999).add_(1e-7)
        return y
    return plain


def ceilings(device, ms, emit) -> dict:
    """The measured ceilings: GB/s of reads and of read+write chains, TF/s
    of matmuls and of the FMA chain (on the CPU, a harness check, at a
    64th of the card's sizes)."""
    cpu = device.type == "cpu"
    div = 64 if cpu else 1
    mib = 1 << 20
    got = {}
    # the H100's L2 holds 50 MB: arrays of 128 MB and more are read from
    # device memory on every pass, so these rates are HBM's
    for mb in (128, 512, 1024):
        x = torch.rand(mb * mib // 4 // div, device=device)
        t = ms(lambda: x.sum())
        got[f"read_{mb}mb"] = x.numel() * 4 / t / 1e6
        emit({"leg": f"ceiling_read_{mb}mb", "mb": x.numel() * 4 / mib,
              "ms_per_rep": t, "gbps": got[f"read_{mb}mb"]})
        del x
    # read+write: each pass reads one array and writes another of its
    # size, the pipeline's mix; at 256 MB from HBM, at 16 MB inside the L2
    for mb, name in ((256, "rw_256mb"), (16, "rw_l2_16mb")):
        x = torch.rand(mb * mib // 4 // div, device=device)
        y = torch.empty_like(x)
        t = ms(lambda: torch.mul(x, 1.0000001, out=y))
        got[name] = 2 * x.numel() * 4 / t / 1e6
        emit({"leg": f"ceiling_{name}", "mb": x.numel() * 4 / mib,
              "ms_per_rep": t, "gbps": got[name]})
        del x, y
    n = 512 if cpu else 4096
    for name, dtype, tf32 in (("fp32", torch.float32, False),
                              ("tf32", torch.float32, True),
                              ("bf16", torch.bfloat16, False)):
        a = torch.rand(n, n, device=device).to(dtype)
        b = torch.rand(n, n, device=device).to(dtype)
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            t = ms(lambda: torch.matmul(a, b))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
        got[f"matmul_{name}"] = 2 * n**3 / t / 1e9
        emit({"leg": f"ceiling_matmul_{name}", "n": n, "ms_per_rep": t,
              "tflops": got[f"matmul_{name}"]})
        del a, b
    x = torch.rand((1 << 24) // div, device=device)
    chain = fma_chain(device)
    t = ms(lambda: chain(x))
    got["fma_fp32"] = 2 * FMA_STEPS * x.numel() / t / 1e9
    emit({"leg": "ceiling_fma_fp32", "values": x.numel(),
          "fma_per_value": FMA_STEPS, "ms_per_rep": t,
          "tflops": got["fma_fp32"]})
    return got


def clip_frames(H: int, W: int, T: int, device) -> torch.Tensor:
    """T frames [T, H, W] of a noise texture moving 2 px a frame (the
    reference tool's)."""
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 255, (H + 8, W + 2 * T)).astype(np.float32)
    return torch.from_numpy(np.stack(
        [base[4:4 + H, 2 * t:2 * t + W] for t in range(T)])).to(device)


def stages(device, ms, emit, H: int, W: int, T: int, ceil: dict) -> None:
    """Each stage's device time at every level of the T-frame clip, its
    bytes and its GB/s against the ceilings."""
    from ..classical import farneback as fb
    from ..core.resize import resize_bilinear
    from ..ops.farneback_update import farneback_update
    from ..ops.solve2x2 import blur_solve

    fields = T - 1
    frames = clip_frames(H, W, T, device)
    def breakdown(oob_share=0.0):
        return fb.farneback_traffic_breakdown(
            H, W, FB["levels"], FB["pyr_scale"], FB["iterations"], T,
            oob_share=oob_share)

    bd = breakdown()
    rng = np.random.default_rng(0)

    def shares(gbps: float) -> dict:
        """The rate over the card's ceilings (none for a CPU run)."""
        if device.type != "cuda":
            return {}
        out = {"of_datasheet": gbps / DATASHEET["hbm_gbps"]}
        for name in ("rw_256mb", "rw_l2_16mb"):
            if name in ceil:
                out[f"of_{name}"] = gbps / ceil[name]
        return out

    def stage(leg, fn, n_bytes, **extra):
        """Time ``fn`` and emit its rates."""
        t = ms(fn)
        gbps = n_bytes / t / 1e6
        emit({"leg": leg, **extra, "ms": t, "ms_per_field": t / fields,
              "model_mb": n_bytes / 1e6, "gbps": gbps, **shares(gbps)})

    for i, lv in enumerate(bd["levels"]):
        k, lh, lw = lv["k"], lv["lh"], lv["lw"]
        planes = fb._level_planes(frames, H, W, k, FB["pyr_scale"],
                                  FB["poly_n"], FB["poly_sigma"])
        stage(f"poly_k{k}", lambda: fb._level_planes(
            frames, H, W, k, FB["pyr_scale"], FB["poly_n"], FB["poly_sigma"]),
            T * lv["poly_per_expansion"], lh=lh, lw=lw)
        R0, R1 = planes[:-1], planes[1:]
        u = torch.from_numpy(rng.uniform(-1.5, 1.5, (fields, lh, lw)).astype(
            np.float32)).to(device)
        v = torch.from_numpy(rng.uniform(-1.5, 1.5, (fields, lh, lw)).astype(
            np.float32)).to(device)
        fx = torch.arange(lw, device=device) + u
        fy = torch.arange(lh, device=device)[:, None] + v
        n_inb = int(((fx.floor() >= 0) & (fx.floor() < lw - 1)
                     & (fy.floor() >= 0) & (fy.floor() < lh - 1)).sum())
        n_pix = fields * lh * lw
        oob = 1 - n_inb / n_pix
        stage(f"update_k{k}", lambda: farneback_update(R0, R1, u, v),
              fields * breakdown(oob)["levels"][i]["update_per_iter"], lh=lh,
              lw=lw, oob_share=oob)
        M = farneback_update(R0, R1, u, v)
        stage(f"solve_k{k}", lambda: blur_solve(M, FB["winsize"], False),
              fields * lv["solve_per_iter"], lh=lh, lw=lw)
        del planes, R0, R1, u, v, M

    coarse = bd["levels"][0]
    uv0 = torch.zeros((2, fields, coarse["lh"], coarse["lw"]), device=device)

    def resizes():
        u, v = uv0
        for lv in bd["levels"][1:]:
            u = resize_bilinear(u, (lv["lh"], lv["lw"])) / FB["pyr_scale"]
            v = resize_bilinear(v, (lv["lh"], lv["lw"])) / FB["pyr_scale"]
        return u, v

    stage("resize", resizes,
          fields * sum(lv["resize"] for lv in bd["levels"][1:]))
    stage("full_clip", lambda: fb.farneback_clip(frames, device=device, **FB),
          fields * bd["total"])
    emit({"leg": "model_totals_mb_per_field",
          **{k: bd[k] / 1e6 for k in ("poly", "update", "solve", "resize",
                                      "total")}})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="stage_roofline.json",
                    help="file the JSON lines are appended to")
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--clip", type=int, default=5, help="frames in the clip")
    ap.add_argument("--reps", type=int, default=64,
                    help="calls captured in each timed graph")
    ap.add_argument("--no-ceilings", action="store_true")
    ap.add_argument("--no-stages", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU by the wall clock (a harness check)")
    args = ap.parse_args(argv)
    if args.clip < 2:
        ap.error("--clip needs at least 2 frames")
    from ..core.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    ms = timer(device, args.reps)

    with open(args.out, "a", buffering=1) as out_f:
        def emit(rec: dict) -> None:
            rec["t"] = time.strftime("%H:%M:%S")
            line = json.dumps(rec)
            out_f.write(line + "\n")
            print(line, flush=True)

        head = {"leg": "device", "device": device.type,
                "timer": "cuda_graph" if device.type == "cuda" else "wall",
                "reps": args.reps, "height": args.height, "width": args.width,
                "clip": args.clip}
        if device.type == "cuda":
            head.update(name=torch.cuda.get_device_name(device),
                        card=card_line(),
                        l2_mb=torch.cuda.get_device_properties(
                            device).L2_cache_size / 1e6)
        emit(head)
        ceil = {}
        with torch.inference_mode():
            if not args.no_ceilings:
                ceil = ceilings(device, ms, emit)
            if not args.no_stages:
                stages(device, ms, emit, args.height, args.width, args.clip,
                       ceil)
    return 0


if __name__ == "__main__":
    sys.exit(main())
