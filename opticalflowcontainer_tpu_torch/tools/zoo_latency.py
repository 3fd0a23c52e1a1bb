"""Model-zoo latency table (the port's copy of the reference's
``tools/zoo_latency.py``): device ms per frame of every learned family at
its reference operating point, fp32 or bf16, one JSON row each.

Operating points, as the reference nodes run them:

- liteflownet / liteflownet3: 640x480 camera frames;
- pwcnet: 448x640 (multiples of 64);
- raft_small / raft_large: 384x512 at 12 iterations;
- neuflow_lite / neuflow_v2: 432x768 (the NeuFlow node's fixed input).

Each call is timed as ``eval.run_eval.time_call`` times it: CUDA-graph
replay of ``--reps`` calls, best of ``--rounds``; a call that cannot be
captured falls back to CUDA events around back-to-back calls and its row
is flagged ``"unreliable": true`` (that time includes the device's waits
for the host).  ``--cpu`` times the CPU by the wall clock.  A family whose
packaged npz is absent runs on seeded weights (``"weights": "seeded"``).

    python -m opticalflowcontainer_tpu_torch.tools.zoo_latency [--bf16]
        [--models raft_small,neuflow_lite] [--reps 48] [--cpu] [--quick]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def _spec(name: str, quick: bool = False):
    """(H, W, model class, packaged-weight loader, step factory) of one
    family; ``factory(model)`` gives ``step(a, b)``, the flow.  ``quick``
    cuts the iterative models to 2 RAFT iterations and 1 NeuFlow-v2
    refinement."""
    from ..models import convert

    if name == "liteflownet":
        from ..models.liteflownet import LiteFlowNet, estimate

        return 480, 640, LiteFlowNet, convert.load_liteflownet_synth, (
            lambda model: lambda a, b: estimate(model, a, b))
    if name == "liteflownet3":
        from ..models.liteflownet3 import LiteFlowNet3, estimate

        return 480, 640, LiteFlowNet3, convert.load_liteflownet3_synth, (
            lambda model: lambda a, b: estimate(model, a, b))
    if name == "pwcnet":
        from ..models.pwcnet import PWCNet, estimate

        return 448, 640, PWCNet, convert.load_pwcnet_synth, (
            lambda model: lambda a, b: estimate(model, a, b))
    if name in ("raft_small", "raft_large"):
        from ..models.raft import RAFT, RAFTSmall, estimate

        cls, load = ((RAFTSmall, convert.load_raft_small_synth)
                     if name == "raft_small" else (RAFT, convert.load_raft_synth))
        iters = 2 if quick else 12
        return 384, 512, cls, load, (
            lambda model: lambda a, b: estimate(model, a, b, iters=iters))
    if name == "neuflow_lite":
        from ..models.neuflow import NeuFlowLite, estimate

        return 432, 768, NeuFlowLite, convert.load_neuflow_lite_synth, (
            lambda model: lambda a, b: estimate(model, a, b))
    if name == "neuflow_v2":
        from ..models.neuflow_v2 import NeuFlowV2, estimate

        iters_s8 = 1 if quick else 8
        return 432, 768, NeuFlowV2, convert.load_neuflow_v2_synth, (
            lambda model: lambda a, b: estimate(model, a, b, iters_s8=iters_s8))
    raise SystemExit(f"unknown model {name!r}")


ALL = ("liteflownet", "liteflownet3", "pwcnet", "raft_small", "raft_large",
       "neuflow_lite", "neuflow_v2")


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", default=",".join(ALL),
                    help="comma list from: " + " ".join(ALL))
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 parameters and inputs (fp32 flow out)")
    ap.add_argument("--reps", type=int, default=None,
                    help="calls a timing round (default 48; 4 with --quick)")
    ap.add_argument("--rounds", type=int, default=None,
                    help="timing rounds, the best kept (default 3; 1 with "
                         "--quick)")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--quick", action="store_true",
                    help="96x128 frames and fewer iterations; fewer reps and "
                         "rounds unless --reps / --rounds are given")
    args = ap.parse_args(argv)

    from ..core.device import resolve_device
    from ..eval.run_eval import seeded_init, time_call
    from ..models.common import cast_params

    device = resolve_device("cpu" if args.cpu else None)
    reps = args.reps if args.reps is not None else (4 if args.quick else 48)
    rounds = args.rounds if args.rounds is not None else (1 if args.quick else 3)
    rng = np.random.default_rng(0)
    rows = []
    for name in args.models.split(","):
        name = name.strip()
        H, W, cls, load, factory = _spec(name, quick=args.quick)
        if args.quick:
            H, W = 96, 128
        model = load(device)
        weights = "packaged"
        if model is None:
            model, weights = seeded_init(cls()).eval().to(device), "seeded"
        if args.bf16:
            cast_params(model, torch.bfloat16)
        step = factory(model)
        base = rng.uniform(0, 1, (H + 8, W + 8, 3)).astype(np.float32)
        i1 = torch.from_numpy(np.ascontiguousarray(base[4:4 + H, 4:4 + W])).to(device)
        i2 = torch.from_numpy(np.ascontiguousarray(base[4:4 + H, 2:2 + W])).to(device)
        t0 = time.perf_counter()
        with torch.inference_mode():
            step(i1, i2).cpu()
        first_s = time.perf_counter() - t0
        t = time_call(lambda: step(i1, i2), device, reps=reps, rounds=rounds)
        row = {
            "model": name, "height": H, "width": W,
            "dtype": "bf16" if args.bf16 else "fp32",
            "device_ms_per_frame": round(t["ms"], 3),
            "fps": round(1000.0 / t["ms"], 1),
            "timer": t["timer"], "unreliable": t["unreliable"],
            "reps": reps, "rounds": rounds,
            "weights": weights, "first_call_s": round(first_s, 2),
            "device": device.type,
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
