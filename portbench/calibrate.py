"""Readings for a cell's correctness limits, on the card:

    python3 portbench/calibrate.py --workload <cell> --seeds 12 --control-seeds 3

In one process (the program's model and kernels are set up once), for each
seed a short window at the cell's own load through the timed path, then
the run's check against the plain reference; then the same with the
control (the reference in the next precision below the configuration's,
``System.use_control``) in the program's place.  Prints one JSON line per
run and a summary: the program's largest reading (the lower) and the
control's smallest (the upper).  The benchmark's own runs never run this.
"""
import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)

    import importlib

    import torch

    from portbench import harness

    spec = harness.cell_spec(harness.load_benchmark(), args.workload)
    device = torch.device("cuda", 0)
    mod = importlib.import_module(f"portbench.systems.{spec['config']['system']}")
    system = mod.System(spec["config"], device)
    readings = {"program": [], "control": []}
    seed = args.first_seed
    for kind, n in (("program", args.seeds), ("control", args.control_seeds)):
        if kind == "control":
            system.use_control()
        for _ in range(n):
            seed += 1
            t = time.perf_counter()
            loop = importlib.import_module(
                f"portbench.loops.{spec['traffic']['loop']}").Loop(
                    system, spec["traffic"], seed, device)
            loop.warmup()
            sampler = harness.Sampler(seed, spec["traffic"]["check_calls"])
            window = harness.run_window(loop, args.seconds, sampler)
            numbers = loop.check(sampler.items)
            readings[kind].append(numbers)
            print(json.dumps({"kind": kind, "seed": seed, "calls": window["calls"],
                              "numbers": numbers,
                              "seconds": time.perf_counter() - t}), flush=True)
    summary = {}
    for name in readings["program"][0]:
        summary[name] = {
            "lower": max(r[name] for r in readings["program"]),
            "upper": min((r[name] for r in readings["control"]), default=None),
            "program": [r[name] for r in readings["program"]],
            "control": [r[name] for r in readings["control"]]}
    print(json.dumps({"workload": args.workload, "summary": summary,
                      "kind_of_card": torch.cuda.get_device_name(device)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
