"""Run one cell of BENCHMARK.json on the card and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (the kernels built or loaded, the weights, the cell's frames made
from the seed, its shapes warmed up) counts as ``setup_s`` from the
process's start; then the window; then the check of a seeded sample of the
window's answers against the plain reference.  The last line of standard
output is the result's JSON; the numbers checked, each with its limit,
are the last lines of standard error and the result's last key.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# no library the port uses may load JAX on its own
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"


def power_limit_w():
    """The card's power limit as nvidia-smi reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             "-i", "0"], capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    spec = harness.cell_spec(harness.load_benchmark(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        print(f"portbench: {args.workload} needs {spec['chips']} CUDA device(s); "
              f"this process sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace),
                              device, t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    line = harness.result_line(result, torch.cuda.get_device_name(device),
                               spec["chips"], power_limit_w())
    for text in harness.check_lines(line["checks"]):
        print(text, file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
