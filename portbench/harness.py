"""One run of one cell: set-up, the measured window, the trace's reduction
to the per-layer metrics, and the check of the window's answers against
the plain reference.  ``run.py`` is the command; tests drive
:func:`run_cell` on the CPU with a small cell and a broken program."""
from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
import sys
import time
import types

import numpy as np
import torch

from . import counts as counts_mod
from .trace import traced

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
# compared with each loaded module's top-level name, whole
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "opticalflowcontainer_tpu"})


def load_benchmark(path=ROOT / "BENCHMARK.json") -> dict:
    return json.loads(pathlib.Path(path).read_text())


def _json(root: pathlib.Path, kind: str, name: str) -> dict:
    return json.loads((root / kind / f"{name}.json").read_text())


def cell_spec(bench: dict, name: str, root: pathlib.Path = HERE) -> dict:
    """Everything one cell needs, found by name under ``root``: its entry in
    ``BENCHMARK.json``, its configuration and traffic files, its
    correctness limits, and the metrics it reports."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[name]
    limits_file = root / "cells" / f"{name}.json"
    return {
        "name": name, "chips": cell["chips"], "root": root,
        "config_name": cell["config"],
        "config": _json(root, "configs", cell["config"]),
        "traffic": _json(root, "traffic", cell["traffic"]),
        "limits": (json.loads(limits_file.read_text())["limits"]
                   if limits_file.exists() else {}),
        "end_to_end": [m["name"] for m in bench["end_to_end"]
                       if name in m.get("workloads", [name])],
        "per_layer": [m["name"] for m in bench["per_layer"]
                      if name in m.get("workloads", [name])],
        "units": {m["name"]: m["unit"]
                  for m in bench["end_to_end"] + bench["per_layer"]},
    }


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's (``opticalflowcontainer_tpu_torch`` is not)."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in list(modules) if m.split(".")[0] in FORBIDDEN)


def reader(metric: str, root: pathlib.Path = HERE):
    """The reader of per-layer metric ``metric``: ``metrics/<metric>.py``."""
    path = root / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{metric.replace('.', '__')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Sampler:
    """A seeded uniform sample of ``k`` of the window's answers."""

    def __init__(self, seed: int, k: int):
        self.rng = np.random.default_rng(seed % (2 ** 63) + 2)
        self.k = k
        self.items: list = []
        self.seen = 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.k:
                self.items[j] = item


def run_window(loop, seconds: float, sampler: Sampler) -> dict:
    """Call the loop back to back until ``seconds`` have passed; the window
    ends with the last call's answer."""
    latency = []
    t0 = time.perf_counter()
    t_end = t0
    while t_end - t0 < seconds:
        t = time.perf_counter()
        item = loop.call()
        t_end = time.perf_counter()
        latency.append(t_end - t)
        sampler.offer(item)
    return {"calls": len(latency), "window_s": t_end - t0, "latency_s": latency}


def run_cell(spec: dict, seed: int, seconds: float, trace: bool,
             device: torch.device, system=None, t_start: float | None = None) -> dict:
    """One run; returns the result line's keys but ``device`` (plus
    ``memory_peak_bytes`` and, traced, ``busy_s`` and ``window_s`` for it).

    Every run measures a window of ``seconds`` on the host's clock.  A
    traced run then profiles a second, shorter window: the per-layer
    metrics of the host's clock read the first (the profiler slows the
    host), those of the trace the second."""
    t_start = time.perf_counter() if t_start is None else t_start
    config, traffic = spec["config"], spec["traffic"]
    if system is None:
        system = importlib.import_module(
            f"portbench.systems.{config['system']}").System(config, device)
    loop = importlib.import_module(
        f"portbench.loops.{traffic['loop']}").Loop(system, traffic, seed, device)
    loop.warmup()
    setup_s = time.perf_counter() - t_start
    if device.type == "cuda":
        # the peak reported is the window's: set-up's (cuDNN's timed search
        # of algorithms among it) is no memory the traffic holds
        print(f"portbench: set-up peak {torch.cuda.max_memory_allocated(device)} "
              "bytes", file=sys.stderr)
        torch.cuda.reset_peak_memory_stats(device)

    sampler = Sampler(seed, traffic["check_calls"])
    window = run_window(loop, seconds, sampler)
    host = types.SimpleNamespace(
        fields=window["calls"] * loop.fields_per_call, calls=window["calls"],
        window_s=window["window_s"], latency_s=window["latency_s"],
        enqueue_s=list(getattr(loop, "enqueue_s", [])))
    attempted = host.fields
    if trace:
        with traced(True) as box:
            traced_window = run_window(loop, traffic["trace_seconds"], sampler)
        summary = box[0]
        # what a per-layer metric's reader gets: the trace summary and the
        # calls and fields of its window, the untraced window on the
        # host's clock, the counts, the peaks
        ctx = types.SimpleNamespace(
            trace=summary, calls=traced_window["calls"],
            fields=traced_window["calls"] * loop.fields_per_call, host=host,
            counts=importlib.import_module(
                f"portbench.counts.{config['system']}").counts(config, traffic),
            peak=(counts_mod.peaks(torch.cuda.get_device_name(device))
                  if device.type == "cuda" else None))
        attempted += ctx.fields
        metrics = {}
        for name in spec["per_layer"]:
            value = reader(name, spec["root"])(ctx)
            if value is not None:
                metrics[name] = value
        extra = {"busy_s": summary.busy_s, "window_s": summary.window_s,
                 "breakdown": summary.breakdown()}
    else:
        lat_ms = 1e3 * np.asarray(host.latency_s)
        e2e = {"fields_per_s": host.fields / host.window_s,
               "frame_p95_ms": float(np.percentile(lat_ms, 95)), "setup_s": setup_s}
        # "<metric>.<group>" is <metric> under a bound of its own
        metrics = {name: e2e[name.split(".")[0]] for name in spec["end_to_end"]}
        extra = {}
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    result = {"correct": False, "attempted": attempted, "failed": 0,
              "metrics": {k: {"value": v, "unit": spec["units"][k]}
                          for k, v in metrics.items()}}

    # the reference runs once the window has closed, the peak has been
    # read and the program's state is freed
    for owner in (loop, system):
        if hasattr(owner, "release"):
            owner.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = loop.check(sampler.items)
    checks = {k: {"value": v, "limit": spec["limits"].get(k)}
              for k, v in numbers.items()}
    result["correct"] = bool(checks) and all(
        c["limit"] is not None and np.isfinite(c["value"])
        and c["value"] <= c["limit"] for c in checks.values())
    result["memory_peak_bytes"] = memory_peak
    result.update(extra)
    result["checks"] = checks
    return result


def result_line(result: dict, kind: str, count: int,
                power_limit_w: float | None) -> dict:
    """The printed result: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, in a traced run ``breakdown``, and the numbers
    checked, each beside its limit, last."""
    r = dict(result)
    dev = {"platform": "gpu", "kind": kind, "count": count,
           "memory_peak_bytes": r.pop("memory_peak_bytes"),
           "power_limit_w": power_limit_w}
    for key in ("busy_s", "window_s"):
        if key in r:
            dev[key] = r.pop(key)
    checks = r.pop("checks")
    breakdown = r.pop("breakdown", None)
    line = dict(r, device=dev)
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return line


def check_lines(checks: dict) -> list[str]:
    return [f"check {k}: {c['value']!r} (limit {c['limit']!r})"
            for k, c in checks.items()]
