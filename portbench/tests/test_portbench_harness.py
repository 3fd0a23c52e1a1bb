"""The benchmark's files and rules: every workload, configuration, traffic
mix, limit and metric reader is found by name and valid; the name and unit
rules; each per-layer metric's cells report the metric it moves; the
import check on whole top-level names; the result line's keys; the command
without a card; and a cell, a configuration and a metric added as new
files only."""
import json
import math
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import harness

HERE = pathlib.Path(__file__).resolve().parents[1]
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert TEXT.match(word) and not word.startswith("/") and ".." not in word
    assert (ROOT / BENCH["command"][1]).is_file()
    assert BENCH["command"][1].startswith("portbench/")


def test_run_seconds_fit_a_full_check_of_24_cells():
    s = BENCH["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_texts():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
             + [w["config"] for w in BENCH["workloads"]]
             + [w["traffic"] for w in BENCH["workloads"]])
    for n in names:
        assert NAME.match(n), n
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [x["name"] for x in BENCH[group]]
        assert len(seen) == len(set(seen)), group
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert TEXT.match(c["why"]) and TEXT.match(c["source"])
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_configs_are_files_under_paths_each_used():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert (HERE / "systems" / f"{cfg['system']}.py").is_file()
        assert (HERE / "counts" / f"{cfg['system']}.py").is_file()
        files.add(c["file"])
        assert c["name"] in used
    assert len(files) == len(BENCH["configs"])


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_is_found_by_name_and_valid(cell):
    spec = harness.cell_spec(BENCH, cell)
    tr = spec["traffic"]
    assert (HERE / "loops" / f"{tr['loop']}.py").is_file()
    assert spec["chips"] == 1
    assert "setup_s" in spec["end_to_end"] and len(spec["end_to_end"]) >= 2
    assert spec["per_layer"]
    for m in spec["per_layer"]:
        assert callable(harness.reader(m))
    assert spec["limits"] and all(math.isfinite(v) and v > 0
                                  for v in spec["limits"].values())
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_each_per_layer_metrics_cells_report_what_it_moves():
    e2e = {m["name"]: set(m.get("workloads", CELLS)) for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert TEXT.match(m["layer"]) and m["moves"] in e2e
        cells = set(m.get("workloads", e2e[m["moves"]]))
        assert cells <= e2e[m["moves"]], m["name"]
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        if "roofline" in m["name"]:  # <kernel>_roofline[.<cells' group>]
            assert m["name"].split(".")[0].endswith("_roofline") and m["unit"] == "%"
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_import_check_compares_whole_top_level_names():
    mods = {"opticalflowcontainer_tpu_torch": 1,
            "opticalflowcontainer_tpu_torch.models.pwcnet": 1,
            "jaxtyping": 1, "flaxen": 1, "torch": 1,
            "opticalflowcontainer_tpu": 1, "opticalflowcontainer_tpu.models": 1,
            "jax.numpy": 1, "jaxlib": 1, "flax.linen": 1}
    assert harness.forbidden_modules(mods) == [
        "flax.linen", "jax.numpy", "jaxlib", "opticalflowcontainer_tpu",
        "opticalflowcontainer_tpu.models"]


def test_result_line_keys():
    result = {"correct": True, "attempted": 6, "failed": 0,
              "metrics": {"device_idle_share": {"value": 12.5, "unit": "%"}},
              "breakdown": {"device_ops": [], "idle_gaps": []},
              "memory_peak_bytes": 123, "busy_s": 1.5, "window_s": 2.0,
              "checks": {"flow_epe_mean_px": {"value": 1e-6, "limit": 1e-4}}}
    line = harness.result_line(result, "NVIDIA H100 80GB HBM3", 1, 700.0)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device",
                          "breakdown", "checks"]
    assert line["device"] == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                              "count": 1, "memory_peak_bytes": 123,
                              "power_limit_w": 700.0, "busy_s": 1.5,
                              "window_s": 2.0}
    untraced = {k: v for k, v in result.items()
                if k not in ("breakdown", "busy_s", "window_s")}
    assert list(harness.result_line(untraced, "x", 1, None)) == [
        "correct", "attempted", "failed", "metrics", "device", "checks"]
    assert harness.check_lines(line["checks"]) == [
        "check flow_epe_mean_px: 1e-06 (limit 0.0001)"]


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed",
         str(2 ** 31 + 11), "--seconds", "1", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
             "HOME": str(cwd)})


def test_command_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run(ROOT)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "needs 1 CUDA device" in proc.stderr


def test_command_with_only_the_benchmark_files_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""


def test_a_cell_config_and_metric_added_as_new_files_only(tmp_path):
    """A copy of the benchmark's files with new files only (a configuration,
    a traffic mix, the cell's limits, a metric reader and their entries in
    BENCHMARK.json) runs the new cell; no existing file is edited."""
    root = tmp_path / "portbench"
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cfg = json.loads((root / "configs" / "farneback.json").read_text())
    cfg["params"]["iterations"] = 2
    (root / "configs" / "farneback_two_iter.json").write_text(json.dumps(cfg))
    (root / "traffic" / "clip_tiny.json").write_text(json.dumps({
        "loop": "clip", "height": 48, "width": 64, "channels": 1,
        "frames_per_call": 4, "pool": 8, "max_shift_px": 1.0,
        "check_calls": 2, "trace_seconds": 0.3}))
    (root / "cells" / "farneback_two_iter.tiny.json").write_text(json.dumps(
        {"limits": {"flow_epe_mean_px": 1e-3}}))
    (root / "metrics" / "calls_per_field.py").write_text(
        "def read(ctx):\n    return ctx.calls / ctx.fields if ctx.fields else None\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "farneback_two_iter", "source": cfg["source"],
                             "file": "portbench/configs/farneback_two_iter.json",
                             "reduced": [], "why": "two iterations"})
    bench["workloads"].append({"name": "farneback_two_iter.tiny",
                               "config": "farneback_two_iter",
                               "traffic": "clip_tiny", "chips": 1, "why": "tiny"})
    for m in bench["end_to_end"]:
        if m["name"] == "fields_per_s":
            m["workloads"].append("farneback_two_iter.tiny")
    bench["per_layer"].append({"name": "calls_per_field", "unit": "1",
                               "better": "lower", "source": "program_counter",
                               "layer": "harness", "moves": "fields_per_s",
                               "workloads": ["farneback_two_iter.tiny"]})
    spec = harness.cell_spec(bench, "farneback_two_iter.tiny", root)
    assert spec["config"]["params"]["iterations"] == 2
    for trace in (False, True):
        r = harness.run_cell(spec, 2 ** 31 + 3, 0.3, trace, torch.device("cpu"))
        assert r["correct"], r["checks"]
        assert set(r["metrics"]) == ({"calls_per_field"}
                                     if trace else {"fields_per_s", "setup_s"})
    assert r["metrics"]["calls_per_field"]["value"] == pytest.approx(1 / 3)
    assert {p: p.read_bytes() for p in before} == before


@pytest.mark.gpu
def test_each_cell_runs_correct_on_the_card(cuda_device):
    for cell in CELLS:
        proc = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
             str(2 ** 31 + 5), "--seconds", "2", "--trace", "0"],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-2000:]
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        assert line["correct"] and line["device"]["platform"] == "gpu", line


def test_a_traced_run_reads_the_host_clock_from_its_untraced_window(tmp_path):
    """A traced run measures the untraced window first; a per-layer metric
    of the host's clock reads it (``ctx.host``), one of the trace reads the
    shorter profiled window after it."""
    root = tmp_path / "portbench"
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns("__pycache__"))
    (root / "metrics" / "host_window_s.py").write_text(
        "def read(ctx):\n    return ctx.host.window_s\n")
    bench = json.loads(json.dumps(BENCH))
    cell = "farneback.clip720p_t7"
    bench["per_layer"].append({"name": "host_window_s", "unit": "s",
                               "better": "lower", "source": "host_clock",
                               "layer": "harness", "moves": "fields_per_s.host_paced",
                               "workloads": [cell]})
    spec = harness.cell_spec(bench, cell, root)
    spec["traffic"].update(height=48, width=64, frames_per_call=4, pool=8,
                           check_calls=2, trace_seconds=0.2)
    r = harness.run_cell(spec, 2 ** 31 + 7, 0.8, True, torch.device("cpu"))
    assert r["correct"], r["checks"]
    assert r["metrics"]["host_window_s"]["value"] >= 0.8
    assert 0.2 <= r["window_s"] < 0.8
    assert r["metrics"]["device_idle_share.host_paced"]["value"] == pytest.approx(100.0)
