"""The readers of the program's spans (``portbench/spans.py`` and the eight
``program_span`` metrics) on a hand-built trace summary with known idle
gaps, nested spans and launches; None where the trace holds no such span;
and a traced CPU run of each Farneback cell, shrunk, in a copy of the
benchmark's files, reporting its span metrics."""
import json
import pathlib
import shutil
import types

import pytest
import torch

from portbench import harness
from portbench.spans import Spans
from portbench.trace import WINDOW_SPAN, Summary

HERE = pathlib.Path(__file__).resolve().parents[1]
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
MS = 1_000_000  # ns
SPAN_METRICS = [m["name"] for m in BENCH["per_layer"] if m["source"] == "program_span"]


def _kernels(*intervals_ms):
    return [("k", int(s * MS), int((e - s) * MS), "kernel") for s, e in intervals_ms]


def _host(*events_ms):
    return [(n, int(s * MS), int(e * MS)) for n, s, e in events_ms]


def _clip_summary():
    """A 10 ms window, the card busy at 1-2, 4-5 and 8-9 ms: idle gaps 0-1,
    2-4, 5-8 and 9-10.  Prep spans at 0.5-4.5 (another nested in it) and
    8.5-9.8 hold the midpoints of three gaps, 4 ms of idle, and three of
    the four launches."""
    return Summary(_kernels((1, 2), (4, 5), (8, 9)), (0, 10 * MS), _host(
        (WINDOW_SPAN, 0, 10),
        ("ofc.farneback.prep", 0.5, 4.5), ("ofc.farneback.prep", 2.5, 3.5),
        ("ofc.farneback.prep", 8.5, 9.8), ("ofc.farneback.solve", 5, 8),
        ("cudaLaunchKernel", 0.6, 0.7), ("aten::mul", 1, 1.1),
        ("cudaLaunchKernel", 3, 3.1), ("cudaLaunchKernel", 6, 6.1),
        ("cudaMemcpyAsync", 9, 9.2)))


def _stream_summary():
    """Two frames in a 10 ms window, the card busy at 2-3 and 7-8 ms: steps
    of 3 and 1 ms, forwards holding gaps 1-2 and 6-7 and five launches,
    waits of 0.5 and 1.5 ms."""
    return Summary(_kernels((2, 3), (7, 8)), (0, 10 * MS), _host(
        (WINDOW_SPAN, 0, 10),
        ("ofc.stream.step", 0, 3), ("ofc.model.forward", 1, 2.5),
        ("ofc.stream.wait", 3, 3.5),
        ("ofc.stream.step", 5, 6), ("ofc.model.forward", 5.5, 7.2),
        ("ofc.stream.wait", 7.5, 9),
        *[("cudaLaunchKernel", t, t + 0.01) for t in (1.2, 1.4, 2.2, 5.6, 6.5)],
        ("cudaLaunchKernel", 3.2, 3.3)))


def _ctx(summary, fields=2, calls=2):
    return types.SimpleNamespace(trace=summary, fields=fields, calls=calls)


def test_idle_and_launches_inside_spans_nested_counted_once():
    prep = Spans(_clip_summary(), "ofc.farneback.prep")
    assert prep.idle_s() == pytest.approx(4e-3)
    assert prep.launches() == 3
    assert sorted(prep.lengths_ns) == [1 * MS, 1.3 * MS, 4 * MS]
    solve = Spans(_clip_summary(), "ofc.farneback.solve")
    assert solve.idle_s() == pytest.approx(3e-3) and solve.launches() == 1


@pytest.mark.parametrize("metric, value", [
    ("prep_launches_per_field.farneback", 1.5),
    ("prep_launches_per_field.farneback.host_paced", 1.5),
    ("prep_idle_ms_per_field.farneback", 2.0),
    ("prep_idle_ms_per_field.farneback.host_paced", 2.0),
])
def test_farneback_span_metrics(metric, value):
    assert harness.reader(metric)(_ctx(_clip_summary())) == pytest.approx(value)


@pytest.mark.parametrize("metric, value", [
    ("step_ms.stream", 2.0), ("wait_ms.stream", 1.0),
    ("model_launches.stream", 2.5), ("model_idle_ms.stream", 1.0),
])
def test_stream_span_metrics(metric, value):
    assert harness.reader(metric)(_ctx(_stream_summary())) == pytest.approx(value)


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_no_span_reads_none(metric):
    bare = Summary(_kernels((1, 2)), (0, 10 * MS), _host(
        (WINDOW_SPAN, 0, 10), ("aten::mul", 0.5, 0.6),
        ("cudaLaunchKernel", 0.6, 0.7)))
    assert harness.reader(metric)(_ctx(bare)) is None


def test_the_eight_span_metrics_and_their_cells():
    assert sorted(SPAN_METRICS) == sorted([
        "prep_launches_per_field.farneback",
        "prep_launches_per_field.farneback.host_paced",
        "prep_idle_ms_per_field.farneback",
        "prep_idle_ms_per_field.farneback.host_paced",
        "step_ms.stream", "wait_ms.stream",
        "model_launches.stream", "model_idle_ms.stream"])
    assert BENCH["per_layer"][-len(SPAN_METRICS):] == [
        m for m in BENCH["per_layer"] if m["name"] in SPAN_METRICS]


@pytest.mark.parametrize("cell", ["farneback.clip720p_t7", "farneback.clip1080p_2cam"])
def test_a_traced_cpu_run_reports_the_farneback_span_metrics(cell, tmp_path):
    root = tmp_path / "portbench"
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns("__pycache__"))
    spec = harness.cell_spec(BENCH, cell, root)
    spec["traffic"].update(height=48, width=64, frames_per_call=4, pool=8,
                           check_calls=2, trace_seconds=0.2)
    r = harness.run_cell(spec, 2 ** 31 + 9, 0.2, True, torch.device("cpu"))
    assert r["correct"], r["checks"]
    suffix = ".host_paced" if cell == "farneback.clip720p_t7" else ""
    launches, idle = (f"prep_launches_per_field.farneback{suffix}",
                      f"prep_idle_ms_per_field.farneback{suffix}")
    assert {launches, idle} == {m for m in spec["per_layer"] if m in SPAN_METRICS}
    # no CUDA runtime on the CPU: no launch; the window is one idle gap,
    # put down to prep or not by where its midpoint falls
    assert r["metrics"][launches]["value"] == 0
    assert r["metrics"][idle]["value"] >= 0
