"""The port's still-pair tools, ``zoo_latency`` and ``monitor`` against the
JAX package's, on PNGs that cv2 wrote (the JAX CLIs' own oracles are in
``tests/test_aux_capabilities.py``).

Bars: the ``.flo`` written by ``run_pair`` within 1e-4 px of the JAX
CLI's (the JAX Farneback runs jitted; its luma rounds differently in
~1e-5 px) and its HSV PNG within 1 grey level; ``fish_speed``'s printed
lines equal and its ROI overlays bit-equal, its flow image within 1 grey
level; ``summarize_accel`` equal."""
import contextlib
import io
import json
import os

import cv2
import numpy as np
import pytest
import torch

from opticalflowcontainer_tpu.tools import fish_speed as jfish
from opticalflowcontainer_tpu.tools import monitor as jmonitor
from opticalflowcontainer_tpu.tools import run_pair as jrun_pair
from opticalflowcontainer_tpu.utils import read_flo as jread_flo
from opticalflowcontainer_tpu_torch.eval import run_eval
from opticalflowcontainer_tpu_torch.tools import fish_speed as pfish
from opticalflowcontainer_tpu_torch.tools import monitor as pmonitor
from opticalflowcontainer_tpu_torch.tools import run_pair as prun_pair
from opticalflowcontainer_tpu_torch.tools import zoo_latency
from opticalflowcontainer_tpu_torch.utils import read_flo

from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Two 100x140 frames of one blurred texture, the second's window 3 px
    to the right (the content moves -3 px in x)."""
    d = tmp_path_factory.mktemp("pair")
    rng = np.random.default_rng(0)
    base = cv2.GaussianBlur(rng.uniform(0, 255, (140, 180)).astype(np.float32), (0, 0), 2)
    f1 = np.repeat(base[10:110, 10:150, None], 3, -1).astype(np.uint8)
    f2 = np.repeat(base[10:110, 13:153, None], 3, -1).astype(np.uint8)
    p1, p2 = str(d / "a.png"), str(d / "b.png")
    cv2.imwrite(p1, f1)
    cv2.imwrite(p2, f2)
    return d, p1, p2


def _run(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def test_run_pair_matches_the_jax_cli(pair):
    d, p1, p2 = pair
    outs = {}
    for tag, main in (("j", jrun_pair.main), ("p", prun_pair.main)):
        _run(main, [p1, p2, "--out-flo", str(d / f"{tag}.flo"),
                    "--out-png", str(d / f"{tag}.png"), "--cpu"])
        outs[tag] = (str(d / f"{tag}.flo"), cv2.imread(str(d / f"{tag}.png")))
    want, got = jread_flo(outs["j"][0]), read_flo(outs["p"][0])
    assert got.shape == want.shape == (100, 140, 2)
    assert np.abs(got - want).max() <= 1e-4
    assert abs(got[20:-20, 20:-20, 0].mean() + 3.0) < 0.3
    diff = np.abs(outs["p"][1].astype(int) - outs["j"][1].astype(int))
    assert outs["p"][1].shape == (100, 140, 3) and diff.max() <= 1


def test_estimate_pair_goes_through_the_eval_factory(monkeypatch):
    """Every method is built by run_eval._make_method (so --ckpt and the
    packaged weights are honoured) and gets RGB floats in [0, 1]."""
    seen = {}

    def fake_make(name, ckpt, quick, device=None):
        seen.update(name=name, ckpt=ckpt, device=device)

        def run(i1, i2):
            seen["rgb01"] = i1.dtype == np.float32 and i1.max() <= 1.0
            seen["channel_order_ok"] = i1[..., 2].mean() > i1[..., 0].mean()
            return np.zeros(i1.shape[:2] + (2,), np.float32)

        return run

    monkeypatch.setattr(run_eval, "_make_method", fake_make)
    img = np.zeros((24, 32, 3), np.uint8)
    img[..., 0] = 200  # BGR blue
    out = prun_pair.estimate_pair(img, img, "raft", "cand.npz", on_cpu=True)
    assert seen == {"name": "raft", "ckpt": "cand.npz", "device": "cpu",
                    "rgb01": True, "channel_order_ok": True}
    assert out.shape == (24, 32, 2)


def test_fish_speed_matches_the_jax_cli(pair):
    d, p1, p2 = pair
    text = {}
    for tag, main in (("j", jfish.main), ("p", pfish.main)):
        out = _run(main, [p1, p2, "--dt", "0.1", "--pixel-to-meter", "0.001",
                          "--out-prefix", str(d / f"fs{tag}"), "--cpu"])
        text[tag] = [line for line in out.splitlines() if not line.startswith("wrote")]
    assert text["p"] == text["j"] and any("ROI speed" in t for t in text["p"])
    for part in ("_one", "_two"):
        assert np.array_equal(cv2.imread(str(d / f"fsp{part}.png")),
                              cv2.imread(str(d / f"fsj{part}.png")))
    flow_j, flow_p = (cv2.imread(str(d / f"fs{t}_flow.png")).astype(int) for t in "jp")
    assert np.abs(flow_p - flow_j).max() <= 1


def test_fish_speed_refuses_an_roi_outside_the_image(pair):
    _, p1, p2 = pair
    with pytest.raises(SystemExit, match="not inside"):
        pfish.main([p1, p2, "--roi", "100", "10", "50", "20", "--cpu"])


def test_zoo_latency_quick_cpu_rows(capsys):
    rows = zoo_latency.main(["--quick", "--cpu", "--models", "pwcnet,neuflow_lite"])
    assert [json.loads(line) for line in capsys.readouterr().out.splitlines()] == rows
    assert [r["model"] for r in rows] == ["pwcnet", "neuflow_lite"]
    for r in rows:
        assert (r["height"], r["width"], r["dtype"]) == (96, 128, "fp32")
        assert r["timer"] == "wall" and r["unreliable"] is False
        assert r["device_ms_per_frame"] > 0 and r["weights"] == "packaged"
        assert (r["reps"], r["rounds"]) == (4, 1)


def test_zoo_latency_quick_keeps_explicit_reps(monkeypatch):
    """--quick no longer overrides --reps / --rounds: one first call, two
    warm-up calls, then reps x rounds timed calls."""
    from opticalflowcontainer_tpu_torch.models import neuflow

    calls = []
    real = neuflow.estimate
    monkeypatch.setattr(neuflow, "estimate", lambda *a, **k: calls.append(1) or real(*a, **k))
    rows = zoo_latency.main(["--quick", "--cpu", "--models", "neuflow_lite",
                             "--reps", "3", "--rounds", "2"])
    assert (rows[0]["reps"], rows[0]["rounds"]) == (3, 2)
    assert len(calls) == 1 + 2 + 3 * 2


def test_timing_that_falls_back_is_flagged_unreliable(monkeypatch):
    """On the card a call that cannot be captured in a CUDA graph is timed
    by CUDA events, and the row says so."""
    def no_graph(fn, reps, rounds):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(run_eval, "_graph_ms", no_graph)
    monkeypatch.setattr(run_eval, "_events_ms", lambda fn, reps, rounds: 2.5)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    t = run_eval.time_call(lambda: None, torch.device("cuda", 0), reps=3)
    assert t == {"ms": 2.5, "timer": "cuda_events", "unreliable": True}
    monkeypatch.setattr(run_eval, "_graph_ms", lambda fn, reps, rounds: 1.5)
    t = run_eval.time_call(lambda: None, torch.device("cuda", 0), reps=3)
    assert t == {"ms": 1.5, "timer": "cuda_graph", "unreliable": False}


def test_summarize_accel_equals_jax(tmp_path):
    from opticalflowcontainer_tpu_torch.runtime import tracing

    stop = tracing.start_memory_monitor(str(tmp_path / "port.log"), interval=0.01)
    stop()
    (tmp_path / "a.log").write_text(
        "timestamp,device,bytes_in_use,peak_bytes_in_use,bytes_limit\n"
        "1.0,cuda:0,1000000,2000000,80000000000\n"
        "2.0,cuda:0,3000000,5000000,80000000000\n"
        "2.5,cuda:1,7000000,7000000,None\n"
        "3.0,cuda:0,None,None,None\n"
        "3.5,cuda:0,garbled\n"
        "4.0,cuda:1,1000000,9000000,bad\n")
    (tmp_path / "b.log").write_text(
        "timestamp,device,bytes_in_use,peak_bytes_in_use,bytes_limit\n"
        "5.0,cuda:0,4000000,6000000,80000000000\n")
    paths = [str(tmp_path / n) for n in ("port.log", "a.log", "b.log")]
    got = pmonitor.summarize_accel(paths)
    assert got == jmonitor.summarize_accel(paths)
    assert [r["samples"] for r in got] == [3, 2]
    assert pmonitor.main(["--summarize-accel"] + paths) == 0


def test_monitor_samples_a_process(tmp_path):
    import subprocess
    import sys

    child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(5)",
                              "ofc_monitor_probe"])
    try:
        assert pmonitor.main(["ofc_monitor_probe", "--duration", "0.35",
                              "--interval", "0.1", "--out-dir", str(tmp_path)]) == 0
    finally:
        child.kill()
        child.wait()
    log = tmp_path / f"cpu_usage_ofc_monitor_probe_{child.pid}.log"
    assert log.exists(), os.listdir(tmp_path)
    lines = log.read_text().splitlines()
    assert lines[0] == "timestamp,cpu_pct,rss_mb" and len(lines) >= 3
