"""The port's eval harness (``eval/run_eval.py``) against the JAX
package's ``main()``: the same flags give rows with the same keys and,
on the same pairs, the same accuracy.

Bars: Farneback's EPE, p50 and p95 within 1e-3 px of JAX's and its 1/3/5
px fractions within 2e-3 (the JAX Farneback runs jitted, its luma rounds
differently in ~1e-5 px); each learned method's EPE within 1e-3 px of
JAX's on the packaged npz (RAFT and NeuFlow-v2 with ``--quick``).  Each
JAX row is computed once per module; the checkpoint and bf16 rows are in
``test_torch_run_eval_ckpt.py``."""
import contextlib
import functools
import io
import json

import pytest

from opticalflowcontainer_tpu.eval import run_eval as jrun_eval
from opticalflowcontainer_tpu_torch.eval import run_eval as prun_eval

from test_torch_threads import one_torch_thread  # noqa: F401


def rows(main, argv) -> list[dict]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(list(argv)) == 0
    return [json.loads(line) for line in buf.getvalue().splitlines()
            if line.startswith("{")]


@functools.lru_cache(maxsize=None)
def jax_rows(argv: tuple) -> list[dict]:
    return rows(jrun_eval.main, argv)


def check_rows(argv, epe_tol=1e-3, frac_tol=None):
    want, got = jax_rows(tuple(argv)), rows(prun_eval.main, argv)
    assert len(got) == len(want) == len(argv[argv.index("--method") + 1].split(","))
    for w, g in zip(want, got):
        assert sorted(g) == sorted(w)
        for k in ("method", "dataset", "n", "dtype"):
            assert g[k] == w[k], k
        assert abs(g["epe"] - w["epe"]) <= epe_tol, (g["epe"], w["epe"])
        if frac_tol is not None:
            for k in ("p50", "p95"):
                assert abs(g[k] - w[k]) <= epe_tol, k
            for k in ("1px", "3px", "5px", "fl_all"):
                assert abs(g[k] - w[k]) <= frac_tol, k
    return want, got


def test_farneback_rows_match_jax():
    check_rows(["--method", "farneback", "--n", "2", "--cpu"], 1e-3, 2e-3)


def test_farneback_hard_rows_match_jax():
    check_rows(["--method", "farneback", "--n", "2", "--hard", "--cpu"], 1e-3, 2e-3)


@pytest.mark.parametrize("argv", [
    ["--method", "pwcnet"],
    ["--method", "liteflownet3"],
    ["--method", "raft", "--quick"],
    ["--method", "neuflow_v2", "--quick"],
], ids=lambda a: a[1])
def test_learned_rows_match_jax(argv):
    check_rows(argv + ["--n", "2", "--cpu"])


def test_unknown_method_exits():
    with pytest.raises(SystemExit, match="unknown method"):
        prun_eval.main(["--method", "nope", "--n", "1", "--cpu"])


def test_time_device_row_names_its_timer():
    (row,) = rows(prun_eval.main, ["--method", "farneback", "--n", "1", "--cpu",
                                   "--quick", "--time-device"])
    assert row["timer"] == "wall" and row["unreliable"] is False
    assert row["device_ms_per_frame"] > 0


def test_entry_point_raises_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prun_eval.main(["--method", "farneback", "--n", "1"])
