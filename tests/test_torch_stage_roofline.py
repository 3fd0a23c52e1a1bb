"""``classical.farneback.farneback_traffic_breakdown`` (the port's own bytes
per field) and ``tools/stage_roofline.py`` on the CPU.

- The prep stage's and the inter-level resizes' counts against the bytes
  the code moves: every aten operation of ``_level_planes`` and of the
  resize is counted under a dispatch mode (its tensor inputs read and its
  output written once; a gather reads what it writes; views move
  nothing), within 1% (the count leaves out the resize weights' few
  hundred bytes).
- K1 and K2 against their hand counts, and against the bytes
  ``chip_smoke.py``'s bounds use at its K1/K2 shapes: 375.2 and 154.8 MB
  at B=6, 720x1280 (K1's inputs rebuilt from chip_smoke's seed: their
  in-bounds count decides R1's reads).
- The tool at a tiny size: every line parses, every leg is there.
"""
import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from opticalflowcontainer_tpu_torch.classical import farneback as tfb
from opticalflowcontainer_tpu_torch.core.resize import resize_bilinear
from opticalflowcontainer_tpu_torch.tools import stage_roofline
from test_torch_threads import one_torch_thread  # noqa: F401


class _Bytes(TorchDispatchMode):
    """Bytes the aten operations under it read and write."""

    def __init__(self):
        super().__init__()
        self.moved = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            outs = [t for t in torch.utils._pytree.tree_leaves(out)
                    if isinstance(t, torch.Tensor)]
            written = sum(t.numel() * t.element_size() for t in outs)
            if func.__name__.startswith("index_select"):
                read = written  # the gathered values (the index is not counted)
            else:
                read = sum(t.numel() * t.element_size() for t in
                           torch.utils._pytree.tree_leaves((args, kwargs))
                           if isinstance(t, torch.Tensor) and t.is_floating_point())
            self.moved += read + written
        return out


def _measured(fn) -> int:
    fn()  # the cached pad and resize tables, outside the count
    with _Bytes() as b:
        fn()
    return b.moved


@pytest.mark.parametrize("H,W,levels,T", [(64, 96, 2, 3), (90, 70, 3, None)])
def test_prep_and_resize_counts_match_the_operations(H, W, levels, T):
    bd = tfb.farneback_traffic_breakdown(H, W, levels, 0.5, 2, T)
    img = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 255, (1, H, W)).astype(np.float32))
    assert len(bd["levels"]) == tfb._num_levels(H, W, levels, 0.5) + 1
    prev = None
    for lv in bd["levels"]:
        got = _measured(lambda: tfb._level_planes(img, H, W, lv["k"], 0.5, 5, 1.2))
        assert got == pytest.approx(lv["poly_per_expansion"], rel=1e-2)
        assert lv["poly"] == lv["poly_per_expansion"] * (T / (T - 1) if T else 2)
        if prev is not None:
            u = torch.zeros(1, *prev)
            got = _measured(lambda: resize_bilinear(u, (lv["lh"], lv["lw"])) / 0.5)
            assert 2 * got == pytest.approx(lv["resize"], rel=1e-2)
        else:
            assert lv["resize"] == 2 * 4 * lv["lh"] * lv["lw"]  # the zero u, v
        prev = (lv["lh"], lv["lw"])
    assert bd["total"] == pytest.approx(
        bd["poly"] + bd["update"] + bd["solve"] + bd["resize"])


def test_kernel_counts_by_hand():
    bd = tfb.farneback_traffic_breakdown(48, 64, 1, 0.5, 3, 4)
    (lv,) = bd["levels"]  # 48x64 keeps one level: the next is below 32 px
    n = 48 * 64
    assert lv["update_per_iter"] == 68 * n  # R0, R1 5 each, u, v, M 5: fp32
    assert lv["solve_per_iter"] == 28 * n  # M in, u and v out
    assert bd["update"] == 3 * 68 * n and bd["solve"] == 3 * 28 * n
    half = tfb.farneback_traffic_breakdown(48, 64, 1, 0.5, 3, 4, oob_share=0.5)
    assert half["levels"][0]["update_per_iter"] == (48 + 10) * n
    with pytest.raises(ValueError, match="clip_frames"):
        tfb.farneback_traffic_breakdown(48, 64, clip_frames=1)
    with pytest.raises(ValueError, match="share"):
        tfb.farneback_traffic_breakdown(48, 64, oob_share=1.5)


def test_k1_k2_bytes_are_chip_smokes():
    """chip_smoke's K1 at [6, 5, 720, 1280] (its seed 0: R0, R1, then the
    flows' noise) reads R1 where the sample is in bounds: 375.2 MB; K2
    154.8 MB."""
    B, H, W = 6, 720, 1280
    rng = np.random.default_rng(0)
    for _ in range(2):  # R0, R1: drawn to advance the stream, not kept
        rng.standard_normal((B, 5, H, W), np.float32)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    u = np.stack([6 * np.sin(2 * np.pi * (xx / W + b / B)) for b in range(B)])
    v = np.stack([4 * np.cos(2 * np.pi * (yy / H + b / B)) for b in range(B)])
    u = (u + rng.uniform(-1, 1, u.shape)).astype(np.float32)
    v = (v + rng.uniform(-1, 1, v.shape)).astype(np.float32)
    fx = np.floor(np.arange(W, dtype=np.float32) + u)
    fy = np.floor(np.arange(H, dtype=np.float32)[:, None] + v)
    n_inb = int(((fx >= 0) & (fx < W - 1) & (fy >= 0) & (fy < H - 1)).sum())
    n_pix = B * H * W
    bd = tfb.farneback_traffic_breakdown(H, W, 3, 0.5, 3, oob_share=1 - n_inb / n_pix)
    finest = bd["levels"][-1]
    assert (finest["lh"], finest["lw"]) == (H, W)
    assert round(B * finest["update_per_iter"] / 1e6, 1) == 375.2
    assert round(B * finest["solve_per_iter"] / 1e6, 1) == 154.8


def test_stage_roofline_on_the_cpu(tmp_path):
    out = tmp_path / "r.json"
    assert stage_roofline.main(["--cpu", "--height", "48", "--width",
                                "64", "--clip", "3", "--reps", "1", "--out",
                                str(out)]) == 0
    legs = [json.loads(line) for line in out.read_text().splitlines()]
    names = [leg["leg"] for leg in legs]
    assert names == (["device"] + [f"ceiling_{k}" for k in (
        "read_128mb", "read_512mb", "read_1024mb", "rw_256mb", "rw_l2_16mb",
        "matmul_fp32", "matmul_tf32", "matmul_bf16", "fma_fp32")]
        + ["poly_k0", "update_k0", "solve_k0", "resize", "full_clip",
           "model_totals_mb_per_field"])
    assert legs[0]["device"] == "cpu" and legs[0]["timer"] == "wall"
    numbers = [v for leg in legs for v in leg.values()
               if isinstance(v, (int, float))]
    assert np.isfinite(numbers).all()
    # a CPU run states no share of the card's ceilings
    assert not any(k.startswith("of_") for leg in legs for k in leg)
    assert stage_roofline.main(["--cpu", "--no-ceilings", "--no-stages",
                                "--out", str(out)]) == 0
    assert len(out.read_text().splitlines()) == len(legs) + 1
