"""The port's RAFT (large) held against the benchmark's plain reference
(``portbench/reference/raft_large.py``: the published ``CorrBlock`` with
``F.avg_pool2d`` and ``F.grid_sample``, the update block and the convex
upsampling in plain PyTorch) on the CPU: seeded random weights and the
packaged npz, B=1 and B=2, 1 and 4 updates, at 128x256 (the coarsest of
the four levels 2x4: ``grid_sample``'s align-corners coordinates divide
by the level's size less one, so a level one pixel wide is where the two
lookups part, and the cell's 1080p coarsest level is 16x30) and at a size
the estimate contract resizes.  Also: the TF32 control fails the
tolerance; the reference loads nothing of the port, JAX or the JAX
package and leaves both TF32 switches as it found them; the cell, shrunk,
is correct through ``harness.run_cell`` and is not with the timed path
broken; ``counts/raft_large.py`` against ``torch.utils.flop_counter``.

Tolerance: the flow within 3e-5 px mean and 2e-4 px max end-point
distance of the reference's.  Both compute in fp32; their convolutions
sum in another order, and the reference's lookup goes through
grid_sample's normalised coordinates and advances ``coords1`` where the
port advances the flow.  Measured 1.3e-6 to 3.4e-6 px mean at 128x256,
and 1.1e-5 at 132x260, where the frames and the flow are also resized
(the port's own resize against ``F.interpolate``); up to 6.7e-5 px max;
on flows of 2-11 px RMS.  The control (the reference with TF32 operands)
reads 4.1e-4 to 7.8e-3 px mean, over 13 times the bar.
"""
import importlib
import json
import pathlib
import subprocess
import sys
import types

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from opticalflowcontainer_tpu_torch.models import convert
from opticalflowcontainer_tpu_torch.models import raft as traft
from opticalflowcontainer_tpu_torch.models.common import flax_init, upsample_convex
from portbench import frames, harness
from portbench.counts import raft_large as counts
from portbench.reference import raft_large as ref
from test_torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "raft_large.batch2_1080p"
CPU = torch.device("cpu")
MEAN_PX, MAX_PX = 3e-5, 2e-4
SEED = 2 ** 31 + 22


def _frames(n, H, W, seed=SEED):
    """``n`` consecutive [H, W, 3] frames in [0, 1] of the cell's generator."""
    pool = frames.make_pool({"height": H, "width": W, "channels": 3, "pool": n,
                             "max_shift_px": 3.0}, seed, CPU)
    return torch.from_numpy(pool).float() / 255.0


@pytest.fixture(scope="module")
def models():
    """The port's RAFT with seeded random weights and with the packaged npz,
    each beside the reference's weights made from it."""
    seeded = flax_init(traft.RAFT(), torch.Generator().manual_seed(22)).eval()
    packaged = convert.load_raft_synth(device="cpu")
    assert packaged is not None, "packaged raft_large_synth.npz missing"
    return {name: (m, ref.weights_from_flat(convert.torch_to_flax_flat(m), CPU))
            for name, m in (("seeded", seeded), ("packaged", packaged))}


def _epe(a, b):
    d = (a - b).norm(dim=-1)
    return float(d.mean()), float(d.max())


CASES = [("seeded", 1, 128, 256, 1), ("seeded", 1, 128, 256, 4),
         ("seeded", 2, 128, 256, 1), ("seeded", 2, 128, 256, 4),
         ("seeded", 2, 132, 260, 2), ("packaged", 2, 128, 256, 4)]


@pytest.mark.parametrize("weights,B,H,W,iters", CASES,
                         ids=[f"{c[0]}-B{c[1]}-{c[2]}x{c[3]}-iters{c[4]}" for c in CASES])
def test_port_matches_the_reference(models, weights, B, H, W, iters):
    model, w = models[weights]
    x = _frames(B + 1, H, W)
    flow = traft.estimate(model, x[:-1], x[1:], iters=iters)
    want = ref.RAFTLargeRef(w, iters=iters).estimate(x[:-1], x[1:])
    assert flow.shape == want.shape == (B, H, W, 2)
    mean, worst = _epe(flow, want)
    assert mean <= MEAN_PX and worst <= MAX_PX, (mean, worst)
    # the flow is far from zero: the comparison is not of two empty fields
    assert float(want.square().mean().sqrt()) > 0.5


@pytest.mark.parametrize("weights", ["seeded", "packaged"])
def test_the_control_fails_the_tolerance(models, weights):
    model, w = models[weights]
    x = _frames(3, 128, 256)
    flow = traft.estimate(model, x[:-1], x[1:], iters=4)
    control = ref.RAFTLargeRef(w, control=True, iters=4).estimate(x[:-1], x[1:])
    mean, _ = _epe(flow, control)
    assert mean > 5 * MEAN_PX, mean


def test_the_reference_loads_nothing_of_the_port():
    code = ("import json, sys; import portbench.reference.raft_large; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    loaded = set(json.loads(out))
    assert not loaded & (harness.FORBIDDEN | {"opticalflowcontainer_tpu_torch"}), loaded


def test_the_reference_turns_tf32_off_and_back():
    seen = []
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        with ref.fp32_math():
            seen.append((torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32))
        assert seen == [(False, False)]
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def test_counts_match_the_flop_counter():
    """The convolutions and the all-pairs product of one estimate, as
    ``torch.utils.flop_counter`` counts them, at 64x128 and 3 updates."""
    model = traft.RAFT().eval()
    x = _frames(2, 64, 128)
    with FlopCounterMode(display=False) as counter:
        traft.estimate(model, x[:1], x[1:], iters=3)
    mine = counts.counts({"iters": 3}, {"height": 64, "width": 128})
    assert mine["flops"] == counter.get_total_flops()
    assert mine["flops"] == sum(mine[k] for k in ("encoders", "volume", "updates",
                                                  "upsample"))
    n = 8 * 16
    assert mine["volume"] == 2 * 256 * n * n
    assert mine["lookup"] == {"flops": 3 * n * 324 * 8, "bytes": 3 * n * 324 * 5 * 4}


def test_counts_at_the_cell_size():
    """4.88 TFLOP a 1080p pair: the encoders 0.845, the product 0.537, 20
    updates 3.468, the mask head 0.029."""
    spec = harness.cell_spec(BENCH, CELL)
    c = counts.counts(spec["config"], spec["traffic"])
    assert round(c["flops"] / 1e9) == 4880
    assert [round(c[k] / 1e9) for k in ("encoders", "volume", "updates", "upsample")] \
        == [845, 537, 3468, 29]


# ------------------------------------------------ the cell through the harness
# the cell shrunk to what a CPU test holds: 128x256 frames, 4 updates
TINY = {"height": 128, "width": 256, "pool": 6, "check_calls": 2}
TINY_ITERS = 4


def _spec():
    spec = harness.cell_spec(BENCH, CELL)
    spec["traffic"].update(TINY)
    spec["config"]["iters"] = TINY_ITERS
    return spec


def _system(spec):
    return importlib.import_module(
        f"portbench.systems.{spec['config']['system']}").System(spec["config"], CPU)


def _run(spec, system):
    return harness.run_cell(spec, SEED, 0.3, False, CPU, system=system)


def test_the_shrunk_cell_is_correct():
    spec = _spec()
    r = _run(spec, _system(spec))
    assert r["correct"], r["checks"]
    assert r["checks"]["flow_epe_mean_px"]["value"] <= MEAN_PX


def _mask_scale_dropped(system, monkeypatch):
    def upsample(self, flow, h):
        return upsample_convex(flow, self.mask2(F.relu(self.mask1(h))))
    system.model._upsample = types.MethodType(upsample, system.model)


def _window_left_at_the_pixel(system, monkeypatch):
    lookup = traft.lookup_packed
    monkeypatch.setattr(traft, "lookup_packed",
                        lambda packed, flow, r: lookup(packed, torch.zeros_like(flow), r))


FAULTS = {"mask_scale_dropped": _mask_scale_dropped,
          "window_left_at_the_pixel": _window_left_at_the_pixel}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    spec = _spec()
    system = _system(spec)
    FAULTS[fault](system, monkeypatch)
    r = _run(spec, system)
    assert not r["correct"], r["checks"]
