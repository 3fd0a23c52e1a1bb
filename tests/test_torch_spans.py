"""The port's ``ofc.*`` spans (``core/spans.py``) on the CPU: the shared
no-op when no profiler runs, and under ``torch.profiler`` the spans of a
Farneback call, of a fused stream's step and wait, of the model's estimate
and PWC-Net's stages, of RAFT's stages (and the lookup's call counter), and
of a constant table built on a cache miss."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from opticalflowcontainer_tpu_torch.classical import farneback as tfb
from opticalflowcontainer_tpu_torch.core import spans
from opticalflowcontainer_tpu_torch.models import pwcnet as tpwc
from opticalflowcontainer_tpu_torch.models import raft as traft
from opticalflowcontainer_tpu_torch.ops import allpairs
from opticalflowcontainer_tpu_torch.runtime import fused, tracing
from test_torch_threads import one_torch_thread  # noqa: F401

H, W = 128, 128


def _frames(n, h=H, w=W, channels=None, seed=0):
    """``n`` uint8 frames of one texture moving one pixel a frame."""
    rng = np.random.default_rng(seed)
    shape = (h, w + n) + ((channels,) if channels else ())
    base = rng.integers(0, 256, shape, dtype=np.uint8)
    return np.stack([base[:, i:i + w] for i in range(n)])


def _profiled(fn):
    """The ``ofc.*`` events of one call of ``fn`` under the profiler, as
    (name, start_us, end_us) in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith("ofc.")),
                  key=lambda e: e[1])


def _names(events):
    return [n for n, _, _ in events]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_annotate_is_one_shared_no_op_with_no_profiler():
    assert tracing.annotate is spans.annotate
    assert spans.annotate(spans.FARNEBACK_PREP) is spans.annotate("anything")
    with spans.annotate(spans.STREAM_STEP) as entered:
        assert entered is None
    tfb.farneback_clip(_frames(3), device="cpu")
    assert _profiled(lambda: torch.ones(4).sum()) == []


def test_annotate_records_a_span_under_the_profiler():
    def run():
        with tracing.annotate("ofc.test"):
            torch.ones(4).sum()
    assert _names(_profiled(run)) == ["ofc.test"]


def test_span_names_are_distinct_and_prefixed():
    names = [v for k, v in vars(spans).items() if k.isupper() and isinstance(v, str)]
    names += list(spans.PWCNET_DECODER.values())
    assert len(names) == len(set(names)) == 23
    assert all(n.startswith("ofc.") for n in names)


def _stream_step(frames):
    state = tfb.farneback_stream_planes(frames[0], device="cpu")
    return lambda: tfb.farneback_stream_step(state, frames[1], device="cpu")


# (the call made of the frames, preps a level, uploads): a clip expands the
# clip's frames in one batch, a pair each of its two frames, a stream step
# the new frame (its state carries the previous frame's planes)
FARNEBACK_CALLS = {
    "clip": (lambda f: lambda: tfb.farneback_clip(f, device="cpu"), 1, 1),
    "pair": (lambda f: lambda: tfb.calc_optical_flow_farneback(
        f[0], f[1], device="cpu"), 2, 2),
    "stream_step": (_stream_step, 1, 1),
}


@pytest.mark.parametrize("entry", sorted(FARNEBACK_CALLS))
def test_farneback_records_upload_prep_and_solve_per_level(entry):
    make_call, preps, uploads = FARNEBACK_CALLS[entry]
    levels = tfb._num_levels(H, W, 3, 0.5) + 1
    assert levels == 3
    events = _profiled(make_call(_frames(4)))
    names = _names(events)
    assert names.count(spans.FARNEBACK_UPLOAD) == uploads
    assert names.count(spans.FARNEBACK_PREP) == preps * levels
    assert names.count(spans.FARNEBACK_SOLVE) == levels
    solves = [e for e in events if e[0] == spans.FARNEBACK_SOLVE]
    for prep in (e for e in events if e[0] == spans.FARNEBACK_PREP):
        assert not any(_inside(prep, s) for s in solves)
    # coarse to fine: each level's prep before its solve
    order = [n for n in names if n in (spans.FARNEBACK_PREP, spans.FARNEBACK_SOLVE)]
    assert order == ([spans.FARNEBACK_PREP] * preps + [spans.FARNEBACK_SOLVE]) * levels


def _pwcnet_backend():
    torch.manual_seed(0)
    model = tpwc.PWCNet().eval()
    return fused.make_fused_model_backend(model, tpwc.estimate, device="cpu")


PWCNET_STAGES = ([spans.PWCNET_EXTRACTOR]
                 + [spans.PWCNET_DECODER[level] for level in (6, 5, 4, 3, 2)]
                 + [spans.PWCNET_REFINER])
BACKENDS = {
    "pwcnet": (_pwcnet_backend, [spans.MODEL_RESIZE_IN, spans.MODEL_FORWARD]
               + PWCNET_STAGES + [spans.MODEL_RESIZE_OUT]),
    "farneback": (lambda: fused.make_fused_farneback_backend(device="cpu"),
                  [spans.FARNEBACK_UPLOAD]
                  + [spans.FARNEBACK_PREP, spans.FARNEBACK_SOLVE] * 3),
}


@pytest.mark.parametrize("kind", sorted(BACKENDS))
def test_a_fused_backend_records_step_then_wait(kind):
    make, inner = BACKENDS[kind]
    h, w = (64, 64) if kind == "pwcnet" else (H, W)
    frames = _frames(3, h, w, channels=3)
    backend = make()
    backend(frames[0], frames[1], 1 / 30)
    events = _profiled(lambda: backend(frames[1], frames[2], 1 / 30))
    names = _names(events)
    assert names == ([spans.STREAM_STEP, spans.STREAM_UPLOAD] + inner
                     + [spans.STREAM_AGGREGATE, spans.STREAM_WAIT])
    step = events[0]
    assert all(_inside(e, step) for e in events[1:-1])
    assert events[-1][1] >= step[2]  # the wait opens after the step returns
    if kind == "pwcnet":
        forward = events[names.index(spans.MODEL_FORWARD)]
        assert all(_inside(e, forward) for e in events if e[0] in PWCNET_STAGES)


def _clip_call(frames):
    return lambda: tfb.farneback_clip(frames[..., 0], device="cpu")


def _backend_call(make):
    def call(frames):
        backend = make()
        return lambda: backend(frames[0], frames[1], 1 / 30)
    return call


RAFT_STAGES = {"large": traft.RAFT, "small": traft.RAFTSmall}


def _raft_call(kind, iters):
    torch.manual_seed(0)
    model = RAFT_STAGES[kind]().eval()
    frames = torch.from_numpy(_frames(2, 64, 64, channels=3)).float() / 255
    return lambda: traft.estimate(model, frames[:1], frames[1:], iters=iters)


@pytest.mark.parametrize("kind,iters", [("large", 3), ("small", 2)])
def test_raft_records_its_stages_and_counts_its_lookups(kind, iters):
    run = _raft_call(kind, iters)
    run()
    calls = allpairs.lookup_packed.calls
    events = _profiled(run)
    assert allpairs.lookup_packed.calls == calls + iters
    names = _names(events)
    stages = [n for n in names if n.startswith("ofc.raft.")]
    assert stages == ([spans.RAFT_ENCODE, spans.RAFT_VOLUME]
                      + [spans.RAFT_LOOKUP, spans.RAFT_UPDATE] * iters
                      + [spans.RAFT_UPSAMPLE])
    forward = events[names.index(spans.MODEL_FORWARD)]
    assert all(_inside(e, forward) for e in events if e[0] in stages)
    # one span at a time: no stage opens inside another
    raft = [e for e in events if e[0] in stages]
    assert all(a[2] <= b[1] for a, b in zip(raft, raft[1:]))


def test_raft_records_no_span_with_no_profiler(monkeypatch):
    made = []
    real = torch._C._profiler._RecordFunctionFast

    def counted(name):
        made.append(name)
        return real(name)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", counted)
    run = _raft_call("large", 2)
    calls = allpairs.lookup_packed.calls
    run()
    assert made == []
    assert allpairs.lookup_packed.calls == calls + 2
    _profiled(run)
    assert made.count(spans.RAFT_LOOKUP) == 2  # the stand-in is the one used


# kind -> (frame size, the call made of the frames)
WARM_CALLS = {
    "clip": ((H, W), _clip_call),
    "farneback_stream": ((H, W), _backend_call(BACKENDS["farneback"][0])),
    "pwcnet_stream": ((64, 64), _backend_call(_pwcnet_backend)),
}


@pytest.mark.parametrize("kind", sorted(WARM_CALLS))
def test_a_warm_call_builds_nothing(kind):
    (h, w), make_call = WARM_CALLS[kind]
    run = make_call(_frames(4, h, w, channels=3))
    run()
    run()
    assert spans.BUILD not in _names(_profiled(run))


def test_a_new_shape_builds_its_tables():
    # a size no other test uses: its resize and filter tables are not cached
    frames = _frames(3, 71, 97)
    assert spans.BUILD in _names(_profiled(
        lambda: tfb.farneback_clip(frames, device="cpu")))
