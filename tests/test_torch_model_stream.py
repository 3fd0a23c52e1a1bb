"""The port's learned-model stream (``runtime/fused.py`` ``FusedModelStream``
and ``make_fused_model_backend``) held against the JAX package's on the CPU,
over LiteFlowNet3 with the packaged ``liteflownet3_synth.npz``: uint8 BGR
frames in, one aggregated displacement out per frame.

Tolerance on du: 5e-4 px, LFN3's whole-net mean bound
(``tests/test_torch_liteflownet3.py``): a mean or median of the flow
carries the flow's own fp32 difference."""
import numpy as np
import pytest
import torch

from opticalflowcontainer_tpu.models import liteflownet3 as jlfn3
from opticalflowcontainer_tpu.runtime import fused as jfused
from opticalflowcontainer_tpu_torch.models import convert
from opticalflowcontainer_tpu_torch.models import liteflownet3 as tlfn3
from opticalflowcontainer_tpu_torch.models import pwcnet as tpwc
from opticalflowcontainer_tpu_torch.runtime import fused as tfused
from test_torch_threads import one_torch_thread  # noqa: F401

DU_PX = 5e-4


@pytest.fixture(scope="module")
def jax_lfn3():
    loaded = jlfn3.load_liteflownet3_synth()
    assert loaded is not None, "packaged liteflownet3_synth.npz missing"
    return loaded


@pytest.fixture(scope="module")
def torch_lfn3():
    return convert.load_liteflownet3_synth(device="cpu")


@pytest.fixture(scope="module")
def jax_streams(jax_lfn3):
    """One JAX stream per aggregate, shared by the cases so that each
    compiles its step program once."""
    model, params = jax_lfn3
    return {agg: jfused.FusedModelStream(model, params, jlfn3.estimate, agg)
            for agg in ("mean", "median")}


def frames(n=4, h=64, w=96, step=2, seed=0):
    """uint8 BGR frames of one texture moving ``step`` px left per frame."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (h, w + step * n, 3)).astype(np.uint8)
    return [np.ascontiguousarray(base[:, step * i:step * i + w]) for i in range(n)]


def mask_of(kind, h=64, w=96):
    if kind == "none":
        return None
    m = np.zeros((h, w), bool)
    if kind == "some":
        m[8:40, 20:70] = True
    return m


@pytest.mark.parametrize("aggregate", ["mean", "median"])
@pytest.mark.parametrize("mask_kind", ["none", "some", "empty"])
def test_stream_matches_jax(aggregate, mask_kind, jax_streams, torch_lfn3):
    """Four frames through both streams, unmasked, masked, and with an
    all-False mask that falls back to the whole frame."""
    f = frames()
    m = mask_of(mask_kind)
    js = jax_streams[aggregate]
    js.reset()
    ts = tfused.FusedModelStream(torch_lfn3, tlfn3.estimate, aggregate,
                                 device="cpu")
    assert js.step(f[0], m) is None and ts.step(f[0], m) is None
    for frame in f[1:]:
        want = float(js.step(frame, m))
        got = ts.step(frame, m)
        assert got.shape == () and got.dtype == torch.float32
        assert float(got) == pytest.approx(want, abs=DU_PX)
    if mask_kind == "empty":
        full = tfused.FusedModelStream(torch_lfn3, tlfn3.estimate, aggregate,
                                       device="cpu")
        full.step(f[-2])
        assert float(full.step(f[-1])) == float(got)


def test_step_many_equals_step_bitwise(torch_lfn3):
    """K frames from one upload == K steps, bit for bit, and the carried
    frame ends the same; step_many needs a seeded stream."""
    f = frames(n=4)
    a = tfused.FusedModelStream(torch_lfn3, tlfn3.estimate, device="cpu")
    b = tfused.FusedModelStream(torch_lfn3, tlfn3.estimate, device="cpu")
    a.step(f[0])
    b.step(f[0])
    per_frame = torch.stack([a.step(x) for x in f[1:]])
    chunk = b.step_many(np.stack(f[1:]))
    assert chunk.shape == (3,)
    assert torch.equal(per_frame, chunk)
    assert torch.equal(a._prev, b._prev)
    with pytest.raises(RuntimeError, match="seed the stream"):
        tfused.FusedModelStream(torch_lfn3, tlfn3.estimate,
                                device="cpu").step_many(np.stack(f))


@pytest.mark.parametrize("bgr_to_rgb", [False, True])
def test_backend_matches_jax(bgr_to_rgb, jax_lfn3, torch_lfn3):
    """The flow-node backend returns the JAX backend's displacement (BGR
    kept or flipped to RGB), carries the stream, and ``warmup`` and
    ``reset`` leave the state as they found it."""
    model, params = jax_lfn3
    f = frames(n=3, seed=1)
    jb = jfused.make_fused_model_backend(model, params, jlfn3.estimate,
                                         bgr_to_rgb=bgr_to_rgb)
    tb = tfused.make_fused_model_backend(torch_lfn3, tlfn3.estimate,
                                         bgr_to_rgb=bgr_to_rgb, device="cpu")
    assert tb.wants_color and tb.returns_displacement
    assert isinstance(tb.stream, tfused.FusedModelStream)
    tb.stream.warmup(f[0])
    assert tb.stream._prev is None
    for a, b in zip(f, f[1:]):
        du = tb(a, b, 1 / 30)
        assert isinstance(du, float)
        assert du == pytest.approx(jb(a, b, 1 / 30), abs=DU_PX)
    tb.stream.reset()
    assert tb.stream._prev is None


def test_stream_refuses_what_it_does_not_serve(torch_lfn3):
    """bf16 is served (a bf16 copy of the model; the caller's stays fp32,
    tests/test_torch_bf16_serving.py holds the numbers); a model on another
    device than the stream's, and an unknown aggregate, raise; without a
    card the stream needs device='cpu'."""
    for make in (tfused.FusedModelStream, tfused.make_fused_model_backend):
        made = make(torch_lfn3, tlfn3.estimate, bf16=True, device="cpu")
        stream = getattr(made, "stream", made)
        assert all(p.dtype == torch.bfloat16 for p in stream.model.parameters())
    assert all(p.dtype == torch.float32 for p in torch_lfn3.parameters())
    with pytest.raises(ValueError, match="aggregate"):
        tfused.FusedModelStream(torch_lfn3, tlfn3.estimate, "mode", device="cpu")
    meta = tpwc.PWCNet().to("meta")
    with pytest.raises(ValueError, match="parameters are on"):
        tfused.FusedModelStream(meta, tpwc.estimate, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tfused.FusedModelStream(torch_lfn3, tlfn3.estimate)
