"""bf16 serving in the port, on the CPU: every family's flow with bfloat16
parameters and frames (``models.common.cast_params``) against its own fp32
flow on the same pair, at the bars of ``tests/test_bf16_serving.py`` (the
reference's bf16 tests, same pairs, same sizes); the flow comes back fp32.
``FusedModelStream(bf16=True)`` and the demo's ``--bf16``.

The seeded nets (NeuFlowLite, LiteFlowNet3) take the reference test's
initialization, flax's defaults, drawn from a seeded ``torch.Generator``:
kernels truncated-normal with variance 1/fan_in, zero biases, NeuFlowLite's
temperature 10 and gate 0; the others the packaged npz.  RAFT (large) has
no bar in the reference: it is held to RAFT-small's.  Measured here (mean /
max px): NeuFlowLite 0.020 / 0.087, LFN3 3e-5 / 1.2e-4 (its seeded flow is
~0.002 px, as the reference's), LiteFlowNet 0.006 / 0.036, NeuFlow-v2 0.007
/ 0.033, PWC-Net 0.031 / 0.133, RAFT-small 0.007 / 0.023, RAFT 0.004 /
0.015.
"""
import copy

import numpy as np
import pytest
import torch

from opticalflowcontainer_tpu_torch.models import convert
from opticalflowcontainer_tpu_torch.models.common import cast_params
from opticalflowcontainer_tpu_torch.models.liteflownet3 import LiteFlowNet3
from opticalflowcontainer_tpu_torch.models.neuflow import NeuFlowLite
from opticalflowcontainer_tpu_torch.runtime import demo
from opticalflowcontainer_tpu_torch.runtime.fused import (
    FusedModelStream, make_fused_model_backend)
from test_torch_threads import one_torch_thread  # noqa: F401



def _pair(H, W):
    """The reference test's pair (``rng`` seed 0): noise and itself moved
    2 px."""
    base = np.random.default_rng(0).uniform(0, 1, (H + 8, W + 8, 3)).astype(np.float32)
    return base[4:4 + H, 4:4 + W], base[4:4 + H, 2:2 + W]


def _flax_init(model, seed=0):
    """``model`` with flax's default initializers, as the reference test's
    ``model.init``: every kernel truncated normal (at 2 sigma) of variance
    1 / fan_in, biases zero; parameters of their own keep the module's
    init (NeuFlowLite's temperature 10 and gate 0)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.ConvTranspose2d):
                fan_in = m.weight.shape[0] // m.groups * m.weight[0, 0].numel()
            elif isinstance(m, torch.nn.Conv2d):
                fan_in = m.weight[0].numel()
            else:
                continue
            # flax's truncated normal is rescaled to keep the variance
            std = fan_in ** -0.5 / 0.87962566103423978
            torch.nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                        generator=g)
            if m.bias is not None:
                m.bias.zero_()
    return model.eval()


def _lite():
    return _flax_init(NeuFlowLite())


def _lfn3():
    return _flax_init(LiteFlowNet3())


# family -> (model, size, (mean bar, max bar), forward kwargs)
FAMILIES = {
    "neuflow_lite": (_lite, (48, 64), (None, 0.5), {}),
    "liteflownet3": (_lfn3, (64, 96), (None, 0.1), {}),
    "liteflownet": (convert.load_liteflownet_synth, (64, 96), (0.05, 0.3), {}),
    "neuflow_v2": (convert.load_neuflow_v2_synth, (64, 96), (0.05, 0.3), {}),
    "pwcnet": (convert.load_pwcnet_synth, (64, 128), (2.5, 9.0), {}),
    "raft_small": (convert.load_raft_small_synth, (64, 96), (0.1, 0.5),
                   {"iters": 8, "final_only": True}),
    "raft": (convert.load_raft_synth, (64, 96), (0.1, 0.5),
             {"iters": 8, "final_only": True}),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_bf16_flow_close_to_fp32(family):
    make, (H, W), (mean_bar, max_bar), kw = FAMILIES[family]
    model = make(device="cpu") if make.__module__ == convert.__name__ else make()
    assert model is not None, f"packaged weights of {family} missing"
    i1, i2 = (torch.from_numpy(i).permute(2, 0, 1)[None] for i in _pair(H, W))
    bf = cast_params(copy.deepcopy(model), torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in bf.parameters())
    with torch.inference_mode():
        f32 = model(i1, i2, **kw)
        f16 = bf(i1.bfloat16(), i2.bfloat16(), **kw)
    assert f16.dtype == torch.float32 and bool(torch.isfinite(f16).all())
    d = (f16 - f32).abs()
    assert float(f32.abs().max()) > 0.0  # a flow, not zeros
    assert (mean_bar is None or float(d.mean()) < mean_bar) and float(d.max()) < max_bar, (
        float(d.mean()), float(d.max()))


def _frames(n=4, H=48, W=64):
    base = np.random.default_rng(1).uniform(0, 255, (H, W + 2 * n, 3))
    return [base[:, 2 * (n - t):2 * (n - t) + W].astype(np.uint8) for t in range(n)]


def test_fused_model_stream_bf16():
    """The stream casts a copy of the model once (the caller's stays fp32),
    frames go to the model in bf16, du comes back fp32 and near the fp32
    stream's; ``make_fused_model_backend(bf16=True)`` serves the same."""
    from opticalflowcontainer_tpu_torch.models import neuflow

    model = convert.load_neuflow_lite_synth(device="cpu")
    s = FusedModelStream(model, neuflow.estimate, bf16=True, device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in s.model.parameters())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    ref = FusedModelStream(model, neuflow.estimate, device="cpu")
    frames = _frames()
    assert s.step(frames[0]) is None and ref.step(frames[0]) is None
    assert s._prev.dtype == torch.bfloat16
    for f in frames[1:]:
        du, want = s.step(f), ref.step(f)
        assert du.dtype == torch.float32 and du.dim() == 0
        assert abs(float(du) - float(want)) < 0.05, (float(du), float(want))
    backend = make_fused_model_backend(model, neuflow.estimate, bf16=True, device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in backend.stream.model.parameters())
    assert isinstance(backend(frames[0], frames[1], 1 / 30), float)


def test_demo_bf16_on_the_cpu(capsys):
    """``--model neuflow --bf16``: the self-check holds in bf16."""
    r = demo.run(["--cpu", "--model", "neuflow", "--bf16", "--frames", "10",
                  "--width", "128", "--height", "96", "--fps", "100"])
    out = capsys.readouterr().out
    assert r["exit_code"] == 0 and r["frames_failed"] == 0, out


@pytest.mark.parametrize("argv", [["--bf16"], ["--bf16", "--fused"],
                                  ["--bf16", "--model", "farneback", "--fused"]])
def test_demo_bf16_with_farneback_exits_with_an_error(argv, capsys):
    """bf16 serves a learned model: with the Farneback backend, plain or
    fused, the demo refuses instead of running fp32 under a bf16 flag."""
    with pytest.raises(SystemExit) as e:
        demo.run(["--cpu"] + argv)
    assert e.value.code != 0
    assert "--bf16 serves a learned model" in capsys.readouterr().err
