"""The port's core primitives (device selection, cv2-parity filters, resize,
colour) held against the JAX package on the CPU."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from opticalflowcontainer_tpu.core import color as jcolor
from opticalflowcontainer_tpu.core import filters as jfilters
from opticalflowcontainer_tpu.core import resize as jresize
from opticalflowcontainer_tpu_torch.core import color, device, filters, resize


@pytest.mark.parametrize("ksize,sigma", [(1, 0.0), (3, 0.0), (5, 0.0), (7, 0.0),
                                         (9, 0.0), (19, 3.5), (5, 1.1)])
def test_gaussian_kernel_matches_jax(ksize, sigma):
    np.testing.assert_array_equal(filters.gaussian_kernel_1d(ksize, sigma),
                                  jfilters.gaussian_kernel_1d(ksize, sigma))


@pytest.mark.parametrize("border", ["reflect101", "replicate"])
@pytest.mark.parametrize("klen", [3, 11, 19])
def test_sepconv_matches_jax(border, klen, rng):
    """Same shifted-slice sums in the same order: equal to fp32 rounding
    (1e-6 relative)."""
    img = rng.uniform(0, 255, (2, 37, 53)).astype(np.float32)
    kx = filters.gaussian_kernel_1d(klen, 0.0)
    ky = rng.normal(size=klen)
    want = np.asarray(jfilters._sepconv(jnp.asarray(img), kx, ky, border))
    got = filters._sepconv(torch.from_numpy(img), kx, ky, border).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("size", [(18, 27), (45, 80), (60, 31), (36, 53)])
def test_resize_matches_jax(size, rng):
    """Half-pixel bilinear resize, fp32 coordinates on both sides: equal to
    fp32 rounding."""
    img = rng.uniform(0, 255, (2, 36, 53)).astype(np.float32)
    want = np.asarray(jresize.resize_bilinear(jnp.asarray(img), size))
    got = resize.resize_bilinear(torch.from_numpy(img), size).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("helper,args", [
    ("pad", (37, 5, "replicate")), ("pad", (53, 9, "reflect101")),
    ("resize", (36, 18)), ("resize", (53, 80))])
def test_index_tables_are_made_once_per_shape_and_device(helper, args):
    """The pad indices and resize taps live on the device once per shape:
    a fresh upload from pageable host memory would synchronize the stream
    on every filter and resize."""
    make = filters._pad_index if helper == "pad" else resize._taps
    dev = torch.device("cpu")
    assert make(*args, dev) is make(*args, dev)


def test_bgr_to_gray_matches_jax(rng):
    frame = rng.integers(0, 256, (24, 32, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        color.bgr_to_gray(torch.from_numpy(frame)).numpy(),
        np.asarray(jcolor.bgr_to_gray(jnp.asarray(frame))))


def test_resolve_device_never_falls_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert device.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        device.resolve_device("cuda")
    with pytest.raises(ValueError, match="unsupported"):
        device.resolve_device("meta")


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch):
    from opticalflowcontainer_tpu_torch.classical import (
        calc_optical_flow_farneback, farneback_clip)
    from opticalflowcontainer_tpu_torch.runtime.fused import FusedFarnebackStream

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = np.zeros((40, 48), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calc_optical_flow_farneback(img, img)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        farneback_clip(np.stack([img, img]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FusedFarnebackStream()
    out = calc_optical_flow_farneback(img, img, levels=1, iterations=1,
                                      device="cpu")
    assert out.shape == (40, 48, 2) and out.device.type == "cpu"


def test_capabilities_report_names_the_compiler_and_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rep = device.capabilities()
    assert rep["cuda_available"] is False and rep["device_count"] == 0
    assert {"torch", "cuda_runtime", "nvcc"} <= set(rep)
