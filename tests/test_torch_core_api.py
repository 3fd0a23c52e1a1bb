"""The port's remaining public API against the JAX package and cv2 on
seeded numpy inputs: ``core/filters.py`` ``gaussian_blur``, ``box_filter``
and ``sobel``; ``core/color.py`` ``bgr_to_rgb`` and ``normalize_image``;
``models/common.py`` ``fuse_conv_bn``; and the ``core`` and ``ops``
packages' exports.  (The byte count of Farneback's stages is the
benchmark's, ``portbench/counts/farneback.py``, and its tests are there.)

Bars: the filters within 1e-5 of the 0-255 scale (2.55e-3) of JAX and of
cv2 (fp32 sums of shifted slices on both sides; cv2 sums in its own order
and, for the box filter, by running sums); the colour functions exact; the
BatchNorm fold 1e-5 relative to the outputs' scale."""
import cv2
import numpy as np
import pytest
import torch

from opticalflowcontainer_tpu.core import color as jcolor
from opticalflowcontainer_tpu.core import filters as jfilters
from opticalflowcontainer_tpu.models import common as jcommon
from opticalflowcontainer_tpu_torch import core as tcore
from opticalflowcontainer_tpu_torch import ops as tops
from opticalflowcontainer_tpu_torch.core import color as tcolor
from opticalflowcontainer_tpu_torch.core import filters as tfilters
from opticalflowcontainer_tpu_torch.models import common as tcommon
from test_torch_threads import one_torch_thread  # noqa: F401

BAR = 1e-5 * 255.0
CV_BORDER = {"reflect101": cv2.BORDER_REFLECT_101, "replicate": cv2.BORDER_REPLICATE,
             "reflect": cv2.BORDER_REFLECT, "constant": cv2.BORDER_CONSTANT}


def _image(seed: int, shape=(2, 37, 53)) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32)


def _both(jfn, tfn, img, *args, **kwargs):
    return (np.asarray(jfn(img, *args, **kwargs)),
            tfn(torch.from_numpy(img), *args, **kwargs).numpy())


@pytest.mark.parametrize("border", ["reflect101", "replicate", "reflect", "constant"])
@pytest.mark.parametrize("ksize", [3, 4, 5, 8])
def test_box_filter_matches_jax_and_cv2(ksize, border):
    """Every border the reference supports, odd and even windows.  An even
    window gives one more row and column than the input (both packages pad
    ``ksize // 2`` on each side); the first [H, W] are cv2's."""
    img = _image(ksize)
    want, got = _both(jfilters.box_filter, tfilters.box_filter, img, ksize, border)
    assert got.dtype == np.float32 and got.shape == want.shape
    extra = 1 - ksize % 2
    assert got.shape == (2, 37 + extra, 53 + extra)
    assert np.abs(got - want).max() <= BAR
    for i in range(2):
        cv = cv2.boxFilter(img[i], -1, (ksize, ksize), normalize=True,
                           borderType=CV_BORDER[border])
        assert np.abs(got[i, :37, :53] - cv).max() <= BAR
    raw = tfilters.box_filter(torch.from_numpy(img), ksize, border, normalize=False).numpy()
    assert np.abs(raw - np.asarray(jfilters.box_filter(img, ksize, border, False))).max() \
        <= BAR * ksize * ksize


@pytest.mark.parametrize("dx,dy", [(1, 0), (0, 1), (1, 1)])
def test_sobel_matches_jax_and_cv2(dx, dy):
    img = _image(10 + 2 * dx + dy)
    want, got = _both(jfilters.sobel, tfilters.sobel, img, dx, dy)
    assert got.dtype == np.float32 and got.shape == img.shape
    assert np.abs(got - want).max() <= BAR
    for i in range(2):
        cv = cv2.Sobel(img[i], cv2.CV_32F, dx, dy, ksize=3)
        assert np.abs(got[i] - cv).max() <= BAR


def test_sobel_refuses_another_kernel_size_as_jax_does():
    img = _image(3)
    with pytest.raises(AssertionError):
        jfilters.sobel(img, 1, 0, ksize=5)
    with pytest.raises(ValueError, match="ksize 3"):
        tfilters.sobel(torch.from_numpy(img), 1, 0, ksize=5)


@pytest.mark.parametrize("ksize,sigma", [(5, 0.0), (7, 1.5), (9, 2.0)])
def test_gaussian_blur_matches_jax_and_cv2(ksize, sigma):
    img = _image(ksize)
    want, got = _both(jfilters.gaussian_blur, tfilters.gaussian_blur, img, ksize, sigma)
    assert got.dtype == np.float32 and np.abs(got - want).max() <= BAR
    for i in range(2):
        cv = cv2.GaussianBlur(img[i], (ksize, ksize), sigma)
        assert np.abs(got[i] - cv).max() <= BAR


def test_uint8_frames_filter_in_fp32():
    """A uint8 frame is filtered in fp32, as the reference casts it."""
    img = np.random.default_rng(4).integers(0, 256, (21, 30), dtype=np.uint8)
    got = tfilters.box_filter(torch.from_numpy(img), 3).numpy()
    assert got.dtype == np.float32
    cv = cv2.boxFilter(img.astype(np.float32), -1, (3, 3), borderType=cv2.BORDER_REFLECT_101)
    assert np.abs(got - cv).max() <= BAR


def test_bgr_to_rgb_is_exact():
    img = _image(5, (3, 9, 11, 3))
    got = tcolor.bgr_to_rgb(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcolor.bgr_to_rgb(img)))
    np.testing.assert_array_equal(got, img[..., ::-1])
    np.testing.assert_array_equal(
        tcolor.bgr_to_gray(torch.from_numpy(img)).numpy(), np.asarray(jcolor.bgr_to_gray(img)))


@pytest.mark.parametrize("kwargs", [{}, {"scale": 1.0 / 127.5},
                                    {"mean": (0.411, 0.432, 0.45)},
                                    {"scale": 2.0, "mean": (1.0, -0.5, 0.25)}])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_normalize_image_is_exact(kwargs, dtype):
    img = np.random.default_rng(6).integers(0, 256, (2, 7, 5, 3)).astype(dtype)
    got = tcolor.normalize_image(torch.from_numpy(img), **kwargs).numpy()
    want = np.asarray(jcolor.normalize_image(img, **kwargs))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("with_bias", [True, False])
def test_fuse_conv_bn_matches_jax_and_conv_then_batchnorm(with_bias):
    """The fold on torch's OIHW kernel equals JAX's on the HWIO kernel
    after the layout change, and the fused conv equals conv -> BatchNorm in
    eval mode (1e-5 relative to the output's scale)."""
    rng = np.random.default_rng(7)
    cout, cin = 6, 4
    w = rng.standard_normal((cout, cin, 3, 3)).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32) if with_bias else None
    gamma, beta, mean = (rng.standard_normal(cout).astype(np.float32) for _ in range(3))
    var = rng.uniform(0.2, 2.0, cout).astype(np.float32)
    fw, fb = tcommon.fuse_conv_bn(w, b, gamma, beta, mean, var)
    jk, jb = jcommon.fuse_conv_bn(np.transpose(w, (2, 3, 1, 0)), b, gamma, beta, mean, var)
    np.testing.assert_allclose(fw, np.transpose(np.asarray(jk), (3, 2, 0, 1)), rtol=1e-6)
    np.testing.assert_allclose(fb, np.asarray(jb), rtol=1e-6, atol=1e-6)

    conv = torch.nn.Conv2d(cin, cout, 3, padding=1, bias=with_bias)
    bn = torch.nn.BatchNorm2d(cout, eps=1e-5).eval()
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w))
        if with_bias:
            conv.bias.copy_(torch.from_numpy(b))
        for name, v in (("weight", gamma), ("bias", beta), ("running_mean", mean),
                        ("running_var", var)):
            getattr(bn, name).copy_(torch.from_numpy(v))
        x = torch.from_numpy(rng.standard_normal((2, cin, 9, 10)).astype(np.float32))
        want = bn(conv(x))
        got = torch.nn.functional.conv2d(x, torch.from_numpy(np.asarray(fw, np.float32)),
                                         torch.from_numpy(np.asarray(fb, np.float32)),
                                         padding=1)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_core_and_ops_export_callables():
    """``core`` exports the counterparts of the reference's 23 names, and
    ``ops`` the correlation, all-pairs and unfold ops with the plain
    correlation under its own name."""
    from opticalflowcontainer_tpu import core as jcore

    assert tcore.__all__ == jcore.__all__
    assert all(callable(getattr(tcore, n)) for n in tcore.__all__)
    assert set(tops.__all__) == {"local_correlation", "correlation_plain",
                                 "all_pairs_correlation", "corr_pyramid", "corr_lookup",
                                 "unfold"}
    assert all(callable(getattr(tops, n)) for n in tops.__all__)
    f1, f2 = (torch.from_numpy(_image(s, (1, 8, 6, 7)) / 255.0) for s in (1, 2))
    torch.testing.assert_close(tops.local_correlation(f1, f2, 2),
                               tops.correlation_plain(f1, f2, 2))
