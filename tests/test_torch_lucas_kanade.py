"""The port's Lucas-Kanade slice held against the JAX package and cv2 on the
CPU: ``scharr_deriv``, the pyramids, the align-corners resize,
``calc_optical_flow_pyr_lk`` and ``good_features_to_track``
(``LKVelocityNode`` in ``tests/test_torch_lk_node.py``).  The same seeded
numpy inputs go to both sides; each test states its tolerance."""
import cv2
import numpy as np
import pytest
import torch

from opticalflowcontainer_tpu.classical import lucas_kanade as jlk
from opticalflowcontainer_tpu.core import filters as jfilters
from opticalflowcontainer_tpu.core import pyramid as jpyramid
from opticalflowcontainer_tpu.core import resize as jresize
from opticalflowcontainer_tpu_torch.classical import LKResult, calc_optical_flow_pyr_lk
from opticalflowcontainer_tpu_torch.core import corners, filters, pyramid, resize
from opticalflowcontainer_tpu_torch.runtime.sources import SyntheticCamera
from test_torch_threads import one_torch_thread  # noqa: F401

# Filters and pyramids: fp32 shifted-slice sums in the reference's order on
# 0-255 images; 1e-4 absolute allows a last-bit difference per tap.
FILTER_ATOL = 1e-4
# The tracker against JAX: the same float algorithm with reductions summed
# in another order.  Measured <= 2e-4 px (640x480, 500 points) and <= 1.3e-4
# in err; the bars leave 5x room and stay 250x below cv2's 0.05 px bar.
LK_PX, LK_ERR = 1e-3, 1e-3


def _pair(rng, H=240, W=320, shift=(-3.3, 2.6)):
    """tests/test_lucas_kanade.py's textured pair: frame 2 is frame 1 moved
    by ``shift`` px (cv2.warpAffine of a blurred noise canvas), uint8."""
    base = cv2.GaussianBlur(
        rng.uniform(0, 255, (H + 40, W + 40)).astype(np.float32), (0, 0), 1.5)
    M = np.float32([[1, 0, shift[0]], [0, 1, shift[1]]])
    f1 = base[20:20 + H, 20:20 + W].astype(np.uint8)
    f2 = cv2.warpAffine(base, M, (W + 40, H + 40))[20:20 + H, 20:20 + W].astype(np.uint8)
    return f1, f2


def _gray_u8(frame):
    f = frame.astype(np.float32)
    return (0.114 * f[..., 0] + 0.587 * f[..., 1] + 0.299 * f[..., 2]).astype(np.uint8)


@pytest.mark.parametrize("shape", [(37, 53), (48, 64)], ids=["odd", "even"])
def test_scharr_deriv_matches_jax(shape, rng):
    img = rng.uniform(0, 255, shape).astype(np.float32)
    want = jfilters.scharr_deriv(img)
    got = filters.scharr_deriv(torch.from_numpy(img))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=FILTER_ATOL)


@pytest.mark.parametrize("shape", [(37, 53), (48, 64), (101, 133)])
def test_pyr_down_and_gaussian_pyramid_match_jax(shape, rng):
    """Each level against JAX's; level 1 is ``pyr_down`` of the input,
    ceil(H / 2) x ceil(W / 2)."""
    img = rng.uniform(0, 255, shape).astype(np.float32)
    want = jpyramid.gaussian_pyramid(img, 4)
    got = pyramid.gaussian_pyramid(torch.from_numpy(img), 4)
    assert len(got) == 4
    assert tuple(got[1].shape) == (-(-shape[0] // 2), -(-shape[1] // 2))
    torch.testing.assert_close(pyramid.pyr_down(torch.from_numpy(img)), got[1],
                               rtol=0, atol=0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=FILTER_ATOL)


@pytest.mark.parametrize("src,dst", [((37, 53), (18, 26)), ((20, 30), (41, 61)),
                                     ((5, 7), (1, 3))])
def test_align_corners_resize_matches_jax(src, dst, rng):
    """src = dst * (S - 1) / (D - 1), a size-1 output axis reading index 0;
    the half-pixel default stays as it was."""
    img = rng.uniform(0, 255, (2,) + src).astype(np.float32)
    for ac in (True, False):
        want = np.asarray(jresize.resize_bilinear(img, dst, align_corners=ac))
        got = resize.resize_bilinear(torch.from_numpy(img), dst, align_corners=ac)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)


def test_image_pyramid_resize_matches_jax(rng):
    img = rng.uniform(0, 1, (3, 50, 70)).astype(np.float32)
    for ac in (False, True):
        want = jpyramid.image_pyramid_resize(img, 4, align_corners=ac,
                                             channel_last=False)
        got = pyramid.image_pyramid_resize(torch.from_numpy(img), 4, align_corners=ac)
        assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


@pytest.mark.parametrize("H,W", [(240, 320), (101, 133)])
def test_lk_matches_jax(H, W, rng):
    """cv2's corners plus points at and beyond the border (windows hanging
    off the image, one far outside): tracked points, status and err against
    the JAX tracker."""
    f1, f2 = _pair(rng, H, W)
    pts = cv2.goodFeaturesToTrack(f1, 500, 0.01, 8).reshape(-1, 2)
    pts = np.concatenate([pts, np.float32([
        [2.0, 2.0], [W - 3, 3.0], [1.5, H - 3], [W - 3.5, H - 2], [5000.0, 5000.0],
        [-15.0, 40.0]])])
    want = jlk.calc_optical_flow_pyr_lk(f1.astype(np.float32), f2.astype(np.float32), pts)
    got = calc_optical_flow_pyr_lk(f1, f2, pts, device="cpu")
    assert isinstance(got, LKResult)
    assert got.pts.dtype == torch.float32 and got.status.dtype == torch.uint8
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(want.status))
    np.testing.assert_allclose(got.pts.numpy(), np.asarray(want.pts), rtol=0, atol=LK_PX)
    np.testing.assert_allclose(got.err.numpy(), np.asarray(want.err), rtol=0, atol=LK_ERR)
    assert got.status.numpy()[-2] == 0  # the far-off point


def test_lk_meets_the_cv2_bars(rng):
    """BASELINE config 2 at tests/test_lucas_kanade.py's bars: >= 95% of
    cv2's tracked points tracked, mean distance to cv2's < 0.05 px, EPE
    against the true shift within 0.05 px of cv2's."""
    f1, f2 = _pair(rng)
    pts = cv2.goodFeaturesToTrack(f1, 500, 0.01, 8).reshape(-1, 2)
    ref_pts, ref_st, _ = cv2.calcOpticalFlowPyrLK(
        f1, f2, pts.reshape(-1, 1, 2), None, winSize=(21, 21), maxLevel=3,
        criteria=(cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT, 30, 0.01))
    ref_pts, ref_st = ref_pts.reshape(-1, 2), ref_st.ravel()
    res = calc_optical_flow_pyr_lk(f1, f2, pts, device="cpu")
    ours, st = res.pts.numpy(), res.status.numpy()
    both = (ref_st == 1) & (st == 1)
    assert both.sum() >= 0.95 * (ref_st == 1).sum()
    assert np.linalg.norm(ours[both] - ref_pts[both], axis=-1).mean() < 0.05
    gt = pts + np.float32([-3.3, 2.6])
    ours_epe = np.linalg.norm(ours[both] - gt[both], axis=-1).mean()
    cv2_epe = np.linalg.norm(ref_pts[both] - gt[both], axis=-1).mean()
    assert ours_epe < cv2_epe + 0.05


def test_lk_initial_flow_criteria_and_window_rules(rng):
    """``next_pts`` seeds the search only with ``use_initial_flow``; cv2's
    3-tuple criteria equal the 2-tuple; a non-square window raises; the
    seeded search lands on the true 6 px shift (tests/test_lucas_kanade.py's
    0.2 px bar)."""
    f1, f2 = _pair(rng, shift=(6.0, 0.0))
    pts = cv2.goodFeaturesToTrack(f1, 100, 0.01, 10).reshape(-1, 2)
    seeded = calc_optical_flow_pyr_lk(f1, f2, pts, next_pts=pts + np.float32([5.5, 0.0]),
                                      use_initial_flow=True, device="cpu")
    ok = seeded.status.numpy() == 1
    gt = pts + np.float32([6.0, 0.0])
    assert np.linalg.norm(seeded.pts.numpy()[ok] - gt[ok], axis=-1).mean() < 0.2
    want = jlk.calc_optical_flow_pyr_lk(
        f1.astype(np.float32), f2.astype(np.float32), pts,
        next_pts=pts + np.float32([5.5, 0.0]), use_initial_flow=True)
    np.testing.assert_allclose(seeded.pts.numpy(), np.asarray(want.pts), rtol=0, atol=LK_PX)

    base = calc_optical_flow_pyr_lk(f1, f2, pts, device="cpu")
    garbage = calc_optical_flow_pyr_lk(f1, f2, pts, next_pts=pts + np.float32([500.0, -900.0]),
                                       criteria=(3, 30, 0.01), device="cpu")
    np.testing.assert_array_equal(garbage.pts.numpy(), base.pts.numpy())
    with pytest.raises(NotImplementedError):
        calc_optical_flow_pyr_lk(f1, f2, pts, win_size=(21, 15), device="cpu")


def test_lk_status_kills_offimage_points(rng):
    f1, f2 = _pair(rng)
    res = calc_optical_flow_pyr_lk(f1, f2, np.float32([[5000.0, 5000.0], [160.0, 120.0]]),
                                   device="cpu")
    assert res.status.tolist() == [0, 1]


def test_lk_short_loop_matches_jax_without_latching(rng):
    """Three steps per level with a coarse eps: points freeze and move
    again between steps (the freeze is re-tested each step), as in the
    reference's fori_loop."""
    f1, f2 = _pair(rng, 120, 160, shift=(2.7, -1.9))
    pts = cv2.goodFeaturesToTrack(f1, 150, 0.01, 6).reshape(-1, 2)
    for criteria in ((3, 0.3), (1, 0.01), (5, 0.0)):
        want = jlk.calc_optical_flow_pyr_lk(f1.astype(np.float32), f2.astype(np.float32),
                                            pts, criteria=criteria)
        got = calc_optical_flow_pyr_lk(f1, f2, pts, criteria=criteria, device="cpu")
        np.testing.assert_array_equal(got.status.numpy(), np.asarray(want.status))
        np.testing.assert_allclose(got.pts.numpy(), np.asarray(want.pts), rtol=0, atol=LK_PX)


def _textured(rng, H, W):
    return cv2.GaussianBlur(rng.uniform(0, 255, (H + 40, W + 40)).astype(np.float32),
                            (0, 0), 1.5)[20:20 + H, 20:20 + W].astype(np.uint8)


@pytest.mark.parametrize("H,W", [(240, 320), (480, 640), (50, 64)])
def test_corner_min_eig_val_equals_cv2_bit_for_bit(H, W, rng):
    """Bit for bit at widths that are a multiple of cv2's vector width (16
    floats on an AVX-512 host; camera widths are): the last W mod 16
    columns go through cv2's scalar tail, which rounds its Sobel dy row
    pass differently in the last bit."""
    img = _textured(rng, H, W)
    np.testing.assert_array_equal(corners.corner_min_eig_val(torch.from_numpy(img)).numpy(),
                                  cv2.cornerMinEigenVal(img, 3, ksize=3))


@pytest.mark.parametrize("source", ["textured", "camera"])
@pytest.mark.parametrize("args", [(500, 0.01, 8), (200, 0.01, 8), (0, 0.05, 10),
                                  (100, 0.01, 0.5), (300, 0.01, 7.5)],
                         ids=["500", "200", "all", "no-distance", "fractional"])
def test_good_features_equal_cv2(source, args, rng):
    """The same corners in the same order (ties included) as
    cv2.goodFeaturesToTrack, on a textured 240x320 frame and on the
    SyntheticCamera's 640x480 gray frames."""
    if source == "textured":
        imgs = [_textured(rng, 240, 320)]
    else:
        cam = SyntheticCamera(width=640, height=480)
        imgs = [_gray_u8(cam.frame_at(i)) for i in (0, 7)]
    for img in imgs:
        want = cv2.goodFeaturesToTrack(img, *args).reshape(-1, 2)
        got = corners.good_features_to_track(img, *args, device="cpu")
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_good_features_ties_follow_cv2(rng):
    """A periodic image (every response repeated) and a checkerboard:
    the tie order is cv2's."""
    tile = rng.integers(0, 255, (16, 16)).astype(np.uint8)
    cb = ((np.indices((120, 160)) // 10).sum(0) % 2 * 200 + 20).astype(np.uint8)
    for img, args in ((np.tile(tile, (20, 30)), (500, 0.01, 8)),
                      (np.tile(tile, (20, 30)), (2000, 0.01, 3)),
                      (cb, (500, 0.01, 8)), (cb, (100, 0.01, 2))):
        want = cv2.goodFeaturesToTrack(img, *args).reshape(-1, 2)
        np.testing.assert_array_equal(
            corners.good_features_to_track(img, *args, device="cpu"), want)
    flat = np.full((40, 50), 7, np.uint8)
    assert corners.good_features_to_track(flat, 10, 0.01, 8, device="cpu").shape == (0, 2)
