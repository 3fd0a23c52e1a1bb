"""The port's cv2 building blocks of the junction detector
(``core/contours.py``) held against cv2 on seeded numpy inputs: the two
blurs and the adaptive threshold bit for bit, the contours as point sets
with their areas and boxes (and as the very chains cv2 traces), the convex
hull and the minimum-area rectangle within 1e-4."""
import cv2
import numpy as np
import pytest

from opticalflowcontainer_tpu_torch.core import contours as C

SIZES = [(1, 1), (2, 3), (5, 4), (7, 9), (16, 16), (31, 37), (48, 64), (61, 83)]


@pytest.mark.parametrize("shape", SIZES + [(480, 640)])
def test_gaussian_blur_u8_bit_equal_to_cv2(shape):
    """(3, 3) BORDER_REFLECT_101 (the detector's blur) and (11, 11)
    BORDER_REPLICATE | BORDER_ISOLATED (inside adaptiveThreshold's box),
    with 5 and 7 too: OpenCV's 8-bit fixed point, bit for bit."""
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    for k in (3, 5, 7):
        if min(shape) > k // 2:  # reflect-101 needs the border inside the image
            want = cv2.GaussianBlur(img, (k, k), 0, borderType=cv2.BORDER_REFLECT_101)
            np.testing.assert_array_equal(C.gaussian_blur_u8(img, k, 0.0, "reflect101"), want)
    want = cv2.GaussianBlur(img, (11, 11), 0,
                            borderType=cv2.BORDER_REPLICATE | cv2.BORDER_ISOLATED)
    np.testing.assert_array_equal(C.gaussian_blur_u8(img, 11, 0.0, "replicate"), want)


def test_gaussian_kernel_matches_cv2():
    """The float kernel is getGaussianKernel's float32 taps (size 9 is left
    out: cv2's float table has a fixed kernel for it, its bit-exact 8-bit
    path does not, and the detector uses neither); the fixed one sums to
    256."""
    for k in (3, 5, 7, 11, 13):
        want = cv2.getGaussianKernel(k, 0, ktype=cv2.CV_32F).ravel()
        np.testing.assert_array_equal(np.float32(C._gaussian_kernel(k, 0.0)), want)
        assert C.gaussian_kernel_fixed(k).sum() == 256


@pytest.mark.parametrize("shape", SIZES + [(240, 320), (480, 640)])
def test_adaptive_threshold_bit_equal_to_cv2(shape):
    """ADAPTIVE_THRESH_GAUSSIAN_C, THRESH_BINARY_INV, block 11, C 2, on
    noise and on smooth images (where src - mean sits near the threshold
    more often)."""
    rng = np.random.default_rng(shape[0] + 7 * shape[1])
    noise = rng.integers(0, 256, shape, dtype=np.uint8)
    smooth = cv2.GaussianBlur(noise, (5, 5), 0)
    for img in (noise, smooth):
        want = cv2.adaptiveThreshold(img, 255, cv2.ADAPTIVE_THRESH_GAUSSIAN_C,
                                     cv2.THRESH_BINARY_INV, 11, 2)
        np.testing.assert_array_equal(C.adaptive_threshold_gaussian_inv(img), want)


def test_gaussian_mean_f32_matches_cv2_float_blur():
    """The float mean equals cv2's float32 GaussianBlur bit for bit on
    widths that are multiples of 16 (its vector loop), within 1e-4 on the
    scalar tail."""
    rng = np.random.default_rng(1)
    for shape in ((48, 64), (31, 37), (100, 101)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        want = cv2.GaussianBlur(img.astype(np.float32), (11, 11), 0,
                                borderType=cv2.BORDER_REPLICATE | cv2.BORDER_ISOLATED)
        got = C.gaussian_mean_f32(img, 11)
        body = (shape[1] // 16) * 16
        np.testing.assert_array_equal(got[:, :body], want[:, :body])
        assert np.abs(got - want).max() <= 1e-4


def _key(contour, area, rect):
    pts = tuple(sorted(set(map(tuple, np.asarray(contour).reshape(-1, 2).tolist()))))
    return pts, area, tuple(rect)


def _check_contours(img):
    want, _ = cv2.findContours(img.copy(), cv2.RETR_TREE, cv2.CHAIN_APPROX_NONE)
    got = C.find_contours(img)
    assert sorted(_key(c, cv2.contourArea(c), cv2.boundingRect(c)) for c in want) == \
        sorted(_key(c, C.contour_area(c), C.bounding_rect(c)) for c in got)
    # the chains themselves: the same start pixel and order as cv2's
    by_set = {_key(c, 0, ())[0]: c for c in got}
    for c in want:
        c = c.reshape(-1, 2)
        np.testing.assert_array_equal(by_set[_key(c, 0, ())[0]], c)
    simple, _ = cv2.findContours(img.copy(), cv2.RETR_TREE, cv2.CHAIN_APPROX_SIMPLE)
    assert sorted(tuple(map(tuple, c.reshape(-1, 2).tolist())) for c in simple) == \
        sorted(tuple(map(tuple, C.approx_simple(c).tolist())) for c in got)
    return len(got)


def test_find_contours_random_blobs():
    """Random binary images (speckle and blurred blobs) of many sizes: the
    same multiset of (point set, area, bounding rect), the same chains."""
    rng = np.random.default_rng(0)
    total = 0
    for t in range(120):
        H, W = (int(v) for v in rng.integers(1, 48, 2))
        img = (rng.uniform(size=(H, W)) < rng.uniform(0.2, 0.8)).astype(np.uint8) * 255
        if t % 2:
            img = (cv2.GaussianBlur(img, (5, 5), 0) > 128).astype(np.uint8)
        total += _check_contours(img)
    assert total > 1000


def test_find_contours_nested_lines_and_border():
    """Nested holes with an island, one-pixel lines (traced both ways),
    isolated pixels, foreground on every edge of the image, an empty and a
    full image."""
    img = np.zeros((40, 44), np.uint8)
    cv2.rectangle(img, (2, 2), (37, 37), 255, -1)
    cv2.rectangle(img, (6, 6), (33, 33), 0, -1)
    cv2.rectangle(img, (10, 10), (29, 29), 255, -1)
    cv2.rectangle(img, (14, 14), (25, 25), 0, -1)
    img[19, 19] = 255
    cv2.line(img, (0, 0), (43, 5), 255, 1)
    cv2.line(img, (0, 39), (43, 39), 255, 1)
    cv2.line(img, (41, 8), (41, 30), 255, 1)
    img[3, 40] = 255
    assert _check_contours(img) == 8
    assert _check_contours(np.full((5, 6), 7, np.uint8)) == 1
    assert _check_contours(np.zeros((4, 4), np.uint8)) == 0


def test_convex_hull_and_min_area_rect_on_contours():
    """cv2.convexHull's order (start point included) and cv2.minAreaRect /
    cv2.boxPoints within 1e-4 on every contour of thresholded noise,
    CHAIN_APPROX_NONE and CHAIN_APPROX_SIMPLE (the detector's input)."""
    rng = np.random.default_rng(5)
    n = 0
    for _ in range(40):
        H, W = (int(v) for v in rng.integers(8, 40, 2))
        img = (rng.uniform(size=(H, W)) < 0.45).astype(np.uint8)
        for mode in (cv2.CHAIN_APPROX_NONE, cv2.CHAIN_APPROX_SIMPLE):
            for c in cv2.findContours(img, cv2.RETR_TREE, mode)[0]:
                c = c.reshape(-1, 2)
                want = cv2.minAreaRect(c)
                got = C.min_area_rect(c)
                np.testing.assert_allclose([*got[0], *got[1], got[2]],
                                           [*want[0], *want[1], want[2]], atol=1e-4)
                np.testing.assert_allclose(C.box_points(got), cv2.boxPoints(want), atol=1e-4)
                n += 1
    assert n > 1000


def test_min_area_rect_on_point_sets():
    """Random point sets (distinct points), axis-aligned rectangles (ties
    between the sides), triangles, segments and single points, within
    1e-4; the hull's vertices in cv2's cyclic order."""
    rng = np.random.default_rng(6)
    sets = []
    for t in range(300):
        n = int(rng.integers(1, 30))
        sets.append(rng.choice(60 * 60, n, replace=False).reshape(-1, 1)
                    // [60, 1] % 60 - 20)
    for _ in range(40):
        x0, y0, w, h = (int(v) for v in rng.integers(0, 10, 4))
        sets.append(np.array([[x0, y0], [x0 + w, y0], [x0 + w, y0 + h], [x0, y0 + h]]))
    sets += [np.array([[0, 0], [2, 0], [4, 0]]), np.array([[0, 0], [0, 3]]),
             np.array([[2, 3]])]
    for pts in sets:
        pts = np.asarray(pts, np.int32)
        want = cv2.minAreaRect(pts)
        got = C.min_area_rect(pts)
        np.testing.assert_allclose([*got[0], *got[1], got[2]],
                                   [*want[0], *want[1], want[2]], atol=1e-4)
        np.testing.assert_allclose(C.box_points(got), cv2.boxPoints(want), atol=1e-4)
        hull = C.convex_hull(pts)
        ref = cv2.convexHull(pts).reshape(-1, 2)
        if len(ref) >= 3:
            k = [tuple(p) for p in ref.tolist()].index(tuple(hull[0]))
            np.testing.assert_array_equal(hull, np.roll(ref, -k, axis=0))


def test_contour_helpers_reject_bad_input():
    with pytest.raises(ValueError):
        C.gaussian_blur_u8(np.zeros((4, 4), np.float32), 3)
    with pytest.raises(ValueError):
        C.gaussian_kernel_fixed(4)
    with pytest.raises(ValueError):
        C.find_contours(np.zeros((2, 2, 3), np.uint8))
