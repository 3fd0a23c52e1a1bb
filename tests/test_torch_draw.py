"""The port's line rasterizer (``core/draw.py``), its arrow overlays
(``runtime/viz.py``), ``SpikeDumper`` and ``FrameDirectorySource`` against
cv2 and the JAX package's, on the same inputs.

Bars: thickness-1 lines and arrows bit-equal to cv2, end points outside the
image included.  Thickness-2 lines and rectangles: at least IoU 0.9 with
cv2's pixels is what the overlays need; the port follows OpenCV 5's
``ThickLine`` and is held bit-equal here.  ``draw_flow_arrows``,
``grid_mean_arrows``, the spike dumps' pixels and the directory source's
frames bit-equal to the JAX package's."""
import glob
import os

import cv2
import numpy as np
import pytest

from opticalflowcontainer_tpu.runtime import sources as jsources
from opticalflowcontainer_tpu.runtime import timing as jtiming
from opticalflowcontainer_tpu.runtime import viz as jviz
from opticalflowcontainer_tpu_torch.core import draw
from opticalflowcontainer_tpu_torch.runtime import FrameDirectorySource
from opticalflowcontainer_tpu_torch.runtime import timing as ptiming
from opticalflowcontainer_tpu_torch.runtime import viz as pviz
from opticalflowcontainer_tpu_torch.utils.png import imread

H, W = 37, 53


def _points(seed, n, lo=-40, hi=100):
    rng = np.random.default_rng(seed)
    pts = rng.integers(lo, hi, (n, 4))
    pts[::3, :2] = rng.integers(0, 37, (len(pts[::3]), 2))  # a third start inside
    return [((int(a), int(b)), (int(c), int(d))) for a, b, c, d in pts]


@pytest.mark.parametrize("seed", range(4))
def test_thin_lines_and_arrows_equal_cv2(seed):
    """500 segments a seed, most with an end or both outside the image."""
    for p1, p2 in _points(seed, 500):
        for name, want_fn, got_fn in (
                ("line", lambda a: cv2.line(a, p1, p2, (0, 255, 0), 1),
                 lambda a: draw.line(a, p1, p2, (0, 255, 0), 1)),
                ("arrow", lambda a: cv2.arrowedLine(a, p1, p2, (0, 0, 255), 1, tipLength=0.3),
                 lambda a: draw.arrowed_line(a, p1, p2, (0, 0, 255), 1, tip_length=0.3))):
            want, got = np.zeros((H, W, 3), np.uint8), np.zeros((H, W, 3), np.uint8)
            want_fn(want)
            assert got_fn(got) is got
            assert np.array_equal(got, want), (name, p1, p2)


def _iou(a, b):
    a, b = a.any(-1), b.any(-1)
    return (a & b).sum() / max((a | b).sum(), 1)


@pytest.mark.parametrize("shape", ["line", "rectangle", "arrow"])
def test_thick_shapes_equal_cv2(shape):
    ious = []
    for p1, p2 in _points(10 + len(shape), 300, -10, 70):
        want, got = np.zeros((H, W, 3), np.uint8), np.zeros((H, W, 3), np.uint8)
        if shape == "line":
            cv2.line(want, p1, p2, (0, 255, 0), 2)
            draw.line(got, p1, p2, (0, 255, 0), 2)
        elif shape == "rectangle":
            cv2.rectangle(want, p1, p2, (0, 255, 0), 2)
            draw.rectangle(got, p1, p2, (0, 255, 0), 2)
        else:
            cv2.arrowedLine(want, p1, p2, (0, 0, 255), 2, tipLength=0.3)
            draw.arrowed_line(got, p1, p2, (0, 0, 255), 2, tip_length=0.3)
        if want.any() or got.any():
            ious.append(_iou(want, got))
        assert np.array_equal(got, want), (p1, p2)
    assert min(ious) >= 0.9


def test_gray_image_and_thickness_one_rectangle_equal_cv2():
    want, got = np.zeros((H, W), np.uint8), np.zeros((H, W), np.uint8)
    cv2.rectangle(want, (3, 4), (40, 30), 200, 1)
    draw.rectangle(got, (3, 4), (40, 30), 200, 1)
    assert np.array_equal(got, want)


def _frame_and_flow(seed, h=96, w=128):
    rng = np.random.default_rng(seed)
    frame = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    flow = (rng.standard_normal((h, w, 2)) * 4).astype(np.float32)
    flow[40:50, 60:70] += 30.0  # outliers for the sigma filter
    return frame, flow


@pytest.mark.parametrize("kw", [{}, {"step": 8, "scale": 2.5}, {"outlier_sigma": 1.0}],
                         ids=["default", "dense", "outliers"])
def test_draw_flow_arrows_equals_jax(kw):
    frame, flow = _frame_and_flow(0)
    got = pviz.draw_flow_arrows(frame, flow, **kw)
    assert np.array_equal(got, jviz.draw_flow_arrows(frame, flow, **kw))
    assert not np.array_equal(got, frame)
    gray = frame[..., 0]
    assert np.array_equal(pviz.draw_flow_arrows(gray, flow, **kw),
                          jviz.draw_flow_arrows(gray, flow, **kw))


@pytest.mark.parametrize("grid", [3, 4])
def test_grid_mean_arrows_equals_jax(grid):
    frame, flow = _frame_and_flow(1)
    assert np.array_equal(pviz.grid_mean_arrows(frame, flow, grid),
                          jviz.grid_mean_arrows(frame, flow, grid))


def test_spike_dumper_writes_the_jax_dump(tmp_path):
    frame, flow = _frame_and_flow(2, 32, 48)
    dumps = []
    for mod, sub in ((jtiming, "j"), (ptiming, "p")):
        d = mod.SpikeDumper(out_dir=str(tmp_path / sub), threshold=0.5, max_dumps=2)
        assert d.maybe_dump(frame, flow, vx=0.1) is None
        paths = [d.maybe_dump(frame, flow, vx=v) for v in (0.9, -0.7, 0.9)]
        assert paths[2] is None and all(os.path.exists(p) for p in paths[:2])
        dumps.append([cv2.imread(p) for p in paths[:2]])
    for want, got in zip(*dumps):
        assert np.array_equal(got, want)
    assert np.array_equal(imread(glob.glob(str(tmp_path / "p" / "*.png"))[0]),
                          dumps[0][0])


def test_frame_directory_source_equals_jax(tmp_path):
    rng = np.random.default_rng(3)
    for i in (2, 0, 1):
        img = rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
        cv2.imwrite(str(tmp_path / f"f{i:03d}.png"), img if i else img[..., 0])
    (tmp_path / "notes.txt").write_text("not a frame")
    want = list(jsources.FrameDirectorySource(str(tmp_path)).frames())
    src = FrameDirectorySource(str(tmp_path), fps=60.0)
    got = list(src.frames())
    assert src.files == sorted(glob.glob(str(tmp_path / "*.png")))
    assert len(got) == len(want) == 3
    for a, b in zip(want, got):
        assert b.dtype == a.dtype and np.array_equal(b, a)
