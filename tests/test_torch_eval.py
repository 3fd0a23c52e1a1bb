"""The port's eval metrics, affine operations, pair generators and dataset
loaders against the JAX package's and cv2's, on the same inputs.

Bars, each stated where it is checked:
- the EPE statistics equal JAX's (NaN on an empty mask included) and
  ``affine_warp_pad`` equals JAX's;
- ``rotation_matrix_2d`` within 1e-12 of cv2; ``gaussian_blur`` within 1e-3
  of cv2 on 0-255 float32 images (float sums in another order);
  ``warp_affine_linear`` within 1e-3 of ``cv2.warpAffine`` on 0-255 images
  (it computes what OpenCV 5 computes and is bit-equal here);
  ``copy_make_border_reflect101`` equal to cv2's;
- the generators' ground truth within 1e-5 px of JAX's and their images
  within 4e-6 of JAX's on [0, 1] (the blur's rounding);
- the Sintel and KITTI loaders equal to JAX's on trees written here."""
import importlib
import math

import cv2
import numpy as np
import pytest

from opticalflowcontainer_tpu.eval import datasets as jds
from opticalflowcontainer_tpu.utils.flo import write_flo
from opticalflowcontainer_tpu_torch.core import affine
from opticalflowcontainer_tpu_torch.eval import datasets as pds

from test_torch_threads import one_torch_thread  # noqa: F401

# the packages' ``eval.epe`` attribute is the function the module exports
jepe = importlib.import_module("opticalflowcontainer_tpu.eval.epe")
pepe = importlib.import_module("opticalflowcontainer_tpu_torch.eval.epe")


def _flows(seed=0, shape=(20, 30, 2)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32) * 3,
            rng.standard_normal(shape).astype(np.float32) * 3)


@pytest.mark.parametrize("mask", ["none", "half", "empty"])
def test_epe_stats_equal_jax(mask):
    flow, gt = _flows()
    valid = {"none": None, "half": np.arange(600).reshape(20, 30) % 2 == 0,
             "empty": np.zeros((20, 30), bool)}[mask]
    want, got = jepe.epe_stats(flow, gt, valid), pepe.epe_stats(flow, gt, valid)
    assert want.keys() == got.keys()
    for k in want:
        assert (math.isnan(want[k]) and math.isnan(got[k])) or want[k] == got[k], k
    for fn in ("epe", "outlier_rate"):
        a, b = getattr(jepe, fn)(flow, gt, valid), getattr(pepe, fn)(flow, gt, valid)
        assert (math.isnan(a) and math.isnan(b)) or a == b, fn
    if mask == "empty":
        assert all(math.isnan(v) for v in got.values())


@pytest.mark.parametrize("args", [(128, 160, 4.0, 2.0, (0.98, 1.02)),
                                  (480, 640, 16.0, 8.0, (0.92, 1.1)),
                                  (37, 1000, 0.0, 0.0, (1.0, 1.0))])
def test_affine_warp_pad_equals_jax(args):
    assert pds.affine_warp_pad(*args) == jds.affine_warp_pad(*args)


@pytest.mark.parametrize("center,angle,scale", [((347.0, 267.0), 1.7, 1.013),
                                                ((80.5, 64.5), -7.9, 0.93),
                                                ((0.3, 0.7), 0.0, 1.0),
                                                ((100.0, 50.0), 180.0, 2.0)])
def test_rotation_matrix_2d_within_1e12_of_cv2(center, angle, scale):
    got = affine.rotation_matrix_2d(center, angle, scale)
    assert np.abs(got - cv2.getRotationMatrix2D(center, angle, scale)).max() <= 1e-12


@pytest.mark.parametrize("sigma", [0.8, 1.2, 2.0, 3.0])
@pytest.mark.parametrize("shape", [(100, 130), (60, 70, 3)], ids=["gray", "rgb"])
def test_gaussian_blur_within_1e3_of_cv2(sigma, shape):
    img = np.random.default_rng(3).uniform(0, 255, shape).astype(np.float32)
    got = affine.gaussian_blur(img, sigma)
    assert got.dtype == np.float32 and got.shape == img.shape
    assert np.abs(got - cv2.GaussianBlur(img, (0, 0), sigma)).max() <= 1e-3


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("W", [5, 17, 203, 208, 694])
def test_warp_affine_linear_within_1e3_of_cv2(channels, W):
    """Widths on both sides of OpenCV's 16-column vector loop, canvases
    larger than the output, motion that takes taps out of the image."""
    rng = np.random.default_rng(W + channels)
    H = 534 if W > 600 else 37
    shape = (H + 10, W + 10) + ((channels,) if channels > 1 else ())
    img = cv2.GaussianBlur(rng.uniform(0, 255, shape).astype(np.float32), (0, 0), 2.0)
    M = cv2.getRotationMatrix2D((W / 2, H / 2), rng.uniform(-8, 8), rng.uniform(0.92, 1.1))
    M[:, 2] += rng.uniform(-16, 16, 2)
    want = cv2.warpAffine(img, M, (W, H))
    got = affine.warp_affine_linear(img, M, (W, H))
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-3


def test_copy_make_border_reflect101_equals_cv2():
    img = np.random.default_rng(4).uniform(0, 1, (20, 30, 3)).astype(np.float32)[..., ::-1]
    want = cv2.copyMakeBorder(img, 3, 4, 5, 6, cv2.BORDER_REFLECT_101)
    assert np.array_equal(affine.copy_make_border_reflect101(img, 3, 4, 5, 6), want)


def _check_pairs(want, got):
    assert len(want) == len(got)
    for (a1, a2, ag, av), (b1, b2, bg, bv) in zip(want, got):
        assert av is None and bv is None
        for a, b in ((a1, b1), (a2, b2), (ag, bg)):
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        assert np.abs(ag - bg).max() <= 1e-5
        assert max(np.abs(a1 - b1).max(), np.abs(a2 - b2).max()) <= 4e-6


@pytest.mark.parametrize("hard", [False, True], ids=["easy", "hard"])
def test_synthetic_pairs_match_jax(hard):
    kw = dict(n=3, H=128, W=160, seed=0, hard=hard)
    _check_pairs(jds.synthetic_eval_pairs(**kw), pds.synthetic_eval_pairs(**kw))


@pytest.mark.parametrize("hard", [False, True], ids=["easy", "hard"])
def test_fishnet_pairs_match_jax(hard):
    """Pair 0 warps the golden image, pairs 1-3 the three textures."""
    kw = dict(n=4, H=120, W=160, seed=0, hard=hard)
    _check_pairs(jds.fishnet_eval_pairs(**kw), pds.fishnet_eval_pairs(**kw))


def test_fishnet_pairs_without_the_golden_image_match_jax(tmp_path):
    kw = dict(n=2, H=64, W=80, seed=3, image_path=str(tmp_path / "absent.png"))
    _check_pairs(jds.fishnet_eval_pairs(**kw), pds.fishnet_eval_pairs(**kw))


def _write_sintel(root, rng):
    for scene in ("alley_1", "bamboo_2"):
        d = root / "training" / "clean" / scene
        f = root / "training" / "flow" / scene
        d.mkdir(parents=True)
        f.mkdir(parents=True)
        for i in range(1, 4):
            cv2.imwrite(str(d / f"frame_{i:04d}.png"),
                        rng.integers(0, 256, (12, 16, 3), dtype=np.uint8))
            if i < 3 and not (scene == "bamboo_2" and i == 2):
                write_flo(str(f / f"frame_{i:04d}.flo"),
                          rng.standard_normal((12, 16, 2)).astype(np.float32))


def _write_kitti(root, rng):
    img, occ = root / "training" / "image_2", root / "training" / "flow_occ"
    img.mkdir(parents=True)
    occ.mkdir(parents=True)
    for fid in ("000000", "000007"):
        for k in ("10", "11"):
            cv2.imwrite(str(img / f"{fid}_{k}.png"),
                        rng.integers(0, 256, (10, 14, 3), dtype=np.uint8))
        raw = rng.integers(0, 65536, (10, 14, 3)).astype(np.uint16)  # B, G, R
        raw[..., 0] = rng.integers(0, 2, (10, 14))
        cv2.imwrite(str(occ / f"{fid}_10.png"), raw)


@pytest.mark.parametrize("which", ["sintel", "kitti"])
def test_dataset_loaders_equal_jax(tmp_path, which):
    rng = np.random.default_rng(5)
    if which == "sintel":
        _write_sintel(tmp_path, rng)
        want, got = jds.SintelDataset(str(tmp_path)), pds.SintelDataset(str(tmp_path))
        assert want.pairs == got.pairs and len(got) == 3
    else:
        _write_kitti(tmp_path, rng)
        want, got = jds.KittiFlowDataset(str(tmp_path)), pds.KittiFlowDataset(str(tmp_path))
        assert want.ids == got.ids == ["000000", "000007"]
    for i in range(len(got)):
        for a, b in zip(want[i], got[i]):
            if a is None:
                assert b is None
            else:
                assert a.dtype == b.dtype and np.array_equal(a, b)
    assert len(pds.SintelDataset(str(tmp_path / "none"))) == 0
    assert len(pds.KittiFlowDataset(str(tmp_path / "none"))) == 0
