"""Flow eval datasets (the port's copy of the reference's
``eval/datasets.py``): MPI-Sintel and KITTI-2015 loaders, which find no
pairs unless their directory trees are present, and two generators of
affine pairs with exact ground truth, which are always available.

The generators draw from ``numpy.random.default_rng(seed)`` in the
reference's order and build each pair with the port's copies of the cv2
operations the reference calls (``core/affine.py``), so that a seed gives
the reference's pairs.  Images come back RGB float32 in [0, 1], flows
[H, W, 2] float32, as host arrays.
"""
from __future__ import annotations

import glob
import os

import numpy as np

from ..core.affine import (
    copy_make_border_reflect101,
    gaussian_blur,
    rotation_matrix_2d,
    warp_affine_linear,
)
from ..utils.flo import read_flo
from ..utils.png import imread


class SintelDataset:
    """MPI-Sintel layout: <root>/<split>/<pass>/<scene>/frame_XXXX.png and
    <root>/<split>/flow/<scene>/frame_XXXX.flo; a pair for each consecutive
    pair of frames whose first frame has a flow file."""

    def __init__(self, root: str, split: str = "training", pass_: str = "clean"):
        self.root = root
        self.pairs: list[tuple[str, str, str]] = []
        img_dir = os.path.join(root, split, pass_)
        flow_dir = os.path.join(root, split, "flow")
        if not os.path.isdir(img_dir):
            return
        for scene in sorted(os.listdir(img_dir)):
            frames = sorted(glob.glob(os.path.join(img_dir, scene, "*.png")))
            for a, b in zip(frames[:-1], frames[1:]):
                flo = os.path.join(flow_dir, scene,
                                   os.path.basename(a).replace(".png", ".flo"))
                if os.path.exists(flo):
                    self.pairs.append((a, b, flo))

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, i):
        a, b, flo = self.pairs[i]
        img1 = imread(a)[..., ::-1].astype(np.float32) / 255.0
        img2 = imread(b)[..., ::-1].astype(np.float32) / 255.0
        return img1, img2, read_flo(flo), None


class KittiFlowDataset:
    """KITTI-2015 layout: <root>/<split>/image_2/<id>_10.png and _11.png,
    and flow_occ/<id>_10.png: 16-bit RGB with u, v = (R, G - 2^15) / 64
    and B > 0 where the flow is valid."""

    def __init__(self, root: str, split: str = "training"):
        self.root = root
        self.base = os.path.join(root, split)
        self.ids: list[str] = []
        if os.path.isdir(os.path.join(self.base, "image_2")):
            self.ids = sorted(f[:-7] for f in os.listdir(
                os.path.join(self.base, "image_2")) if f.endswith("_10.png"))

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        fid = self.ids[i]
        img1 = imread(os.path.join(self.base, "image_2", fid + "_10.png"))[..., ::-1]
        img2 = imread(os.path.join(self.base, "image_2", fid + "_11.png"))[..., ::-1]
        raw = imread(os.path.join(self.base, "flow_occ", fid + "_10.png"),
                     unchanged=True)  # BGR uint16
        flow = (raw[..., 2::-1][..., :2].astype(np.float32) - 2**15) / 64.0
        valid = raw[..., 0] > 0
        return (img1.astype(np.float32) / 255.0, img2.astype(np.float32) / 255.0,
                flow, valid)


def affine_warp_pad(H: int, W: int, max_t: float, max_angle: float,
                    scales: tuple[float, float]) -> int:
    """Canvas margin that covers the largest inverse-warp displacement of a
    crop pixel (the warp samples the canvas at M^-1 p): for p = c + r,
    |M^-1 p - p| <= |(1/s) R^-1 - I| |r| + |t|/s, largest at the crop's
    corner and at an end of the scale range.  Plus 4 px."""
    diag = 0.5 * float(np.hypot(H, W))
    ang_r = float(np.deg2rad(max_angle))
    rot_gain = max(
        float(np.sqrt(1.0 + k * k - 2.0 * k * np.cos(ang_r)))
        for k in (1.0 / min(scales), 1.0 / max(scales))
    )
    return int(np.ceil(rot_gain * diag
                       + np.sqrt(2.0) * max_t / min(scales))) + 4


def _regime_pad(H: int, W: int, hard: bool) -> int:
    return (affine_warp_pad(H, W, 16.0, 8.0, (0.92, 1.1)) if hard
            else affine_warp_pad(H, W, 4.0, 2.0, (0.98, 1.02)))


def _draw_motion(rng, hard: bool):
    """(angle in degrees, scale, tx, ty) of one pair: easy <= 4 px and
    +-2 deg, hard <= 16 px and +-8 deg."""
    if hard:
        ang = rng.uniform(-8, 8)
        scale = rng.uniform(0.92, 1.1)
        tx, ty = rng.uniform(-16, 16, 2)
    else:
        ang = rng.uniform(-2, 2)
        scale = rng.uniform(0.98, 1.02)
        tx, ty = rng.uniform(-4, 4, 2)
    return ang, scale, tx, ty


def _warp_pair(base: np.ndarray, H: int, W: int, pad: int, motion):
    """(f1, f2, gt) of the canvas ``base``: f1 its centre crop, f2 the crop of
    the canvas warped by M (rotation and scale about the crop's centre, then
    the translation), gt the forward flow M p - p of each crop pixel."""
    ang, scale, tx, ty = motion
    M = rotation_matrix_2d((W / 2 + pad, H / 2 + pad), ang, scale)
    M[:, 2] += (tx, ty)
    f1 = base[pad:pad + H, pad:pad + W]
    f2 = warp_affine_linear(base, M, (base.shape[1], base.shape[0]))[
        pad:pad + H, pad:pad + W]
    # f2(p) = base(M^-1 p): the canvas point X shows in f2 at M X
    xs, ys = np.meshgrid(np.arange(W, dtype=np.float64) + pad,
                         np.arange(H, dtype=np.float64) + pad)
    x2 = M[0, 0] * xs + M[0, 1] * ys + M[0, 2]
    y2 = M[1, 0] * xs + M[1, 1] * ys + M[1, 2]
    gt = np.stack([x2 - xs, y2 - ys], axis=-1).astype(np.float32)
    return f1, f2, gt


def synthetic_eval_pairs(n: int = 8, H: int = 128, W: int = 160, seed: int = 0,
                         hard: bool = False):
    """Warped-noise pairs with exact affine ground truth:
    [(img1, img2, gt, None)] with gray images repeated into RGB.

    ``hard=True`` is the regime where brightness constancy breaks: motion up
    to ~16 px, stronger rotation and zoom, a finer second texture layer, a
    gain and offset on the second frame and sensor noise on both."""
    rng = np.random.default_rng(seed)
    pad = _regime_pad(H, W, hard)
    out = []
    for _ in range(n):
        base = gaussian_blur(
            rng.uniform(0, 255, (H + 2 * pad, W + 2 * pad)).astype(np.float32), 2.0)
        if hard:
            base = 0.7 * base + 0.3 * gaussian_blur(
                rng.uniform(0, 255, base.shape).astype(np.float32), 0.8)
        f1, f2, gt = _warp_pair(base, H, W, pad, _draw_motion(rng, hard))
        if hard:
            gain = rng.uniform(0.6, 1.4)
            offset = rng.uniform(-25, 25)
            f2 = np.clip(f2 * gain + offset, 0, 255)
            f1 = np.clip(f1 + rng.normal(0, 4, f1.shape), 0, 255).astype(np.float32)
            f2 = np.clip(f2 + rng.normal(0, 4, f2.shape), 0, 255).astype(np.float32)
        g1 = np.repeat(f1[..., None], 3, -1) / 255.0
        g2 = np.repeat(f2[..., None], 3, -1) / 255.0
        out.append((g1.astype(np.float32), g2.astype(np.float32), gt, None))
    return out


_FISHNET_PNG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "tests", "data", "fishnet_golden.png",
)


def fishnet_eval_pairs(n: int = 32, H: int = 480, W: int = 640, seed: int = 0,
                       hard: bool = False, image_path: str | None = None):
    """Deployment-domain pairs at the camera's operating point: exact-GT
    affine warps of the fishnet golden image (reflect-padded to the canvas)
    taken in turn with three procedural textures (blur sigma 2.0, 1.2, 3.0).
    Motion and photometric regimes as :func:`synthetic_eval_pairs`.
    Returns [(img1 RGB float32 [0, 1], img2, gt [H, W, 2], None)]; without
    the golden image, textures only."""
    rng = np.random.default_rng(seed)
    pad = _regime_pad(H, W, hard)
    sources = []
    path = image_path or _FISHNET_PNG
    if os.path.exists(path):
        rgb = (imread(path).astype(np.float32) / 255.0)[..., ::-1]
        sy = max(H + 2 * pad - rgb.shape[0], 0)
        sx = max(W + 2 * pad - rgb.shape[1], 0)
        rgb = copy_make_border_reflect101(rgb, (sy + 1) // 2, (sy + 1) // 2,
                                          (sx + 1) // 2, (sx + 1) // 2)
        sources.append(np.ascontiguousarray(rgb, np.float32))
    for sig in (2.0, 1.2, 3.0):
        base = gaussian_blur(
            rng.uniform(0, 1, (H + 2 * pad, W + 2 * pad)).astype(np.float32), sig)
        base -= base.min()
        base /= max(base.max(), 1e-6)
        sources.append(np.repeat(base[..., None], 3, -1))

    out = []
    for i in range(n):
        src = sources[i % len(sources)]
        oy = (src.shape[0] - (H + 2 * pad)) // 2
        ox = (src.shape[1] - (W + 2 * pad)) // 2
        base = src[oy:oy + H + 2 * pad, ox:ox + W + 2 * pad]
        f1, f2, gt = _warp_pair(base, H, W, pad, _draw_motion(rng, hard))
        if hard:
            gain = rng.uniform(0.6, 1.4)
            offset = rng.uniform(-0.1, 0.1)
            f2 = np.clip(f2 * gain + offset, 0, 1)
            f1 = np.clip(f1 + rng.normal(0, 0.016, f1.shape), 0, 1)
            f2 = np.clip(f2 + rng.normal(0, 0.016, f2.shape), 0, 1)
        out.append((f1.astype(np.float32), f2.astype(np.float32), gt, None))
    return out
