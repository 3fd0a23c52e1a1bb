"""The committed codec fixtures of tests/data/, and how they were made.

    python tests/_torch_codec_fixtures.py        # rewrite them (needs cv2)

- ``synthetic_640x480_mjpeg.avi``: ``N_FRAMES`` frames of the JAX
  package's ``SyntheticCamera`` (640x480, seed 0, ``VELOCITY_MPS`` at the
  default pixel_to_meter 0.000857 and 30 fps: ``PX_PER_FRAME`` pixels a
  frame to the right), written by cv2's Motion-JPEG writer (FFmpeg's
  encoder, 4:2:0, a DHT in every frame);
- ``mixed_filters_640x480.png``: a colour image written by cv2 with
  ``IMWRITE_PNG_ALL_FILTERS`` (libpng's adaptive choice: rows of all five
  filter types);
- ``restart_444.jpg``: a 4:4:4 JPEG with a restart marker every 7 MCUs,
  written by cv2 at quality 90.

The CPU tests hold the port's decode of each against cv2's; chip_smoke.py
reads them on the card, where there is no cv2.
"""
from __future__ import annotations

import pathlib

import numpy as np

DATA = pathlib.Path(__file__).resolve().parent / "data"
AVI = DATA / "synthetic_640x480_mjpeg.avi"
PNG = DATA / "mixed_filters_640x480.png"
JPG = DATA / "restart_444.jpg"
N_FRAMES = 16
VELOCITY_MPS = 0.05
PIXEL_TO_METER = 0.000857
FPS = 30.0
PX_PER_FRAME = VELOCITY_MPS / (PIXEL_TO_METER * FPS)


def colour_image(H: int = 480, W: int = 640, seed: int = 3) -> np.ndarray:
    """A BGR image of colour gradients and a smooth texture, with bands of
    noise, of vertical stripes and of one colour that other row filters
    suit."""
    import cv2

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    tex = cv2.GaussianBlur(rng.uniform(0, 255, (H, W)).astype(np.float32),
                           (0, 0), 3.0)
    b = 255 * x / W
    g = 255 * y / H
    r = 0.5 * tex + 64 * np.sin(x / 37.0) + 64
    img = np.clip(np.stack([b, g, r], -1), 0, 255).astype(np.uint8)
    band = H // 8
    img[:band] = rng.integers(0, 256, (band, W, 3), dtype=np.uint8)
    img[2 * band:3 * band] = rng.integers(0, 256, (1, W, 3), dtype=np.uint8)
    img[4 * band:5 * band] = (40, 90, 200)
    img[6 * band:7 * band, :, 0] = (np.arange(W) * 7 % 256).astype(np.uint8)
    return img


def png_filters(path) -> np.ndarray:
    """How many rows of the PNG at ``path`` use each row filter (0-4)."""
    import struct
    import zlib

    data = pathlib.Path(path).read_bytes()
    pos, idat, header = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IHDR":
            header = struct.unpack(">IIBB", data[pos + 8:pos + 18])
        elif kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    W, H, depth, ctype = header
    bpp = {0: 1, 2: 3, 4: 2, 6: 4}[ctype] * depth // 8
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(H, 1 + W * bpp)
    return np.bincount(raw[:, 0], minlength=5)


def make() -> None:
    import cv2

    from opticalflowcontainer_tpu.runtime.sources import SyntheticCamera

    DATA.mkdir(exist_ok=True)
    cam = SyntheticCamera(width=640, height=480, fps=FPS, n_frames=N_FRAMES,
                          velocity_mps=VELOCITY_MPS,
                          pixel_to_meter=PIXEL_TO_METER, seed=0)
    w = cv2.VideoWriter(str(AVI), cv2.VideoWriter_fourcc(*"MJPG"), FPS,
                        (640, 480))
    assert w.isOpened()
    for f in cam.frames():
        w.write(f)
    w.release()
    assert cv2.imwrite(str(PNG), colour_image(), [
        cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS,
        cv2.IMWRITE_PNG_COMPRESSION, 9])
    ok, buf = cv2.imencode(".jpg", colour_image(seed=4)[:240, :320], [
        cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_RST_INTERVAL, 7,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444])
    assert ok
    JPG.write_bytes(buf.tobytes())


if __name__ == "__main__":
    import sys

    sys.path.insert(0, str(DATA.parent.parent))
    make()
    for p in (AVI, PNG, JPG):
        print(p.name, p.stat().st_size)
    print("row filters", png_filters(PNG))
