"""The port's PNG reader and writer (``utils/png.py``) against cv2, and its
``.flo`` IO against the JAX package's.

Bars: bit-equal everywhere.  ``imread`` equals ``cv2.imread`` (IMREAD_COLOR
and IMREAD_UNCHANGED) on the repo's fishnet golden image, on cv2-written
PNGs of every layout cv2 writes (gray, BGR, BGRA; uint8 and uint16) and on
PNGs built here with each row filter 0-4 and every colour type; cv2 reads
back what ``imwrite`` wrote; ``.flo`` files are byte-equal."""
import pathlib
import struct
import zlib

import cv2
import numpy as np
import pytest

from opticalflowcontainer_tpu.utils import flo as jflo
from opticalflowcontainer_tpu_torch.utils import flo as pflo
from opticalflowcontainer_tpu_torch.utils import png

GOLDEN = pathlib.Path(__file__).resolve().parent / "data" / "fishnet_golden.png"


def _same(a, b):
    assert a is not None and b is not None
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


@pytest.mark.parametrize("unchanged", [False, True])
def test_imread_equals_cv2_on_the_golden_image(unchanged):
    flag = cv2.IMREAD_UNCHANGED if unchanged else cv2.IMREAD_COLOR
    _same(png.imread(str(GOLDEN), unchanged=unchanged), cv2.imread(str(GOLDEN), flag))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("shape", [(13, 17), (13, 17, 3), (13, 17, 4)],
                         ids=["gray", "bgr", "bgra"])
def test_imread_equals_cv2_on_cv2_written_pngs(tmp_path, dtype, shape):
    rng = np.random.default_rng(0)
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    path = str(tmp_path / "c.png")
    assert cv2.imwrite(path, img)
    _same(png.imread(path), cv2.imread(path, cv2.IMREAD_COLOR))
    _same(png.imread(path, unchanged=True), cv2.imread(path, cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("shape", [(13, 17), (13, 17, 3), (13, 17, 4), (1, 1, 3)],
                         ids=["gray", "bgr", "bgra", "one_pixel"])
def test_cv2_reads_back_imwrite(tmp_path, dtype, shape):
    rng = np.random.default_rng(1)
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    path = str(tmp_path / "p.png")
    assert png.imwrite(path, img)
    _same(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    _same(png.imread(path, unchanged=True), img)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _build_png(samples, ctype, depth, filters, interlace=0, extra=b""):
    """A PNG of ``samples`` [H, W, C] with row r filtered by
    filters[r % len(filters)] (the specification's filters, Paeth's ties a,
    b, c), its IDAT split in two."""
    H = samples.shape[0]
    dt = ">u2" if depth == 16 else np.uint8
    rows_b = samples.astype(dt).view(np.uint8).reshape(H, -1).astype(np.int32)
    bpp = samples.shape[2] * depth // 8
    prev = np.zeros(rows_b.shape[1], np.int32)
    out = []
    for r in range(H):
        x, f = rows_b[r], filters[r % len(filters)]
        a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if f == 0:
            y = x
        elif f == 1:
            y = x - a
        elif f == 2:
            y = x - prev
        elif f == 3:
            y = x - ((a + prev) >> 1)
        else:
            p = a + prev - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
            y = x - np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        out.append(np.concatenate([[f], y & 0xFF]).astype(np.uint8))
        prev = x
    data = zlib.compress(np.concatenate(out).tobytes())
    half = len(data) // 2
    W = samples.shape[1]
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, interlace))
            + extra + _chunk(b"IDAT", data[:half]) + _chunk(b"IDAT", data[half:])
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [4, 3, 2, 1, 0]],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("ctype,channels", [(0, 1), (4, 2), (2, 3), (6, 4)],
                         ids=["gray", "gray_alpha", "rgb", "rgba"])
def test_imread_equals_cv2_on_each_row_filter(tmp_path, filters, depth, ctype, channels):
    """Smooth rows (small cumulative steps) so that Paeth's ties occur."""
    rng = np.random.default_rng(depth + ctype)
    steps = rng.integers(0, 3, (11, 9, channels)).cumsum(1)
    samples = (steps * (300 if depth == 16 else 1)).astype(
        np.uint16 if depth == 16 else np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_build_png(samples, ctype, depth, filters))
    _same(png.imread(str(path)), cv2.imread(str(path), cv2.IMREAD_COLOR))
    _same(png.imread(str(path), unchanged=True),
          cv2.imread(str(path), cv2.IMREAD_UNCHANGED))


def test_sixteen_bit_keeps_the_high_byte(tmp_path):
    """cv2 reads a 16-bit PNG as 8 bits by dropping the low byte (0x01FF ->
    1, not 2 as rounding would give)."""
    samples = np.array([[[0x01FF], [0xFF80], [0x00FF], [0x8000]]], np.uint16)
    path = tmp_path / "s.png"
    path.write_bytes(_build_png(samples, 0, 16, [0]))
    got = png.imread(str(path))
    assert got[0, :, 0].tolist() == [1, 255, 0, 128]
    _same(got, cv2.imread(str(path)))


@pytest.mark.parametrize("case", ["palette", "interlaced", "depth4", "trns", "crc"])
def test_refusals_name_the_file(tmp_path, case):
    samples = np.zeros((4, 4, 3), np.uint8)
    if case == "palette":
        data = _build_png(samples[..., :1], 3, 8, [0])
    elif case == "interlaced":
        data = _build_png(samples, 2, 8, [0], interlace=1)
    elif case == "depth4":
        data = _build_png(samples[..., :1], 0, 8, [0]).replace(
            struct.pack(">IIBB", 4, 4, 8, 0), struct.pack(">IIBB", 4, 4, 4, 0))
    elif case == "trns":
        data = _build_png(samples, 2, 8, [0], extra=_chunk(b"tRNS", b"\0\0\0\0\0\0"))
    else:
        data = bytearray(_build_png(samples, 2, 8, [0]))
        data[-20] ^= 0xFF  # inside the last IDAT
        data = bytes(data)
    path = tmp_path / f"{case}.png"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=f"{case}.png"):
        png.imread(str(path))


def test_flo_files_are_byte_equal_to_jax(tmp_path):
    rng = np.random.default_rng(2)
    flow = rng.standard_normal((7, 11, 2)).astype(np.float32)
    jflo.write_flo(str(tmp_path / "j.flo"), flow)
    pflo.write_flo(str(tmp_path / "p.flo"), flow)
    assert (tmp_path / "j.flo").read_bytes() == (tmp_path / "p.flo").read_bytes()
    _same(pflo.read_flo(str(tmp_path / "j.flo")), jflo.read_flo(str(tmp_path / "j.flo")))
    _same(pflo.read_flo(str(tmp_path / "p.flo")), flow)
    (tmp_path / "bad.flo").write_bytes(b"\0" * 12)
    with pytest.raises(ValueError, match="magic"):
        pflo.read_flo(str(tmp_path / "bad.flo"))
