"""The port's image decoders (``utils/jpeg.py``, ``utils/png.py``'s bytes
entry, ``utils/imcodec.py``) held against ``cv2.imdecode(buf,
IMREAD_COLOR)`` (libjpeg-turbo 3.1 and libpng in the installed cv2) and
PIL's JPEG decoder, on files cv2 and PIL write here.  Every comparison is
bit for bit.  The plain forms run (``force_python=True``): the compiled
forms need nvcc, and ``tests/test_torch_gpu.py`` holds them against the
plain ones on the card."""
import io

import cv2
import numpy as np
import pytest
from PIL import Image

import _torch_codec_fixtures as fx
from opticalflowcontainer_tpu_torch.ops import _build
from opticalflowcontainer_tpu_torch.runtime import nodes as tnodes
from opticalflowcontainer_tpu_torch.runtime.bus import Bus
from opticalflowcontainer_tpu_torch.runtime.messages import Header, ImageMsg
from opticalflowcontainer_tpu_torch.runtime.sources import VideoFileSource
from opticalflowcontainer_tpu_torch.utils import imcodec, jpeg, png
from test_torch_png import _build_png

SAMPLING = {
    "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
    "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
    "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
    "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
    "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
}
OPTIONS = {
    "plain": [],
    "restart": [cv2.IMWRITE_JPEG_RST_INTERVAL, 3],
    "optimized": [cv2.IMWRITE_JPEG_OPTIMIZE, 1],
}


def smooth(H, W, seed, cell=4):
    """Colour noise on a grid of ``cell`` pixels, cubic-interpolated."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 255, (H // cell + 3, W // cell + 3, 3)).astype(np.float32)
    return np.clip(cv2.resize(x, (W, H), interpolation=cv2.INTER_CUBIC),
                   0, 255).astype(np.uint8)


def noise(H, W, seed):
    return np.random.default_rng(seed).integers(0, 256, (H, W, 3), np.uint8)


def encode(img, quality=90, sampling="420", option="plain"):
    ok, buf = cv2.imencode(".jpg", img, [
        cv2.IMWRITE_JPEG_QUALITY, quality,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]] + OPTIONS[option])
    assert ok
    return buf.tobytes()


def cv2_decode(data: bytes):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


def same(got, want):
    assert got is not None and want is not None
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want), (
        f"{np.count_nonzero(got != want)} of {got.size} samples differ, "
        f"by up to {np.abs(got.astype(int) - want).max()}")


# --------------------------------------------------------------- JPEG

@pytest.mark.parametrize("size", [(48, 64), (50, 70), (1, 1), (17, 9)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
def test_jpeg_equals_cv2_bit_for_bit(sampling, size):
    """Every sampling (4:4:0 and 4:1:1 included: libjpeg-turbo's h1v2 fancy
    filter and its replication are copied), qualities 50/90/100, with and
    without restart intervals and optimized tables, smooth and noisy
    content, at sizes that are and are not MCU multiples."""
    for content in (smooth, noise):
        img = content(*size, seed=size[0] * size[1])
        for quality in (50, 90, 100):
            for option in OPTIONS:
                data = encode(img, quality, sampling, option)
                same(jpeg.imdecode(data, force_python=True), cv2_decode(data))


@pytest.mark.parametrize("sampling", ["444", "422", "420"])
def test_jpeg_at_641x479_with_restarts(sampling):
    data = encode(smooth(479, 641, 7, cell=16), 90, sampling, "restart")
    same(jpeg.imdecode(data, force_python=True), cv2_decode(data))


@pytest.mark.parametrize("size", [(48, 64), (50, 70), (1, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_gray_jpeg_is_repeated_into_three_channels(size):
    gray = cv2.cvtColor(smooth(*size, 3), cv2.COLOR_BGR2GRAY)
    for option in OPTIONS:
        ok, buf = cv2.imencode(".jpg", gray, OPTIONS[option])
        data = buf.tobytes()
        assert data[data.index(b"\xff\xc0") + 9] == 1  # one component
        same(jpeg.imdecode(data, force_python=True), cv2_decode(data))


def test_pil_decodes_the_same():
    """PIL 12.1 (libjpeg-turbo too) is a second oracle for the same files."""
    for sampling in ("444", "422", "420"):
        data = encode(smooth(50, 70, 5), 75, sampling, "restart")
        pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))[..., ::-1]
        same(jpeg.imdecode(data, force_python=True), np.ascontiguousarray(pil))


def _strip(data: bytes, marker: int) -> bytes:
    """``data`` without its marker segments of type ``marker`` (before SOS)."""
    out, pos = bytearray(data[:2]), 2
    while data[pos + 1] != 0xDA:
        n = int.from_bytes(data[pos + 2:pos + 4], "big")
        if data[pos + 1] != marker:
            out += data[pos:pos + 2 + n]
        pos += 2 + n
    return bytes(out + data[pos:])


def test_stripped_dht_takes_the_annex_k_tables():
    """cv2 writes the Annex K tables unless asked to optimize; a Motion-JPEG
    frame without a DHT decodes as the same frame with them."""
    data = encode(smooth(64, 80, 9), 85, "420", "restart")
    bare = _strip(data, 0xC4)
    assert b"\xff\xc4" not in bare[:bare.index(b"\xff\xda")]
    same(jpeg.imdecode(bare, force_python=True), cv2_decode(data))
    same(cv2_decode(bare), cv2_decode(data))


def test_refusals_name_the_marker():
    img = smooth(32, 40, 2)
    ok, prog = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(ValueError, match="SOF2"):
        jpeg.imdecode(prog.tobytes(), force_python=True)
    base = encode(img)
    sof = base.index(b"\xff\xc0")
    for marker, name in ((0xC9, "SOF9"), (0xC3, "SOF3"), (0xC5, "SOF5")):
        data = base[:sof + 1] + bytes([marker]) + base[sof + 2:]
        with pytest.raises(ValueError, match=name):
            jpeg.imdecode(data, force_python=True)
    twelve = base[:sof + 4] + b"\x0c" + base[sof + 5:]
    with pytest.raises(ValueError, match="12-bit"):
        jpeg.imdecode(twelve, force_python=True)
    with pytest.raises(ValueError, match="SOF2"):  # through the dispatcher
        imcodec.imdecode(prog.tobytes(), force_python=True)


def test_truncated_and_damaged_jpeg_give_none():
    """cv2 5.0 returns None for a JPEG cut anywhere (even before EOI);
    so does the port.  A restart marker out of sequence is damage too."""
    data = encode(smooth(40, 48, 5), 90, "420", "restart")
    for cut in list(range(1, len(data) - 1, 97)) + [len(data) - 2, len(data) - 1]:
        assert cv2_decode(data[:cut]) is None
        assert jpeg.imdecode(data[:cut], force_python=True) is None
    rst = data.index(b"\xff\xd1")
    swapped = data[:rst + 1] + b"\xd5" + data[rst + 2:]
    assert jpeg.imdecode(swapped, force_python=True) is None
    assert jpeg.imdecode(b"not a jpeg", force_python=True) is None


# ---------------------------------------------------------------- PNG

def _cv2_png(img):
    ok, buf = cv2.imencode(".png", img, [cv2.IMWRITE_PNG_FILTER,
                                         cv2.IMWRITE_PNG_ALL_FILTERS])
    assert ok
    return buf.tobytes()


def _png_cases():
    """(name, PNG bytes): cv2 writes gray, RGB and RGBA at 8 and 16 bits
    with libpng's adaptive filters; PIL writes 8-bit gray+alpha; the
    16-bit gray+alpha file is built with every row filter."""
    rng = np.random.default_rng(4)
    base = smooth(33, 47, 4)
    cases = [("gray8", _cv2_png(base[..., 0])),
             ("rgb8", _cv2_png(base)),
             ("rgba8", _cv2_png(np.dstack([base, base[..., :1]])))]
    wide = base.astype(np.uint16) * 257 + rng.integers(0, 257, base.shape).astype(np.uint16)
    cases += [("gray16", _cv2_png(wide[..., 0])), ("rgb16", _cv2_png(wide)),
              ("rgba16", _cv2_png(np.dstack([wide, wide[..., 1:2]])))]
    la = io.BytesIO()
    Image.fromarray(np.dstack([base[..., 0], base[..., 2]]), "LA").save(la, "PNG")
    cases.append(("gray_alpha8", la.getvalue()))
    cases.append(("gray_alpha16", _build_png(wide[..., :2], 4, 16, [0, 1, 2, 3, 4])))
    return cases


@pytest.mark.parametrize("name,data", _png_cases(), ids=[c[0] for c in _png_cases()])
def test_png_bytes_equal_cv2(name, data):
    same(png.imdecode(data, force_python=True), cv2_decode(data))
    same(imcodec.imdecode(data, force_python=True), cv2_decode(data))


def test_damaged_png_gives_none_and_unsupported_raises():
    data = _cv2_png(smooth(20, 30, 1))
    assert cv2_decode(data[:-20]) is None
    assert png.imdecode(data[:-20], force_python=True) is None
    crc = bytearray(data)
    crc[40] ^= 0xFF  # inside the IDAT
    assert png.imdecode(bytes(crc), force_python=True) is None
    pal = io.BytesIO()
    Image.fromarray(smooth(20, 30, 1)).convert("P").save(pal, "PNG")
    with pytest.raises(ValueError, match="palette"):
        png.imdecode(pal.getvalue(), force_python=True)


def test_dispatcher_picks_by_signature():
    img = smooth(24, 32, 6)
    j, p = encode(img), _cv2_png(img)
    same(imcodec.imdecode(j, force_python=True), cv2_decode(j))
    same(imcodec.imdecode(np.frombuffer(p, np.uint8), force_python=True),
         cv2_decode(p))
    for other in (b"", b"GIF89a....", b"\xff\xd8", b"\x89PNG\r\n\x1a\n"):
        assert imcodec.imdecode(other, force_python=True) is None


# ------------------------------------------------------ compiled forms

def test_compiled_decoders_raise_without_nvcc(monkeypatch, tmp_path):
    """The compiled forms are the default; without nvcc they raise, and
    nothing falls back to the plain forms.  Data the header walk already
    finds damaged gives None before any build."""
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_lib", None)
    calls = []
    monkeypatch.setattr(jpeg, "_decode_python", lambda *a: calls.append(a))
    monkeypatch.setattr(png, "_unfilter", lambda *a: calls.append(a))
    img = smooth(16, 16, 1)
    for fn, data in ((jpeg.imdecode, encode(img)), (png.imdecode, _cv2_png(img)),
                     (imcodec.imdecode, encode(img))):
        with pytest.raises(RuntimeError, match="nvcc"):
            fn(data)
    node = tnodes.FlowNode(lambda *a: None, bus=Bus()).attach()
    node.bus.publish("/camera/color/image_raw",
                     ImageMsg(Header(1.0), encode(img), "jpeg"))
    assert node.frames_failed == 1  # raised, counted, traceback printed
    node.stop()
    assert imcodec.imdecode(b"\xff\xd8\xff\xd9") is None
    assert calls == []


def test_decoder_source_is_built_with_the_kernels():
    """``image_decode.cpp`` goes through the kernels' one nvcc call, so its
    text is in the library's hash: an edited decoder is never served by a
    stale library."""
    src = _build.CSRC / "image_decode.cpp"
    assert src in _build._sources()
    assert {"ofc_jpeg_decode", "ofc_png_unfilter"} <= set(_build._SIGNATURES)
    for i, line in enumerate(src.read_text().splitlines(), 1):
        assert "\t" not in line and line == line.rstrip(), f"line {i}"


def test_library_hash_covers_the_decoder(monkeypatch, tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for s in _build._sources():
        (csrc / s.name).write_bytes(s.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build.library_path()
    (csrc / "image_decode.cpp").write_text(
        (csrc / "image_decode.cpp").read_text() + "// edited\n")
    assert _build.library_path() != before


# ------------------------------------------------------- the fixtures

def test_committed_fixtures_decode_as_cv2_decodes_them():
    """Every frame of the 640x480 Motion-JPEG fixture equals cv2.imdecode of
    its chunk (located through the file's idx1 index, not the port's
    walk), and the PNG and JPEG fixtures equal cv2.imread."""
    data = fx.AVI.read_bytes()
    movi = data.index(b"movi")
    idx = data.index(b"idx1")
    n = int.from_bytes(data[idx + 4:idx + 8], "little") // 16
    src = VideoFileSource(str(fx.AVI), force_python=True)
    got = list(src.frames())
    assert len(got) == n == fx.N_FRAMES
    for i, frame in enumerate(got):
        e = idx + 8 + 16 * i
        off = int.from_bytes(data[e + 8:e + 12], "little")
        size = int.from_bytes(data[e + 12:e + 16], "little")
        chunk = data[movi + off + 8:movi + off + 8 + size]
        same(frame, cv2_decode(chunk))
    assert (fx.png_filters(fx.PNG) > 0).all()  # every row filter occurs
    same(imcodec.imread(str(fx.PNG), force_python=True), cv2.imread(str(fx.PNG)))
    same(imcodec.imread(str(fx.JPG), force_python=True), cv2.imread(str(fx.JPG)))
    jpg = fx.JPG.read_bytes()
    assert b"\xff\xd0" in jpg and jpg[jpg.index(b"\xff\xc0") + 11] == 0x11
