"""Video input and compressed frames: the port's AVI demuxer and writer
(``utils/avi.py``), ``VideoFileSource``, ``RealSenseSource``'s refusal,
``tools/record.py`` and ``FlowNode``'s compressed-frame path, held against
cv2 (its Motion-JPEG writer, ``cv2.imdecode``, ``cv2.VideoCapture``) and
the JAX package's sources and node on the CPU.  The port's decoders run
their plain forms (``force_python``); the compiled forms need nvcc."""
import inspect
import struct

import cv2
import numpy as np
import pytest

import opticalflowcontainer_tpu.runtime as jrt
from opticalflowcontainer_tpu.runtime import nodes as jnodes
from opticalflowcontainer_tpu.runtime import sources as jsources
import opticalflowcontainer_tpu_torch.runtime as trt
from opticalflowcontainer_tpu_torch.runtime import nodes as tnodes
from opticalflowcontainer_tpu_torch.runtime import sources as tsources
from opticalflowcontainer_tpu_torch.runtime.bus import Bus
from opticalflowcontainer_tpu_torch.tools import record
from opticalflowcontainer_tpu_torch.utils import avi
from test_torch_threads import one_torch_thread  # noqa: F401

FB = dict(levels=2, winsize=13, iterations=2)  # the runtime's default
H, W, N = 120, 160, 8
VELOCITY = 0.05


def camera_frames(n=N, h=H, w=W):
    cam = tsources.SyntheticCamera(width=w, height=h, n_frames=n,
                                   velocity_mps=VELOCITY)
    return [cam.frame_at(i) for i in range(n)]


def write_mjpeg(path, frames, fps=30.0):
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), fps,
                             (w, h))
    assert writer.isOpened()
    for f in frames:
        writer.write(f)
    writer.release()
    return str(path)


def idx1_chunks(path) -> list[bytes]:
    """The video chunks the file's idx1 index points at (an oracle that
    does not use the port's walk)."""
    data = open(path, "rb").read()
    movi, idx = data.index(b"movi"), data.index(b"idx1")
    n = struct.unpack_from("<I", data, idx + 4)[0] // 16
    out = []
    for i in range(n):
        cid, _, off, size = struct.unpack_from("<4sIII", data, idx + 8 + 16 * i)
        if cid.endswith((b"dc", b"db")):
            out.append(data[movi + off + 8:movi + off + 8 + size])
    return out


def capture(path) -> list[np.ndarray]:
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return frames


@pytest.fixture(scope="module")
def mjpeg(tmp_path_factory):
    return write_mjpeg(tmp_path_factory.mktemp("v") / "cam.avi", camera_frames())


# ---------------------------------------------------------------- AVI

def test_mjpeg_frames_equal_cv2_imdecode_of_each_chunk(mjpeg):
    reader = avi.AviReader(mjpeg, force_python=True)
    assert (reader.coding, reader.fourcc, reader.fps) == ("mjpeg", "MJPG", 30.0)
    assert (reader.width, reader.height) == (W, H)
    chunks = idx1_chunks(mjpeg)
    frames = list(reader.frames())
    assert len(frames) == len(chunks) == len(capture(mjpeg)) == N
    cap = cv2.VideoCapture(mjpeg)
    assert cap.get(cv2.CAP_PROP_FRAME_COUNT) == N
    for got, chunk in zip(frames, chunks):
        want = cv2.imdecode(np.frombuffer(chunk, np.uint8), cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("content,mean_bar,max_bar", [
    ("camera", 1.0, 3), ("smooth-colour", 3.0, 20), ("detailed-colour", 8.0, 64)])
def test_frames_against_video_capture(tmp_path, content, mean_bar, max_bar):
    """cv2.VideoCapture decodes Motion JPEG through FFmpeg (its own IDCT,
    no fancy chroma upsampling, swscale's YUV->BGR), cv2.imdecode and the
    port through libjpeg-turbo's arithmetic, so the two differ.  On the
    gray camera frames (flat chroma) only the IDCT's rounding differs:
    measured mean 0.64, max 2.  On colour the chroma interpolation adds
    to it: smooth colour (a 32-pixel grid) measured mean 2.0-2.4, max
    14-15; detailed colour (an 8-pixel grid) mean 6.3-6.9, max 41-54.
    Each bar has room over what was measured; none is a parity bar."""
    rng = np.random.default_rng(0)
    if content == "camera":
        frames = camera_frames(4)
    else:
        cell = 32 if content == "smooth-colour" else 8
        frames = []
        for _ in range(2):
            grid = rng.uniform(0, 255, (H // cell + 3, W // cell + 3, 3))
            frames.append(np.clip(cv2.resize(grid.astype(np.float32), (W, H),
                                             interpolation=cv2.INTER_CUBIC),
                                  0, 255).astype(np.uint8))
    path = write_mjpeg(tmp_path / "c.avi", frames)
    ours = list(tsources.VideoFileSource(path, force_python=True).frames())
    theirs = capture(path)
    assert len(ours) == len(theirs) == len(frames)
    d = np.abs(np.array(ours, np.int64) - np.array(theirs))
    assert d.mean() <= mean_bar and d.max() <= max_bar, (d.mean(), d.max())


@pytest.mark.parametrize("size,fps", [((37, 51), 29.97), ((48, 64), 30.0),
                                      ((1, 1), 15.0)])
def test_writer_reads_back_through_cv2_bit_for_bit(tmp_path, size, fps):
    rng = np.random.default_rng(size[0])
    frames = [rng.integers(0, 256, size + (3,), np.uint8) for _ in range(4)]
    path = str(tmp_path / "w.avi")
    with avi.AviWriter(path, fps, (size[1], size[0])) as w:
        for f in frames:
            w.write(f)
    cap = cv2.VideoCapture(path)
    assert cap.get(cv2.CAP_PROP_FRAME_COUNT) == 4
    assert cap.get(cv2.CAP_PROP_FPS) == pytest.approx(fps, abs=1e-6)
    back = capture(path)
    assert len(back) == 4
    for got, want in zip(back, frames):
        np.testing.assert_array_equal(got, want)
    reader = avi.AviReader(path)
    assert reader.coding == "bgr24" and reader.fps == pytest.approx(fps)
    for got, want in zip(reader.frames(), frames):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="uint8"):
        avi.AviWriter(str(tmp_path / "x.avi"), fps, (size[1], size[0])).write(
            frames[0].astype(np.float32))


def _riff(form: bytes, body: bytes) -> bytes:
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + form + body


def _list(form: bytes, body: bytes) -> bytes:
    return b"LIST" + struct.pack("<I", 4 + len(body)) + form + body


def _chunk(cid: bytes, body: bytes) -> bytes:
    return cid + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)


def test_demuxer_walks_rec_lists_junk_padding_and_avix(mjpeg, tmp_path):
    """A file without idx1 whose movi list groups frames in ``LIST rec``,
    holds JUNK and an audio chunk, and continues in an OpenDML ``RIFF
    AVIX``: the frames come out in order, each as cv2 decodes its chunk."""
    data = open(mjpeg, "rb").read()
    hdrl_at = data.index(b"LIST")
    hdrl = data[hdrl_at:hdrl_at + 8 + struct.unpack_from("<I", data, hdrl_at + 4)[0]]
    chunks = idx1_chunks(mjpeg)
    odd = [c for c in chunks if len(c) & 1]
    assert odd, "the padding byte goes untested"
    movi1 = _list(b"movi", _chunk(b"JUNK", b"x" * 5)
                  + _list(b"rec ", _chunk(b"00dc", chunks[0]) + _chunk(b"01wb", b"au"))
                  + b"".join(_chunk(b"00dc", c) for c in chunks[1:4]))
    movi2 = _list(b"movi", _chunk(b"ix00", b"\0" * 8)
                  + b"".join(_chunk(b"00dc", c) for c in chunks[4:]))
    path = tmp_path / "odml.avi"
    path.write_bytes(_riff(b"AVI ", hdrl + movi1) + _riff(b"AVIX", movi2))
    got = list(avi.AviReader(str(path), force_python=True).frames())
    assert len(got) == len(chunks)
    for frame, chunk in zip(got, chunks):
        np.testing.assert_array_equal(
            frame, cv2.imdecode(np.frombuffer(chunk, np.uint8), cv2.IMREAD_COLOR))


@pytest.mark.parametrize("fourcc", ["XVID", "H264"])
def test_other_codings_raise_naming_the_fourcc(mjpeg, tmp_path, fourcc):
    data = bytearray(open(mjpeg, "rb").read())
    strh, strf = data.index(b"strh") + 8, data.index(b"strf") + 8
    data[strh + 4:strh + 8] = fourcc.encode()
    data[strf + 16:strf + 20] = fourcc.encode()
    path = tmp_path / "x.avi"
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match=fourcc):
        tsources.VideoFileSource(str(path), force_python=True)
    with pytest.raises(ValueError, match="not an AVI"):
        avi.AviReader(__file__)


def test_truncated_file_ends_the_stream(mjpeg, tmp_path):
    """A last chunk cut short is not read, as cv2.VideoCapture stops."""
    data = open(mjpeg, "rb").read()
    idx = data.index(b"idx1")
    path = tmp_path / "cut.avi"
    path.write_bytes(data[:idx - 300])
    got = list(avi.AviReader(str(path), force_python=True).frames())
    assert len(got) == N - 1


# ------------------------------------------------------------ sources

def _drive(node_cls, frames, backend, params, mod, encoding="bgr8", **node_kw):
    """Publish ``frames`` stamped 1/30 s apart to a node in topic mode;
    its velocities and the frames it published as its live feed."""
    bus = mod.Bus(namespace="")
    node = node_cls(backend, params, bus, **node_kw).attach(direct=True)
    vels, feed = [], []
    bus.subscribe(f"/optical_flow/{params.name}_velocity", lambda m: vels.append(m.x))
    bus.subscribe("/optical_flow/image_live_feed", lambda m: feed.append(m.data))
    try:
        for i, f in enumerate(frames):
            bus.publish("/camera/color/image_raw", mod.messages.ImageMsg(
                mod.messages.Header(i / 30.0), f, encoding))
    finally:
        node.stop()
    return np.array(vels), feed, node


def _params(mod, **kw):
    return mod.nodes.NodeParams(pixel_to_meter=0.000857, name="FB",
                                smooth_window=3, **kw)


def test_video_source_pipeline_against_the_jax_source(mjpeg):
    """The JAX VideoFileSource (cv2.VideoCapture: FFmpeg's decode) into the
    JAX FlowNode, and the port's VideoFileSource (libjpeg's arithmetic)
    into the port's FlowNode, on the same file.  The decodes differ by
    mean 0.64 and at most 2 levels (test_frames_against_video_capture);
    the velocities then differ by at most 3.3e-4 relative (measured), the
    bar is 1e-3.  On the same frames the two nodes agree to 1e-6
    (test_torch_runtime's FlowNode bar)."""
    jf = list(jsources.VideoFileSource(mjpeg).frames())
    tf = list(tsources.VideoFileSource(mjpeg, force_python=True).frames())
    assert len(jf) == len(tf) == N
    want, _, _ = _drive(jnodes.FlowNode, jf, jnodes.make_farneback_backend(**FB),
                        _params(jrt), jrt)
    got, _, node = _drive(tnodes.FlowNode, tf,
                          tnodes.make_farneback_backend(device="cpu", **FB),
                          _params(trt), trt)
    assert len(got) == len(want) == N - 1 and node.frames_processed == N - 1
    np.testing.assert_allclose(got, want, rtol=1e-3)
    np.testing.assert_allclose(np.median(got), VELOCITY, rtol=0.05)


def test_video_source_signature_and_thread(mjpeg):
    """The JAX signature plus ``force_python``; the file's rate; run() on a
    thread publishes every frame and the camera info."""
    jparams = list(inspect.signature(jsources.VideoFileSource).parameters)
    tparams = list(inspect.signature(tsources.VideoFileSource).parameters)
    assert tparams == jparams + ["force_python"]
    assert trt.VideoFileSource is tsources.VideoFileSource
    bus = Bus(namespace="")
    got, info = [], []
    bus.subscribe("/camera/color/image_raw", got.append)
    bus.subscribe("/camera/color/camera_info", info.append)
    src = tsources.VideoFileSource(mjpeg, bus, fps=240.0, force_python=True)
    assert src.file_fps == 30.0
    src.start()
    src._thread.join(timeout=30.0)
    src.stop()
    assert not src._thread.is_alive() and len(got) == N and len(info) == 1
    assert got[0].data.shape == (H, W, 3) and got[0].encoding == "bgr8"


def test_realsense_source_refuses_without_pyrealsense2():
    with pytest.raises(RuntimeError) as port:
        tsources.RealSenseSource()
    with pytest.raises(RuntimeError) as ref:
        jsources.RealSenseSource()
    assert str(port.value) == str(ref.value)
    assert "RealSenseSource" not in trt.__all__


# ---------------------------------------------------- compressed frames

def _encoded(frames, kind):
    ext = ".jpg" if kind == "jpeg" else ".png"
    return [cv2.imencode(ext, f)[1].tobytes() for f in frames]


@pytest.mark.parametrize("kind", ["jpeg", "png"])
def test_compressed_frames_match_the_jax_node(kind):
    """The same stream of cv2-encoded ImageMsgs (encoding "jpeg" carrying
    JPEG, "compressed" carrying PNG) through the JAX node (cv2.imdecode)
    and the port's: the decoded frames (the live feed) are bit-equal, the
    velocities agree at test_torch_runtime's FlowNode bar (1e-6 relative),
    and a truncated frame publishes nothing in either node."""
    encoding = "jpeg" if kind == "jpeg" else "compressed"
    msgs = _encoded(camera_frames(6), kind)
    msgs.insert(3, msgs[2][:len(msgs[2]) // 2])  # a damaged frame
    want, jfeed, jnode = _drive(
        jnodes.FlowNode, msgs, jnodes.make_farneback_backend(**FB),
        _params(jrt, publish_debug_images=True), jrt, encoding)
    got, tfeed, tnode = _drive(
        tnodes.FlowNode, msgs, tnodes.make_farneback_backend(device="cpu", **FB),
        _params(trt, publish_debug_images=True), trt, encoding,
        force_python_decoder=True)
    assert len(got) == len(want) == 5 and len(tfeed) == len(jfeed) == 5
    for a, b in zip(tfeed, jfeed):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert (tnode.frames_processed, tnode.frames_failed) == (5, 1)


# ------------------------------------------------------------- record

def test_record_writes_pngs_and_an_avi_cv2_reads(mjpeg, tmp_path, capsys):
    out_dir, out_avi = tmp_path / "png", str(tmp_path / "out.avi")
    assert record.main([mjpeg, "--frames", "5", "--out-dir", str(out_dir),
                        "--out-avi", out_avi, "--force-python"]) == 0
    assert "captured 5 frames" in capsys.readouterr().out
    chunks = idx1_chunks(mjpeg)
    want = [cv2.imdecode(np.frombuffer(c, np.uint8), cv2.IMREAD_COLOR)
            for c in chunks[:5]]
    pngs = sorted(out_dir.glob("frame_*.png"))
    assert [p.name for p in pngs] == [f"frame_{i:05d}.png" for i in range(5)]
    for p, w in zip(pngs, want):
        np.testing.assert_array_equal(cv2.imread(str(p)), w)
    back = capture(out_avi)
    assert len(back) == 5
    for b, w in zip(back, want):
        np.testing.assert_array_equal(b, w)
    assert cv2.VideoCapture(out_avi).get(cv2.CAP_PROP_FPS) == 30.0  # the source's


def test_record_refuses_a_camera_index_and_a_missing_file(tmp_path):
    with pytest.raises(SystemExit, match="camera index 0.*V4L2"):
        record.main(["0"])
    with pytest.raises(SystemExit, match="cannot open source"):
        record.main([str(tmp_path / "none.avi")])
