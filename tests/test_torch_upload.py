"""The frame upload of ``core.device``: the native host copy that gathers a
host array into pinned memory (``ops/csrc/host_gather.cpp``, built here
with the host's C++ compiler, as nvcc hands it to that compiler in the
kernels' build), and Farneback's ``_frames`` on the CPU route, which
neither stages nor counts.  The pinned blocks and the DMAs are held on the
card in ``tests/test_torch_gpu.py``."""
import ctypes
import os
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from opticalflowcontainer_tpu_torch.classical import farneback as fb
from opticalflowcontainer_tpu_torch.core import device as dv
from opticalflowcontainer_tpu_torch.ops import _build

SRC = _build.CSRC / "host_gather.cpp"
ITEM_BYTES = 256 << 10  # kItemBytes of host_gather.cpp
CLIP_1080P_BYTES = 7 * 2 * 1080 * 1920


@pytest.fixture(scope="module")
def native(tmp_path_factory):
    """host_gather.cpp alone as a shared library, with the signature the
    kernels' library gives it."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no C++ compiler on this host")
    out = tmp_path_factory.mktemp("host_gather") / "libhost_gather.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-pthread",
                    "-o", str(out), str(SRC)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    restype, argtypes = _build._SIGNATURES["ofc_host_gather"]
    lib.ofc_host_gather.restype = restype
    lib.ofc_host_gather.argtypes = argtypes
    return lib


@pytest.fixture
def gather(native, monkeypatch):
    """``core.device.host_gather`` on that library."""
    monkeypatch.setattr(_build, "load_kernels", lambda: native)
    return dv.host_gather


def test_host_gather_is_built_with_the_kernels():
    """The host copy goes through the kernels' one nvcc call (and so into
    the library's hash), with no tabs or trailing whitespace."""
    assert SRC in _build._sources()
    assert "ofc_host_gather" in _build._SIGNATURES
    text = SRC.read_text()
    assert f"kItemBytes = {ITEM_BYTES >> 10} << 10;" in text
    for i, line in enumerate(text.splitlines(), 1):
        assert "\t" not in line and line == line.rstrip(), f"line {i}"


@pytest.mark.parametrize("n", [0, 1, ITEM_BYTES - 1, ITEM_BYTES, ITEM_BYTES + 1,
                               CLIP_1080P_BYTES])
def test_host_gather_writes_every_byte_once_in_order(n, gather):
    """A contiguous uint8 array of n bytes, cut into items of 256 KiB that
    the caller and three helpers claim: every byte lands at its place and
    nothing past the end is written."""
    src = torch.from_numpy(np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8))
    buf = torch.full((n + 64,), 7, dtype=torch.uint8)
    gather(buf[:n], src, helpers=3)
    assert torch.equal(buf[:n], src)
    assert bool((buf[n:] == 7).all())


def _strided_sources():
    """uint8 and fp32 host arrays as callers hand them over: contiguous, a
    crop, a channel of an interleaved frame, every other frame, a
    transposed layout, a reversed axis, and CPU tensors."""
    rng = np.random.default_rng(0)
    clip = rng.integers(0, 256, (5, 2, 37, 53), dtype=np.uint8)
    bgr = rng.integers(0, 256, (4, 29, 41, 3), dtype=np.uint8)
    flow = rng.standard_normal((3, 31, 47, 2)).astype(np.float32)
    return {
        "contiguous": clip,
        "crop": clip[:, :, 3:30, 5:50],
        "channel": bgr[..., 1],
        "every_other_frame": clip[::2],
        "transposed": np.moveaxis(clip, 1, -1),
        "reversed_rows": clip[:, :, ::-1],
        "fp32_flow_component": flow[..., 0],
        "tensor": torch.from_numpy(clip),
        "tensor_permuted": torch.from_numpy(clip).permute(1, 0, 3, 2),
    }


SOURCES = _strided_sources()


def _tensor(x):
    """``x`` as ``upload`` hands it to the host copy."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(x if all(s >= 0 for s in x.strides)
                            else np.ascontiguousarray(x))


@pytest.mark.parametrize("name", sorted(SOURCES))
@pytest.mark.parametrize("helpers", [0, 1, 3, 7])
def test_host_gather_reads_the_flat_order_from_any_strides(name, helpers, gather):
    """Straight from the source's own strides (no contiguous copy first),
    by the caller alone or with helpers, the copy holds the C-order
    elements of the array."""
    x = SOURCES[name]
    t = _tensor(x)
    out = torch.empty(t.shape, dtype=t.dtype)
    gather(out, t, helpers=helpers)
    np.testing.assert_array_equal(out.numpy(), np.asarray(x))


def test_host_gather_of_a_large_strided_array_with_helpers(gather):
    """The 1080p clip's two cameras interleaved on the last axis: 111 items
    of 256 KiB, each a walk of 2-byte strides, shared by four threads."""
    rng = np.random.default_rng(3)
    clip = np.moveaxis(rng.integers(0, 256, (7, 1080, 1920, 2), dtype=np.uint8), -1, 1)
    out = torch.empty(clip.shape, dtype=torch.uint8)
    gather(out, torch.from_numpy(clip), helpers=3)
    np.testing.assert_array_equal(out.numpy(), clip)


def test_callers_on_several_threads_each_get_their_own_array(gather):
    """More callers than cores copy their own clips at once, ten times each,
    through the one pool, with the interpreter switching threads often:
    the helpers join the newest caller, and every caller finishes its own
    array."""
    n = (os.cpu_count() or 4) + 2
    rng = np.random.default_rng(4)
    clips = [rng.integers(0, 256, (3, 480, 640), dtype=np.uint8) for _ in range(n)]
    bad, errors = [], []

    def work(k):
        try:
            out = torch.empty(clips[k].shape, dtype=torch.uint8)
            src = torch.from_numpy(clips[k])
            for i in range(10):
                out.zero_()
                gather(out, src, helpers=3)
                if not torch.equal(out, src):
                    bad.append((k, i))
        except BaseException as e:  # handed to the test's thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors and not bad


@pytest.mark.parametrize("case", ["shape", "dims"])
def test_host_gather_refuses_what_it_cannot_copy(case, gather):
    """A destination of another shape is refused before the native call;
    more than the native copy's 16 dims after it."""
    if case == "shape":
        with pytest.raises(ValueError, match="dst"):
            gather(torch.empty(3, 4), torch.empty(4, 3))
    else:
        src = torch.zeros((2,) * 17, dtype=torch.uint8)
        with pytest.raises(ValueError, match="17 dims"):
            gather(torch.empty_like(src), src)


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_cpu_route_gives_the_frames_as_before_and_never_stages(name):
    """``device="cpu"`` is the route it was: the numpy array's contiguous
    copy, or the tensor, in fp32; nothing is counted."""
    x = SOURCES[name]
    before = (dv.upload.staged, dv.upload.staged_bytes)
    got = fb._frames(x, torch.device("cpu"))
    want = (x if isinstance(x, torch.Tensor)
            else torch.from_numpy(np.ascontiguousarray(x))).float()
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, want)
    assert (dv.upload.staged, dv.upload.staged_bytes) == before


def test_cpu_clip_of_a_strided_view_equals_its_contiguous_copy():
    """A clip handed over as a strided view (two cameras interleaved on the
    last axis) flows as its contiguous copy does, bit for bit."""
    rng = np.random.default_rng(1)
    base = rng.uniform(0, 255, (72, 100)).astype(np.float32)
    clip = np.stack([np.stack([base[:, t:t + 80], base[:, 2 * t:2 * t + 80]], -1)
                     for t in range(3)]).astype(np.uint8)  # [T, H, W, 2]
    view = np.moveaxis(clip, -1, 1)  # [T, 2, H, W], not contiguous
    got = fb.farneback_clip(view, device="cpu")
    want = fb.farneback_clip(np.ascontiguousarray(view), device="cpu")
    assert torch.equal(got, want)
