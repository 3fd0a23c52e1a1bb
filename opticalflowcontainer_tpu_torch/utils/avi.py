"""RIFF AVI demuxer and an uncompressed AVI writer on the standard library
and numpy, in place of ``cv2.VideoCapture`` and ``cv2.VideoWriter`` for AVI
files (the card's machine has no cv2).

Read (:class:`AviReader`): the first video stream of an AVI file, its
frames in the order of the ``movi`` lists.  The walk follows ``LIST rec``
groups, skips ``JUNK`` and index chunks (``idx1``, OpenDML ``ix##``),
pads odd-sized chunks by a byte, and continues into OpenDML ``RIFF AVIX``
extensions, so a file with or without an ``idx1`` index reads the same.
The frame rate is ``strh``'s dwRate / dwScale.  Two codings are read:

- Motion JPEG (``MJPG`` in ``strf``'s compression or ``strh``'s handler),
  each ``##dc`` chunk a JPEG frame decoded by :mod:`.jpeg` (the compiled
  form unless ``force_python``), bit for bit what ``cv2.imdecode`` gives
  for the chunk;
- uncompressed 24-bit ``BI_RGB`` DIBs (``##db`` or ``##dc`` chunks), rows
  bottom-up unless the height is negative, each padded to 4 bytes.

Any other coding (XVID, H.264, ...) raises ``ValueError`` naming its
fourcc.  A frame that does not decode ends the stream, as
``cv2.VideoCapture.read`` returns False there.

Write (:class:`AviWriter`): uncompressed 24-bit BGR frames (``00db``
chunks) with an ``idx1`` index, which ``cv2.VideoCapture`` reads back bit
for bit.  The rows are stored top-down (a negative DIB height): OpenCV 5's
FFmpeg reader crashes on bottom-up 24-bit frames.
"""
from __future__ import annotations

import fractions
import struct
from typing import Iterator

import numpy as np

from . import jpeg

_MJPEG = {b"MJPG", b"mjpg"}
_AVIF_HASINDEX = 0x10
_AVIIF_KEYFRAME = 0x10


class AviReader:
    """The first video stream of the AVI file at ``path``: ``fps``,
    ``width``, ``height``, ``coding`` ("mjpeg" or "bgr24"), ``fourcc``,
    ``len()`` frames, and ``frames()`` as BGR uint8 [H, W, 3]."""

    def __init__(self, path: str, force_python: bool = False):
        self.path = path
        self.force_python = force_python
        with open(path, "rb") as f:
            data = f.read()
        self._data = data
        self._stream = None
        self._n_strl = 0
        self._chunks: list[tuple[int, int]] = []
        self.fps = 0.0
        pos = 0
        while pos + 12 <= len(data):
            cid, size, form = struct.unpack_from("<4sI4s", data, pos)
            if cid != b"RIFF" or form not in (b"AVI ", b"AVIX"):
                if pos == 0:
                    raise ValueError(f"{path}: not an AVI file")
                break
            self._walk(pos + 12, min(pos + 8 + size, len(data)))
            pos += 8 + size + (size & 1)
        if self._stream is None:
            raise ValueError(f"{path}: no video stream")

    def _walk(self, pos: int, end: int, in_movi: bool = False,
              strl: int = -1) -> None:
        data = self._data
        while pos + 8 <= end:
            cid, size = struct.unpack_from("<4sI", data, pos)
            body = pos + 8
            if cid == b"LIST" and body + 4 <= end:
                form = data[body:body + 4]
                if form == b"strl":
                    self._walk(body + 4, min(body + size, end), in_movi,
                               strl=self._n_strl)
                    self._n_strl += 1
                elif form in (b"hdrl", b"movi", b"rec "):
                    self._walk(body + 4, min(body + size, end),
                               in_movi or form != b"hdrl")
            elif cid == b"strh" and strl >= 0 and self._stream is None:
                self._strh(data[body:body + size], strl)
            elif cid == b"strf" and strl >= 0 and strl == self._stream:
                self._strf(data[body:body + size])
            elif (in_movi and self._stream is not None and size > 0
                  and cid[:2] == b"%02d" % self._stream
                  and cid[2:] in (b"dc", b"db")):
                if body + size > len(data):
                    break  # a truncated last chunk
                self._chunks.append((body, size))
            pos = body + size + (size & 1)

    def _strh(self, body: bytes, index: int) -> None:
        if body[:4] != b"vids" or len(body) < 36:
            return
        self._stream = index
        self.handler = body[4:8]
        scale, rate = struct.unpack_from("<II", body, 20)
        self.fps = rate / scale if scale else 0.0

    def _strf(self, body: bytes) -> None:
        if len(body) < 40:
            raise ValueError(f"{self.path}: a video format of {len(body)} bytes")
        (_, w, h, _, bits, compression) = struct.unpack_from("<IiiHH4s", body)
        self.width, self.height = w, abs(h)
        self._bottom_up = h > 0
        rgb = compression == b"\0\0\0\0"  # BI_RGB
        if compression in _MJPEG or (rgb and self.handler in _MJPEG):
            self.coding, self.fourcc = "mjpeg", "MJPG"
        elif rgb and bits == 24:
            self.coding, self.fourcc = "bgr24", "BI_RGB"
        else:
            name = (f"BI_RGB at {bits} bits" if rgb
                    else repr(compression.decode("latin-1")))
            raise ValueError(
                f"{self.path}: video coded as {name} is not supported (Motion "
                "JPEG and uncompressed 24-bit BI_RGB only)")

    def __len__(self) -> int:
        return len(self._chunks)

    def chunk(self, i: int) -> bytes:
        """The coded bytes of frame ``i`` (a JPEG file for Motion JPEG)."""
        start, size = self._chunks[i]
        return self._data[start:start + size]

    def frame(self, i: int) -> np.ndarray | None:
        """Frame ``i`` as BGR uint8 [H, W, 3], or None when it does not
        decode."""
        raw = self.chunk(i)
        size = len(raw)
        if self.coding == "mjpeg":
            return jpeg.imdecode(raw, self.force_python,
                                 name=f"{self.path} frame {i}")
        stride = (self.width * 3 + 3) & ~3
        if size < stride * self.height:
            return None
        rows = np.frombuffer(raw, np.uint8, stride * self.height)
        img = rows.reshape(self.height, stride)[:, :self.width * 3]
        if self._bottom_up:
            img = img[::-1]
        return np.ascontiguousarray(img.reshape(self.height, self.width, 3))

    def frames(self) -> Iterator[np.ndarray]:
        for i in range(len(self)):
            img = self.frame(i)
            if img is None:
                return
            yield img


class AviWriter:
    """Write BGR uint8 frames [H, W, 3] of one size to ``path`` as an
    uncompressed 24-bit AVI at ``fps``; ``close()`` (or leaving a ``with``
    block) writes the index and the header's counts."""

    def __init__(self, path: str, fps: float, size: tuple[int, int]):
        self.path = path
        self.width, self.height = size
        if fps <= 0:
            raise ValueError(f"{path}: fps must be positive, got {fps}")
        frac = fractions.Fraction(fps).limit_denominator(1001)
        self._rate, self._scale = frac.numerator, frac.denominator
        self._stride = (self.width * 3 + 3) & ~3
        self._index: list[tuple[int, int]] = []
        self._f = open(path, "wb")
        self._f.write(self._headers(0))
        self._movi = self._f.tell() - 4  # the offset of "movi"

    def _headers(self, n: int) -> bytes:
        w, h = self.width, self.height
        frame_bytes = self._stride * h
        avih = struct.pack(
            "<14I", round(1e6 * self._scale / self._rate), frame_bytes *
            self._rate // self._scale, 0, _AVIF_HASINDEX, n, 0, 1,
            frame_bytes, w, h, 0, 0, 0, 0)
        strh = struct.pack(
            "<4s4sIHHIIIIIIiI4h", b"vids", b"\0\0\0\0", 0, 0, 0, 0,
            self._scale, self._rate, 0, n, frame_bytes, -1, 0, 0, 0, w, h)
        strf = struct.pack("<IiiHH4sIiiII", 40, w, -h, 1, 24, b"\0\0\0\0",
                           frame_bytes, 0, 0, 0, 0)
        strl = _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf))
        hdrl = _list(b"hdrl", _chunk(b"avih", avih) + strl)
        movi_size = 4 + len(self._index) * (8 + frame_bytes)
        riff_size = 4 + len(hdrl) + 8 + movi_size + 8 + 16 * len(self._index)
        return (b"RIFF" + struct.pack("<I", riff_size) + b"AVI " + hdrl
                + b"LIST" + struct.pack("<I", movi_size) + b"movi")

    def write(self, frame: np.ndarray) -> None:
        frame = np.asarray(frame)
        if frame.shape != (self.height, self.width, 3) or frame.dtype != np.uint8:
            raise ValueError(
                f"{self.path}: frames must be uint8 [{self.height}, "
                f"{self.width}, 3], got {frame.dtype} {list(frame.shape)}")
        rows = np.zeros((self.height, self._stride), np.uint8)
        rows[:, :self.width * 3] = frame.reshape(self.height, -1)
        self._index.append((self._f.tell() - self._movi, rows.size))
        self._f.write(_chunk(b"00db", rows.tobytes()))

    def close(self) -> None:
        if self._f.closed:
            return
        idx = b"".join(struct.pack("<4sIII", b"00db", _AVIIF_KEYFRAME, off, size)
                       for off, size in self._index)
        self._f.write(_chunk(b"idx1", idx))
        if self._f.tell() > 0xFFFFFFFF:
            self._f.close()
            raise ValueError(f"{self.path}: over 4 GiB, more than a RIFF "
                             "AVI without OpenDML extensions holds")
        self._f.seek(0)
        self._f.write(self._headers(len(self._index)))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _chunk(cid: bytes, body: bytes) -> bytes:
    return cid + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)


def _list(form: bytes, body: bytes) -> bytes:
    return b"LIST" + struct.pack("<I", 4 + len(body)) + form + body
