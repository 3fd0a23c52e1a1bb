"""PNG reader and writer on ``zlib`` and numpy, in place of ``cv2.imread``
and ``cv2.imwrite`` for PNG files (the card's machine has neither cv2 nor
PIL).

Read: 8- and 16-bit grayscale, grayscale + alpha, RGB and RGBA, not
interlaced, with any of the five row filters (None, Sub, Up, Average,
Paeth; Paeth breaks ties in the specification's order a, b, c).  The IDAT
chunks are concatenated and every chunk's CRC is checked.  These raise
``ValueError`` naming the file: palette images (colour type 3), Adam7
interlaced images, bit depths below 8, and a ``tRNS`` chunk (cv2 would add
an alpha channel from it).

- ``imread(path)`` returns what ``cv2.imread(path)`` does: BGR uint8
  [H, W, 3], grayscale repeated into the three channels, alpha dropped, and
  16-bit samples cut to their high byte.
- ``imdecode(buf)`` does the same for the bytes of a PNG file, as
  ``cv2.imdecode(buf, cv2.IMREAD_COLOR)``: None when the data are
  truncated or damaged (a bad CRC, a broken zlib stream, too few bytes).
- ``imread(path, unchanged=True)`` returns what ``cv2.IMREAD_UNCHANGED``
  does: the file's own channel count and dtype (uint16 for 16-bit), in BGR
  or BGRA order; grayscale + alpha comes back as BGRA.

Write: ``imwrite(path, img)`` takes [H, W] grayscale, [H, W, 3] BGR or
[H, W, 4] BGRA, uint8 or uint16, as ``cv2.imwrite`` does, and writes a
non-interlaced PNG with filter None on every row; ``imencode(img)``
returns the file's bytes.

Unfiltering has two forms.  ``imdecode`` runs the compiled one
(``ofc_png_unfilter`` in ``ops/csrc/image_decode.cpp``, built by the
kernels' single nvcc call) unless ``force_python`` asks for the plain one;
``imread`` runs the plain one.  The plain form runs along anti-diagonals: byte group (r, i)
depends only on (r, i-1), (r-1, i) and (r-1, i-1), so all groups with the
same r + i are independent and one numpy step decodes them, H + W steps an
image.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


class _Damaged(ValueError):
    """Truncated or damaged PNG data (``imdecode`` gives None)."""


def _chunks(data: bytes, path: str):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise _Damaged(f"{path}: truncated {kind!r} chunk")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise _Damaged(f"{path}: bad CRC in the {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise _Damaged(f"{path}: no IEND chunk")


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, H: int, W: int, bpp: int, path: str) -> np.ndarray:
    """Undo the row filters of ``raw`` (H rows of a filter byte and W * bpp
    bytes): the image bytes [H, W, bpp] uint8."""
    rows = raw.reshape(H, 1 + W * bpp)
    ftype = rows[:, 0].astype(np.int64)
    if ftype.max(initial=0) > 4:
        raise _Damaged(f"{path}: unknown row filter {int(ftype.max())}")
    filt = rows[:, 1:].reshape(H, W, bpp).astype(np.int32)
    # out[r + 1, i + 1] is byte group (r, i); row 0 and column 0 stay 0,
    # the "previous row" and "left pixel" the filters see at the edges
    out = np.zeros((H + 1, W + 1, bpp), np.int32)
    if (ftype == 0).all():
        out[1:, 1:] = filt
    else:
        for t in range(H + W - 1):
            r = np.arange(max(0, t - W + 1), min(H - 1, t) + 1)
            i = t - r
            a = out[r + 1, i]
            b = out[r, i + 1]
            c = out[r, i]
            ft = ftype[r][:, None]
            pred = np.where(ft == 1, a, 0)
            pred = np.where(ft == 2, b, pred)
            pred = np.where(ft == 3, (a + b) >> 1, pred)
            pred = np.where(ft == 4, _paeth(a, b, c), pred)
            out[r + 1, i + 1] = (filt[r, i] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def _unfilter_compiled(raw: np.ndarray, H: int, W: int, bpp: int,
                       path: str) -> np.ndarray:
    from ..ops._build import load_kernels

    lib = load_kernels()  # raises with nvcc's output when it cannot build
    out = np.empty((H, W, bpp), np.uint8)
    if lib.ofc_png_unfilter(raw.ctypes.data, out.ctypes.data, H, W, bpp):
        raise _Damaged(f"{path}: unknown row filter")
    return out


def _decode(data: bytes, path: str,
            force_python: bool) -> tuple[np.ndarray, int]:
    """The samples [H, W, C] (uint8 or uint16) of the PNG file ``data``
    (named ``path`` in errors) in the file's channel order (gray,
    gray+alpha, RGB or RGBA), and its colour type."""
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header = None
    idat = []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            if len(body) != 13:
                raise _Damaged(f"{path}: an IHDR chunk of {len(body)} bytes")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"tRNS":
            raise ValueError(f"{path}: a tRNS chunk (transparency by colour "
                             "key) is not supported")
    if header is None:
        raise _Damaged(f"{path}: no IHDR chunk")
    W, H, depth, ctype, _comp, _filt, interlace = header
    if ctype == 3:
        raise ValueError(f"{path}: palette PNGs are not supported")
    if interlace:
        raise ValueError(f"{path}: Adam7-interlaced PNGs are not supported")
    if ctype not in _CHANNELS or depth not in (8, 16):
        raise ValueError(f"{path}: colour type {ctype} at bit depth {depth} "
                         "is not supported (8- or 16-bit gray, gray+alpha, "
                         "RGB, RGBA)")
    C = _CHANNELS[ctype]
    bpp = C * depth // 8
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise _Damaged(f"{path}: {e}") from None
    if raw.size != H * (1 + W * bpp):
        raise _Damaged(f"{path}: {raw.size} bytes of image data for a "
                       f"{W}x{H} image of {bpp} bytes a pixel")
    if force_python:
        px = _unfilter(raw, H, W, bpp, path)
    else:
        px = _unfilter_compiled(raw, H, W, bpp, path)
    if depth == 16:
        px = px.reshape(H, W * C, 2)
        img = ((px[..., 0].astype(np.uint16) << 8) | px[..., 1]).reshape(H, W, C)
    else:
        img = px.reshape(H, W, C)
    return img, ctype


def imread(path: str, unchanged: bool = False) -> np.ndarray:
    """The image at ``path`` as ``cv2.imread`` returns it: BGR uint8 [H, W,
    3], or with ``unchanged`` the file's own channels and dtype in BGR(A)
    order ([H, W] for grayscale), as ``cv2.IMREAD_UNCHANGED``.  Unfilters
    in plain numpy."""
    with open(path, "rb") as f:
        img, ctype = _decode(f.read(), path, force_python=True)
    if unchanged:
        if ctype == 0:
            return img[..., 0].copy()
        if ctype == 4:
            g, a = img[..., :1], img[..., 1:]
            return np.concatenate([g, g, g, a], axis=-1)
        order = [2, 1, 0] if ctype == 2 else [2, 1, 0, 3]
        return np.ascontiguousarray(img[..., order])
    return _to_bgr(img, ctype)


def _to_bgr(img: np.ndarray, ctype: int) -> np.ndarray:
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if ctype in (0, 4):
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., 2::-1])


def imdecode(buf, force_python: bool = False,
             name: str = "PNG data") -> np.ndarray | None:
    """The PNG file in ``buf`` (bytes, or a uint8 array) as ``cv2.imdecode(buf,
    cv2.IMREAD_COLOR)`` returns it: BGR uint8 [H, W, 3], or None when the
    data are truncated or damaged.  Unfilters with the compiled form unless
    ``force_python`` asks for the plain one."""
    data = buf if isinstance(buf, bytes) else bytes(buf)
    try:
        return _to_bgr(*_decode(data, name, force_python))
    except _Damaged:
        return None


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def imencode(img) -> bytes:
    """The PNG file of ``img`` ([H, W] gray, [H, W, 1], [H, W, 3] BGR or
    [H, W, 4] BGRA; uint8 or uint16): filter None on every row."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG samples must be uint8 or uint16, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        ctype, px = 0, img[..., None]
    elif img.ndim == 3 and img.shape[2] == 3:
        ctype, px = 2, img[..., ::-1]
    elif img.ndim == 3 and img.shape[2] == 4:
        ctype, px = 6, img[..., [2, 1, 0, 3]]
    else:
        raise ValueError(f"cannot write an image of shape {img.shape} as a PNG")
    H, W = px.shape[:2]
    depth = 8 * img.dtype.itemsize
    rows = np.ascontiguousarray(px.astype(px.dtype.newbyteorder(">"))
                                ).view(np.uint8).reshape(H, -1)
    raw = np.concatenate([np.zeros((H, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + _chunk(b"IEND", b""))


def imwrite(path: str, img) -> bool:
    """Write ``img`` (as :func:`imencode` takes it) to ``path`` as a PNG.
    Returns True, as ``cv2.imwrite``."""
    try:
        data = imencode(img)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    with open(path, "wb") as f:
        f.write(data)
    return True
