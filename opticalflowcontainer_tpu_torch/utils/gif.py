"""Animated GIF writer on numpy, in place of PIL's ``Image.save(...,
save_all=True)`` for the comparison tool (the card's machine has no PIL).

:func:`quantize` builds one 256-colour palette for all frames by median
cut: the box of colours with the widest channel range is split at that
channel's median pixel, until there are 256 boxes or none can be split;
each box's colour is its pixels' mean, and every pixel takes its box's
index.  :func:`write_gif` writes GIF89a: the palette as the global colour
table, a NETSCAPE2.0 block with the loop count, and each frame behind a
graphic control extension carrying its delay (``duration_ms // 10``
hundredths of a second), compressed by variable-width LZW (9 to 12-bit
codes, a clear code when the table is full).
"""
from __future__ import annotations

import struct

import numpy as np


def quantize(frames: list[np.ndarray], colours: int = 256
             ) -> tuple[np.ndarray, list[np.ndarray]]:
    """The median-cut palette [K, 3] uint8 (RGB, K <= ``colours``) of RGB
    uint8 frames [H, W, 3], and each frame's palette indices [H, W] uint8."""
    px = np.concatenate([np.asarray(f, np.uint8).reshape(-1, 3) for f in frames])
    key = (px[:, 0].astype(np.int64) << 16) | (px[:, 1].astype(np.int64) << 8) | px[:, 2]
    uniq, inverse, counts = np.unique(key, return_inverse=True, return_counts=True)
    rgb = np.stack([(uniq >> 16) & 255, (uniq >> 8) & 255, uniq & 255], axis=1)
    boxes = [np.arange(len(uniq))]
    spans = [np.ptp(rgb, axis=0)]
    while len(boxes) < colours:
        widest = max(range(len(boxes)), key=lambda i: (spans[i].max(), -i))
        if spans[widest].max() == 0:
            break  # every box holds one colour
        box = boxes[widest]
        ch = int(np.argmax(spans[widest]))
        order = box[np.argsort(rgb[box, ch], kind="stable")]
        vals = rgb[order, ch]
        cum = np.cumsum(counts[order])
        # split after the median pixel's value, or before it when it is
        # the box's largest: both halves hold colours
        v = vals[int(np.searchsorted(cum, cum[-1] / 2.0))]
        cut = int(np.searchsorted(vals, v, side="right"))
        if cut == len(order):
            cut = int(np.searchsorted(vals, v, side="left"))
        halves = [order[:cut], order[cut:]]
        boxes[widest:widest + 1] = halves
        spans[widest:widest + 1] = [np.ptp(rgb[h], axis=0) for h in halves]
    palette = np.zeros((len(boxes), 3), np.uint8)
    label = np.zeros(len(uniq), np.uint8)
    for i, b in enumerate(boxes):
        w = counts[b].astype(np.float64)
        palette[i] = np.round((rgb[b] * w[:, None]).sum(0) / w.sum())
        label[b] = i
    idx = label[inverse]
    out, start = [], 0
    for f in frames:
        n = f.shape[0] * f.shape[1]
        out.append(idx[start:start + n].reshape(f.shape[:2]))
        start += n
    return palette, out


def lzw_encode(indices: np.ndarray, min_code_size: int = 8) -> bytes:
    """The GIF LZW code stream of palette indices (a clear code first, an
    end code last), packed least-significant bit first."""
    clear, end = 1 << min_code_size, (1 << min_code_size) + 1
    out = bytearray()
    acc = nbits = 0

    def emit(code: int, width: int) -> None:
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8

    data = np.asarray(indices, np.uint8).ravel().tolist()
    width = min_code_size + 1
    table: dict = {}
    nxt = end + 1
    emit(clear, width)
    prefix = data[0] if data else None
    for k in data[1:]:
        code = table.get((prefix, k))
        if code is not None:
            prefix = code
            continue
        emit(prefix, width)
        table[(prefix, k)] = nxt
        if nxt == (1 << width) and width < 12:
            width += 1
        nxt += 1
        if nxt == 4096:  # the table is full: start again
            emit(clear, width)
            table.clear()
            width, nxt = min_code_size + 1, end + 1
        prefix = k
    if prefix is not None:
        emit(prefix, width)
        # the decoder adds an entry on this code too; follow its width
        if nxt == (1 << width) and width < 12:
            width += 1
    emit(end, width)
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\x00"


def write_gif(path: str, palette: np.ndarray, frames: list[np.ndarray],
              duration_ms: int = 500, loop: int = 0) -> None:
    """Write palette-indexed frames [H, W] uint8 (all of one size) with the
    RGB ``palette`` [K <= 256, 3] as a looping GIF89a."""
    H, W = frames[0].shape
    table = np.zeros((256, 3), np.uint8)
    table[:len(palette)] = palette
    parts = [b"GIF89a", struct.pack("<HHBBB", W, H, 0xF7, 0, 0),
             table.tobytes(),
             b"\x21\xff\x0bNETSCAPE2.0" + struct.pack("<BBHB", 3, 1, loop, 0)]
    for f in frames:
        if f.shape != (H, W):
            raise ValueError(f"{path}: frames of sizes {(H, W)} and {f.shape}")
        parts.append(b"\x21\xf9\x04" + struct.pack(
            "<BHBB", 0, duration_ms // 10, 0, 0))
        parts.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, W, H, 0))
        parts.append(b"\x08" + _sub_blocks(lzw_encode(f, 8)))
    parts.append(b"\x3b")
    with open(path, "wb") as fh:
        fh.write(b"".join(parts))
