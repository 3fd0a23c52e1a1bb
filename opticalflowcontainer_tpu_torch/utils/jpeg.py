"""Baseline JPEG decoder on numpy, in place of ``cv2.imdecode(buf,
cv2.IMREAD_COLOR)`` for JPEG bytes (the card's machine has neither cv2 nor
PIL).

Read: SOF0 and SOF1 frames (sequential, Huffman-coded, 8-bit samples) of
one component (gray) or three (YCbCr, or RGB where an Adobe marker or the
component ids say so), interleaved or not, with restart intervals, 8- and
16-bit quantization tables, and any integral sampling factors.  A frame
that defines no Huffman table gets the standard's Annex K tables, as
libjpeg does for Motion-JPEG frames.  These raise ``ValueError`` naming the
marker: progressive (SOF2), lossless (SOF3), hierarchical (SOF5-7) and
arithmetic-coded (SOF9-15) frames, sample precision other than 8 bits,
four-component (CMYK/YCCK) images, fractional sampling and a DNL marker.

The decode computes what libjpeg-turbo's default decompression does, so
that the result equals cv2's bit for bit:

- receive/extend Huffman decoding, DC prediction reset at each restart;
- dequantization and ``jpeg_idct_islow`` (integer, CONST_BITS 13,
  PASS1_BITS 2, the post-IDCT range limit on ten bits);
- ``jdsample.c``'s default ("fancy") upsampling: the triangle filters h2v1
  and h2v2 (on components more than two samples wide) and h1v2, edges
  replicated; every other integral factor replicates samples;
- ``jdcolor.c``'s 16-bit fixed-point YCbCr -> BGR tables;
- gray repeated into three channels, the image cropped to its size.

Truncated input (no EOI marker, a scan that runs out of data) and damaged
entropy data (a code no table holds, a coefficient past the block's end,
a restart marker missing) give ``None``.

The entropy decoding is plain Python; ``imdecode`` runs the compiled form
(``ops/csrc/image_decode.cpp``, the same steps in C++, built by the
kernels' single nvcc call) unless ``force_python`` asks for this one.
"""
from __future__ import annotations

import functools
import re

import numpy as np

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
_ZIGZAG_LIST = _ZIGZAG.tolist()

# Annex K.3 tables: (class, id) -> (counts of codes of lengths 1..16, symbols)
_STD_HUFFMAN = {
    (0, 0): ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
             list(range(12))),
    (0, 1): ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
             list(range(12))),
    (1, 0): ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d], bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
        "2433627282090a161718191a25262728292a3435363738393a43444546474849"
        "4a535455565758595a636465666768696a737475767778797a83848586878889"
        "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
        "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
        "f9fa")),
    (1, 1): ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0"
        "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
        "494a535455565758595a636465666768696a737475767778797a828384858687"
        "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
        "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
        "f9fa")),
}

# frame markers that are not sequential Huffman 8-bit: marker -> description
_REFUSED_SOF = {
    0xC2: "a progressive JPEG (SOF2)",
    0xC3: "a lossless JPEG (SOF3)",
    0xC5: "a hierarchical JPEG (SOF5)",
    0xC6: "a hierarchical JPEG (SOF6)",
    0xC7: "a hierarchical JPEG (SOF7)",
    0xC9: "an arithmetic-coded JPEG (SOF9)",
    0xCA: "an arithmetic-coded JPEG (SOF10)",
    0xCB: "an arithmetic-coded JPEG (SOF11)",
    0xCD: "an arithmetic-coded JPEG (SOF13)",
    0xCE: "an arithmetic-coded JPEG (SOF14)",
    0xCF: "an arithmetic-coded JPEG (SOF15)",
}

# the first 0xFF of a marker that ends entropy-coded data: not a stuffed
# 0xFF00 and not a restart marker
_END_OF_SCAN = re.compile(rb"\xff[^\x00\xd0-\xd7]")
_RST = re.compile(rb"\xff[\xd0-\xd7]")


class _Damaged(Exception):
    """The input is truncated or its data are damaged: decode to None."""


class _Frame:
    def __init__(self, H, W, comps):
        self.H, self.W = H, W
        self.comps = comps          # [(id, h, v, tq)]
        self.hmax = max(c[1] for c in comps)
        self.vmax = max(c[2] for c in comps)
        self.mcux = _ceil(W, 8 * self.hmax)
        self.mcuy = _ceil(H, 8 * self.vmax)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _u16(data: bytes, pos: int) -> int:
    if pos + 2 > len(data):
        raise _Damaged
    return (data[pos] << 8) | data[pos + 1]


@functools.lru_cache(maxsize=64)
def _huffman_table(counts: tuple, symbols: bytes) -> tuple[list, list]:
    """Lookup lists over every 16-bit window: the code length (0: no code
    starts with these bits) and the symbol.  Cached: a video's frames
    repeat their tables, and a table takes milliseconds to build."""
    length = np.zeros(1 << 16, np.int64)
    symbol = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for n in range(1, 17):
        for _ in range(counts[n - 1]):
            if code >= (1 << n):
                raise _Damaged  # more codes than the length has room for
            lo, hi = code << (16 - n), (code + 1) << (16 - n)
            length[lo:hi] = n
            symbol[lo:hi] = symbols[k]
            code += 1
            k += 1
        code <<= 1
    return length.tolist(), symbol.tolist()


def parse(data: bytes, name: str = "JPEG data"):
    """The frame, quantization tables and scans of a JPEG stream: ``(frame,
    latched, scans, colour)``, where ``latched`` maps a component to the
    table it took at its first scan (as libjpeg latches them), each scan
    is ``(components, DC tables, AC tables, restart interval, start, end
    of its entropy-coded bytes)`` and ``colour`` is "gray", "ycc" or
    "rgb".  Raises ValueError for what the decoders do not read and
    _Damaged for a truncated or malformed stream."""
    if data[:2] != b"\xff\xd8":
        raise _Damaged
    pos = 2
    qt: dict[int, np.ndarray] = {}
    ht: dict[tuple[int, int], tuple] = {}
    frame = None
    latched: dict[int, np.ndarray] = {}
    scans = []
    restart = 0
    jfif = False
    adobe = None
    n = len(data)
    while True:
        # a marker, after any fill bytes
        if pos >= n or data[pos] != 0xFF:
            raise _Damaged
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            raise _Damaged
        m = data[pos]
        pos += 1
        if m == 0xD9:  # EOI
            break
        if m in (0x01,) or 0xD0 <= m <= 0xD7:
            continue  # TEM, or a restart marker out of place: no body
        L = _u16(data, pos)
        if L < 2 or pos + L > n:
            raise _Damaged
        body = data[pos + 2:pos + L]
        pos += L
        if m in _REFUSED_SOF:
            raise ValueError(f"{name}: {_REFUSED_SOF[m]} is not supported "
                             "(baseline and extended sequential Huffman only)")
        if m == 0xDC:
            raise ValueError(f"{name}: a DNL marker (image height defined "
                             "after the first scan) is not supported")
        if m == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif m == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif m == 0xDB:  # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                size = 128 if pq else 64
                if tq > 3 or pq > 1 or i + 1 + size > len(body):
                    raise _Damaged
                raw = np.frombuffer(body, ">u2" if pq else np.uint8,
                                    count=64, offset=i + 1)
                q = np.zeros(64, np.int64)
                q[_ZIGZAG] = raw
                qt[tq] = q
                i += 1 + size
        elif m == 0xC4:  # DHT
            i = 0
            while i < len(body):
                if i + 17 > len(body):
                    raise _Damaged
                tc, th = body[i] >> 4, body[i] & 15
                counts = list(body[i + 1:i + 17])
                total = sum(counts)
                if tc > 1 or th > 3 or total > 256 or i + 17 + total > len(body):
                    raise _Damaged
                ht[(tc, th)] = (counts, body[i + 17:i + 17 + total])
                i += 17 + total
        elif m in (0xC0, 0xC1):  # SOF0, SOF1
            if frame is not None or len(body) < 6:
                raise _Damaged
            P, H, W, nc = body[0], _u16(body, 1), _u16(body, 3), body[5]
            if P != 8:
                raise ValueError(f"{name}: {P}-bit sample precision is not "
                                 "supported (8-bit only)")
            if nc not in (1, 3):
                raise ValueError(f"{name}: {nc} components are not supported "
                                 "(gray or three-component colour only)")
            if len(body) != 6 + 3 * nc or H == 0 or W == 0:
                raise _Damaged
            comps = []
            for c in range(nc):
                cid, hv, tq = body[6 + 3 * c:9 + 3 * c]
                h, v = hv >> 4, hv & 15
                if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
                    raise _Damaged
                comps.append((cid, h, v, tq))
            frame = _Frame(H, W, comps)
            for cid, h, v, _ in comps:
                if frame.hmax % h or frame.vmax % v:
                    raise ValueError(f"{name}: fractional sampling factors "
                                     f"({h}x{v} of {frame.hmax}x{frame.vmax}) "
                                     "are not supported")
        elif m == 0xDD:  # DRI
            if len(body) != 2:
                raise _Damaged
            restart = _u16(body, 0)
        elif m == 0xDA:  # SOS
            if frame is None or not body:
                raise _Damaged
            ns = body[0]
            if not 1 <= ns <= len(frame.comps) or len(body) != 4 + 2 * ns:
                raise _Damaged
            ids = [c[0] for c in frame.comps]
            members, dcs, acs = [], [], []
            for j in range(ns):
                cid, t = body[1 + 2 * j], body[2 + 2 * j]
                if cid not in ids:
                    raise _Damaged
                ci = ids.index(cid)
                members.append(ci)
                dcs.append(_table(ht, 0, t >> 4))
                acs.append(_table(ht, 1, t & 15))
                if ci not in latched:
                    tq = frame.comps[ci][3]
                    if tq not in qt:
                        raise _Damaged
                    latched[ci] = qt[tq]
            ss, se, ahal = body[1 + 2 * ns:4 + 2 * ns]
            if ss != 0 or se != 63 or ahal != 0:
                raise _Damaged
            blocks = sum(frame.comps[ci][1] * frame.comps[ci][2]
                         for ci in members) if ns > 1 else 1
            if blocks > 10:
                raise _Damaged
            hit = _END_OF_SCAN.search(data, pos)
            if hit is None:
                raise _Damaged  # the scan runs to the end of the input
            scans.append((members, dcs, acs, restart, pos, hit.start()))
            pos = hit.start()
        # APPn, COM and other marker segments are skipped
    if frame is None or not scans or len(latched) != len(frame.comps):
        raise _Damaged
    nc = len(frame.comps)
    if nc == 1:
        colour = "gray"
    elif adobe is not None and not jfif:
        colour = "rgb" if adobe == 0 else "ycc"
    elif not jfif and [c[0] for c in frame.comps] == [82, 71, 66]:
        colour = "rgb"
    else:
        colour = "ycc"
    return frame, latched, scans, colour


def _table(ht, tc, th):
    if (tc, th) not in ht:
        if (tc, th) not in _STD_HUFFMAN:
            raise _Damaged
        ht[(tc, th)] = _STD_HUFFMAN[(tc, th)]
    counts, symbols = ht[(tc, th)]
    return _huffman_table(tuple(counts), bytes(symbols))


def _segments(data: bytes, start: int, end: int) -> list[bytes]:
    """The restart intervals of a scan's entropy-coded bytes, unstuffed."""
    seg = data[start:end]
    bounds = [m.start() for m in _RST.finditer(seg)]
    parts, prev = [], 0
    for k, b in enumerate(bounds):
        if seg[b + 1] != 0xD0 + (k & 7):
            raise _Damaged  # a restart marker out of sequence
        parts.append(seg[prev:b])
        prev = b + 2
    parts.append(seg[prev:])
    return [p.replace(b"\xff\x00", b"\xff") for p in parts]


def _block_offsets(frame, members, nbx):
    """For each MCU of a scan, the (component, flat block offset) of its
    blocks in decode order, as a function of the MCU index."""
    if len(members) == 1:
        ci = members[0]
        _, h, v, _ = frame.comps[ci]
        bw = _ceil(frame.W * h, frame.hmax * 8)
        bh = _ceil(frame.H * v, frame.vmax * 8)
        return bw * bh, lambda m: ((ci, ((m // bw) * nbx[ci] + m % bw) * 64),)
    layout = []
    for ci in members:
        _, h, v, _ = frame.comps[ci]
        for y in range(v):
            for x in range(h):
                layout.append((ci, h, v, y, x))

    def offsets(m):
        my, mx = divmod(m, frame.mcux)
        return tuple((ci, ((my * v + y) * nbx[ci] + mx * h + x) * 64)
                     for ci, h, v, y, x in layout)
    return frame.mcux * frame.mcuy, offsets


def _decode_scan(data, frame, scan, coef, nbx):
    members, dcs, acs, restart, start, end = scan
    n_mcu, offsets = _block_offsets(frame, members, nbx)
    segments = _segments(data, start, end)
    per = restart if restart else n_mcu
    if len(segments) != -(-n_mcu // per):
        raise _Damaged
    tables = {ci: (dcs[j], acs[j]) for j, ci in enumerate(members)}
    try:
        _decode_intervals(segments, per, n_mcu, offsets, members, tables, coef)
    except IndexError:
        raise _Damaged from None  # damaged data ran past the padding


def _decode_intervals(segments, per, n_mcu, offsets, members, tables, coef):
    zz = _ZIGZAG_LIST
    mcu = 0
    for seg in segments:
        nbits = 8 * len(seg)
        pad = (-len(seg)) % 4 + 8
        words = np.frombuffer(seg + b"\x00" * pad, ">u4").tolist()
        wi, acc, nb = 0, 0, 0
        pred = {ci: 0 for ci in members}
        for m in range(mcu, min(mcu + per, n_mcu)):
            for ci, off in offsets(m):
                (dcl, dcs_), (acl, acs_) = tables[ci]
                out = coef[ci]
                # DC
                if nb < 32:
                    acc = ((acc & ((1 << nb) - 1)) << 32) | words[wi]
                    wi += 1
                    nb += 32
                w = (acc >> (nb - 16)) & 0xFFFF
                ln = dcl[w]
                if not ln:
                    raise _Damaged
                s = dcs_[w]
                nb -= ln
                if s > 15:
                    raise _Damaged
                if s:
                    d = (acc >> (nb - s)) & ((1 << s) - 1)
                    nb -= s
                    if d < (1 << (s - 1)):
                        d -= (1 << s) - 1
                    pred[ci] += d
                out[off] = pred[ci]
                # AC
                k = 1
                while k < 64:
                    if nb < 32:
                        acc = ((acc & ((1 << nb) - 1)) << 32) | words[wi]
                        wi += 1
                        nb += 32
                    w = (acc >> (nb - 16)) & 0xFFFF
                    ln = acl[w]
                    if not ln:
                        raise _Damaged
                    rs = acs_[w]
                    nb -= ln
                    s = rs & 15
                    if s:
                        k += rs >> 4
                        if k > 63:
                            raise _Damaged
                        d = (acc >> (nb - s)) & ((1 << s) - 1)
                        nb -= s
                        if d < (1 << (s - 1)):
                            d -= (1 << s) - 1
                        out[off + zz[k]] = d
                        k += 1
                    elif rs == 0xF0:
                        k += 16
                    else:
                        break  # end of block
            if 32 * wi - nb > nbits:
                raise _Damaged  # the interval ran past its data
        mcu += per


# jidctint.c's constants at CONST_BITS 13
_C = {k: v for k, v in (
    ("0_298631336", 2446), ("0_390180644", 3196), ("0_541196100", 4433),
    ("0_765366865", 6270), ("0_899976223", 7373), ("1_175875602", 9633),
    ("1_501321110", 12299), ("1_847759065", 15137), ("1_961570560", 16069),
    ("2_053119869", 16819), ("2_562915447", 20995), ("3_072711026", 25172))}


def _idct_1d(x, out, shift):
    """One pass of jpeg_idct_islow on the 8 rows x[k] of axis 1, rounded by
    ``shift`` bits, into out[k]."""
    c = _C
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * c["0_541196100"]
    tmp2 = z1 + z3 * -c["1_847759065"]
    tmp3 = z1 + z2 * c["0_765366865"]
    tmp0 = (x[0] + x[4]) << 13
    tmp1 = (x[0] - x[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * c["1_175875602"]
    t0 = t0 * c["0_298631336"]
    t1 = t1 * c["2_053119869"]
    t2 = t2 * c["3_072711026"]
    t3 = t3 * c["1_501321110"]
    z1 = z1 * -c["0_899976223"]
    z2 = z2 * -c["2_562915447"]
    z3 = z3 * -c["1_961570560"] + z5
    z4 = z4 * -c["0_390180644"] + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    r = 1 << (shift - 1)
    out[0] = (tmp10 + t3 + r) >> shift
    out[7] = (tmp10 - t3 + r) >> shift
    out[1] = (tmp11 + t2 + r) >> shift
    out[6] = (tmp11 - t2 + r) >> shift
    out[2] = (tmp12 + t1 + r) >> shift
    out[5] = (tmp12 - t1 + r) >> shift
    out[3] = (tmp13 + t0 + r) >> shift
    out[4] = (tmp13 - t0 + r) >> shift


def idct_islow(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """libjpeg's jpeg_idct_islow of blocks [N, 64] (natural order) with the
    quantization table ``q`` [64]: the samples [N, 8, 8] uint8."""
    x = (coef.astype(np.int64) * q).reshape(-1, 8, 8).transpose(1, 0, 2)
    ws = np.empty_like(x)
    _idct_1d(x, ws, 13 - 2)                  # columns: x[k] = row k
    out = np.empty_like(x)
    _idct_1d(ws.transpose(2, 1, 0), out.transpose(2, 1, 0), 13 + 2 + 3)
    # the range limit: ten bits, wrapped, then clamped around 128
    s = ((out + 512) & 1023) - 512
    return np.clip(s + 128, 0, 255).astype(np.uint8).transpose(1, 0, 2)


def _clamped(x: np.ndarray, axis: int, step: int) -> np.ndarray:
    """x shifted by ``step`` along ``axis``, the edge sample repeated."""
    n = x.shape[axis]
    idx = np.clip(np.arange(n) + step, 0, n - 1)
    return np.take(x, idx, axis=axis)


def upsample(plane: np.ndarray, dw: int, dh: int, fh: int, fv: int) -> np.ndarray:
    """jdsample.c's upsampling of a component's samples [>= dh, >= dw]
    (``dw`` x ``dh`` of them real) by (fh, fv): [dh * fv, dw * fh]."""
    x = plane[:dh, :dw].astype(np.int32)
    if (fh, fv) == (1, 1):
        return x
    if (fh, fv) == (2, 1) and dw > 2:
        out = np.empty((dh, 2 * dw), np.int32)
        out[:, 0::2] = (3 * x + _clamped(x, 1, -1) + 1) >> 2
        out[:, 1::2] = (3 * x + _clamped(x, 1, 1) + 2) >> 2
        return out
    if (fh, fv) == (1, 2):
        out = np.empty((2 * dh, dw), np.int32)
        out[0::2] = (3 * x + _clamped(x, 0, -1) + 1) >> 2
        out[1::2] = (3 * x + _clamped(x, 0, 1) + 2) >> 2
        return out
    if (fh, fv) == (2, 2) and dw > 2:
        out = np.empty((2 * dh, 2 * dw), np.int32)
        for r, far in ((0, _clamped(x, 0, -1)), (1, _clamped(x, 0, 1))):
            cs = 3 * x + far
            out[r::2, 0::2] = (3 * cs + _clamped(cs, 1, -1) + 8) >> 4
            out[r::2, 1::2] = (3 * cs + _clamped(cs, 1, 1) + 7) >> 4
        return out
    return np.repeat(np.repeat(x, fv, axis=0), fh, axis=1)


def _ycc_tables():
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15
    cr_r = (91881 * x + half) >> 16         # FIX(1.40200)
    cb_b = (116130 * x + half) >> 16        # FIX(1.77200)
    cr_g = -46802 * x                       # -FIX(0.71414)
    cb_g = -22554 * x + half                # -FIX(0.34414), rounding added
    return cr_r, cb_b, cr_g, cb_g


_YCC = _ycc_tables()


def ycc_to_bgr(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert of uint8-valued planes: BGR uint8."""
    cr_r, cb_b, cr_g, cb_g = _YCC
    y = y.astype(np.int64)
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack([b, g, r], axis=-1), 0, 255).astype(np.uint8)


def _decode_python(data: bytes, name: str) -> np.ndarray:
    frame, latched, scans, colour = parse(data, name)
    nbx = [frame.mcux * h for _, h, _, _ in frame.comps]
    nby = [frame.mcuy * v for _, _, v, _ in frame.comps]
    coef = [[0] * (64 * bx * by) for bx, by in zip(nbx, nby)]
    for scan in scans:
        _decode_scan(data, frame, scan, coef, nbx)
    planes = []
    for ci, (_, h, v, _) in enumerate(frame.comps):
        blocks = np.asarray(coef[ci], np.int64).reshape(-1, 64)
        px = idct_islow(blocks, latched[ci])
        plane = px.reshape(nby[ci], nbx[ci], 8, 8).transpose(0, 2, 1, 3)
        plane = plane.reshape(nby[ci] * 8, nbx[ci] * 8)
        dw = _ceil(frame.W * h, frame.hmax)
        dh = _ceil(frame.H * v, frame.vmax)
        up = upsample(plane, dw, dh, frame.hmax // h, frame.vmax // v)
        planes.append(up[:frame.H, :frame.W])
    if colour == "gray":
        return np.repeat(planes[0].astype(np.uint8)[..., None], 3, axis=-1)
    if colour == "rgb":
        return np.stack(planes[::-1], axis=-1).astype(np.uint8)
    return ycc_to_bgr(*planes)


def _decode_compiled(data: bytes, name: str) -> np.ndarray | None:
    from ..ops._build import load_kernels

    frame, _, _, _ = parse(data, name)  # refuses what neither form reads
    lib = load_kernels()  # raises with nvcc's output when it cannot build
    out = np.empty((frame.H, frame.W, 3), np.uint8)
    rc = lib.ofc_jpeg_decode(data, len(data), out.ctypes.data,
                             frame.H, frame.W)
    if rc == 1:
        return None
    if rc != 0:
        raise RuntimeError(f"ofc_jpeg_decode failed with code {rc} on "
                           f"{name}, which the plain form reads")
    return out


def imdecode(buf, force_python: bool = False,
             name: str = "JPEG data") -> np.ndarray | None:
    """The JPEG in ``buf`` (bytes, or a uint8 array) as ``cv2.imdecode(buf,
    cv2.IMREAD_COLOR)`` returns it: BGR uint8 [H, W, 3], or None when the
    data are truncated or damaged.  The compiled form runs unless
    ``force_python`` asks for the plain one."""
    data = bytes(buf) if not isinstance(buf, bytes) else buf
    try:
        if force_python:
            return _decode_python(data, name)
        return _decode_compiled(data, name)
    except _Damaged:
        return None


def imread(path: str, force_python: bool = False) -> np.ndarray | None:
    """The JPEG file at ``path`` as ``cv2.imread`` returns it (BGR uint8),
    or None when it is truncated or damaged."""
    with open(path, "rb") as f:
        return imdecode(f.read(), force_python, name=path)
