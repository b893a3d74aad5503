"""Image codecs on numpy and the standard library: PNG in and out, JPEG out.

The reference encodes through the ``image`` crate (reference
``src/http.rs:136-148`` for JPEG q90, ``src/cli.rs:170-176`` for PNG). These
are the Python paths beside the native C++ encoders (:mod:`..native`):

* :func:`encode_png` / :func:`decode_png` — 8-bit PNG over ``zlib``
  (decode: greyscale, RGB, palette, grey+alpha, RGBA; all five row
  filters; no interlacing);
* :func:`encode_jpeg` — baseline JPEG (JFIF, YCbCr 4:4:4, the ITU T.81
  Annex K tables scaled by quality the way libjpeg scales them), with the
  entropy coder vectorized in numpy.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# ----------------------------------------------------------------- PNG --
_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes (RGB8, filter 0)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape[:2]
    if img.ndim != 3 or img.shape[2] != 3 or h == 0 or w == 0:
        raise ValueError(f"expected a non-empty (H, W, 3) image, got {img.shape}")
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)],
                         axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_PNG_SIG + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (PNG spec section 9)."""
    rows = np.frombuffer(data, np.uint8)[:h * (stride + 1)]
    rows = rows.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = int(rows[y, 0])
        line = rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype == 1:
            # each byte adds the byte bpp to its left: a running sum per channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype in (3, 4):
            # Average and Paeth predict from the reconstructed left byte, so
            # they run serially (on Python ints, much faster than numpy
            # scalars)
            cur, up = line.tolist(), prev.tolist()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = up[x]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
            cur = np.asarray(cur, np.int32)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB (alpha dropped, grey expanded)."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos, idat, plte, hdr = 8, [], None, None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace:
        raise ValueError(f"unsupported PNG: depth {depth}, color type {ctype}, "
                         f"interlace {interlace} (8-bit non-interlaced only)")
    ch = _PNG_CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    px = px.reshape(h, w, ch)
    if ctype == 3:
        if plte is None:
            raise ValueError("palette PNG without PLTE")
        return plte[px[..., 0]]
    if ch <= 2:
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


# ---------------------------------------------------------------- JPEG --
# ITU T.81 Annex K: quantization tables (natural order) ...
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], np.int32)
_Q_CHROMA = np.full(64, 99, np.int32)
_Q_CHROMA[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]

# ... and Huffman tables: code counts per length 1..16, then symbols.
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], bytes.fromhex("""
    01 02 03 00 04 11 05 12 21 31 41 06 13 51 61 07
    22 71 14 32 81 91 a1 08 23 42 b1 c1 15 52 d1 f0
    24 33 62 72 82 09 0a 16 17 18 19 1a 25 26 27 28
    29 2a 34 35 36 37 38 39 3a 43 44 45 46 47 48 49
    4a 53 54 55 56 57 58 59 5a 63 64 65 66 67 68 69
    6a 73 74 75 76 77 78 79 7a 83 84 85 86 87 88 89
    8a 92 93 94 95 96 97 98 99 9a a2 a3 a4 a5 a6 a7
    a8 a9 aa b2 b3 b4 b5 b6 b7 b8 b9 ba c2 c3 c4 c5
    c6 c7 c8 c9 ca d2 d3 d4 d5 d6 d7 d8 d9 da e1 e2
    e3 e4 e5 e6 e7 e8 e9 ea f1 f2 f3 f4 f5 f6 f7 f8
    f9 fa"""))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex("""
    00 01 02 03 11 04 05 21 31 06 12 41 51 07 61 71
    13 22 32 81 08 14 42 91 a1 b1 c1 09 23 33 52 f0
    15 62 72 d1 0a 16 24 34 e1 25 f1 17 18 19 1a 26
    27 28 29 2a 35 36 37 38 39 3a 43 44 45 46 47 48
    49 4a 53 54 55 56 57 58 59 5a 63 64 65 66 67 68
    69 6a 73 74 75 76 77 78 79 7a 82 83 84 85 86 87
    88 89 8a 92 93 94 95 96 97 98 99 9a a2 a3 a4 a5
    a6 a7 a8 a9 aa b2 b3 b4 b5 b6 b7 b8 b9 ba c2 c3
    c4 c5 c6 c7 c8 c9 ca d2 d3 d4 d5 d6 d7 d8 d9 da
    e2 e3 e4 e5 e6 e7 e8 e9 ea f2 f3 f4 f5 f6 f7 f8
    f9 fa"""))


def _zigzag() -> np.ndarray:
    """Natural-order index of each zigzag position (T.81 figure A.6)."""
    cells = [(i, j) for i in range(8) for j in range(8)]
    cells.sort(key=lambda c: (c[0] + c[1],
                              c[0] if (c[0] + c[1]) % 2 else c[1]))
    return np.array([i * 8 + j for i, j in cells], np.int64)


_ZIGZAG = _zigzag()


def _quant_tables(quality: int):
    """libjpeg's quality scaling of the Annex K tables (natural order)."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255)
                 for t in (_Q_LUMA, _Q_CHROMA))


def _huff_codes(spec):
    """Canonical Huffman code (code, length) for every symbol (T.81 C)."""
    counts, symbols = spec
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            code_of[symbols[k]] = code
            len_of[symbols[k]] = length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


_DCT = np.array([[(np.sqrt(0.125) if k == 0 else 0.5)
                  * np.cos((2 * n + 1) * k * np.pi / 16) for n in range(8)]
                 for k in range(8)])


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(H8, W8) plane -> (n_blocks, 8, 8) in row-major block order."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).swapaxes(1, 2).reshape(-1, 8, 8)


def _bit_length(v: np.ndarray) -> np.ndarray:
    """Magnitude category of each coefficient (T.81 F.1.2.1)."""
    return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)


def _amplitude_bits(v: np.ndarray, size: np.ndarray) -> np.ndarray:
    """Additional bits: v for v >= 0, else v - 1 in ``size`` bits."""
    return np.where(v >= 0, v, v + (1 << size) - 1).astype(np.int64)


def _scan_tokens(coef, dc_tab, ac_tab):
    """(code, nbits, sort key) tokens of one component's blocks.

    ``coef`` is (n_blocks, 64) quantized coefficients in zigzag order. The
    key orders tokens within a block; the caller interleaves components.
    """
    nb = coef.shape[0]
    dc_code, dc_len = dc_tab
    ac_code, ac_len = ac_tab
    codes, lens, blk, pos = [], [], [], []

    def emit(c, l, b, p):
        codes.append(c)
        lens.append(l)
        blk.append(b)
        pos.append(p)

    # DC: difference to the previous block's DC, category + amplitude
    dc = coef[:, 0]
    diff = np.diff(dc, prepend=0)
    size = _bit_length(diff)
    bidx = np.arange(nb)
    emit(dc_code[size], dc_len[size], bidx, np.zeros(nb))
    emit(_amplitude_bits(diff, size), size, bidx, np.full(nb, 0.5))

    # AC: one (run, size) symbol per nonzero, ZRL for every 16 zeros skipped
    ac = coef[:, 1:]
    b_nz, k_nz = np.nonzero(ac)
    v = ac[b_nz, k_nz]
    first = np.r_[True, b_nz[1:] != b_nz[:-1]] if b_nz.size else np.zeros(0, bool)
    prev_k = np.where(first, -1, np.r_[-1, k_nz[:-1]])
    run = k_nz - prev_k - 1
    n_zrl = run // 16
    size = _bit_length(v)
    sym = (run % 16) * 16 + size
    emit(ac_code[sym], ac_len[sym], b_nz, k_nz + 1.0)
    emit(_amplitude_bits(v, size), size, b_nz, k_nz + 1.5)
    if n_zrl.any():
        rep = np.repeat(np.arange(b_nz.size), n_zrl)
        j = np.arange(rep.size) - np.repeat(np.cumsum(n_zrl) - n_zrl, n_zrl)
        emit(np.full(rep.size, ac_code[0xF0]), np.full(rep.size, ac_len[0xF0]),
             b_nz[rep], k_nz[rep] + 0.01 * (j + 1) - 0.5)
    # EOB unless the last coefficient is nonzero
    eob = ac[:, -1] == 0
    emit(np.full(eob.sum(), ac_code[0x00]), np.full(eob.sum(), ac_len[0x00]),
         np.nonzero(eob)[0], np.full(eob.sum(), 64.0))
    return (np.concatenate(codes), np.concatenate(lens),
            np.concatenate(blk), np.concatenate(pos))


def _pack_bits(codes: np.ndarray, lens: np.ndarray) -> bytes:
    """Concatenate variable-length codes MSB first, pad with 1s, stuff FF."""
    keep = lens > 0
    codes, lens = codes[keep].astype(np.uint64), lens[keep]
    # each code's bits, MSB first: bit i of a len-L code is (code >> (L-1-i))
    starts = np.cumsum(lens) - lens
    total = int(lens.sum())
    owner = np.repeat(np.arange(lens.size), lens)
    shift = (lens[owner] - 1 - (np.arange(total) - starts[owner])).astype(np.uint64)
    bits = ((codes[owner] >> shift) & np.uint64(1)).astype(np.uint8)
    pad = (-total) % 8
    bits = np.concatenate([bits, np.ones(pad, np.uint8)])
    out = np.packbits(bits)
    ff = np.nonzero(out == 0xFF)[0]
    return np.insert(out, ff + 1, 0).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", marker, len(body) + 2) + body


def encode_jpeg(img: np.ndarray, quality: int = 90) -> bytes:
    """(H, W, 3) uint8 RGB -> baseline JPEG bytes (JFIF, 4:4:4)."""
    img = np.asarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3 or 0 in img.shape[:2]:
        raise ValueError(f"expected a non-empty (H, W, 3) image, got {img.shape}")
    h, w = img.shape[:2]
    ph, pw = -h % 8, -w % 8
    x = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="edge").astype(np.float64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    planes = (0.299 * r + 0.587 * g + 0.114 * b - 128.0,
              -0.168736 * r - 0.331264 * g + 0.5 * b,
              0.5 * r - 0.418688 * g - 0.081312 * b)
    q_luma, q_chroma = _quant_tables(quality)
    tabs = ((_huff_codes(_DC_LUMA), _huff_codes(_AC_LUMA)),
            (_huff_codes(_DC_CHROMA), _huff_codes(_AC_CHROMA)))
    streams = []
    for c, (plane, q) in enumerate(zip(planes, (q_luma, q_chroma, q_chroma))):
        blocks = _DCT @ _blocks(plane) @ _DCT.T
        coef = np.round(blocks.reshape(-1, 64) / q).astype(np.int64)
        dc_tab, ac_tab = tabs[min(c, 1)]
        code, nbits, blk, pos = _scan_tokens(coef[:, _ZIGZAG], dc_tab, ac_tab)
        streams.append((code, nbits, blk, pos + 100.0 * c))
    code, nbits, blk, pos = (np.concatenate(p) for p in zip(*streams))
    order = np.lexsort((pos, blk))          # MCU = Y, Cb, Cr block
    scan = _pack_bits(code[order], nbits[order])

    def dqt(tid, t):
        return bytes([tid]) + bytes(t[_ZIGZAG].astype(np.uint8))

    def dht(cls_id, spec):
        counts, symbols = spec
        return bytes([cls_id]) + bytes(counts) + bytes(symbols)

    return b"".join([
        b"\xff\xd8",
        _segment(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"),
        _segment(0xFFDB, dqt(0, q_luma) + dqt(1, q_chroma)),
        _segment(0xFFC0, struct.pack(">BHHB", 8, h, w, 3)
                 + bytes([1, 0x11, 0, 2, 0x11, 1, 3, 0x11, 1])),
        _segment(0xFFC4, dht(0x00, _DC_LUMA) + dht(0x10, _AC_LUMA)
                 + dht(0x01, _DC_CHROMA) + dht(0x11, _AC_CHROMA)),
        _segment(0xFFDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])),
        scan,
        b"\xff\xd9",
    ])


def jpeg_size(data: bytes):
    """(width, height) from the SOF0 segment of a baseline JPEG."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("missing JPEG SOI marker")
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"bad JPEG marker at byte {pos}")
        marker = data[pos + 1]
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if marker == 0xC0:
            h, w = struct.unpack(">HH", data[pos + 5:pos + 9])
            return w, h
        pos += 2 + n
    raise ValueError("no SOF0 segment")
