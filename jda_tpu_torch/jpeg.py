"""Baseline grayscale JPEG, decode and encode (numpy, on the host).

The FDDB harness reads its images as JPEG; where OpenCV is missing this
module is the reader (`imread_gray`, the `imread=` of `fddb.run_fddb`) and
the writer of the synthetic FDDB tree (scripts/synth_fddb_torch.py).  It
models libjpeg-turbo as OpenCV builds it, bit for bit:

- `decode_gray` equals `cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2GRAY)`
  on baseline (SOF0 / SOF1), 8-bit, one-component files: Huffman decoding
  (restart intervals included), dequantisation, libjpeg's integer inverse
  DCT (`jpeg_idct_islow`) and the range limit.  A gray JPEG read in colour
  gives three equal channels, and OpenCV's BGR-to-gray of three equal
  channels is that value, so the gray plane is the whole answer.
- `encode_gray` equals `cv2.imencode('.jpg', img)` byte for byte: the JFIF
  APP0 segment, `jpeg_set_quality`'s scaled luminance table, the integer
  forward DCT (`jpeg_fdct_islow`), libjpeg-turbo's reciprocal quantisation,
  the standard Huffman tables, 0xFF stuffing and 1-bit padding; images
  whose sides are not multiples of 8 are padded by repeating the last row
  and column.

Anything else (progressive or lossless frames, arithmetic coding, more
than one component, 12-bit samples) raises NotImplementedError naming
what it met.  The DCTs, quantisation and bit packing are vectorised; the
Huffman decoder is a Python loop over the symbols.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

# natural (row-major) index of the k-th coefficient in zigzag order
ZIGZAG = np.array(sorted(
    ((u, v) for u in range(8) for v in range(8)),
    key=lambda p: (p[0] + p[1], p[0] if (p[0] + p[1]) % 2 else p[1]),
), np.int64) @ np.array([8, 1])

# the luminance quantisation table of the JPEG standard (K.1), natural order
STD_LUMINANCE_QT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99,
], np.int64)

# the standard luminance Huffman tables (K.3): code counts per length 1-16
# and the symbols in code order
DC_BITS = (0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0)
DC_VALS = tuple(range(12))
AC_BITS = (0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D)
AC_VALS = (
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
)

# jfdctint.c / jidctint.c fixed-point constants (CONST_BITS = 13)
CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100 = 2446, 3196, 4433
FIX_0_765366865, FIX_0_899976223, FIX_1_175875602 = 6270, 7373, 9633
FIX_1_501321110, FIX_1_847759065, FIX_1_961570560 = 12299, 15137, 16069
FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16819, 20995, 25172

# start-of-frame markers that are not baseline or extended sequential Huffman
_UNSUPPORTED_SOF = {
    0xC2: "a progressive JPEG (SOF2)",
    0xC3: "a lossless JPEG (SOF3)",
    0xC5: "a differential sequential JPEG (SOF5)",
    0xC6: "a differential progressive JPEG (SOF6)",
    0xC7: "a differential lossless JPEG (SOF7)",
    0xC9: "an arithmetic-coded JPEG (SOF9)",
    0xCA: "an arithmetic-coded progressive JPEG (SOF10)",
    0xCB: "an arithmetic-coded lossless JPEG (SOF11)",
    0xCD: "an arithmetic-coded differential JPEG (SOF13)",
    0xCE: "an arithmetic-coded differential progressive JPEG (SOF14)",
    0xCF: "an arithmetic-coded differential lossless JPEG (SOF15)",
}


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


# -- the integer DCTs -------------------------------------------------------

def _fdct_1d(d: List[np.ndarray], first: bool) -> List[np.ndarray]:
    """One pass of jpeg_fdct_islow over the eight arrays `d` (one per
    sample position): the row pass (`first`) scales by 2^PASS1_BITS, the
    column pass removes it and leaves the factor of 8."""
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    n = CONST_BITS - PASS1_BITS if first else CONST_BITS + PASS1_BITS
    out = [None] * 8
    if first:
        out[0] = (tmp10 + tmp11) << PASS1_BITS
        out[4] = (tmp10 - tmp11) << PASS1_BITS
    else:
        out[0] = _descale(tmp10 + tmp11, PASS1_BITS)
        out[4] = _descale(tmp10 - tmp11, PASS1_BITS)
    z1 = (tmp12 + tmp13) * FIX_0_541196100
    out[2] = _descale(z1 + tmp13 * FIX_0_765366865, n)
    out[6] = _descale(z1 - tmp12 * FIX_1_847759065, n)
    z1, z2 = tmp4 + tmp7, tmp5 + tmp6
    z3, z4 = tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * FIX_1_175875602
    tmp4 = tmp4 * FIX_0_298631336
    tmp5 = tmp5 * FIX_2_053119869
    tmp6 = tmp6 * FIX_3_072711026
    tmp7 = tmp7 * FIX_1_501321110
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    out[7] = _descale(tmp4 + z1 + z3, n)
    out[5] = _descale(tmp5 + z2 + z4, n)
    out[3] = _descale(tmp6 + z2 + z3, n)
    out[1] = _descale(tmp7 + z1 + z4, n)
    return out


def fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """jpeg_fdct_islow on level-shifted samples [N, 8, 8] (int64): the DCT
    coefficients scaled up by 8, natural order."""
    rows = _fdct_1d([blocks[:, :, i] for i in range(8)], True)
    rows = np.stack(rows, axis=2)
    cols = _fdct_1d([rows[:, i, :] for i in range(8)], False)
    return np.stack(cols, axis=1)


def _idct_1d(c: List[np.ndarray], n: int) -> List[np.ndarray]:
    """One pass of jpeg_idct_islow over the eight arrays `c` (one per
    frequency), descaled by n bits."""
    z2, z3 = c[2], c[6]
    z1 = (z2 + z3) * FIX_0_541196100
    tmp2 = z1 - z3 * FIX_1_847759065
    tmp3 = z1 + z2 * FIX_0_765366865
    tmp0 = (c[0] + c[4]) << CONST_BITS
    tmp1 = (c[0] - c[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = c[7], c[5], c[3], c[1]
    z1, z2 = tmp0 + tmp3, tmp1 + tmp2
    z3, z4 = tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * FIX_1_175875602
    tmp0 = tmp0 * FIX_0_298631336
    tmp1 = tmp1 * FIX_2_053119869
    tmp2 = tmp2 * FIX_3_072711026
    tmp3 = tmp3 * FIX_1_501321110
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    tmp0 = tmp0 + z1 + z3
    tmp1 = tmp1 + z2 + z4
    tmp2 = tmp2 + z2 + z3
    tmp3 = tmp3 + z1 + z4
    return [
        _descale(tmp10 + tmp3, n), _descale(tmp11 + tmp2, n),
        _descale(tmp12 + tmp1, n), _descale(tmp13 + tmp0, n),
        _descale(tmp13 - tmp0, n), _descale(tmp12 - tmp1, n),
        _descale(tmp11 - tmp2, n), _descale(tmp10 - tmp3, n),
    ]


def idct_islow(coefs: np.ndarray) -> np.ndarray:
    """jpeg_idct_islow on dequantised coefficients [N, 8, 8] (int64,
    natural order): the samples, level-shifted back and range-limited to
    uint8 (values past the 8-bit range saturate, as libjpeg-turbo's SIMD
    IDCT packs them)."""
    cols = _idct_1d([coefs[:, i, :] for i in range(8)], CONST_BITS - PASS1_BITS)
    ws = np.stack(cols, axis=1)
    rows = _idct_1d([ws[:, :, i] for i in range(8)], CONST_BITS + PASS1_BITS + 3)
    out = np.stack(rows, axis=2)
    return np.clip(out + 128, 0, 255).astype(np.uint8)


# -- Huffman tables ------------------------------------------------------------

def _huff_codes(bits, vals) -> Dict[int, Tuple[int, int]]:
    """Canonical Huffman codes: symbol -> (code, length)."""
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


def _huff_lut(bits, vals) -> List[int]:
    """Decoding table over 16-bit prefixes: (length << 8) | symbol, 0 for a
    prefix that starts no code."""
    lut = [0] * 65536
    for sym, (code, length) in _huff_codes(bits, vals).items():
        lo = code << (16 - length)
        entry = (length << 8) | sym
        lut[lo:lo + (1 << (16 - length))] = [entry] * (1 << (16 - length))
    return lut


def _code_array(bits, vals) -> Tuple[np.ndarray, np.ndarray]:
    codes = _huff_codes(bits, vals)
    code = np.zeros(256, np.int64)
    size = np.zeros(256, np.int64)
    for sym, (c, n) in codes.items():
        code[sym], size[sym] = c, n
    return code, size


# -- decode ---------------------------------------------------------------------

def _segments(data: bytes):
    """Marker segments of a JPEG stream before its scan: yields (marker,
    payload, offset after the segment)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG stream (no SOI marker)")
    i = 2
    while i + 4 <= len(data):
        if data[i] != 0xFF:
            raise ValueError(f"JPEG stream: expected a marker at byte {i}")
        marker = data[i + 1]
        if marker == 0xFF:  # fill byte
            i += 1
            continue
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            i += 2
            continue
        if marker == 0xD9:
            break
        length = int.from_bytes(data[i + 2:i + 4], "big")
        yield marker, data[i + 4:i + 2 + length], i + 2 + length
        i += 2 + length
    raise ValueError("JPEG stream ends before its scan (no SOS marker)")


def _entropy_data(data: bytes, start: int) -> List[bytes]:
    """The entropy-coded data after the SOS segment, split at its restart
    markers, with 0xFF 0x00 unstuffed."""
    parts, cur, i, n = [], bytearray(), start, len(data)
    while i < n:
        b = data[i]
        if b != 0xFF:
            j = data.find(b"\xff", i)
            j = n if j < 0 else j
            cur += data[i:j]
            i = j
            continue
        if i + 1 >= n:
            break
        m = data[i + 1]
        if m == 0x00:
            cur.append(0xFF)
            i += 2
        elif m == 0xFF:
            i += 1
        elif 0xD0 <= m <= 0xD7:
            parts.append(bytes(cur))
            cur = bytearray()
            i += 2
        else:
            break  # EOI or another marker ends the scan
    parts.append(bytes(cur))
    return parts


def _decode_blocks(seg: bytes, n_blocks: int, dc_lut, ac_lut, out: list, base: int) -> None:
    """Huffman-decode `n_blocks` blocks of one restart interval into the
    flat zigzag-ordered list `out` from block `base` on (DC differences
    undone within the interval)."""
    # 40-bit big-endian window at every byte; a 32-bit window at bit p is
    # (win[p >> 3] >> (8 - (p & 7))) & 0xFFFFFFFF.  The tail is padded with
    # ones, as libjpeg fills a short stream.
    padded = np.frombuffer(seg + b"\xff" * 8, np.uint8).astype(np.int64)
    nb = len(seg) + 4
    win = ((padded[0:nb] << 32) | (padded[1:nb + 1] << 24) | (padded[2:nb + 2] << 16)
           | (padded[3:nb + 3] << 8) | padded[4:nb + 4]).tolist()
    limit = 8 * len(seg)
    p, pred = 0, 0
    for b in range(base, base + n_blocks):
        w = (win[p >> 3] >> (8 - (p & 7))) & 0xFFFFFFFF
        e = dc_lut[w >> 16]
        if not e:
            raise ValueError("corrupt JPEG data: bad Huffman code")
        length, s = e >> 8, e & 255
        if s:
            v = (w >> (32 - length - s)) & ((1 << s) - 1)
            if v < (1 << (s - 1)):
                v -= (1 << s) - 1
            pred += v
        p += length + s
        o = b * 64
        out[o] = pred
        k = 1
        while k < 64:
            w = (win[p >> 3] >> (8 - (p & 7))) & 0xFFFFFFFF
            e = ac_lut[w >> 16]
            if not e:
                raise ValueError("corrupt JPEG data: bad Huffman code")
            length, rs = e >> 8, e & 255
            s = rs & 15
            if s:
                k += rs >> 4
                if k > 63:
                    raise ValueError("corrupt JPEG data: coefficient past 63")
                v = (w >> (32 - length - s)) & ((1 << s) - 1)
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
                out[o + k] = v
                p += length + s
                k += 1
            else:
                p += length
                if rs == 0xF0:
                    k += 16
                else:
                    break  # end of block
        if p > limit:
            raise ValueError("corrupt JPEG data: the scan ends early")


def decode_gray(data: bytes) -> np.ndarray:
    """Decode a baseline, 8-bit, one-component JPEG to uint8 [H, W]."""
    qt: Dict[int, np.ndarray] = {}
    dc: Dict[int, list] = {}
    ac: Dict[int, list] = {}
    frame = None
    restart = 0
    for marker, seg, end in _segments(data):
        if marker == 0xDB:  # DQT
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                if pq:
                    vals = np.frombuffer(seg[i + 1:i + 129], ">u2").astype(np.int64)
                    i += 129
                else:
                    vals = np.frombuffer(seg[i + 1:i + 65], np.uint8).astype(np.int64)
                    i += 65
                table = np.zeros(64, np.int64)
                table[ZIGZAG] = vals
                qt[tq] = table
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                bits = tuple(seg[i + 1:i + 17])
                vals = tuple(seg[i + 17:i + 17 + sum(bits)])
                (ac if tc else dc)[th] = _huff_lut(bits, vals)
                i += 17 + sum(bits)
        elif marker == 0xDD:  # DRI
            restart = int.from_bytes(seg[:2], "big")
        elif marker in _UNSUPPORTED_SOF:
            raise NotImplementedError(f"decode_gray: {_UNSUPPORTED_SOF[marker]}")
        elif marker in (0xC0, 0xC1):  # baseline / extended sequential Huffman
            precision = seg[0]
            if precision != 8:
                raise NotImplementedError(f"decode_gray: {precision}-bit samples")
            h, w, nc = int.from_bytes(seg[1:3], "big"), int.from_bytes(seg[3:5], "big"), seg[5]
            if nc != 1:
                raise NotImplementedError(f"decode_gray: {nc} components")
            if h == 0:
                raise NotImplementedError("decode_gray: a frame height set by DNL")
            frame = (h, w, seg[8])
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise ValueError("JPEG stream: scan before the frame header")
            if seg[0] != 1:
                raise NotImplementedError(f"decode_gray: a scan of {seg[0]} components")
            td, ta = seg[2] >> 4, seg[2] & 15
            h, w, tq = frame
            bh, bw = -(-h // 8), -(-w // 8)
            n = bh * bw
            flat = [0] * (64 * n)
            parts = _entropy_data(data, end)
            per = restart or n
            for j in range(-(-n // per)):
                if j >= len(parts):
                    raise ValueError("corrupt JPEG data: missing restart interval")
                _decode_blocks(parts[j], min(per, n - j * per), dc[td], ac[ta], flat, j * per)
            zz = np.asarray(flat, np.int64).reshape(n, 64)
            coefs = np.zeros((n, 64), np.int64)
            coefs[:, ZIGZAG] = zz * qt[tq][ZIGZAG]
            blocks = idct_islow(coefs.reshape(n, 8, 8))
            img = blocks.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)
            return np.ascontiguousarray(img[:h, :w])
    raise ValueError("JPEG stream without a scan")


def imread_gray(path: str) -> Optional[np.ndarray]:
    """The gray image of a JPEG file, or None where the file cannot be read
    (the `imread=` contract of `fddb.run_fddb`)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    return decode_gray(data)


# -- encode -----------------------------------------------------------------------

def quality_table(quality: int) -> np.ndarray:
    """jpeg_set_quality's luminance table (natural order), forced to
    baseline (1..255)."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((STD_LUMINANCE_QT * scale + 50) // 100, 1, 255)


def _reciprocals(q: np.ndarray):
    """libjpeg-turbo's quantisation divisors for the islow DCT (divisor =
    q * 8): reciprocal, correction and shift, so that a coefficient x
    becomes sign(x) * ((|x| + correction) * reciprocal >> shift)."""
    recip, corr, shift = [], [], []
    for divisor in (q * 8).tolist():
        b = divisor.bit_length() - 1
        r = 16 + b
        fq, fr = divmod(1 << r, divisor)
        c = divisor // 2
        if fr == 0:  # a power of two
            fq >>= 1
            r -= 1
        elif fr <= divisor // 2:
            c += 1
        else:
            fq += 1
        recip.append(fq)
        corr.append(c)
        shift.append(r)
    return np.array(recip, np.int64), np.array(corr, np.int64), np.array(shift, np.int64)


def _pack_bits(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """The bit string of (value, length) pieces, MSB first, padded with
    ones to a byte and 0xFF-stuffed."""
    total = int(lengths.sum())
    piece = np.repeat(np.arange(len(lengths)), lengths)
    ends = np.cumsum(lengths)
    off = np.arange(total) - np.repeat(ends - lengths, lengths)
    bits = (values[piece] >> (lengths[piece] - 1 - off)) & 1
    pad = (-total) % 8
    bits = np.concatenate([bits, np.ones(pad, np.int64)]).astype(np.uint8)
    packed = np.packbits(bits)
    ff = packed == 0xFF
    out = np.zeros(len(packed) + int(ff.sum()), np.uint8)
    pos = np.arange(len(packed)) + np.concatenate([[0], np.cumsum(ff)[:-1]])
    out[pos] = packed
    return out.tobytes()


def _category(v: np.ndarray) -> np.ndarray:
    """Bit length of |v| (0 for 0)."""
    a = np.abs(v)
    n = np.zeros_like(a)
    while True:
        m = a > 0
        if not m.any():
            return n
        n[m] += 1
        a >>= 1


def encode_gray(img: np.ndarray, quality: int = 95) -> bytes:
    """`cv2.imencode('.jpg', img, [cv2.IMWRITE_JPEG_QUALITY, quality])` of
    a 2-D uint8 image, byte for byte."""
    if img.dtype != np.uint8 or img.ndim != 2 or 0 in img.shape:
        raise ValueError("encode_gray: img must be a non-empty 2-D uint8 array")
    h, w = img.shape
    if h > 65535 or w > 65535:
        raise ValueError("encode_gray: a JPEG side is at most 65535")
    q = quality_table(quality)
    bh, bw = -(-h // 8), -(-w // 8)
    full = np.pad(img, ((0, bh * 8 - h), (0, bw * 8 - w)), mode="edge").astype(np.int64)
    blocks = full.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8) - 128
    coefs = fdct_islow(blocks).reshape(-1, 64)
    recip, corr, shift = _reciprocals(q)
    quant = np.sign(coefs) * (((np.abs(coefs) + corr) * recip) >> shift)
    zz = quant[:, ZIGZAG]
    n = len(zz)

    dc_code, dc_size = _code_array(DC_BITS, DC_VALS)
    ac_code, ac_size = _code_array(AC_BITS, AC_VALS)
    # pieces: (block, order key, value, length), sorted by block then key
    diff = np.diff(zz[:, 0], prepend=0)
    s = _category(diff)
    extra = np.where(diff < 0, diff + (1 << s) - 1, diff) & ((1 << s) - 1)
    keys = [np.arange(n) * 256]
    vals = [(dc_code[s] << s) | extra]
    lens = [dc_size[s] + s]

    blk, k = np.nonzero(zz[:, 1:])
    k = k + 1
    v = zz[blk, k]
    first = np.ones(len(blk), bool)
    first[1:] = blk[1:] != blk[:-1]
    prev = np.where(first, 0, np.concatenate([[0], k[:-1]]))
    run = k - prev - 1
    s = _category(v)
    sym = ((run & 15) << 4) | s
    extra = np.where(v < 0, v + (1 << s) - 1, v) & ((1 << s) - 1)
    keys.append(blk * 256 + 2 * k)
    vals.append((ac_code[sym] << s) | extra)
    lens.append(ac_size[sym] + s)
    zrl = run >> 4
    if zrl.any():
        where = np.repeat(np.arange(len(blk)), zrl)
        keys.append(blk[where] * 256 + 2 * k[where] - 1)
        vals.append(np.full(len(where), ac_code[0xF0]))
        lens.append(np.full(len(where), ac_size[0xF0]))
    last = np.zeros(n, np.int64)
    if len(blk):
        last[blk] = k  # the last nonzero index of each block (ascending k)
    eob = np.nonzero(last < 63)[0]
    keys.append(eob * 256 + 255)
    vals.append(np.full(len(eob), ac_code[0x00]))
    lens.append(np.full(len(eob), ac_size[0x00]))
    keys, vals, lens = (np.concatenate(a) for a in (keys, vals, lens))
    order = np.argsort(keys, kind="stable")
    scan = _pack_bits(vals[order], lens[order])

    def segment(marker: int, payload: bytes) -> bytes:
        return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload

    def dht(tc_th: int, bits, vals_) -> bytes:
        return segment(0xC4, bytes([tc_th]) + bytes(bits) + bytes(vals_))

    return b"".join([
        b"\xff\xd8",
        segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"),
        segment(0xDB, b"\x00" + bytes(q[ZIGZAG].astype(np.uint8).tolist())),
        segment(0xC0, b"\x08" + h.to_bytes(2, "big") + w.to_bytes(2, "big") + b"\x01\x01\x11\x00"),
        dht(0x00, DC_BITS, DC_VALS),
        dht(0x10, AC_BITS, AC_VALS),
        segment(0xDA, b"\x01\x01\x00\x00\x3f\x00"),
        scan,
        b"\xff\xd9",
    ])
