"""JPEG decoding, pixel for pixel as Pillow decodes it.

Pillow decodes JPEG through libjpeg-turbo with its defaults: the "islow"
integer inverse DCT (jidctint.c), "fancy" (triangle-filter) chroma
upsampling (jdsample.c) and the fixed-point YCbCr -> RGB tables
(jdcolor.c). This module repeats each of those integer stages in numpy,
after a serial Huffman walk in Python, so its pixels are Pillow's:

  - Huffman sequential DCT (SOF0 baseline and SOF1 extended, 8 bits a
    sample), interleaved and single-component scans, restart intervals
    (DRI / RSTn, the DC predictions reset at each), 0xFF00 stuffing;
  - Huffman progressive DCT (SOF2, ITU T.81 Annex G): DC first and
    refinement scans (interleaved or not), AC first scans with end-of-band
    runs across blocks, AC refinement with its correction bits, restart
    intervals resetting the runs and predictions; every scan is decoded
    into the coefficients, and the pixel stages run once after the last,
    as libjpeg-turbo's output of a complete file is a function of the
    final coefficients only;
  - one component (grey), three (YCbCr, or RGB where the file says so
    as libjpeg's jdapimin.c decides it: a JFIF marker means YCbCr, an
    Adobe marker with transform 0 means RGB, else component ids 'R', 'G',
    'B' mean RGB) or four (CMYK, or YCCK under Adobe transform 2, which
    libjpeg turns into CMYK; Pillow reads the samples inverted and
    converts them by its own cmyk2rgb), any integral sampling factors.

What is outside that raises ValueError naming it: lossless, hierarchical
and arithmetic-coded files, 12-bit samples, a progressive file whose
first nine AC coefficients are not all refined to Al = 0 (libjpeg-turbo
smooths its blocks, jdcoefct.c's decompress_smooth_data, which is not
ported) and a corrupt or truncated stream. So does a block whose
inverse DCT leaves the range [-512, 511] before the level shift: there
libjpeg-turbo's C code (a lookup in a wrapping table) and its SIMD code
(saturating packs) give different pixels, and the module does not guess
which one the reader's Pillow runs (`decode_jpeg(..., saturate=True)`
gives the SIMD code's pixels there, for bytes the caller wrote itself).
`jpeg_mode` gives Pillow's mode for the file from its header alone ("L",
"RGB", "CMYK").
"""
from __future__ import annotations

import struct
from typing import Dict, List, NamedTuple, Tuple

import numpy as np

# zig-zag position k -> natural (row-major) index of an 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_SOF_NAMES = {0xC3: "lossless", 0xC5:
              "differential sequential", 0xC6: "differential progressive",
              0xC7: "differential lossless", 0xC9:
              "arithmetic-coded sequential", 0xCA:
              "arithmetic-coded progressive", 0xCB:
              "arithmetic-coded lossless", 0xCD:
              "arithmetic-coded differential sequential", 0xCE:
              "arithmetic-coded differential progressive", 0xCF:
              "arithmetic-coded differential lossless"}


class Component(NamedTuple):
    cid: int
    h: int          # sampling factors
    v: int
    tq: int         # quantization table


class Frame(NamedTuple):
    width: int
    height: int
    comps: Tuple[Component, ...]
    rgb: bool       # three components stored as RGB, not YCbCr
    ycck: bool      # four components stored as YCCK, not CMYK
    progressive: bool

    @property
    def grid(self) -> Tuple[int, int, int, int]:
        """(largest h, largest v, MCU columns, MCU rows)."""
        hmax = max(c.h for c in self.comps)
        vmax = max(c.v for c in self.comps)
        return (hmax, vmax, -(-self.width // (8 * hmax)),
                -(-self.height // (8 * vmax)))


def _segments(blob: bytes, path: str):
    """(marker, payload, offset after the payload) of each marker segment
    to EOI. After an SOS the caller sends the offset of the marker that
    ends the scan's entropy-coded data, and the walk goes on from there."""
    if blob[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: not a JPEG file (no SOI marker)")
    at = 2
    while True:
        while at < len(blob) and blob[at] != 0xFF:
            at += 1                       # garbage between segments
        while at < len(blob) and blob[at] == 0xFF:
            at += 1                       # fill bytes
        if at >= len(blob):
            raise ValueError(f"{path}: truncated JPEG (no EOI marker)")
        marker = blob[at]
        at += 1
        if marker == 0xD9:
            yield marker, b"", at
            return
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue                      # stray RSTn / TEM: no payload
        if at + 2 > len(blob):
            raise ValueError(f"{path}: truncated JPEG marker segment")
        n = struct.unpack(">H", blob[at:at + 2])[0]
        if n < 2 or at + n > len(blob):
            raise ValueError(f"{path}: truncated JPEG marker segment "
                             f"0xFF{marker:02X}")
        sent = yield marker, blob[at + 2:at + n], at + n
        at = at + n if sent is None else sent


def _dims(seg: bytes, path: str) -> Tuple[int, int, int, int]:
    """An SOFn payload -> (bits a sample, width, height, components)."""
    if len(seg) < 6:
        raise ValueError(f"{path}: truncated JPEG frame header")
    bits, height, width, n = struct.unpack(">BHHB", seg[:6])
    return bits, width, height, n


def _frame(marker: int, seg: bytes, path: str) -> Tuple[int, int, Tuple]:
    """SOFn -> (width, height, components); refuses what is not decoded."""
    if marker in _SOF_NAMES:
        raise ValueError(f"{path}: {_SOF_NAMES[marker]} JPEG is not "
                         "decoded; the port reads Huffman-coded sequential "
                         "and progressive JPEG only")
    bits, width, height, n = _dims(seg, path)
    if bits != 8:
        raise ValueError(f"{path}: {bits}-bit JPEG is not decoded; the port "
                         "reads 8-bit samples only")
    if height == 0:
        raise ValueError(f"{path}: JPEG height given by a DNL marker is not "
                         "decoded")
    if width == 0 or n == 0 or len(seg) < 6 + 3 * n:
        raise ValueError(f"{path}: corrupt JPEG frame header")
    comps = tuple(Component(seg[6 + 3 * i], seg[7 + 3 * i] >> 4,
                            seg[7 + 3 * i] & 15, seg[8 + 3 * i])
                  for i in range(n))
    if any(not (1 <= c.h <= 4 and 1 <= c.v <= 4) for c in comps):
        raise ValueError(f"{path}: corrupt JPEG sampling factors")
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    if any(hmax % c.h or vmax % c.v for c in comps):
        raise ValueError(f"{path}: JPEG with non-integral sampling ratios "
                         "is not decoded")
    return width, height, comps


def _header_dims(path: str) -> Tuple[int, int, int]:
    """(width, height, components) from the frame header, whatever the
    coding process (the size and mode do not depend on it)."""
    with open(path, "rb") as f:
        blob = f.read()
    for marker, seg, _ in _segments(blob, path):
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            return _dims(seg, path)[1:]
        if marker in (0xDA, 0xD9):
            break
    raise ValueError(f"{path}: JPEG without a frame header")


def jpeg_size(path: str) -> Tuple[int, int]:
    """(height, width) from the frame header."""
    width, height, _ = _header_dims(path)
    return height, width


def jpeg_mode(path: str) -> str:
    """Pillow's mode for the file: its number of components decides it."""
    n = _header_dims(path)[2]
    if n not in (1, 3, 4):
        raise ValueError(f"{path}: JPEG with {n} components is not read")
    return {1: "L", 3: "RGB", 4: "CMYK"}[n]


# ------------------------------------------------------------- Huffman


def _huffman_table(seg: bytes, at: int, path: str) -> Tuple[list, int]:
    """One DHT table at `at` -> (a list of 65536 entries, the offset after
    it): entry[next 16 bits] = code length << 8 | symbol, 0 where no code
    starts with those bits."""
    counts = seg[at + 1:at + 17]
    n = sum(counts)
    syms = seg[at + 17:at + 17 + n]
    if len(counts) != 16 or len(syms) != n:
        raise ValueError(f"{path}: truncated JPEG Huffman table")
    lut = np.zeros(1 << 16, np.int64)
    code = k = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= 1 << length:
                raise ValueError(f"{path}: corrupt JPEG Huffman table")
            lo = code << (16 - length)
            lut[lo:lo + (1 << (16 - length))] = length << 8 | syms[k]
            code += 1
            k += 1
        code <<= 1
    return lut.tolist(), at + 17 + n


# bytes one block can read at most: a DC code and its bits (16 + 11) and
# 63 AC codes and their bits (16 + 15 each), rounded up
_BLOCK_BYTES = 256


def _windows(data: bytes) -> list:
    """Entry i: bytes i .. i + 7 of `data` (zeros past its end) as one
    big-endian 64-bit integer, so any 16 + 16 bits from bit 8 i on are
    one shift and mask away. Zero entries run a whole block past the end,
    so a block cut short reads zeros and fails the check after it."""
    n = len(data) + 1 + _BLOCK_BYTES
    b = np.zeros(n + 7, np.uint64)
    b[:len(data)] = np.frombuffer(data, np.uint8)
    w = np.zeros(n, np.uint64)
    for j in range(8):
        w |= b[j:j + n] << np.uint64(56 - 8 * j)
    return w.tolist()


def _decode_interval(data: bytes, blocks: list, tables: list, coefs: list,
                     preds: list, path: str) -> None:
    """Decode one restart interval's blocks into `coefs` (zig-zag order).

    blocks: (component slot, offset into its coefficient list) in stream
    order; tables: per slot (DC lookup, AC lookup)."""
    W = _windows(data)
    end = 8 * len(data)
    p = 0
    for ci, base in blocks:
        dc, ac = tables[ci]
        out = coefs[ci]
        e = dc[(W[p >> 3] >> (48 - (p & 7))) & 0xFFFF]
        if not e:
            raise ValueError(f"{path}: corrupt JPEG data (bad Huffman code)")
        p += e >> 8
        s = e & 255
        if s:
            if s > 11:
                raise ValueError(f"{path}: corrupt JPEG data (DC size {s})")
            v = (W[p >> 3] >> (64 - (p & 7) - s)) & ((1 << s) - 1)
            p += s
            if v < 1 << (s - 1):
                v -= (1 << s) - 1
            preds[ci] += v
        out[base] = preds[ci]
        k = 1
        while k < 64:
            e = ac[(W[p >> 3] >> (48 - (p & 7))) & 0xFFFF]
            if not e:
                raise ValueError(f"{path}: corrupt JPEG data (bad Huffman "
                                 "code)")
            p += e >> 8
            rs = e & 255
            s = rs & 15
            if s:
                k += rs >> 4
                if k > 63:
                    raise ValueError(f"{path}: corrupt JPEG data (run past "
                                     "the block's end)")
                v = (W[p >> 3] >> (64 - (p & 7) - s)) & ((1 << s) - 1)
                p += s
                if v < 1 << (s - 1):
                    v -= (1 << s) - 1
                out[base + k] = v
                k += 1
            elif rs == 0xF0:
                k += 16
            else:
                break
        if p > end:
            raise ValueError(f"{path}: truncated JPEG data")


def _extend(v: int, s: int) -> int:
    """HUFF_EXTEND: s bits read as a signed value."""
    return v - (1 << s) + 1 if v < 1 << (s - 1) else v


def _dc_first(data: bytes, blocks: list, tables: list, coefs: list,
              preds: list, al: int, path: str) -> None:
    """A progressive DC first scan's interval (jdphuff.c decode_mcu_DC_first):
    the DC differences of `blocks` (as _decode_interval's), shifted by
    Al."""
    W = _windows(data)
    end = 8 * len(data)
    p = 0
    for ci, base in blocks:
        e = tables[ci][(W[p >> 3] >> (48 - (p & 7))) & 0xFFFF]
        if not e:
            raise ValueError(f"{path}: corrupt JPEG data (bad Huffman code)")
        p += e >> 8
        s = e & 255
        if s:
            if s > 11:
                raise ValueError(f"{path}: corrupt JPEG data (DC size {s})")
            preds[ci] += _extend((W[p >> 3] >> (64 - (p & 7) - s))
                                 & ((1 << s) - 1), s)
            p += s
        coefs[ci][base] = preds[ci] << al
        if p > end:
            raise ValueError(f"{path}: truncated JPEG data")


def _dc_refine(data: bytes, blocks: list, coefs: list, al: int,
               path: str) -> None:
    """A DC refinement scan's interval: one bit a block, bit Al of its
    DC."""
    W = _windows(data)
    p = 0
    for ci, base in blocks:
        if (W[p >> 3] >> (63 - (p & 7))) & 1:
            coefs[ci][base] |= 1 << al
        p += 1
    if p > 8 * len(data):
        raise ValueError(f"{path}: truncated JPEG data")


def _ac_first(data: bytes, bases: list, ac: list, out: list, ss: int,
              se: int, al: int, path: str) -> None:
    """An AC first scan's interval (decode_mcu_AC_first): one component,
    bands ss..se of the blocks at `bases`, end-of-band runs (EOBRUN)
    across blocks."""
    W = _windows(data)
    end = 8 * len(data)
    p = eobrun = 0
    for base in bases:
        if eobrun:
            eobrun -= 1
            continue
        k = ss
        while k <= se:
            e = ac[(W[p >> 3] >> (48 - (p & 7))) & 0xFFFF]
            if not e:
                raise ValueError(f"{path}: corrupt JPEG data (bad Huffman "
                                 "code)")
            p += e >> 8
            r, s = (e >> 4) & 15, e & 15
            if s:
                k += r
                if k > se:
                    raise ValueError(f"{path}: corrupt JPEG data (run past "
                                     "the band's end)")
                out[base + k] = _extend((W[p >> 3] >> (64 - (p & 7) - s))
                                        & ((1 << s) - 1), s) << al
                p += s
                k += 1
            elif r == 15:
                k += 16
            else:
                eobrun = 1 << r
                if r:
                    eobrun += (W[p >> 3] >> (64 - (p & 7) - r)) & (
                        (1 << r) - 1)
                    p += r
                eobrun -= 1
                break
        if p > end:
            raise ValueError(f"{path}: truncated JPEG data")


def _ac_refine(data: bytes, bases: list, ac: list, out: list, ss: int,
               se: int, al: int, path: str) -> None:
    """An AC refinement scan's interval (decode_mcu_AC_refine): a
    correction bit for every coefficient already nonzero that a run
    passes, and the new coefficients +-(1 << Al)."""
    W = _windows(data)
    end = 8 * len(data)
    p1, m1 = 1 << al, -1 << al
    p = eobrun = 0
    for base in bases:
        k = ss
        if not eobrun:
            while k <= se:
                e = ac[(W[p >> 3] >> (48 - (p & 7))) & 0xFFFF]
                if not e:
                    raise ValueError(f"{path}: corrupt JPEG data (bad "
                                     "Huffman code)")
                p += e >> 8
                r, s = (e >> 4) & 15, e & 15
                if s:                 # libjpeg takes any size as 1
                    s = p1 if (W[p >> 3] >> (63 - (p & 7))) & 1 else m1
                    p += 1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += (W[p >> 3] >> (64 - (p & 7) - r)) & (
                            (1 << r) - 1)
                        p += r
                    break
                while k <= se:
                    c = out[base + k]
                    if c:
                        if (W[p >> 3] >> (63 - (p & 7))) & 1 and not c & p1:
                            out[base + k] = c + p1 if c >= 0 else c + m1
                        p += 1
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if s:
                    if k > se:
                        raise ValueError(f"{path}: corrupt JPEG data (run "
                                         "past the band's end)")
                    out[base + k] = s
                k += 1
        if eobrun:
            while k <= se:
                c = out[base + k]
                if c:
                    if (W[p >> 3] >> (63 - (p & 7))) & 1 and not c & p1:
                        out[base + k] = c + p1 if c >= 0 else c + m1
                    p += 1
                k += 1
            eobrun -= 1
        if p > end:
            raise ValueError(f"{path}: truncated JPEG data")


def _scan_data(blob: bytes, at: int, path: str) -> Tuple[List[bytes], int]:
    """The entropy-coded data from `at` to the next marker that is not an
    RSTn: the restart intervals, unstuffed, and the offset of that
    marker."""
    parts, start = [], at
    while True:
        at = blob.find(b"\xff", at)
        if at < 0 or at + 1 >= len(blob):
            raise ValueError(f"{path}: truncated JPEG data (no marker after "
                             "the scan)")
        nxt = blob[at + 1]
        if nxt == 0x00 or nxt == 0xFF:
            at += 1 if nxt == 0xFF else 2
            continue
        if 0xD0 <= nxt <= 0xD7:
            parts.append((blob[start:at], nxt - 0xD0))
            at += 2
            start = at
            continue
        parts.append((blob[start:at], None))
        break
    intervals = []
    for i, (data, rst) in enumerate(parts):
        if rst is not None and rst != i % 8:
            raise ValueError(f"{path}: corrupt JPEG data (RST{rst} where "
                             f"RST{i % 8} belongs)")
        intervals.append(data.replace(b"\xff\x00", b"\xff"))
    return intervals, at


# ---------------------------------------------------------- pixel stages

CONST_BITS, PASS1_BITS = 13, 2
FIX = {"0_298631336": 2446, "0_390180644": 3196, "0_541196100": 4433,
       "0_765366865": 6270, "0_899976223": 7373, "1_175875602": 9633,
       "1_501321110": 12299, "1_847759065": 15137, "1_961570560": 16069,
       "2_053119869": 16819, "2_562915447": 20995, "3_072711026": 25172}


def _idct_1d(x: np.ndarray, shift: int) -> np.ndarray:
    """jidctint.c's 1-D pass over the last axis (int64), descaled by
    `shift` with rounding. Its shortcut for all-zero AC terms gives the
    same numbers, so it is not taken."""
    f = FIX
    z2, z3 = x[..., 2], x[..., 6]
    z1 = (z2 + z3) * f["0_541196100"]
    tmp2 = z1 - z3 * f["1_847759065"]
    tmp3 = z1 + z2 * f["0_765366865"]
    tmp0 = (x[..., 0] + x[..., 4]) << CONST_BITS
    tmp1 = (x[..., 0] - x[..., 4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[..., 7], x[..., 5], x[..., 3], x[..., 1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["1_175875602"]
    t0 = t0 * f["0_298631336"]
    t1 = t1 * f["2_053119869"]
    t2 = t2 * f["3_072711026"]
    t3 = t3 * f["1_501321110"]
    z1 = z1 * -f["0_899976223"]
    z2 = z2 * -f["2_562915447"]
    z3 = z3 * -f["1_961570560"] + z5
    z4 = z4 * -f["0_390180644"] + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    out = np.stack([tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                    tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3], -1)
    return (out + (1 << (shift - 1))) >> shift


# blocks decode_jpeg(..., saturate=True) found outside the range where
# libjpeg-turbo's C and SIMD inverse DCTs agree, since the process began
COUNTS = {"saturated_blocks": 0}


def idct_islow(coefs: np.ndarray, path: str = "",
               saturate: bool = False) -> np.ndarray:
    """(N, 8, 8) dequantized coefficients (natural order) -> (N, 8, 8)
    uint8 samples: columns, then rows, then the level shift.

    A block outside the range where libjpeg-turbo's C and SIMD code agree
    raises, unless `saturate`: then it gets what the SIMD code gives (the
    first pass's results saturated to 16 bits, the samples to 0..255,
    which is Pillow's on an x86-64 host) and is counted in
    COUNTS["saturated_blocks"]."""
    ws = _idct_1d(np.swapaxes(coefs.astype(np.int64), 1, 2),
                  CONST_BITS - PASS1_BITS)            # per column
    wide = (np.abs(ws) > 32767).any((1, 2))
    if saturate:
        ws = np.clip(ws, -32768, 32767)
    x = _idct_1d(np.swapaxes(ws, 1, 2), CONST_BITS + PASS1_BITS + 3)
    wide |= (x < -512).any((1, 2)) | (x > 511).any((1, 2))
    if wide.any():
        if not saturate:
            raise ValueError(f"{path}: JPEG coefficients outside the range "
                             "where libjpeg-turbo's C and SIMD inverse DCTs "
                             "agree; not decoded")
        COUNTS["saturated_blocks"] += int(wide.sum())
    return np.clip(x + 128, 0, 255).astype(np.uint8)


def _upsample(c: np.ndarray, fh: int, fv: int) -> np.ndarray:
    """jdsample.c: a component's (h, w) samples (int32) upsampled by fh x
    fv. 2x1 and 2x2 (both when w > 2) and 1x2 by the triangle filter: 3/4
    of the nearer sample and 1/4 of the further, the rounding bias
    alternating, the edge samples repeated (which gives jdsample.c's
    special cases of the first and last column); any other integral
    factor by repetition."""
    if (fh, fv) == (1, 1):
        return c
    if fh == 1 and fv == 2 or fh == 2 and fv in (1, 2) and c.shape[1] > 2:
        if fv == 2:
            up = np.concatenate([c[:1], c[:-1]])
            down = np.concatenate([c[1:], c[-1:]])
            rows = np.empty((2 * c.shape[0], c.shape[1]), np.int32)
            rows[0::2] = 3 * c + up
            rows[1::2] = 3 * c + down
            if fh == 1:
                rows[0::2] += 1
                rows[1::2] += 2
                return rows >> 2
            bias, shift = (8, 7), 4
        else:
            rows, bias, shift = c, (1, 2), 2
        left = np.concatenate([rows[:, :1], rows[:, :-1]], 1)
        right = np.concatenate([rows[:, 1:], rows[:, -1:]], 1)
        out = np.empty((rows.shape[0], 2 * rows.shape[1]), np.int32)
        out[:, 0::2] = (3 * rows + left + bias[0]) >> shift
        out[:, 1::2] = (3 * rows + right + bias[1]) >> shift
        return out
    return np.repeat(np.repeat(c, fv, 0), fh, 1)


def _ycc_tables() -> Tuple[np.ndarray, ...]:
    """jdcolor.c's build_ycc_rgb_table (SCALEBITS 16)."""
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15

    def fix(v):
        return int(v * 65536 + 0.5)
    cr_r = (fix(1.40200) * x + half) >> 16
    cb_b = (fix(1.77200) * x + half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + half
    return cr_r, cb_b, cr_g, cb_g


_YCC = _ycc_tables()


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert: (H, W) uint8-valued planes -> (H, W, 3)
    uint8; Cb's and Cr's green terms are summed before the shift."""
    cr_r, cb_b, cr_g, cb_g = _YCC
    y = y.astype(np.int64)
    rgb = np.stack([y + cr_r[cr], y + ((cb_g[cb] + cr_g[cr]) >> 16),
                    y + cb_b[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


# -------------------------------------------------------------- decoder


def _decode(blob: bytes, path: str) -> Tuple[Frame, List[np.ndarray]]:
    """Parse and entropy-decode the file: the frame and, per component, its
    MCU-padded 8x8 blocks as (by, bx, 64) int64 coefficients in zig-zag
    order, dequantized."""
    qt: Dict[int, np.ndarray] = {}
    dht: Dict[Tuple[int, int], list] = {}
    restart = 0
    frame = None
    jfif, adobe = False, None
    coefs: List[list] = []
    qt_of: List[np.ndarray] = []
    bits: List[List[int]] = []     # libjpeg's coef_bits: -1 = never sent
    segs = _segments(blob, path)
    item = next(segs)
    while True:
        marker, seg, after = item
        if marker == 0xD9:
            break
        if marker == 0xE0 and seg[:5] == b"JFIF\0":
            jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        elif marker == 0xDB:
            at = 0
            while at < len(seg):
                pq, tq = seg[at] >> 4, seg[at] & 15
                n = 128 if pq else 64
                if pq > 1 or tq > 3 or at + 1 + n > len(seg):
                    raise ValueError(f"{path}: corrupt JPEG quantization "
                                     "table")
                q = np.frombuffer(seg[at + 1:at + 1 + n],
                                  ">u2" if pq else np.uint8)
                qt[tq] = q.astype(np.int64)
                at += 1 + n
        elif marker == 0xC4:
            at = 0
            while at < len(seg):
                tc, th = seg[at] >> 4, seg[at] & 15
                if tc > 1 or th > 3:
                    raise ValueError(f"{path}: corrupt JPEG Huffman table")
                dht[tc, th], at = _huffman_table(seg, at, path)
        elif marker == 0xDD:
            if len(seg) < 2:
                raise ValueError(f"{path}: corrupt JPEG DRI segment")
            restart = struct.unpack(">H", seg[:2])[0]
        elif marker == 0xCC:
            raise ValueError(f"{path}: arithmetic-coded JPEG is not decoded;"
                             " the port reads Huffman-coded sequential and "
                             "progressive JPEG only")
        elif 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8):
            if frame is not None:
                raise ValueError(f"{path}: JPEG with two frame headers")
            width, height, comps = _frame(marker, seg, path)
            if len(comps) not in (1, 3, 4):
                raise ValueError(f"{path}: JPEG with {len(comps)} components"
                                 " (not grey, colour or CMYK) is not "
                                 "decoded")
            # jdapimin.c's colour space: 3 components are YCbCr unless RGB
            # is signalled; 4 are YCCK under Adobe transform 2 (or any
            # transform but 0), else CMYK
            rgb = len(comps) == 3 and not jfif and (
                adobe == 0 if adobe is not None
                else tuple(c.cid for c in comps) == (82, 71, 66))
            ycck = len(comps) == 4 and adobe not in (None, 0)
            frame = Frame(width, height, comps, rgb, ycck, marker == 0xC2)
            _, _, mcux, mcuy = frame.grid
            coefs = [[0] * (mcuy * c.v * mcux * c.h * 64) for c in comps]
            qt_of = [None] * len(comps)
            bits = [[-1] * 64 for _ in comps]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError(f"{path}: JPEG scan before its frame header")
            item = segs.send(_scan(blob, seg, after, frame, qt, dht, restart,
                                   coefs, qt_of, bits, path))
            continue
        item = next(segs)
    if frame is None or any(q is None for q in qt_of):
        raise ValueError(f"{path}: JPEG ends before every component was "
                         "coded")
    if frame.progressive and all(b[0] >= 0 for b in bits) and any(
            b[k] for b in bits for k in range(1, 10)):
        # jdcoefct.c's smoothing_ok: libjpeg-turbo smooths the blocks of a
        # file whose first nine AC coefficients are not all sent to Al = 0
        raise ValueError(f"{path}: incompletely refined progressive JPEG is "
                         "not decoded (libjpeg's block smoothing is not "
                         "ported)")
    _, _, mcux, mcuy = frame.grid
    blocks = [np.asarray(cf, np.int64).reshape(mcuy * c.v, mcux * c.h, 64)
              * qt_of[i] for i, (c, cf) in enumerate(zip(frame.comps,
                                                          coefs))]
    return frame, blocks


def _scan(blob, seg, after, frame, qt, dht, restart, coefs, qt_of, bits,
          path) -> int:
    """Decode one scan into `coefs`; the offset of the marker after it."""
    ns = seg[0] if seg else 0
    if ns < 1 or len(seg) < 4 + 2 * ns:
        raise ValueError(f"{path}: corrupt JPEG scan header")
    ss, se, ahl = seg[1 + 2 * ns:4 + 2 * ns]
    ah, al = ahl >> 4, ahl & 15
    if not frame.progressive:
        if (ss, se, ahl) != (0, 63, 0):
            raise ValueError(f"{path}: sequential JPEG scan with spectral "
                             "selection or successive approximation")
    elif (se != 0 if ss == 0 else se < ss or se > 63 or ns != 1) or (
            ah and al != ah - 1) or al > 13:
        raise ValueError(f"{path}: corrupt JPEG progression (scan "
                         f"Ss={ss} Se={se} Ah={ah} Al={al})")
    ids = [c.cid for c in frame.comps]
    slots, tables = [], []
    for i in range(ns):
        cid, t = seg[1 + 2 * i], seg[2 + 2 * i]
        if cid not in ids:
            raise ValueError(f"{path}: JPEG scan names component {cid}")
        ci = ids.index(cid)
        if not frame.progressive and bits[ci][0] >= 0:
            raise ValueError(f"{path}: JPEG component {cid} coded twice in "
                             "a sequential file")
        if not frame.progressive:
            need = [(0, t >> 4), (1, t & 15)]
        elif ss:
            need = [(1, t & 15)]
        else:                          # a DC refinement codes no symbols
            need = [] if ah else [(0, t >> 4)]
        if any(k not in dht for k in need):
            raise ValueError(f"{path}: JPEG scan uses an undefined Huffman "
                             "table")
        slots.append(ci)
        tables.append([dht[k] for k in need])
    # jdinput.c latches a component's quantization table when its first
    # scan starts (zig-zag order, as the coefficients)
    for ci in slots:
        tq = frame.comps[ci].tq
        if qt_of[ci] is None:
            if tq not in qt:
                raise ValueError(f"{path}: JPEG component uses an undefined "
                                 "quantization table")
            qt_of[ci] = qt[tq]
        bits[ci][ss:se + 1] = [al] * (se + 1 - ss)
    comps = frame.comps
    hmax, vmax, mcux, mcuy = frame.grid
    if ns == 1:            # one block an MCU, the component's own extent
        c = comps[slots[0]]
        bw = -(-(-(-frame.width * c.h // hmax)) // 8)
        bh = -(-(-(-frame.height * c.v // vmax)) // 8)
        stride = mcux * c.h
        by, bx = np.divmod(np.arange(bw * bh), bw)
        order = [(0, int(o)) for o in (by * stride + bx) * 64]
        per_mcu = 1
        n_mcu = bw * bh
    else:
        n_mcu = mcux * mcuy
        my, mx = np.divmod(np.arange(n_mcu), mcux)
        cols = []
        for s, ci in enumerate(slots):
            c = comps[ci]
            for v in range(c.v):
                for h in range(c.h):
                    off = ((my * c.v + v) * (mcux * c.h) + mx * c.h + h) * 64
                    cols.append([(s, int(o)) for o in off])
        order = [b for mcu in zip(*cols) for b in mcu]
        per_mcu = len(cols)
    intervals, at = _scan_data(blob, after, path)
    per = (restart or n_mcu) * per_mcu
    want = -(-n_mcu // (restart or n_mcu))
    if len(intervals) != want:
        raise ValueError(f"{path}: corrupt JPEG data ({len(intervals)} "
                         f"restart intervals where {want} belong)")
    out = [coefs[ci] for ci in slots]
    for i, data in enumerate(intervals):
        part = order[i * per:(i + 1) * per]
        if not frame.progressive:
            _decode_interval(data, part, tables, out, [0] * ns, path)
        elif ss == 0 and not ah:
            _dc_first(data, part, [t[0] for t in tables], out, [0] * ns, al,
                      path)
        elif ss == 0:
            _dc_refine(data, part, out, al, path)
        else:
            (_ac_refine if ah else _ac_first)(
                data, [b for _, b in part], tables[0][0], out[0],
                ss, se, al, path)
    return at


def read_jpeg(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a JPEG file, as Pillow's
    Image.open(path).convert("RGB") gives it (grey replicated, CMYK
    through Pillow's cmyk2rgb)."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path)


def _muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pillow's MULDIV255: a * b / 255, rounded its way."""
    t = a * b + 128
    return ((t >> 8) + t) >> 8


def cmyk_to_rgb(planes: List[np.ndarray], ycck: bool) -> np.ndarray:
    """Four decoded planes -> (H, W, 3) uint8 as Pillow gives them: libjpeg
    turns YCCK into CMYK (jdcolor.c's ycck_cmyk_convert: YCbCr -> RGB by the
    same tables, then inverted; K as decoded), Pillow reads the samples
    inverted ("CMYK;I", Adobe's polarity) and convert("RGB") applies its
    cmyk2rgb."""
    if ycck:
        cmy = 255 - ycc_to_rgb(*planes[:3]).astype(np.int64)
    else:
        cmy = np.stack(planes[:3], -1).astype(np.int64)
    cmy = 255 - cmy
    nk = planes[3].astype(np.int64)[..., None]    # 255 - (255 - K)
    return np.clip(nk - _muldiv255(cmy, nk), 0, 255).astype(np.uint8)


def decode_jpeg(blob: bytes, path: str = "<JPEG bytes>",
                saturate: bool = False) -> np.ndarray:
    """read_jpeg of a file's bytes; `path` names it in errors. With
    `saturate`, a block outside the inverse DCT's agreed range gives
    Pillow's pixels (see idct_islow) instead of raising."""
    frame, blocks = _decode(blob, path)
    comps = frame.comps
    hmax, vmax, _, _ = frame.grid
    planes = []
    for c, cf in zip(comps, blocks):
        by, bx, _ = cf.shape
        nat = np.empty_like(cf)
        nat[..., ZIGZAG] = cf
        px = idct_islow(nat.reshape(-1, 8, 8), path, saturate).reshape(
            by, bx, 8, 8)
        px = px.transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)
        dh = -(-frame.height * c.v // vmax)
        dw = -(-frame.width * c.h // hmax)
        up = _upsample(px[:dh, :dw].astype(np.int32), hmax // c.h,
                       vmax // c.v)
        planes.append(up[:frame.height, :frame.width])
    if len(planes) == 1:
        return np.repeat(planes[0].astype(np.uint8)[..., None], 3, axis=2)
    if len(planes) == 4:
        return cmyk_to_rgb(planes, frame.ycck)
    if frame.rgb:
        return np.stack(planes, -1).astype(np.uint8)
    return ycc_to_rgb(*planes)
