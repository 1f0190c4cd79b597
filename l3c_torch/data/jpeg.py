"""JPEG decoding, pixel for pixel as Pillow decodes it.

Pillow decodes JPEG through libjpeg-turbo with its defaults: the "islow"
integer inverse DCT in the SIMD code libjpeg-turbo picks on every x86-64
CPU (jidctint-sse2 / -avx2), "fancy" (triangle-filter) chroma upsampling
(jdsample.c) and the fixed-point YCbCr -> RGB tables (jdcolor.c). This
module repeats each of those integer stages in numpy, after a serial
entropy walk in Python, so its pixels are Pillow's:

  - Huffman sequential DCT (SOF0 baseline and SOF1 extended, 8 bits a
    sample), interleaved and single-component scans, restart intervals
    (DRI / RSTn, the DC predictions reset at each), 0xFF00 stuffing,
    Annex K's tables where a sequential file defines none;
  - Huffman progressive DCT (SOF2, ITU T.81 Annex G): DC first and
    refinement scans (interleaved or not), AC first scans with end-of-band
    runs across blocks, AC refinement with its correction bits, restart
    intervals resetting the runs and predictions; every scan is decoded
    into the coefficients, and the pixel stages run once after the last;
  - arithmetic-coded sequential and progressive DCT (SOF9, SOF10; Annexes
    D, F and G): jdarith.c's QM decoder, statistics and conditioning
    (DAC); Pillow hands libjpeg the file 64 KiB at a time and jdarith.c
    cannot wait for more, so a scan that reads past what was handed over
    is refused, as Pillow refuses it;
  - lossless (SOF3, Huffman; Annex H): the seven predictors, the point
    transform, restart intervals of whole MCU rows; RGB unless a JFIF or
    Adobe marker says YCbCr, which libjpeg-turbo refuses to convert;
  - one component (grey), three (YCbCr, or RGB where the file says so
    as libjpeg's jdapimin.c decides it: a JFIF marker means YCbCr, an
    Adobe marker with transform 0 means RGB, else component ids 'R', 'G',
    'B' mean RGB) or four (CMYK, or YCCK under Adobe transform 2, which
    libjpeg turns into CMYK; Pillow reads the samples inverted and
    converts them by its own cmyk2rgb), any integral sampling factors;
  - jdcoefct.c's block smoothing (libjpeg-turbo >= 2.1) of a progressive
    file whose AC 1..9 are not all exact: the missing ones, and with no
    AC sent the DC, estimated from 5 x 5 blocks' DC values;
  - damaged files as libjpeg-turbo recovers them (jdhuff.c, jdphuff.c,
    jdarith.c, jdmarker.c): zero bits past the data of the MCU it ends in
    and the rest of the restart interval left alone, a bad Huffman code
    as symbol 0, a run past the band into coefficient 63, a wrong restart
    marker resynchronised (discarded, scanned past, or left for empty
    intervals), a bad arithmetic code ending the interval, a scan cut
    short before EOI read as far as it goes; the inverse DCT's 16-bit
    wraps and saturations on coefficients out of range.

What Pillow refuses raises ValueError naming the reason: hierarchical
(SOF5-7, SOF13-15) and 12-bit files, a file that ends where libjpeg
would wait for more bytes (Pillow's "image file is truncated"; after the
scan of a single-scan file, libjpeg has its pixels and Pillow reads it),
a marker libjpeg does not know, broken headers, arithmetic-coded
lossless files (SOF11). Under
JSIMD_FORCENONE, libjpeg-turbo's C inverse DCT wraps where its SIMD code
saturates, and Pillow's pixels then differ from these for such blocks.
`jpeg_header` gives Pillow's mode ("L", "RGB", "CMYK") and the size from
the headers alone.
"""
from __future__ import annotations

import array
import re
import struct
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

# zig-zag position k -> natural (row-major) index of an 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_SOF_NAMES = {0xC5: "differential sequential",
              0xC6: "differential progressive",
              0xC7: "differential lossless",
              0xCB: "arithmetic-coded lossless",
              0xCD: "arithmetic-coded differential sequential",
              0xCE: "arithmetic-coded differential progressive",
              0xCF: "arithmetic-coded differential lossless"}


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
    arith: bool = False     # arithmetic-coded (SOF9, SOF10), not Huffman
    lossless: bool = False  # lossless (SOF3): samples, not DCT blocks

    @property
    def grid(self) -> Tuple[int, int, int, int]:
        """(largest h, largest v, MCU columns, MCU rows)."""
        hmax = max(c.h for c in self.comps)
        vmax = max(c.v for c in self.comps)
        return (hmax, vmax, -(-self.width // (8 * hmax)),
                -(-self.height // (8 * vmax)))


class _Truncated(ValueError):
    """The file ends where libjpeg would wait for more bytes: Pillow refuses
    it as truncated, except after the scan of a single-scan file, where its
    pixels are already out."""


def _find_marker(blob: bytes, at: int, path: str) -> Tuple[int, int, int]:
    """jdmarker.c's next_marker from `at`: past any bytes that are not 0xFF,
    fill 0xFFs and stuffed 0xFF00 pairs -> (marker code, offset of the run
    of 0xFF before it, offset after it)."""
    n = len(blob)
    while True:
        ff = blob.find(b"\xff", at)
        if ff < 0:
            raise _Truncated(f"{path}: truncated JPEG (no marker after "
                             f"offset {at})")
        at = ff + 1
        while at < n and blob[at] == 0xFF:
            at += 1
        if at >= n:
            raise _Truncated(f"{path}: truncated JPEG (no marker after "
                             f"offset {ff})")
        if blob[at]:
            return blob[at], ff, at + 1
        at += 1


# markers jdmarker.c's read_markers refuses on sight: SOI again, the
# reserved codes, JPG, DHP, EXP and JPGn
_UNKNOWN_MARKERS = frozenset([0xD8, 0xC8, 0xDE, 0xDF] + list(range(2, 0xC0))
                             + list(range(0xF0, 0xFE)))
# the frame headers get_sof reads (8 bytes, then the components)
_SOF_READ = frozenset([0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA, 0xCB])


def _check_segment(marker: int, blob: bytes, at: int, ids: List[int],
                   path: str) -> None:
    """jdmarker.c's get_sof / get_sos / get_dht / get_dqt / get_dac /
    get_dri on the segment at `at` (its length field), in their order:
    the first fault they raise on comes out as ValueError, a byte they
    would wait for before it as _Truncated."""
    def byte(i):
        if i >= len(blob):
            raise _Truncated(f"{path}: truncated JPEG marker segment "
                             f"0xFF{marker:02X}")
        return blob[i]

    def bad(what):
        return ValueError(f"{path}: corrupt JPEG {what}")
    left = (byte(at) << 8 | byte(at + 1)) - 2
    i = at + 2
    if marker in _SOF_READ:
        h, w, n = byte(i + 1) << 8 | byte(i + 2), byte(i + 3) << 8 | byte(
            i + 4), byte(i + 5)
        if h and w and n and left != 6 + 3 * n:
            raise bad("frame header")
    elif marker == 0xDA:
        n = byte(i)
        if left != 2 * n + 4 or not 1 <= n <= 4:
            raise bad("scan header")
        seen = []
        for j in range(n):
            cid = byte(i + 1 + 2 * j)
            byte(i + 2 + 2 * j)
            if cid not in ids or cid in seen:
                raise bad(f"scan header (component {cid})")
            seen.append(cid)
        byte(i + 3 + 2 * n)
    elif marker == 0xDD:
        if left != 2:
            raise bad("DRI segment")
        byte(i + 1)
    elif marker == 0xC4:
        while left > 16:
            index = byte(i)
            count = sum(byte(i + 1 + j) for j in range(16))
            i, left = i + 17, left - 17
            if count > 256 or count > left:
                raise bad("Huffman table")
            if count:
                byte(i + count - 1)
            i, left = i + count, left - count
            if index & 0xEF > 3:
                raise bad("Huffman table index")
        if left:
            raise bad("Huffman table length")
    elif marker == 0xDB:
        while left > 0:
            n = byte(i)
            if n & 15 > 3:
                raise bad("quantization table")
            k = 128 if n >> 4 else 64
            byte(i + k)
            i, left = i + 1 + k, left - 1 - k
        if left:
            raise bad("quantization table length")
    elif marker == 0xCC:
        while left > 0:
            index, val = byte(i), byte(i + 1)
            i, left = i + 2, left - 2
            if index > 31 or index < 16 and val & 15 > val >> 4:
                raise bad("arithmetic conditioning")
        if left:
            raise bad("arithmetic conditioning length")


def _segments(blob: bytes, path: str, header: bool = False):
    """(marker, payload, offset after the payload) of each marker segment
    to EOI, as jdmarker.c's read_markers walks them: what it refuses
    raises ValueError, what it would wait for more bytes to read raises
    _Truncated. After an SOS the caller sends the offset of the marker
    that ends the scan's entropy-coded data, and the walk goes on from
    there. With `header` (a header read, as Pillow's own parser makes
    it), the frame header of any coding process comes out and no segment
    is checked."""
    if blob[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: not a JPEG file (no SOI marker)")
    at, ids = 2, None
    while True:
        marker, _, at = _find_marker(blob, at, path)
        if marker == 0xD9:
            yield marker, b"", at
            return
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue                      # stray RSTn / TEM: no payload
        if marker in _UNKNOWN_MARKERS:
            raise ValueError(f"{path}: unsupported JPEG marker "
                             f"0xFF{marker:02X}")
        if marker in _SOF_NAMES and marker not in _SOF_READ and not header:
            raise ValueError(f"{path}: {_SOF_NAMES[marker]} JPEG is not "
                             "decoded; the port reads sequential and "
                             "progressive JPEG only")
        if marker in _SOF_READ and ids is not None:
            _check_segment(marker, blob, at, ids, path)
            raise ValueError(f"{path}: JPEG with two frame headers")
        if marker == 0xDA and ids is None:
            raise ValueError(f"{path}: JPEG scan before its frame header")
        if not header:
            _check_segment(marker, blob, at, ids, path)
        if at + 2 > len(blob):
            raise _Truncated(f"{path}: truncated JPEG marker segment")
        n = struct.unpack(">H", blob[at:at + 2])[0]
        if n < 2:                         # skip_variable skips nothing
            at += 2
            continue
        if at + n > len(blob):
            raise _Truncated(f"{path}: truncated JPEG marker segment "
                             f"0xFF{marker:02X}")
        seg = blob[at + 2:at + n]
        if marker in _SOF_READ:
            ids = [seg[6 + 3 * i] for i in range(len(seg[6:]) // 3)]
        sent = yield marker, seg, at + n
        at = at + n if sent is None else sent


def _dims(seg: bytes, path: str) -> Tuple[int, int, int, int]:
    """An SOFn payload -> (bits a sample, width, height, components)."""
    if len(seg) < 6:
        raise ValueError(f"{path}: truncated JPEG frame header")
    bits, height, width, n = struct.unpack(">BHHB", seg[:6])
    return bits, width, height, n


def _frame(marker: int, seg: bytes, path: str, precision: int = 8
           ) -> Tuple[int, int, Tuple]:
    """SOFn -> (width, height, components); refuses what is not decoded."""
    if marker in _SOF_NAMES:
        raise ValueError(f"{path}: {_SOF_NAMES[marker]} JPEG is not "
                         "decoded; the port reads sequential and progressive "
                         "JPEG only")
    bits, width, height, n = _dims(seg, path)
    if bits != precision:
        raise ValueError(f"{path}: {bits}-bit JPEG is not decoded; the port "
                         f"reads {precision}-bit samples here only")
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


def jpeg_header(blob: bytes, path: str) -> Tuple[str, int, int]:
    """(Pillow's mode, height, width) from the frame header, whatever the
    coding process (the size and mode do not depend on it): the number
    of components decides the mode."""
    for marker, seg, _ in _segments(blob, path, header=True):
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            width, height, n = _dims(seg, path)[1:]
            if n not in (1, 3, 4):
                raise ValueError(f"{path}: JPEG with {n} components is not "
                                 "read")
            return {1: "L", 3: "RGB", 4: "CMYK"}[n], height, width
        if marker in (0xDA, 0xD9):
            break
    raise ValueError(f"{path}: JPEG without a frame header")


# ------------------------------------------------------------- Huffman


def _huffman_table(seg: bytes, at: int, path: str) -> Tuple[object, int]:
    """One DHT table at `at` -> ((a list of 65536 entries, its largest
    symbol), the offset after it): entry[next 16 bits] = code length << 8 |
    symbol, 0 where no code starts with those bits. A table whose code
    lengths overflow comes back as the ValueError that jdhuff.c raises
    when a scan uses it."""
    counts = seg[at + 1:at + 17]
    n = sum(counts)
    syms = seg[at + 17:at + 17 + n]
    if len(counts) != 16 or len(syms) != n or n > 256:
        raise ValueError(f"{path}: corrupt JPEG Huffman table")
    lut = np.zeros(1 << 16, np.int64)
    code = k = 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if code >= 1 << length:
                return (ValueError(f"{path}: corrupt JPEG Huffman table"),
                        at + 17 + n)
            lo = code << (16 - length)
            lut[lo:lo + (1 << (16 - length))] = length << 8 | syms[k]
            code += 1
            k += 1
        code <<= 1
    return (lut.tolist(), max(syms, default=0)), at + 17 + n


def _table(dht: dict, key: Tuple[int, int], sequential: bool,
           path: str, top_dc: int = 15) -> list:
    """A scan's table, checked as jdhuff.c's jpeg_make_d_derived_tbl
    checks it: defined (a sequential scan falls back on Annex K's tables in
    slots 0 and 1, as jdhuff.c's jinit_huff_decoder installs them), its
    codes fit, a DC table's sizes at most `top_dc` (16 in lossless
    files)."""
    if key not in dht and sequential and key[1] < 2:
        from .jpeg_encode import STD_HUFFMAN   # it imports this module
        dht[key] = _huffman_table(b"\0" + STD_HUFFMAN[key], 0, path)[0]
    if key not in dht:
        raise ValueError(f"{path}: JPEG scan uses an undefined Huffman "
                         "table")
    lut = dht[key]
    if isinstance(lut, ValueError):
        raise lut
    lut, top = lut
    if key[0] == 0 and top > top_dc:
        raise ValueError(f"{path}: corrupt JPEG Huffman table (DC size "
                         f"above {top_dc})")
    return lut


# bytes one block can read at most: a DC code and its bits (16 + 15) and
# 63 AC codes and their bits (17 + 15 each), rounded up
_BLOCK_BYTES = 256


def _windows(data: bytes, per: int) -> list:
    """Entry i: bytes i .. i + 7 of `data` (zeros past its end) as one
    big-endian 64-bit integer, so any 16 + 16 bits from bit 8 i on are one
    shift and mask away. The zeros run an MCU of `per` blocks past the end:
    libjpeg feeds zero bits to an MCU that its data ends in
    ("premature end of data segment")."""
    n = len(data) + 1 + per * _BLOCK_BYTES
    b = np.zeros(n + 7, np.uint64)
    b[:len(data)] = np.frombuffer(data, np.uint8)
    w = np.zeros(n, np.uint64)
    for j in range(8):
        w |= b[j:j + n] << np.uint64(56 - 8 * j)
    return w.tolist()


# The interval decoders below walk a restart interval's blocks as
# jdhuff.c / jdphuff.c do on any data, damaged or not: a bit pattern no
# code fits within 16 bits is the symbol 0 (17 bits read), a run past the
# band writes jpeg_natural_order's extra entries (zig-zag position 63),
# coefficients are stored as JCOEF (16 bits). Past the data come zero
# bits; the MCU the data ends in is decoded on them and the interval's
# later MCUs are not decoded at all. Each returns (MCUs decoded, whether
# the data ran out): the clean path pays one comparison a block.


def _decode_interval(W: list, end: int, blocks: list, per: int,
                     tables: list, coefs: list, preds: list
                     ) -> Tuple[int, bool]:
    """A sequential scan's interval (jdhuff.c decode_mcu) into `coefs`
    (zig-zag order). blocks: (component slot, offset into its coefficient
    list) in stream order, `per` an MCU; tables: per slot (DC lookup, AC
    lookup)."""
    p = j = 0
    for ci, base in blocks:
        dc, ac = tables[ci]
        out = coefs[ci]
        e = dc[(W[p >> 3] >> (48 - (p & 7))) & 0xFFFF]
        if e:
            p += e >> 8
            s = e & 255
            if s:
                v = (W[p >> 3] >> (64 - (p & 7) - s)) & ((1 << s) - 1)
                p += s
                if v < 1 << (s - 1):
                    v -= (1 << s) - 1
                preds[ci] += v
        else:
            p += 17
        out[base] = ((preds[ci] + 32768) & 0xFFFF) - 32768
        k = 1
        while k < 64:
            e = ac[(W[p >> 3] >> (48 - (p & 7))) & 0xFFFF]
            if not e:
                p += 17
                break
            p += e >> 8
            rs = e & 255
            s = rs & 15
            if s:
                k += rs >> 4
                if k > 63:
                    k = 63
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
        j += 1
        if p > end and j % per == 0:
            return j // per, True
    return j // per, False


def _trace_mcu(W: list, p: int, blocks: list, tables: list, preds: list
               ) -> Tuple[int, list, list]:
    """_decode_interval's walk of one MCU from bit p, recorded: -> (the bit
    position after it, its writes (slot, offset, value) in order, its reads
    (True for a Huffman code, False for value bits; their bit counts))."""
    writes, reads = [], []
    for ci, base in blocks:
        dc, ac = tables[ci]
        e = dc[(W[p >> 3] >> (48 - (p & 7))) & 0xFFFF]
        n = e >> 8 if e else 17
        p += n
        reads.append((True, n))
        s = e & 255
        if s:
            v = (W[p >> 3] >> (64 - (p & 7) - s)) & ((1 << s) - 1)
            p += s
            reads.append((False, s))
            preds[ci] += _extend(v, s)
        writes.append((ci, base, ((preds[ci] + 32768) & 0xFFFF) - 32768))
        k = 1
        while k < 64:
            e = ac[(W[p >> 3] >> (48 - (p & 7))) & 0xFFFF]
            n = e >> 8 if e else 17
            p += n
            reads.append((True, n))
            rs = e & 255
            s = rs & 15
            if s:
                k += rs >> 4
                v = (W[p >> 3] >> (64 - (p & 7) - s)) & ((1 << s) - 1)
                p += s
                reads.append((False, s))
                writes.append((ci, base + (k if k < 64 else 63),
                               _extend(v, s)))
                k += 1
            elif rs == 0xF0:
                k += 16
            else:
                break
    return p, writes, reads


def _fast_fills(reads: list, bl: int, d: int) -> Tuple[int, int]:
    """jdhuff.c decode_mcu_fast's reading for `reads` from bits_left bl
    and data byte d on: six bytes whenever 16 bits or fewer are left before
    a code or value bits -> (bits_left, the data byte it reached)."""
    for _, n in reads:
        if bl <= 16:
            bl += 48
            d += 6
        bl -= n
    return bl, d


def _slow_fills(reads: list, bl: int, d: int) -> Tuple[int, int]:
    """jdhuff.c decode_mcu_slow's reading for `reads`: jpeg_fill_bit_buffer
    loads bytes until 57 bits are held whenever a code of up to 8 bits
    finds fewer than 8 (its lookahead), a longer one fewer than 9 or then
    1, value bits fewer than they need -> (bits_left, the data byte it
    reached)."""
    for code, n in reads:
        for i, need in enumerate(([n] if n <= 8 else [9] + [1] * (n - 9))
                                 if code else [n]):
            if bl < (8 if code and n <= 8 else need):
                while bl < 57:
                    bl += 8
                    d += 1
            bl -= need
    return bl, d


def _replay_interval(blob: bytes, pos: int, end_at: int, marker: bool,
                     blocks: list, per: int, tables: list, coefs: list,
                     restart: int, st, path: str) -> Tuple[int, bool]:
    """_decode_interval for an interval libjpeg-turbo reads differently
    from its data alone: "0xFF 0xFF ... 0x00" inside it, or no marker
    before the file ends. libjpeg's reader is replayed MCU by MCU: the
    fast Huffman path where no restarts are defined and 512 bytes a block
    are buffered (it takes 0xFF 0xFF as a marker and decodes on zero
    bits, and where that changed what it read, the slow path's redo
    leaves its coefficients where it writes none), the slow path's fills,
    Pillow handing libjpeg 64 KiB more whenever a fill needs it (the MCU
    begun again), and the file's end, where libjpeg waits (refused as
    truncated)."""
    raw = blob[pos:end_at]
    data, src, ffff = bytearray(), [], []
    i = 0
    while i < len(raw):                    # unstuff, keeping each byte's
        src.append(pos + i)                # source offset
        c = raw[i]
        if c == 0xFF:
            j = i + 1
            while j < len(raw) and raw[j] == 0xFF:
                j += 1
            ffff.append(j > i + 1)
            i = j + 1
        else:
            ffff.append(False)
            i += 1
        data.append(c)
    src.append(pos + len(raw))
    data = bytes(data)
    W, end = _windows(data, per), 8 * len(data)
    ff_at = [j for j, f in enumerate(ffff) if f] + [len(data)]
    p = bl = d = 0
    preds = [0] * len(tables)
    n_mcu = len(blocks) // per
    cut = {}                                   # the fast path's streams
    for m in range(n_mcu):
        mcu = blocks[m * per:(m + 1) * per]
        while True:
            fed = min(st.fed, len(blob))
            polluted = []
            if not restart and d < len(data) and fed - src[d] >= 512 * per:
                j = next(x for x in ff_at if x >= d)
                if j not in cut:
                    cut[j] = _windows(data[:j], per)
                pc = list(preds)
                q, w, reads = _trace_mcu(cut[j], p, mcu, tables, pc)
                fbl, fd = _fast_fills(reads, bl, d)
                if fd <= j:                # it met no marker: it stands
                    p, bl, d, preds = q, fbl, fd, pc
                    break
                polluted = w
            pc = list(preds)
            q, w, reads = _trace_mcu(W, p, mcu, tables, pc)
            sbl, sd = _slow_fills(reads, bl, d)
            if sd > len(data) and not marker:
                raise _Truncated(f"{path}: truncated JPEG data (the file "
                                 "ends inside a scan)")
            # the bytes read: to the source of data byte sd, or past the
            # marker's code where the data ran out
            if (src[sd] if sd <= len(data) else end_at + 2) > fed:
                st.fed += 1 << 16          # Pillow reads on; begin again
                continue
            p, bl, d, preds = q, sbl, sd, pc
            w = polluted + w
            break
        for ci, at, v in w:
            coefs[ci][at] = v
        if p > end:
            return m + 1, True
    return n_mcu, False


def _extend(v: int, s: int) -> int:
    """HUFF_EXTEND: s bits read as a signed value."""
    return v - (1 << s) + 1 if v < 1 << (s - 1) else v


def _dc_first(W: list, end: int, blocks: list, per: int, tables: list,
              coefs: list, preds: list, al: int) -> Tuple[int, bool]:
    """A progressive DC first scan's interval (jdphuff.c
    decode_mcu_DC_first): the DC differences of `blocks` (as
    _decode_interval's), shifted by Al."""
    p = j = 0
    for ci, base in blocks:
        e = tables[ci][(W[p >> 3] >> (48 - (p & 7))) & 0xFFFF]
        if e:
            p += e >> 8
            s = e & 255
            if s:
                preds[ci] += _extend((W[p >> 3] >> (64 - (p & 7) - s))
                                     & ((1 << s) - 1), s)
                p += s
        else:
            p += 17
        coefs[ci][base] = ((preds[ci] << al) + 32768 & 0xFFFF) - 32768
        j += 1
        if p > end and j % per == 0:
            return j // per, True
    return j // per, False


def _dc_refine(W: list, end: int, blocks: list, per: int, coefs: list,
               al: int) -> Tuple[int, bool]:
    """A DC refinement scan's interval: one bit a block, bit Al of its DC
    (zero bits past the data change nothing)."""
    p = 0
    for ci, base in blocks:
        if (W[p >> 3] >> (63 - (p & 7))) & 1:
            coefs[ci][base] |= 1 << al
        p += 1
    n = len(blocks) // per
    if p > end:
        return min(n, end // per + 1), True
    return n, False


def _ac_first(W: list, end: int, bases: list, ac: list, out: list, ss: int,
              se: int, al: int) -> Tuple[int, bool]:
    """An AC first scan's interval (decode_mcu_AC_first): one component,
    bands ss..se of the blocks at `bases`, end-of-band runs (EOBRUN)
    across blocks."""
    p = eobrun = j = 0
    top = 15 - al                      # sizes whose value << Al fits
    for base in bases:
        j += 1
        if eobrun:
            eobrun -= 1
            continue
        k = ss
        while k <= se:
            e = ac[(W[p >> 3] >> (48 - (p & 7))) & 0xFFFF]
            if e:
                p += e >> 8
                r, s = (e >> 4) & 15, e & 15
            else:
                p += 17
                r = s = 0
            if s:
                k += r
                if k > 63:
                    k = 63
                v = (W[p >> 3] >> (64 - (p & 7) - s)) & ((1 << s) - 1)
                if v < 1 << (s - 1):
                    v -= (1 << s) - 1
                v <<= al
                if s > top:            # past 16 bits: JCOEF wraps
                    v = ((v + 32768) & 0xFFFF) - 32768
                out[base + k] = v
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
            return j, True
    return j, False


def _ac_refine(W: list, end: int, bases: list, ac: list, out: list, ss: int,
               se: int, al: int) -> Tuple[int, bool]:
    """An AC refinement scan's interval (decode_mcu_AC_refine): a
    correction bit for every coefficient already nonzero that a run
    passes, and the new coefficients +-(1 << Al); a new one a run carries
    past the band lands just after it."""
    p1, m1 = 1 << al, -1 << al
    lo = p1 - 32768                    # below it, c + m1 wraps (JCOEF)
    p = eobrun = j = 0
    for base in bases:
        j += 1
        k = ss
        if not eobrun:
            while k <= se:
                e = ac[(W[p >> 3] >> (48 - (p & 7))) & 0xFFFF]
                if e:
                    p += e >> 8
                    r, s = (e >> 4) & 15, e & 15
                else:
                    p += 17
                    r = s = 0
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
                            out[base + k] = c + p1 if c >= 0 else (
                                c + m1 if c >= lo else c + m1 + 65536)
                        p += 1
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if s:
                    out[base + (k if k < 64 else 63)] = s
                k += 1
        if eobrun:
            while k <= se:
                c = out[base + k]
                if c:
                    if (W[p >> 3] >> (63 - (p & 7))) & 1 and not c & p1:
                        out[base + k] = c + p1 if c >= 0 else (
                            c + m1 if c >= lo else c + m1 + 65536)
                    p += 1
                k += 1
            eobrun -= 1
        if p > end:
            return j, True
    return j, False


# jaricom.c's jpeg_aritab: T.81 Table D.2 (Qe, Next_Index_MPS,
# Switch_MPS, Next_Index_LPS) packed as Qe << 16 | NMPS << 8 | SW << 7 |
# NLPS, and entry 113, the fixed probability 0.5 (read out of
# libjpeg-turbo's decoder)
_ARITAB = (
    0x5A1D0181, 0x2586020E, 0x11140310, 0x080B0412, 0x03D80514, 0x01DA0617,
    0x00E50719, 0x006F081C, 0x0036091E, 0x001A0A21, 0x000D0B23, 0x00060C09,
    0x00030D0A, 0x00010D0C, 0x5A7F0F8F, 0x3F251024, 0x2CF21126, 0x207C1227,
    0x17B91328, 0x1182142A, 0x0CEF152B, 0x09A1162D, 0x072F172E, 0x055C1830,
    0x04061931, 0x03031A33, 0x02401B34, 0x01B11C36, 0x01441D38, 0x00F51E39,
    0x00B71F3B, 0x008A203C, 0x0068213E, 0x004E223F, 0x003B2320, 0x002C0921,
    0x5AE125A5, 0x484C2640, 0x3A0D2741, 0x2EF12843, 0x261F2944, 0x1F332A45,
    0x19A82B46, 0x15182C48, 0x11772D49, 0x0E742E4A, 0x0BFB2F4B, 0x09F8304D,
    0x0861314E, 0x0706324F, 0x05CD3330, 0x04DE3432, 0x040F3532, 0x03633633,
    0x02D43734, 0x025C3835, 0x01F83936, 0x01A43A37, 0x01603B38, 0x01253C39,
    0x00F63D3A, 0x00CB3E3B, 0x00AB3F3D, 0x008F203D, 0x5B1241C1, 0x4D044250,
    0x412C4351, 0x37D84452, 0x2FE84553, 0x293C4654, 0x23794756, 0x1EDF4857,
    0x1AA94957, 0x174E4A48, 0x14244B48, 0x119C4C4A, 0x0F6B4D4A, 0x0D514E4B,
    0x0BB64F4D, 0x0A40304D, 0x583251D0, 0x4D1C5258, 0x438E5359, 0x3BDD545A,
    0x34EE555B, 0x2EAE565C, 0x299A575D, 0x25164756, 0x557059D8, 0x4CA95A5F,
    0x44D95B60, 0x3E225C61, 0x38245D63, 0x32B45E63, 0x2E17565D, 0x56A860DF,
    0x4F466165, 0x47E56266, 0x41CF6367, 0x3C3D6468, 0x375E5D63, 0x52316669,
    0x4C0F676A, 0x4639686B, 0x415E6367, 0x56276AE9, 0x50E76B6C, 0x4B85676D,
    0x55976D6E, 0x504F6B6F, 0x5A106FEE, 0x55226D70, 0x59EB6FF0, 0x5A1D7171,
)


class _QM:
    """jdarith.c's arith_decode: T.81's QM decoder (Annex D) over one
    restart interval's data, zero bytes past its end (libjpeg feeds
    zeros once it reaches the marker)."""
    __slots__ = ("data", "at", "c", "a", "ct")

    def __init__(self, data: bytes):
        self.data, self.at = data, 0
        self.c = self.a = 0
        self.ct = -16                  # two bytes fill C before the first

    def bit(self, stats: bytearray, i: int) -> int:
        """One binary decision in statistics bin stats[i]."""
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                at = self.at
                c = (c << 8) | (self.data[at] if at < len(self.data) else 0)
                self.at = at + 1
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000
            a <<= 1
        sv = stats[i]
        e = _ARITAB[sv & 0x7F]
        qe = e >> 16
        a -= qe
        t = a << ct
        if c >= t:
            c -= t
            if a < qe:
                stats[i] = (sv & 0x80) ^ ((e >> 8) & 0xFF)
            else:
                stats[i] = (sv & 0x80) ^ (e & 0xFF)
                sv ^= 0x80
            a = qe
        elif a < 0x8000:
            if a < qe:
                stats[i] = (sv & 0x80) ^ (e & 0xFF)
                sv ^= 0x80
            else:
                stats[i] = (sv & 0x80) ^ ((e >> 8) & 0xFF)
        self.a, self.c, self.ct = a, c, ct
        return sv >> 7


def _arith_dc(qm: _QM, st: bytearray, ctx: int, lo: int, hi: int):
    """Figures F.19 and F.21-F.24: one DC difference from the bins `st`
    at context `ctx`, the conditioning bounds L and U -> (difference, next
    context), or None where the magnitude overflows."""
    if not qm.bit(st, ctx):
        return 0, 0
    sign = qm.bit(st, ctx + 1)
    i = ctx + 2 + sign
    m = qm.bit(st, i)
    if m:
        i = 20
        while qm.bit(st, i):
            m <<= 1
            if m == 0x8000:
                return None
            i += 1
    if m < (1 << lo) >> 1:
        ctx = 0
    elif m > (1 << hi) >> 1:
        ctx = 12 + 4 * sign
    else:
        ctx = 4 + 4 * sign
    v, i = m, i + 14
    m >>= 1
    while m:
        if qm.bit(st, i):
            v |= m
        m >>= 1
    return (-v - 1 if sign else v + 1), ctx


# the fixed-probability bin: state 113 leads back to itself
_FIXED_BIN = bytearray([113])


def _arith_ac(qm: _QM, st: bytearray, i: int, k: int, kx: int):
    """Figures F.21-F.24 for AC coefficient k, its bins from st[i] on and
    the conditioning bound Kx -> the value, or None where it overflows."""
    sign = qm.bit(_FIXED_BIN, 0)
    i += 2
    m = qm.bit(st, i)
    if m and qm.bit(st, i):
        m <<= 1
        i = 189 if k <= kx else 217
        while qm.bit(st, i):
            m <<= 1
            if m == 0x8000:
                return None
            i += 1
    v, i = m, i + 14
    m >>= 1
    while m:
        if qm.bit(st, i):
            v |= m
        m >>= 1
    return -v - 1 if sign else v + 1


def _arith_interval(data: bytes, blocks: list, tsel: list, dac: list,
                    coefs: list, ss: int, se: int, ah: int, al: int,
                    progressive: bool) -> int:
    """One restart interval of an arithmetic-coded scan (jdarith.c's
    decode_mcu and decode_mcu_DC_first / _AC_first / _DC_refine /
    _AC_refine) into `coefs` (zig-zag): fresh statistics, the QM decoder
    on `data`, every MCU decoded (zero data past the marker) until a bad
    code, after which the interval's blocks are left alone -> the data
    bytes the decoder read (past len(data): it reached the marker).
    tsel: per slot (DC table, AC table); dac: (L, U, Kx) per table."""
    qm = _QM(data)
    try:
        _arith_mcus(qm, blocks, tsel, dac, coefs, ss, se, ah, al,
                    progressive)
    except _BadCode:
        pass
    return qm.at


class _BadCode(Exception):
    """jdarith.c's "bad arithmetic code" (a spectral or magnitude
    overflow): the rest of the restart interval is not decoded."""


def _arith_mcus(qm: _QM, blocks: list, tsel: list, dac: list, coefs: list,
                ss: int, se: int, ah: int, al: int, progressive: bool
                ) -> None:
    """_arith_interval's blocks in stream order."""
    dc_st = {t: bytearray(64) for t, _ in tsel}
    ac_st = {t: bytearray(256) for _, t in tsel}
    ctx, last = [0] * len(tsel), [0] * len(tsel)
    p1, m1 = 1 << al, -1 << al
    for ci, base in blocks:
        out = coefs[ci]
        dt, at = tsel[ci]
        if progressive and ss == 0 and ah:             # DC refinement
            if qm.bit(_FIXED_BIN, 0):
                out[base] |= p1
        elif not progressive or ss == 0:               # a DC value
            got = _arith_dc(qm, dc_st[dt], ctx[ci], dac[dt][0], dac[dt][1])
            if got is None:
                raise _BadCode
            last[ci] += got[0]
            ctx[ci] = got[1]
            out[base] = ((last[ci] << al) + 32768 & 0xFFFF) - 32768
        if not progressive or (ss and not ah):         # AC values
            st, kx = ac_st[at], dac[at][2]
            k, end = (1, 63) if not progressive else (ss, se)
            while k <= end:
                i = 3 * (k - 1)
                if qm.bit(st, i):
                    break                              # end of block
                while not qm.bit(st, i + 1):
                    i += 3
                    k += 1
                    if k > end:
                        raise _BadCode             # spectral overflow
                v = _arith_ac(qm, st, i, k, kx)
                if v is None:
                    raise _BadCode
                out[base + k] = ((v << al) + 32768 & 0xFFFF) - 32768
                k += 1
        elif ss:                                       # AC refinement
            st = ac_st[at]
            kex = se
            while kex > 0 and not out[base + kex]:
                kex -= 1
            k = ss
            while k <= se:
                i = 3 * (k - 1)
                if k > kex and qm.bit(st, i):
                    break
                while True:
                    c = out[base + k]
                    if c:
                        if qm.bit(st, i + 2):
                            c += m1 if c < 0 else p1
                            out[base + k] = (c + 32768 & 0xFFFF) - 32768
                        break
                    if qm.bit(st, i + 1):
                        out[base + k] = m1 if qm.bit(_FIXED_BIN, 0) else p1
                        break
                    i += 3
                    k += 1
                    if k > se:
                        raise _BadCode
                k += 1


def _unstuff(data: bytes) -> bytes:
    """Entropy-coded bytes -> data bytes: 0xFF (0xFF)* 0x00 is one 0xFF,
    as jdhuff.c's jpeg_fill_bit_buffer reads it."""
    if b"\xff\xff" in data:
        return re.sub(b"\xff+\x00", b"\xff", data)
    return data.replace(b"\xff\x00", b"\xff")


def _source_offset(blob: bytes, at: int, n: int) -> int:
    """The file offset of the n-th byte of entropy-coded data from `at`
    on (_unstuff's count), the last of the n a decoder read."""
    while True:
        ff = blob.find(b"\xff", at, at + n)
        if ff < 0:
            return at + n - 1
        n -= ff + 1 - at
        at = ff + 1
        while blob[at] == 0xFF:
            at += 1
        at += 1                            # the stuffed 0x00
        if n == 0:
            return at - 1


def _resync(blob: bytes, mk: Tuple[int, int, int], want: int, path: str
            ) -> Tuple[Optional[Tuple[int, int, int]], int]:
    """jdmarker.c's read_restart_marker at a restart, given the marker `mk`
    that ended the interval before -> (the marker left unread, or None,
    and the offset the next interval's data starts at). RST`want` is read
    past; any other goes through jpeg_resync_to_restart: discarded (action
    1), scanned past to the next marker (2), or left unread (3), and the
    entropy decoder then reads an empty interval."""
    while True:
        code = mk[0]
        if code < 0xC0:
            action = 2                     # not a valid marker
        elif not 0xD0 <= code <= 0xD7:
            action = 3                     # a valid marker, not a restart
        else:
            d = (code - 0xD0 - want) & 7
            action = 3 if d in (1, 2) else 2 if d in (6, 7) else 1
        if action == 1:
            return None, mk[2]
        if action == 3:
            return mk, mk[2]
        mk = _find_marker(blob, mk[2], path)


# ---------------------------------------------------------- pixel stages

CONST_BITS, PASS1_BITS = 13, 2
FIX = {"0_298631336": 2446, "0_390180644": 3196, "0_541196100": 4433,
       "0_765366865": 6270, "0_899976223": 7373, "1_175875602": 9633,
       "1_501321110": 12299, "1_847759065": 15137, "1_961570560": 16069,
       "2_053119869": 16819, "2_562915447": 20995, "3_072711026": 25172}


def _w16(x: np.ndarray) -> np.ndarray:
    """int64 values wrapped to 16 bits, as paddw / psllw / pmullw leave
    them."""
    return ((x + 32768) & 0xFFFF) - 32768


def _idct_1d(x: np.ndarray, shift: int, wrap: bool) -> np.ndarray:
    """jidctint.c's 1-D pass over the last axis (int64), descaled by
    `shift` with rounding, as jidctint-sse2 / -avx2 compute it: with
    `wrap`, the sums x0 +- x4, x7 + x3 and x5 + x1, which the SIMD code
    forms in 16 bits, wrap (the other sums and products are exact there
    too). Its shortcut for all-zero AC terms gives the same numbers, so it
    is not taken."""
    f = FIX
    z2, z3 = x[..., 2], x[..., 6]
    z1 = (z2 + z3) * f["0_541196100"]
    tmp2 = z1 - z3 * f["1_847759065"]
    tmp3 = z1 + z2 * f["0_765366865"]
    tmp0, tmp1 = x[..., 0] + x[..., 4], x[..., 0] - x[..., 4]
    if wrap:
        tmp0, tmp1 = _w16(tmp0), _w16(tmp1)
    tmp0 <<= CONST_BITS
    tmp1 <<= CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[..., 7], x[..., 5], x[..., 3], x[..., 1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    if wrap:
        z3, z4 = _w16(z3), _w16(z4)
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


# blocks whose inverse DCT may wrap or saturated a 16-bit value or left
# [-512, 511] (where libjpeg-turbo's C code would give other pixels),
# since the process began
COUNTS = {"saturated_blocks": 0}


def _span(x: np.ndarray) -> int:
    """The largest magnitude in x (0 for an empty array)."""
    return max(-int(x.min()), int(x.max())) if x.size else 0


def idct_islow(coefs: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """(N, 8, 8) quantized coefficients (natural order, int16 values) and
    the (8, 8) quantization table -> (N, 8, 8) uint8 samples, as
    libjpeg-turbo's SIMD "islow" inverse DCT gives them, the code it runs
    on every x86-64 CPU (and that Pillow runs there unless the
    environment sets JSIMD_FORCENONE, whose C code wraps instead):
    dequantized in 16 bits (pmullw); a block whose rows 1..7 are all zero
    takes the shortcut (row 0 shifted by PASS1_BITS in 16 bits, psllw); any
    other the column pass, its results saturated to 16 bits (packssdw);
    then the row pass, saturated to 16 and 8 bits, and the level shift.
    Where no 16-bit value can wrap or saturate (the usual case, checked
    from the extremes) this is jidctint.c's, and computed so."""
    c = coefs.astype(np.int64)
    d = c * qt.astype(np.int64)
    odd = np.zeros(len(c), bool)
    big = _span(d) > 8191                  # else no 16-bit sum can wrap
    if big:
        odd |= (np.abs(d) > 8191).any((1, 2))
        d = _w16(d)
    ws = np.swapaxes(_idct_1d(np.swapaxes(d, 1, 2),
                              CONST_BITS - PASS1_BITS, big), 1, 2)
    if big:
        flat = ~c[:, 1:].any((1, 2))
        if flat.any():
            ws[flat] = _w16(d[flat, :1] << PASS1_BITS)
    span = _span(ws)
    if span > 32767:
        sat = np.clip(ws, -32768, 32767)
        odd |= (sat != ws).any((1, 2))
        ws = sat
    x = _idct_1d(ws, CONST_BITS + PASS1_BITS + 3, span > 16383)
    if _span(x) > 511:
        odd |= (x < -512).any((1, 2)) | (x > 511).any((1, 2))
    COUNTS["saturated_blocks"] += int(odd.sum())
    return (np.clip(x, -128, 127) + 128).astype(np.uint8)


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


def _decode(blob: bytes, path: str, precision: int = 8
            ) -> Tuple[Frame, List[np.ndarray], List[np.ndarray]]:
    """Parse and entropy-decode the file -> the frame, per component its
    MCU-padded 8x8 blocks as (by, bx, 64) int64 quantized coefficients in
    zig-zag order (block smoothing applied where libjpeg-turbo applies
    it), and per component its quantization table (zig-zag; zeros for a
    component no scan coded, whose blocks then come out mid-grey). A
    lossless file gives its components' (h, w) uint8 samples and None."""
    qt: Dict[int, np.ndarray] = {}
    dht: Dict[Tuple[int, int], object] = {}
    restart = 0
    dac = [(0, 1, 5)] * 16      # (L, U, Kx) a table, as SOI resets them
    frame = None
    jfif, adobe = False, None
    st = _State()
    st.precision = precision
    segs = _segments(blob, path)
    try:
        item = next(segs)
        while True:
            marker, seg, after = item
            st.feed(after)
            if marker == 0xD9:
                break
            if marker == 0xE0 and len(seg) >= 14 and seg[:5] == b"JFIF\0":
                jfif = True
            elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
                adobe = seg[11]
            elif marker == 0xDB:
                at = 0
                while at < len(seg):
                    pq, tq = seg[at] >> 4, seg[at] & 15
                    n = 128 if pq else 64
                    if tq > 3 or at + 1 + n > len(seg):
                        raise ValueError(f"{path}: corrupt JPEG quantization"
                                         " table")
                    q = np.frombuffer(seg[at + 1:at + 1 + n],
                                      ">u2" if pq else np.uint8)
                    qt[tq] = q.astype(np.int64)
                    at += 1 + n
            elif marker == 0xC4:
                at = 0
                while at < len(seg):
                    tc, th = seg[at] >> 4, seg[at] & 15
                    if tc > 1 or th > 3:
                        raise ValueError(f"{path}: corrupt JPEG Huffman "
                                         "table")
                    dht[tc, th], at = _huffman_table(seg, at, path)
            elif marker == 0xDD:
                restart = struct.unpack(">H", seg[:2])[0]
            elif marker == 0xCC:           # arithmetic conditioning
                for at in range(0, len(seg) - 1, 2):
                    t, v = seg[at], seg[at + 1]
                    if t < 16:
                        dac[t] = (v & 15, v >> 4, dac[t][2])
                    else:
                        dac[t - 16] = (dac[t - 16][0], dac[t - 16][1], v)
            elif 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xCC):
                if frame is not None:
                    raise ValueError(f"{path}: JPEG with two frame headers")
                width, height, comps = _frame(marker, seg, path, precision)
                if len(comps) not in (1, 3, 4):
                    raise ValueError(f"{path}: JPEG with {len(comps)} "
                                     "components (not grey, colour or "
                                     "CMYK) is not decoded")
                frame = Frame(width, height, comps, False, False,
                              marker in (0xC2, 0xCA), marker in (0xC9, 0xCA),
                              marker == 0xC3)
                st.start(frame)
            elif marker == 0xDA:
                if frame is None:
                    raise ValueError(f"{path}: JPEG scan before its frame "
                                     "header")
                if not st.scans:
                    # jdapimin.c's colour space, fixed when the first scan
                    # starts: 3 components are YCbCr unless RGB is
                    # signalled (a lossless file's are RGB unless YCbCr
                    # is); 4 are YCCK under an Adobe transform but 0
                    comps = frame.comps
                    frame = frame._replace(
                        rgb=len(comps) == 3 and not jfif and (
                            adobe == 0 if adobe is not None
                            else frame.lossless or tuple(
                                c.cid for c in comps) == (82, 71, 66)),
                        ycck=len(comps) == 4 and adobe not in (None, 0))
                item = segs.send(_scan(blob, seg, after, frame, qt, dht,
                                       restart, dac, st, path))
                continue
            item = next(segs)
    except _Truncated:
        if not st.single_done:     # libjpeg waits for the rest of the file
            raise
    if frame is None or not st.scans:
        raise ValueError(f"{path}: JPEG without a scan")
    if frame.lossless:
        if any(p is None for p in st.planes):
            raise ValueError(f"{path}: lossless JPEG ends before every "
                             "component was coded")
        if len(frame.comps) == 3 and not frame.rgb or frame.ycck:
            raise ValueError(f"{path}: lossless JPEG in YCbCr / YCCK: "
                             "libjpeg-turbo converts no colour in lossless "
                             "mode, so Pillow refuses it")
        return frame, st.planes, None
    _, _, mcux, mcuy = frame.grid
    coefs = [np.frombuffer(array.array("q", cf), np.int64).reshape(
        mcuy * c.v, mcux * c.h, 64) for c, cf in zip(frame.comps, st.coefs)]
    if frame.progressive and st.smoothing_ok():
        for i, c in enumerate(frame.comps):
            _smooth(coefs[i], st.qt_of[i], st.bits[i][:10],
                    st.prev[i][:10] if st.scans > 1 else [-1] * 10,
                    frame, c, st.last_good)
    qts = [np.zeros(64, np.int64) if q is None else q for q in st.qt_of]
    return frame, coefs, qts


class _State:
    """What the scans leave for the pixel stages: the coefficients, the
    latched quantization tables and libjpeg's progression state."""

    def start(self, frame: Frame) -> None:
        _, _, mcux, mcuy = frame.grid
        n = len(frame.comps)
        self.coefs = [[0] * (mcuy * c.v * mcux * c.h * 64)
                      for c in frame.comps]
        self.qt_of = [None] * n
        self.planes = [None] * n   # a lossless file's samples
        self.bits = [[-1] * 64 for _ in range(n)]  # coef_bits: -1 = unsent
        self.prev = [[-1] * 64 for _ in range(n)]  # before the last scan
        self.scans = 0
        self.single_done = False   # the scan of a single-scan file is read
        self.last_good = 0         # jdcoefct.c's last_good_iMCU_row

    scans = 0
    single_done = False
    fed = 1 << 16       # the bytes Pillow has handed libjpeg

    def feed(self, upto: int) -> None:
        """Pillow reads the file 64 KiB at a time and hands libjpeg more
        whenever reading markers makes it wait (up to `upto`)."""
        while self.fed < upto:
            self.fed += 1 << 16

    def smoothing_ok(self) -> bool:
        """jdcoefct.c's smoothing_ok: every component's table latched with
        nonzero entries 0..9, its DC sent, and some AC 1..9 not yet exact."""
        return all(q is not None and q[:10].all() for q in self.qt_of) and \
            all(b[0] >= 0 for b in self.bits) and \
            any(b[k] for b in self.bits for k in range(1, 10))


def _scan(blob, seg, after, frame, qt, dht, restart, dac, st, path) -> int:
    """Decode one scan into st.coefs; the offset of the marker after it."""
    ns = seg[0] if seg else 0
    if ns < 1 or ns > 4 or len(seg) < 4 + 2 * ns:
        raise ValueError(f"{path}: corrupt JPEG scan header")
    if frame.lossless:
        return _lossless_scan(blob, seg, after, frame, dht, restart, st,
                              path)
    ss, se, ahl = seg[1 + 2 * ns:4 + 2 * ns]
    ah, al = ahl >> 4, ahl & 15
    if frame.progressive and ((se != 0 if ss == 0 else se < ss or se > 63
                               or ns != 1) or (ah and al != ah - 1)
                              or al > 13):
        raise ValueError(f"{path}: corrupt JPEG progression (scan "
                         f"Ss={ss} Se={se} Ah={ah} Al={al})")
    ids = [c.cid for c in frame.comps]
    slots, tables, tsel = [], [], []
    for i in range(ns):
        cid, t = seg[1 + 2 * i], seg[2 + 2 * i]
        if cid not in ids or ids.index(cid) in slots:
            raise ValueError(f"{path}: JPEG scan names component {cid}")
        ci = ids.index(cid)
        if not frame.progressive and (st.single_done or st.bits[ci][0] >= 0):
            raise ValueError(f"{path}: JPEG component {cid} coded twice in "
                             "a sequential file")
        if frame.arith:
            need = []
        elif not frame.progressive:
            need = [(0, t >> 4), (1, t & 15)]
        elif ss:
            need = [(1, t & 15)]
        else:                          # a DC refinement codes no symbols
            need = [] if ah else [(0, t >> 4)]
        slots.append(ci)
        tsel.append((t >> 4, t & 15))
        tables.append([_table(dht, k, not frame.progressive, path)
                       for k in need])
    st.scans += 1
    # jdinput.c latches a component's quantization table when its first
    # scan starts (zig-zag order, as the coefficients); jdphuff.c keeps the
    # progression (coef_bits) and, for block smoothing, its state before
    # this scan
    for ci in slots:
        tq = frame.comps[ci].tq
        if st.qt_of[ci] is None:
            if tq not in qt:
                raise ValueError(f"{path}: JPEG component uses an undefined "
                                 "quantization table")
            st.qt_of[ci] = qt[tq]
        if frame.progressive:
            for k in range(min(ss, 1), max(se, 9) + 1):
                st.prev[ci][k] = st.bits[ci][k] if st.scans > 1 else 0
        st.bits[ci][ss:se + 1] = [al] * (se + 1 - ss)
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
        row_of = lambda m: m // bw // c.v      # noqa: E731 (iMCU row)
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
        row_of = lambda m: m // mcux           # noqa: E731
    if not frame.progressive and ns == len(comps) and st.scans == 1:
        single = True
    else:
        single = False
    out = [st.coefs[ci] for ci in slots]
    each = restart or n_mcu
    walk = _Walk(blob, after, path)
    short = False               # libjpeg's insufficient_data
    good = None                 # the last MCU begun with data left
    n_int = -(-n_mcu // each)
    for i in range(n_int):
        # a single-scan file's last interval may run to the file's end:
        # libjpeg has its pixels if it never had to wait there
        data, cleared = walk.next(single and not frame.arith
                                  and i == n_int - 1)
        short = short and not cleared
        if short:
            continue
        part = order[i * each * per_mcu:(i + 1) * each * per_mcu]
        if not frame.progressive and not frame.arith and (
                walk.eof or not restart and b"\xff\xff" in blob[
                    walk.start:walk.stop]):
            done, short = _replay_interval(
                blob, walk.start, walk.stop, not walk.eof, part, per_mcu,
                tables, out, restart, st, path)
            good = i * each + done - 1
            continue
        if frame.arith:
            # jdarith.c reads what Pillow has handed libjpeg and cannot
            # wait for more: a restart marker or a byte of data past it
            # refuses the file
            read = _arith_interval(data, part, tsel, dac, out, ss, se, ah,
                                   al, frame.progressive)
            last = walk.mk[2] - 1 if read > len(data) else _source_offset(
                blob, walk.pos, read)
            if walk.pos > st.fed or last >= st.fed:
                raise ValueError(f"{path}: arithmetic-coded JPEG data past "
                                 f"the first {st.fed} bytes Pillow hands "
                                 "libjpeg, which cannot wait for more in an "
                                 "arithmetic-coded scan")
            good = i * each + len(part) // per_mcu - 1
            continue
        W, end = _windows(data, per_mcu), 8 * len(data)
        if not frame.progressive:
            done, short = _decode_interval(W, end, part, per_mcu, tables,
                                           out, [0] * ns)
        elif ss == 0 and not ah:
            done, short = _dc_first(W, end, part, per_mcu,
                                    [t[0] for t in tables], out, [0] * ns,
                                    al)
        elif ss == 0:
            done, short = _dc_refine(W, end, part, per_mcu, out, al)
        else:
            done, short = (_ac_refine if ah else _ac_first)(
                W, end, [b for _, b in part], tables[0][0], out[0], ss, se,
                al)
        if done:
            good = i * each + done - 1
    if good is not None:
        st.last_good = row_of(good)
    st.single_done = single
    return walk.end()


class _Walk:
    """A scan's restart intervals as libjpeg reads them: each interval's
    data up to the marker that ends it (unstuffed), and between them
    jdmarker.c's read_restart_marker, resynchronising where the marker is
    not the expected RSTn."""

    def __init__(self, blob: bytes, at: int, path: str):
        self.blob, self.pos, self.path = blob, at, path
        self.mk = None              # a marker read and not consumed
        self.i = 0
        self.start = self.stop = at     # the last interval's bytes
        self.eof = False                # it ran to the file's end

    def next(self, eof_ok: bool = False) -> Tuple[bytes, bool]:
        """The next interval's data (empty where a marker is left unread
        before it), and whether a restart marker was read past before it
        (which clears libjpeg's insufficient_data). With `eof_ok`, data
        that runs to the file's end comes back (eof set) instead of
        raising _Truncated."""
        blob, cleared = self.blob, False
        if self.i:                  # jdhuff.c / jdphuff.c's process_restart
            if self.mk is None:
                self.mk = _find_marker(blob, self.pos, self.path)
            self.mk, self.pos = _resync(blob, self.mk, (self.i - 1) & 7,
                                        self.path)
            cleared = self.mk is None
        self.i += 1
        self.start = self.stop = self.pos
        if self.mk is not None:
            return b"", cleared
        try:
            self.mk = _find_marker(blob, self.pos, self.path)
        except _Truncated:
            if not eof_ok:
                raise
            self.eof, self.stop = True, len(blob)
            return _unstuff(blob[self.pos:]), cleared
        self.stop = self.mk[1]
        return _unstuff(blob[self.pos:self.mk[1]]), cleared

    def end(self) -> int:
        """The offset of the marker after the scan (the file's end where
        the data ran to it)."""
        if self.eof:
            return len(self.blob)
        if self.mk is None:
            self.mk = _find_marker(self.blob, self.pos, self.path)
        return self.mk[1]


def _lossless_samples(W: list, p: int, order: list, tables: list,
                      diffs: list) -> int:
    """One MCU row of a lossless scan (jdlhuff.c decode_mcus): a
    difference a sample, its size 16 meaning 32768 with no bits after it
    -> the bit position after the row."""
    for ci, at in order:
        e = tables[ci][(W[p >> 3] >> (48 - (p & 7))) & 0xFFFF]
        if e:
            p += e >> 8
            s = e & 255
            if s == 16:
                diffs[ci][at] = 32768
            elif s:
                v = (W[p >> 3] >> (64 - (p & 7) - s)) & ((1 << s) - 1)
                p += s
                diffs[ci][at] = v - (1 << s) + 1 if v < 1 << (s - 1) else v
        else:
            p += 17
    return p


def _undifference(d: np.ndarray, first: np.ndarray, psv: int,
                  pt: int, precision: int = 8) -> np.ndarray:
    """jdlossls.c on one component's (h, w) differences: rows whose flag
    in `first` is set start the prediction afresh (the left neighbour,
    from 1 << (precision - 1 - Pt) at the row's start), any other row
    predicts by predictor `psv` from it and the row above (its first
    sample from above); the samples modulo 2 ** 16, shifted left by Pt,
    cut to `precision` bits (a byte, or the 12 bits libtiff packs)."""
    h, w = d.shape
    out = np.zeros((h, w), np.int64)
    for r in range(h):
        diff = d[r].tolist()
        row = [0] * w
        if first[r]:
            ra = 1 << (precision - 1 - pt)
            for x in range(w):
                ra = (diff[x] + ra) & 0xFFFF
                row[x] = ra
        else:
            up = out[r - 1].tolist()
            rb = up[0]
            ra = (diff[0] + rb) & 0xFFFF
            row[0] = ra
            for x in range(1, w):
                rc, rb = rb, up[x]
                pred = (ra if psv == 1 else rb if psv == 2 else rc
                        if psv == 3 else ra + rb - rc if psv == 4 else
                        ra + ((rb - rc) >> 1) if psv == 5 else
                        rb + ((ra - rc) >> 1) if psv == 6 else
                        (ra + rb) >> 1)
                ra = (diff[x] + pred) & 0xFFFF
                row[x] = ra
        out[r] = row
    return (out << pt) & ((1 << precision) - 1)


def _lossless_scan(blob, seg, after, frame, dht, restart, st, path) -> int:
    """Decode one scan of a lossless (SOF3) file into st.planes; the offset
    of the marker after it (jdlhuff.c, jddiffct.c, jdlossls.c)."""
    ns = seg[0]
    psv, se, ahl = seg[1 + 2 * ns:4 + 2 * ns]
    pt = ahl & 15
    if not 1 <= psv <= 7 or se or ahl >> 4 or pt >= 8:
        raise ValueError(f"{path}: corrupt lossless JPEG scan (Ss={psv} "
                         f"Se={se} Ah={ahl >> 4} Al={pt})")
    ids = [c.cid for c in frame.comps]
    slots, tables = [], []
    for i in range(ns):
        cid, t = seg[1 + 2 * i], seg[2 + 2 * i]
        if cid not in ids or ids.index(cid) in slots:
            raise ValueError(f"{path}: JPEG scan names component {cid}")
        ci = ids.index(cid)
        if st.single_done or st.planes[ci] is not None:
            raise ValueError(f"{path}: JPEG component {cid} coded twice in "
                             "a sequential file")
        slots.append(ci)
        tables.append(_table(dht, (0, t >> 4), False, path, 16))
    st.scans += 1
    comps = frame.comps
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    real = [(-(-frame.height * comps[ci].v // vmax),
             -(-frame.width * comps[ci].h // hmax)) for ci in slots]
    if ns == 1:              # one sample an MCU, the component's own extent
        rows, per_row = real[0]
        shapes = [real[0]]
        rows_of = [[(0, r * per_row + x) for x in range(per_row)]
                   for r in range(rows)]
        vs = [1]
    else:
        per_row, rows = -(-frame.width // hmax), -(-frame.height // vmax)
        shapes = [(rows * comps[ci].v, per_row * comps[ci].h)
                  for ci in slots]
        rows_of = []
        for my in range(rows):
            row = []
            for mx in range(per_row):
                for s, ci in enumerate(slots):
                    c = comps[ci]
                    row += [(s, (my * c.v + y) * shapes[s][1] + mx * c.h + x)
                            for y in range(c.v) for x in range(c.h)]
            rows_of.append(row)
        vs = [comps[ci].v for ci in slots]
    if restart % per_row:
        raise ValueError(f"{path}: invalid restart interval {restart} in a "
                         f"lossless JPEG (not a multiple of {per_row} MCUs)")
    each = restart // per_row or rows
    diffs = [[0] * (hh * ww) for hh, ww in shapes]
    fresh = [False] * rows        # MCU rows whose prediction starts afresh
    walk = _Walk(blob, after, path)
    short = False
    for i in range(-(-rows // each)):
        data, cleared = walk.next()
        short = short and not cleared
        W, end = _windows(data, len(rows_of[0]) // 48 + 2), 8 * len(data)
        p = 0
        for r in range(i * each, min(rows, (i + 1) * each)):
            fresh[r] = r == i * each or short
            if not short:
                p = _lossless_samples(W, p, rows_of[r], tables, diffs)
                short = p > end
    for s, ci in enumerate(slots):
        d = np.asarray(diffs[s], np.int64).reshape(shapes[s])
        first = np.repeat(np.asarray(fresh), vs[s])[:shapes[s][0]] & (
            np.arange(shapes[s][0]) % vs[s] == 0)
        hh, ww = real[s]
        st.planes[ci] = _undifference(d[:hh, :ww], first[:hh], psv, pt,
                                      st.precision).astype(
            np.uint8 if st.precision == 8 else np.uint16)
    st.single_done = ns == len(comps) and st.scans == 1
    return walk.end()


# Block smoothing's kernels over the 5 x 5 blocks' DC values around a
# block (jdcoefct.c, libjpeg-turbo >= 2.1): zig-zag position -> (kernel
# when no AC 1..9 was ever sent, which also re-estimates the DC; kernel
# otherwise, None where that position is then left alone)
def _k(*rows):
    return np.array(rows, np.int64)


_Z = [0, 0, 0, 0, 0]
_SMOOTH = {
    1: (_k([-1, -1, 0, 1, 1], [-3, 13, 0, -13, 3], [-3, 38, 0, -38, 3],
           [-3, 13, 0, -13, 3], [-1, -1, 0, 1, 1]),
        _k(_Z, _Z, [-7, 50, 0, -50, 7], _Z, _Z)),
    3: (_k([0, 0, 1, 0, 0], [0, 2, 7, 2, 0], [0, -5, -14, -5, 0],
           [0, 2, 7, 2, 0], [0, 0, 1, 0, 0]),
        _k([0, 0, -1, 0, 0], [0, 0, 13, 0, 0], [0, 0, -24, 0, 0],
           [0, 0, 13, 0, 0], [0, 0, -1, 0, 0])),
    4: (_k([-1, 0, 0, 0, 1], [0, 9, 0, -9, 0], _Z, [0, -9, 0, 9, 0],
           [1, 0, 0, 0, -1]),
        _k([0, -1, 0, 1, 0], [-1, 10, 0, -10, 1], _Z, [1, -10, 0, 10, -1],
           [0, 1, 0, -1, 0])),
    6: (_k(_Z, [0, 1, 0, -1, 0], [0, 2, 0, -2, 0], [0, 1, 0, -1, 0], _Z),
        None),
    7: (_k(_Z, [0, 1, -3, 1, 0], _Z, [0, -1, 3, -1, 0], _Z), None),
}
_SMOOTH[2] = tuple(k.T for k in _SMOOTH[1])          # AC10: AC01's
_SMOOTH[5] = tuple(k.T for k in _SMOOTH[3])          # AC02: AC20's
_SMOOTH[8] = (_SMOOTH[7][0].T, None)                 # AC21: AC12's
_SMOOTH[9] = (_SMOOTH[6][0].T, None)                 # AC30: AC03's
_SMOOTH_DC = _k([-2, -6, -8, -6, -2], [-6, 6, 42, 6, -6],
                [-8, 42, 152, 42, -8], [-6, 6, 42, 6, -6],
                [-2, -6, -8, -6, -2])


def _smooth(cf: np.ndarray, q: np.ndarray, cur: list, prev: list,
            frame: Frame, comp: Component, last_good: int) -> None:
    """jdcoefct.c's decompress_smooth_data on one component's coefficients
    (in place): each AC 1..9 still zero and not known exact gets an
    estimate from the DC values around its block, clamped below 1 << Al
    where it was sent to Al > 0; where no AC 1..9 was ever sent the DC is
    re-estimated too. Rows of blocks past the last iMCU row the last scan
    decoded with data take the progression before that scan. The
    neighbours are libjpeg's, quirks included: rows by the iMCU row
    arithmetic (a padding row can be read), columns by its sliding
    registers (edges repeated)."""
    hmax, vmax, _, total = frame.grid
    v = comp.v
    hib = -(-(-(-frame.height * v // vmax)) // 8)
    wib = -(-(-(-frame.width * comp.h // hmax)) // 8)
    t = np.arange(hib)
    m = t // v
    br = np.where(m < total - 1, v, hib - (total - 1) * v)
    ibr, ibrs = m * br + t % v, br * total
    prev_r = np.where(ibr > 0, t - 1, t)
    next_r = np.where(ibr < ibrs - 1, t + 1, t)
    rows = [np.where(ibr > 1, t - 2, prev_r), prev_r, t, next_r,
            np.where(ibr < ibrs - 2, t + 2, next_r)]
    regs, cols = [0] * 5, []
    for b in range(wib):
        if b == 0 and wib > 1:
            regs[3] = regs[4] = 1
        if b + 1 < wib - 1:
            regs[4] = b + 2
        cols.append(list(regs))
        regs = regs[1:] + regs[4:]
    cols = np.array(cols)
    dc = cf[..., 0]
    D = np.stack([np.stack([dc[r][:, cols[:, j]] for j in range(5)])
                  for r in rows])                      # (5, 5, hib, wib)
    ws = cf[:hib, :wib].copy()
    q00 = int(q[0])
    good = (m <= last_good)[:, None]
    for latch, sel in ((cur, good), (prev, ~good)):
        if not sel.any():
            continue
        change_dc = all(latch[k] == -1 for k in range(1, 10))
        for k in range(1, 10):
            al = latch[k]
            kern = _SMOOTH[k][0 if change_dc else 1]
            if al == 0 or kern is None:
                continue
            num = q00 * np.tensordot(kern, D, ([0, 1], [0, 1]))
            qk = int(q[k])
            pred = (qk * 128 + np.abs(num)) // (qk * 256)
            if al > 0:
                pred = np.minimum(pred, (1 << al) - 1)
            pred = _w16(np.where(num >= 0, pred, -pred))
            ws[..., k] = np.where(sel & (cf[:hib, :wib, k] == 0), pred,
                                  ws[..., k])
        if change_dc:
            num = q00 * np.tensordot(_SMOOTH_DC, D, ([0, 1], [0, 1]))
            pred = (q00 * 128 + np.abs(num)) // (q00 * 256)
            pred = _w16(np.where(num >= 0, pred, -pred))
            ws[..., 0] = np.where(sel, pred, ws[..., 0])
    cf[:hib, :wib] = ws


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


def _plane(cf: np.ndarray, q: np.ndarray, idct=None) -> np.ndarray:
    """A component's MCU-padded blocks (zig-zag coefficients) -> its
    samples through `idct` (the 8-bit islow IDCT unless given), (8 by,
    8 bx)."""
    by, bx, _ = cf.shape
    nat = np.empty_like(cf)
    nat[..., ZIGZAG] = cf
    qn = np.empty_like(q)
    qn[ZIGZAG] = q
    px = (idct or idct_islow)(nat.reshape(-1, 8, 8), qn.reshape(8, 8))
    return px.reshape(by, bx, 8, 8).transpose(0, 2, 1, 3).reshape(
        by * 8, bx * 8)


def idct_islow12(coefs: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """(N, 8, 8) quantized coefficients (natural order) -> (N, 8, 8)
    12-bit samples, as libjpeg-turbo's jpeg12_idct_islow gives them (C
    arithmetic, PASS1_BITS 1; the post-IDCT range table: -2048..2047 to
    0..4095, clamped within a quarter turn of the 16384 wrap)."""
    c = coefs.astype(np.int64) * qt.astype(np.int64)
    ws = np.swapaxes(_idct_1d(np.swapaxes(c, 1, 2), CONST_BITS - 1, False),
                     1, 2)
    x = _idct_1d(ws, CONST_BITS + 1 + 3, False) & 16383
    return np.where(x < 2048, x + 2048, np.where(
        x < 8192, 4095, np.where(x < 14336, 0, x - 14336)))


def decode_jpeg12_grey(blob: bytes, path: str) -> np.ndarray:
    """A one-component 12-bit JPEG, DCT or lossless (what libtiff's JPEG
    codec hands Pillow for a 12-bit TIFF) -> (H, W) int64 samples
    0..4095."""
    frame, coefs, qts = _decode(blob, path, precision=12)
    if len(frame.comps) != 1:
        raise ValueError(f"{path}: 12-bit JPEG of {len(frame.comps)} "
                         "components in a grey TIFF: libtiff refuses it "
                         "(JPEGPreDecode: Improper JPEG component count)")
    if frame.lossless:
        return coefs[0][:frame.height, :frame.width].astype(np.int64)
    px = _plane(coefs[0], qts[0], idct_islow12)
    return px[:frame.height, :frame.width]


def raw_planes(blob: bytes, path: str = "<JPEG bytes>"
               ) -> Tuple[Frame, List[np.ndarray]]:
    """The frame and each component's samples as jpeg_read_raw_data gives
    them (libtiff's old-style JPEG reads so): the islow IDCT of every
    MCU-padded block, no upsampling, no colour conversion."""
    frame, coefs, qts = _decode(blob, path)
    if frame.lossless:
        raise ValueError(f"{path}: a lossless JPEG has no raw DCT planes")
    return frame, [_plane(cf, q).astype(np.uint8) for cf, q in zip(coefs,
                                                                   qts)]


def decode_jpeg(blob: bytes, path: str = "<JPEG bytes>",
                convert: bool = True) -> np.ndarray:
    """read_jpeg of a file's bytes; `path` names it in errors. With
    convert=False three components come out as decoded, with no colour
    conversion (libjpeg's JCS_UNKNOWN output, as libtiff asks for it for a
    JPEG-compressed TIFF that is not YCbCr)."""
    frame, coefs, qts = _decode(blob, path)
    comps = frame.comps
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    planes = []
    for i, c in enumerate(comps):
        fh, fv = hmax // c.h, vmax // c.v
        if frame.lossless:          # samples; jdsample.c replicates them
            up = np.repeat(np.repeat(coefs[i].astype(np.int32), fv, 0), fh,
                           1)
        else:
            px = _plane(coefs[i], qts[i])
            dh = -(-frame.height * c.v // vmax)
            dw = -(-frame.width * c.h // hmax)
            up = _upsample(px[:dh, :dw].astype(np.int32), fh, fv)
        planes.append(up[:frame.height, :frame.width])
    if len(planes) == 1:
        return np.repeat(planes[0].astype(np.uint8)[..., None], 3, axis=2)
    if len(planes) == 4:
        return cmyk_to_rgb(planes, frame.ycck)
    if frame.rgb or not convert:
        return np.stack(planes, -1).astype(np.uint8)
    return ycc_to_rgb(*planes)
