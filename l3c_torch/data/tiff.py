"""TIFF files as the JAX package's loader reads them: Pillow's
TiffImagePlugin opens the first image directory, decodes it through
libtiff (or its own raw decoder where the data is not compressed) and
convert("RGB") turns its mode into RGB.

Read here, as Pillow 12.1 with libtiff 4.7 reads them:
  - both byte orders, classic and (little-endian) BigTIFF, the first
    directory; a big-endian BigTIFF, which Pillow takes for a classic
    file, refused as Pillow refuses it;
  - strips and tiles, contiguous and planar (PlanarConfiguration 1 and
    2), FillOrder 1 and 2;
  - compression none, LZW (libtiff's: MSB first, the code width growing
    one code early; and its compat decoder of old-style LSB-first LZW),
    Deflate (8 and 32946), PackBits, LZMA (the standard library's xz
    reader), ZSTD (data/zstd.py), CCITT RLE, RLEW, Group 3 and Group 4
    (data/ccitt.py), ThunderScan (4-bit runs and deltas), old-style JPEG
    (6: libjpeg's raw planes of the JPEGInterchangeFormat stream or of one
    made from the table tags, then libtiff's YCbCr conversion) and JPEG (7,
    12-bit grey too through libjpeg's 12-bit islow IDCT; its
    JPEGTables spliced before each strip or tile, decoded by data/jpeg.py
    with libtiff's colour request: YCbCr turned into RGB, anything else
    left as coded), with the horizontal predictor (2) on 8-, 16- and
    32-bit samples and the floating-point predictor (3: byte planes,
    bytes differenced) on 16-, 24-, 32- and 64-bit floats;
  - YCbCr without JPEG compression as libtiff's RGBA interface converts
    it (Pillow reads it so): the YCbCrSubSampling blocks, then
    TIFFYCbCrToRGB's integer tables from the YCbCrCoefficients and
    ReferenceBlackWhite tags; an uncompressed one as Pillow's own decoder
    reads it (RGBX: four bytes a pixel, the first three kept; planar
    files band by band);
  - the modes of Pillow's OPEN_INFO table: bilevel, grey at 1, 2, 4, 8,
    12, 16 and 32 bits (min-is-black and min-is-white), float grey, grey +
    alpha, RGB at 8 and 16 bits with unused, unassociated or associated
    (premultiplied) extra samples, palettes at 1, 2, 4 and 8 bits, CMYK
    at 8 and 16 bits, CIELAB (LittleCMS's Lab -> sRGB, data/cielab.py);
    big-endian signed and float grey of a compressed
    file byte-swapped, as Pillow unpacks libtiff's native samples with
    its big-endian raw mode;
  - the Orientation tag, applied as Pillow's load applies it
    (ImageOps.exif_transpose).
convert("RGB") as Pillow gives it: grey replicated, 16- and 32-bit grey
clipped to 0..255, float grey clipped and truncated, 16-bit colour's high
byte, associated alpha divided out (CLIP8(v * 255 / a)), other alpha
dropped, palettes looked up (ColorMap // 256, black past the end), CMYK
by Pillow's cmyk2rgb. What Pillow does not open or load raises with its
reason (LogL / LogLuv, whose photometrics Pillow has no mode for, and
SGILog of any other; WebP, which this libtiff build lacks).
"""
from __future__ import annotations

import lzma
import struct
import zlib
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np

from . import ccitt, cielab, jpeg, zstd

# tag numbers
_WIDTH, _LENGTH, _BPS, _COMPRESSION, _PHOTO = 256, 257, 258, 259, 262
_FILLORDER, _STRIPS, _ORIENTATION, _SPP, _ROWS = 266, 273, 274, 277, 278
_STRIP_BYTES, _PLANAR, _PREDICTOR, _COLORMAP = 279, 284, 317, 320
_TILE_W, _TILE_L, _TILES, _TILE_BYTES = 322, 323, 324, 325
_EXTRA, _SAMPLE_FORMAT, _JPEG_TABLES = 338, 339, 347
_T4OPTIONS, _YCC_COEFFS, _YCC_SUBSAMPLING, _REF_BW = 292, 529, 530, 532
# old-style JPEG's tags
_JIF, _JIF_LEN, _JPEG_RESTART = 513, 514, 515
_JPEG_QT, _JPEG_DC, _JPEG_AC = 519, 520, 521

# type -> (struct code, bytes an item)
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8),
          6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8),
          11: ("f", 4), 12: ("d", 8), 13: ("I", 4), 16: ("Q", 8),
          17: ("q", 8), 18: ("Q", 8)}

# the compressions Pillow 12.1 names (TiffImagePlugin.COMPRESSION_INFO); it
# cannot identify a file of any other
_COMPRESSIONS = frozenset((1, 2, 3, 4, 5, 6, 7, 8, 32771, 32773, 32809,
                           32946, 34676, 34677, 34925, 50000, 50001))
_CCITT = (2, 3, 4, 32771)
# codecs whose data libtiff runs the predictor over
_PREDICTED = (5, 8, 32946, 34925, 50000)
# raw modes of FillOrder 2 that Pillow's own (uncompressed) decoder cannot
# unpack; libtiff reverses the bits of compressed data itself
_NO_UNPACKER = {"L;IR", "P;1R", "P;2R", "P;4R", "RGB;R", "I;16R"}
# big-endian raw modes Pillow keeps for libtiff's output, which libtiff
# has already turned into native (little-endian) order: Pillow reads those
# samples byte-swapped
_SWAPPED = {"I;16BS", "F;32BF", "I;32BS"}

# Pillow 12.1's TiffImagePlugin.OPEN_INFO: (photometric, sample format,
# fill order, bits per sample, extra samples) -> (mode, raw mode), or a
# dict by byte order where the two differ
_OPEN_INFO = {
    (0, (1,), 1, (1,), ()): ("1", "1;I"),
    (0, (1,), 2, (1,), ()): ("1", "1;IR"),
    (1, (1,), 1, (1,), ()): ("1", "1"),
    (1, (1,), 2, (1,), ()): ("1", "1;R"),
    (0, (1,), 1, (2,), ()): ("L", "L;2I"),
    (0, (1,), 2, (2,), ()): ("L", "L;2IR"),
    (1, (1,), 1, (2,), ()): ("L", "L;2"),
    (1, (1,), 2, (2,), ()): ("L", "L;2R"),
    (0, (1,), 1, (4,), ()): ("L", "L;4I"),
    (0, (1,), 2, (4,), ()): ("L", "L;4IR"),
    (1, (1,), 1, (4,), ()): ("L", "L;4"),
    (1, (1,), 2, (4,), ()): ("L", "L;4R"),
    (0, (1,), 1, (8,), ()): ("L", "L;I"),
    (0, (1,), 2, (8,), ()): ("L", "L;IR"),
    (1, (1,), 1, (8,), ()): ("L", "L"),
    (1, (2,), 1, (8,), ()): ("L", "L"),
    (1, (1,), 2, (8,), ()): ("L", "L;R"),
    (1, (1,), 1, (12,), ()): {"<": ("I;16", "I;12")},
    (0, (1,), 1, (16,), ()): {"<": ("I;16", "I;16")},
    (1, (1,), 1, (16,), ()): {"<": ("I;16", "I;16"), ">": ("I;16B", "I;16B")},
    (1, (1,), 2, (16,), ()): {"<": ("I;16", "I;16R")},
    (1, (2,), 1, (16,), ()): {"<": ("I", "I;16S"), ">": ("I", "I;16BS")},
    (0, (3,), 1, (32,), ()): {"<": ("F", "F;32F"), ">": ("F", "F;32BF")},
    (1, (1,), 1, (32,), ()): {"<": ("I", "I;32N")},
    (1, (2,), 1, (32,), ()): {"<": ("I", "I;32S"), ">": ("I", "I;32BS")},
    (1, (3,), 1, (32,), ()): {"<": ("F", "F;32F"), ">": ("F", "F;32BF")},
    (1, (1,), 1, (8, 8), (2,)): ("LA", "LA"),
    (2, (1,), 1, (8, 8, 8), ()): ("RGB", "RGB"),
    (2, (1,), 2, (8, 8, 8), ()): ("RGB", "RGB;R"),
    (2, (1,), 1, (8, 8, 8, 8), ()): ("RGBA", "RGBA"),
    (2, (1,), 1, (8, 8, 8, 8), (0,)): ("RGB", "RGBX"),
    (2, (1,), 1, (8, 8, 8, 8, 8), (0, 0)): ("RGB", "RGBXX"),
    (2, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0, 0)): ("RGB", "RGBXXX"),
    (2, (1,), 1, (8, 8, 8, 8), (1,)): ("RGBA", "RGBa"),
    (2, (1,), 1, (8, 8, 8, 8, 8), (1, 0)): ("RGBA", "RGBaX"),
    (2, (1,), 1, (8, 8, 8, 8, 8, 8), (1, 0, 0)): ("RGBA", "RGBaXX"),
    (2, (1,), 1, (8, 8, 8, 8), (2,)): ("RGBA", "RGBA"),
    (2, (1,), 1, (8, 8, 8, 8, 8), (2, 0)): ("RGBA", "RGBAX"),
    (2, (1,), 1, (8, 8, 8, 8, 8, 8), (2, 0, 0)): ("RGBA", "RGBAXX"),
    (2, (1,), 1, (8, 8, 8, 8), (999,)): ("RGBA", "RGBA"),
    (2, (1,), 1, (16, 16, 16), ()): ("RGB", "RGB;16"),
    (2, (1,), 1, (16, 16, 16, 16), ()): ("RGBA", "RGBA;16"),
    (2, (1,), 1, (16, 16, 16, 16), (0,)): ("RGB", "RGBX;16"),
    (2, (1,), 1, (16, 16, 16, 16), (1,)): ("RGBA", "RGBa;16"),
    (2, (1,), 1, (16, 16, 16, 16), (2,)): ("RGBA", "RGBA;16"),
    (3, (1,), 1, (1,), ()): ("P", "P;1"),
    (3, (1,), 2, (1,), ()): ("P", "P;1R"),
    (3, (1,), 1, (2,), ()): ("P", "P;2"),
    (3, (1,), 2, (2,), ()): ("P", "P;2R"),
    (3, (1,), 1, (4,), ()): ("P", "P;4"),
    (3, (1,), 2, (4,), ()): ("P", "P;4R"),
    (3, (1,), 1, (8,), ()): ("P", "P"),
    (3, (1,), 1, (8, 8), (0,)): ("P", "PX"),
    (3, (1,), 1, (8, 8), (2,)): ("PA", "PA"),
    (3, (1,), 2, (8,), ()): ("P", "P;R"),
    (5, (1,), 1, (8, 8, 8, 8), ()): ("CMYK", "CMYK"),
    (5, (1,), 1, (8, 8, 8, 8, 8), (0,)): ("CMYK", "CMYKX"),
    (5, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0)): ("CMYK", "CMYKXX"),
    (5, (1,), 1, (16, 16, 16, 16), ()): ("CMYK", "CMYK;16"),
    (6, (1,), 1, (8,), ()): ("L", "L"),
    (6, (1,), 1, (8, 8, 8), ()): ("RGB", "RGBX"),
    (8, (1,), 1, (8, 8, 8), ()): ("LAB", "LAB"),
}


class _Tiff(NamedTuple):
    order: str                  # "<" or ">"
    tags: Dict[int, tuple]
    width: int
    height: int
    mode: str                   # Pillow's
    rawmode: str
    compression: int
    photo: int
    planar: int
    bps: Tuple[int, ...]
    fillorder: int


def _directory(blob: bytes, path: str) -> Tuple[str, Dict[int, tuple]]:
    """The header and the first image directory -> (byte order, tag ->
    its values). Entries of unknown type or whose data lies past the end
    of the file are left out, as Pillow leaves them out."""
    order = {b"II": "<", b"MM": ">"}.get(blob[:2])
    if order is None or len(blob) < 8:
        raise ValueError(f"{path}: not a TIFF file")
    big = blob[2] == 43         # Pillow's test: a big-endian BigTIFF fails
    if big:
        at = struct.unpack(order + "Q", blob[8:16])[0]
        count_fmt, entry, value_size = "Q", 20, 8
    else:
        at = struct.unpack(order + "I", blob[4:8])[0]
        count_fmt, entry, value_size = "H", 12, 4
    head = struct.calcsize(count_fmt)
    if at + head > len(blob):
        raise ValueError(f"{path}: truncated TIFF directory")
    n = struct.unpack(order + count_fmt, blob[at:at + head])[0]
    at += head
    tags: Dict[int, tuple] = {}
    for i in range(n):
        e = blob[at + i * entry:at + (i + 1) * entry]
        if len(e) < entry:
            raise ValueError(f"{path}: truncated TIFF directory")
        tag, typ = struct.unpack(order + "HH", e[:4])
        count = struct.unpack(order + ("Q" if big else "I"),
                              e[4:4 + value_size])[0]
        if typ not in _TYPES:
            continue
        code, size = _TYPES[typ]
        nbytes = size * count
        if nbytes <= value_size:
            data = e[4 + value_size:4 + value_size + nbytes]
        else:
            off = struct.unpack(order + ("Q" if big else "I"),
                                e[4 + value_size:])[0]
            data = blob[off:off + nbytes]
            if len(data) < nbytes:
                continue
        if typ in (2, 7):
            tags[tag] = (data,)
        else:
            v = struct.unpack(order + code * count, data)
            if typ in (5, 10):
                v = tuple(v[j] / v[j + 1] if v[j + 1] else float("nan")
                          for j in range(0, len(v), 2))
            tags[tag] = v
    return order, tags


def _parse(blob: bytes, path: str) -> _Tiff:
    """TiffImagePlugin._setup on the first directory: the mode and raw
    mode from OPEN_INFO, refusing what Pillow refuses."""
    order, tags = _directory(blob, path)
    one = lambda t, d: tags[t][0] if t in tags else d
    compression = one(_COMPRESSION, 1)
    if compression not in _COMPRESSIONS:
        raise ValueError(f"{path}: TIFF of compression {compression}, which "
                         "Pillow has no codec for (it cannot identify the "
                         "file either)")
    planar = one(_PLANAR, 1)
    photo = one(_PHOTO, 0)
    if compression == 6:
        photo = 6
    fillorder = one(_FILLORDER, 1)
    if _WIDTH not in tags or _LENGTH not in tags:
        raise ValueError(f"{path}: TIFF without dimensions (Pillow: Missing "
                         "dimensions)")
    w, h = tags[_WIDTH][0], tags[_LENGTH][0]
    fmt = tags.get(_SAMPLE_FORMAT, (1,))
    if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
        fmt = (1,)
    bps = tags.get(_BPS, (1,))
    extra = tags.get(_EXTRA, ())
    spp = one(_SPP, 3 if compression == 6 and photo in (2, 6) else 1)
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise ValueError(f"{path}: TIFF of unknown data organization")
    info = _OPEN_INFO.get((photo, fmt, fillorder, bps, extra))
    if isinstance(info, dict):
        info = info.get(order)
    if info is None:
        raise ValueError(f"{path}: TIFF of unknown pixel mode (photometric "
                         f"{photo}, samples {bps}, extra {extra}; Pillow "
                         "does not open it either)")
    mode, rawmode = info
    if compression != 1 and fillorder == 2:      # libtiff reverses the bits
        info = _OPEN_INFO[(photo, fmt, 1, bps, extra)]
        mode, rawmode = info if not isinstance(info, dict) else info[order]
    if w < 1 or h < 1:
        raise ValueError(f"{path}: empty image {w}x{h}")
    return _Tiff(order, tags, w, h, mode, rawmode, compression, photo,
                 planar, bps, fillorder)


def tiff_header(blob: bytes, path: str) -> Tuple[str, int, int]:
    """(Pillow's mode, height, width) of a TIFF's bytes, the size as
    Pillow gives it (turned where the Orientation tag turns it)."""
    t = _parse(blob, path)
    if t.tags.get(_ORIENTATION, (1,))[0] in (5, 6, 7, 8):
        return t.mode, t.width, t.height
    return t.mode, t.height, t.width


# ------------------------------------------------------------ decompression

_REVERSED = np.array([int(f"{v:08b}"[::-1], 2) for v in range(256)],
                     np.uint8)


def lzw_decode(data: bytes, need: int, path: str) -> bytes:
    """libtiff's LZWDecode: up to `need` bytes of a TIFF LZW stream (codes
    MSB first, 256 clear, 257 end, the width growing when the next free
    code reaches 2^n - 1)."""
    if data[:1] == b"\0" and len(data) > 1 and data[1] & 1:
        return _lzw_compat(data, need, path)
    first = [bytes([v]) for v in range(256)]
    table = first + [b"", b""]
    out = bytearray()
    pos, nbits, size = 0, len(data) * 8, 9
    prev = None
    while len(out) < need:
        if pos + size > nbits:
            break
        i = pos >> 3
        c = (int.from_bytes(data[i:i + 3].ljust(3, b"\0"), "big")
             >> (24 - (pos & 7) - size)) & ((1 << size) - 1)
        pos += size
        if c == 256:
            table, size, prev = first + [b"", b""], 9, None
            continue
        if c == 257:
            break
        if prev is None:
            if c > 255:
                raise ValueError(f"{path}: corrupted TIFF LZW data")
            prev = table[c]
            out += prev
            continue
        nxt = len(table)
        if c > nxt:
            raise ValueError(f"{path}: corrupted TIFF LZW data")
        entry = table[c] if c < nxt else prev + prev[:1]
        out += entry
        if nxt >= 5119:              # libtiff's table: 4096 + 1023 spare
            raise ValueError(f"{path}: corrupted TIFF LZW table")
        table.append(prev + entry[:1])
        if nxt + 1 >= (1 << size) - 1 and size < 12:
            size += 1
        prev = entry
    return bytes(out)


def _lzw_compat(data: bytes, need: int, path: str) -> bytes:
    """libtiff's LZWDecodeCompat, for old-style TIFF LZW (its stream
    starts with a clear code written LSB first): codes LSB first, the
    width growing once the next free entry passes 2^n - 1; a stream that
    stops short of a code ends as at an end code."""
    first = [bytes([v]) for v in range(256)]
    table = first + [b"", b""]
    out = bytearray()
    acc, nacc, at = 0, 0, 0
    size, maxcode = 9, 511
    left = len(data) * 8
    prev = None
    while len(out) < need:
        if left < size:
            break
        while nacc < size:
            acc |= data[at] << nacc
            at += 1
            nacc += 8
        c = acc & ((1 << size) - 1)
        acc >>= size
        nacc -= size
        left -= size
        if c == 257:
            break
        if c == 256:
            table, size, maxcode, prev = first + [b"", b""], 9, 511, None
            continue
        if prev is None:
            if c > 256:
                raise ValueError(f"{path}: corrupted TIFF LZW table")
            prev = table[c]
            out += prev
            continue
        nxt = len(table)
        if nxt >= 4096:
            raise ValueError(f"{path}: corrupted TIFF LZW table")
        if c > nxt:
            raise ValueError(f"{path}: corrupted TIFF LZW data")
        entry = table[c] if c < nxt else prev + prev[:1]
        table.append(prev + entry[:1])
        if len(table) > maxcode:
            size = min(size + 1, 12)
            maxcode = (1 << size) - 1
        out += entry
        prev = entry
    return bytes(out)


def packbits_decode(data: bytes, need: int) -> bytes:
    """PackBits: n < 128 copies n + 1 bytes, n > 128 repeats the next byte
    257 - n times, 128 is a no-op."""
    out = bytearray()
    at = 0
    while len(out) < need and at < len(data):
        n = data[at]
        at += 1
        if n < 128:
            out += data[at:at + n + 1]
            at += n + 1
        elif n > 128:
            out += data[at:at + 1] * (257 - n)
            at += 1
    return bytes(out)


def thunderscan_decode(data: bytes, width: int, rows: int, path: str
                       ) -> bytes:
    """libtiff's ThunderDecode, row by row: 4-bit samples from a byte's
    two-bit code (a run of the last sample, three 2-bit or two 3-bit
    deltas, a raw sample) and six bits of data; a row must come out at its
    width exactly."""
    two, three = (0, 1, 0, -1), (0, 1, 2, 3, 0, -3, -2, -1)
    stride = (width + 1) // 2
    out = bytearray(stride * rows)
    at = 0
    for r in range(rows):
        op, n_px, last = r * stride, 0, 0

        def put(v):
            nonlocal last, n_px, op
            last = v & 15
            if n_px < width:
                if n_px & 1:
                    out[op] |= last
                    op += 1
                else:
                    out[op] = last << 4
                n_px += 1

        while at < len(data) and n_px < width:
            n = data[at]
            at += 1
            code = n & 0xC0
            if code == 0x00:                    # a run of the last sample
                n &= 0x3F
                if n_px & 1:
                    out[op] |= last
                    last = out[op]
                    op += 1
                    n_px += 1
                    n -= 1
                else:
                    last |= last << 4
                n_px += n
                if n_px <= width:
                    while n > 0:
                        out[op] = last
                        op += 1
                        n -= 2
                if n == -1:
                    op -= 1
                    out[op] &= 0xF0
                last &= 15
            elif code == 0x40:
                for sh in (4, 2, 0):
                    d = (n >> sh) & 3
                    if d != 2:
                        put(last + two[d])
            elif code == 0x80:
                for sh in (3, 0):
                    d = (n >> sh) & 7
                    if d != 4:
                        put(last + three[d])
            else:
                put(n)
        if n_px != width:
            raise ValueError(f"{path}: ThunderScan TIFF: "
                             f"{'not enough' if n_px < width else 'too much'}"
                             f" data at scanline {r} ({n_px} != {width})")
    return bytes(out)


def _inflate(t: _Tiff, raw: bytes, need: int, path: str, cw: int = 0,
             rows: int = 0, fax: Optional[dict] = None, off: int = 0
             ) -> bytes:
    if t.fillorder == 2 and t.compression != 1:
        raw = _REVERSED[np.frombuffer(raw, np.uint8)].tobytes()
    c = t.compression
    if c == 1:
        out = raw
    elif c == 5:
        out = lzw_decode(raw, need, path)
    elif c in (8, 32946):
        d = zlib.decompressobj()
        try:
            out = d.decompress(raw, need)
        except zlib.error as e:
            raise ValueError(f"{path}: corrupt TIFF Deflate data ({e})") \
                from None
    elif c == 34925:
        d = lzma.LZMADecompressor()
        try:
            out = d.decompress(raw, need)
        except lzma.LZMAError as e:
            raise ValueError(f"{path}: corrupt TIFF LZMA data ({e})") \
                from None
    elif c == 50000:
        out = zstd.decompress(raw, need)
    elif c in _CCITT:
        try:
            bits, _ = ccitt.decode(raw, cw, rows, c,
                                   t.tags.get(_T4OPTIONS, (0,))[0], fax,
                                   bool(off & 1))
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
        out = np.packbits(bits, axis=1).tobytes()
    elif c == 32809:
        out = thunderscan_decode(raw, cw, rows, path)
    else:
        out = packbits_decode(raw, need)
    if len(out) < need:
        raise ValueError(f"{path}: truncated TIFF data ({len(out)} of "
                         f"{need} bytes)")
    return out[:need]


def _unpredict(v: np.ndarray, spp: int) -> np.ndarray:
    """Undo the horizontal predictor on (rows, cols * spp) samples."""
    r, n = v.shape
    acc = v.reshape(r, n // spp, spp).astype(np.uint64).cumsum(1)
    return acc.astype(v.dtype).reshape(r, n)


def _samples(t: _Tiff, data: bytes, rows: int, cols: int, spp: int,
             predictor: int, path: str) -> np.ndarray:
    """A chunk's bytes -> (rows, cols, spp) samples: uint8 up to 8 bits,
    else unsigned, signed or float at the file's width, in native order."""
    bits = t.bps[0]
    if bits < 8:
        row = (cols * spp * bits + 7) // 8
        px = np.frombuffer(data, np.uint8, rows * row).reshape(rows, row)
        px = np.unpackbits(px, axis=1).reshape(rows, row * 8 // bits, bits)
        px = (px << np.arange(bits - 1, -1, -1, dtype=np.uint8)).sum(
            2, dtype=np.uint8)[:, :cols * spp]
        return px.reshape(rows, cols, spp)
    if bits == 12:              # Pillow's I;12 unpacker: MSB-first pairs
        row = (cols * spp * 12 + 7) // 8
        px = np.frombuffer(data, np.uint8, rows * row).reshape(rows, row)
        px = np.unpackbits(px, axis=1)[:, :cols * spp * 12].reshape(
            rows, cols * spp, 12)
        v = (px.astype(np.uint16) << np.arange(11, -1, -1, dtype=np.uint16)
             ).sum(2, dtype=np.uint16)
        return v.reshape(rows, cols, spp)
    fmt = t.tags.get(_SAMPLE_FORMAT, (1,))[0]
    kind = {1: "u", 2: "i", 3: "f"}[fmt]
    dt = np.dtype(f"{t.order}{kind}{bits // 8}")
    if predictor == 3:          # libtiff's fpAcc, row by row
        nb = bits // 8
        u = np.frombuffer(data, np.uint8, rows * cols * spp * nb).reshape(
            rows, cols * nb, spp)
        u = u.cumsum(1, dtype=np.uint64).astype(np.uint8).reshape(
            rows, nb, cols * spp)
        # byte planes, most significant first, whatever the file's order
        px = np.ascontiguousarray(u.transpose(0, 2, 1)).view(
            f">{kind}{nb}")[..., 0]
        return px.astype(dt.newbyteorder("=")).reshape(rows, cols, spp)
    px = np.frombuffer(data, dt, rows * cols * spp).reshape(rows, cols * spp)
    if predictor == 2:
        px = _unpredict(px.view(f"{t.order}u{bits // 8}"), spp).view(dt)
    return px.astype(dt.newbyteorder("=")).reshape(rows, cols, spp)


def _table_defs(stream: bytes, defs: dict) -> None:
    """Each table that the DQT and DHT segments of a JPEG stream define
    before its first SOS, as a segment of its own in `defs`, keyed by
    (marker, table): a later definition replaces an earlier one, as in
    libjpeg's one decoder object."""
    at = 2
    while at + 4 <= len(stream) and stream[at] == 0xFF:
        marker = stream[at + 1]
        n = struct.unpack(">H", stream[at + 2:at + 4])[0]
        if marker == 0xDA:
            break
        seg, k = stream[at + 4:at + 2 + n], 0
        while marker in (0xDB, 0xC4) and k < len(seg):
            if marker == 0xDB:          # Pq|Tq, 64 bytes or 64 words
                size, key = 1 + (128 if seg[k] >> 4 else 64), seg[k] & 15
            else:                       # Tc|Th, 16 counts, their values
                size, key = 17 + sum(seg[k + 1:k + 17]), seg[k]
            if k + size > len(seg):
                break                   # the strip's own decode says why
            part = seg[k:k + size]
            defs.pop((marker, key), None)
            defs[(marker, key)] = (b"\xff" + bytes([marker])
                                   + struct.pack(">H", 2 + size) + part)
            k += size
        at += 2 + n


def _jpeg_chunk(t: _Tiff, raw: bytes, path: str, kept: dict
                ) -> np.ndarray:
    """A JPEG strip or tile -> (rows, cols, samples) as libtiff hands them
    over: uint8, or 12-bit grey samples (libtiff's JPEG codec built for 12
    bits, jpeg12_*). libtiff reads every strip with one libjpeg object,
    so the JPEGTables and then the tables earlier strips defined (the
    latest of each, `kept`) stand before each strip's own. Its 12-bit
    packing writes sample pairs only: of an odd-width row the last sample
    stays what Pillow's strip buffer held (the previous strip's; zeros
    before the first)."""
    tables = t.tags.get(_JPEG_TABLES, (b"",))[0]
    if raw[:2] == b"\xff\xd8":
        defs = kept.setdefault("tables", {})
        old = b"".join(defs.values())
        _table_defs(raw, defs)
        if tables[:2] == b"\xff\xd8":
            head = tables[:-2] if tables[-2:] == b"\xff\xd9" else tables
            raw = head + old + raw[2:]
        elif old:
            raw = b"\xff\xd8" + old + raw[2:]
    if t.bps == (12,):
        px = jpeg.decode_jpeg12_grey(raw, path).astype(np.uint16)
        if px.shape[1] & 1:
            last = kept.get("last")
            px[:, -1] = 0
            if last is not None:
                n = min(len(last), len(px))
                px[:n, -1] = last[:n]
            kept["last"] = px[:, -1].copy()
        return px[..., None]
    px = jpeg.decode_jpeg(raw, path, convert=t.photo == 6)
    if t.bps == (8,):
        return px[..., :1]
    return px


def _chunks(t: _Tiff, path: str):
    """(offsets, byte counts, chunk width, chunk height) of the strips or
    tiles."""
    tags = t.tags
    if _TILES in tags:
        if _TILE_W not in tags or _TILE_L not in tags:
            raise ValueError(f"{path}: TIFF tiles without their size")
        return (tags[_TILES], tags.get(_TILE_BYTES), tags[_TILE_W][0],
                tags[_TILE_L][0])
    if _STRIPS in tags:
        rows = min(tags.get(_ROWS, (t.height,))[0], t.height)
        return tags[_STRIPS], tags.get(_STRIP_BYTES), t.width, rows
    raise ValueError(f"{path}: TIFF without strips or tiles (Pillow: "
                     "unknown data organization)")


def _decode_samples(t: _Tiff, blob: bytes, path: str) -> np.ndarray:
    """(H, W, spp) samples of the whole image."""
    offsets, counts, cw, ch = _chunks(t, path)
    spp = len(t.bps)
    planes = spp if t.planar == 2 else 1
    per = spp // planes                           # samples a chunk's pixel
    across, down = -(-t.width // cw), -(-t.height // ch)
    if len(offsets) < across * down * planes:
        raise ValueError(f"{path}: TIFF with {len(offsets)} strips or tiles"
                         f", expected {across * down * planes}")
    predictor = t.tags.get(_PREDICTOR, (1,))[0]
    if t.compression not in _PREDICTED:
        predictor = 1         # libtiff runs it for these codecs alone
    if predictor not in (1, 2, 3):
        raise ValueError(f"{path}: TIFF predictor {predictor} (libtiff: "
                         "\"Predictor\" value not supported)")
    if predictor == 2 and t.bps[0] not in (8, 16, 32, 64):
        raise ValueError(f"{path}: TIFF horizontal predictor on "
                         f"{t.bps[0]}-bit samples (libtiff refuses it)")
    if predictor == 3 and (t.bps[0] not in (16, 24, 32, 64) or t.tags.get(
            _SAMPLE_FORMAT, (1,))[0] != 3):
        raise ValueError(f"{path}: TIFF floating-point predictor on "
                         f"{t.bps[0]}-bit non-float samples (libtiff "
                         "refuses it)")
    sub = _subsampling(t, path) if t.photo == 6 and t.compression not in (
        1, 7) else None
    out = None
    tiled = _TILES in t.tags
    fax: dict = {}                 # libtiff's CCITT run arrays, kept
    kept: dict = {}                # what libjpeg and the strip buffer keep
    i = 0
    for p in range(planes):
        for ty in range(down):
            for tx in range(across):
                off = offsets[i]
                n = counts[i] if counts is not None and i < len(counts) \
                    else len(blob) - off
                i += 1
                rows = ch if tiled else min(ch, t.height - ty * ch)
                raw = blob[off:off + n]
                if t.compression == 7:
                    px = _jpeg_chunk(t, raw, path, kept)
                    if px.shape[0] < rows or px.shape[1] < cw:
                        raise ValueError(f"{path}: TIFF JPEG chunk of "
                                         f"{px.shape[:2]}, expected "
                                         f"{(rows, cw)}")
                    px = px[:rows, :cw]
                elif sub is not None and per == 3:
                    px = _ycbcr_blocks(t, raw, rows, cw, sub, predictor,
                                       path)
                else:
                    row = (cw * per * t.bps[0] + 7) // 8
                    data = _inflate(t, raw, rows * row, path, cw, rows,
                                    fax, off)
                    if t.compression == 1 and t.fillorder == 2:
                        data = _REVERSED[np.frombuffer(data, np.uint8)
                                         ].tobytes()
                    px = _samples(t, data, rows, cw, per, predictor, path)
                if out is None:
                    out = np.zeros((t.height, t.width, spp), px.dtype)
                y0, x0 = ty * ch, tx * cw
                hh, ww = min(rows, t.height - y0), min(cw, t.width - x0)
                out[y0:y0 + hh, x0:x0 + ww, p * per:(p + 1) * per] = \
                    px[:hh, :ww]
    return out


def _subsampling(t: _Tiff, path: str) -> Tuple[int, int]:
    """YCbCrSubSampling (libtiff's default 2, 2), as its RGBA reader
    accepts it."""
    h, v = (tuple(t.tags.get(_YCC_SUBSAMPLING, (2, 2))) + (2, 2))[:2]
    if (h, v) not in ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2),
                      (4, 4)) or (t.planar == 2 and (h, v) != (1, 1)):
        raise ValueError(f"{path}: YCbCr subsampling {h}x{v} "
                         f"(libtiff: cannot handle it)")
    return h, v


def _ycbcr_blocks(t: _Tiff, raw: bytes, rows: int, cw: int, sub,
                  predictor: int, path: str) -> np.ndarray:
    """A contiguous YCbCr chunk of h x v blocks (the Y samples, then Cb
    and Cr) -> (rows, cw, 3) Y, Cb, Cr, each pixel with its block's
    chroma. The horizontal predictor runs over libtiff's scanlines (a
    block row's bytes / v), three samples apart."""
    h, v = sub
    bx, by = -(-cw // h), -(-rows // v)
    need = bx * by * (h * v + 2)
    # libtiff reads (rows rounded up to v) scanlines of a block row's
    # bytes / v, rounded down: with v = 4 the last block can lose its
    # last bytes, which stay zero
    line = bx * (h * v + 2) // v
    data = np.frombuffer(_inflate(t, raw, by * v * line, path), np.uint8)
    if predictor == 2:
        data = _unpredict(data.reshape(-1, line), 3).ravel()
    data = np.concatenate([data, np.zeros(need - data.size, np.uint8)])
    data = data.reshape(by, bx, h * v + 2)
    y = data[..., :h * v].reshape(by, bx, v, h).transpose(0, 2, 1, 3)
    y = y.reshape(by * v, bx * h)[:rows, :cw]
    cb = np.repeat(np.repeat(data[..., h * v], v, 0), h, 1)[:rows, :cw]
    cr = np.repeat(np.repeat(data[..., h * v + 1], v, 0), h, 1)[:rows, :cw]
    return np.stack([y, cb, cr], -1)


def _ycbcr_to_rgb(t: _Tiff, s: np.ndarray) -> np.ndarray:
    """libtiff's TIFFYCbCrToRGBInit tables and TIFFYCbCrtoRGB, from the
    YCbCrCoefficients and ReferenceBlackWhite tags (float32 arithmetic,
    as libtiff's)."""
    f32 = np.float32
    luma = [f32(x) for x in (tuple(t.tags.get(_YCC_COEFFS, ()))
                             + (0.299, 0.587, 0.114)[len(
                                 t.tags.get(_YCC_COEFFS, ())):])[:3]]
    rbw = [f32(x) for x in (tuple(t.tags.get(_REF_BW, ())) + (
        0, 255, 128, 255, 128, 255)[len(t.tags.get(_REF_BW, ())):])[:6]]

    def fix(x):
        return int(float(x) * 65536 + 0.5)

    clamp = lambda f, lo, hi: min(max(f, lo), hi)
    f1 = f32(2) - f32(2) * luma[0]
    d1 = fix(clamp(f1, 0.0, 2.0))
    f2 = luma[0] * f1 / luma[1]
    d2 = -fix(clamp(f2, 0.0, 2.0))
    f3 = f32(2) - f32(2) * luma[2]
    d3 = fix(clamp(f3, 0.0, 2.0))
    f4 = luma[2] * f3 / luma[1]
    d4 = -fix(clamp(f4, 0.0, 2.0))

    def code2v(c, rb, rw, cr):
        den = (rw - rb) if rw - rb != 0 else f32(1)
        return f32(f32(f32(c - int(rb)) * f32(cr)) / f32(den))

    def clampw(f, lo, hi):
        return int(lo if f < lo else hi if f > hi else f)

    cr_r, cb_b, cr_g, cb_g, y_t = [], [], [], [], []
    for i, x in zip(range(256), range(-128, 128)):
        cr = clampw(code2v(x, rbw[4] - f32(128), rbw[5] - f32(128), 127),
                    -128.0 * 32, 128.0 * 32)
        cb = clampw(code2v(x, rbw[2] - f32(128), rbw[3] - f32(128), 127),
                    -128.0 * 32, 128.0 * 32)
        cr_r.append((d1 * cr + 32768) >> 16)
        cb_b.append((d3 * cb + 32768) >> 16)
        cr_g.append(d2 * cr)
        cb_g.append(d4 * cb + 32768)
        y_t.append(clampw(code2v(x + 128, rbw[0], rbw[1], 255),
                          -128.0 * 32, 128.0 * 32))
    tabs = [np.asarray(a, np.int64) for a in (cr_r, cb_b, cr_g, cb_g, y_t)]
    cr_r, cb_b, cr_g, cb_g, y_t = tabs
    yy = y_t[s[..., 0].astype(np.intp)]
    cb = s[..., 1].astype(np.intp)
    cr = s[..., 2].astype(np.intp)
    r = yy + cr_r[cr]
    g = yy + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = yy + cb_b[cb]
    return np.stack([np.clip(r, 0, 255), np.clip(g, 0, 255),
                     np.clip(b, 0, 255)], -1).astype(np.uint8)


def _clip8(v: np.ndarray) -> np.ndarray:
    return np.clip(v, 0, 255).astype(np.uint8)


def _to_rgb(t: _Tiff, s: np.ndarray, path: str) -> np.ndarray:
    """The samples as convert("RGB") gives Pillow's mode."""
    mode, raw = t.mode, t.rawmode.rstrip("R")    # R: FillOrder 2, undone
    if raw.endswith(";16") and mode in ("RGB", "RGBA", "CMYK"):
        s = (s >> 8).astype(np.uint8)
    if mode == "1":
        v = np.where(s[..., 0] > 0, 255, 0).astype(np.uint8)
        grey = 255 - v if raw == "1;I" else v
    elif mode == "L":
        bits = t.bps[0]
        v = s[..., 0].astype(np.uint8) * np.uint8(255 // ((1 << bits) - 1))
        grey = 255 - v if raw.endswith("I") else v
    elif mode in ("I;16", "I;16B", "I"):
        grey = _clip8(s[..., 0])
    elif mode == "F":
        with np.errstate(invalid="ignore"):
            v = s[..., 0].astype(np.float32)
            grey = np.where(np.isnan(v), 0, np.clip(v, 0, 255)).astype(
                np.uint8)
    elif mode == "LA":
        grey = s[..., 0].astype(np.uint8)
    elif mode in ("P", "PA"):
        cmap = t.tags.get(_COLORMAP)
        if cmap is None:
            raise ValueError(f"{path}: TIFF palette image without a ColorMap")
        n = len(cmap) // 3
        pal = (np.asarray(cmap[:3 * n], np.int64) // 256).astype(
            np.uint8).reshape(3, n).T
        lut = np.zeros((256, 3), np.uint8)
        lut[:min(n, 256)] = pal[:256]
        return lut[s[..., 0]]
    elif mode == "CMYK":
        px = s[..., :4].astype(np.int64)
        nk = 255 - px[..., 3:]
        return (nk - jpeg._muldiv255(px[..., :3], nk)).astype(np.uint8)
    elif mode == "LAB":
        return cielab.lab_to_rgb(s[..., :3].astype(np.uint8))
    elif mode in ("RGB", "RGBA"):
        rgb = s[..., :3].astype(np.uint8)
        if raw.startswith("RGBa"):               # associated alpha
            a = s[..., 3:4].astype(np.int64)
            div = np.minimum(255, rgb.astype(np.int64) * 255
                             // np.maximum(a, 1))
            rgb = np.where(a == 0, 0, np.where(a == 255, rgb, div)).astype(
                np.uint8)
        return np.ascontiguousarray(rgb)
    else:               # OPEN_INFO gives no other mode
        raise ValueError(f"{path}: TIFF of mode {mode}, which Pillow does "
                         "not open")
    return np.repeat(grey[..., None], 3, axis=2)


_TRANSPOSE = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1],
              4: lambda a: a[::-1], 5: lambda a: a.transpose(1, 0, 2),
              6: lambda a: np.rot90(a, -1),
              7: lambda a: a.transpose(1, 0, 2)[::-1, ::-1],
              8: lambda a: np.rot90(a, 1)}


def decode_tiff(blob: bytes, path: str = "<TIFF bytes>") -> np.ndarray:
    """(H, W, 3) uint8 RGB of a TIFF's first image, as Pillow's
    Image.open(...).convert("RGB") gives it."""
    t = _parse(blob, path)
    if t.compression == 50001:
        raise ValueError(f"{path}: WebP TIFF: Pillow's libtiff here is built"
                         " without it and refuses it (WEBP compression "
                         "support is not configured)")
    if t.compression in (34676, 34677):
        raise ValueError(f"{path}: SGILog TIFF of photometric {t.photo}: "
                         "libtiff refuses it (Inappropriate photometric "
                         "interpretation for SGILog compression; must be "
                         "either LogLUV or LogL, for which Pillow has no "
                         "mode)")
    if t.compression in _CCITT and t.bps != (1,):
        raise ValueError(f"{path}: CCITT TIFF of {t.bps} bits a sample "
                         "(libtiff: Bits/sample must be 1 for Group 3/4 "
                         "encoding/decoding)")
    if t.compression == 32809 and t.bps != (4,):
        raise ValueError(f"{path}: ThunderScan TIFF of {t.bps} bits a sample"
                         " (libtiff: Thunder decoder only supports 4bits "
                         "per sample)")
    if t.compression == 1 and t.rawmode in _NO_UNPACKER:
        raise ValueError(f"{path}: uncompressed TIFF in raw mode {t.rawmode}"
                         " (FillOrder 2): Pillow has no unpacker for it and "
                         "refuses it")
    if t.compression == 7 and t.bps not in ((12,),) and t.bps[0] != 8:
        raise ValueError(f"{path}: JPEG TIFF of {t.bps} samples: libtiff "
                         "reads 8- and 12-bit JPEG only (Pillow refuses it)")
    ycc = t.photo == 6 and len(t.bps) == 3 and t.compression != 7
    if t.compression == 6:
        rgb = _ojpeg(t, blob, path)
    elif ycc and t.compression == 1:
        rgb = _raw_rgbx(t, blob, path)
    else:
        samples = _decode_samples(t, blob, path)
        if t.compression != 1 and t.rawmode in _SWAPPED:
            samples = samples.byteswap()
        rgb = _ycbcr_to_rgb(t, samples) if ycc else _to_rgb(t, samples,
                                                             path)
    turn = _TRANSPOSE.get(t.tags.get(_ORIENTATION, (1,))[0])
    return np.ascontiguousarray(turn(rgb) if turn else rgb)


def _ojpeg_stream(t: _Tiff, blob: bytes, path: str) -> bytes:
    """The JPEG stream libtiff's OJPEG codec hands libjpeg: the
    JPEGInterchangeFormat bytes where the tag is set, else SOI, DQT, DHT,
    SOF0 and SOS made from the JPEGQTables / DCTables / ACTables tags and
    the YCbCrSubSampling; then the strips' bytes, and an EOI (libtiff's
    source manager ends the data with one)."""
    tags = t.tags
    strips = b"".join(blob[o:o + n] for o, n in zip(
        tags.get(_STRIPS, ()), tags.get(_STRIP_BYTES, ())))
    jif = tags.get(_JIF, (0,))[0]
    if 0 < jif < len(blob):
        n = tags.get(_JIF_LEN, (0,))[0]
        if not n or jif + n > len(blob):
            n = len(blob) - jif
        return blob[jif:jif + n] + strips + b"\xff\xd9"
    spp = len(t.bps)
    qts, dcs, acs = (tags.get(k, ()) for k in (_JPEG_QT, _JPEG_DC, _JPEG_AC))
    if len(qts) < spp or len(dcs) < spp or len(acs) < spp:
        raise ValueError(f"{path}: old-style JPEG TIFF without its tables "
                         "(libtiff refuses it)")
    out = bytearray(b"\xff\xd8")
    for i, off in enumerate(qts[:spp]):
        q = blob[off:off + 64]
        if len(q) < 64:
            raise ValueError(f"{path}: truncated old-style JPEG table")
        out += b"\xff\xdb\x00\x43" + bytes([i]) + q
    for cls, offs in ((0, dcs), (1, acs)):
        for i, off in enumerate(offs[:spp]):
            counts = blob[off:off + 16]
            n = sum(counts)
            vals = blob[off + 16:off + 16 + n]
            if len(counts) < 16 or len(vals) < n:
                raise ValueError(f"{path}: truncated old-style JPEG table")
            out += b"\xff\xc4" + struct.pack(">H", 3 + 16 + n) + \
                bytes([cls << 4 | i]) + counts + vals
    restart = tags.get(_JPEG_RESTART, (0,))[0]
    if restart:
        out += b"\xff\xdd\x00\x04" + struct.pack(">H", restart)
    h, v = _subsampling(t, path) if spp == 3 else (1, 1)
    out += b"\xff\xc0" + struct.pack(">HBHHB", 8 + 3 * spp, 8, t.height,
                                      t.width, spp)
    for i in range(spp):
        out += bytes([i + 1, (h << 4 | v) if i == 0 else 0x11, i])
    out += b"\xff\xda" + struct.pack(">HB", 6 + 2 * spp, spp)
    for i in range(spp):
        out += bytes([i + 1, i << 4 | i])
    out += b"\x00\x3f\x00"
    return bytes(out) + strips + b"\xff\xd9"


# the markers libtiff's OJPEGReadHeaderInfoSec walks past in a stream:
# SOI, COM, APP0-15, DRI, DQT, DHT, SOF0, SOF1, SOF3 and SOS
_OJPEG_MARKERS = {0xD8, 0xFE, 0xDD, 0xDB, 0xC4, 0xC0, 0xC1, 0xC3, 0xDA} | \
    set(range(0xE0, 0xF0))


def _ojpeg_refused(path: str, why: str) -> ValueError:
    return ValueError(f"{path}: old-style JPEG TIFF: {why} (libtiff refuses "
                      "it; Pillow: decoder error -2)")


def _ojpeg_header(stream: bytes, path: str) -> None:
    """OJPEGReadHeaderInfoSec's walk over the markers up to SOS: any other
    marker is refused."""
    at = 0
    while at + 1 < len(stream) and stream[at] == 0xFF:
        at += 1
        while at < len(stream) and stream[at] == 0xFF:
            at += 1
        if at >= len(stream):
            return
        m = stream[at]
        at += 1
        if m not in _OJPEG_MARKERS:
            raise _ojpeg_refused(path, "OJPEGReadHeaderInfoSec: Unknown "
                                 f"marker type {m} in JPEG data")
        if m == 0xDA:
            return
        if m != 0xD8:
            at += struct.unpack(">H", stream[at:at + 2].ljust(2, b"\0"))[0]


def _ojpeg(t: _Tiff, blob: bytes, path: str) -> np.ndarray:
    """An old-style JPEG TIFF as libtiff gives it to Pillow. libtiff takes
    photometric RGB for YCbCr; YCbCr (three samples) goes through its RGBA
    reader: libjpeg's raw planes (no upsampling), each pixel with its
    block's chroma, then TIFFYCbCrToRGB, the planes contiguous or
    separate alike; grey (one sample, MinIsBlack or MinIsWhite) is the
    component as libjpeg decodes it. What libtiff refuses, and three
    samples of another photometric, which Pillow's decoder fails, raise
    with the reason."""
    spp = len(t.bps)
    photo = t.tags.get(_PHOTO, (0,))[0]
    photo = 6 if photo == 2 else photo
    if photo == 6 and spp != 3:
        raise _ojpeg_refused(path, "TIFFVStripSize64: Invalid "
                             "td_samplesperpixel value; TIFFReadDirectory: "
                             "Cannot handle zero strip size")
    if spp == 3 and photo != 6:
        raise ValueError(f"{path}: old-style JPEG TIFF of three samples and "
                         f"photometric {photo}: Pillow's libtiff decode "
                         "fails (decoder error -2)")
    stream = _ojpeg_stream(t, blob, path)
    _ojpeg_header(stream, path)
    frame, planes = jpeg.raw_planes(stream, path)
    if frame.height < t.height:
        raise _ojpeg_refused(path, "OJPEGReadHeaderInfoSecStreamSof: JPEG "
                             "compressed data indicates unexpected height")
    if frame.width < t.width:
        raise _ojpeg_refused(path, "OJPEGReadHeaderInfoSecStreamSof: JPEG "
                             "compressed data indicates unexpected width")
    if frame.width > t.width:
        raise _ojpeg_refused(path, "OJPEGReadHeaderInfoSecStreamSof: JPEG "
                             "compressed data image width exceeds expected "
                             "image width")
    if len(planes) != spp:
        raise _ojpeg_refused(path, "OJPEGReadHeaderInfoSecStreamSof: JPEG "
                             "compressed data indicates unexpected number "
                             "of samples")
    comps = frame.comps
    if spp == 1:
        if (comps[0].h, comps[0].v) != (1, 1):
            raise _ojpeg_refused(path, "OJPEGReadHeaderInfoSecStreamSof: "
                                 "JPEG compressed data indicates unexpected "
                                 "subsampling values")
        return _to_rgb(t, planes[0][:t.height, :t.width, None], path)
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    if any((c.h, c.v) != (1, 1) for c in comps[1:]) or \
            comps[0].h not in (1, 2, 4) or comps[0].v not in (1, 2, 4):
        # libtiff leaves such sampling to libjpeg, then finds it unexpected
        if sum(c.h * c.v for c in comps) > 10:
            raise _ojpeg_refused(path, "LibJpeg: Sampling factors too large"
                                 " for interleaved scan")
        raise _ojpeg_refused(path, "OJPEGWriteHeaderInfo: "
                             "jpeg_start_decompress() returned "
                             f"max_h_samp_factor = {hmax} and "
                             f"max_v_samp_factor = {vmax}, expected 1 and 1")
    y = planes[0][:t.height, :t.width]
    up = [np.repeat(np.repeat(c, vmax, 0), hmax, 1)[:t.height, :t.width]
          for c in planes[1:]]
    return _ycbcr_to_rgb(t, np.stack([y] + up, -1))


def _raw_rgbx(t: _Tiff, blob: bytes, path: str) -> np.ndarray:
    """An uncompressed YCbCr TIFF as Pillow's own decoder reads it: its raw
    mode is RGBX, four bytes a pixel taken as R, G, B and a pad, from each
    strip's or tile's offset, its rows the unpacker's four bytes a pixel
    apart, or three a pixel where a tile overhangs the image (Pillow's
    stride); planar files band by band, R, G and B."""
    offsets, _, cw, ch = _chunks(t, path)
    out = np.zeros((t.height, t.width, 3), np.uint8)
    planar = t.planar == 2
    i = 0
    for layer in range(3 if planar else 1):
        for y in range(0, t.height, ch):
            for x in range(0, t.width, cw):
                if i >= len(offsets):
                    raise ValueError(f"{path}: TIFF with too few strips or "
                                     "tiles")
                off = offsets[i]
                i += 1
                ew, eh = min(cw, t.width - x), min(ch, t.height - y)
                n = 1 if planar else 4
                stride = cw * 3 // (3 if planar else 1) if x + cw > t.width \
                    else ew * n
                if len(blob) < off + stride * (eh - 1) + max(stride, 1):
                    raise ValueError(f"{path}: image file is truncated "
                                     "(Pillow reads an uncompressed YCbCr "
                                     "TIFF as RGBX)")
                for r in range(eh):
                    at = off + r * stride
                    row = np.frombuffer(blob[at:at + ew * n].ljust(ew * n,
                                                                  b"\0"),
                                        np.uint8)
                    if planar:
                        out[y + r, x:x + ew, layer] = row
                    else:
                        out[y + r, x:x + ew] = row.reshape(ew, 4)[:, :3]
    return out


def read_tiff(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_tiff(f.read(), path)
