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
    one code early), Deflate (8 and 32946), PackBits and JPEG (7, its
    JPEGTables spliced before each strip or tile, decoded by data/jpeg.py
    with libtiff's colour request: YCbCr turned into RGB, anything else
    left as coded), with the horizontal predictor (2) on 8-, 16- and
    32-bit samples;
  - the modes of Pillow's OPEN_INFO table: bilevel, grey at 1, 2, 4, 8,
    16 and 32 bits (min-is-black and min-is-white), float grey, grey +
    alpha, RGB at 8 and 16 bits with unused, unassociated or associated
    (premultiplied) extra samples, palettes at 1, 2, 4 and 8 bits, CMYK
    at 8 and 16 bits; big-endian signed and float grey of a compressed
    file byte-swapped, as Pillow unpacks libtiff's native samples with
    its big-endian raw mode;
  - the Orientation tag, applied as Pillow's load applies it
    (ImageOps.exif_transpose).
convert("RGB") as Pillow gives it: grey replicated, 16- and 32-bit grey
clipped to 0..255, float grey clipped and truncated, 16-bit colour's high
byte, associated alpha divided out (CLIP8(v * 255 / a)), other alpha
dropped, palettes looked up (ColorMap // 256, black past the end), CMYK
by Pillow's cmyk2rgb. What Pillow does not open raises with its reason;
what it opens and the port does not decode yet (CCITT, old-style JPEG,
LZMA, ZSTD, WebP, YCbCr without JPEG, CIELAB, the float predictor)
raises naming it.
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, NamedTuple, Tuple

import numpy as np

from . import jpeg

# tag numbers
_WIDTH, _LENGTH, _BPS, _COMPRESSION, _PHOTO = 256, 257, 258, 259, 262
_FILLORDER, _STRIPS, _ORIENTATION, _SPP, _ROWS = 266, 273, 274, 277, 278
_STRIP_BYTES, _PLANAR, _PREDICTOR, _COLORMAP = 279, 284, 317, 320
_TILE_W, _TILE_L, _TILES, _TILE_BYTES = 322, 323, 324, 325
_EXTRA, _SAMPLE_FORMAT, _JPEG_TABLES = 338, 339, 347

# type -> (struct code, bytes an item)
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8),
          6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8),
          11: ("f", 4), 12: ("d", 8), 13: ("I", 4), 16: ("Q", 8),
          17: ("q", 8), 18: ("Q", 8)}

_COMPRESSIONS = {1: "raw", 2: "CCITT RLE", 3: "CCITT Group 3",
                 4: "CCITT Group 4", 5: "LZW", 6: "old-style JPEG",
                 7: "JPEG", 8: "Deflate", 32771: "raw 16", 32773: "PackBits",
                 32809: "ThunderScan", 32946: "Deflate", 34676: "SGILog",
                 34677: "SGILog24", 34925: "LZMA", 50000: "ZSTD",
                 50001: "WebP"}
_READ = (1, 5, 7, 8, 32773, 32946)
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
    if data[:2] == b"\x00\x01":
        raise ValueError(f"{path}: old-style (LSB-first) TIFF LZW is not "
                         "decoded by the port yet")
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


def _inflate(t: _Tiff, raw: bytes, need: int, path: str) -> bytes:
    if t.fillorder == 2 and t.compression != 1:
        raw = _REVERSED[np.frombuffer(raw, np.uint8)].tobytes()
    if t.compression == 1:
        out = raw
    elif t.compression == 5:
        out = lzw_decode(raw, need, path)
    elif t.compression in (8, 32946):
        d = zlib.decompressobj()
        try:
            out = d.decompress(raw, need)
        except zlib.error as e:
            raise ValueError(f"{path}: corrupt TIFF Deflate data ({e})") \
                from None
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
    fmt = t.tags.get(_SAMPLE_FORMAT, (1,))[0]
    kind = {1: "u", 2: "i", 3: "f"}[fmt]
    dt = np.dtype(f"{t.order}{kind}{bits // 8}")
    px = np.frombuffer(data, dt, rows * cols * spp).reshape(rows, cols * spp)
    if predictor == 2:
        px = _unpredict(px.view(f"{t.order}u{bits // 8}"), spp).view(dt)
    return px.astype(dt.newbyteorder("=")).reshape(rows, cols, spp)


def _jpeg_chunk(t: _Tiff, raw: bytes, path: str) -> np.ndarray:
    """A JPEG strip or tile, its tables spliced before it -> (rows, cols,
    samples) uint8 as libtiff hands them over."""
    tables = t.tags.get(_JPEG_TABLES, (b"",))[0]
    if tables[:2] == b"\xff\xd8" and raw[:2] == b"\xff\xd8":
        raw = tables[:-2] + raw[2:] if tables[-2:] == b"\xff\xd9" \
            else tables + raw[2:]
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
    if t.compression in (1, 7, 32773):
        predictor = 1                  # libtiff applies it to LZW and Deflate
    if predictor not in (1, 2):
        raise ValueError(f"{path}: TIFF predictor {predictor} is not decoded "
                         "by the port yet")
    if predictor == 2 and t.bps[0] < 8:
        raise ValueError(f"{path}: TIFF horizontal predictor on "
                         f"{t.bps[0]}-bit samples (libtiff refuses it)")
    out = None
    tiled = _TILES in t.tags
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
                    px = _jpeg_chunk(t, raw, path)
                    if px.shape[0] < rows or px.shape[1] < cw:
                        raise ValueError(f"{path}: TIFF JPEG chunk of "
                                         f"{px.shape[:2]}, expected "
                                         f"{(rows, cw)}")
                    px = px[:rows, :cw]
                else:
                    row = (cw * per * t.bps[0] + 7) // 8
                    data = _inflate(t, raw, rows * row, path)
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
    elif mode in ("RGB", "RGBA"):
        rgb = s[..., :3].astype(np.uint8)
        if raw.startswith("RGBa"):               # associated alpha
            a = s[..., 3:4].astype(np.int64)
            div = np.minimum(255, rgb.astype(np.int64) * 255
                             // np.maximum(a, 1))
            rgb = np.where(a == 0, 0, np.where(a == 255, rgb, div)).astype(
                np.uint8)
        return np.ascontiguousarray(rgb)
    else:
        raise ValueError(f"{path}: {mode} TIFF is not decoded by the port yet")
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
    if t.compression not in _READ:
        name = _COMPRESSIONS.get(t.compression, f"compression "
                                 f"{t.compression}")
        raise ValueError(f"{path}: {name} TIFF is not decoded by the port "
                         "yet")
    if t.mode == "LAB":
        raise ValueError(f"{path}: CIELAB TIFF is not decoded by the port "
                         "yet")
    if t.photo == 6 and len(t.bps) == 3 and (t.compression != 7
                                             or t.planar != 1):
        raise ValueError(f"{path}: YCbCr TIFF without JPEG compression is "
                         "not decoded by the port yet")
    if t.compression == 1 and t.rawmode in _NO_UNPACKER:
        raise ValueError(f"{path}: uncompressed TIFF in raw mode {t.rawmode}"
                         " (FillOrder 2): Pillow has no unpacker for it and "
                         "refuses it")
    if t.rawmode == "I;12":
        raise ValueError(f"{path}: 12-bit TIFF is not decoded by the port "
                         "yet")
    if t.compression == 7 and t.bps[0] != 8:
        raise ValueError(f"{path}: JPEG TIFF of {t.bps[0]}-bit samples is "
                         "not decoded by the port yet")
    samples = _decode_samples(t, blob, path)
    if t.compression != 1 and t.rawmode in _SWAPPED:
        samples = samples.byteswap()
    rgb = _to_rgb(t, samples, path)
    turn = _TRANSPOSE.get(t.tags.get(_ORIENTATION, (1,))[0])
    return np.ascontiguousarray(turn(rgb) if turn else rgb)


def read_tiff(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_tiff(f.read(), path)
