"""The small raster formats Pillow opens, read as the JAX package's loader
reads them (Image.open(p).convert("RGB") under Pillow 12.1) (JPEG 2000
is in data/jpeg2000.py, ICNS in data/icns.py, AVIF in data/avif.py,
whose header is reachable from here too).

Each format's `*_header(blob, path)` gives (Pillow's mode, height,
width) from the bytes; `decode_*(blob, path)` gives (H, W, 3) uint8 RGB:
  - TGA: colour-mapped (8-bit indices, 15/16- and 24-bit maps; Pillow
    refuses 32-bit maps),
    true-colour 15/16, 24 and 32 bits, grey 8 and 16 bits (LA) and 1 bit,
    raw and RLE, the origin bits (bottom-up rows and right-to-left
    columns) as TgaImagePlugin reads them;
  - ICO: the entry Pillow picks (the largest, then the fewest colours),
    a PNG payload through read_png, a BMP payload through the BMP reader
    (mode RGBA: the AND mask or the 32-bit alpha becomes alpha and is
    dropped again); CUR: the entry CurImagePlugin picks, its bitmap in
    its own mode;
  - PCX: 1-bit, 2- and 4-plane 1-bit palettes (the header's 16 colours),
    8-bit grey or palette (the trailing 769 bytes), 24-bit in line-
    interleaved planes, PcxDecode's RLE; DCX: its first page;
  - SGI: 8- and 16-bit (the high byte) grey, RGB and RGBA, raw and RLE;
  - QOI, as QoiImagePlugin's Python decoder reads it;
  - IM: the 1, L, P (a Lut), LA, PA, RGB, RGBA, RGBX, CMYK and YCbCr
    types, and the numeric ones (8- to 32-bit integer and float grey);
    a Lut on grey or RGB values is left unapplied, as Pillow leaves it;
  - MSP: version 1 (raw) and 2 (RLE rows);
  - SUN: 1, 4 (grey), 8 (grey or palette), 24 and 32 bits, raw and RLE;
  - PSD: the merged composite of bitmap, grey, indexed, RGB(A), CMYK,
    multichannel, duotone and Lab files, raw and PackBits (a packet cut
    at the end of its row, as PackbitsDecode.c cuts it; the row counts
    and planes Pillow reads are those of its mode's channels); Lab
    through data/cielab.py's LittleCMS transform, an indexed file whose
    colour-mode data is not a 768-byte palette black, as Pillow's empty
    palette gives it.
DDS is in data/dds.py. Where Pillow refuses a file the port refuses it;
where Pillow reads one the port does not yet, it raises naming it.
"""
from __future__ import annotations

import re
import struct
from typing import List, Tuple

import numpy as np

from .avif import avif_header  # noqa: F401  (moved there)
from .cielab import lab_to_rgb
from .jpeg import _muldiv255


def _lut(pal: np.ndarray, start: int = 0) -> np.ndarray:
    """A 256-entry RGB table: `pal` (n, 3) from entry `start`, black
    elsewhere."""
    lut = np.zeros((256, 3), np.uint8)
    n = max(0, min(len(pal), 256 - start))
    lut[start:start + n] = pal[:n]
    return lut


def _grey(v: np.ndarray) -> np.ndarray:
    return np.repeat(v.astype(np.uint8)[..., None], 3, axis=2)


def _bits(data: bytes, rows: int, stride: int, w: int, bits: int
          ) -> np.ndarray:
    """(rows, w) samples of `bits` bits, MSB first, rows `stride` bytes."""
    px = np.frombuffer(data, np.uint8, rows * stride).reshape(rows, stride)
    if bits == 8:
        return px[:, :w].copy()
    px = np.unpackbits(px, axis=1).reshape(rows, stride * 8 // bits, bits)
    return (px << np.arange(bits - 1, -1, -1, dtype=np.uint8)).sum(
        2, dtype=np.uint8)[:, :w]


def _need(data: bytes, n: int, path: str, what: str) -> bytes:
    if len(data) < n:
        raise ValueError(f"{path}: truncated {what} ({len(data)} of {n} "
                         "bytes)")
    return data[:n]


def _cmyk(px: np.ndarray) -> np.ndarray:
    """Pillow's cmyk2rgb of (H, W, 4) CMYK samples."""
    px = px.astype(np.int64)
    nk = 255 - px[..., 3:]
    return (nk - _muldiv255(px[..., :3], nk)).astype(np.uint8)


# ------------------------------------------------------------------ TGA

_TGA_RAW = {(1, 8), (3, 1), (3, 8), (3, 16), (2, 16), (2, 24), (2, 32)}


def _tga(blob: bytes, path: str):
    if len(blob) < 18:
        raise ValueError(f"{path}: not a TGA file")
    id_len, maptype, itype = blob[0], blob[1], blob[2]
    w, h = struct.unpack("<HH", blob[12:16])
    depth, flags = blob[16], blob[17]
    if maptype not in (0, 1) or w <= 0 or h <= 0 or \
            depth not in (1, 8, 16, 24, 32):
        raise ValueError(f"{path}: not a TGA file")
    if itype in (3, 11):
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif itype in (1, 9):
        mode = "P" if maptype else "L"
    elif itype in (2, 10):
        mode = "RGB" if depth == 24 else "RGBA"
    else:
        raise ValueError(f"{path}: unknown TGA mode (image type {itype})")
    if flags & 0x30 not in (0, 0x10, 0x20, 0x30):
        raise ValueError(f"{path}: unknown TGA orientation")
    return id_len, maptype, itype, w, h, depth, flags, mode


def tga_header(blob: bytes, path: str) -> Tuple[str, int, int]:
    _, _, _, w, h, _, _, mode = _tga(blob, path)
    return mode, h, w


def _rgb15(v: np.ndarray) -> np.ndarray:
    """Pillow's BGRA;15Z / BGR;15 unpacking: 5-5-5 bits, red at bit 10."""
    v = v.astype(np.int32)
    return np.stack([((v >> 10) & 31) * 255 // 31, ((v >> 5) & 31) * 255
                     // 31, (v & 31) * 255 // 31], -1).astype(np.uint8)


def _tga_rle(blob: bytes, at: int, n: int, size: int, path: str) -> bytes:
    """TgaRleDecode: packets of a header byte (bit 7: a run of one pixel
    repeated, else literal pixels; low 7 bits: count - 1)."""
    out = bytearray()
    need = n * size
    while len(out) < need:
        if at >= len(blob):
            raise ValueError(f"{path}: truncated TGA RLE data")
        c = blob[at]
        at += 1
        k = (c & 0x7F) + 1
        if c & 0x80:
            out += blob[at:at + size] * k
            at += size
        else:
            out += blob[at:at + k * size]
            at += k * size
    return bytes(out[:need])


def decode_tga(blob: bytes, path: str) -> np.ndarray:
    id_len, maptype, itype, w, h, depth, flags, mode = _tga(blob, path)
    at = 18 + id_len
    lut = None
    if maptype:
        start, size, mdepth = struct.unpack("<HHB", blob[3:8])
        if mdepth not in (16, 24, 32):
            raise ValueError(f"{path}: unknown TGA map depth {mdepth}")
        if mdepth == 32:
            raise ValueError(f"{path}: TGA with a 32-bit colour map (Pillow "
                             "has no BGRA palette raw mode and refuses it)")
        nb = mdepth // 8
        raw = blob[at:at + nb * size]
        at += nb * size
        n = len(raw) // nb
        if mdepth == 16:
            pal = _rgb15(np.frombuffer(raw[:2 * n], "<u2"))
        else:
            pal = np.frombuffer(raw[:nb * n], np.uint8).reshape(n, nb)[
                :, 2::-1]
        lut = _lut(pal, start)
    if (itype & 7, depth) not in _TGA_RAW:
        raise ValueError(f"{path}: TGA of image type {itype} at {depth} bits"
                         " (Pillow opens it without decoding it)")
    size = (depth + 7) // 8
    if itype & 8:
        data = _tga_rle(blob, at, w * h, size, path)
        stride = w * size
    else:
        stride = (w * depth + 7) // 8
        data = _need(blob[at:], stride * h, path, "TGA")
    if depth == 1:
        px = _bits(data, h, stride, w, 1) * np.uint8(255)
    else:
        px = np.frombuffer(data, np.uint8, h * w * size).reshape(h, w, size)
    if not flags & 0x20:
        px = px[::-1]
    if flags & 0x10:
        px = px[:, ::-1]
    if depth == 1:
        return _grey(px)
    if mode == "P":
        return lut[px[..., 0]]
    if depth == 16 and itype & 7 == 2:
        return _rgb15(px[..., 0].astype(np.uint16)
                      | px[..., 1].astype(np.uint16) << 8)
    if itype & 7 in (1, 3):
        return _grey(px[..., 0])
    return np.ascontiguousarray(px[..., 2::-1])


# ----------------------------------------------------------- ICO and CUR

def _ico_entry(blob: bytes, path: str) -> Tuple[int, int, int, int, int]:
    """IcoFile's choice: the entries sorted by colour depth, then (stably)
    by area, largest first -> (width, height, bpp, size, offset)."""
    if len(blob) < 6 or blob[:4] != b"\0\0\1\0":
        raise ValueError(f"{path}: not an ICO file")
    entries = []
    for i in range(struct.unpack("<H", blob[4:6])[0]):
        e = blob[6 + 16 * i:22 + 16 * i]
        if len(e) < 16:
            raise ValueError(f"{path}: truncated ICO directory")
        w, h, colors = e[0] or 256, e[1] or 256, e[2]
        bpp, size, off = struct.unpack("<HII", e[6:16])
        depth = bpp or (colors and (colors - 1).bit_length()) or 256
        entries.append((w, h, bpp, size, off, depth))
    if not entries:
        raise ValueError(f"{path}: ICO without entries")
    entries.sort(key=lambda e: e[5])
    entries.sort(key=lambda e: e[0] * e[1], reverse=True)
    return entries[0][:5]


def ico_header(blob: bytes, path: str) -> Tuple[str, int, int]:
    from . import images
    w, h, bpp, size, off = _ico_entry(blob, path)
    if blob[off:off + 8] == images.PNG_SIGNATURE:
        ihdr = images._png_open(blob[off:], path)[0]
        pw, ph, depth, colour, _ = images._header(ihdr, path)
        mode = images._PNG_MODES.get((colour, depth), images._PNG_MODES[
            colour])
        return mode, ph, pw
    hd = images._bmp_header(b"BM" + bytes(12) + blob[off:], path, dib=True,
                            halve=True)
    return "RGBA", hd.height, hd.width


def decode_ico(blob: bytes, path: str) -> np.ndarray:
    from . import images
    w, h, bpp, size, off = _ico_entry(blob, path)
    if blob[off:off + 8] == images.PNG_SIGNATURE:
        return images.decode_png(blob[off:], path)
    return images.decode_bmp(b"BM" + bytes(12) + blob[off:], path, dib=True,
                             halve=True)


def _cur_offset(blob: bytes, path: str) -> int:
    """CurImagePlugin's choice: the first entry, replaced by a later one
    only where both sides are larger."""
    if len(blob) < 6 or blob[:4] != b"\0\0\2\0":
        raise ValueError(f"{path}: not a CUR file")
    m = None
    for i in range(struct.unpack("<H", blob[4:6])[0]):
        e = blob[6 + 16 * i:22 + 16 * i]
        if len(e) < 16:
            raise ValueError(f"{path}: truncated CUR directory")
        if m is None or e[0] > m[0] and e[1] > m[1]:
            m = e
    if m is None:
        raise ValueError(f"{path}: no cursors were found")
    return struct.unpack("<I", m[12:16])[0]


def cur_probe(blob: bytes) -> bool:
    """Whether CurImagePlugin's _open gets past its directory (a TGA file
    can start with the CUR magic and then has no cursors)."""
    try:
        _cur_offset(blob, "")
        return True
    except (ValueError, struct.error):
        return False


def cur_header(blob: bytes, path: str) -> Tuple[str, int, int]:
    from . import images
    hd = images._bmp_header(b"BM" + bytes(12) + blob[_cur_offset(blob, path):],
                            path, dib=True, halve=True)
    return hd.mode, hd.height, hd.width


def decode_cur(blob: bytes, path: str) -> np.ndarray:
    from . import images
    return images.decode_bmp(b"BM" + bytes(12) + blob[_cur_offset(
        blob, path):], path, dib=True, halve=True)


# ------------------------------------------------------------ PCX, DCX

def _pcx(blob: bytes, path: str, at: int = 0):
    s = blob[at:at + 128]
    if len(s) < 68 or s[0] != 10 or s[1] not in (0, 2, 3, 5):
        raise ValueError(f"{path}: not a PCX file")
    x0, y0, x1, y1 = struct.unpack("<HHHH", s[4:12])
    w, h = x1 + 1 - x0, y1 + 1 - y0
    if w <= 0 or h <= 0:
        raise ValueError(f"{path}: bad PCX image size")
    version, bits, planes = s[1], s[3], s[65]
    given = struct.unpack("<H", s[66:68])[0]
    pal = None
    if bits == 1 and planes == 1:
        mode = "1"
    elif bits == 1 and planes in (2, 4):
        mode = "P"
        pal = np.frombuffer(s[16:64], np.uint8).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        mode = "L"
        tail = blob[-769:]
        if len(tail) == 769 and tail[0] == 12:
            p = np.frombuffer(tail[1:], np.uint8).reshape(256, 3)
            if (p != np.arange(256)[:, None]).any():
                mode, pal = "P", p
    elif version == 5 and bits == 8 and planes == 3:
        mode = "RGB"
    else:
        raise ValueError(f"{path}: unknown PCX mode (version {version}, "
                         f"{bits} bits, {planes} planes; Pillow refuses it)")
    stride = (w * bits + 7) // 8
    if given != stride:
        stride += stride % 2
    return w, h, bits, planes, stride, mode, pal, at + 128


def _dcx_at(blob: bytes, path: str) -> int:
    if len(blob) < 8 or struct.unpack("<I", blob[:4])[0] != 987654321:
        raise ValueError(f"{path}: not a DCX file")
    at = struct.unpack("<I", blob[4:8])[0]
    if not at:
        raise ValueError(f"{path}: DCX without pages")
    return at


def pcx_header(blob: bytes, path: str, dcx: bool = False
               ) -> Tuple[str, int, int]:
    w, h, _, _, _, mode, _, _ = _pcx(blob, path, _dcx_at(blob, path)
                                     if dcx else 0)
    return mode, h, w


def _pcx_rle(blob: bytes, at: int, need: int, path: str) -> bytes:
    """PcxDecode: a byte with its two high bits set repeats the next byte
    (its low 6 bits) times, any other byte stands for itself."""
    out = bytearray()
    while len(out) < need:
        if at >= len(blob):
            raise ValueError(f"{path}: truncated PCX data")
        c = blob[at]
        if c & 0xC0 == 0xC0:
            if at + 1 >= len(blob):
                raise ValueError(f"{path}: truncated PCX data")
            out += blob[at + 1:at + 2] * (c & 0x3F)
            at += 2
        else:
            out.append(c)
            at += 1
    return bytes(out[:need])


def decode_pcx(blob: bytes, path: str, dcx: bool = False) -> np.ndarray:
    w, h, bits, planes, stride, mode, pal, at = _pcx(
        blob, path, _dcx_at(blob, path) if dcx else 0)
    line = planes * stride
    rows = np.frombuffer(_pcx_rle(blob, at, line * h, path), np.uint8
                         ).reshape(h, planes, stride)
    if mode == "RGB":
        return np.ascontiguousarray(rows[:, :, :w].transpose(0, 2, 1))
    if bits == 1:
        bitsp = np.unpackbits(rows, axis=2)[:, :, :w].astype(np.uint8)
        idx = (bitsp << np.arange(planes, dtype=np.uint8)[None, :, None]
               ).sum(1, dtype=np.uint8)
        if mode == "1":
            return _grey(idx * np.uint8(255))
        return _lut(pal)[idx]
    idx = rows[:, 0, :w]
    return _lut(pal)[idx] if mode == "P" else _grey(idx)


# ------------------------------------------------------------------ SGI

_SGI_MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L",
              (2, 2, 1): "L", (1, 3, 3): "RGB", (2, 3, 3): "RGB",
              (1, 3, 4): "RGBA", (2, 3, 4): "RGBA"}


def _sgi(blob: bytes, path: str):
    if len(blob) < 512 or struct.unpack(">H", blob[:2])[0] != 474:
        raise ValueError(f"{path}: not an SGI image file")
    comp, bpc = blob[2], blob[3]
    dim, w, h, z = struct.unpack(">HHHH", blob[4:12])
    mode = _SGI_MODES.get((bpc, dim, z))
    if mode is None:
        raise ValueError(f"{path}: unsupported SGI image mode (bpc {bpc}, "
                         f"dimension {dim}, {z} channels; Pillow refuses it)")
    if comp not in (0, 1):
        raise ValueError(f"{path}: SGI compression {comp} (Pillow opens it "
                         "without decoding it)")
    return comp, bpc, w, h, len(mode), mode


def sgi_header(blob: bytes, path: str) -> Tuple[str, int, int]:
    _, _, w, h, _, mode = _sgi(blob, path)
    return mode, h, w


def _sgi_row(blob: bytes, at: int, n: int, bpc: int, path: str) -> bytes:
    """SgiRleDecode on one row: a value (byte or 16-bit word) with count
    in its low 7 bits; bit 7 set copies that many values, clear repeats
    the next one; a zero count ends the row."""
    out = bytearray()
    dt = ">H" if bpc == 2 else "B"
    while True:
        if at + bpc > len(blob):
            raise ValueError(f"{path}: truncated SGI RLE data")
        c = struct.unpack_from(dt, blob, at)[0]
        at += bpc
        k = c & 0x7F
        if not k:
            break
        if c & 0x80:
            out += blob[at:at + k * bpc]
            at += k * bpc
        else:
            out += blob[at:at + bpc] * k
            at += bpc
        if len(out) > n * bpc:
            raise ValueError(f"{path}: SGI RLE row overruns its width")
    if len(out) < n * bpc:
        raise ValueError(f"{path}: SGI RLE row shorter than its width")
    return bytes(out)


def decode_sgi(blob: bytes, path: str) -> np.ndarray:
    comp, bpc, w, h, z, mode = _sgi(blob, path)
    dt = np.dtype(">u2" if bpc == 2 else np.uint8)
    if comp == 0:
        n = w * h * z * bpc
        planes = np.frombuffer(_need(blob[512:], n, path, "SGI"), dt
                               ).reshape(z, h, w)
    else:
        tab = np.frombuffer(_need(blob[512:], 8 * h * z, path, "SGI tables"),
                            ">u4").reshape(2, z, h)
        planes = np.stack([np.stack([np.frombuffer(_sgi_row(
            blob, int(tab[0, c, y]), w, bpc, path), dt) for y in range(h)])
            for c in range(z)])
    px = planes.transpose(1, 2, 0)[::-1]
    if bpc == 2:
        px = px >> 8
    px = px.astype(np.uint8)
    return _grey(px[..., 0]) if mode == "L" else np.ascontiguousarray(
        px[..., :3])


# ------------------------------------------------------------------ QOI

def qoi_header(blob: bytes, path: str) -> Tuple[str, int, int]:
    if len(blob) < 14 or blob[:4] != b"qoif":
        raise ValueError(f"{path}: not a QOI file")
    w, h = struct.unpack(">II", blob[4:12])
    return ("RGB" if blob[12] == 3 else "RGBA"), h, w


def decode_qoi(blob: bytes, path: str) -> np.ndarray:
    """QoiImagePlugin's decoder: the index updated by every op but a run,
    an unseen index entry (0, 0, 0, 0)."""
    mode, h, w = qoi_header(blob, path)
    n = w * h
    out = bytearray()
    seen = {}
    prev = (0, 0, 0, 255)
    at = 14
    try:
        while len(out) < 4 * n:
            b = blob[at]
            at += 1
            if b == 0xFE:
                v = (blob[at], blob[at + 1], blob[at + 2], prev[3])
                at += 3
            elif b == 0xFF:
                v = tuple(blob[at:at + 4])
                at += 4
                if len(v) < 4:
                    raise IndexError
            elif b >> 6 == 0:
                v = seen.get(b & 63, (0, 0, 0, 0))
            elif b >> 6 == 1:
                v = ((prev[0] + ((b >> 4) & 3) - 2) % 256,
                     (prev[1] + ((b >> 2) & 3) - 2) % 256,
                     (prev[2] + (b & 3) - 2) % 256, prev[3])
            elif b >> 6 == 2:
                b2 = blob[at]
                at += 1
                dg = (b & 63) - 32
                v = ((prev[0] + dg + (b2 >> 4) - 8) % 256,
                     (prev[1] + dg) % 256,
                     (prev[2] + dg + (b2 & 15) - 8) % 256, prev[3])
            else:
                out += bytes(prev) * ((b & 63) + 1)
                continue
            prev = v
            seen[(v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64] = v
            out += bytes(v)
    except IndexError:
        raise ValueError(f"{path}: truncated QOI data") from None
    px = np.frombuffer(bytes(out[:4 * n]), np.uint8).reshape(h, w, 4)
    return np.ascontiguousarray(px[..., :3])


# ------------------------------------------------------------------- IM

_IM_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
_IM_TAGS = {"Comment", "Date", "Digitalization equipment",
            "File size (no of images)", "Lut", "Name", "Scale (x,y)",
            "Image size (x*y)", "Image type"}
# ImImagePlugin's image types without a reader here -> Pillow's mode
_IM_MODES = {"RLB image": "RGB", "RYB image": "RGB", "B2 image": "P",
             "B4 image": "P", "RGB3 image": "RGB", "RYB3 image": "RGB"}
for _j in range(2, 33):
    _IM_MODES.setdefault(f"L*{_j} image", "F")
# Image type -> (mode, samples a pixel, line-interleaved planes); the
# one-sample numeric types as (mode, little- or big-endian dtype, None),
# Pillow's F;8 .. F;32F, I;16, I;16L, I;16B and I;32S raw modes
_IM_TYPES = {"0 1 image": ("1", 1, False), "L 1 image": ("1", 1, False),
             "B1 image": ("1", 1, False), "Greyscale image": ("L", 1, False),
             "Grayscale image": ("L", 1, False),
             "RGB image": ("RGB", 3, True), "X 24 image": ("RGB", 3, False),
             "LA image": ("LA", 2, True), "PA image": ("LA", 2, True),
             "RGBA image": ("RGBA", 4, True), "RGBX image": ("RGB", 4, True),
             "CMYK image": ("CMYK", 4, True),
             "YCC image": ("YCbCr", 3, True)}
for _i, _t in (("8", "u1"), ("8S", "i1"), ("16", "<u2"), ("16S", "<i2"),
               ("32", "<u4"), ("32F", "<f4")):
    _IM_TYPES[f"L {_i} image"] = _IM_TYPES[f"L*{_i} image"] = ("F", _t, None)
for _i, _t in (("16", "<u2"), ("16L", "<u2"), ("16B", ">u2")):
    _IM_TYPES[f"L {_i} image"] = _IM_TYPES[f"L*{_i} image"] = (
        f"I;{_i}", _t, None)
_IM_TYPES["L 32S image"] = _IM_TYPES["L*32S image"] = ("I", "<i4", None)
for _i, _t in (("8", "u1"), ("16", "<u2"), ("32", "<u4")):
    _IM_TYPES[f"L*{_i} image"] = ("F", _t, None)   # Pillow's L*n override


def _im(blob: bytes, path: str):
    """ImImagePlugin._open: "key: value" lines up to a NUL, ^Z or the end,
    then the data after the ^Z (and a 768-byte Lut where one is named)."""
    if b"\n" not in blob[:100]:
        raise ValueError(f"{path}: not an IM file")
    info = {"Image type": "L", "Image size (x*y)": (512, 512)}
    at, n, kind = 0, 0, None
    while True:
        s = blob[at:at + 1]
        at += 1
        if s == b"\r":
            continue
        if not s or s in (b"\0", b"\x1a"):
            break
        end = blob.find(b"\n", at)
        end = len(blob) if end < 0 else end + 1
        s += blob[at:end]
        at = end
        if len(s) > 100:
            raise ValueError(f"{path}: not an IM file")
        s = s[:-2] if s.endswith(b"\r\n") else s[:-1] if s.endswith(
            b"\n") else s
        m = _IM_SPLIT.match(s)
        if not m:
            raise ValueError(f"{path}: syntax error in IM header")
        k, v = (g.decode("latin-1") for g in m.group(1, 2))
        if k in ("File size (no of images)", "Scale (x,y)",
                 "Image size (x*y)"):
            v = tuple(float(x) if "." in x else int(x)
                      for x in v.replace("*", ",").split(","))
        if k == "Image type":
            kind = v
        info[k] = v
        if k in _IM_TAGS:
            n += 1
    if not n:
        raise ValueError(f"{path}: not an IM file")
    while s and not s.startswith(b"\x1a"):
        s = blob[at:at + 1]
        at += 1
    if not s:
        raise ValueError(f"{path}: truncated IM header")
    size = info["Image size (x*y)"]
    if not isinstance(size, tuple) or len(size) != 2:
        raise ValueError(f"{path}: bad IM size {size}")
    w, h = size
    pal = None
    spec = _IM_TYPES.get(kind or "", None)
    mode = spec[0] if spec else _IM_MODES.get(kind, kind) if kind else "L"
    if kind is None:
        spec = ("L", 1, False)
    if "Lut" in info:
        p = np.frombuffer(_need(blob[at:], 768, path, "IM Lut"), np.uint8
                          ).reshape(3, 256)
        at += 768
        grey = (p[0] == p[1]).all() and (p[1] == p[2]).all()
        # a grey Lut on grey values, or any on RGB ones, becomes Pillow's
        # `lut` attribute, which nothing applies: the values stay
        if mode in ("L", "LA", "P", "PA") and not grey:
            mode, pal = ("P" if mode in ("L", "P") else "PA"), p.T.copy()
    return w, h, mode, spec, pal, at, kind


def im_probe(blob: bytes) -> bool:
    try:
        _im(blob, "")
        return True
    except (ValueError, IndexError):
        return False


def im_header(blob: bytes, path: str) -> Tuple[str, int, int]:
    w, h, mode, _, _, _, _ = _im(blob, path)
    return mode, h, w


def _im_bits(data: bytes, w: int, h: int, bits: int) -> np.ndarray:
    """Pillow's BitDecode with IM's arguments (bits, pad 8, fill 3, no
    sign): bytes into the bit buffer LSB first, values out LSB first, the
    bit count (not the buffer) reset at each row; rows bottom first."""
    out = np.zeros((h, w), np.float64)
    mask = (1 << bits) - 1
    buf = count = x = 0
    y = h - 1
    for byte in data:
        buf |= byte << count
        count += 8
        while count >= bits:
            v = buf & mask
            if count > 32:        # the buffer overflows: its last byte's bits
                buf = byte >> (8 - (count - bits))
            else:
                buf >>= bits
            count -= bits
            out[y, x] = v
            x += 1
            if x >= w:
                y -= 1
                if y < 0:
                    return out
                x = 0
                count = 0
    return None


def decode_im(blob: bytes, path: str) -> np.ndarray:
    w, h, mode, spec, pal, at, kind = _im(blob, path)
    if kind in ("B2 image", "B4 image"):         # P;2 / P;4, bottom first
        # a colour Lut makes Pillow's raw mode plain P, a byte a pixel
        bits = 8 if pal is not None else 2 if kind[1] == "2" else 4
        stride = (w * bits + 7) // 8
        px = _bits(_need(blob[at:], stride * h, path, "IM"), h, stride, w,
                   bits)[::-1]
        # no Lut: Pillow's P image has no palette, and converts to black
        return _lut(pal if pal is not None else np.zeros((0, 3), np.uint8)
                    )[px]
    if kind in ("RGB3 image", "RYB3 image"):     # planes G, R, B
        n = w * h
        d = np.frombuffer(_need(blob[at:], 3 * n, path, "IM"), np.uint8,
                          3 * n).reshape(3, h, w)[:, ::-1]
        return np.ascontiguousarray(np.stack([d[1], d[0], d[2]], -1))
    if kind and kind.startswith("L*") and kind not in _IM_TYPES:
        bits = int(kind[2:-6])
        v = _im_bits(blob[at:], w, h, bits)
        if v is None:
            raise ValueError(f"{path}: truncated IM (image file is "
                             "truncated)")
        return _grey(np.clip(v, 0, 255).astype(np.uint8))
    if spec is None:
        raise ValueError(f"{path}: IM of type {kind!r}: Pillow has no raw "
                         "mode for it and refuses it")
    _, ch, lines = spec
    if lines is None:                   # one numeric sample a pixel
        n = np.dtype(ch).itemsize
        v = np.frombuffer(_need(blob[at:], n * w * h, path, "IM"), ch,
                          w * h).reshape(h, w)[::-1].astype(np.float64)
        if spec[0] == "F":              # through float32, as Pillow's F
            v = v.astype(np.float32)
        with np.errstate(invalid="ignore"):
            return _grey(np.where(np.isnan(v), 0, np.clip(v, 0, 255)))
    if spec[0] == "1":
        stride = (w + 7) // 8
        px = _bits(_need(blob[at:], stride * h, path, "IM"), h, stride, w,
                   1)[::-1]
        return _grey(px * np.uint8(255))
    data = np.frombuffer(_need(blob[at:], w * h * ch, path, "IM"), np.uint8,
                         w * h * ch)
    px = (data.reshape(h, ch, w).transpose(0, 2, 1) if lines
          else data.reshape(h, w, ch))[::-1]
    if pal is not None:
        return _lut(pal)[px[..., 0]]
    if mode == "CMYK":
        return _cmyk(px)
    if mode == "YCbCr":
        from .jpeg2000 import ycbcr_to_rgb
        return ycbcr_to_rgb(np.ascontiguousarray(px))
    if ch <= 2:
        return _grey(px[..., 0])
    return np.ascontiguousarray(px[..., :3])


# ------------------------------------------------------------------ MSP

def _msp(blob: bytes, path: str):
    s = blob[:32]
    if len(s) < 32 or s[:4] not in (b"DanM", b"LinS"):
        raise ValueError(f"{path}: not an MSP file")
    check = 0
    for v in struct.unpack("<16H", s):
        check ^= v
    if check:
        raise ValueError(f"{path}: bad MSP checksum")
    w, h = struct.unpack("<HH", s[4:8])
    if w < 1 or h < 1:
        raise ValueError(f"{path}: empty image {w}x{h}")
    return w, h


def msp_header(blob: bytes, path: str) -> Tuple[str, int, int]:
    w, h = _msp(blob, path)
    return "1", h, w


def decode_msp(blob: bytes, path: str) -> np.ndarray:
    w, h = _msp(blob, path)
    stride = (w + 7) // 8
    if blob[:4] == b"DanM":
        data = _need(blob[32:], stride * h, path, "MSP")
    else:
        rowmap = struct.unpack_from(f"<{h}H", _need(blob[32:], 2 * h, path,
                                                    "MSP row map"))
        at, out = 32 + 2 * h, bytearray()
        for rowlen in rowmap:
            if not rowlen:
                out += b"\xff" * stride
                continue
            row = _need(blob[at:at + rowlen], rowlen, path, "MSP row")
            at += rowlen
            i = 0
            while i < rowlen:
                t = row[i]
                i += 1
                if t == 0:
                    if i + 2 > rowlen:
                        raise ValueError(f"{path}: corrupted MSP row")
                    out += row[i + 1:i + 2] * row[i]
                    i += 2
                else:
                    out += row[i:i + t]
                    i += t
        data = _need(bytes(out), stride * h, path, "MSP")
    return _grey(_bits(data, h, stride, w, 1) * np.uint8(255))


# ------------------------------------------------------------------ SUN

def _sun(blob: bytes, path: str):
    if len(blob) < 32 or struct.unpack(">I", blob[:4])[0] != 0x59A66A95:
        raise ValueError(f"{path}: not a SUN raster file")
    w, h, depth, _, ftype, ptype, plen = struct.unpack(">7I", blob[4:32])
    mode = {1: "1", 4: "L", 8: "L", 24: "RGB", 32: "RGB"}.get(depth)
    if mode is None:
        raise ValueError(f"{path}: SUN raster of depth {depth} (Pillow "
                         "refuses it)")
    pal = None
    if plen:
        if plen > 1024 or ptype != 1:
            raise ValueError(f"{path}: unsupported SUN colour map")
        n = plen // 3
        pal = np.frombuffer(blob[32:32 + 3 * n], np.uint8).reshape(3, n).T
        if mode == "L":
            mode = "P"
    if ftype not in (0, 1, 2, 3, 4, 5):
        raise ValueError(f"{path}: unsupported SUN raster type {ftype}")
    if w < 1 or h < 1:
        raise ValueError(f"{path}: empty image {w}x{h}")
    return w, h, depth, ftype, mode, pal, 32 + plen


def sun_header(blob: bytes, path: str) -> Tuple[str, int, int]:
    w, h, _, _, mode, _, _ = _sun(blob, path)
    return mode, h, w


def _sun_rle(blob: bytes, at: int, need: int) -> bytes:
    """SunRleDecode: 0x80 then 0 is one 0x80 byte, 0x80 then n > 0 then b
    is n + 1 bytes b, any other byte stands for itself."""
    out = bytearray()
    while len(out) < need and at < len(blob):
        c = blob[at]
        if c != 0x80:
            out.append(c)
            at += 1
        elif at + 1 < len(blob) and blob[at + 1] == 0:
            out.append(0x80)
            at += 2
        else:
            out += blob[at + 2:at + 3] * (blob[at + 1] + 1)
            at += 3
    return bytes(out)


def decode_sun(blob: bytes, path: str) -> np.ndarray:
    w, h, depth, ftype, mode, pal, at = _sun(blob, path)
    if ftype == 2:
        stride = (w * depth + 7) // 8
        data = _need(_sun_rle(blob, at, stride * h), stride * h, path,
                     "SUN RLE")
    else:
        stride = (w * depth + 15) // 16 * 2
        data = _need(blob[at:], stride * h, path, "SUN")
    if depth <= 8:
        px = _bits(data, h, stride, w, depth)
        if mode == "1":
            return _grey(255 - px * np.uint8(255))
        if mode == "P":
            return _lut(pal)[px]
        return _grey(px * np.uint8(255 // ((1 << depth) - 1)))
    nb = depth // 8
    px = np.frombuffer(data, np.uint8, h * stride).reshape(h, stride)[
        :, :w * nb].reshape(h, w, nb)
    return np.ascontiguousarray(px[..., :3] if ftype == 3
                                else px[..., [2, 1, 0]])


# ------------------------------------------------------------------ PSD

_PSD_MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1),
              (2, 8): ("P", 1), (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4),
              (7, 8): ("L", 1), (8, 8): ("L", 1), (9, 8): ("LAB", 3)}


def _psd(blob: bytes, path: str):
    s = blob[:26]
    if len(s) < 26 or s[:4] != b"8BPS" or struct.unpack(">H", s[4:6])[0] != 1:
        raise ValueError(f"{path}: not a PSD file")
    chans, = struct.unpack(">H", s[12:14])
    h, w = struct.unpack(">II", s[14:22])
    bits, cmode = struct.unpack(">HH", s[22:26])
    if (cmode, bits) not in _PSD_MODES:
        raise ValueError(f"{path}: PSD of colour mode {cmode} at {bits} bits "
                         "(Pillow refuses it)")
    mode, ch = _PSD_MODES[(cmode, bits)]
    if ch > chans:
        raise ValueError(f"{path}: PSD with not enough channels")
    if mode == "RGB" and chans == 4:
        mode, ch = "RGBA", 4
    at = 26
    size, = struct.unpack(">I", _need(blob[at:at + 4], 4, path, "PSD"))
    pal = None
    if size and mode == "P" and size == 768:
        pal = np.frombuffer(blob[at + 4:at + 772], np.uint8).reshape(3, 256).T
    at += 4 + size
    for _ in range(2):              # image resources, layer and mask info
        size, = struct.unpack(">I", _need(blob[at:at + 4], 4, path, "PSD"))
        at += 4 + size
    return w, h, mode, ch, bits, pal, at


def psd_header(blob: bytes, path: str) -> Tuple[str, int, int]:
    w, h, mode, _, _, _, _ = _psd(blob, path)
    return mode, h, w


def _packbits_rows(blob: bytes, at: int, rows: int, stride: int,
                   path: str) -> bytes:
    """PackbitsDecode.c over `rows` rows of `stride` bytes, from `at` on:
    a packet that runs past the end of its row is cut there (the rest of
    it dropped), 128 is a no-op, and a packet cut short by the end of the
    file is the truncation Pillow refuses."""
    out = bytearray()
    for _ in range(rows):
        row = bytearray()
        while len(row) < stride:
            n = blob[at] if at < len(blob) else 0
            if at + (1 if n == 128 else 2 if n > 128 else n + 2) > len(blob):
                raise ValueError(f"{path}: truncated PSD PackBits data")
            if n == 128:
                at += 1
            elif n > 128:
                row += blob[at + 1:at + 2] * (257 - n)
                at += 2
            else:
                row += blob[at + 1:at + 2 + n]
                at += n + 2
        out += row[:stride]
    return bytes(out)


def decode_psd(blob: bytes, path: str) -> np.ndarray:
    w, h, mode, ch, bits, pal, at = _psd(blob, path)
    comp, = struct.unpack(">H", _need(blob[at:at + 2], 2, path, "PSD"))
    at += 2
    stride = (w * bits + 7) // 8
    planes: List[np.ndarray] = []
    if comp == 0:
        for c in range(ch):           # Pillow steps w * h bytes a channel
            data = _need(blob[at + c * w * h:], stride * h, path, "PSD")
            planes.append(_bits(data, h, stride, w, bits))
    elif comp == 1:
        counts = np.frombuffer(_need(blob[at:], 2 * ch * h, path,
                                     "PSD row counts"), ">u2", ch * h)
        at += 2 * ch * h
        for c in range(ch):
            data = _packbits_rows(blob, at, h, stride, path)
            planes.append(_bits(data, h, stride, w, bits))
            at += int(counts[c * h:(c + 1) * h].sum())
    else:
        raise ValueError(f"{path}: PSD compression {comp} (Pillow opens it "
                         "without decoding it)")
    px = np.stack(planes, -1)
    if mode == "1":
        return _grey(px[..., 0] * np.uint8(255))
    if mode == "P":                 # no 768-byte palette: Pillow's empty one
        return _lut(pal)[px[..., 0]] if pal is not None else \
            np.zeros((h, w, 3), np.uint8)
    if mode == "LAB":               # a and b stored offset by 128
        return lab_to_rgb(px[..., :3] ^ np.array([0, 128, 128], np.uint8))
    if mode == "CMYK":
        return _cmyk(255 - px)
    if ch == 1:
        return _grey(px[..., 0])
    return np.ascontiguousarray(px[..., :3])


# ------------------------------------------ ISO base media boxes (JP2)

def _boxes(blob: bytes, at: int, end: int):
    """ISO base media boxes between `at` and `end` -> (type, body)."""
    while at + 8 <= end:
        size, typ = struct.unpack(">I4s", blob[at:at + 8])
        head = 8
        if size == 1:
            size, = struct.unpack(">Q", blob[at + 8:at + 16])
            head = 16
        elif size == 0:
            size = end - at
        if size < head or at + size > end:
            break
        yield typ, blob[at + head:at + size]
        at += size
