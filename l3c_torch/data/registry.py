"""The rest of Pillow's Image.OPEN registry, read as the JAX package's
loader reads it (Image.open(p).convert("RGB") under Pillow 12.1): each
format's `*_probe(blob)` is its _open succeeding (Image.open tries the
next plugin where it does not), `*_header(blob, path)` gives (Pillow's
mode, height, width) and `decode_*(blob, path)` (H, W, 3) uint8 RGB.

  - XBM: X10 / X11 hex bitmaps, XbmDecode's reading of two hex digits
    after each "x" (an X10 word's high byte), bits LSB first;
  - XPM: XpmImagePlugin's palette lines ("c" keys: "#rrggbb" or None)
    and pixel strings, mode P up to 256 colours, else RGB;
  - FITS: BITPIX 8, 16, 32, -32 and -64 read with Pillow's raw modes (L,
    I;16, I, F: little-endian, bottom row first, BZERO / BSCALE unread),
    and the GZIP_1 tile-compressed extension as FitsGzipDecoder reads it;
  - BLP: BLP1 palette and JPEG (its channels swapped, as Pillow's BGR
    raw mode swaps them), BLP2 palette and DXT1 / DXT3 / DXT5 through
    BlpImagePlugin's own block decoders, whose rows run on unclipped;
  - SPIDER: 2-D float32 images and stacks' first image, either order;
  - PCD: the 768 x 512 base image, PcdDecode's YCC;P unpacking through
    Pillow's PhotoYCC tables, turned by the orientation bits;
  - GBR: GIMP brushes v1 / v2, grey and RGBA;
  - FLI / FLC: the first frame (COLOR / COLOR256 palette, BRUN, LC, SS2,
    BLACK, COPY, PSTAMP), as FliDecode draws it on a black frame;
  - FTEX: FTU (raw RGB) and FTC (BC1 through data/dds.py);
  - PIXAR (RGB), MCIDAS (8-, 16- and 32-bit areas), IMT (grey), IPTC
    (raw grey, or JPEG, into one band of RGB / CMYK) and XVThumb (the
    3-3-2 palette).
Converted to RGB as Pillow converts their modes; where Pillow refuses a
file the port raises ValueError with its reason.
"""
from __future__ import annotations

import gzip
import math
import re
import struct
from typing import List, Tuple

import numpy as np

from . import dds, jpeg
from .rasters import _cmyk, _grey, _lut


def _f_to_rgb(v: np.ndarray) -> np.ndarray:
    """Pillow's F -> RGB: clipped to 0..255 and truncated (NaN as 0)."""
    with np.errstate(invalid="ignore"):
        v = v.astype(np.float32)
        return _grey(np.where(np.isnan(v), 0, np.clip(v, 0, 255)).astype(
            np.uint8))


def _i_to_rgb(v: np.ndarray) -> np.ndarray:
    return _grey(np.clip(v.astype(np.int64), 0, 255).astype(np.uint8))


def _truncated(path: str, what: str) -> ValueError:
    return ValueError(f"{path}: {what}: image file is truncated (Pillow "
                      "refuses it)")


# ------------------------------------------------------------------ XBM

_XBM_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]")


def _xbm(blob: bytes, path: str):
    m = _XBM_HEAD.match(blob[:512])
    if not m:
        raise ValueError(f"{path}: not a XBM file")
    w, h = int(m.group("width")), int(m.group("height"))
    if w <= 0 or h <= 0:
        raise ValueError(f"{path}: empty XBM image")
    return w, h, m.end()


def xbm_probe(blob: bytes) -> bool:
    return _ok(_xbm, blob)


def xbm_header(blob: bytes, path: str) -> Tuple[str, int, int]:
    w, h, _ = _xbm(blob, path)
    return "1", h, w


_HEX = bytes(int(chr(c), 16) if chr(c) in "0123456789abcdefABCDEF" else 0
             for c in range(256))


def decode_xbm(blob: bytes, path: str) -> np.ndarray:
    """XbmDecode: after each "x", the next two characters as hex digits
    (anything else counts 0); rows of (w + 7) // 8 bytes, LSB first."""
    w, h, at = _xbm(blob, path)
    need = (w + 7) // 8 * h
    out = bytearray()
    while len(out) < need:
        at = blob.find(b"x", at)
        if at < 0 or at + 3 > len(blob):
            raise _truncated(path, "XBM")
        out.append(_HEX[blob[at + 1]] << 4 | _HEX[blob[at + 2]])
        at += 3
    px = np.unpackbits(np.frombuffer(bytes(out), np.uint8).reshape(h, -1),
                       axis=1, bitorder="little")[:, :w]
    return _grey(px * np.uint8(255))


# ------------------------------------------------------------------ XPM

_XPM_HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


class _Lines:
    """readline() over bytes, as a file's."""

    def __init__(self, blob: bytes, at: int = 0):
        self.blob, self.at = blob, at

    def readline(self) -> bytes:
        end = self.blob.find(b"\n", self.at)
        end = len(self.blob) if end < 0 else end + 1
        line, self.at = self.blob[self.at:end], end
        return line


def _xpm(blob: bytes, path: str):
    if blob[:9] != b"/* XPM */":
        raise ValueError(f"{path}: not an XPM file")
    f = _Lines(blob, 9)
    while True:
        line = f.readline()
        if not line:
            raise ValueError(f"{path}: broken XPM file")
        m = _XPM_HEAD.match(line)
        if m:
            break
    try:
        w, h, n, bpp = (int(g) for g in m.groups())
    except ValueError:
        raise ValueError(f"{path}: broken XPM header") from None
    palette = {}
    for _ in range(n):
        line = f.readline().rstrip()
        c = line[1:bpp + 1]
        s = line[bpp + 1:-2].split()
        for i in range(0, len(s), 2):
            if s[i] == b"c":
                rgb = s[i + 1] if i + 1 < len(s) else b""
                if rgb == b"None":
                    pass
                elif rgb.startswith(b"#"):
                    try:
                        v = int(rgb[1:], 16)
                    except ValueError:
                        raise ValueError(f"{path}: cannot read this XPM "
                                         "file (a colour)") from None
                    palette[c] = (v >> 16 & 255, v >> 8 & 255, v & 255)
                else:
                    raise ValueError(f"{path}: cannot read this XPM file "
                                     f"(colour {rgb!r}; Pillow reads # "
                                     "values and None only)")
                break
        else:
            raise ValueError(f"{path}: cannot read this XPM file")
    if w <= 0 or h <= 0:
        raise ValueError(f"{path}: empty XPM image")
    return w, h, bpp, palette, "RGB" if n > 256 else "P", f.at


def xpm_header(blob: bytes, path: str) -> Tuple[str, int, int]:
    w, h, _, _, mode, _ = _xpm(blob, path)
    return mode, h, w


def decode_xpm(blob: bytes, path: str) -> np.ndarray:
    """XpmDecoder: pixel strings between the quotes of each line (a
    "/* pixels */" line skipped once) until the image is full; a key
    without a colour fails as Pillow's lookup fails."""
    w, h, bpp, palette, mode, at = _xpm(blob, path)
    f = _Lines(blob, at)
    keys = list(palette)
    index = {k: i for i, k in enumerate(keys)}
    out: List[int] = []
    header = False
    while len(out) < w * h:
        line = f.readline()
        if not line:
            break
        if line.rstrip() == b"/* pixels */" and not header:
            header = True
            continue
        line = b'"'.join(line.split(b'"')[1:-1])
        for i in range(0, len(line), max(bpp, 1)):
            key = line[i:i + bpp]
            if key not in index:
                raise ValueError(f"{path}: XPM pixel {key!r} has no colour "
                                 "(Pillow's lookup fails)")
            out.append(index[key])
    if len(out) < w * h:
        raise ValueError(f"{path}: not enough XPM image data")
    idx = np.asarray(out[:w * h], np.intp).reshape(h, w)
    pal = np.asarray([palette[k] for k in keys] or [(0, 0, 0)], np.uint8)
    if mode == "RGB":
        return pal[idx]
    return _lut(pal)[idx]


# ----------------------------------------------------------------- FITS

def _fits(blob: bytes, path: str):
    """FitsImageFile._open: 80-byte cards in 2880-byte blocks; the first
    header with an image (NAXIS > 0), or a GZIP_1 tile-compressed
    extension, decides."""
    headers = {}
    in_progress, decoder, at = False, "", 0
    size, mode, args, offset = None, "", None, 0
    while True:
        card = blob[at:at + 80]
        at += 80
        if not card:
            raise ValueError(f"{path}: Truncated FITS file")
        key = card[:8].strip()
        if key in (b"SIMPLE", b"XTENSION"):
            in_progress = True
        elif headers and not in_progress:
            break
        elif key == b"END":
            at = math.ceil(min(at, len(blob)) / 2880) * 2880
            if not decoder:
                decoder, offset, size, mode, args = _fits_parse(
                    headers, path)
            in_progress = False
            continue
        if decoder:
            continue
        value = card[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (key != b"SIMPLE" or value != b"T"):
            raise ValueError(f"{path}: Not a FITS file")
        headers[key] = value
    if not decoder:
        raise ValueError(f"{path}: FITS file: No image data (Pillow "
                         "refuses it)")
    if not mode or size[0] <= 0 or size[1] <= 0:
        raise ValueError(f"{path}: FITS of an unknown BITPIX")
    return decoder, offset + min(at, len(blob)) - 80, size, mode, args


def _int(v: bytes, path: str) -> int:
    try:
        return int(v)
    except ValueError:
        raise ValueError(f"{path}: FITS value {v!r} is not an integer") \
            from None


def _fits_parse(headers, path):
    def get(k):
        if k not in headers:
            raise ValueError(f"{path}: FITS header without {k.decode()}")
        return headers[k]

    def dims(prefix):
        n = _int(get(prefix + b"NAXIS"), path)
        if n == 0:
            return None
        if n == 1:
            return 1, _int(get(prefix + b"NAXIS1"), path)
        return (_int(get(prefix + b"NAXIS1"), path),
                _int(get(prefix + b"NAXIS2"), path))

    prefix, decoder, offset = b"", "raw", 0
    if headers.get(b"XTENSION") == b"'BINTABLE'" and \
            headers.get(b"ZIMAGE") == b"T" and \
            get(b"ZCMPTYPE") == b"'GZIP_1  '":
        plain = dims(b"") or (0, 0)
        offset = plain[0] * plain[1] * (_int(get(b"BITPIX"), path) // 8)
        prefix, decoder = b"Z", "fits_gzip"
    size = dims(prefix)
    if not size:
        return "", 0, None, "", None
    bits = _int(get(prefix + b"BITPIX"), path)
    mode = {8: "L", 16: "I;16", 32: "I", -32: "F", -64: "F"}.get(bits, "")
    return decoder, offset, size, mode, bits


def fits_probe(blob: bytes) -> bool:
    return _ok(_fits, blob)


def fits_header(blob: bytes, path: str) -> Tuple[str, int, int]:
    _, _, (w, h), mode, _ = _fits(blob, path)
    return mode, h, w


_RAW = {"L": ("u1", 1), "I;16": ("<u2", 2), "I": ("<i4", 4),
        "F": ("<f4", 4)}


def _mode_to_rgb(mode: str, v: np.ndarray) -> np.ndarray:
    if mode == "L":
        return _grey(v)
    if mode == "F":
        return _f_to_rgb(v)
    return _i_to_rgb(v)


def decode_fits(blob: bytes, path: str) -> np.ndarray:
    decoder, at, (w, h), mode, bits = _fits(blob, path)
    dt, n = _RAW[mode]
    if decoder == "raw":
        data = blob[at:at + w * h * n]
        if len(data) < w * h * n:
            raise _truncated(path, "FITS")
    else:                           # FitsGzipDecoder
        try:
            value = gzip.decompress(blob[at:])
        except (OSError, EOFError, ValueError) as e:
            raise ValueError(f"{path}: FITS GZIP_1 data: {e}") from None
        nb = min(bits // 8, 4)
        rows, off = [], 0
        for _ in range(h):
            row = bytearray()
            for _ in range(w):
                row += value[off + (4 - nb):off + 4]
                off += 4
            rows.append(row)
        data = b"".join(rows[::-1])          # then read top row first
        if len(data) < w * h * n:
            raise ValueError(f"{path}: FITS GZIP_1 data: not enough image "
                             "data (Pillow refuses it)")
        return _mode_to_rgb(mode, np.frombuffer(data, dt, w * h).reshape(
            h, w))
    v = np.frombuffer(data, dt, w * h).reshape(h, w)[::-1]
    return _mode_to_rgb(mode, v)


# ------------------------------------------------------------------ BLP

def _blp(blob: bytes, path: str):
    if blob[:4] not in (b"BLP1", b"BLP2") or len(blob) < 20:
        raise ValueError(f"{path}: not a BLP file")
    comp = struct.unpack_from("<i", blob, 4)[0]
    if blob[:4] == b"BLP1":
        alpha = struct.unpack_from("<I", blob, 8)[0] != 0
        w, h = struct.unpack_from("<II", blob, 12)
        if len(blob) < 28:
            raise ValueError(f"{path}: truncated BLP header")
        enc = struct.unpack_from("<i", blob, 20)[0]
        return 1, comp, enc, alpha, None, w, h, 28
    enc, a, aenc = struct.unpack_from("<bbb", blob, 8)
    w, h = struct.unpack_from("<II", blob, 12)
    return 2, comp, enc, a != 0, aenc, w, h, 20


def blp_header(blob: bytes, path: str) -> Tuple[str, int, int]:
    _, _, _, alpha, _, w, h, _ = _blp(blob, path)
    if w <= 0 or h <= 0:
        raise ValueError(f"{path}: empty BLP image")
    return "RGBA" if alpha else "RGB", h, w


def _unpack_565(c: np.ndarray):
    c = c.astype(np.int64)
    return ((c >> 11) & 31) << 3, ((c >> 5) & 63) << 2, (c & 31) << 3


def _blp_colours(c0, c1, four):
    """BlpImagePlugin's colour of each code (0..3) of each block: the two
    565 endpoints shifted (not replicated), thirds or halves by //."""
    r0, g0, b0 = _unpack_565(c0)
    r1, g1, b1 = _unpack_565(c1)
    e0 = np.stack([r0, g0, b0], -1)
    e1 = np.stack([r1, g1, b1], -1)
    third = np.stack([(2 * e0 + e1) // 3, (2 * e1 + e0) // 3], 1)
    half = np.stack([(e0 + e1) // 2, np.zeros_like(e0)], 1)
    mix = np.where(four[:, None, None], third, half)
    return np.concatenate([e0[:, None], e1[:, None], mix], 1)


def _blp_dxt(data: bytes, w: int, h: int, kind: int, alpha: bool,
             path: str) -> bytes:
    """The byte stream Pillow's DXT1 / DXT3 / DXT5 decoders build: each
    row of blocks gives four rows of 4 x blocks pixels, RGBA (RGB for DXT1
    without alpha)."""
    size = 8 if kind == 0 else 16
    bx, by = (w + 3) // 4, (h + 3) // 4
    need = bx * by * size
    if len(data) < need:
        raise ValueError(f"{path}: truncated BLP file (Pillow: Truncated "
                         "File Read)")
    blk = np.frombuffer(data, np.uint8, need).reshape(by * bx, size)
    col = blk[:, size - 8:]
    c0 = col[:, 0].astype(np.int64) | col[:, 1].astype(np.int64) << 8
    c1 = col[:, 2].astype(np.int64) | col[:, 3].astype(np.int64) << 8
    codes = np.frombuffer(col[:, 4:].tobytes(), "<u4").astype(np.int64)
    sel = (codes[:, None] >> (2 * np.arange(16))) & 3
    four = (c0 > c1) if kind == 0 else np.ones(len(c0), bool)
    pal = _blp_colours(c0, c1, four)
    rgb = np.take_along_axis(pal, sel[..., None], 1)      # (n, 16, 3)
    if kind == 0:
        a = np.where((sel == 3) & ~four[:, None], 0, 255)
    elif kind == 1:
        nib = np.unpackbits(blk[:, :8], axis=1, bitorder="little").reshape(
            -1, 16, 4)
        a = (nib * (1 << np.arange(4))).sum(2) * 17
    else:
        a0 = blk[:, 0].astype(np.int64)[:, None]
        a1 = blk[:, 1].astype(np.int64)[:, None]
        v = np.zeros(len(blk), np.int64)
        for k in range(6):
            v |= blk[:, 2 + k].astype(np.int64) << (8 * k)
        code = (v[:, None] >> (3 * np.arange(16))) & 7
        hi = ((8 - code) * a0 + (code - 1) * a1) // 7
        lo = ((6 - code) * a0 + (code - 1) * a1) // 5
        lo = np.where(code == 6, 0, np.where(code == 7, 255, lo))
        a = np.where(code == 0, a0, np.where(code == 1, a1, np.where(
            a0 > a1, hi, lo)))
    px = np.concatenate([rgb, a[..., None]], -1)
    if kind == 0 and not alpha:
        px = px[..., :3]
    px = px.reshape(by, bx, 4, 4, -1).transpose(0, 2, 1, 3, 4)
    return px.astype(np.uint8).tobytes()


def _blp_palette(blob: bytes, at: int, path: str) -> np.ndarray:
    data = blob[at:at + 1024]
    if len(data) < 1024:
        raise ValueError(f"{path}: truncated BLP palette (Pillow: Truncated "
                         "File Read)")
    return np.frombuffer(data, np.uint8).reshape(256, 4)[:, [2, 1, 0, 3]]


def _raw_pixels(data: bytes, w: int, h: int, n: int, path: str
                ) -> np.ndarray:
    """set_as_raw: the stream's first w * h pixels of n bytes, row after
    row."""
    if len(data) < w * h * n:
        raise ValueError(f"{path}: not enough image data (Pillow refuses "
                         "it)")
    return np.frombuffer(data, np.uint8, w * h * n).reshape(h, w, n)


def decode_blp(blob: bytes, path: str) -> np.ndarray:
    ver, comp, enc, alpha, aenc, w, h, at = _blp(blob, path)
    if len(blob) < at + 128:
        raise ValueError(f"{path}: Truncated BLP file")
    offsets = struct.unpack_from("<16I", blob, at)
    lengths = struct.unpack_from("<16I", blob, at + 64)
    at += 128
    n = 4 if alpha else 3
    if ver == 1 and comp == 0:                 # JPEG
        if len(blob) < at + 4:
            raise ValueError(f"{path}: Truncated BLP file")
        hs = struct.unpack_from("<I", blob, at)[0]
        head = blob[at + 4:at + 4 + hs]
        pos = at + 4 + hs
        body = blob[offsets[0]:offsets[0] + lengths[0]]
        if len(head) < hs or offsets[0] < pos or len(body) < lengths[0]:
            raise ValueError(f"{path}: truncated BLP JPEG (Pillow: "
                             "Truncated File Read)")
        # a CMYK stream: BlpImagePlugin's plain "CMYK" raw mode gives the
        # samples Pillow's JPEG reader gives anyway
        rgb = jpeg.decode_jpeg(head + body, path)
        if rgb.shape[:2] != (h, w):
            raise ValueError(f"{path}: BLP JPEG of {rgb.shape[1]} x "
                             f"{rgb.shape[0]}, not {w} x {h} (Pillow: not "
                             "enough image data)")
        return np.ascontiguousarray(rgb[..., ::-1])
    if ver == 1:
        if comp != 1:
            raise ValueError(f"{path}: Unsupported BLP compression {enc!r}")
        if enc not in (4, 5):
            raise ValueError(f"{path}: Unsupported BLP encoding {enc!r}")
        pal = _blp_palette(blob, at, path)
        idx = blob[at + 1024:at + 1024 + lengths[0]]
    else:
        if comp != 1:
            raise ValueError(f"{path}: Unknown BLP compression {comp!r}")
        pal = _blp_palette(blob, at, path)
        if enc == 1:
            idx = blob[offsets[0]:offsets[0] + lengths[0]]
        elif enc == 2:
            if aenc not in (0, 1, 7):
                raise ValueError(f"{path}: Unsupported alpha encoding "
                                 f"{aenc!r}")
            data = _blp_dxt(blob[offsets[0]:], w, h, {0: 0, 1: 1, 7: 2}[aenc],
                            alpha, path)
            return np.ascontiguousarray(_raw_pixels(data, w, h, n, path)[
                ..., :3])
        else:
            raise ValueError(f"{path}: Unknown BLP encoding {enc!r}")
    if len(idx) < lengths[0]:
        raise ValueError(f"{path}: truncated BLP data (Pillow: Truncated "
                         "File Read)")
    data = pal[np.frombuffer(idx, np.uint8)][:, :n].tobytes()
    return np.ascontiguousarray(_raw_pixels(data, w, h, n, path)[..., :3])


# --------------------------------------------------------------- SPIDER

def _spider(blob: bytes, path: str):
    """SpiderImageFile._open: 27 floats, big-endian first."""
    if len(blob) < 108:
        raise ValueError(f"{path}: not a valid Spider file")
    for order in ">", "<":
        t = struct.unpack(order + "27f", blob[:108])
        hdr = _spider_hdr(t)
        if hdr:
            break
    else:
        raise ValueError(f"{path}: not a valid Spider file")
    h = (99.0,) + t
    if int(h[5]) != 1:
        raise ValueError(f"{path}: not a Spider 2D image")
    w, rows = int(h[12]), int(h[2])
    istack, imgnumber = int(h[24]), int(h[27])
    if istack == 0 and imgnumber == 0:
        offset = hdr
    elif istack > 0 and imgnumber == 0:
        offset = hdr * 2
    else:
        raise ValueError(f"{path}: Spider stack header values Pillow does "
                         "not open")
    if w <= 0 or rows <= 0:
        raise ValueError(f"{path}: empty Spider image")
    return order, w, rows, offset


def _isint(f: float) -> bool:
    try:
        return f - int(f) == 0
    except (ValueError, OverflowError):
        return False


def _spider_hdr(t) -> int:
    h = (99.0,) + t
    if not all(_isint(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return 0
    if int(h[22]) != int(h[13]) * int(h[23]):
        return 0
    return int(h[22])


def spider_probe(blob: bytes) -> bool:
    return _ok(_spider, blob)


def spider_header(blob: bytes, path: str) -> Tuple[str, int, int]:
    _, w, h, _ = _spider(blob, path)
    return "F", h, w


def decode_spider(blob: bytes, path: str) -> np.ndarray:
    order, w, h, at = _spider(blob, path)
    data = blob[at:at + 4 * w * h]
    if at < 0 or len(data) < 4 * w * h:
        raise _truncated(path, "Spider")
    return _f_to_rgb(np.frombuffer(data, order + "f4").reshape(h, w))


# ------------------------------------------------------------------ PCD

# Pillow's UnpackYCC.c tables (Kodak PhotoYCC), read out of its YCC;P
# unpacker: R = L[y] + CR[cr], G = L[y] + GR[cr] + GB[cb], B = L[y] +
# CB[cb], each clipped to 0..255. Each table is its first value and
# its 255 steps, less the smallest step, one digit a step.
_PCD = {
    "L": (0, 1, (
        "010010100100100100101001001001001010010010010010100100100101"
        "001001001001010010010010010100100100100101001001001001010010"
        "010010100100100100101001001001001010010010010010100100100101"
        "001001001001010010010010010100100100100101001001001010010010"
        "010010100100100"
    )),
    "CR": (-249, 1, (
        "111110111101111101111101111011111011110111110111110111101111"
        "101111011111011111011110111110111101111101111101111011111011"
        "110111110111110101101111101111101111011111011110111110111110"
        "111101111101111011111011111011110111110111101111101111101111"
        "011111011110111"
    )),
    "CB": (-345, 1, (
        "112111211112111121112111121112111121112111121111211121111211"
        "121111211112111211112111211112111121112111121112111121112111"
        "121111211121111211121111211112111210112111211112111121112111"
        "121112111121111211121111211121111211121111211112111211112111"
        "211112111121112"
    )),
    "GR": (127, -1, (
        "000000100000000000001000000000000010000000000001000000000000"
        "010000000000000100000000000010000000000000100000000000001000"
        "000000000010000001000001000000000000010000000000000100000000"
        "000001000000000000100000000000001000000000000010000000000001"
        "000000000000010"
    )),
    "GB": (67, -1, (
        "101011010101101010110101011010101011010101101010110101011010"
        "101101010110101011010101101010110101011010101101010110101010"
        "110101011010101101010110101011010101111010110101011010101101"
        "010110101011010101011010101101010110101011010101101010110101"
        "011010101101010"
    )),
}


def _pcd_table(name: str) -> np.ndarray:
    first, step, digits = _PCD[name]
    d = np.frombuffer("".join(digits).encode(), np.uint8).astype(
        np.int64) - 48 + step
    return np.concatenate([[first], first + np.cumsum(d)])


def pcd_ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray
                   ) -> np.ndarray:
    """Pillow's YCC;P unpacking of PhotoYCC samples."""
    L, CR, CB, GR, GB = (_pcd_table(k) for k in ("L", "CR", "CB", "GR",
                                                 "GB"))
    ly = L[y]
    rgb = np.stack([ly + CR[cr], ly + GR[cr] + GB[cb], ly + CB[cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _pcd(blob: bytes, path: str):
    s = blob[2048:2048 + 1539]
    if s[:4] != b"PCD_":
        raise ValueError(f"{path}: not a PCD file")
    if len(s) < 1539:
        raise ValueError(f"{path}: truncated PCD header")
    return s[1538] & 3


def pcd_header(blob: bytes, path: str) -> Tuple[str, int, int]:
    o = _pcd(blob, path)
    return ("RGB", 768, 512) if o in (1, 3) else ("RGB", 512, 768)


def decode_pcd(blob: bytes, path: str) -> np.ndarray:
    """PcdDecode: each pair of rows from 3 * 768 bytes (two Y rows, then
    768 / 2 Cb and Cr, shared by the pair), through the YCC;P unpacker;
    then rotated as the orientation bits say."""
    o = _pcd(blob, path)
    data = blob[96 * 2048:96 * 2048 + 256 * 3 * 768]
    if len(data) < 256 * 3 * 768:
        raise _truncated(path, "PCD")
    d = np.frombuffer(data, np.uint8).reshape(256, 3 * 768)
    y = d[:, :1536].reshape(512, 768)
    x = np.arange(768) // 2
    cb = np.repeat(d[:, 1536 + x], 2, 0)
    cr = np.repeat(d[:, 1920 + x], 2, 0)
    rgb = pcd_ycc_to_rgb(y, cb, cr)
    if o == 1:
        rgb = np.rot90(rgb, 1)
    elif o == 3:
        rgb = np.rot90(rgb, -1)
    return np.ascontiguousarray(rgb)


# ------------------------------------------------------------------ GBR

def _gbr(blob: bytes, path: str):
    if len(blob) < 20:
        raise ValueError(f"{path}: not a GIMP brush")
    size, ver, w, h, depth = struct.unpack_from(">5I", blob)
    if size < 20 or ver not in (1, 2) or w == 0 or h == 0 or \
            depth not in (1, 4):
        raise ValueError(f"{path}: not a GIMP brush Pillow opens")
    if ver == 2 and blob[20:24] != b"GIMP":
        raise ValueError(f"{path}: not a GIMP brush, bad magic number")
    at = 20 + (8 if ver == 2 else 0) + (size - (28 if ver == 2 else 20))
    return w, h, depth, at


def gbr_probe(blob: bytes) -> bool:
    return _ok(_gbr, blob)


def gbr_header(blob: bytes, path: str) -> Tuple[str, int, int]:
    w, h, depth, _ = _gbr(blob, path)
    return ("L" if depth == 1 else "RGBA"), h, w


def decode_gbr(blob: bytes, path: str) -> np.ndarray:
    w, h, depth, at = _gbr(blob, path)
    data = blob[at:at + w * h * depth] if at >= 0 else b""
    px = _raw_pixels(data, w, h, depth, path)
    return _grey(px[..., 0]) if depth == 1 else np.ascontiguousarray(
        px[..., :3])


# ------------------------------------------------------------------ FLI

def _i16(b: bytes, at: int) -> int:
    return b[at] | b[at + 1] << 8


def _i32(b: bytes, at: int) -> int:
    return struct.unpack_from("<i", b, at)[0]


def _fli(blob: bytes, path: str):
    """FliImageFile._open: the header, the first frame's palette."""
    s = blob[:128]
    if not (len(s) == 128 and _i16(s, 4) in (0xAF11, 0xAF12)
            and _i16(s, 14) in (0, 3) and s[20:22] == b"\0\0"
            and s[42:80] == bytes(38) and s[88:] == bytes(40)):
        raise ValueError(f"{path}: not an FLI/FLC file")
    w, h = _i16(s, 8), _i16(s, 10)
    pal = [(a, a, a) for a in range(256)]
    at = 128
    s = blob[at:at + 16].ljust(16, b"\0")
    if _i16(s, 4) == 0xF100:
        at = 128 + _i32(s, 0)
        s = blob[at:at + 16].ljust(16, b"\0")
    at += 16
    if _i16(s, 4) == 0xF1FA:
        size = None
        for _ in range(_i16(s, 6)):
            if size is not None:
                at += size - 6
            c = blob[at:at + 6].ljust(6, b"\0")
            at += 6
            kind = _i16(c, 4)
            if kind in (4, 11):
                shift = 2 if kind == 11 else 0
                i = 0
                for _ in range(_i16(blob[at:at + 2].ljust(2, b"\0"), 0)):
                    at += 2
                    sk = blob[at:at + 2].ljust(2, b"\0")
                    i += sk[0]
                    n = sk[1] or 256
                    at += 2
                    rgb = blob[at:at + 3 * n]
                    at += 3 * n
                    for k in range(0, len(rgb) - 2, 3):
                        if i > 255:
                            raise ValueError(f"{path}: FLI palette past 256"
                                             " entries")
                        pal[i] = (rgb[k] << shift & 255, rgb[k + 1] << shift
                                  & 255, rgb[k + 2] << shift & 255)
                        i += 1
                    at -= 2
                break
            size = _i32(c, 0)
            if not size:
                break
    if w <= 0 or h <= 0:
        raise ValueError(f"{path}: empty FLI image")
    return w, h, np.asarray(pal, np.uint8)


def fli_probe(blob: bytes) -> bool:
    return _ok(_fli, blob)


def fli_header(blob: bytes, path: str) -> Tuple[str, int, int]:
    w, h, _ = _fli(blob, path)
    return "P", h, w


def _fli_frame(data: bytes, w: int, h: int, path: str) -> np.ndarray:
    """FliDecode of one frame's bytes onto a black image."""
    img = np.zeros((h, w), np.uint8)
    bad = ValueError(f"{path}: FLI frame data overrun (Pillow refuses it)")
    n = len(data)
    if _i16(data, 4) != 0xF1FA:
        raise ValueError(f"{path}: FLI frame of an unknown chunk type "
                         "(Pillow refuses it)")
    chunks = _i16(data, 6)
    ptr = 16
    left = n - 16
    for _ in range(chunks):
        if left < 10:
            raise bad
        d = ptr + 6
        end = ptr + left

        def oob(k):
            if d + k > end:
                raise bad

        kind = _i16(data, ptr + 4)
        if kind in (4, 11, 18):
            pass
        elif kind == 7:                         # SS2, word deltas
            lines = _i16(data, d)
            d += 2
            y = l_ = 0
            while l_ < lines and y < h:
                oob(2)
                packets = _i16(data, d)
                d += 2
                row = img[y]
                while packets & 0x8000:
                    if packets & 0x4000:
                        y += 65536 - packets
                        if y >= h:
                            raise bad
                        row = img[y]
                    else:
                        row[w - 1] = packets & 255
                    oob(2)
                    packets = _i16(data, d)
                    d += 2
                x = p = 0
                while p < packets:
                    oob(2)
                    x += data[d]
                    if data[d + 1] >= 128:
                        oob(4)
                        i = 256 - data[d + 1]
                        if x + 2 * i > w:
                            break
                        row[x:x + 2 * i] = np.tile(np.frombuffer(
                            data[d + 2:d + 4], np.uint8), i)
                        x += 2 * i
                        d += 4
                    else:
                        i = 2 * data[d + 1]
                        if x + i > w:
                            break
                        oob(2 + i)
                        row[x:x + i] = np.frombuffer(data[d + 2:d + 2 + i],
                                                     np.uint8)
                        d += 2 + i
                        x += i
                    p += 1
                if p < packets:
                    break
                l_ += 1
                y += 1
            if l_ < lines:
                raise bad
        elif kind == 12:                        # LC, byte deltas
            y = _i16(data, d)
            ymax = y + _i16(data, d + 2)
            d += 4
            while y < ymax and y < h:
                oob(1)
                packets = data[d]
                d += 1
                x = p = 0
                i = 0
                while p < packets:
                    oob(2)
                    x += data[d]
                    if data[d + 1] & 0x80:
                        i = 256 - data[d + 1]
                        if x + i > w:
                            break
                        oob(3)
                        img[y, x:x + i] = data[d + 2]
                        d += 3
                    else:
                        i = data[d + 1]
                        if x + i > w:
                            break
                        oob(2 + i)
                        img[y, x:x + i] = np.frombuffer(
                            data[d + 2:d + 2 + i], np.uint8)
                        d += i + 2
                    p += 1
                    x += i
                if p < packets:
                    break
                y += 1
            if y < ymax:
                raise bad
        elif kind == 13:                        # BLACK
            img[:] = 0
        elif kind == 15:                        # BRUN
            for y in range(h):
                d += 1
                x = 0
                while x < w:
                    oob(2)
                    if data[d] & 0x80:
                        i = 256 - data[d]
                        if x + i > w:
                            break
                        oob(i + 1)
                        img[y, x:x + i] = np.frombuffer(
                            data[d + 1:d + 1 + i], np.uint8)
                        d += i + 1
                    else:
                        i = data[d]
                        if x + i > w:
                            break
                        img[y, x:x + i] = data[d + 1]
                        d += 2
                    x += i
                if x != w:
                    raise bad
        elif kind == 16:                        # COPY
            if d + w * h > end:
                raise ValueError(f"{path}: FLI COPY chunk past the frame "
                                 "(Pillow: image file is truncated)")
            img[:] = np.frombuffer(data[d:d + w * h], np.uint8).reshape(h, w)
        else:
            raise ValueError(f"{path}: FLI chunk of unknown type {kind} "
                             "(Pillow refuses it)")
        advance = _i32(data, ptr)
        if advance == 0:
            raise ValueError(f"{path}: FLI chunk of size 0 (Pillow refuses "
                             "it)")
        if advance < 0 or advance > left:
            raise bad
        ptr += advance
        left -= advance
    return img


def decode_fli(blob: bytes, path: str) -> np.ndarray:
    w, h, pal = _fli(blob, path)
    head = blob[128:132]
    if len(head) < 4:
        raise ValueError(f"{path}: FLI file without frames (Pillow: missing "
                         "frame size)")
    size = _i32(head, 0)
    data = blob[128:128 + max(size, 0)]
    if len(data) < 4 or len(data) + len(data) % 2 < size or len(data) < 8:
        raise _truncated(path, "FLI")
    return _lut(pal)[_fli_frame(data.ljust(16, b"\0"), w, h, path)]


# ----------------------------------------------------------------- FTEX

def _ftex(blob: bytes, path: str):
    if blob[:4] != b"FTEX" or len(blob) < 32:
        raise ValueError(f"{path}: not an FTEX file")
    w, h = struct.unpack_from("<2i", blob, 8)
    _, count = struct.unpack_from("<2i", blob, 16)
    if count != 1:
        raise ValueError(f"{path}: FTEX of {count} formats (Pillow asserts "
                         "one)")
    fmt, where = struct.unpack_from("<2i", blob, 24)
    if fmt not in (0, 1):
        raise ValueError(f"{path}: Invalid texture compression format: "
                         f"{fmt!r}")
    if len(blob) < where + 4 or where < 0:
        raise ValueError(f"{path}: truncated FTEX file")
    size = struct.unpack_from("<i", blob, where)[0]
    data = blob[where + 4:where + 4 + max(size, 0)]
    if w <= 0 or h <= 0:
        raise ValueError(f"{path}: empty FTEX image")
    return w, h, fmt, data


def ftex_header(blob: bytes, path: str) -> Tuple[str, int, int]:
    w, h, fmt, _ = _ftex(blob, path)
    return ("RGBA" if fmt == 0 else "RGB"), h, w


def decode_ftex(blob: bytes, path: str) -> np.ndarray:
    w, h, fmt, data = _ftex(blob, path)
    if fmt == 1:
        return np.ascontiguousarray(_raw_pixels(data, w, h, 3, path))
    bx, by = (w + 3) // 4, (h + 3) // 4
    if len(data) < 8 * bx * by:
        raise _truncated(path, "FTEX")
    blocks = np.frombuffer(data, np.uint8, 8 * bx * by).reshape(-1, 8)
    px = dds._bcn(blocks, 1, path).reshape(by, bx, 4, 4, 3).transpose(
        0, 2, 1, 3, 4).reshape(by * 4, bx * 4, 3)
    return np.ascontiguousarray(px[:h, :w]).astype(np.uint8)


# ---------------------------------------------------------------- PIXAR

def _pixar(blob: bytes, path: str):
    if blob[:4] != b"\x80\xe8\0\0" or len(blob) < 428:
        raise ValueError(f"{path}: not a PIXAR file")
    w, h = _i16(blob, 418), _i16(blob, 416)
    if (_i16(blob, 424), _i16(blob, 426)) != (14, 2) or w <= 0 or h <= 0:
        raise ValueError(f"{path}: PIXAR of a mode Pillow does not open")
    return w, h


def pixar_probe(blob: bytes) -> bool:
    return _ok(_pixar, blob)


def pixar_header(blob: bytes, path: str) -> Tuple[str, int, int]:
    w, h = _pixar(blob, path)
    return "RGB", h, w


def decode_pixar(blob: bytes, path: str) -> np.ndarray:
    w, h = _pixar(blob, path)
    data = blob[1024:1024 + 3 * w * h]
    if len(data) < 3 * w * h:
        raise _truncated(path, "PIXAR")
    return np.frombuffer(data, np.uint8).reshape(h, w, 3).copy()


# --------------------------------------------------------------- MCIDAS

def _mcidas(blob: bytes, path: str):
    s = blob[:256]
    if s[:8] != b"\0\0\0\0\0\0\0\x04" or len(s) != 256:
        raise ValueError(f"{path}: not an McIdas area file")
    w = (0,) + struct.unpack("!64i", s)
    kind = {1: ("L", "u1"), 2: ("I;16B", ">u2"), 4: ("I", ">i4")}.get(w[11])
    if kind is None:
        raise ValueError(f"{path}: unsupported McIdas format")
    if w[10] <= 0 or w[9] <= 0:
        raise ValueError(f"{path}: empty McIdas image")
    return w[10], w[9], kind, w[34] + w[15], w[15] + w[10] * w[11] * w[14]


def mcidas_probe(blob: bytes) -> bool:
    return _ok(_mcidas, blob)


def mcidas_header(blob: bytes, path: str) -> Tuple[str, int, int]:
    w, h, (mode, _), _, _ = _mcidas(blob, path)
    return mode, h, w


def decode_mcidas(blob: bytes, path: str) -> np.ndarray:
    w, h, (mode, dt), at, stride = _mcidas(blob, path)
    n = np.dtype(dt).itemsize
    if stride < w * n or at < 0:
        raise ValueError(f"{path}: McIdas lines shorter than their pixels")
    data = blob[at:at + stride * h]
    if len(data) < stride * h:
        raise _truncated(path, "McIdas")
    rows = np.frombuffer(data, np.uint8).reshape(h, stride)[:, :w * n]
    v = np.ascontiguousarray(rows).view(dt).reshape(h, w)
    return _grey(v) if mode == "L" else _i_to_rgb(v)


# ------------------------------------------------------------------ IMT

_IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def _imt(blob: bytes, path: str):
    """ImtImageFile._open: "key value" lines until a form feed, then the
    grey pixels."""
    if b"\n" not in blob[:100]:
        raise ValueError(f"{path}: not an IM Tools file")
    at, w, h, grey, start = 0, 0, 0, False, None
    while at < len(blob):
        c = blob[at:at + 1]
        at += 1
        if c == b"\x0c":
            start = at
            break
        end = blob.find(b"\n", at)
        end = len(blob) if end < 0 else end
        line, at = c + blob[at:end], end + 1
        if len(line) == 1 or len(line) > 100:
            break
        if line[:1] == b"*":
            continue
        m = _IMT_FIELD.match(line)
        if not m:
            break
        k, v = m.groups()
        if k in (b"width", b"height"):
            try:
                n = int(v)
            except ValueError:
                raise ValueError(f"{path}: IM Tools {k.decode()} {v!r}") \
                    from None
            w, h = (n, h) if k == b"width" else (w, n)
        elif k == b"pixel" and v == b"n8":
            grey = True
    if not (w > 0 and h > 0 and grey):
        raise ValueError(f"{path}: not an IM Tools file Pillow opens")
    return w, h, start


def imt_probe(blob: bytes) -> bool:
    return _ok(_imt, blob)


def imt_header(blob: bytes, path: str) -> Tuple[str, int, int]:
    w, h, _ = _imt(blob, path)
    return "L", h, w


def decode_imt(blob: bytes, path: str) -> np.ndarray:
    w, h, at = _imt(blob, path)
    if at is None:
        raise ValueError(f"{path}: IM Tools file without its form feed "
                         "(Pillow: cannot load this image)")
    data = blob[at:at + w * h]
    if len(data) < w * h:
        raise _truncated(path, "IM Tools")
    return _grey(np.frombuffer(data, np.uint8).reshape(h, w))


# ----------------------------------------------------------------- IPTC

def _iptc_field(blob: bytes, at: int, path: str):
    s = blob[at:at + 5]
    if not s.strip(b"\0"):
        return None, 0, at + len(s)
    if len(s) < 5:
        raise ValueError(f"{path}: truncated IPTC/NAA field")
    tag = (s[1], s[2])
    if s[0] != 0x1C or tag[0] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
        raise ValueError(f"{path}: invalid IPTC/NAA file")
    size = s[3]
    at += 5
    if size > 132:
        raise ValueError(f"{path}: illegal field length in IPTC/NAA file")
    if size == 128:
        size = 0
    elif size > 128:
        size = int.from_bytes(blob[at:at + size - 128].rjust(4, b"\0")[-4:],
                              "big")
        at += s[3] - 128
    else:
        size = s[3] << 8 | s[4]
    return tag, size, at


def _iptc(blob: bytes, path: str):
    info, at = {}, 0
    while True:
        start = at
        tag, size, at = _iptc_field(blob, at, path)
        if not tag or tag == (8, 10):
            break
        data = blob[at:at + size] if size else None
        at += size
        if tag in info:
            info[tag] = info[tag] + [data] if isinstance(info[tag], list) \
                else [info[tag], data]
        else:
            info[tag] = data

    def getint(k):
        if k not in info:
            raise ValueError(f"{path}: IPTC without dataset {k}")
        v = info[k]
        v = v[0] if isinstance(v, list) else v
        return int.from_bytes((b"\0\0\0\0" + (v or b""))[-4:], "big")

    if (3, 60) not in info or not info[(3, 60)] or \
            isinstance(info[(3, 60)], list) or len(info[(3, 60)]) < 2:
        raise ValueError(f"{path}: IPTC without its image type (3, 60)")
    layers, comp = info[(3, 60)][0], info[(3, 60)][1]
    band = None
    mode = ""
    if layers == 1 and not comp:
        mode = "L"
    else:
        if layers == 3 and comp:
            mode = "RGB"
        elif layers == 4 and comp:
            mode = "CMYK"
        band = info[(3, 65)][0] - 1 if (3, 65) in info and info[(3, 65)] \
            else 0
    w, h = getint((3, 20)), getint((3, 30))
    compression = {1: "raw", 5: "jpeg"}.get(getint((3, 120)))
    if compression is None:
        raise ValueError(f"{path}: Unknown IPTC image compression")
    if not mode or w <= 0 or h <= 0:
        raise ValueError(f"{path}: IPTC of a mode Pillow does not open")
    return mode, w, h, compression, band, (start if tag == (8, 10) else None)


def iptc_probe(blob: bytes) -> bool:
    return _ok(_iptc, blob)


def iptc_header(blob: bytes, path: str) -> Tuple[str, int, int]:
    mode, w, h, _, _, _ = _iptc(blob, path)
    return mode, h, w


def decode_iptc(blob: bytes, path: str) -> np.ndarray:
    """IptcImageFile.load: the (8, 10) datasets' bytes, a P5 header put
    before raw ones, opened as an image; for RGB / CMYK it becomes one
    band, the others zero."""
    from . import images
    mode, w, h, compression, band, at = _iptc(blob, path)
    if at is None:
        raise ValueError(f"{path}: IPTC file without image data (Pillow: "
                         "cannot load this image)")
    body = bytearray(b"P5\n%d %d\n255\n" % (w, h) if compression == "raw"
                     else b"")
    while True:
        tag, size, at = _iptc_field(blob, at, path)
        if tag != (8, 10):
            break
        body += blob[at:at + size]
        at += size
    body = bytes(body)
    if compression == "raw":
        inner, inner_mode = images.decode_pnm(body, path), \
            images._pnm_header(body, path).mode
    else:
        inner, inner_mode = jpeg.decode_jpeg(body, path), \
            jpeg.jpeg_header(body, path)[0]
    if band is None:
        return inner
    if inner_mode != "L":
        raise ValueError(f"{path}: IPTC band of mode {inner_mode} (Pillow: "
                         "mode mismatch)")
    if inner.shape[:2] != (h, w):
        raise ValueError(f"{path}: IPTC band of another size (Pillow: "
                         "images do not match)")
    n = 3 if mode == "RGB" else 4
    planes = np.zeros((h, w, n), np.uint8)
    planes[..., band] = inner[..., 0]
    return planes if mode == "RGB" else _cmyk(planes)


# -------------------------------------------------------------- XVThumb

_XV_PALETTE = np.asarray([(r * 255 // 7, g * 255 // 7, b * 255 // 3)
                          for r in range(8) for g in range(8)
                          for b in range(4)], np.uint8)


def _xv(blob: bytes, path: str):
    if blob[:6] != b"P7 332":
        raise ValueError(f"{path}: not an XV thumbnail file")
    f = _Lines(blob, 6)
    f.readline()
    while True:
        s = f.readline()
        if not s:
            raise ValueError(f"{path}: Unexpected EOF reading XV thumbnail "
                             "file")
        if s[0] != 35:
            break
    parts = s.strip().split(maxsplit=2)[:2]
    try:
        w, h = int(parts[0]), int(parts[1])
    except (ValueError, IndexError):
        raise ValueError(f"{path}: XV thumbnail size {s!r}") from None
    if w <= 0 or h <= 0:
        raise ValueError(f"{path}: empty XV thumbnail")
    return w, h, f.at


def xv_header(blob: bytes, path: str) -> Tuple[str, int, int]:
    w, h, _ = _xv(blob, path)
    return "P", h, w


def decode_xv(blob: bytes, path: str) -> np.ndarray:
    w, h, at = _xv(blob, path)
    data = blob[at:at + w * h]
    if len(data) < w * h:
        raise _truncated(path, "XV thumbnail")
    return _lut(_XV_PALETTE)[np.frombuffer(data, np.uint8).reshape(h, w)]


def _ok(fn, blob: bytes) -> bool:
    try:
        fn(blob, "")
        return True
    except (ValueError, IndexError, struct.error):
        return False
