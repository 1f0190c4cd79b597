"""Image files for training, the tester and the codec CLIs: listings (and
their cache CLI, `python -m l3c_torch.data.images update|show CACHE_PKL
[SPEC] [--min_size N]`), training batches, testsets, and the image
formats.

Port of `l3c_tpu/data/images.py` (`iter_images_in`, `ImagesCached`,
`load_image_uint8`, `random_crop_flip`, `TrainBatches`, `Testset`). The
training batches are the JAX package's bit for bit for the same paths,
seed and flags: both draw from one np.random.RandomState in the same
order. The JAX package reads images with Pillow; the port depends on
torch, numpy and the standard library only, so it reads the formats
itself, told apart by their bytes in the order Pillow's Image.open tries
its plugins (`image_format`), damaged files included, each as the JAX
loader reads it or refused where it refuses:
  - PNG (zlib + numpy; it also writes them): every bit depth (1, 2, 4, 8
    and 16) and colour type (grey, RGB, palette, grey + alpha, RGBA) the
    standard defines, non-interlaced and Adam7, all five row filters;
    read as PngImagePlugin reads it: the CRCs of the chunks before the
    image data checked, IDAT's not, the data inflated only until the
    image is complete (zlib's check read where its bytes come with the
    last rows), the chunks after it unchecked, a palette's missing
    entries black;
  - JPEG (data/jpeg.py: Huffman and arithmetic-coded, sequential,
    progressive and lossless, grey, colour and CMYK / YCCK, block
    smoothing and libjpeg-turbo's recovery from corrupt data, decoded as
    Pillow's libjpeg-turbo decodes them);
  - WebP (data/webp.py: lossy, lossless, with alpha, extended, and an
    animation's first frame, as Pillow's libwebp decodes them);
  - PNM: P1 to P6, binary and ASCII, any maxval (scaled as Pillow scales
    it; 16-bit grey as Pillow's mode "I"), float Pf (mode "F", clipped
    to 0..255 and truncated) and Pillow's own P0CMYK, PyP, PyRGBA and
    PyCMYK;
  - BMP: 1, 4 and 8-bit palettes (Pillow's "1" and "L" where the palette
    is its grey ramp, rows of fewer bits read as the JAX loader's Pillow
    reads them from a file), RLE8 and RLE4, 16-bit (5-5-5 and 5-6-5), 24
    and 32 bits with the bit-field layouts Pillow reads, OS/2,
    BITMAPINFOHEADER and V4 / V5 headers, bottom-up and top-down rows;
  - JPEG 2000 (data/jpeg2000.py: JP2 files and raw codestreams, 5/3 and
    9/7, every progression, tiles, precincts, layers, code-block style,
    ROI, sub-sampled, palette and CMYK components, and HTJ2K's HT
    code-blocks (data/jpeg2000_ht.py), decoded as Pillow's OpenJPEG 2.5
    decodes them);
  - GIF (data/gif.py), TIFF (data/tiff.py, with data/ccitt.py for CCITT,
    data/zstd.py for ZSTD and data/cielab.py for CIELAB), TGA, ICO, CUR,
    PCX, DCX, SGI, QOI, IM, MSP, SUN, PSD (data/rasters.py), DDS
    (data/dds.py), ICNS (data/icns.py: RLE icons and their masks, PNG and
    JPEG 2000 payloads) and DIB;
  - the rest of Pillow's registry (data/registry.py): XBM, XPM, FITS,
    BLP, SPIDER, PCD, GBR, FLI, FTEX, PIXAR, MCIDAS, IMT, IPTC, XVThumb;
  - AVIF stills and image sequences (data/avif.py: libavif's container
    checks and its choice between the primary item and the tracks;
    a sequence, with or without a meta box, read as frame 0 of its
    colour track, data/avif_moov.py; the AV1
    intra decoder of data/av1_*.py with its in-loop filters, deblocking,
    CDEF and loop restoration, film grain, grids of cells, frames scaled
    to ispe (a track's frames to tkhd's size) by libyuv's ScalePlane in
    data/avif_scale.py, libyuv's and
    libavif's own YUV to RGB in data/avif_yuv.py; 8, 10 and 12 bits;
    superres, per-block loop filter deltas and segment reference
    features; hidden frames shown by show_existing_frame), as Pillow's
    libavif 1.3.0, dav1d 1.5.1 and libyuv give them; the one AV1 case
    the port does not decode yet, an inter frame after a hidden key
    frame, raises ValueError naming it.
Anything else (hierarchical JPEG, JPEG-in-BMP, a 2-bit BMP, ...) raises
ValueError naming the format and the reason. PNGs are written with the
bytes of Pillow's default save (`write_png`). Every image comes out as
RGB the way Pillow's convert("RGB") gives it: grey replicated, the
palette looked up, alpha dropped, CMYK through Pillow's cmyk2rgb, 16-bit
samples cut to their high byte (16-bit grey clipped at 255); `image_mode`
gives the mode Pillow would open the file in.
"""
from __future__ import annotations

import glob
import math
import os
import pickle
import queue
import re
import struct
import threading
import zlib
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from . import (avif, dds, gif, icns, jpeg, jpeg2000, rasters, registry,
               tiff, webp)

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".ppm", ".webp")
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}                       # colour type -> bit depths
# Adam7's seven passes: first column, first row, column step, row step
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _is_image(p: str) -> bool:
    return p.lower().endswith(IMG_EXTS)


def iter_images_in(root_or_glob: str) -> List[str]:
    """Accepts a dir, a glob, or a single file; returns sorted paths."""
    if os.path.isfile(root_or_glob):
        return [root_or_glob]
    if os.path.isdir(root_or_glob):
        out = []
        for base, _, files in os.walk(root_or_glob):
            out.extend(os.path.join(base, f) for f in files
                       if _is_image(f))
        return sorted(out)
    return sorted(p for p in glob.glob(root_or_glob, recursive=True)
                  if _is_image(p))


# ------------------------------------------------------------------- PNG


_CHUNK_TYPE = re.compile(rb"\w\w\w\w")    # PngImagePlugin's is_cid


def _png_open(blob: bytes, path: str) -> Tuple[bytes, Optional[bytes], int,
                                              int]:
    """PngImagePlugin's _open: the signature, then every chunk up to the
    first IDAT, its CRC checked -> (IHDR's data, PLTE's or None, the
    offset of the first IDAT's data, its length as stated)."""
    if blob[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file (the port reads PNG only)")
    at, ihdr, palette = 8, None, None
    while True:
        head = blob[at:at + 8]
        if len(head) < 8 or not _CHUNK_TYPE.match(head[4:]):
            raise ValueError(f"{path}: truncated or broken PNG (chunk "
                             f"header {head!r})")
        size, ctype = struct.unpack(">I4s", head)
        at += 8
        if ctype == b"IDAT":
            if ihdr is None:
                raise ValueError(f"{path}: PNG does not start with IHDR")
            return ihdr, palette, at, size
        if ctype == b"IEND":
            raise ValueError(f"{path}: PNG without image data")
        data, crc = blob[at:at + size], blob[at + size:at + size + 4]
        if len(data) != size or len(crc) != 4:
            raise ValueError(f"{path}: truncated PNG chunk {ctype!r}")
        if zlib.crc32(ctype + data) & 0xFFFFFFFF != struct.unpack(">I",
                                                                  crc)[0]:
            raise ValueError(f"{path}: CRC mismatch in chunk {ctype!r}")
        if ctype == b"IHDR":
            if size < 13:
                raise ValueError(f"{path}: truncated PNG IHDR chunk")
            ihdr = data[:13]
        elif ctype == b"PLTE":
            palette = data
        at += size + 4


def _png_data(blob: bytes, at: int, size: int, need: int, path: str
              ) -> Tuple[bytes, int]:
    """The image data as Pillow's ZipDecode inflates it -> (the first
    `need` bytes, zero rows after an early end of the stream excepted;
    the offset where PngImageFile.load_end goes on). Pillow feeds the
    decoder what load_read returns: consecutive IDAT chunks' data, their
    CRCs skipped, up to 64 KiB a read, so the decoder stops as soon as the
    image is complete, and zlib's check is read only where its bytes came
    with the last rows. A chunk header that breaks off the data refuses
    the file where the image is not complete."""
    d = zlib.decompressobj()
    out, got, left = [], 0, size
    while True:
        while left == 0:
            head = blob[at + 4:at + 12]
            if len(head) < 8 or not _CHUNK_TYPE.match(head[4:]):
                raise ValueError(f"{path}: truncated or broken PNG (chunk "
                                 f"header {head!r} in the image data)")
            left, ctype = struct.unpack(">I4s", head)
            if ctype not in (b"IDAT", b"fdAT", b"DDAT"):
                raise ValueError(f"{path}: truncated PNG data (holds "
                                 f"{got} bytes, expected {need})")
            at += 12
            if ctype == b"fdAT":
                at, left = at + 4, left - 4
        n = min(1 << 16, left)
        piece = blob[at:at + n]
        at, left = at + n, left - n
        if not piece:
            raise ValueError(f"{path}: truncated PNG data (holds {got} "
                             f"bytes, expected {need})")
        try:
            part = d.decompress(piece, need - got)
        except zlib.error as e:
            raise ValueError(f"{path}: corrupt PNG data ({e})") from e
        out.append(part)
        got += len(part)
        if got >= need or d.eof:
            return b"".join(out), at + left


def _png_tail(blob: bytes, at: int, path: str) -> None:
    """PngImageFile.load_end after the image data: chunks up to IEND, no
    CRC checked; a broken chunk header ends the walk, a chunk whose data
    the file cuts short refuses it."""
    while True:
        head = blob[at + 4:at + 12]
        if len(head) < 8 or not _CHUNK_TYPE.match(head[4:]) or \
                head[4:] == b"IEND":
            return
        size = struct.unpack(">I", head[:4])[0]
        at += 12 + size
        if at > len(blob):
            raise ValueError(f"{path}: truncated PNG chunk {head[4:]!r}")


def _header(data: bytes, path: str) -> Tuple[int, int, int, int, int]:
    """IHDR -> (width, height, bit depth, colour type, interlace),
    refusing what the PNG standard does not define."""
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB",
                                                              data)
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: PNG colour type {ctype} is not defined")
    if depth not in _DEPTHS[ctype]:
        raise ValueError(f"{path}: bit depth {depth} is not defined for "
                         f"PNG colour type {ctype}")
    if comp or filt or interlace > 1:
        raise ValueError(f"{path}: unknown PNG compression, filter or "
                         "interlace method")
    if w < 1 or h < 1:
        raise ValueError(f"{path}: empty image {w}x{h}")
    return w, h, depth, ctype, interlace


# Pillow's mode for a PNG's (colour type, bit depth)
_PNG_MODES = {(0, 1): "1", (0, 16): "I;16", (4, 16): "RGBA", 0: "L",
              2: "RGB", 3: "P", 4: "LA", 6: "RGBA"}


def png_header(blob: bytes, path: str) -> Tuple[str, int, int]:
    """(Pillow's mode, height, width) from the IHDR, the chunks before the
    image data checked as Pillow's Image.open checks them, without
    decoding pixels."""
    w, h, depth, colour, _ = _header(_png_open(blob, path)[0], path)
    return _PNG_MODES.get((colour, depth), _PNG_MODES[colour]), h, w


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor of left a, up b, up-left c (int arrays)."""
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(ftype: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Undo the row filters: ftype (H,), data (H, W, bpp) filtered bytes
    -> (H, W, bpp) uint8. A pixel needs its left, up and up-left
    neighbours, so the image is walked along anti-diagonals: all pixels of
    one diagonal are independent, H + W - 1 vectorised steps in all."""
    H, W, bpp = data.shape
    if ftype.max(initial=0) > 4:
        raise ValueError(f"bad PNG filter type {int(ftype.max())}")
    out = np.zeros((H + 1, W + 1, bpp), np.int32)    # zero border: row 0,
    raw = data.astype(np.int32)                      # column 0
    for d in range(H + W - 1):
        r = np.arange(max(0, d - W + 1), min(H - 1, d) + 1)
        x = d - r
        a, b, c = out[r + 1, x], out[r, x + 1], out[r, x]
        f = ftype[r][:, None]
        pred = np.where(f == 1, a, np.where(f == 2, b, np.where(
            f == 3, (a + b) >> 1, np.where(f == 4, _paeth(a, b, c), 0))))
        out[r + 1, x + 1] = (raw[r, x] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def _samples(raw: bytes, w: int, h: int, ch: int, depth: int,
             path: str) -> np.ndarray:
    """Unfilter the h rows of a (sub)image w pixels wide from the start of
    `raw`: (h, w, ch) samples (uint8, or uint16 at depth 16)."""
    row = (w * ch * depth + 7) // 8
    bpp = max(1, ch * depth // 8)          # the filters' byte distance
    if len(raw) < h * (1 + row):
        raise ValueError(f"{path}: PNG data holds {len(raw)} bytes, "
                         f"expected {h * (1 + row)}")
    rows = np.frombuffer(raw, np.uint8, h * (1 + row)).reshape(h, 1 + row)
    px = _unfilter(rows[:, 0], rows[:, 1:].reshape(h, row // bpp, bpp))
    px = px.reshape(h, row)
    if depth == 16:
        return px.view(">u2").reshape(h, w, ch).astype(np.uint16)
    if depth < 8:
        bits = np.unpackbits(px, axis=1).reshape(h, row * 8 // depth, depth)
        px = (bits << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(
            2, dtype=np.uint8)[:, :w * ch]
    return px.reshape(h, w, ch)


def _png_size(w: int, h: int, ch: int, depth: int, interlace: int) -> int:
    """Bytes of filtered image data: one image, or Adam7's seven passes."""
    if not interlace:
        return h * (1 + (w * ch * depth + 7) // 8)
    n = 0
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
        if pw > 0 and ph > 0:            # an empty pass has no bytes at all
            n += ph * (1 + (pw * ch * depth + 7) // 8)
    return n


def _png_pixels(raw: bytes, w: int, h: int, ch: int, depth: int,
                interlace: int, path: str) -> np.ndarray:
    """(h, w, ch) samples of the decompressed image data: one image, or
    Adam7's seven passes one after another, each filtered on its own."""
    if not interlace:
        return _samples(raw, w, h, ch, depth, path)
    out = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    at = 0
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
        if pw < 1 or ph < 1:
            continue
        out[y0::dy, x0::dx] = _samples(raw[at:], pw, ph, ch, depth, path)
        at += ph * (1 + (pw * ch * depth + 7) // 8)
    return out


def read_png(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a PNG file, as Pillow's convert("RGB") gives
    it: grey at 1, 2 and 4 bits scaled to 0..255 (16-bit grey clipped at
    255), the palette looked up (black past its end), 16-bit samples'
    high byte, grey + alpha replicated and alpha dropped. The file is read
    as Pillow reads it: the chunks before the image data CRC-checked, the
    image data's (IDAT) CRCs not, the decoder stopping once the image is
    complete (a stream that ends cleanly at a row before it leaves the
    rest zero), the chunks after it unchecked."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_png(blob: bytes, path: str) -> np.ndarray:
    """read_png of a file's bytes."""
    ihdr, palette, at, size = _png_open(blob, path)
    w, h, depth, colour, interlace = _header(ihdr, path)
    ch = _CHANNELS[colour]
    need = _png_size(w, h, ch, depth, interlace)
    raw, at = _png_data(blob, at, size, need, path)
    if len(raw) < need:
        row = 1 + (w * ch * depth + 7) // 8
        if interlace or len(raw) % row:
            raise ValueError(f"{path}: PNG data holds {len(raw)} bytes, "
                             f"expected {need}")
        raw += bytes(need - len(raw))
    _png_tail(blob, at, path)
    px = _png_pixels(raw, w, h, ch, depth, interlace, path)
    if colour == 3:
        if palette is None:
            raise ValueError(f"{path}: PNG palette missing")
        lut = np.zeros((256, 3), np.uint8)
        n = min(len(palette) // 3, 256)
        lut[:n] = np.frombuffer(palette[:3 * n], np.uint8).reshape(n, 3)
        return lut[px[..., 0]]
    if colour == 0:
        grey = (np.minimum(px, 255) if depth == 16
                else px * np.uint8(255 // ((1 << depth) - 1)))
        return np.repeat(grey.astype(np.uint8), 3, axis=2)
    if depth == 16:
        px = (px >> 8).astype(np.uint8)
    if colour == 4:
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


# The row filters Pillow's ZipEncode.c tries, in its order: a later one is
# taken only where its bytes are strictly better. Average is tried only
# under save(..., optimize=True).
PNG_FILTERS = (0, 2, 1, 4)               # None, Up, Sub, Paeth
PNG_FILTERS_OPTIMIZE = (0, 2, 1, 3, 4)   # None, Up, Sub, Average, Paeth


def png_filter_rows(img: np.ndarray, filters: Sequence[int] = PNG_FILTERS
                    ) -> np.ndarray:
    """(H, W[, C]) uint8 -> (H, 1 + W C) uint8 filtered rows, each with its
    filter byte, as Pillow's ZipEncode.c filters them: each row takes the
    first of `filters` whose filtered bytes v have the least sum of
    min(v, 256 - v)."""
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * bpp).astype(np.int32)
    up = np.zeros_like(rows)
    up[1:] = rows[:-1]
    left = np.zeros_like(rows)
    left[:, bpp:] = rows[:, :-bpp]
    upleft = np.zeros_like(rows)
    upleft[1:] = left[:-1]
    pred = {0: 0, 1: left, 2: up, 3: (left + up) >> 1,
            4: _paeth(left, up, upleft)}
    cands = np.stack([(rows - pred[f]) & 255 for f in filters])
    cost = np.minimum(cands, 256 - cands).sum(-1)     # (len(filters), h)
    best = np.argmin(cost, 0)                         # first of the least
    data = np.empty((h, 1 + w * bpp), np.uint8)
    data[:, 0] = np.asarray(filters, np.uint8)[best]
    data[:, 1:] = cands[best, np.arange(h)]
    return data


def png_deflate(rows: np.ndarray, level: int) -> bytes:
    """The zlib stream ZipEncode.c writes for filtered rows: deflate at
    `level`, window 15, memLevel 9, Z_FILTERED. Its bytes are this zlib's
    (zlib.ZLIB_RUNTIME_VERSION): equal to Pillow's where both use one."""
    z = zlib.compressobj(level, zlib.DEFLATED, 15, 9, zlib.Z_FILTERED)
    return z.compress(rows.tobytes()) + z.flush()


def png_idat_block(w: int) -> int:
    """Bytes of each IDAT chunk but the last: ImageFile._save's buffer for
    an image w pixels wide."""
    return max(65536, 4 * w)


def write_png(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3) uint8 RGB as an 8-bit colour-type-2 PNG with the
    bytes of Pillow's default save (Image.fromarray(img).save(path)): rows
    filtered by png_filter_rows, deflated at level 6, the stream cut into
    IDAT chunks of png_idat_block(W) bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got "
                         f"{img.dtype} {img.shape}")
    h, w, _ = img.shape
    stream = png_deflate(png_filter_rows(img), 6)
    block = png_idat_block(w)

    def chunk(ctype: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + ctype + data
                + struct.pack(">I", zlib.crc32(ctype + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        for at in range(0, len(stream), block):
            f.write(chunk(b"IDAT", stream[at:at + block]))
        f.write(chunk(b"IEND", b""))


# ------------------------------------------------------------- PNM, BMP

_WHITESPACE = b" \t\n\x0b\x0c\r"
_PNM_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L",
              b"P6": "RGB", b"Pf": "F", b"P0CMYK": "CMYK", b"PyP": "P",
              b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}   # Pillow's extensions
_PNM_CHANNELS = {"RGB": 3, "RGBA": 4, "CMYK": 4}


class _Pnm(NamedTuple):
    magic: bytes
    width: int
    height: int
    maxval: int     # 1 for P1 and P4; Pf: -1 little-endian, 1 big-endian
    mode: str       # Pillow's: "1", "L", "I" (grey past 8 bits), "RGB" or
    offset: int     # "F" (Pf); the offset of the pixel data


def _pnm_header(blob: bytes, path: str) -> _Pnm:
    """PpmImagePlugin's header walk: the magic up to whitespace, then
    tokens of at most 10 bytes between whitespace and '#' comments, the
    data starting after the byte that ends the last one."""
    at, magic = 0, b""
    while at < min(6, len(blob)):
        c = blob[at:at + 1]
        at += 1
        if c in _WHITESPACE:
            break
        magic += c
    if magic not in _PNM_MODES:
        raise ValueError(f"{path}: PNM type {magic.decode(errors='replace')}"
                         "; P1 to P6, Pf and Pillow's P0CMYK, PyP, PyRGBA "
                         "and PyCMYK are read")

    def token(number=int):
        nonlocal at
        tok = b""
        while len(tok) <= 10 and at < len(blob):
            c = blob[at:at + 1]
            at += 1
            if c in _WHITESPACE:
                if tok:
                    break
            elif c == b"#":
                while at < len(blob) and blob[at:at + 1] not in b"\r\n":
                    at += 1
                at += 1
            else:
                tok += c
        if len(tok) > 10 or number is int and not tok.isdigit():
            raise ValueError(f"{path}: malformed PNM header")
        try:
            return number(tok)
        except ValueError:
            raise ValueError(f"{path}: malformed PNM header") from None

    w, h = token(), token()
    if magic == b"Pf":                # the scale's sign gives the byte order
        scale = token(float)
        if scale == 0 or not math.isfinite(scale):
            raise ValueError(f"{path}: PNM scale {scale}, not finite and "
                             "non-zero")
        if w < 1 or h < 1:
            raise ValueError(f"{path}: empty image {w}x{h}")
        return _Pnm(magic, w, h, -1 if scale < 0 else 1, "F", at)
    maxval = 1 if magic in (b"P1", b"P4") else token()
    if not 0 < maxval < 65536:
        raise ValueError(f"{path}: PNM maxval {maxval} out of 1..65535")
    if w < 1 or h < 1:
        raise ValueError(f"{path}: empty image {w}x{h}")
    mode = _PNM_MODES[magic]
    if mode == "L" and maxval > 255:
        mode = "I"
    return _Pnm(magic, w, h, maxval, mode, at)


def _plain_tokens(data: bytes) -> List[bytes]:
    """The ASCII (P1-P3) data's tokens, '#' comments to a line's end cut
    out first."""
    parts = data.split(b"#")
    kept = [parts[0]]
    for part in parts[1:]:
        ends = [i for i in (part.find(b"\n"), part.find(b"\r")) if i >= 0]
        kept.append(part[min(ends) + 1:] if ends else b"")
    return b"".join(kept).split()


def decode_pnm(blob: bytes, path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a PNM's bytes (P1-P6, Pf, and Pillow's own
    P0CMYK, PyP, PyRGBA, PyCMYK) as Pillow's convert("RGB") gives it: a
    maxval other than 255 (65535 for 16-bit grey) scaled by Pillow's
    round(v / maxval * out_max), grey past 8 bits clipped at 255, bitmaps
    0 or 255, float samples clipped to 0..255 and truncated (NaN 0), grey
    replicated, alpha dropped, CMYK by Pillow's cmyk2rgb, a palette image
    without its palette black."""
    hd = _pnm_header(blob, path)
    w, h, maxval = hd.width, hd.height, hd.maxval
    if hd.mode == "F":          # float32 rows bottom-up; convert("RGB")
        n = 4 * w * h           # clips at 0 and 255 and truncates
        if len(blob) - hd.offset < n:
            raise ValueError(f"{path}: truncated PNM ({len(blob) - hd.offset}"
                             f" of {n} pixel bytes)")
        v = np.frombuffer(blob, "<f4" if maxval < 0 else ">f4", w * h,
                          hd.offset).reshape(h, w)[::-1]
        with np.errstate(invalid="ignore"):
            grey = np.where(np.isnan(v), 0, np.clip(v, 0, 255))
        return np.repeat(grey.astype(np.uint8)[..., None], 3, axis=2)
    ch = _PNM_CHANNELS.get(hd.mode, 1)
    n = w * h * ch
    data = blob[hd.offset:]
    if hd.magic == b"P4":
        row = (w + 7) // 8
        if len(data) < row * h:
            raise ValueError(f"{path}: truncated PNM ({len(data)} of "
                             f"{row * h} pixel bytes)")
        bits = np.unpackbits(np.frombuffer(data, np.uint8, row * h).reshape(
            h, row), axis=1)[:, :w]
        px = ((1 - bits) * 255).astype(np.uint8)[..., None]
    elif hd.magic == b"P1":
        digits = b"".join(_plain_tokens(data))[:n]
        if digits.strip(b"01"):
            raise ValueError(f"{path}: PNM bitmap data other than 0 and 1")
        if len(digits) < n:
            raise ValueError(f"{path}: truncated PNM ({len(digits)} of {n} "
                             "samples)")
        px = np.where(np.frombuffer(digits, np.uint8) == ord("1"), 0,
                      255).astype(np.uint8).reshape(h, w, 1)
    else:
        if hd.magic in (b"P2", b"P3"):
            toks = _plain_tokens(data)[:n]
            if any(len(t) > 10 or not t.isdigit() for t in toks):
                raise ValueError(f"{path}: malformed PNM sample")
            v = np.array([int(t) for t in toks], np.int64)
            if v.size and v.max() > maxval:
                raise ValueError(f"{path}: PNM sample past maxval {maxval}")
            raw = False
        else:
            size = 1 if maxval < 256 else 2
            v = np.frombuffer(data, np.uint8 if size == 1 else ">u2",
                              min(n, len(data) // size)).astype(np.int64)
            raw = maxval == 255 or maxval == 65535 and hd.mode == "I"
        if v.size < n:
            raise ValueError(f"{path}: truncated PNM ({v.size} of {n} "
                             "samples)")
        if not raw:            # PpmDecoder / PpmPlainDecoder's scaling
            out_max = 65535 if hd.mode == "I" else 255
            v = np.minimum(out_max, np.round(v / maxval * out_max))
        px = np.minimum(v, 255).astype(np.uint8).reshape(h, w, ch)
    if hd.mode == "P":                  # no palette: Pillow's is black
        return np.zeros((h, w, 3), np.uint8)
    if hd.mode == "CMYK":               # not inverted, then cmyk2rgb
        nk = 255 - px[..., 3:].astype(np.int64)
        return (nk - jpeg._muldiv255(px[..., :3].astype(np.int64), nk)
                ).astype(np.uint8)
    return np.repeat(px, 3, axis=2) if ch == 1 else px[..., :3]


_BMP_COMPRESSION = {1: "RLE8", 2: "RLE4", 3: "BI_BITFIELDS", 4: "JPEG",
                    5: "PNG", 6: "BI_ALPHABITFIELDS"}
# BmpImagePlugin's bit-field layouts: (bits, masks) -> the byte of each of
# R, G, B in a pixel (32 and 24 bits), or the 16-bit layout
_BMP_FIELDS = {(32, (0xFF0000, 0xFF00, 0xFF, 0)): (2, 1, 0),
               (32, (0xFF000000, 0xFF0000, 0xFF00, 0)): (3, 2, 1),
               (32, (0xFF000000, 0xFF00, 0xFF, 0)): (3, 1, 0),
               (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): (3, 2, 1),
               (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): (0, 1, 2),
               (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): (2, 1, 0),
               (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): (3, 1, 0),
               (32, (0, 0, 0, 0)): (2, 1, 0),
               (24, (0xFF0000, 0xFF00, 0xFF)): (2, 1, 0),
               (16, (0xF800, 0x7E0, 0x1F)): 565,
               (16, (0x7C00, 0x3E0, 0x1F)): 555}


class _Bmp(NamedTuple):
    width: int
    height: int
    bits: int
    compression: int
    top_down: bool
    offset: int              # of the pixel data
    mode: str                # Pillow's: "1", "L", "P", "RGB" or "RGBA"
    layout: object           # _BMP_FIELDS' value for RGB modes
    palette: Optional[np.ndarray]    # (colors, 3) RGB for "P"


def _bmp_header(blob: bytes, path: str, dib: bool = False,
                halve: bool = False) -> _Bmp:
    """BmpImagePlugin's reading of the headers and the palette: OS/2 (12
    bytes), BITMAPINFOHEADER (40) and its successors to V5 (124); refuses
    what Pillow refuses, and the layouts it reads inconsistently. With
    dib=True the blob's first 14 bytes stand for a file header that is not
    there (a DIB file, or the bitmap in an ICO or CUR file): the pixel data
    follows the palette. halve=True halves the height, as IcoImagePlugin
    and CurImagePlugin do (the AND mask's rows follow the image's)."""
    if len(blob) < 18 or blob[:2] != b"BM" and not dib:
        raise ValueError(f"{path}: truncated BMP header")
    offset, hs = struct.unpack("<II", blob[10:18])
    hd = blob[18:14 + hs]
    if hs not in (12, 40, 52, 56, 64, 108, 124):
        raise ValueError(f"{path}: BMP with a {hs}-byte header is not read")
    if len(hd) < hs - 4:
        raise ValueError(f"{path}: truncated BMP header")
    at = 14 + hs
    masks, colors, top_down = None, 0, False
    if hs == 12:
        w, h, _, bits = struct.unpack("<HHHH", hd[:8])
        comp, pad = 0, 3
    else:
        top_down = hd[7] == 0xFF
        w, h, _, bits, comp = struct.unpack("<IIHHI", hd[:16])
        if top_down:
            h = 2 ** 32 - h
        colors = struct.unpack("<I", hd[28:32])[0]
        pad = 4
        if comp == 3:
            if len(hd) >= 48:
                masks = struct.unpack("<III", hd[36:48]) + (
                    struct.unpack("<I", hd[48:52]) if len(hd) >= 52 else (0,))
            else:
                masks = struct.unpack("<III", blob[at:at + 12]) + (0,)
                at += 12
    if halve:
        h //= 2
    colors = colors or 1 << bits
    if offset == 14 + hs and bits <= 8:
        offset += 4 * colors
    if bits not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"{path}: {bits}-bit BMP is not read (Pillow reads "
                         "1, 4, 8, 16, 24 and 32 bits)")
    if w < 1 or h < 1:
        raise ValueError(f"{path}: empty image {w}x{h}")
    mode = "P" if bits <= 8 else "RGB"
    layout: object = {16: 555, 24: (2, 1, 0), 32: (2, 1, 0)}.get(bits)
    if comp == 3:
        key = (bits, masks if bits == 32 else masks[:3])
        if key not in _BMP_FIELDS:
            raise ValueError(f"{path}: BI_BITFIELDS BMP with masks "
                             f"{[hex(m) for m in masks]} at {bits} bits is "
                             "not read (nor by Pillow)")
        layout = _BMP_FIELDS[key]
        if bits == 32 and masks[3]:
            mode = "RGBA"
    elif comp in (1, 2):
        if mode != "P":
            raise ValueError(f"{path}: {_BMP_COMPRESSION[comp]} BMP of "
                             f"{bits} bits is not read (nor by Pillow)")
    elif comp:
        raise ValueError(f"{path}: {_BMP_COMPRESSION.get(comp, comp)} BMP is "
                         "not read (nor by Pillow)")
    palette = None
    if mode == "P":
        if not 0 < colors <= 65536:
            raise ValueError(f"{path}: BMP palette of {colors} colours")
        pal = np.frombuffer(blob[at:at + pad * colors], np.uint8)
        pal = pal[:len(pal) // pad * pad].reshape(-1, pad)[:, 2::-1]
        grey = (0, 255) if colors == 2 else range(colors)
        if len(pal) == colors and all((pal[i] == v).all()
                                      for i, v in enumerate(grey)):
            mode = "1" if colors == 2 else "L"
            if comp and mode == "1":
                raise ValueError(f"{path}: RLE BMP with a two-entry grey "
                                 "palette is not read (nor by Pillow)")
        palette = np.ascontiguousarray(pal)
    if dib:
        offset = at + (pad * colors if bits <= 8 else 0)
    return _Bmp(w, h, bits, comp, top_down, offset, mode, layout, palette)


def _bmp_rle(blob: bytes, at: int, w: int, h: int, rle4: bool,
             path: str) -> np.ndarray:
    """BmpRleDecoder's walk from file offset `at`: (h * w,) indices in
    file row order (runs clipped at the row's end, absolute runs not,
    a delta as Pillow reads it: two bytes skipped, then right and up)."""
    data = bytearray()
    x, dest = 0, w * h
    while len(data) < dest and at + 2 <= len(blob):
        n, byte = blob[at], blob[at + 1]
        at += 2
        if n:
            n = max(0, w - x) if x + n > w else n
            if rle4:
                data += bytes([byte >> 4, byte & 15] * (n // 2 + 1))[:n]
            else:
                data += bytes([byte]) * n
            x += n
        elif byte == 0:
            data += bytes(-len(data) % w)
            x = 0
        elif byte == 1:
            break
        elif byte == 2:
            if at + 4 > len(blob):
                break
            right, up = blob[at + 2], blob[at + 3]
            at += 4
            data += bytes(right + up * w)
            x = len(data) % w
        else:
            count = byte // 2 if rle4 else byte
            got = blob[at:at + count]
            at += len(got)
            if rle4:
                data += bytes(v for b in got for v in (b >> 4, b & 15))
            else:
                data += got
            if len(got) < count:
                break
            x += byte
            at += at % 2
    if len(data) < dest:
        raise ValueError(f"{path}: truncated RLE BMP ({len(data)} of {dest} "
                         "pixels)")
    return np.frombuffer(bytes(data[:dest]), np.uint8)


def decode_bmp(blob: bytes, path: str, dib: bool = False,
               halve: bool = False) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a BMP's bytes as Pillow's convert("RGB")
    gives it: 1, 4 and 8-bit palettes (black past their end; grey ones as
    Pillow's "1" and "L", a row of fewer bits read as the JAX loader's
    Pillow reads it from a file: its leading bytes as 1-bit samples, or w
    bytes from its start as 8-bit ones), RLE8 and RLE4, 16-bit 5-5-5 and
    5-6-5, 24 and 32 bits with Pillow's bit-field layouts (alpha dropped),
    bottom-up and top-down rows; dib and halve as in _bmp_header."""
    hd = _bmp_header(blob, path, dib, halve)
    w, h, bits = hd.width, hd.height, hd.bits
    if hd.compression in (1, 2):
        px = _bmp_rle(blob, hd.offset, w, h, hd.compression == 2,
                      path).reshape(h, w)
    else:
        stride = ((w * bits + 31) >> 3) & ~3      # rows padded to 4 bytes
        data = blob[hd.offset:hd.offset + stride * h]
        if len(data) != stride * h:
            raise ValueError(f"{path}: truncated BMP ({len(data)} of "
                             f"{stride * h} pixel bytes)")
        rows = np.frombuffer(data, np.uint8).reshape(h, stride)
        if hd.mode == "1":    # Pillow unpacks a 1-bit row, whatever `bits`
            px = np.unpackbits(rows, axis=1)[:, :w]
        elif hd.mode == "L":  # and maps an 8-bit one onto the file (mmap),
            # w bytes from each row's start, on into the next row and past
            # the file's end (zeros) where the rows hold fewer
            tail = np.frombuffer(blob[hd.offset:] + bytes(w), np.uint8)
            px = np.stack([tail[i * stride:i * stride + w] for i in range(h)])
        elif bits <= 8:
            px = np.unpackbits(rows, axis=1).reshape(h, -1, bits) if bits < 8 \
                else rows[..., None]
            if bits < 8:
                px = (px << np.arange(bits - 1, -1, -1, dtype=np.uint8)).sum(
                    2, dtype=np.uint8)
            px = px.reshape(h, -1)[:, :w]
        elif bits == 16:
            v = rows[:, :2 * w].copy().view("<u2").astype(np.int32)
            g6 = hd.layout == 565
            px = np.stack([((v >> (11 if g6 else 10)) & 31) * 255 // 31,
                           ((v >> 5) & (63 if g6 else 31)) * 255
                           // (63 if g6 else 31),
                           (v & 31) * 255 // 31], -1).astype(np.uint8)
        else:
            px = rows[:, :w * bits // 8].reshape(h, w, bits // 8)[
                ..., list(hd.layout)]
    if not hd.top_down:
        px = px[::-1]
    if hd.mode == "P":                  # black past the palette's end
        lut = np.zeros((256, 3), np.uint8)
        lut[:min(len(hd.palette), 256)] = hd.palette[:256]
        return lut[px]
    if hd.mode in ("1", "L"):
        grey = px * np.uint8(255) if hd.mode == "1" else px
        return np.repeat(grey[..., None], 3, axis=2)
    return np.ascontiguousarray(px)


# Pillow's Image.open tries its formats in this order: the five plugins it
# imports first (preinit), then the others as Image.init registers them.
# The first whose test of the file's first 16 bytes passes opens it; the
# ones marked with a probe fall through to the next, as Pillow's do, where
# their header does not parse (a TGA file can begin with the CUR magic).
_u32 = lambda p, at=0, o="<": struct.unpack_from(o + "I", p.ljust(16, b"\0"),
                                                 at)[0]
_u16 = lambda p, at=0, o="<": struct.unpack_from(o + "H", p.ljust(16, b"\0"),
                                                 at)[0]
_ORDER = (
    ("BMP", lambda p: p[:2] == b"BM"),
    ("DIB", lambda p: _u32(p) in (12, 40, 52, 56, 64, 108, 124)),
    ("GIF", lambda p: p[:6] in (b"GIF87a", b"GIF89a")),
    ("JPEG", lambda p: p[:3] == b"\xff\xd8\xff"),
    ("PPM", lambda p: p[:1] == b"P" and p[1:2] != b"" and p[1:2] in
     b"0123456fy"),
    ("PNG", lambda p: p[:8] == PNG_SIGNATURE),
    ("AVIF", lambda p: p[4:8] == b"ftyp" and p[8:12] in (
        b"avif", b"avis", b"mif1", b"msf1")),
    ("BLP", lambda p: p[:4] in (b"BLP1", b"BLP2")),
    ("BUFR", lambda p: p[:4] in (b"BUFR", b"ZCZC")),
    ("CUR", lambda p: p[:4] == b"\0\0\2\0"),
    ("PCX", lambda p: len(p) >= 2 and p[0] == 10 and p[1] in (0, 2, 3, 5)),
    ("DCX", lambda p: len(p) >= 4 and _u32(p) == 987654321),
    ("DDS", lambda p: p[:4] == b"DDS "),
    ("EPS", lambda p: p[:4] == b"%!PS" or len(p) >= 4
     and _u32(p) == 0xC6D3D0C5),
    ("FITS", lambda p: p[:6] == b"SIMPLE"),
    ("FLI", lambda p: len(p) >= 16 and _u16(p, 4) in (0xAF11, 0xAF12)
     and _u16(p, 14) in (0, 3)),
    ("FTEX", lambda p: p[:4] == b"FTEX"),
    ("GBR", lambda p: len(p) >= 8 and _u32(p, 0, ">") >= 20
     and _u32(p, 4, ">") in (1, 2)),
    ("GRIB", lambda p: len(p) >= 8 and p[:4] == b"GRIB" and p[7] == 1),
    ("HDF5", lambda p: p[:8] == b"\x89HDF\r\n\x1a\n"),
    ("JPEG2000", lambda p: p[:4] == b"\xff\x4f\xff\x51"
     or p[:12] == b"\0\0\0\x0cjP  \r\n\x87\n"),
    ("ICNS", lambda p: p[:4] == b"icns"),
    ("ICO", lambda p: p[:4] == b"\0\0\1\0"),
    ("IM", None), ("IMT", None), ("IPTC", None),
    ("MCIDAS", lambda p: p[:8] == b"\0\0\0\0\0\0\0\x04"),
    ("MPEG", lambda p: p[:4] == b"\0\0\1\xb3"),
    ("TIFF", lambda p: p[:4] in (b"MM\0\x2a", b"II\x2a\0", b"MM\x2a\0",
                                 b"II\0\x2a", b"MM\0\x2b", b"II\x2b\0")),
    ("MSP", lambda p: p[:4] in (b"DanM", b"LinS")),
    ("PCD", None),
    ("PIXAR", lambda p: p[:4] == b"\x80\xe8\0\0"),
    ("PSD", lambda p: p[:4] == b"8BPS"),
    ("QOI", lambda p: p[:4] == b"qoif"),
    ("SGI", lambda p: len(p) >= 2 and _u16(p, 0, ">") == 474),
    ("SPIDER", None),
    ("SUN", lambda p: len(p) >= 4 and _u32(p, 0, ">") == 0x59A66A95),
    ("TGA", None),
    ("WEBP", lambda p: p[:4] == b"RIFF" and p[8:12] == b"WEBP"),
    ("WMF", lambda p: p[:6] == b"\xd7\xcd\xc6\x9a\0\0"
     or p[:4] == b"\x01\0\0\0"),
    ("XBM", lambda p: p.lstrip()[:7] == b"#define"),
    ("XPM", lambda p: p[:9] == b"/* XPM */"),
    ("XVThumb", lambda p: p[:6] == b"P7 332"),
)


def _parses(fn, blob: bytes) -> bool:
    try:
        fn(blob, "")
        return True
    except (ValueError, IndexError, struct.error):
        return False


# formats whose accepted header may still not open, and the formats
# without a test of their first bytes: what Pillow's _open checks
_PROBES = {
    "CUR": rasters.cur_probe,
    "PCX": lambda b: _parses(rasters.pcx_header, b),
    "MSP": lambda b: _parses(rasters.msp_header, b),
    "IM": rasters.im_probe,
    "IMT": registry.imt_probe,
    "IPTC": registry.iptc_probe,
    "PCD": lambda b: b[2048:2052] == b"PCD_",
    "SPIDER": registry.spider_probe,
    "FITS": registry.fits_probe,
    "FLI": registry.fli_probe,
    "GBR": registry.gbr_probe,
    "PIXAR": registry.pixar_probe,
    "MCIDAS": registry.mcidas_probe,
    "XBM": registry.xbm_probe,
    "TGA": lambda b: _parses(rasters.tga_header, b),
}

def _head(hd) -> Tuple[str, int, int]:
    return hd.mode, hd.height, hd.width


# (header, decoder) of each format the port reads: header(blob, path) ->
# (Pillow's mode, height, width), decoder(blob, path) -> (H, W, 3) uint8
_FORMATS = {
    "PNG": (png_header, decode_png),
    "JPEG": (jpeg.jpeg_header, jpeg.decode_jpeg),
    "PPM": (lambda b, p: _head(_pnm_header(b, p)), decode_pnm),
    "BMP": (lambda b, p: _head(_bmp_header(b, p)), decode_bmp),
    "WEBP": (webp.webp_header, webp.decode_webp),
    "GIF": (gif.gif_header, gif.decode_gif),
    "TIFF": (tiff.tiff_header, tiff.decode_tiff),
    "TGA": (rasters.tga_header, rasters.decode_tga),
    "ICO": (rasters.ico_header, rasters.decode_ico),
    "CUR": (rasters.cur_header, rasters.decode_cur),
    "PCX": (rasters.pcx_header, rasters.decode_pcx),
    "DCX": (lambda b, p: rasters.pcx_header(b, p, dcx=True),
            lambda b, p: rasters.decode_pcx(b, p, dcx=True)),
    "SGI": (rasters.sgi_header, rasters.decode_sgi),
    "QOI": (rasters.qoi_header, rasters.decode_qoi),
    "IM": (rasters.im_header, rasters.decode_im),
    "MSP": (rasters.msp_header, rasters.decode_msp),
    "SUN": (rasters.sun_header, rasters.decode_sun),
    "PSD": (rasters.psd_header, rasters.decode_psd),
    "DDS": (dds.dds_header, dds.decode_dds),
    "DIB": (lambda b, p: _head(_bmp_header(b"BM" + bytes(12) + b, p,
                                           dib=True)),
            lambda b, p: decode_bmp(b"BM" + bytes(12) + b, p, dib=True)),
    "JPEG2000": (jpeg2000.jpeg2000_header, jpeg2000.decode_jpeg2000),
    "ICNS": (icns.icns_header, icns.decode_icns),
    "XBM": (registry.xbm_header, registry.decode_xbm),
    "XPM": (registry.xpm_header, registry.decode_xpm),
    "FITS": (registry.fits_header, registry.decode_fits),
    "BLP": (registry.blp_header, registry.decode_blp),
    "SPIDER": (registry.spider_header, registry.decode_spider),
    "PCD": (registry.pcd_header, registry.decode_pcd),
    "GBR": (registry.gbr_header, registry.decode_gbr),
    "FLI": (registry.fli_header, registry.decode_fli),
    "FTEX": (registry.ftex_header, registry.decode_ftex),
    "PIXAR": (registry.pixar_header, registry.decode_pixar),
    "MCIDAS": (registry.mcidas_header, registry.decode_mcidas),
    "IMT": (registry.imt_header, registry.decode_imt),
    "IPTC": (registry.iptc_header, registry.decode_iptc),
    "XVThumb": (registry.xv_header, registry.decode_xv),
    "AVIF": (avif.avif_header, avif.decode_avif),
}
# formats Pillow opens but cannot load on these hosts: stubs without a
# handler, EPS without Ghostscript, MPEG without a decoder, WMF off Windows
_PILLOW_REFUSES = ("BUFR", "GRIB", "HDF5", "EPS", "MPEG", "WMF")


def image_format(path: str) -> str:
    """Pillow's format name for the file ("PNG", "JPEG", "GIF", "TIFF",
    ...), from its bytes as Image.open decides it, whatever its name."""
    with open(path, "rb") as f:
        prefix = f.read(16)          # what Image.open hands the tests
    blob = None
    for name, accept in _ORDER:
        if accept is not None and not accept(prefix):
            continue
        probe = _PROBES.get(name)
        if probe is not None:
            if blob is None:
                with open(path, "rb") as f:
                    blob = f.read()
            if not probe(blob):
                continue
        return name
    raise ValueError(f"{path}: unknown image format; the port reads PNG, "
                     "JPEG, PNM, BMP and WebP, and JPEG 2000, GIF, TIFF, TGA, "
                     "ICO, ICNS, CUR, PCX, DCX, SGI, QOI, IM, MSP, SUN, PSD, "
                     "DDS, DIB, XBM, XPM, FITS, BLP, SPIDER, PCD, GBR, FLI, "
                     "FTEX, PIXAR, MCIDAS, IMT, IPTC, XVThumb and AVIF "
                     "(Pillow cannot identify the file either)")


def _not_decoded(name: str, path: str) -> ValueError:
    if name in _PILLOW_REFUSES:
        return ValueError(f"{path}: {name} file: Pillow opens it but cannot"
                          " load its pixels on these hosts, and the port "
                          "refuses it too")
    return ValueError(f"{path}: {name} is not decoded by the port yet")


def _header_of(path: str) -> Tuple[str, int, int]:
    """(Pillow's mode, height, width) of any format the port knows."""
    kind = image_format(path)
    if kind not in _FORMATS:
        raise _not_decoded(kind, path)
    with open(path, "rb") as f:
        return _FORMATS[kind][0](f.read(), path)


def image_mode(path: str) -> str:
    """The mode Pillow's Image.open gives the file ("RGB", "L", "P", ...),
    from its header alone."""
    return _header_of(path)[0]


def image_size(path: str) -> Tuple[int, int]:
    """(height, width) from the image's header, without decoding pixels."""
    return _header_of(path)[1:]


def load_image_uint8(p: str) -> np.ndarray:
    """(H,W,3) uint8 RGB of any format the port reads; non-RGB images are
    converted as Pillow's convert("RGB") converts them. A format Pillow
    opens that the port does not decode yet raises ValueError naming it."""
    kind = image_format(p)
    decode = _FORMATS.get(kind, (None, None))[1]
    if decode is None:
        raise _not_decoded(kind, p)
    with open(p, "rb") as f:
        return decode(f.read(), p)


class ImagesCached:
    """Pickle-cached recursive file listing with min-size filtering."""

    def __init__(self, spec: str, cache_pkl: Optional[str] = None,
                 min_size: Optional[int] = None):
        self.spec = spec
        self.cache_pkl = cache_pkl
        self.min_size = min_size

    def _cache_key(self):
        return (self.spec, self.min_size)

    def paths(self, update_cache: bool = False) -> List[str]:
        cache = {}
        if self.cache_pkl and os.path.isfile(self.cache_pkl):
            # the cache is this program's own file, next to the data
            with open(self.cache_pkl, "rb") as f:
                cache = pickle.load(f)
            if not update_cache and self._cache_key() in cache:
                return cache[self._cache_key()]
        ps = iter_images_in(self.spec)
        if self.min_size:
            ps = [p for p in ps if min(image_size(p)) >= self.min_size]
        if self.cache_pkl:
            cache[self._cache_key()] = ps
            tmp = self.cache_pkl + ".write"
            with open(tmp, "wb") as f:
                pickle.dump(cache, f)
            os.replace(tmp, self.cache_pkl)
        return ps


def random_crop_flip(img: np.ndarray, crop: int,
                     rng: np.random.RandomState,
                     strong: bool = False) -> np.ndarray:
    """A random crop x crop window (images smaller than the crop are
    reflection-padded first), flipped left-right with probability 1/2."""
    h, w = img.shape[:2]
    if h < crop or w < crop:
        img = np.pad(img, ((0, max(0, crop - h)), (0, max(0, crop - w)),
                           (0, 0)), mode="reflect")
        h, w = img.shape[:2]
    y = rng.randint(0, h - crop + 1)
    x = rng.randint(0, w - crop + 1)
    out = img[y:y + crop, x:x + crop]
    if rng.rand() < 0.5:
        out = out[:, ::-1]
    if strong:
        out = _strong_aug(out, rng)
    return out


def _strong_aug(out: np.ndarray, rng: np.random.RandomState
                ) -> np.ndarray:
    """dl.aug_strong, for small corpora: a channel permutation, a gamma
    jitter (through a uint8 lookup table) and vertical flips, each with
    its probability."""
    if rng.rand() < 0.5:
        out = out[:, :, rng.permutation(3)]
    if rng.rand() < 0.5:
        g = np.float32(rng.uniform(0.7, 1.4))
        lut = (np.power(np.arange(256, dtype=np.float32) / 255.0, g)
               * 255.0 + 0.5).astype(np.uint8)
        out = lut[out]
    if rng.rand() < 0.3:
        out = out[::-1]
    return np.ascontiguousarray(out)


class TrainBatches:
    """Infinite iterator of (B, crop, crop, 3) uint8 batches: random
    images (with replacement), random crops and flips. One background
    thread prefetches the next batches while the card computes; `close()`
    stops it."""

    def __init__(self, paths: Sequence[str], batch_size: int,
                 crop_size: int, seed: int = 0, prefetch: int = 2,
                 aug_strong: bool = False):
        if not paths:
            raise ValueError("no training images found")
        self.paths = list(paths)
        self.batch_size = batch_size
        self.crop_size = crop_size
        self.seed = seed
        self.aug_strong = aug_strong
        self._q: "queue.Queue[np.ndarray]" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    @property
    def epoch_len(self) -> int:
        return max(1, len(self.paths) // self.batch_size)

    def _worker(self):
        rng = np.random.RandomState(self.seed)
        while not self._stop.is_set():
            try:
                idx = rng.randint(0, len(self.paths), size=self.batch_size)
                batch = np.stack([
                    random_crop_flip(load_image_uint8(self.paths[i]),
                                     self.crop_size, rng,
                                     strong=self.aug_strong)
                    for i in idx])
            except Exception as e:   # handed to the consumer, which raises
                batch = e
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.5)
                    break
                except queue.Full:
                    continue
            if isinstance(batch, Exception):
                return

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            batch = self._q.get()
            if isinstance(batch, Exception):
                raise RuntimeError("reading a training batch failed") \
                    from batch
            yield batch

    def close(self):
        """Stop the prefetch thread and wait for it (at most the batch it is
        reading), so that it holds no interpreter time after the call."""
        self._stop.set()
        self._thread.join()


class Testset:
    """Sorted image list with deterministic subsampling and a stable id."""

    def __init__(self, root_or_glob: str, max_imgs: Optional[int] = None,
                 name: Optional[str] = None,
                 append_id: Optional[str] = None):
        ps = iter_images_in(root_or_glob)
        if not ps:
            raise ValueError(f"no images found for {root_or_glob!r}")
        if max_imgs and max_imgs < len(ps):
            sel = np.linspace(0, len(ps) - 1, max_imgs).astype(int)
            ps = [ps[i] for i in sel]
        self.paths = ps
        base = name or os.path.basename(os.path.normpath(root_or_glob))
        self.id = f"{base}_{len(ps)}"
        if append_id:
            self.id += append_id

    def filter_filenames(self, keep: "list[str]"):
        """Keep only images whose extension-less basename is in `keep`
        (test.py --match_filenames)."""
        name = lambda p: os.path.splitext(os.path.basename(p))[0]
        kept = [p for p in self.paths if name(p) in keep]
        if not kept:
            raise ValueError(f"no files left after filtering for {keep}")
        self.paths = kept

    def __len__(self):
        return len(self.paths)

    def __iter__(self):
        return iter(self.paths)


def _cache_cli(argv=None):
    """Maintain listing caches: `python -m l3c_torch.data.images
    update|show CACHE_PKL [SPEC] [--min_size N]`, the JAX package's CLI
    (its pickle, output lines and exit code)."""
    import argparse
    p = argparse.ArgumentParser(description=_cache_cli.__doc__)
    p.add_argument("mode", choices=["update", "show"])
    p.add_argument("cache_pkl")
    p.add_argument("spec", nargs="?", default=None)
    p.add_argument("--min_size", type=int, default=None)
    flags = p.parse_args(argv)
    if flags.mode == "update":
        if not flags.spec:          # exit code 1, as the JAX CLI's assert
            raise ValueError("update needs a dir/glob SPEC")
        ps = ImagesCached(flags.spec, flags.cache_pkl,
                          flags.min_size).paths(update_cache=True)
        print(f"cached {len(ps)} paths for {flags.spec!r}")
    else:
        with open(flags.cache_pkl, "rb") as f:
            cache = pickle.load(f)
        for (spec, min_size), ps in cache.items():
            print(f"{spec!r} min_size={min_size}: {len(ps)} paths")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(_cache_cli())
