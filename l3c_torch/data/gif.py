"""GIF files as the JAX package's loader reads them: Pillow's
GifImagePlugin opens the first frame, and convert("RGB") looks its
indices up in the palette.

What Pillow 12.1 does, and this module with it:
  - the logical screen's size, grown to hold the first frame where that
    frame reaches past it;
  - mode "P" where the frame has a palette (its local one, else the
    global one), mode "L" where it has none or where its local palette is
    only the grey ramp 0, 1, 2, ... (GifImagePlugin's
    _is_palette_needed); in mode "L" the indices are the grey values,
    unless a global palette that is not the ramp is there: Pillow then
    still looks them up in it;
  - the canvas filled with the frame's transparent index where its
    graphic control extension gives one, else with index 0, and the
    frame's pixels placed on it at its offset, the transparent ones
    included (the first frame writes every pixel);
  - convert("RGB") looks every index up in the palette, black past its
    end; transparency is dropped;
  - the LZW data as GifDecode.c reads it: codes grow to 12 bits, the
    table stops growing when full (a deferred clear), a clear code
    right after a clear is a no-op, a code past the next free entry is
    an error, a complete frame ends the data (an end code before it
    leaves Pillow reading on, and the file is refused as truncated), the
    sub-block lengths are read on past a zero-length block as further
    lengths, and pixel values wider than 8 bits keep their low byte.
"""
from __future__ import annotations

import struct
from typing import NamedTuple, Optional, Tuple

import numpy as np


class _Gif(NamedTuple):
    width: int                  # the canvas, grown to hold the frame
    height: int
    mode: str                   # "P" or "L"
    palette: Optional[bytes]    # RGB triples of the frame's palette
    box: Tuple[int, int, int, int]    # x0, y0, x1, y1 of the frame
    interlace: bool
    bits: int                   # the LZW minimum code size
    offset: int                 # of the first data sub-block
    fill: int                   # the canvas's index outside the frame


def _palette_needed(p: bytes) -> bool:
    """GifImagePlugin._is_palette_needed: anything but the grey ramp."""
    return any(not (i // 3 == p[i] == p[i + 1] == p[i + 2])
               for i in range(0, len(p), 3))


def _parse(blob: bytes, path: str) -> _Gif:
    """GifImagePlugin._open and _seek(0): the screen descriptor, the global
    palette, then the blocks up to the first image descriptor."""
    if blob[:6] not in (b"GIF87a", b"GIF89a") or len(blob) < 13:
        raise ValueError(f"{path}: not a GIF file")
    w, h, flags = struct.unpack("<HHB", blob[6:11])
    at = 13
    glob = None
    if flags & 128:
        p = blob[at:at + (3 << ((flags & 7) + 1))]
        at += len(p)
        if len(p) % 3:
            raise ValueError(f"{path}: truncated GIF palette")
        if _palette_needed(p):
            glob = p

    def data():                      # GifImageFile.data: one sub-block
        nonlocal at
        n = blob[at] if at < len(blob) else 0
        at += 1
        if not n:
            return None
        block = blob[at:at + n]
        at += n
        return block

    transparency = None
    while True:
        s = blob[at:at + 1]
        at += 1
        if not s or s == b";":
            raise ValueError(f"{path}: GIF without an image (Pillow: image "
                             "not found in GIF frame)")
        if s == b"!":
            label = blob[at:at + 1]
            at += 1
            block = data()
            if label == b"\xf9" and block is not None and len(block) >= 4:
                if block[0] & 1:
                    transparency = block[3]
            elif label == b"\xfe":      # a comment's blocks end at a zero
                while block:
                    block = data()
                continue
            while data():
                pass
        elif s == b",":
            d = blob[at:at + 9]
            if len(d) < 9:
                raise ValueError(f"{path}: truncated GIF image descriptor")
            x0, y0, fw, fh, fl = struct.unpack("<HHHHB", d)
            at += 9
            palette, mode = glob, "P" if glob else "L"
            if fl & 128:
                p = blob[at:at + (3 << ((fl & 7) + 1))]
                at += len(p)
                if len(p) % 3:
                    raise ValueError(f"{path}: truncated GIF palette")
                if _palette_needed(p):
                    palette, mode = p, "P"
                else:            # mode "L", the global palette still used
                    mode = "L"
            if at >= len(blob):
                raise ValueError(f"{path}: truncated GIF image data")
            bits = blob[at]
            at += 1
            box = (x0, y0, x0 + fw, y0 + fh)
            w, h = max(w, box[2]), max(h, box[3])
            if w < 1 or h < 1:
                raise ValueError(f"{path}: empty image {w}x{h}")
            return _Gif(w, h, mode, palette, box,
                        bool(fl & 64), bits, at,
                        0 if transparency is None else transparency)


def gif_header(blob: bytes, path: str) -> Tuple[str, int, int]:
    """(Pillow's mode, height, width) of a GIF's bytes."""
    g = _parse(blob, path)
    return g.mode, g.height, g.width


def _codes(blob: bytes, at: int):
    """The data sub-blocks' bytes as GifDecode.c takes them: each length
    byte, zero included, followed by its block, on to the end of the
    file; a block that the file cuts short is not read."""
    out = []
    while at < len(blob):
        n = blob[at]
        if at + 1 + n > len(blob):
            break
        out.append(blob[at + 1:at + 1 + n])
        at += 1 + n
    return b"".join(out)


def lzw_decode(data: bytes, bits: int, npix: int, path: str) -> bytes:
    """GifDecode.c's LZW: the `npix` pixel values (low bytes) of the
    stream `data` at minimum code size `bits`. A stream that ends, or
    whose end code comes, before them raises, as Pillow does for a
    truncated file."""
    if not 1 <= bits <= 11:
        raise ValueError(f"{path}: GIF LZW code size {bits} (Pillow reads "
                         "1 to 11)")
    clear, end = 1 << bits, (1 << bits) + 1
    first = [bytes([v & 255]) for v in range(clear)]
    table = first + [b"", b""]
    out = bytearray()
    pos, nbits = 0, len(data) * 8
    size = bits + 1
    prev: Optional[bytes] = None         # None right after a clear
    while len(out) < npix:
        if pos + size > nbits:
            raise ValueError(f"{path}: truncated GIF image data "
                             f"({len(out)} of {npix} pixels)")
        i = pos >> 3
        c = (int.from_bytes(data[i:i + 3], "little") >> (pos & 7)) \
            & ((1 << size) - 1)
        pos += size
        if c == clear:
            if prev is not None:
                table = first + [b"", b""]
                size, prev = bits + 1, None
            continue
        if c == end:         # Pillow reads on for the missing pixels
            raise ValueError(f"{path}: truncated GIF image data (the end "
                             f"code after {len(out)} of {npix} pixels)")
        if prev is None:
            if c > clear:
                raise ValueError(f"{path}: broken GIF LZW data")
            prev = table[c]
            out += prev
            continue
        nxt = len(table)
        if c > nxt:
            raise ValueError(f"{path}: broken GIF LZW data")
        entry = table[c] if c < nxt else prev + prev[:1]
        out += entry
        if nxt < 4096:
            table.append(prev + entry[:1])
            if nxt == (1 << size) - 1 and size < 12:
                size += 1
        prev = entry
    return bytes(out[:npix])


def _rows(fh: int, interlace: bool) -> np.ndarray:
    """The frame's rows in the order the data gives them."""
    if not interlace:
        return np.arange(fh)
    return np.concatenate([np.arange(0, fh, 8), np.arange(4, fh, 8),
                           np.arange(2, fh, 4), np.arange(1, fh, 2)])


def decode_gif(blob: bytes, path: str = "<GIF bytes>") -> np.ndarray:
    """(H, W, 3) uint8 RGB of a GIF's first frame, as Pillow's
    Image.open(...).convert("RGB") gives it."""
    g = _parse(blob, path)
    x0, y0, x1, y1 = g.box
    fw, fh = x1 - x0, y1 - y0
    canvas = np.full((g.height, g.width), g.fill, np.uint8)
    if fw and fh:
        px = np.frombuffer(lzw_decode(_codes(blob, g.offset), g.bits,
                                      fw * fh, path), np.uint8)
        canvas[y0:y1, x0:x1][_rows(fh, g.interlace)] = px.reshape(fh, fw)
    if g.palette is None:
        return np.repeat(canvas[..., None], 3, axis=2)
    lut = np.zeros((256, 3), np.uint8)
    n = min(len(g.palette) // 3, 256)
    lut[:n] = np.frombuffer(g.palette[:3 * n], np.uint8).reshape(n, 3)
    return lut[canvas]


def read_gif(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_gif(f.read(), path)
