"""WebP decoding, pixel for pixel as Pillow decodes it.

Pillow 12 opens every WebP through libwebp's WebPAnimDecoder into
non-premultiplied RGBA (mode "RGBA" where libwebp reports alpha, else
"RGB"), and convert("RGB") drops the alpha. This module decodes the same
RGB in Python and numpy:

  - the RIFF container: simple 'VP8 ' and 'VP8L' files and extended ones
    ('VP8X'; ICCP, EXIF, XMP and unknown chunks skipped, an ALPH chunk
    parsed for the mode only: the alpha does not reach the RGB);
  - VP8L, lossless (RFC 9649): prefix codes (simple, normal, meta codes
    through the entropy image), the colour cache, LZ77 copies through the
    distance map, and the predictor, cross-colour, subtract-green and
    colour-indexing (pixel bundling) transforms;
  - VP8, lossy key frames (RFC 6386) as libwebp decodes them: the boolean
    decoder, segments, token partitions, coefficient probabilities,
    16x16, 4x4 and chroma intra prediction, the inverse DCT and WHT, the
    simple and the normal loop filter; then libwebp's "fancy" chroma
    upsampler (dsp/upsampling.c) and its 14-bit YUV -> RGB (dsp/yuv.h).

An animation gives its first frame on the canvas, as Pillow's Image.open
shows it. Corrupt or truncated streams raise ValueError naming the
fault. `webp_header` gives Pillow's mode and size from the headers
alone. The constant tables are in
data/webp_tables.py.
"""
from __future__ import annotations

import struct
from typing import List, NamedTuple, Tuple

import numpy as np

from . import webp_tables as T


class _Info(NamedTuple):
    width: int           # of the canvas
    height: int
    lossless: bool
    alpha: bool          # libwebp's has_alpha, which decides Pillow's mode
    data: bytes          # the VP8 / VP8L payload (of the first frame)
    frame: Tuple[int, int, int, int] = None   # x, y, w, h of an animation's
                                              # first frame on the canvas


def _chunks(blob: bytes, at: int, end: int, path: str):
    """(fourcc, payload) of each RIFF chunk from `at` to `end`."""
    while at + 8 <= end:
        tag, n = blob[at:at + 4], struct.unpack("<I", blob[at + 4:at + 8])[0]
        if at + 8 + n > end:
            raise ValueError(f"{path}: truncated WebP chunk {tag!r}")
        yield tag, blob[at + 8:at + 8 + n]
        at += 8 + n + (n & 1)


def _vp8_dims(data: bytes, path: str) -> Tuple[int, int]:
    if len(data) < 10:
        raise ValueError(f"{path}: truncated WebP VP8 frame header")
    bits = data[0] | data[1] << 8 | data[2] << 16
    if bits & 1:
        raise ValueError(f"{path}: WebP VP8 data is not a key frame")
    if data[3:6] != b"\x9d\x01\x2a":
        raise ValueError(f"{path}: corrupt WebP VP8 start code")
    w, h = struct.unpack("<HH", data[6:10])
    return w & 0x3FFF, h & 0x3FFF


def _vp8l_dims(data: bytes, path: str) -> Tuple[int, int, bool]:
    if len(data) < 5 or data[0] != 0x2F:
        raise ValueError(f"{path}: corrupt WebP VP8L header")
    v = struct.unpack("<I", data[1:5])[0]
    if v >> 29:
        raise ValueError(f"{path}: WebP VP8L version {v >> 29} is not read")
    return (v & 0x3FFF) + 1, ((v >> 14) & 0x3FFF) + 1, bool(v >> 28 & 1)


def _image(chunks, path: str):
    """(lossless, width, height, VP8L alpha bit, ALPH seen, payload) of the
    first 'VP8 ' / 'VP8L' chunk, ALPH and others before it skipped."""
    has_alph = False
    for tag, data in chunks:
        if tag == b"ALPH":
            has_alph = True
        elif tag == b"VP8 ":
            return (False, *_vp8_dims(data, path), False, has_alph, data)
        elif tag == b"VP8L":
            return (True, *_vp8l_dims(data, path), has_alph, data)
    raise ValueError(f"{path}: truncated WebP file (no image data)")


def _parse(blob: bytes, path: str) -> _Info:
    """libwebp's ParseHeadersInternal: the canvas's size, the alpha that
    decides the mode, and the (first) image's data."""
    if len(blob) < 20 or blob[:4] != b"RIFF" or blob[8:12] != b"WEBP":
        raise ValueError(f"{path}: not a WebP file")
    end = min(len(blob), 8 + struct.unpack("<I", blob[4:8])[0])
    chunks = _chunks(blob, 12, end, path)
    tag, data = next(chunks, (None, b""))
    if tag in (b"VP8 ", b"VP8L"):
        lossless, w, h, alpha, _, data = _image([(tag, data)], path)
        return _Info(w, h, lossless, alpha, data)
    if tag != b"VP8X" or len(data) < 10:
        raise ValueError(f"{path}: corrupt WebP file (no VP8, VP8L or VP8X "
                         "chunk first)")
    flags = data[0]
    cw = 1 + int.from_bytes(data[4:7], "little")
    ch = 1 + int.from_bytes(data[7:10], "little")
    alpha = bool(flags & 0x10)
    if flags & 0x02:             # animated: the first ANMF frame
        for tag, data in chunks:
            if tag == b"ANMF":
                if len(data) < 16:
                    break
                x, y, fw, fh = (2 * int.from_bytes(data[0:3], "little"),
                                2 * int.from_bytes(data[3:6], "little"),
                                1 + int.from_bytes(data[6:9], "little"),
                                1 + int.from_bytes(data[9:12], "little"))
                lossless, w, h, _, _, img = _image(
                    _chunks(data, 16, len(data), path), path)
                if (w, h) != (fw, fh) or x + w > cw or y + h > ch:
                    raise ValueError(f"{path}: corrupt WebP animation frame")
                return _Info(cw, ch, lossless, alpha, img, (x, y, w, h))
        raise ValueError(f"{path}: truncated WebP animation (no frame)")
    lossless, w, h, vp8l_alpha, has_alph, data = _image(chunks, path)
    if (w, h) != (cw, ch):
        raise ValueError(f"{path}: WebP frame {w}x{h} on a canvas of "
                         f"{cw}x{ch}")
    return _Info(w, h, lossless, (vp8l_alpha if lossless else alpha)
                 or has_alph, data)


def webp_header(blob: bytes, path: str) -> Tuple[str, int, int]:
    """(Pillow's mode, height, width) of the canvas: "RGBA" where libwebp
    reports alpha, else "RGB"."""
    info = _parse(blob, path)
    return "RGBA" if info.alpha else "RGB", info.height, info.width


def decode_webp(blob: bytes, path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a WebP file's bytes, as Pillow's
    convert("RGB") gives it: an animation's first frame on its canvas,
    black where the frame does not cover it (WebPAnimDecoder zero-fills a
    key frame's canvas)."""
    info = _parse(blob, path)
    try:
        if info.lossless:
            argb = decode_vp8l(info.data, path)
            rgb = np.stack([(argb >> 16) & 255, (argb >> 8) & 255,
                            argb & 255], -1).astype(np.uint8)
        else:
            rgb = decode_vp8(info.data, path)
    except IndexError as e:          # a corrupt stream read past its end
        raise ValueError(f"{path}: corrupt WebP data") from e
    if info.frame is None:
        return rgb
    x, y, w, h = info.frame
    canvas = np.zeros((info.height, info.width, 3), np.uint8)
    canvas[y:y + h, x:x + w] = rgb
    return canvas


# ================================================================ VP8L


def _windows_le(data: bytes) -> list:
    """Entry i: bytes i .. i + 7 of `data` (zeros past its end) as one
    little-endian 64-bit integer: any 57 bits from bit 8 i on are a shift
    and a mask away."""
    n = len(data) + 8
    b = np.zeros(n + 8, np.uint64)
    b[:len(data)] = np.frombuffer(data, np.uint8)
    w = np.zeros(n, np.uint64)
    for j in range(8):
        w |= b[j:j + n] << np.uint64(8 * j)
    return w.tolist()


class _Bits:
    """VP8L's LSB-first bit reader."""

    def __init__(self, data: bytes, path: str):
        self.w = _windows_le(data)
        self.p = 0
        self.end = 8 * len(data)
        self.path = path

    def read(self, n: int) -> int:
        p = self.p
        self.p = p + n
        if self.p > self.end:
            raise ValueError(f"{self.path}: truncated WebP VP8L data")
        return (self.w[p >> 3] >> (p & 7)) & ((1 << n) - 1)


_ROOT = 8                  # bits of a prefix code's first lookup


class _Code:
    """A canonical prefix code, looked up by the next bits of the stream
    (first bit read = the code's most significant bit): a table of the
    first 8 bits, entries length << 16 | symbol, and for longer codes a
    second table per 8-bit prefix."""

    def __init__(self, lengths: List[int], path: str):
        used = [(s, n) for s, n in enumerate(lengths) if n]
        if not used:
            raise ValueError(f"{path}: corrupt WebP VP8L prefix code (empty)")
        if len(used) == 1:                 # one symbol: zero bits
            self.root, self.subs, self.sub_bits = [used[0][0]] * 256, [], 0
            return
        maxlen = max(n for _, n in used)
        if sum(1 << (maxlen - n) for _, n in used) != 1 << maxlen:
            raise ValueError(f"{path}: corrupt WebP VP8L prefix code "
                             "(incomplete)")
        count = [0] * (maxlen + 2)
        for _, n in used:
            count[n] += 1
        code, nxt = 0, [0] * (maxlen + 2)
        for n in range(1, maxlen + 1):
            code = (code + count[n - 1]) << 1
            nxt[n] = code
        sub_bits = max(0, maxlen - _ROOT)
        root = np.zeros(1 << _ROOT, np.int64)
        subs = {}
        for s, n in sorted(used, key=lambda t: (t[1], t[0])):
            c = nxt[n]
            nxt[n] += 1
            r = int(format(c, f"0{n}b")[::-1], 2)      # stream order
            e = n << 16 | s
            if n <= _ROOT:
                root[r::1 << n] = e
            else:
                lo = r & ((1 << _ROOT) - 1)
                if lo not in subs:
                    subs[lo] = np.zeros(1 << sub_bits, np.int64)
                subs[lo][r >> _ROOT::1 << (n - _ROOT)] = e
        self.subs = []
        for lo, t in subs.items():
            root[lo] = -1 - len(self.subs)
            self.subs.append(t.tolist())
        self.root = root.tolist()
        self.sub_bits = sub_bits

    def read(self, br: _Bits) -> int:
        p = br.p
        v = br.w[p >> 3] >> (p & 7)
        e = self.root[v & 255]
        if e < 0:
            e = self.subs[-1 - e][(v >> _ROOT) & ((1 << self.sub_bits) - 1)]
        br.p = p + (e >> 16)
        return e & 0xFFFF


_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11,
                      12, 13, 14, 15)


def _read_code(br: _Bits, size: int) -> _Code:
    """ReadHuffmanCode: a simple code of 1 or 2 symbols, or code lengths
    coded by a code of the 19 code-length codes."""
    lengths = [0] * size
    if br.read(1):
        n = br.read(1) + 1
        first = br.read(8 if br.read(1) else 1)
        lengths[first] = 1
        if n == 2:
            lengths[br.read(8)] = 1
        return _Code(lengths, br.path)
    cl = [0] * 19
    for i in range(br.read(4) + 4):
        cl[_CODE_LENGTH_ORDER[i]] = br.read(3)
    clc = _Code(cl, br.path)
    if br.read(1):
        max_symbol = 2 + br.read(2 + 2 * br.read(3))
        if max_symbol > size:
            raise ValueError(f"{br.path}: corrupt WebP VP8L code lengths")
    else:
        max_symbol = size
    s, prev = 0, 8
    while s < size:
        if max_symbol == 0:
            break
        max_symbol -= 1
        c = clc.read(br)
        if c < 16:
            lengths[s] = c
            s += 1
            if c:
                prev = c
            continue
        extra, offset = ((2, 3), (3, 3), (7, 11))[c - 16]
        rep = br.read(extra) + offset
        if s + rep > size:
            raise ValueError(f"{br.path}: corrupt WebP VP8L code lengths")
        lengths[s:s + rep] = [prev if c == 16 else 0] * rep
        s += rep
    return _Code(lengths, br.path)


def _prefix_value(sym: int, br: _Bits) -> int:
    """A length or distance prefix symbol and its extra bits -> value."""
    if sym < 4:
        return sym + 1
    extra = (sym - 2) >> 1
    return ((2 + (sym & 1)) << extra) + br.read(extra) + 1


def _subsample(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def _image_stream(br: _Bits, xsize: int, ysize: int,
                  level0: bool) -> List[int]:
    """DecodeImageStream after the transforms: the colour cache, the prefix
    codes (meta codes at level 0 only) and the ARGB pixels."""
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise ValueError(f"{br.path}: corrupt WebP VP8L colour cache")
    meta, meta_bits, meta_w = None, 0, 0
    if level0 and br.read(1):
        meta_bits = br.read(3) + 2
        meta_w = _subsample(xsize, meta_bits)
        img = _image_stream(br, meta_w, _subsample(ysize, meta_bits), False)
        meta = [(v >> 8) & 0xFFFF for v in img]
    n_groups = max(meta) + 1 if meta else 1
    cache_size = 1 << cache_bits if cache_bits else 0
    groups = [[_read_code(br, size) for size in
               (280 + cache_size, 256, 256, 256, 40)]
              for _ in range(n_groups)]
    return _pixels(br, xsize, ysize, cache_bits, groups, meta, meta_bits,
                   meta_w)


def _pixels(br, xsize, ysize, cache_bits, groups, meta, meta_bits,
            meta_w) -> List[int]:
    n = xsize * ysize
    out = [0] * n
    cache = [0] * (1 << cache_bits) if cache_bits else None
    shift = 32 - cache_bits
    pos = x = y = 0
    g = groups[0]
    while pos < n:
        if meta is not None:
            g = groups[meta[(y >> meta_bits) * meta_w + (x >> meta_bits)]]
        s = g[0].read(br)
        if s < 256:
            r = g[1].read(br)
            b = g[2].read(br)
            a = g[3].read(br)
            px = a << 24 | r << 16 | s << 8 | b
            out[pos] = px
            if cache is not None:
                cache[((0x1E35A7BD * px) & 0xFFFFFFFF) >> shift] = px
            pos += 1
            x += 1
        elif s < 280:
            length = _prefix_value(s - 256, br)
            d = _prefix_value(g[4].read(br), br)
            if d > 120:
                d -= 120
            else:
                c = T.CODE_TO_PLANE[d - 1]
                d = max(1, (c >> 4) * xsize + 8 - (c & 15))
            if d > pos or pos + length > n:
                raise ValueError(f"{br.path}: corrupt WebP VP8L data "
                                 "(a copy outside the image)")
            if d >= length:
                out[pos:pos + length] = out[pos - d:pos - d + length]
            else:
                for i in range(pos, pos + length):
                    out[i] = out[i - d]
            if cache is not None:
                for px in out[pos:pos + length]:
                    cache[((0x1E35A7BD * px) & 0xFFFFFFFF) >> shift] = px
            pos += length
            x += length
        else:
            if cache is None or s - 280 >= len(cache):
                raise ValueError(f"{br.path}: corrupt WebP VP8L data (colour "
                                 "cache index)")
            out[pos] = cache[s - 280]
            pos += 1
            x += 1
        if x >= xsize:
            y += x // xsize
            x %= xsize
    if br.p > br.end:
        raise ValueError(f"{br.path}: truncated WebP VP8L data")
    return out


def _channels(argb: np.ndarray) -> np.ndarray:
    """(..., ) uint32 ARGB -> (..., 4) int32 A, R, G, B."""
    a = argb.astype(np.int64)
    return np.stack([(a >> 24) & 255, (a >> 16) & 255, (a >> 8) & 255,
                     a & 255], -1).astype(np.int32)


def _pack(ch: np.ndarray) -> np.ndarray:
    c = ch.astype(np.int64) & 255
    return (c[..., 0] << 24 | c[..., 1] << 16 | c[..., 2] << 8
            | c[..., 3])


def _avg2(a, b):
    return (a + b) >> 1


def _predict(mode: np.ndarray, L, T, TL, TR) -> np.ndarray:
    """The 14 predictors over (n, 4) channel arrays, chosen per pixel."""
    def clamp(v):
        return np.clip(v, 0, 255)
    pl = (np.abs(T - TL)).sum(-1)              # Select's distances
    pt = (np.abs(L - TL)).sum(-1)
    a = _avg2(L, T)
    preds = [np.zeros_like(L) + np.array([255, 0, 0, 0], np.int32), L, T,
             TR, TL, _avg2(_avg2(L, TR), T), _avg2(L, TL), a, _avg2(TL, T),
             _avg2(T, TR), _avg2(_avg2(L, TL), _avg2(T, TR)),
             np.where((pl < pt)[:, None], L, T), clamp(L + T - TL),
             clamp(a + np.trunc((a - TL) / 2).astype(np.int32))]
    out = preds[0].copy()
    for m in range(1, 14):
        sel = mode == m
        if sel.any():
            out[sel] = preds[m][sel]
    return out


def _inverse_predictor(res: np.ndarray, bits: int,
                       sub: np.ndarray) -> np.ndarray:
    """Undo the predictor transform on (H, W, 4) residuals: the first pixel
    from black, the top row from L, the left column from T, the rest by
    their block's mode, a wavefront at a time (x + 2y constant: L, T, TL
    and TR are all on earlier fronts)."""
    H, W, _ = res.shape
    out = np.zeros_like(res)
    row0 = res[0].copy()
    row0[0] += np.array([255, 0, 0, 0], np.int32)
    out[0] = np.cumsum(row0, 0) & 255
    out[1:, 0] = (np.cumsum(res[1:, 0], 0) + out[0, 0]) & 255
    if W == 1 or H == 1:
        return out
    sw = _subsample(W, bits)
    modes = (sub.reshape(-1, sw, 4)[..., 2] & 15)
    ys, xs = np.mgrid[1:H, 1:W]
    front = (xs + 2 * ys).ravel()
    order = np.argsort(front, kind="stable")
    ys, xs, front = ys.ravel()[order], xs.ravel()[order], front[order]
    cuts = np.flatnonzero(np.diff(front)) + 1
    for y, x in zip(np.split(ys, cuts), np.split(xs, cuts)):
        L, T, TL = out[y, x - 1], out[y - 1, x], out[y - 1, x - 1]
        TR = np.where((x + 1 < W)[:, None], out[y - 1, np.minimum(x + 1,
                                                                 W - 1)],
                      out[y, 0])
        pred = _predict(modes[y >> bits, x >> bits], L, T, TL, TR)
        out[y, x] = (res[y, x] + pred) & 255
    return out


def _inverse_cross_colour(px: np.ndarray, bits: int,
                          sub: np.ndarray) -> np.ndarray:
    H, W, _ = px.shape
    sw = _subsample(W, bits)
    m = sub.reshape(-1, sw, 4)
    ys, xs = np.mgrid[0:H, 0:W]
    e = m[ys >> bits, xs >> bits].astype(np.int8).astype(np.int32)
    g2r, g2b, r2b = e[..., 3], e[..., 2], e[..., 1]
    g = px[..., 2].astype(np.int8).astype(np.int32)
    red = (px[..., 1] + ((g2r * g) >> 5)) & 255
    blue = px[..., 3] + ((g2b * g) >> 5)
    blue = (blue + ((r2b * red.astype(np.int8).astype(np.int32)) >> 5)) & 255
    return np.stack([px[..., 0], red, px[..., 2], blue], -1)


def decode_vp8l(data: bytes, path: str = "<VP8L bytes>") -> np.ndarray:
    """A VP8L bitstream -> (H, W) uint32 ARGB."""
    width, height, _ = _vp8l_dims(data, path)
    br = _Bits(data, path)
    br.p = 40
    xsize = width
    transforms = []
    while br.read(1):
        kind = br.read(2)
        if any(t[0] == kind for t in transforms):
            raise ValueError(f"{path}: corrupt WebP VP8L data (transform "
                             f"{kind} twice)")
        if kind in (0, 1):
            bits = br.read(3) + 2
            sub = _image_stream(br, _subsample(xsize, bits),
                                _subsample(height, bits), False)
            transforms.append((kind, xsize, bits, _channels(np.array(
                sub, np.uint32))))
        elif kind == 3:
            n = br.read(8) + 1
            bits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
            pal = _channels(np.array(_image_stream(br, n, 1, False),
                                     np.uint32))
            pal = np.cumsum(pal, 0) & 255           # delta-coded entries
            full = np.zeros((1 << (8 >> bits) if bits else 256, 4), np.int32)
            full[:n] = pal[:len(full)]
            transforms.append((kind, xsize, bits, full))
            xsize = _subsample(xsize, bits)
        else:
            transforms.append((kind, xsize, 0, None))
    px = _channels(np.array(_image_stream(br, xsize, height, True),
                            np.uint32)).reshape(height, xsize, 4)
    for kind, xs, bits, arg in reversed(transforms):
        if kind == 0:
            px = _inverse_predictor(px, bits, arg)
        elif kind == 1:
            px = _inverse_cross_colour(px, bits, arg)
        elif kind == 2:
            px = px.copy()
            px[..., 1] = (px[..., 1] + px[..., 2]) & 255
            px[..., 3] = (px[..., 3] + px[..., 2]) & 255
        else:
            if bits:
                per = 1 << bits
                g = px[..., 2]
                idx = (g[..., None] >> (np.arange(per) * (8 >> bits))) & (
                    (1 << (8 >> bits)) - 1)
                idx = idx.reshape(height, -1)[:, :xs]
            else:
                idx = px[..., 2]
            px = arg[idx]
    return _pack(px).astype(np.uint32)


# ================================================================= VP8

# shift that brings a range of 1..255 back to 128..255
_NORM = [0] + [7 - (r.bit_length() - 1) for r in range(1, 256)]


class _Bool:
    """RFC 6386's boolean decoder: `value` holds the unread bits, compared
    at bit `n` against the split."""

    __slots__ = ("data", "at", "value", "n", "range")

    def __init__(self, data: bytes):
        self.data = data
        self.at = 0
        self.value = 0
        self.n = -8
        self.range = 255
        self._load()

    def _load(self):
        chunk = self.data[self.at:self.at + 8]
        self.at += 8
        self.value = (self.value << 64) | int.from_bytes(
            chunk.ljust(8, b"\0"), "big")
        self.n += 64

    def bit(self, prob: int) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        big = split << self.n
        if self.value >= big:
            self.value -= big
            r = self.range - split
            b = 1
        else:
            r = split
            b = 0
        s = _NORM[r]
        self.range = r << s
        self.n -= s
        if self.n < 0:
            self._load()
        return b

    def consumed(self) -> int:
        """Bits shifted out of the comparison window so far."""
        return 8 * self.at - 8 - self.n

    def literal(self, bits: int) -> int:
        v = 0
        for _ in range(bits):
            v = v << 1 | self.bit(128)
        return v

    def signed(self, bits: int) -> int:
        v = self.literal(bits)
        return -v if self.bit(128) else v


ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
_CAT = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
        (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# libwebp's mode numbers: the 4x4 ones, of which DC, TM, VE, HE are also
# the 16x16 and chroma modes
B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU = range(10)


def _coeffs(br: _Bool, probs, ctx: int, dq: Tuple[int, int], n: int,
            out: list, base: int) -> int:
    """GetCoeffs: one block's tokens from position n into out[base:base +
    16] (natural order, dequantized); the position after the last one
    read."""
    p = probs[n][ctx]
    while n < 16:
        if not br.bit(p[0]):
            return n
        while not br.bit(p[1]):
            n += 1
            if n == 16:
                return 16
            p = probs[n][0]
        if not br.bit(p[2]):
            v = 1
            nxt = 1
        else:
            if not br.bit(p[3]):
                v = 2 if not br.bit(p[4]) else 3 + br.bit(p[5])
            elif not br.bit(p[6]):
                if not br.bit(p[7]):
                    v = 5 + br.bit(159)
                else:
                    v = 7 + 2 * br.bit(165)
                    v += br.bit(145)
            else:
                b1 = br.bit(p[8])
                b0 = br.bit(p[9 + b1])
                cat = 2 * b1 + b0
                v = 0
                for q in _CAT[cat]:
                    v += v + br.bit(q)
                v += 3 + (8 << cat)
            nxt = 2
        if br.bit(128):
            v = -v
        c = v * dq[n > 0]
        out[base + ZIGZAG[n]] = ((c + 32768) & 0xFFFF) - 32768   # int16
        n += 1
        if n < 16:
            p = probs[n][nxt]
    return 16


class _Frame(NamedTuple):
    width: int
    height: int
    mbw: int
    mbh: int


def _header(data: bytes, path: str):
    """The key frame's header: (frame, first partition, token partitions)."""
    bits = data[0] | data[1] << 8 | data[2] << 16
    size0 = bits >> 5
    w, h = _vp8_dims(data, path)
    if w == 0 or h == 0:
        raise ValueError(f"{path}: empty WebP VP8 frame")
    if 10 + size0 > len(data):
        raise ValueError(f"{path}: truncated WebP VP8 data")
    frame = _Frame(w, h, (w + 15) >> 4, (h + 15) >> 4)
    return frame, data[10:10 + size0], data[10 + size0:]


def decode_vp8(data: bytes, path: str = "<VP8 bytes>") -> np.ndarray:
    """A VP8 key frame -> (H, W, 3) uint8 RGB as libwebp outputs it."""
    fr, part0, rest = _header(data, path)
    br = _Bool(part0)
    br.bit(128)                                    # colour space
    br.bit(128)                                    # clamping type
    # segments
    use_seg = br.bit(128)
    update_map = absolute = 0
    seg_q = [0] * 4
    seg_f = [0] * 4
    seg_p = [255, 255, 255]
    if use_seg:
        update_map = br.bit(128)
        if br.bit(128):
            absolute = br.bit(128)
            seg_q = [br.signed(7) if br.bit(128) else 0 for _ in range(4)]
            seg_f = [br.signed(6) if br.bit(128) else 0 for _ in range(4)]
        if update_map:
            seg_p = [br.literal(8) if br.bit(128) else 255 for _ in range(3)]
    # loop filter
    simple = br.bit(128)
    level = br.literal(6)
    sharpness = br.literal(3)
    ref_d, mode_d = [0] * 4, [0] * 4
    use_delta = br.bit(128)
    if use_delta and br.bit(128):
        ref_d = [br.signed(6) if br.bit(128) else 0 for _ in range(4)]
        mode_d = [br.signed(6) if br.bit(128) else 0 for _ in range(4)]
    ftype = 0 if level == 0 else 1 if simple else 2
    # token partitions
    nparts = 1 << br.literal(2)
    sizes_at = 3 * (nparts - 1)
    if sizes_at > len(rest):
        raise ValueError(f"{path}: truncated WebP VP8 partitions")
    parts, at = [], sizes_at
    for i in range(nparts):
        if i < nparts - 1:
            n = int.from_bytes(rest[3 * i:3 * i + 3], "little")
        else:
            n = len(rest) - at
        if at + n > len(rest):
            raise ValueError(f"{path}: truncated WebP VP8 partitions")
        parts.append(_Bool(rest[at:at + n]))
        at += n
    # quantizers
    base_q = br.literal(7)
    dq = [br.signed(4) if br.bit(128) else 0 for _ in range(5)]
    quant = []
    for s in range(4):
        q = (seg_q[s] + (0 if absolute else base_q)) if use_seg else base_q

        def tab(t, d, hi=127):
            return t[min(max(q + d, 0), hi)]
        y2ac = tab(T.AC_TABLE, dq[2]) * 101581 >> 16
        quant.append(((tab(T.DC_TABLE, dq[0]), tab(T.AC_TABLE, 0)),
                      (tab(T.DC_TABLE, dq[1]) * 2, max(8, y2ac)),
                      (tab(T.DC_TABLE, dq[3], 117), tab(T.AC_TABLE, dq[4]))))
    br.bit(128)                                    # refresh entropy probs
    proba = [br.literal(8) if br.bit(u) else p0
             for u, p0 in zip(T.COEFFS_UPDATE_PROBA, T.COEFFS_PROBA0)]
    # bands[t][n][ctx] -> the 11 probabilities of position n's band
    bands = [[[proba[((t * 8 + BANDS[n]) * 3 + c) * 11:
                     ((t * 8 + BANDS[n]) * 3 + c + 1) * 11]
               for c in range(3)] for n in range(17)] for t in range(4)]
    skip_p = br.literal(8) if br.bit(128) else None
    # filter strengths per segment and 4x4-ness
    fstr = []
    for s in range(4):
        base = (seg_f[s] + (0 if absolute else level)) if use_seg else level
        row = []
        for i4 in (0, 1):
            lv = base
            if use_delta:
                lv += ref_d[0] + (mode_d[0] if i4 else 0)
            lv = min(max(lv, 0), 63)
            if lv > 0:
                il = lv
                if sharpness > 0:
                    il >>= 2 if sharpness > 4 else 1
                    il = min(il, 9 - sharpness)
                il = max(il, 1)
                row.append((2 * lv + il, il, 2 if lv >= 40 else 1
                            if lv >= 15 else 0))
            else:
                row.append((0, 0, 0))
        fstr.append(row)
    return _reconstruct(fr, br, parts, bands, quant, skip_p, update_map,
                        seg_p, ftype, fstr, path)


def _parse_modes(br: _Bool, top: list, left: list, update_map: int,
                 seg_p: list, skip_p):
    """ParseIntraMode: (segment, skip, 4x4?, 16 sub-block modes or the
    16x16 mode, chroma mode)."""
    seg = 0
    if update_map:
        seg = br.bit(seg_p[1]) if not br.bit(seg_p[0]) else 2 + br.bit(
            seg_p[2])
    skip = br.bit(skip_p) if skip_p is not None else 0
    i4 = not br.bit(145)
    if not i4:
        ymode = (B_TM if br.bit(128) else B_HE) if br.bit(156) else (
            B_VE if br.bit(163) else B_DC)
        top[:] = [ymode] * 4
        left[:] = [ymode] * 4
        modes = ymode
    else:
        modes = []
        for y in range(4):
            ym = left[y]
            for x in range(4):
                p = T.BMODES_PROBA[(top[x] * 10 + ym) * 9:
                                   (top[x] * 10 + ym + 1) * 9]
                if not br.bit(p[0]):
                    ym = B_DC
                elif not br.bit(p[1]):
                    ym = B_TM
                elif not br.bit(p[2]):
                    ym = B_VE
                elif not br.bit(p[3]):
                    ym = (B_HE if not br.bit(p[4]) else B_RD
                          if not br.bit(p[5]) else B_VR)
                else:
                    ym = (B_LD if not br.bit(p[6]) else B_VL
                          if not br.bit(p[7]) else B_HD
                          if not br.bit(p[8]) else B_HU)
                top[x] = ym
                modes.append(ym)
            left[y] = ym
    uv = B_DC if not br.bit(142) else B_VE if not br.bit(114) else (
        B_TM if br.bit(183) else B_HE)
    return seg, skip, i4, modes, uv


def _residuals(br: _Bool, bands, q, i4: bool, tnz: list, lnz: list,
               coefs: list):
    """ParseResiduals into coefs (25 blocks of 16: 16 Y, 4 U, 4 V, and the
    Y2 block last); tnz / lnz: the above and left non-zero flags (4 Y, 2 U,
    2 V, Y2). Returns whether any coefficient is non-zero, as libwebp's
    NzCodeBits sees it."""
    nonzero = False
    if not i4:
        ctx = tnz[8] + lnz[8]
        nz = _coeffs(br, bands[1], ctx, q[1], 0, coefs, 384)
        tnz[8] = lnz[8] = int(nz > 0)
        dc = _wht(coefs[384:400])
        for i in range(16):
            coefs[16 * i] = dc[i]
        first, ac = 1, bands[0]
    else:
        first, ac = 0, bands[3]
    for y in range(4):
        left = lnz[y]
        for x in range(4):
            b = 16 * (4 * y + x)
            nz = _coeffs(br, ac, left + tnz[x], q[0], first, coefs, b)
            left = tnz[x] = int(nz > first)
            nonzero |= nz > 1 or coefs[b] != 0
        lnz[y] = left
    for ch in (0, 2):
        for y in range(2):
            left = lnz[4 + ch + y]
            for x in range(2):
                b = 256 + 64 * (ch // 2) + 16 * (2 * y + x)
                nz = _coeffs(br, bands[2], left + tnz[4 + ch + x], q[2], 0,
                             coefs, b)
                left = tnz[4 + ch + x] = int(nz > 0)
                nonzero |= nz > 1 or coefs[b] != 0
            lnz[4 + ch + y] = left
    return nonzero


def _wht(c: list) -> list:
    """TransformWHT: the Y2 block -> the 16 Y blocks' DC terms."""
    t = [0] * 16
    for i in range(4):
        a0, a1 = c[i] + c[12 + i], c[4 + i] + c[8 + i]
        a2, a3 = c[4 + i] - c[8 + i], c[i] - c[12 + i]
        t[i], t[8 + i], t[4 + i], t[12 + i] = a0 + a1, a0 - a1, a3 + a2, \
            a3 - a2
    out = [0] * 16
    for i in range(4):
        dc = t[4 * i] + 3
        a0, a1 = dc + t[4 * i + 3], t[4 * i + 1] + t[4 * i + 2]
        a2, a3 = t[4 * i + 1] - t[4 * i + 2], dc - t[4 * i + 3]
        out[4 * i], out[4 * i + 1] = ((a0 + a1) >> 3, (a3 + a2) >> 3)
        out[4 * i + 2], out[4 * i + 3] = ((a0 - a1) >> 3, (a3 - a2) >> 3)
    return out


def _idct(blocks: np.ndarray) -> np.ndarray:
    """TransformOne over (..., 16) coefficients (natural order) -> (..., 4,
    4) residuals to add: columns, then rows with the rounding, >> 3."""
    c = blocks.reshape(blocks.shape[:-1] + (4, 4)).astype(np.int64)

    def mul1(a):
        return ((a * 20091) >> 16) + a

    def mul2(a):
        return (a * 35468) >> 16

    def one(x0, x1, x2, x3, dc=0):
        a, b = x0 + dc + x2, x0 + dc - x2
        cc, d = mul2(x1) - mul1(x3), mul1(x1) + mul2(x3)
        return a + d, b + cc, b - cc, a - d
    # vertical pass: in[0], in[4], in[8], in[12] of each column
    v = np.stack(one(c[..., 0, :], c[..., 1, :], c[..., 2, :], c[..., 3, :]),
                 -2)                                # (..., 4 out rows, col)
    # horizontal pass: row i of the output takes v[i] across the columns
    h = np.stack(one(v[..., 0], v[..., 1], v[..., 2], v[..., 3], 4), -1)
    return h >> 3


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2r(a, b):
    return (a + b + 1) >> 1


def _pred4(mode: int, top: list, left: list, tl: int) -> list:
    """A 4x4 block's prediction as 16 values (row-major); top: 8 values
    above (4 above-right), left: 4 values, tl: above-left."""
    A, B, C, D, E, F, G, H = top
    I, J, K, L = left
    X = tl
    if mode == B_DC:
        return [(A + B + C + D + I + J + K + L + 4) >> 3] * 16
    if mode == B_TM:
        return [min(max(left[y] + top[x] - X, 0), 255) for y in range(4)
                for x in range(4)]
    if mode == B_VE:
        return [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D),
                _avg3(C, D, E)] * 4
    if mode == B_HE:
        return [v for v in (_avg3(X, I, J), _avg3(I, J, K), _avg3(J, K, L),
                            _avg3(K, L, L)) for _ in range(4)]
    d = [[0] * 4 for _ in range(4)]        # d[y][x]
    if mode == B_RD:
        for x, y, v in ((0, 3, _avg3(J, K, L)), (1, 3, _avg3(I, J, K)),
                        (2, 3, _avg3(X, I, J)), (3, 3, _avg3(A, X, I)),
                        (3, 2, _avg3(B, A, X)), (3, 1, _avg3(C, B, A)),
                        (3, 0, _avg3(D, C, B))):
            # the diagonal through (x, y) running up-left
            for k in range(4):
                if x - k >= 0 and y - k >= 0:
                    d[y - k][x - k] = v
    elif mode == B_LD:
        vals = (_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E),
                _avg3(D, E, F), _avg3(E, F, G), _avg3(F, G, H),
                _avg3(G, H, H))
        for y in range(4):
            for x in range(4):
                d[y][x] = vals[x + y]
    elif mode == B_VR:
        d[0] = [_avg2r(X, A), _avg2r(A, B), _avg2r(B, C), _avg2r(C, D)]
        d[2][1:] = d[0][:3]
        d[3][0] = _avg3(K, J, I)
        d[2][0] = _avg3(J, I, X)
        d[1][0] = d[3][1] = _avg3(I, X, A)
        d[1][1] = d[3][2] = _avg3(X, A, B)
        d[1][2] = d[3][3] = _avg3(A, B, C)
        d[1][3] = _avg3(B, C, D)
    elif mode == B_VL:
        d[0] = [_avg2r(A, B), _avg2r(B, C), _avg2r(C, D), _avg2r(D, E)]
        d[2][0:3] = d[0][1:4]
        d[1] = [_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E),
                _avg3(D, E, F)]
        d[3][0:3] = d[1][1:4]
        d[2][3] = _avg3(E, F, G)
        d[3][3] = _avg3(F, G, H)
    elif mode == B_HD:
        d[0][0] = d[1][2] = _avg2r(I, X)
        d[1][0] = d[2][2] = _avg2r(J, I)
        d[2][0] = d[3][2] = _avg2r(K, J)
        d[3][0] = _avg2r(L, K)
        d[0][3] = _avg3(A, B, C)
        d[0][2] = _avg3(X, A, B)
        d[0][1] = d[1][3] = _avg3(I, X, A)
        d[1][1] = d[2][3] = _avg3(J, I, X)
        d[2][1] = d[3][3] = _avg3(K, J, I)
        d[3][1] = _avg3(L, K, J)
    else:                                      # B_HU
        d[0][0] = _avg2r(I, J)
        d[0][2] = d[1][0] = _avg2r(J, K)
        d[1][2] = d[2][0] = _avg2r(K, L)
        d[0][1] = _avg3(I, J, K)
        d[0][3] = d[1][1] = _avg3(J, K, L)
        d[1][3] = d[2][1] = _avg3(K, L, L)
        d[2][3] = d[2][2] = d[3][0] = d[3][1] = d[3][2] = d[3][3] = L
    return [v for row in d for v in row]


def _pred_block(mode: int, P: np.ndarray, y: int, x: int, n: int,
                mb_x: int, mb_y: int) -> np.ndarray:
    """A 16x16 luma or 8x8 chroma prediction from the padded plane P (row
    y, column x: the block's top-left sample; row y - 1 and column x - 1
    hold the neighbours or the border values)."""
    top = P[y - 1, x:x + n].astype(np.int32)
    left = P[y:y + n, x - 1].astype(np.int32)
    if mode == B_DC:
        sh = 4 if n == 16 else 3
        if mb_x and mb_y:
            v = (top.sum() + left.sum() + n) >> (sh + 1)
        elif mb_y:
            v = (top.sum() + n // 2) >> sh
        elif mb_x:
            v = (left.sum() + n // 2) >> sh
        else:
            v = 128
        return np.full((n, n), v, np.int32)
    if mode == B_TM:
        return np.clip(left[:, None] + top[None, :] - int(P[y - 1, x - 1]),
                       0, 255)
    if mode == B_VE:
        return np.broadcast_to(top, (n, n))
    return np.broadcast_to(left[:, None], (n, n))


def _reconstruct(fr, br, parts, bands, quant, skip_p, update_map, seg_p,
                 ftype, fstr, path):
    mbw, mbh = fr.mbw, fr.mbh
    # padded planes: row 0 and column 0 the border (127 above, 129 left),
    # 4 columns of 127 past the right edge for row 0's above-right samples
    Y = np.full((16 * mbh + 1, 16 * mbw + 5), 127, np.int32)
    Y[1:, 0] = 129
    U = np.full((8 * mbh + 1, 8 * mbw + 1), 127, np.int32)
    U[1:, 0] = 129
    V = U.copy()
    tnz_all = [[0] * 9 for _ in range(mbw)]
    intra_t = [B_DC] * (4 * mbw)
    finfo = np.zeros((mbh, mbw, 4), np.int32)     # limit, ilevel, hev, inner
    coefs = [0] * 400
    for mb_y in range(mbh):
        lnz = [0] * 9
        intra_l = [B_DC] * 4
        tok = parts[mb_y & (len(parts) - 1)]
        for mb_x in range(mbw):
            top = intra_t[4 * mb_x:4 * mb_x + 4]
            seg, skip, i4, modes, uvmode = _parse_modes(
                br, top, intra_l, update_map, seg_p, skip_p)
            intra_t[4 * mb_x:4 * mb_x + 4] = top
            tnz = tnz_all[mb_x]
            coefs[:] = [0] * 400
            if not skip:
                nonzero = _residuals(tok, bands, quant[seg], i4, tnz, lnz,
                                     coefs)
            else:
                nonzero = False
                for i in range(8):
                    tnz[i] = lnz[i] = 0
                if not i4:
                    tnz[8] = lnz[8] = 0
            limit, il, hev = fstr[seg][int(i4)]
            finfo[mb_y, mb_x] = (limit, il, hev, int(i4) | nonzero)
            res = _idct(np.array(coefs[:384], np.int64).reshape(24, 16))
            y0, x0 = 1 + 16 * mb_y, 1 + 16 * mb_x
            if i4:
                if mb_y == 0:
                    tr = [127] * 4
                elif mb_x == mbw - 1:
                    tr = [int(Y[y0 - 1, x0 + 15])] * 4
                else:
                    tr = Y[y0 - 1, x0 + 16:x0 + 20].tolist()
                for n in range(16):
                    by, bx = n >> 2, n & 3
                    yy, xx = y0 + 4 * by, x0 + 4 * bx
                    above = Y[yy - 1, xx:xx + 4].tolist()
                    above += tr if bx == 3 else Y[yy - 1, xx + 4:xx + 8]\
                        .tolist()
                    pred = _pred4(modes[n], above,
                                  Y[yy:yy + 4, xx - 1].tolist(),
                                  int(Y[yy - 1, xx - 1]))
                    Y[yy:yy + 4, xx:xx + 4] = np.clip(np.array(
                        pred, np.int32).reshape(4, 4) + res[n], 0, 255)
            else:
                pred = _pred_block(modes, Y, y0, x0, 16, mb_x, mb_y)
                r = res[:16].reshape(4, 4, 4, 4).transpose(0, 2, 1, 3)\
                    .reshape(16, 16)
                Y[y0:y0 + 16, x0:x0 + 16] = np.clip(pred + r, 0, 255)
            cy, cx = 1 + 8 * mb_y, 1 + 8 * mb_x
            for P, first in ((U, 16), (V, 20)):
                pred = _pred_block(uvmode, P, cy, cx, 8, mb_x, mb_y)
                r = res[first:first + 4].reshape(2, 2, 4, 4).transpose(
                    0, 2, 1, 3).reshape(8, 8)
                P[cy:cy + 8, cx:cx + 8] = np.clip(pred + r, 0, 255)
    if any(p.consumed() > 8 * len(p.data) for p in parts + [br]):
        raise ValueError(f"{path}: truncated WebP VP8 data")
    Yp = Y[1:, 1:16 * mbw + 1].copy()
    Up, Vp = U[1:, 1:].copy(), V[1:, 1:].copy()
    if ftype:
        _loop_filter(Yp, Up, Vp, finfo, ftype)
    w, h = fr.width, fr.height
    return yuv_to_rgb(Yp[:h, :w], Up[:(h + 1) // 2, :(w + 1) // 2],
                      Vp[:(h + 1) // 2, :(w + 1) // 2])


# ---------------------------------------------------------- loop filter


def _sclip1(v):
    return np.clip(v, -128, 127)


def _sclip2(v):
    return np.clip(v, -16, 15)


def _clip1(v):
    return np.clip(v, 0, 255)


def _filter_edge(seg: np.ndarray, thresh, ilevel, hev_t,
                 kind: str) -> np.ndarray:
    """Edge lines: seg (n, 8) int32 samples p3 p2 p1 p0 q0 q1 q2 q3 across
    an edge, thresh / ilevel / hev_t (n,) per line -> the filtered
    samples. kind: 'simple', 'mb' (FilterLoop26) or 'inner'
    (FilterLoop24)."""
    p3, p2, p1, p0, q0, q1, q2, q3 = seg.T
    mask = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= 2 * thresh + 1
    out = seg.copy()
    if kind != "simple":
        mask &= ((np.abs(p3 - p2) <= ilevel) & (np.abs(p2 - p1) <= ilevel)
                 & (np.abs(p1 - p0) <= ilevel) & (np.abs(q3 - q2) <= ilevel)
                 & (np.abs(q2 - q1) <= ilevel) & (np.abs(q1 - q0) <= ilevel))
        hev = (np.abs(p1 - p0) > hev_t) | (np.abs(q1 - q0) > hev_t)
    else:
        hev = np.ones_like(mask)
    # DoFilter2 where hev (always for the simple filter)
    f2 = mask & hev
    a = 3 * (q0 - p0) + _sclip1(p1 - q1)
    a1, a2 = _sclip2((a + 4) >> 3), _sclip2((a + 3) >> 3)
    out[f2, 3] = _clip1(p0 + a2)[f2]
    out[f2, 4] = _clip1(q0 - a1)[f2]
    if kind == "simple":
        return out
    f = mask & ~hev
    if kind == "mb":              # DoFilter6
        a = _sclip1(3 * (q0 - p0) + _sclip1(p1 - q1))
        a1, a2, a3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
        for i, v in ((1, p2 + a3), (2, p1 + a2), (3, p0 + a1), (4, q0 - a1),
                     (5, q1 - a2), (6, q2 - a3)):
            out[f, i] = _clip1(v)[f]
    else:                          # DoFilter4
        a = 3 * (q0 - p0)
        a1, a2 = _sclip2((a + 4) >> 3), _sclip2((a + 3) >> 3)
        a3 = (a1 + 1) >> 1
        for i, v in ((2, p1 + a3), (3, p0 + a2), (4, q0 - a1),
                     (5, q1 - a3)):
            out[f, i] = _clip1(v)[f]
    return out


_TAPS = np.arange(-4, 4)


def _edges(P, y0, x0, n, off, vertical, params, kind):
    """One edge of each macroblock in a wavefront, all at once: the edge
    `off` samples into each block at rows y0 and columns x0 (arrays), n
    lines long; across columns (a vertical edge) or across rows."""
    if not len(y0):
        return
    line = np.arange(n)
    if vertical:       # lines are rows, taps run along the row
        rows = (y0[:, None] + line)[:, :, None]
        cols = (x0 + off)[:, None, None] + _TAPS
    else:              # lines are columns, taps run down the column
        rows = (y0 + off)[:, None, None] + _TAPS
        cols = (x0[:, None] + line)[:, :, None]
    rows, cols = np.broadcast_arrays(rows, cols)
    seg = P[rows, cols].reshape(-1, 8)
    t, il, hev = (np.repeat(v, n) for v in params)
    P[rows, cols] = _filter_edge(seg, t, il, hev, kind).reshape(rows.shape)


def _loop_filter(Y, U, V, finfo, ftype):
    """DoFilter over every macroblock: per macroblock the left edge, the
    inner vertical edges, the top edge, the inner horizontal edges, in
    libwebp's raster order. Macroblock (x, y) reads and writes samples
    that (x - 1, y), (x, y - 1) and (x + 1, y - 1) wrote, and none that
    another macroblock with the same x + 2 y touches, so each such
    wavefront is filtered at once."""
    mbh, mbw, _ = finfo.shape
    my, mx = np.mgrid[0:mbh, 0:mbw]
    front = (mx + 2 * my).ravel()
    live = finfo[..., 0].ravel() > 0
    for d in range(mbw + 2 * mbh):
        sel = np.flatnonzero((front == d) & live)
        if not len(sel):
            continue
        bx, by = mx.ravel()[sel], my.ravel()[sel]
        limit, il, hev, inner = finfo.reshape(-1, 4)[sel].T
        planes = [(Y, 16, 16 * by, 16 * bx, (4, 8, 12))]
        if ftype == 2:
            planes += [(U, 8, 8 * by, 8 * bx, (4,)), (V, 8, 8 * by, 8 * bx,
                                                       (4,))]
        kind_mb, kind_in = ("simple", "simple") if ftype == 1 else (
            "mb", "inner")
        for vertical, first in ((True, bx > 0), (False, by > 0)):
            for P, n, y0, x0, inner_offs in planes:
                e = first
                _edges(P, y0[e], x0[e], n, 0, vertical,
                       (limit[e] + 4, il[e], hev[e]), kind_mb)
                e = inner > 0
                for off in inner_offs:
                    _edges(P, y0[e], x0[e], n, off, vertical,
                           (limit[e], il[e], hev[e]), kind_in)


# ------------------------------------------------------- YUV -> RGB


def _upsample_rows(near: np.ndarray, far: np.ndarray, w: int) -> np.ndarray:
    """UPSAMPLE_FUNC's output line for chroma rows `near` (the nearer) and
    `far`, (n, uw) int -> (n, w): the first (and, for even w, the last)
    sample 3:1 vertically, the rest through the two diagonals, rounded in
    two steps as libwebp's packed arithmetic does."""
    out = np.empty((near.shape[0], w), np.int64)
    out[:, 0] = (3 * near[:, 0] + far[:, 0] + 2) >> 2
    pairs = (w - 1) >> 1
    if pairs:
        a, b = near[:, :pairs], near[:, 1:pairs + 1]
        c, d = far[:, :pairs], far[:, 1:pairs + 1]
        diag_12 = (a + 3 * b + 3 * c + d + 8) >> 3
        diag_03 = (3 * a + b + c + 3 * d + 8) >> 3
        out[:, 1:2 * pairs:2] = (diag_12 + a) >> 1
        out[:, 2:2 * pairs + 1:2] = (diag_03 + b) >> 1
    if not w & 1:
        out[:, w - 1] = (3 * near[:, pairs] + far[:, pairs] + 2) >> 2
    return out


def upsample(c: np.ndarray, h: int, w: int) -> np.ndarray:
    """EmitFancyRGB's chroma: (ceil(h/2), ceil(w/2)) -> (h, w). Row 0 and
    an even height's last row from one chroma row; rows 2k - 1 and 2k from
    rows k - 1 and k, each nearer its own."""
    c = c.astype(np.int64)
    r = np.arange(h)
    k = (r + 1) >> 1
    near = np.where(r & 1, k - 1, k)
    far = np.where(r & 1, np.minimum(k, c.shape[0] - 1), np.maximum(k - 1,
                                                                   0))
    return _upsample_rows(c[near], c[far], w)


def _mult_hi(v, coeff):
    return (v * coeff) >> 8


def _clip8(v):
    return np.where((v & ~16383) == 0, v >> 6, np.where(v < 0, 0, 255))


def yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """libwebp's fancy-upsampled VP8YuvToRgb: (h, w) luma and half-size
    chroma -> (h, w, 3) uint8."""
    h, w = y.shape
    y = y.astype(np.int64)
    uu, vv = upsample(u, h, w), upsample(v, h, w)
    yy = _mult_hi(y, 19077)
    r = _clip8(yy + _mult_hi(vv, 26149) - 14234)
    g = _clip8(yy - _mult_hi(uu, 6419) - _mult_hi(vv, 13320) + 8708)
    b = _clip8(yy + _mult_hi(uu, 33050) - 17685)
    return np.stack([r, g, b], -1).astype(np.uint8)
