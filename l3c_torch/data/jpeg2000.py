"""JPEG 2000 (ISO 15444-1): JP2 files and raw J2K codestreams read as the
JAX package's loader reads them, through Pillow's Jpeg2KImagePlugin over
OpenJPEG 2.5 (Image.open(p).convert("RGB")), bit for bit.

  - the codestream: SOC, SIZ, COD, COC, QCD, QCC, RGN, POC, PPM, PPT, TLM,
    PLM, PLT, CRG, COM, tile-parts (SOT / SOD) of the tiles in any order,
    and EOC; the JP2 boxes jP, ftyp, jp2h (ihdr, colr, pclr, cmap, cdef,
    res) and jp2c;
  - Tier-2: tiles on the canvas with their offsets, tile-components
    sub-sampled by XRsiz / YRsiz, resolutions, precincts of any size per
    resolution, code-blocks; the five progression orders and POC
    changes, SOP / EPH, packet headers in the bodies or packed in PPM /
    PPT, with their inclusion and zero-bit-plane tag trees, pass counts,
    Lblock and the codeword segments of BYPASS / TERMALL; every quality
    layer, at full resolution (Pillow's layers = 0, reduce = 0);
  - Tier-1 in data/jpeg2000_t1.py, and HTJ2K's (Part 15) HT code-blocks
    in data/jpeg2000_ht.py: CAP and CPF are skipped as OpenJPEG skips
    them, an HT block's first segment holds its cleanup pass alone and
    the second the rest (opj_t2_read_packet_header), and the mixed HT
    style (bit 0x80) is refused as OpenJPEG refuses it;
  - dequantisation (none, scalar derived, scalar expounded) with the
    guard bits, the ROI max-shift, the inverse DWT (5/3 in integers, 9/7
    in float32 with OpenJPEG's constants and order: rows, then columns,
    each level), the inverse RCT or ICT, the DC level shift and the
    clamp;
  - Pillow's unpacking of each tile (Jpeg2KDecode.c's j2ku_*): the
    precision shift to 8 bits (16 for I;16) and the signed offset, its
    row strides for sub-sampled components, sYCC through Pillow's own
    YCbCr -> RGB, CMYK, P and PA with the palette read from the pclr box
    (OpenJPEG's tile interface applies no pclr / cmap / cdef), then
    convert("RGB").

Where Pillow raises (a tile-part longer than the file, which OpenJPEG's
strict mode refuses; more than four components; a colour space Pillow has
no unpacker for; an HT code-block OpenJPEG refuses) the port raises
ValueError with its reason.
"""
from __future__ import annotations

import math
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import jpeg2000_ht as ht
from . import jpeg2000_t1 as t1
from .rasters import _boxes, _cmyk, _grey, _lut

COD, COC, QCD, QCC, RGN, POC = (0xFF52, 0xFF53, 0xFF5C, 0xFF5D, 0xFF5E,
                                0xFF5F)
PPM, PPT, PLT, COM, CAP = 0xFF60, 0xFF61, 0xFF58, 0xFF64, 0xFF50
SOT, SOD, EOC = 0xFF90, 0xFF93, 0xFFD9
JP2_SIGNATURE = b"\0\0\0\x0cjP  \r\n\x87\n"
BROKEN = "broken data stream when reading image file"
LRCP, RLCP, RPCL, PCRL = range(4)          # 4: CPRL
# OpenJPEG's 9/7 synthesis: the low band times K, the high band times its
# two_invK, then four lifting steps x += (left + right) * c
_K = np.float32(1.230174105)
_TWO_INV_K = np.float32(1.625732422)
_LIFT = (np.float32(-0.443506852), np.float32(-0.882911075),
         np.float32(0.052980118), np.float32(1.586134342))


def _broken(path: str, why: str = BROKEN) -> ValueError:
    return ValueError(f"{path}: JPEG 2000: {why} (Pillow: {BROKEN})")


# ---------------------------------------------------------------- header

def jpeg2000_header(blob: bytes, path: str) -> Tuple[str, int, int]:
    """Jpeg2KImagePlugin's size and mode: a raw codestream's SIZ segment,
    or a JP2 file's ihdr, colr and pclr boxes."""
    if blob[:4] == b"\xff\x4f\xff\x51":
        siz = blob[4:]
        if len(siz) < 39:
            raise ValueError(f"{path}: truncated JPEG 2000 codestream")
        _, _, xs, ys, xo, yo, _, _, _, _, c = struct.unpack_from(
            ">HHIIIIIIIIH", siz)
        mode = {1: "I;16" if (siz[38] & 0x7F) + 1 > 8 else "L", 2: "LA",
                3: "RGB", 4: "RGBA"}.get(c)
        if mode is None:
            raise ValueError(f"{path}: JPEG 2000 of {c} components (Pillow: "
                             "unable to determine J2K image mode)")
        return mode, ys - yo, xs - xo
    mode, h, w, _ = _jp2_header(blob, path)
    return mode, h, w


def _jp2_header(blob: bytes, path: str):
    """(mode, height, width, palette or None) from the jp2h box, as
    _parse_jp2_header reads it: the palette's colours as
    ImagePalette.getcolor adds them (each new colour once)."""
    size = mode = nc = palette = None
    for typ, body in _boxes(blob, 0, len(blob)):
        if typ != b"jp2h":
            continue
        for t, b in _boxes(body, 0, len(body)):
            if t == b"ihdr" and len(b) >= 11:
                h, w, nc, bpc = struct.unpack(">IIHB", b[:11])
                size = (h, w)
                mode = {1: "I;16" if bpc & 0x7F > 8 else "L", 2: "LA",
                        3: "RGB", 4: "RGBA"}.get(nc)
            elif t == b"colr" and nc == 4 and len(b) >= 7:
                if b[0] == 1 and struct.unpack(">I", b[3:7])[0] == 12:
                    mode = "CMYK"
            elif t == b"pclr" and mode in ("L", "LA") and len(b) >= 3:
                ne, npc = struct.unpack(">HB", b[:3])
                if max(b[3:3 + npc], default=0) <= 8:
                    colours: Dict[tuple, int] = {}
                    at = 3 + npc
                    for _ in range(ne):
                        if at + npc > len(b):
                            raise ValueError(f"{path}: JPEG 2000: pclr box "
                                             "cut short (Pillow: Not enough "
                                             "data in header)")
                        colours.setdefault(tuple(b[at:at + npc]),
                                           len(colours))
                        at += npc
                    palette = np.array(list(colours)[:256], np.uint8
                                       ).reshape(-1, npc)
                    mode = "P" if mode == "L" else "PA"
        break
    if size is None or mode is None:
        raise ValueError(f"{path}: malformed JP2 header")
    return mode, size[0], size[1], palette


# ------------------------------------------------------------ codestream

class _Coding:
    """COD / COC's SPcod: decomposition levels, code-block size exponents,
    style bits, the wavelet (True: 5/3) and the precinct exponents of each
    resolution."""
    __slots__ = ("levels", "xcb", "ycb", "style", "reversible", "prec")

    def __init__(self, b: bytes, custom_precincts: bool, path: str):
        if len(b) < 5:
            raise _broken(path, "short COD / COC segment")
        self.levels, xcb, ycb, self.style, wavelet = b[:5]
        self.xcb, self.ycb = xcb + 2, ycb + 2
        self.reversible = wavelet == 1
        if self.levels > 32 or self.xcb > 10 or self.ycb > 10 or \
                self.xcb + self.ycb > 12:
            raise _broken(path, "bad COD / COC segment")
        if self.style & t1.HT_MIXED:
            raise _broken(path, "Error reading SPCod SPCoc element. "
                          "Unsupported Mixed HT code-block style found")
        n = self.levels + 1
        if custom_precincts:
            if len(b) < 5 + n:
                raise _broken(path, "short COD / COC segment")
            self.prec = [(v & 15, v >> 4) for v in b[5:5 + n]]
            if any(0 in pp for pp in self.prec[1:]):
                raise _broken(path, "precinct exponent 0 above the lowest "
                              "resolution")
        else:
            self.prec = [(15, 15)] * n


class _Quant:
    """QCD / QCC: the style (0 none, 1 scalar derived, 2 scalar
    expounded), the guard bits and each band's (exponent, mantissa)."""
    __slots__ = ("style", "guard", "steps")

    def __init__(self, b: bytes, path: str):
        if not b:
            raise _broken(path, "short QCD / QCC segment")
        self.style, self.guard = b[0] & 0x1F, b[0] >> 5
        if self.style == 0:
            self.steps = [(v >> 3, 0) for v in b[1:]]
        else:
            n = (len(b) - 1) // 2
            self.steps = [(v >> 11, v & 0x7FF) for v in
                          struct.unpack(f">{n}H", b[1:1 + 2 * n])]
        if not self.steps:
            raise _broken(path, "short QCD / QCC segment")

    def step(self, band: int) -> Tuple[int, int]:
        """(exponent, mantissa) of band `band` (0 LL, then HL, LH, HH of
        each resolution)."""
        if self.style == 1:
            e, m = self.steps[0]
            return max(e - (band - 1) // 3, 0) if band else e, m
        if band >= len(self.steps):
            return 0, 0
        return self.steps[band]


class _Params:
    """What a main or tile header sets: COD (style, progression, layers,
    MCT and the coding of every component), COC, QCD, QCC, RGN, POC."""

    def __init__(self):
        self.cod = None            # (Scod, progression, layers, mct, coding)
        self.coc: Dict[int, _Coding] = {}
        self.qcd: Optional[_Quant] = None
        self.qcc: Dict[int, _Quant] = {}
        self.rgn: Dict[int, int] = {}
        self.poc: List[tuple] = []


class _Stream:
    """A parsed codestream: SIZ, the main header's parameters, and each
    tile's parameters, data and packed packet headers."""

    def __init__(self, cs: bytes, path: str):
        self.path = path
        if cs[:4] != b"\xff\x4f\xff\x51":
            raise _broken(path, "no SOC + SIZ")
        self.main = _Params()
        self.tiles: Dict[int, dict] = {}
        ppm: List[Tuple[int, bytes]] = []
        _, _, body, at = self._segment(cs, 2)
        self._siz(body)
        while cs[at:at + 2] != b"\xff\x90":
            marker, _, body, at_next = self._segment(cs, at)
            if marker == PPM:
                ppm.append((body[0], body[1:]))
            else:
                self._param(self.main, marker, body)
            at = at_next
        if self.main.cod is None or self.main.qcd is None:
            raise _broken(path, "no COD or QCD in the main header")
        self.ppm, self.ppm_at = None, 0
        if ppm:
            data = b"".join(b for _, b in sorted(ppm, key=lambda z: z[0]))
            chunks, i = [], 0
            while i + 4 <= len(data):
                n, = struct.unpack(">I", data[i:i + 4])
                chunks.append(data[i + 4:i + 4 + n])
                i += 4 + n
            self.ppm = b"".join(chunks)
        self._tile_parts(cs, at)

    def _segment(self, cs: bytes, at: int):
        """(marker, its offset, its body, the offset after it)."""
        if at + 4 > len(cs):
            raise _broken(self.path, "codestream cut in a header")
        marker, length = struct.unpack(">HH", cs[at:at + 4])
        if marker < 0xFF30 or length < 2 or at + 2 + length > len(cs):
            raise _broken(self.path, f"bad marker segment {marker:#06x}")
        return marker, at, cs[at + 4:at + 2 + length], at + 2 + length

    def _siz(self, b: bytes):
        if len(b) < 36:
            raise _broken(self.path, "short SIZ")
        (rsiz, self.X1, self.Y1, self.X0, self.Y0, self.XT, self.YT,
         self.XT0, self.YT0, nc) = struct.unpack(">HIIIIIIIIH", b[:36])
        if len(b) < 36 + 3 * nc or nc == 0:
            raise _broken(self.path, "short SIZ")
        self.precision = [(b[36 + 3 * i] & 0x7F) + 1 for i in range(nc)]
        self.signed = [bool(b[36 + 3 * i] & 0x80) for i in range(nc)]
        self.dx = [b[37 + 3 * i] for i in range(nc)]
        self.dy = [b[38 + 3 * i] for i in range(nc)]
        if not (self.X0 < self.X1 and self.Y0 < self.Y1 and self.XT and
                self.YT and self.XT0 <= self.X0 and self.YT0 <= self.Y0
                and self.XT0 + self.XT > self.X0 and self.YT0 + self.YT
                > self.Y0 and min(self.dx + self.dy) > 0
                and max(self.precision) <= 31):
            raise _broken(self.path, "bad SIZ")
        self.nx = -(-(self.X1 - self.XT0) // self.XT)
        self.ny = -(-(self.Y1 - self.YT0) // self.YT)
        self.nc = nc

    def _comp(self, b: bytes) -> Tuple[int, bytes]:
        if self.nc < 257:
            return b[0], b[1:]
        return struct.unpack(">H", b[:2])[0], b[2:]

    def _param(self, p: _Params, marker: int, b: bytes):
        path = self.path
        if marker == COD:
            if len(b) < 5:
                raise _broken(path, "short COD")
            scod, prog, layers, mct = b[0], b[1], struct.unpack(
                ">H", b[2:4])[0], b[4]
            if prog > 4 or layers == 0:
                raise _broken(path, "bad COD")
            p.cod = (scod, prog, layers, mct, _Coding(b[5:], scod & 1, path))
        elif marker == COC:
            c, rest = self._comp(b)
            if c >= self.nc or not rest:
                raise _broken(path, "bad COC")
            p.coc[c] = _Coding(rest[1:], rest[0] & 1, path)
        elif marker == QCD:
            p.qcd = _Quant(b, path)
        elif marker == QCC:
            c, rest = self._comp(b)
            if c >= self.nc:
                raise _broken(path, "bad QCC")
            p.qcc[c] = _Quant(rest, path)
        elif marker == RGN:
            c, rest = self._comp(b)
            if c >= self.nc or len(rest) < 2:
                raise _broken(path, "bad RGN")
            p.rgn[c] = rest[1]
        elif marker == POC:
            w = 1 if self.nc < 257 else 2
            size = 5 + 2 * w
            for i in range(0, len(b) - size + 1, size):
                e = b[i:i + size]
                cs = e[1] if w == 1 else struct.unpack(">H", e[1:3])[0]
                ly, = struct.unpack(">H", e[1 + w:3 + w])
                ce = e[4 + w] if w == 1 else struct.unpack(
                    ">H", e[4 + w:6 + w])[0]
                p.poc.append((e[0], cs, ly, e[3 + w], ce or 256, e[-1]))
        # TLM, PLM, PLT, CRG, COM and the rest say nothing the decoder needs

    def _tile_parts(self, cs: bytes, at: int):
        """Each tile's header parameters, its tile-parts' data in stream
        order and its PPT headers, as OpenJPEG's strict mode reads them: a
        tile-part longer than the stream is refused, and so is one not
        followed by a marker; EOC, or any marker that ends the stream,
        ends the tiles."""
        n_tiles = self.nx * self.ny
        self.order: List[int] = []       # tiles in the order they complete
        while True:
            if at + 2 > len(cs):
                raise _broken(self.path, "no marker after a tile-part")
            marker, = struct.unpack(">H", cs[at:at + 2])
            if marker == EOC or at + 2 == len(cs):
                break
            if marker != SOT:
                raise _broken(self.path, f"expected SOT, found {marker:#06x}")
            _, start, b, at_hdr = self._segment(cs, at)
            if len(b) < 8:
                raise _broken(self.path, "short SOT")
            isot, psot, tpsot, tnsot = struct.unpack(">HIBB", b[:8])
            if isot >= n_tiles:
                raise _broken(self.path, "tile index out of range")
            end = len(cs) - 2 if psot == 0 else start + psot
            if end > len(cs):
                raise _broken(self.path, "tile-part longer than the file")
            tile = self.tiles.setdefault(isot, {
                "params": _Params(), "data": [], "ppt": [], "parts": 0})
            if tpsot != tile["parts"]:
                raise _broken(self.path, "tile-parts out of order")
            tile["parts"] += 1
            at = at_hdr
            while True:
                marker, _, body, at_next = self._segment(cs, at) \
                    if cs[at:at + 2] != b"\xff\x93" else (SOD, at, b"", at + 2)
                if marker == SOD:
                    at = at_next
                    break
                if marker == PPT:
                    tile["ppt"].append((body[0], body[1:]))
                elif tpsot == 0 or marker in (POC, PLT, COM):
                    self._param(tile["params"], marker, body)
                at = at_next
            if at > end:
                raise _broken(self.path, "tile-part header past its end")
            tile["data"].append(cs[at:end])
            at = end
            if tile["parts"] == tnsot:
                self.order.append(isot)
        self.order += [t for t in self.tiles if t not in self.order]

    def tile_params(self, t: int):
        """The tile's effective parameters: tile COC > tile COD > main COC
        > main COD, and the same for QCC / QCD and RGN."""
        tp = self.tiles[t]["params"] if t in self.tiles else _Params()
        m = self.main
        cod = tp.cod or m.cod
        scod, prog, layers, mct, coding = cod
        comps = []
        for c in range(self.nc):
            cc = tp.coc.get(c) or (None if tp.cod else m.coc.get(c)) \
                or coding
            q = tp.qcc.get(c) or (None if tp.qcd else m.qcc.get(c)) \
                or tp.qcd or m.qcd
            roi = tp.rgn.get(c, m.rgn.get(c, 0))
            comps.append((cc, q, roi))
        return scod, prog, layers, mct, comps, tp.poc or m.poc


# ---------------------------------------------------------------- tier-2

def _ceil(a: int, b: int) -> int:
    return -(-a // b)


class _Bits:
    """opj_bio: packet-header bits, MSB first, a 0 bit stuffed after each
    0xFF; past the end it reads 0s."""
    __slots__ = ("b", "at", "end", "buf", "ct")

    def __init__(self, b: bytes, at: int, end: int):
        self.b, self.at, self.end, self.buf, self.ct = b, at, end, 0, 0

    def bit(self) -> int:
        if self.ct == 0:
            self.buf = (self.buf << 8) & 0xFFFF
            self.ct = 7 if self.buf == 0xFF00 else 8
            if self.at < self.end:
                self.buf |= self.b[self.at]
                self.at += 1
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align(self) -> int:
        """opj_bio_inalign; the offset after the header."""
        if (self.buf & 0xFF) == 0xFF:
            self.buf = (self.buf << 8) & 0xFFFF
            if self.at < self.end:
                self.buf |= self.b[self.at]
                self.at += 1
        self.ct = 0
        return self.at


class _TagTree:
    """A tag tree over w x h leaves (opj_tgt), decoded lazily."""

    def __init__(self, w: int, h: int):
        self.levels = []           # (offset, width) of each level
        n = 0
        while True:
            self.levels.append((n, w))
            n += w * h
            if w * h <= 1:
                break
            w, h = (w + 1) // 2, (h + 1) // 2
        self.value = [999] * n
        self.low = [0] * n

    def decode(self, bits: _Bits, x: int, y: int, threshold: int) -> bool:
        path = []
        for off, w in self.levels:
            path.append(off + y * w + x)
            x, y = x >> 1, y >> 1
        low = 0
        value, lows = self.value, self.low
        for node in reversed(path):
            if low > lows[node]:
                lows[node] = low
            else:
                low = lows[node]
            while low < threshold and low < value[node]:
                if bits.bit():
                    value[node] = low
                else:
                    low += 1
            lows[node] = low
        return value[path[0]] < threshold


class _Block:
    """A code-block: its rectangle in band coordinates and what the
    packets gave it."""
    __slots__ = ("x0", "y0", "x1", "y1", "numbps", "lblock", "segs",
                 "chunks")

    def __init__(self, x0, y0, x1, y1):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.numbps = self.lblock = 0
        self.segs: List[list] = []       # [data chunks, passes, max passes]
        self.chunks: List[Tuple[int, bytes]] = []  # (offset, data) as read


class _Band:
    __slots__ = ("no", "x0", "y0", "x1", "y1", "numbps", "step", "precs")


class _Res:
    __slots__ = ("x0", "y0", "x1", "y1", "pdx", "pdy", "pw", "ph", "bands")


def _resolutions(tc, coding: _Coding, quant: _Quant, prec: int,
                 reversible: bool) -> List[_Res]:
    """opj_tcd_init_tile for one tile-component: its resolutions, bands,
    precincts (lists of code-blocks per band) with their tag trees."""
    x0, y0, x1, y1 = tc
    nl = coding.levels
    out = []
    for r in range(nl + 1):
        lv = nl - r
        res = _Res()
        res.x0, res.y0 = _ceil(x0, 1 << lv), _ceil(y0, 1 << lv)
        res.x1, res.y1 = _ceil(x1, 1 << lv), _ceil(y1, 1 << lv)
        pdx, pdy = coding.prec[r]
        res.pdx, res.pdy = pdx, pdy
        px0 = (res.x0 >> pdx) << pdx
        py0 = (res.y0 >> pdy) << pdy
        px1 = _ceil(res.x1, 1 << pdx) << pdx
        py1 = _ceil(res.y1, 1 << pdy) << pdy
        res.pw = 0 if res.x0 == res.x1 else (px1 - px0) >> pdx
        res.ph = 0 if res.y0 == res.y1 else (py1 - py0) >> pdy
        if r == 0:
            gx0, gy0, gw, gh = px0, py0, pdx, pdy
            nos = (0,)
        else:
            gx0, gy0, gw, gh = _ceil(px0, 2), _ceil(py0, 2), pdx - 1, pdy - 1
            nos = (1, 2, 3)
        cbw, cbh = min(coding.xcb, gw), min(coding.ycb, gh)
        res.bands = []
        for no in nos:
            b = _Band()
            b.no = no
            if no == 0:
                b.x0, b.y0 = _ceil(x0, 1 << lv), _ceil(y0, 1 << lv)
                b.x1, b.y1 = _ceil(x1, 1 << lv), _ceil(y1, 1 << lv)
            else:
                ox, oy = no & 1, no >> 1
                b.x0 = _ceil(x0 - (ox << lv), 2 << lv)
                b.y0 = _ceil(y0 - (oy << lv), 2 << lv)
                b.x1 = _ceil(x1 - (ox << lv), 2 << lv)
                b.y1 = _ceil(y1 - (oy << lv), 2 << lv)
            index = 0 if r == 0 else 3 * (r - 1) + no
            expn, mant = quant.step(index)
            gain = 0 if not reversible else (0, 1, 1, 2)[no]
            b.step = np.float32((1.0 + mant / 2048.0) *
                                2.0 ** (prec + gain - expn))
            b.numbps = expn + quant.guard - 1
            b.precs = []
            for k in range(res.pw * res.ph):
                cx0 = gx0 + (k % res.pw) * (1 << gw)
                cy0 = gy0 + (k // res.pw) * (1 << gh)
                p0x, p0y = max(cx0, b.x0), max(cy0, b.y0)
                p1x, p1y = min(cx0 + (1 << gw), b.x1), min(cy0 + (1 << gh),
                                                            b.y1)
                bx0 = (p0x >> cbw) << cbw
                by0 = (p0y >> cbh) << cbh
                cw = max(0, (_ceil(p1x, 1 << cbw) << cbw) - bx0) >> cbw
                ch = max(0, (_ceil(p1y, 1 << cbh) << cbh) - by0) >> cbh
                blocks = []
                for j in range(ch):
                    for i in range(cw):
                        ax = bx0 + (i << cbw)
                        ay = by0 + (j << cbh)
                        blocks.append(_Block(max(ax, p0x), max(ay, p0y),
                                             min(ax + (1 << cbw), p1x),
                                             min(ay + (1 << cbh), p1y)))
                b.precs.append([blocks, cw, ch, None, None])
            res.bands.append(b)
        out.append(res)
    return out


def _packets(prog_list, comps, layers, tile, nc):
    """The packets (layer, resolution, component, precinct) of a tile in
    stream order: each progression (the COD's, or the POC's entries) as
    OpenJPEG's pi_next_* walks it, a packet once."""
    tx0, ty0, tx1, ty1 = tile
    done = set()
    out = []

    def emit(l, r, c, p):
        key = (l, r, c, p)
        if key not in done:
            done.add(key)
            out.append(key)

    def precinct(c, r, x, y):
        """The precinct of component c, resolution r that starts at grid
        point (x, y), or None."""
        dx, dy, res = comps[c]
        if r >= len(res):
            return None
        rr = res[r]
        lv = len(res) - 1 - r
        trx0, try0 = _ceil(tx0, dx << lv), _ceil(ty0, dy << lv)
        trx1, try1 = _ceil(tx1, dx << lv), _ceil(ty1, dy << lv)
        rpx, rpy = rr.pdx + lv, rr.pdy + lv
        if not (y % (dy << rpy) == 0 or (y == ty0 and (try0 << lv) %
                                          (1 << rpy))):
            return None
        if not (x % (dx << rpx) == 0 or (x == tx0 and (trx0 << lv) %
                                          (1 << rpx))):
            return None
        if rr.pw == 0 or rr.ph == 0 or trx0 == trx1 or try0 == try1:
            return None
        pi = (_ceil(x, dx << lv) >> rr.pdx) - (trx0 >> rr.pdx)
        pj = (_ceil(y, dy << lv) >> rr.pdy) - (try0 >> rr.pdy)
        return pi + pj * rr.pw

    def steps(cs):
        sx = sy = 0
        for c in cs:
            dx, dy, res = comps[c]
            for r, rr in enumerate(res):
                lv = len(res) - 1 - r
                ax, ay = dx << (rr.pdx + lv), dy << (rr.pdy + lv)
                sx = ax if not sx else min(sx, ax)
                sy = ay if not sy else min(sy, ay)
        return sx, sy

    def grid(sx, sy):
        y = ty0
        while y < ty1:
            x = tx0
            while x < tx1:
                yield x, y
                x += sx - x % sx
            y += sy - y % sy

    for r0, c0, l1, r1, c1, prog in prog_list:
        c1 = min(c1, nc)
        l1 = min(l1, layers)
        rmax = max(len(comps[c][2]) for c in range(nc))
        r1 = min(r1, rmax)
        if prog == LRCP:
            for l in range(l1):
                for r in range(r0, r1):
                    for c in range(c0, c1):
                        res = comps[c][2]
                        if r < len(res):
                            for p in range(res[r].pw * res[r].ph):
                                emit(l, r, c, p)
        elif prog == RLCP:
            for r in range(r0, r1):
                for l in range(l1):
                    for c in range(c0, c1):
                        res = comps[c][2]
                        if r < len(res):
                            for p in range(res[r].pw * res[r].ph):
                                emit(l, r, c, p)
        elif prog == RPCL:
            sx, sy = steps(range(nc))
            for r in range(r0, r1):
                for x, y in grid(sx, sy):
                    for c in range(c0, c1):
                        p = precinct(c, r, x, y)
                        if p is not None:
                            for l in range(l1):
                                emit(l, r, c, p)
        elif prog == PCRL:
            sx, sy = steps(range(nc))
            for x, y in grid(sx, sy):
                for c in range(c0, c1):
                    for r in range(r0, min(r1, len(comps[c][2]))):
                        p = precinct(c, r, x, y)
                        if p is not None:
                            for l in range(l1):
                                emit(l, r, c, p)
        else:
            for c in range(c0, c1):
                sx, sy = steps((c,))
                for x, y in grid(sx, sy):
                    for r in range(r0, min(r1, len(comps[c][2]))):
                        p = precinct(c, r, x, y)
                        if p is not None:
                            for l in range(l1):
                                emit(l, r, c, p)
    return out


def _numpasses(bits: _Bits) -> int:
    if not bits.bit():
        return 1
    if not bits.bit():
        return 2
    n = bits.read(2)
    if n != 3:
        return 3 + n
    n = bits.read(5)
    if n != 31:
        return 6 + n
    return 37 + bits.read(7)


def _new_seg(blk: _Block, style: int) -> list:
    if style & t1.TERMALL:
        most = 1
    elif style & t1.BYPASS:
        if not blk.segs:
            most = 10
        else:
            most = 2 if blk.segs[-1][2] in (1, 10) else 1
    else:
        most = 109
    seg = [[], 0, most]
    blk.segs.append(seg)
    return seg


def _read_packets(st: _Stream, tile_no: int, order, comps, styles, csty):
    """Tier-2 of one tile: every packet's header (in its body or from the
    PPM / PPT headers) and its code-block contributions."""
    tile = st.tiles.get(tile_no)
    body = b"".join(tile["data"]) if tile else b""
    if st.ppm is not None:
        head, hat = st.ppm, st.ppm_at
    elif tile and tile["ppt"]:
        head = b"".join(b for _, b in sorted(tile["ppt"], key=lambda z: z[0]))
        hat = 0
    else:
        head, hat = None, 0
    at = 0
    for l, r, c, p in order:
        res = comps[c][2][r]
        if l == 0:
            for b in res.bands:
                pr = b.precs[p]
                pr[3] = _TagTree(pr[1], pr[2]) if pr[1] * pr[2] else None
                pr[4] = _TagTree(pr[1], pr[2]) if pr[1] * pr[2] else None
                for blk in pr[0]:
                    blk.segs, blk.chunks = [], []
        if csty & 2 and body[at:at + 2] == b"\xff\x91" and \
                len(body) - at >= 6:
            at += 6
        if head is None:
            bits = _Bits(body, at, len(body))
        else:
            bits = _Bits(head, hat, len(head))
        news = []
        if bits.bit():
            for b in res.bands:
                if b.x1 <= b.x0 or b.y1 <= b.y0:
                    continue
                where = f"(p={p}, b={max(b.no - 1, 0)}, r={r}, c={c})"
                blocks, cw, ch, incl, imsb = b.precs[p]
                for k, blk in enumerate(blocks):
                    x, y = k % cw, k // cw
                    if not blk.segs:
                        if not incl.decode(bits, x, y, l + 1):
                            continue
                        i = 0
                        while not imsb.decode(bits, x, y, i):
                            i += 1
                        blk.numbps = b.numbps + 1 - i
                        blk.lblock = 3
                    elif not bits.bit():
                        continue
                    n = _numpasses(bits)
                    while bits.bit():
                        blk.lblock += 1
                    style = styles[c]
                    seg = blk.segs[-1] if blk.segs and \
                        blk.segs[-1][1] < blk.segs[-1][2] else \
                        _new_seg(blk, style)
                    while True:
                        if style & t1.HT:   # the cleanup pass alone first
                            k_new = 1 if len(blk.segs) == 1 else n
                        else:
                            k_new = min(seg[2] - seg[1], n)
                        nbits = blk.lblock + int(math.log2(k_new))
                        if nbits > 32:
                            raise _broken(st.path, "bad codeword length")
                        news.append((blk, seg, bits.read(nbits),
                                     f"codeblock {k} {where}"))
                        seg[1] += k_new
                        n -= k_new
                        if n <= 0:
                            break
                        seg = _new_seg(blk, style)
        end = bits.align()
        if head is None:
            at = end
            src = body
        else:
            hat = end
            src = head
        if csty & 4 and src[end:end + 2] == b"\xff\x92":
            if head is None:
                at += 2
            else:
                hat += 2
        most = len(body) - at
        for blk, seg, n_bytes, which in news:
            if at + n_bytes > len(body):
                raise _broken(st.path, f"read: segment too long ({n_bytes}) "
                              f"with max ({most}) for {which}")
            seg[0].append(body[at:at + n_bytes])
            blk.chunks.append((at, body[at:at + n_bytes]))
            at += n_bytes
    if st.ppm is not None:
        st.ppm_at = hat


# -------------------------------------------------------- pixel stages

def _lift53(a: np.ndarray, sn: int, cas: int) -> np.ndarray:
    """The inverse 5/3 along the last axis of `a` ([low | high] ->
    interleaved), as opj_idwt53_h computes it."""
    n = a.shape[-1]
    lo, hi = a[..., :sn].copy(), a[..., sn:].copy()
    dn = n - sn
    out = np.empty_like(a)
    if cas == 0:
        if n == 1:
            return a.copy()
        di = np.arange(sn)
        lo -= (hi[..., np.clip(di - 1, 0, dn - 1)] +
               hi[..., np.clip(di, 0, dn - 1)] + 2) >> 2
        si = np.arange(dn)
        hi += (lo[..., si] + lo[..., np.clip(si + 1, 0, sn - 1)]) >> 1
        out[..., 0::2], out[..., 1::2] = lo, hi
    else:
        if n == 1:                       # C's division: toward zero
            return np.sign(a) * (np.abs(a) >> 1)
        di = np.arange(sn)
        lo -= (hi[..., di] + hi[..., np.clip(di + 1, 0, dn - 1)] + 2) >> 2
        si = np.arange(dn)
        hi += (lo[..., np.clip(si - 1, 0, sn - 1)] +
               lo[..., np.clip(si, 0, sn - 1)]) >> 1
        out[..., 0::2], out[..., 1::2] = hi, lo
    return out


def _lift97(a: np.ndarray, sn: int, cas: int) -> np.ndarray:
    """The inverse 9/7 along the last axis of float32 `a`, as
    opj_v8dwt_decode computes it."""
    n = a.shape[-1]
    if n == 1:
        return a.copy()
    lo, hi = a[..., :sn] * _K, a[..., sn:] * _TWO_INV_K
    dn = n - sn
    li, hi_i = np.arange(sn), np.arange(dn)
    if cas == 0:
        ll, lr = np.clip(li - 1, 0, dn - 1), np.clip(li, 0, dn - 1)
        hl, hr = hi_i, np.clip(hi_i + 1, 0, sn - 1)
    else:
        ll, lr = li, np.clip(li + 1, 0, dn - 1)
        hl, hr = np.clip(hi_i - 1, 0, sn - 1), np.clip(hi_i, 0, sn - 1)
    c1, c2, c3, c4 = _LIFT
    lo = lo + (hi[..., ll] + hi[..., lr]) * c1
    hi = hi + (lo[..., hl] + lo[..., hr]) * c2
    lo = lo + (hi[..., ll] + hi[..., lr]) * c3
    hi = hi + (lo[..., hl] + lo[..., hr]) * c4
    out = np.empty_like(a)
    if cas == 0:
        out[..., 0::2], out[..., 1::2] = lo, hi
    else:
        out[..., 0::2], out[..., 1::2] = hi, lo
    return out


def _idwt(a: np.ndarray, res: List[_Res], reversible: bool) -> np.ndarray:
    """The inverse DWT of a tile-component laid out as OpenJPEG lays it
    (each level's low band first): rows, then columns, level by level."""
    lift = _lift53 if reversible else _lift97
    for r in range(1, len(res)):
        lo, rr = res[r - 1], res[r]
        w, h = rr.x1 - rr.x0, rr.y1 - rr.y0
        if w == 0 or h == 0:
            continue
        blk = a[:h, :w]
        blk = lift(blk, lo.x1 - lo.x0, rr.x0 & 1)
        blk = lift(blk.T, lo.y1 - lo.y0, rr.y0 & 1).T
        a[:h, :w] = blk
    return a


def _decode_ht(blk: _Block, band: _Band, roi: int, style: int, path: str
               ) -> Optional[np.ndarray]:
    """An HT code-block through data/jpeg2000_ht.py, or None where it
    holds no data. OpenJPEG hands every block to its HT decoder, so ROI
    fails even an empty one."""
    if not blk.segs and not roi:
        return None
    coded = b"".join(d for _, d in blk.chunks)
    # one chunk is read where it lies in the tile's data, several from a
    # fresh (aligned) buffer
    align = blk.chunks[0][0] if len(blk.chunks) == 1 else 0
    try:
        return ht.decode_cblk(
            blk.x1 - blk.x0, blk.y1 - blk.y0, coded,
            [sum(len(c) for c in s[0]) for s in blk.segs],
            [s[1] for s in blk.segs], band.numbps, blk.numbps, roi, style,
            align)
    except ht.HTError as e:
        raise _broken(path, str(e)) from None


def _decode_tile(st: _Stream, t: int) -> Tuple[tuple, List[np.ndarray]]:
    """One tile: its rectangle on the canvas and each component's int64
    samples after the MCT, the DC level shift and the clamp."""
    p, q = t % st.nx, t // st.nx
    tx0 = max(st.XT0 + p * st.XT, st.X0)
    ty0 = max(st.YT0 + q * st.YT, st.Y0)
    tx1 = min(st.XT0 + (p + 1) * st.XT, st.X1)
    ty1 = min(st.YT0 + (q + 1) * st.YT, st.Y1)
    scod, prog, layers, mct, params, pocs = st.tile_params(t)
    path = st.path
    comps, styles = [], []
    for c, (coding, quant, roi) in enumerate(params):
        tc = (_ceil(tx0, st.dx[c]), _ceil(ty0, st.dy[c]),
              _ceil(tx1, st.dx[c]), _ceil(ty1, st.dy[c]))
        comps.append((st.dx[c], st.dy[c], _resolutions(
            tc, coding, quant, st.precision[c], coding.reversible)))
        styles.append(coding.style)
    progs = pocs or [(0, 0, layers, 33, st.nc, prog)]
    order = _packets(progs, comps, layers, (tx0, ty0, tx1, ty1), st.nc)
    _read_packets(st, t, order, comps, styles, scod)
    out = []
    for c, (coding, quant, roi) in enumerate(params):
        res = comps[c][2]
        top = res[-1]
        a = np.zeros((top.y1 - top.y0, top.x1 - top.x0),
                     np.int64 if coding.reversible else np.float32)
        for r, rr in enumerate(res):
            for b in rr.bands:
                ox = res[r - 1].x1 - res[r - 1].x0 if b.no & 1 else 0
                oy = res[r - 1].y1 - res[r - 1].y0 if b.no & 2 else 0
                for pr in b.precs:
                    for blk in pr[0]:
                        if coding.style & t1.HT:
                            v = _decode_ht(blk, b, roi, coding.style, path)
                            if v is None:
                                continue
                        elif not blk.segs:
                            continue
                        else:
                            segs = [(b"".join(s[0]), s[1]) for s in blk.segs]
                            v = t1.decode_cblk(blk.x1 - blk.x0,
                                               blk.y1 - blk.y0, b.no, segs,
                                               blk.numbps, roi, coding.style)
                        if coding.reversible:
                            v = np.sign(v) * (np.abs(v) >> 1)
                        else:
                            v = v.astype(np.float32) * (np.float32(0.5) *
                                                        b.step)
                        y, x = blk.y0 - b.y0 + oy, blk.x0 - b.x0 + ox
                        a[y:y + v.shape[0], x:x + v.shape[1]] = v
        out.append(_idwt(a, res, coding.reversible))
    if mct and st.nc >= 3:
        if not (out[0].shape == out[1].shape == out[2].shape):
            raise _broken(path, "MCT over components of different sizes")
        y, u, v = out[:3]
        if params[0][0].reversible:
            g = y - ((u + v) >> 2)
            out[:3] = [v + g, g, u + g]
        else:
            out[:3] = [y + v * np.float32(1.402),
                       y - u * np.float32(0.34413) - v * np.float32(0.71414),
                       y + u * np.float32(1.772)]
    for c in range(st.nc):
        prec, sgnd = st.precision[c], st.signed[c]
        lo, hi = (-(1 << (prec - 1)), (1 << (prec - 1)) - 1) if sgnd else \
            (0, (1 << prec) - 1)
        shift = 0 if sgnd else 1 << (prec - 1)
        v = out[c]
        if v.dtype.kind == "f":
            v = np.rint(v).astype(np.int64)
        out[c] = np.clip(v + shift, lo, hi)
    return (tx0, ty0, tx1, ty1), out


# --------------------------------------------------------- Pillow's side

def _ycbcr_tables():
    """ConvertYCbCr.c's tables at SCALE 6: R_Cr, G_Cb, G_Cr, B_Cb, each
    entry int(k * (i - 128) * 64 + 0.5) (rounded toward zero)."""
    i = np.arange(256) - 128
    f = lambda k: np.trunc(k * i * 64 + 0.5).astype(np.int64)
    return f(1.40200), f(-0.34414), f(-0.71414), f(1.77200)


_R_CR, _G_CB, _G_CR, _B_CB = _ycbcr_tables()


def ycbcr_to_rgb(px: np.ndarray) -> np.ndarray:
    """Pillow's ImagingConvertYCbCr2RGB of (..., 3) uint8 samples."""
    y = px[..., 0].astype(np.int64)
    cb, cr = px[..., 1], px[..., 2]
    rgb = np.stack([y + (_R_CR[cr] >> 6), y + ((_G_CB[cb] + _G_CR[cr]) >> 6),
                    y + (_B_CB[cb] >> 6)], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _csiz(prec: int) -> int:
    n = (prec + 7) >> 3
    return 4 if n == 3 else n


def _to_bits(word: np.ndarray, prec: int, sgnd: bool, bits: int
             ) -> np.ndarray:
    """j2ku_shift(offset + word, shift) kept to `bits` bits, as Pillow
    stores it."""
    shift = bits - prec
    off = (1 << (prec - 1)) if sgnd else 0
    if shift < 0:
        off += 1 << (-shift - 1)
        v = (word + off) >> -shift
    else:
        v = (word + off) << shift
    return v & ((1 << bits) - 1)


def _unpack(st: _Stream, kind: str, sycc: bool, tile: tuple,
            samples: List[np.ndarray], img: np.ndarray):
    """One of Jpeg2KDecode.c's j2ku_* unpackers over OpenJPEG's tile
    buffer (each component's samples, csiz bytes each), read back at
    Pillow's offsets and strides into `img`: "l" grey (j2ku_gray_l / _rgb,
    also P's indices), "i16" (j2ku_gray_i), "la" (j2ku_graya_la, also
    PA), "rgb" and "rgba" (j2ku_srgb_rgb / srgba_rgba, through Pillow's
    YCbCr -> RGB where `sycc`)."""
    tx0, ty0, tx1, ty1 = tile
    w, h = tx1 - tx0, ty1 - ty0
    x0, y0 = tx0 - st.X0, ty0 - st.Y0
    sizes = [_csiz(p) for p in st.precision]
    dtypes = {1: "<u1", 2: "<u2", 4: "<u4"}
    buf = np.concatenate([(s.astype(np.int64) % (1 << (8 * z))).ravel()
                          .astype(dtypes[z]).view(np.uint8)
                          for s, z in zip(samples, sizes)])

    def plane(n: int, start: int, stride: int, dx: int, dy: int, bits=8):
        """Component n's (h, w) samples from byte `start`, rows `stride`
        words, each sample replicated dx x dy times, shifted to `bits`."""
        z = sizes[n]
        idx = (np.arange(h) // dy)[:, None] * stride + \
            (np.arange(w) // dx)[None, :]
        need = (int(idx.max()) + 1) * z
        raw = buf[start:start + need]
        if len(raw) < need:             # Pillow would read past the buffer
            raw = np.concatenate([raw, np.zeros(need - len(raw), np.uint8)])
        words = raw.view(dtypes[z]).astype(np.int64)[idx]
        return _to_bits(words, st.precision[n], st.signed[n], bits)

    out = img[y0:y0 + h, x0:x0 + w]
    if kind == "i16":
        out[..., 0] = plane(0, 0, w, 1, 1, 16)
    elif kind == "l":
        out[..., :3] = plane(0, 0, w, 1, 1)[..., None]
        out[..., 3] = 255
    elif kind == "la":
        v = plane(0, 0, w, 1, 1)
        out[...] = np.stack([v, v, v, plane(1, sizes[0] * w * h, w, 1, 1)],
                            -1)
    else:
        planes, at = [], 0
        for n in range(4 if kind == "rgba" else 3):
            dx, dy = st.dx[n], st.dy[n]
            planes.append(plane(n, at, w // dx, dx, dy))
            at += sizes[n] * (w // dx) * (h // dy)
        px = np.stack(planes, -1).astype(np.uint8)
        if sycc:
            px[..., :3] = ycbcr_to_rgb(px[..., :3])
        out[..., :len(planes)] = px
        if len(planes) == 3:
            out[..., 3] = 255


# (Pillow's mode, colour space, components) -> (the unpacker, whether it
# takes sub-sampled components): the rows of Jpeg2KDecode.c's
# j2k_unpackers
_UNPACKERS = {
    ("L", "GRAY", 1): ("l", False), ("P", "SRGB", 1): ("l", False),
    ("PA", "SRGB", 2): ("la", False), ("I;16", "GRAY", 1): ("i16", False),
    ("LA", "GRAY", 2): ("la", False), ("RGB", "GRAY", 1): ("l", False),
    ("RGB", "GRAY", 2): ("l", False), ("RGB", "SRGB", 3): ("rgb", True),
    ("RGB", "SYCC", 3): ("rgb", True), ("RGB", "SRGB", 4): ("rgb", True),
    ("RGB", "SYCC", 4): ("rgb", True), ("RGBA", "GRAY", 1): ("l", False),
    ("RGBA", "GRAY", 2): ("la", False), ("RGBA", "SRGB", 3): ("rgb", True),
    ("RGBA", "SYCC", 3): ("rgb", True), ("RGBA", "SRGB", 4): ("rgba", True),
    ("RGBA", "SYCC", 4): ("rgba", True), ("CMYK", "CMYK", 4): ("rgba", True)}
_SPACES = {16: "SRGB", 17: "GRAY", 18: "SYCC", 24: "EYCC", 12: "CMYK"}


def _jp2_codestream(blob: bytes, path: str) -> Tuple[bytes, str]:
    """The codestream (from the jp2c box to the end of the file, as
    OpenJPEG's stream reads it) and the colour space of the first colr
    box: None (unspecified, as in a raw codestream) for an ICC profile or
    an enumeration OpenJPEG does not know."""
    at, space, colr = 12, None, False
    while at + 8 <= len(blob):
        size, typ = struct.unpack(">I4s", blob[at:at + 8])
        head = 8
        if size == 1:
            size, = struct.unpack(">Q", blob[at + 8:at + 16])
            head = 16
        elif size == 0:
            size = len(blob) - at
        if typ == b"jp2c":
            if not colr:
                raise _broken(path, "codestream before the jp2h box")
            return blob[at + head:], space
        if size < head:
            break
        if typ == b"jp2h":
            for t, b in _boxes(blob, at + head, min(at + size, len(blob))):
                if t == b"colr" and not colr and len(b) >= 3:
                    colr = True
                    if b[0] == 1 and len(b) >= 7:
                        space = _SPACES.get(struct.unpack(">I", b[3:7])[0])
            if not colr:
                raise _broken(path, "jp2h box without a colr box")
        at += size
    raise _broken(path, "no jp2c box")


def _canvas(blob: bytes, path: str):
    """(mode, height, width, palette, codestream, colour space)."""
    if blob[:4] == b"\xff\x4f\xff\x51":
        mode, h, w = jpeg2000_header(blob, path)
        return mode, h, w, None, blob, None
    if blob[:12] != JP2_SIGNATURE:
        raise ValueError(f"{path}: not a JPEG 2000 file")
    mode, h, w, palette = _jp2_header(blob, path)
    cs, space = _jp2_codestream(blob, path)
    return mode, h, w, palette, cs, space


def decode_jpeg2000_raw(blob: bytes, path: str = "<JPEG 2000 bytes>"
                        ) -> Tuple[str, np.ndarray, Optional[np.ndarray]]:
    """(Pillow's mode, its (H, W, 4) uint8 or (H, W, 1) uint16 pixels as
    Pillow holds them, the palette or None)."""
    mode, h, w, palette, cs, space = _canvas(blob, path)
    st = _Stream(cs, path)
    if (st.Y1 - st.Y0, st.X1 - st.X0) != (h, w):
        raise _broken(path, "the JP2 header's size is not the codestream's")
    if space is None:          # unspecified: by the components
        if st.nc <= 2:
            space = "GRAY"
        elif st.dx[0] == st.dy[0] == 1 and any(
                st.dx[n] != 1 or st.dy[n] != 1 for n in (1, 2)):
            space = "SYCC"
        else:
            space = "SRGB"
    if st.nc > 4:
        raise _broken(path, f"{st.nc} components")
    sub = any(st.dx[n] != 1 or st.dy[n] != 1 for n in range(1, st.nc))
    kind, takes_sub = _UNPACKERS.get((mode, space, st.nc), (None, False))
    if kind is None or (sub and not takes_sub):
        raise _broken(path, f"no unpacker for mode {mode}, {st.nc} "
                      f"components in colour space {space}")
    img = np.zeros((h, w, 1 if mode == "I;16" else 4),
                   np.uint16 if mode == "I;16" else np.uint8)
    for t in st.order:
        tile, samples = _decode_tile(st, t)
        _unpack(st, kind, space == "SYCC", tile, samples, img)
    return mode, img, palette


def decode_jpeg2000(blob: bytes, path: str = "<JPEG 2000 bytes>"
                    ) -> np.ndarray:
    """(H, W, 3) uint8 RGB as Pillow's convert("RGB") gives it."""
    mode, img, palette = decode_jpeg2000_raw(blob, path)
    if mode == "I;16":
        return _grey(np.minimum(img[..., 0], 255))
    if mode in ("L", "LA"):
        return _grey(img[..., 0])
    if mode in ("P", "PA"):
        return _lut(palette[:, :3] if palette is not None else
                    np.zeros((0, 3), np.uint8))[img[..., 0]]
    if mode == "CMYK":
        return _cmyk(img)
    return np.ascontiguousarray(img[..., :3])
