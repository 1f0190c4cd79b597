"""AVIF stills and image sequences: the ISO base media file format
container around AV1 frames, read and checked as Pillow's AVIF plugin
has libavif 1.3.0 read it, then decoded by data/av1_*.py and converted
to RGB by data/avif_yuv.py.

The top-level boxes are read until those ftyp's brands ask for are
(`meta` for avif, `moov` for avis; a sequence may have no meta box). A
file whose major brand is avis, or is not avif and that has a `moov`
box, is read from its tracks (data/avif_moov.py): the colour track's
first sample decoded and scaled to `tkhd`'s size, its colour
description from the sample entry's `colr` nclx box, else the sequence
header's; an alpha track's first sample likewise (one of another size
or depth fails the file), divided out where the colour track's `prem`
names it. Any other file is read from its primary item:

`ftyp`; `meta` with `hdlr` (pict), `pitm`, `iinf` (`infe`
versions 2 and 3), `iloc` (versions 0-2, construction methods 0 and 1,
the latter from `idat`, several extents), `iprp` / `ipco` / `ipma`
(`ispe`, `av1C`, `pixi`, `colr` nclx or ICC, `auxC`, `irot`, `imir`,
`clap`, `a1op`, `lsel`) and `iref` (`auxl`, `prem`, `dimg`). The primary
item's OBUs are decoded, each frame scaled to its item's `ispe` where it
is another size (data/avif_scale.py); a `grid` primary item's cells (its
`dimg` references, in their order) are decoded, checked, laid side by
side and cropped to its ImageGrid output before one conversion, with
the grid's colour description, else its first cell's sequence header's;
Pillow reads libavif's buffer by `ispe`, so a grid whose output is
another size comes out re-strided (`_as_opened`). `irot` / `imir` /
`clap` are not applied (Pillow
turns orientation into EXIF, which the loader ignores). An alpha item is
decoded as libavif decodes it for Pillow's RGBA (a damaged one fails the
file); convert("RGB") drops it, unless the file marks it premultiplied
(`prem`): then libavif converts YUV to RGB and divides the colour by the
alpha plane through libyuv's ARGBUnattenuate (`unpremultiply`), whose
result convert("RGB") keeps. Frames of 10 and 12 bits are decoded,
scaled and assembled at their depth (uint16 planes) and converted to
Pillow's 8-bit RGB by data/avif_yuv.py, their alpha brought to 8 bits as
libavif brings it (`avif_yuv.alpha_8bit`); an alpha item of another depth
than the colour's fails the file, as it fails libavif.
"""
from __future__ import annotations

import struct
from types import SimpleNamespace
from typing import Tuple

import numpy as np

from . import av1_block, av1_obu, avif_moov, avif_scale, avif_yuv

_ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha",
               b"urn:mpeg:hevc:2015:auxid:1")


def _refuse(path: str, what: str) -> ValueError:
    return ValueError(f"{path}: AVIF: {what} (libavif refuses it, and so "
                      "does Pillow)")


class _Stream:
    """libavif's bounds-checked reads (avifROStream) over one box."""

    def __init__(self, b: bytes, path: str, what: str):
        self.b, self.at, self.path, self.what = b, 0, path, what

    def read(self, n: int) -> bytes:
        if self.at + n > len(self.b):
            raise _refuse(self.path, f"Box[{self.what}] is cut short")
        self.at += n
        return self.b[self.at - n:self.at]

    def uint(self, n: int) -> int:
        return int.from_bytes(self.read(n), "big")

    def version(self, allowed) -> int:
        v = self.uint(1)
        self.read(3)
        if v not in allowed:
            raise _refuse(self.path, f"Box[{self.what}] has version {v}")
        return v

    def string(self):
        end = self.b.find(b"\0", self.at)
        if end < 0:
            raise _refuse(self.path, f"Box[{self.what}] has a string "
                                     "without its terminating zero")
        self.at = end + 1

    def left(self) -> int:
        return len(self.b) - self.at

    def header(self):
        """A child box's type and body size, checked to fit (a child box
        of size 0 is refused, as avifROStreamReadBoxHeader refuses it);
        the stream is left at its body."""
        head = self.left()
        size, typ = self.uint(4), self.read(4)
        if size == 1:
            size = self.uint(8) - 16
        elif size == 0:
            raise _refuse(self.path, f"Box[{self.what}]: Non-top-level box "
                                     "with size 0")
        else:
            size -= 8
        if typ == b"uuid":
            self.read(16)
            size -= 16
        if size < 0 or size > self.left():
            raise _refuse(self.path, f"Box[{typ.decode('latin-1')}] is "
                                     f"larger than what holds it "
                                     f"({head} bytes)")
        return typ, size

    def boxes(self):
        """The child boxes to the end, each one checked to fit."""
        while self.left():
            typ, size = self.header()
            yield typ, self.read(size)


_SUPPORTED = (b"ispe", b"auxC", b"colr", b"av1C", b"pasp", b"clap", b"irot",
              b"imir", b"pixi", b"a1op", b"lsel", b"a1lx", b"clli")


def parse(blob: bytes, path: str) -> SimpleNamespace:
    """The file's boxes read and checked as libavif's avifParse /
    avifDecoderParse / avifDecoderReset read them (Pillow's Image.open):
    the top-level boxes until every box ftyp's brands ask for is read
    (`meta` for avif, `moov` for avis), then the source libavif takes by
    AVIF_DECODER_SOURCE_AUTO: the tracks where the major brand is avis,
    or is not avif and the file has a track (`m.source` "tracks",
    `m.seq` from data/avif_moov.py), else the primary item with its
    properties and references. Boxes that do not fit, versions libavif
    does not know, misordered or repeated entries and bad indices are
    refused."""
    m = SimpleNamespace(primary=None, props=[], items={}, refs=[],
                        idat=None, ftyp=None, tracks=None, source="item")
    seen = set()
    at = 0
    while at < len(blob):
        head, left = 8, len(blob) - at
        if left < 8:
            raise _refuse(path, "a top-level box header is cut short")
        size, typ = struct.unpack(">I4s", blob[at:at + 8])
        if size == 1:
            if left < 16:
                raise _refuse(path, "a top-level box header is cut short")
            size, = struct.unpack(">Q", blob[at + 8:at + 16])
            head = 16
        if typ == b"uuid":
            head += 16
        key = typ in (b"ftyp", b"meta", b"moov")
        name = typ.decode("latin-1")
        if size == 0:
            if not key:
                raise _refuse(path, f"Box[{name}] has size 0 before the "
                                    "boxes its brands ask for")
            size = left
        elif size < head:
            raise _refuse(path, "File-level box header: Header size "
                                "overflow check failure")
        elif key and size > left:
            raise _refuse(path, f"Box[{name}] runs past the end of the file")
        body = blob[at + head:at + size]
        at += size
        if not seen and typ != b"ftyp":
            raise _refuse(path, "the first box is not ftyp")
        if key and typ in seen:
            raise _refuse(path, f"a second {name} box")
        seen.add(typ)
        if typ == b"ftyp":
            if len(body) < 8 or len(body) % 4:
                raise _refuse(path, "Box[ftyp] has a broken size")
            m.ftyp = [body[i:i + 4] for i in range(0, len(body), 4)
                      if i != 4]
            if b"avif" not in m.ftyp and b"avis" not in m.ftyp:
                raise _refuse(path, "its ftyp box names neither avif nor "
                                    "avis")
        elif typ == b"meta":
            _meta(_Stream(body, path, "meta"), m, path)
        elif typ == b"moov":
            m.tracks = avif_moov.parse_moov(body, path)
        # avifParse stops once it has read what the brands ask for
        if all(t in seen for b, t in ((b"avif", b"meta"), (b"avis", b"moov"))
               if b in m.ftyp):
            break
    else:
        if at > len(blob):
            raise _refuse(path, "a box runs past the end of the file")
    if m.ftyp is None:
        raise _refuse(path, "the file does not start with an ftyp box")
    if b"avif" in m.ftyp and b"meta" not in seen or \
            b"avis" in m.ftyp and b"moov" not in seen:
        raise _refuse(path, "a meta box (brand avif) or a moov box (brand "
                            "avis) is missing (Truncated data)")
    if b"tmap" in m.ftyp and not any(it.type == b"tmap"
                                     for it in m.items.values()):
        raise _refuse(path, "its ftyp box names tmap and it has no tmap "
                            "item")
    # avifDecoderParse: every item libavif does not skip (alpha items too)
    # has an ispe within libavif's limits, whichever source it then takes
    for k in m.items:
        if _skipped(m, k):
            continue
        ispe = _prop(m, k, b"ispe")
        if ispe is None:
            raise _refuse(path, f"item {k} has no ispe property")
        w, h = struct.unpack(">II", ispe[4:12])
        if not w or not h:
            raise _refuse(path, f"Item ID [{k}] has an invalid size "
                                f"[{w}x{h}]")
        if w > avif_moov.DIMENSION_LIMIT or h > avif_moov.DIMENSION_LIMIT \
                or w * h > avif_moov.SIZE_LIMIT:
            raise _refuse(path, f"Item ID [{k}] dimensions are too large "
                                f"[{w}x{h}]")
    major = m.ftyp[0]
    if major == b"avis" or major != b"avif" and m.tracks:
        m.source = "tracks"
        m.seq = avif_moov.select(m.tracks or [], len(blob), path)
        return m
    item = m.items.get(m.primary)
    if m.primary is None or item is None or item.type is None or \
            _skipped(m, m.primary) and not item.unsupported:
        raise _refuse(path, "it has no primary item")
    if item.unsupported:
        raise _refuse(path, "the primary item has an essential property or "
                            "a construction method libavif does not know")
    if item.type in (b"av01", b"grid"):
        for typ in (b"av1C", b"ispe") if item.type == b"av01" else (
                b"ispe",):
            if _prop(m, m.primary, typ) is None:
                raise _refuse(path, "the primary item has no "
                                    f"{typ.decode()} property")
    # avifReadColorProperties: one nclx and one ICC profile at most
    kinds = [b[:4] for t, b in item.props if t == b"colr"]
    if kinds.count(b"nclx") > 1 or sum(kinds.count(k) for k in (
            b"prof", b"rICC")) > 1:
        raise _refuse(path, "the primary item has two colr boxes of a kind")
    # avifDecoderReset: the colour grid, the alpha (a grid of the cells'
    # own alpha items where the colour grid has none), the alpha grid,
    # then each image's configuration and depths
    m.grids = {}
    if item.type == b"grid":
        m.grids[m.primary] = _grid(blob, m, m.primary, path)
    m.alpha = _alpha_of(m, m.primary)
    if m.alpha is None and item.type == b"grid":
        m.alpha = _cell_alphas(m, path)
    elif m.alpha is not None and m.items[m.alpha].type == b"grid":
        m.grids[m.alpha] = _grid(blob, m, m.alpha, path)
    for it in (m.primary, m.alpha):
        if it is not None:
            _check_depths(m, it, path)
    return m


def _check_depths(m: SimpleNamespace, item: int, path: str):
    """avifDecoderItemValidateProperties: each pixi depth is av1C's (a
    grid's: its first cell's)."""
    grid = m.grids.get(item)
    av1c = _prop(m, grid.cells[0] if grid else item, b"av1C")
    pixi = _prop(m, item, b"pixi")
    if av1c is None:
        raise _refuse(path, f"item {item} has no av1C property")
    b = av1c[2]             # twelve_bit first, as libavif reads it
    depth = 12 if b & 0x20 else 10 if b & 0x40 else 8
    if pixi is not None and any(d != depth for d in pixi[5:5 + pixi[4]]):
        raise _refuse(path, f"item {item}'s pixi depths are not its av1C "
                            f"depth {depth}")


def _meta(st: _Stream, m: SimpleNamespace, path: str):
    st.version((0,))
    first, seen = True, set()
    for typ, body in st.boxes():
        if first and typ != b"hdlr":
            raise _refuse(path, "Box[meta] does not start with Box[hdlr]")
        first = False
        if typ in (b"hdlr", b"iloc", b"pitm", b"idat", b"iprp", b"iinf",
                   b"iref"):
            if typ in seen:
                raise _refuse(path, f"Box[meta] has two Box[{typ.decode()}]")
            seen.add(typ)
        sub = _Stream(body, path, typ.decode("latin-1"))
        if typ == b"hdlr":
            sub.version((0,))
            if sub.uint(4):
                raise _refuse(path, "Box[hdlr] has a nonzero pre_defined")
            if sub.read(4) != b"pict":
                raise _refuse(path, "Box[hdlr]'s handler is not pict")
            sub.read(12)
            sub.string()
        elif typ == b"pitm":
            m.primary = sub.uint(2 if sub.version((0, 1)) == 0 else 4)
        elif typ == b"iinf":
            n = sub.uint(2 if sub.version((0, 1)) == 0 else 4)
            kids = sub.boxes()
            for _ in range(n):
                t2, b2 = next(kids, (None, None))
                if t2 != b"infe":
                    raise _refuse(path, "Box[iinf] holds something other "
                                        "than its Box[infe] entries")
                _infe(_Stream(b2, path, "infe"), m, path)
        elif typ == b"iloc":
            _iloc(sub, m, path)
        elif typ == b"idat":
            m.idat = body
        elif typ == b"iprp":
            _iprp(sub, m, path)
        elif typ == b"iref":
            # libavif reads each reference on from the iref box's own
            # stream, whatever its box's size says, and skips an iref of a
            # version it does not know
            v = sub.uint(1)
            sub.read(3)
            step = 4 if v else 2
            while v in (0, 1) and sub.left():
                t2, _ = sub.header()
                src, cnt = sub.uint(step), sub.uint(2)
                if t2 == b"dimg" and any(t == t2 and s == src
                                         for t, s, _ in m.refs):
                    raise _refuse(path, "Box[iref] has two dimg boxes from "
                                        f"item {src}")
                dst = [sub.uint(step) for _ in range(cnt)]
                if not src or 0 in dst:
                    raise _refuse(path, "Box[iref] names item 0")
                m.refs.append((t2, src, dst))
    if first:
        raise _refuse(path, "Box[meta] is empty")


def _item(m: SimpleNamespace, item: int, path: str) -> SimpleNamespace:
    if item == 0:
        raise _refuse(path, "an item has ID 0")
    if item not in m.items:
        m.items[item] = SimpleNamespace(type=None, props=[], method=0,
                                        extents=None, unsupported=False,
                                        ipma=False)
    return m.items[item]


def _infe(st: _Stream, m: SimpleNamespace, path: str):
    v = st.version((2, 3))
    it = _item(m, st.uint(2 if v == 2 else 4), path)
    st.uint(2)                                   # protection index
    typ = st.read(4)
    st.string()                                  # item_name
    if typ == b"mime":
        st.string()
    if it.type is not None:
        raise _refuse(path, "an item has two Box[infe]")
    it.type = typ


def _iloc(st: _Stream, m: SimpleNamespace, path: str):
    v = st.version((0, 1, 2))
    b = st.uint(1)
    osz, lsz = b >> 4, b & 15
    b = st.uint(1)
    bsz, isz = b >> 4, (b & 15) if v in (1, 2) else 0
    if any(n not in (0, 4, 8) for n in (osz, lsz, bsz, isz)):
        raise _refuse(path, "Box[iloc] has a field size other than 0, 4 "
                            "or 8")
    for _ in range(st.uint(2 if v < 2 else 4)):
        it = _item(m, st.uint(2 if v < 2 else 4), path)
        if it.extents is not None:
            raise _refuse(path, "an item has two sets of extents")
        if v in (1, 2):
            x = st.uint(2)
            if x >> 4:
                raise _refuse(path, "Box[iloc] has a nonzero reserved field")
            it.method = x
            if it.method not in (0, 1):
                it.unsupported = True
        st.uint(2)                                   # data_reference_index
        base = st.uint(bsz)
        it.extents = []
        for _ in range(st.uint(2)):
            st.uint(isz)
            off, ln = st.uint(osz), st.uint(lsz)
            it.extents.append((base + off, ln))


def _iprp(st: _Stream, m: SimpleNamespace, path: str):
    kids = st.boxes()
    t, body = next(kids, (None, None))
    if t != b"ipco":
        raise _refuse(path, "Box[iprp] does not start with Box[ipco]")
    m.props = [_property(t2, b2, path)
               for t2, b2 in _Stream(body, path, "ipco").boxes()]
    for t, body in kids:
        if t == b"ipma":
            _ipma(_Stream(body, path, "ipma"), m, path)


def _property(typ: bytes, body: bytes, path: str, track: bool = False):
    """A property box checked as libavif's
    avifParseItemPropertyContainerBox checks it; in a track's sample
    entry (`track`) `auxi` is read as `auxC` is."""
    kind = b"auxC" if track and typ == b"auxi" else typ
    st = _Stream(body, path, kind.decode("latin-1"))
    if kind in (b"ispe", b"pixi", b"auxC"):
        st.version((0,))
    if kind == b"ispe":
        st.read(8)
    elif kind == b"pixi":
        n = st.uint(1)
        if not 1 <= n <= 4:
            raise _refuse(path, f"Box[pixi] has {n} channels")
        if len(set(st.read(n))) > 1:
            raise _refuse(path, "Box[pixi] has channels of different depths")
    elif kind == b"auxC":
        st.string()
    elif typ == b"av1C":
        if st.read(4)[0] != 0x81:
            raise _refuse(path, "Box[av1C] has a bad marker or version")
    elif typ == b"colr":
        kind = st.read(4)
        if kind == b"nclx" and st.read(7)[6] & 0x7F:
            raise _refuse(path, "Box[colr] has nonzero reserved bits")
    elif typ in (b"irot", b"imir"):
        if st.uint(1) & 0xFC if typ == b"irot" else 0:
            raise _refuse(path, "Box[irot] has reserved bits set")
    return typ, body


def _ipma(st: _Stream, m: SimpleNamespace, path: str):
    v = st.uint(1)
    flags = st.uint(3)
    prev = 0
    for _ in range(st.uint(4)):
        item = st.uint(2 if v < 1 else 4)
        if item <= prev:
            raise _refuse(path, "Box[ipma]'s item IDs do not increase")
        prev = item
        it = _item(m, item, path)
        if it.ipma:
            raise _refuse(path, "an item has two Box[ipma] entries")
        it.ipma = True
        for _ in range(st.uint(1)):
            x = st.uint(2 if flags & 1 else 1)
            essential = x >> (15 if flags & 1 else 7)
            idx = x & (0x7FFF if flags & 1 else 0x7F)
            if idx == 0:
                continue
            if idx > len(m.props):
                raise _refuse(path, f"Box[ipma] names property {idx} of "
                                    f"{len(m.props)}")
            typ = m.props[idx - 1][0]
            if typ in _SUPPORTED:
                if essential and typ == b"a1lx" or not essential and \
                        typ in (b"a1op", b"lsel"):
                    raise _refuse(path, f"property {typ.decode()} is marked "
                                        "essential against the rules")
                it.props.append(m.props[idx - 1])
            elif essential:
                it.unsupported = True


def _prop(m: SimpleNamespace, item: int, typ: bytes, nclx=None):
    it = m.items.get(item)
    for t, body in it.props if it else ():
        if t == typ and (nclx is None or body[:4] == nclx):
            return body
    return None


def _skipped(m: SimpleNamespace, item: int) -> bool:
    """libavif's avifDecoderItemShouldBeSkipped: no data, an essential
    property it does not know, a type it cannot decode, a thumbnail."""
    it = m.items.get(item)
    return it is None or not it.extents or not sum(
        ln for _, ln in it.extents) or it.unsupported or it.type not in (
            b"av01", b"grid") or _target(m, b"thmb", item) is not None


def _target(m: SimpleNamespace, typ: bytes, src: int):
    """The item a reference of type `typ` from `src` names, as libavif
    keeps it: one per item and type, the last its iref boxes list."""
    out = None
    for t, s, d in m.refs:
        if t == typ and s == src and d:
            out = d[-1]
    return out


def _alpha_of(m: SimpleNamespace, item: int):
    """The item's alpha, as libavif finds it: the first item (in its
    order) whose auxl names this one and whose auxC names alpha, skipping
    the items libavif skips."""
    for src in m.items:
        if _is_alpha(m, src, item) and not _skipped(m, src):
            return src
    return None


def _is_alpha(m: SimpleNamespace, item: int, of: int) -> bool:
    return _target(m, b"auxl", item) == of and (
        _prop(m, item, b"auxC") or b"")[4:].startswith(_ALPHA_URNS)


def _cell_alphas(m: SimpleNamespace, path: str):
    """libavif's avifMetaFindAlphaItem for a colour grid with no alpha
    item: where each cell (in the items' order) has one alpha item of its
    own, an alpha grid of those made up under a new item ID, the colour
    grid's shape; None where a cell has none; refused where a cell has two
    or its alpha is itself some grid's cell."""
    grid = m.grids[m.primary]
    cells = [k for k in m.items if k in grid.cells]
    in_grids = {x for t, _, d in m.refs if t == b"dimg" for x in d}
    alphas = []
    for c in cells:
        own = [a for a in m.items if _is_alpha(m, a, c)]
        if len(own) > 1 or own and own[0] in in_grids:
            raise _refuse(path, f"its grid's cell {c} has two alpha items, "
                                "or its alpha is a grid's cell")
        if not own:
            return None
        alphas += own
    # libavif's first ID past every item, iref's too
    made = max([*m.items] + [x for _, s, d in m.refs for x in (s, *d)]) + 1
    m.grids[made] = SimpleNamespace(rows=grid.rows, cols=grid.cols,
                                    w=grid.w, h=grid.h, cells=alphas)
    return made


def avif_header(blob: bytes, path: str) -> Tuple[str, int, int]:
    """libavif's size and Pillow's mode of an AVIF file: the primary
    item's ispe, "RGBA" where an auxiliary alpha item refers to it (or,
    for a grid, to each of its cells); a sequence's colour track's tkhd
    size, "RGBA" where it has an alpha track."""
    m = parse(blob, path)
    if m.source == "tracks":
        w, h, alpha = m.seq.colour.width, m.seq.colour.height, m.seq.alpha
    else:
        w, h = struct.unpack(">II", _prop(m, m.primary, b"ispe")[4:12])
        alpha = m.alpha
    _check_pixels(w, h, path)
    return ("RGBA" if alpha is not None else "RGB"), h, w


def _inverse_alpha() -> np.ndarray:
    """libyuv's fixed_invtbl8: 65536 / a in 8.8 fixed point (0 for 0,
    0xFFFF for 1, 0x100 for 255)."""
    t = np.array([0, 0xFFFF] + [0x10000 // a for a in range(2, 255)] +
                 [0x100], np.int64)
    return t


_INV_ALPHA = _inverse_alpha()


def unpremultiply(rgb: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    """libyuv's ARGBUnattenuate (libavif's avifRGBImageUnpremultiplyAlpha
    of 8-bit RGBA): each colour c of a pixel with alpha a becomes
    (c * 257 * inv[a]) >> 16 clamped to 0..255, the product a signed
    32-bit one (at alpha 1, colours from 128 wrap negative and give 0)."""
    ia = _INV_ALPHA[alpha.astype(np.int64)][..., None]
    p = rgb.astype(np.int64) * 257 * ia
    p = np.where(p >= 1 << 31, p - (1 << 32), p)
    return np.clip(p >> 16, 0, 255).astype(np.uint8)


def _item_bytes(blob: bytes, m: SimpleNamespace, item: int, path: str):
    it = m.items[item]
    if not it.extents:
        raise _refuse(path, f"item {item} has no data")
    src = blob if it.method == 0 else m.idat
    if src is None:
        raise _refuse(path, f"item {item} is in a missing Box[idat]")
    out = bytearray()
    for off, ln in it.extents:
        if off + ln > len(src):
            raise _refuse(path, f"item {item} runs past the file")
        out += src[off:off + ln]
    return bytes(out)


def _grid(blob: bytes, m: SimpleNamespace, item: int, path: str):
    """A grid item's ImageGrid payload and cells, checked as libavif's
    avifParseImageGridBox, avifDecoderItemReadAndParse,
    avifDecoderGenerateImageGridTiles and avifDecoderItemValidateProperties
    check them when Pillow opens the file."""
    st = _Stream(_item_bytes(blob, m, item, path), path, "grid")
    if st.uint(1):
        raise _refuse(path, "Box[grid] has a version other than 0")
    wide = st.uint(1) & 1
    rows, cols = st.uint(1) + 1, st.uint(1) + 1
    w, h = st.uint(4 if wide else 2), st.uint(4 if wide else 2)
    if not w or not h:
        raise _refuse(path, f"its grid is {w} x {h}")
    if w > 32768 or h > 32768 or w * h > 16384 * 16384:
        raise _refuse(path, f"its grid of {w} x {h} is past libavif's "
                            "limits")
    if st.left():
        raise _refuse(path, "Box[grid] has bytes past its fields")
    # the dimg reference of each item, the last one where several name it
    dimg = {}
    for typ, src, dst in m.refs:
        if typ == b"dimg":
            for k, x in enumerate(dst):
                dimg[x] = (src, k)
    cells = sorted((k, x) for x, (src, k) in dimg.items() if src == item)
    n = rows * cols
    if len(cells) != n or any(k >= n for k, _ in cells):
        raise _refuse(path, f"its grid of {rows} x {cols} cells names "
                            f"{len(cells)} of them")
    cells = [x for _, x in cells]
    its = [m.items.get(x) for x in cells]
    if not any(it is not None and it.type == b"av01" for it in its):
        raise _refuse(path, "its grid has no AV1 cell")
    for x, it in zip(cells, its):
        if it is None or it.type != b"av01":
            raise _refuse(path, f"its grid's cell {x} is not an AV1 item")
        if it.unsupported:
            raise _refuse(path, f"its grid's cell {x} has an essential "
                                "property libavif does not know")
    first = _prop(m, cells[0], b"av1C")
    if first is None:
        raise _refuse(path, "its grid's first cell has no av1C property")
    for x in cells:
        av1c = _prop(m, x, b"av1C")
        if av1c is None or av1c[1:3] != first[1:3]:
            raise _refuse(path, f"its grid's cell {x} has another av1C "
                                "than the first")
    return SimpleNamespace(rows=rows, cols=cols, w=w, h=h, cells=cells)


def _planes(blob: bytes, m: SimpleNamespace, item: int, path: str,
            alpha: bool = False, ctx: SimpleNamespace = None):
    """(planes, sequence headers) of an AV1 or grid item as libavif gives
    them: an AV1 frame scaled to its ispe (avifImageScale); a grid's cells
    so scaled, then `assemble`d; a header for each cell. `ctx`, where the
    cells share one dav1d context (`av1_obu.context`), holds what that
    context kept from the data sent before: the sequence header (a cell
    without one decodes with it) and the reference slots (a cell may
    show a frame an earlier cell left there)."""
    grid = m.grids.get(item)
    if grid is None:
        w, h = struct.unpack(">II", _prop(m, item, b"ispe")[4:12])
        planes, seq = _decode_item(blob, m, item, path, ctx)
        return _scaled(planes, seq, w, h, path), [seq]
    cells = []
    for x in grid.cells:
        planes, (seq,) = _planes(blob, m, x, path, ctx=ctx)
        cells.append((planes, seq))
    return assemble(grid, cells, path, alpha), [q for _, q in cells]


def _scaled(planes, seq: SimpleNamespace, w: int, h: int, path: str):
    """A decoded frame's planes scaled to the w x h its item's ispe or
    its track's tkhd gives (avifImageScaleWithLimit, with its and
    ScalePlane's limits)."""
    if planes[0].shape == (h, w):
        return planes
    if not w or not h or w > 32768 or h > 32768 or \
            w * h > 16384 * 16384 or max(planes[0].shape) > 16384:
        raise _refuse(path, f"its AV1 frame cannot be scaled to {w} x {h}")
    return avif_scale.scale_planes(planes, seq.ssx, seq.ssy, w, h,
                                   seq.bit_depth)


def assemble(grid: SimpleNamespace, cells, path: str, alpha: bool = False):
    """A grid's frame from its cells' (planes, sequence header), as
    libavif's avifDecoderDataFillImageGrid: the cells checked to match
    (size, depth, layout; a colour grid's range and colour description
    too), to be 64 or more and even where chroma is subsampled, and to
    cover the output without a spare row or column; laid side by side and
    cropped to the output size."""
    seq = cells[0][1]

    def key(planes, s):
        k = (planes[0].shape, s.bit_depth)
        return k if alpha else k + (s.mono, s.ssx, s.ssy, s.full_range,
                                    s.cp, s.tc, s.mc)
    if any(key(*c) != key(*cells[0]) for c in cells):
        raise _refuse(path, "its grid's cells do not match (size, format, "
                            "range or colour description)")
    ch, cw = cells[0][0][0].shape
    if cw * grid.cols < grid.w or ch * grid.rows < grid.h:
        raise _refuse(path, "its grid's cells do not cover its output")
    if cw * (grid.cols - 1) >= grid.w or ch * (grid.rows - 1) >= grid.h:
        raise _refuse(path, "its grid's last row or column of cells lies "
                            "outside its output")
    ssx = 0 if alpha or seq.mono else seq.ssx
    ssy = 0 if alpha or seq.mono else seq.ssy
    if cw < 64 or ch < 64 or ssx and (grid.w | cw) & 1 or \
            ssy and (grid.h | ch) & 1:
        raise _refuse(path, f"its grid's cells of {cw} x {ch} are below 64 "
                            "or not even where chroma is subsampled")
    out = []
    for p in range(len(cells[0][0])):
        sx, sy = (ssx, ssy) if p else (0, 0)
        whole = np.block([[cells[r * grid.cols + c][0][p]
                           for c in range(grid.cols)]
                          for r in range(grid.rows)])
        out.append(whole[:(grid.h + sy) >> sy, :(grid.w + sx) >> sx])
    return out


def decode_avif(blob: bytes, path: str) -> np.ndarray:
    """(H, W, 3) uint8: Pillow's Image.open(path).convert("RGB"), the
    first frame of a sequence read from its track."""
    m = parse(blob, path)
    if m.source == "tracks":
        return _decode_track(blob, m.seq, path)
    item = m.primary
    typ = m.items[item].type
    if typ not in (b"av01", b"grid"):
        raise _refuse(path, f"the primary item has type {typ!r}")
    w, h = struct.unpack(">II", _prop(m, item, b"ispe")[4:12])
    _check_pixels(w, h, path)
    alpha = m.alpha
    # avifTilesCanBeDecodedWithSameCodecInstance: one dav1d context for
    # every cell unless the colour or the alpha is a single item and the
    # other is there too
    counts = [len(m.grids[i].cells) if i in m.grids else 1
              for i in (item, alpha) if i is not None]
    ctx = av1_obu.context() if len(counts) == 1 or 1 not in counts \
        else None
    planes, seqs = _planes(blob, m, item, path, ctx=ctx)
    seq = seqs[0]
    a, prem = None, False
    if alpha is not None:
        # libavif decodes the alpha item whatever its use (a damaged one
        # fails the file); convert("RGB") keeps only a premultiplied
        # image's division by it
        a, aseqs = _planes(blob, m, alpha, path, alpha=True, ctx=ctx)
        a = a[0]
        if a.shape != planes[0].shape:
            raise _refuse(path, "its alpha plane is not the size of its "
                                "colour planes")
        if aseqs[0].bit_depth != seq.bit_depth:
            # libavif fails the alpha plane ("Decoding of alpha plane
            # failed" in Pillow)
            raise _refuse(path, f"its alpha item's depth of "
                                f"{aseqs[0].bit_depth} bits is not its "
                                f"colour's {seq.bit_depth}")
        prem = _target(m, b"prem", item) == alpha
    rgb = _rgb(planes, seq, colour(m, item, seq), a, prem, path)
    return _as_opened(rgb, w, h, path)


def _decode_track(blob: bytes, s: SimpleNamespace, path: str) -> np.ndarray:
    """The first sample of the colour track (and of its alpha track),
    decoded, scaled to each track's tkhd size and converted as for an
    item, with the colour description of the sample entry's colr nclx
    box, else the sequence header's."""
    c = s.colour
    _check_pixels(c.width, c.height, path)
    planes, seq = _decode_sample(blob, c, s.first, path)
    a = None
    if s.alpha is not None:
        a, aseq = _decode_sample(blob, s.alpha, s.alpha_first, path)
        a = a[0]
        if a.shape != planes[0].shape or aseq.bit_depth != seq.bit_depth:
            raise _refuse(path, "The color image item does not match the "
                                "alpha image item in width, height, or bit "
                                "depth")
    if not c.timescale:
        raise ValueError(f"{path}: AVIF: its colour track's timescale is 0 "
                         "(Pillow divides the frame's timestamp by it and "
                         "refuses the file: division by zero)")
    nclx = next((b for t, b in s.props if t == b"colr" and
                 b[:4] == b"nclx"), None)
    rgb = _rgb(planes, seq, _nclx_colour(nclx, seq), a, s.premultiplied,
               path)
    return _as_opened(rgb, c.width, c.height, path)


def _decode_sample(blob: bytes, track: SimpleNamespace, sample, path: str):
    off, size = sample
    planes, seq = _decode_data(blob[off:off + size], path)
    return _scaled(planes, seq, track.width, track.height, path), seq


def _rgb(planes, seq: SimpleNamespace, cicp, a, prem: bool,
         path: str) -> np.ndarray:
    """Pillow's RGB(A) pixels of a decoded frame: libavif's conversion at
    the frame's depth with the colour description `cicp` (matrix
    coefficients, full range, colour primaries), the alpha plane `a`
    brought to 8 bits and, where premultiplied, divided out."""
    mc, full_range, cp = cicp
    depth = seq.bit_depth
    rgb = avif_yuv.to_rgb(planes, seq.ssx, seq.ssy, seq.mono, mc,
                          full_range, path, cp, a, prem, depth)
    if a is not None:
        a = avif_yuv.alpha_8bit(a, depth, seq.ssx, seq.ssy, seq.mono, mc, cp,
                                full_range)
        if prem and not avif_yuv.divides_alpha(seq.ssx, seq.ssy, seq.mono,
                                               mc, cp, full_range, depth):
            rgb = unpremultiply(rgb, a)
        rgb = np.dstack([rgb, a])
    return rgb


# Pillow's Image.open refuses images past twice its MAX_IMAGE_PIXELS
_PILLOW_MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)


def _check_pixels(w: int, h: int, path: str):
    if w * h > _PILLOW_MAX_PIXELS:
        raise ValueError(f"{path}: AVIF: its {w} x {h} pixels are past "
                         "Pillow's decompression bomb limit, and Pillow "
                         "refuses it")


def _as_opened(px: np.ndarray, w: int, h: int, path: str) -> np.ndarray:
    """Pillow's pixels of libavif's RGB(A) buffer: Pillow sizes the image
    by ispe and reads the buffer as rows of that width, so a grid whose
    output is another size comes out re-strided, or, where the buffer is
    short, refused."""
    if px.shape[:2] != (h, w):
        n = h * w * px.shape[2]
        if px.size < n:
            raise ValueError(f"{path}: AVIF: its grid's output is smaller "
                             "than its ispe (Pillow refuses it: image file "
                             "is truncated)")
        px = px.reshape(-1)[:n].reshape(h, w, -1)
    return np.ascontiguousarray(px[..., :3])


def colour(m: SimpleNamespace, item: int, seq: SimpleNamespace):
    """(matrix coefficients, full range, colour primaries) as libavif takes
    them: from the item's colr nclx box where it has one (a grid's own,
    not its cells'), else from the sequence header (a grid's first
    cell's)."""
    return _nclx_colour(_prop(m, item, b"colr", b"nclx"), seq)


def _nclx_colour(nclx, seq: SimpleNamespace):
    if nclx is not None and len(nclx) >= 11:
        return (struct.unpack(">H", nclx[8:10])[0], nclx[10] >> 7,
                struct.unpack(">H", nclx[4:6])[0])
    return seq.mc, seq.full_range, seq.cp


def _decode_item(blob: bytes, m: SimpleNamespace, item: int, path: str,
                 ctx: SimpleNamespace = None):
    """(planes, sequence header) of an AV1 item, at its frame's size,
    through the shared dav1d context `ctx` where there is one."""
    return _decode_data(_item_bytes(blob, m, item, path), path, ctx)


def _decode_data(data: bytes, path: str, ctx: SimpleNamespace = None):
    """(planes, sequence header) of the frame one AV1 item's or sample's
    data shows, through the dav1d context `ctx` (`av1_obu.context`; a
    fresh one where None). Every frame dav1d decodes from the data is
    walked, shown or not, since its tile data's checks fail the file as
    they fail dav1d; the frame shown is filtered once (a slot shown
    again keeps its planes) and given its film grain."""
    ctx = ctx or av1_obu.context()
    frames, shown = av1_obu.walk_av1(data, path, ctx)
    try:
        for fr in frames:
            fr.decoder = av1_block.walk_frame(fr.seq, fr.frame, fr.tiles,
                                              fr.data, path)
        if shown.planes is None:
            shown.planes = av1_block.filter_frame(shown.decoder, shown.seq,
                                                  shown.frame)
    except (IndexError, KeyError) as e:
        raise av1_obu.damaged(path, f"its tile data breaks the decoder ("
                                    f"{type(e).__name__})") from None
    for fr in frames:        # a decoder is kept for a slot to filter only
        if fr.planes is not None or all(fr is not r for r in ctx.refs):
            fr.decoder = None
    return av1_block.add_grain(shown.planes, shown.seq, shown.frame), \
        shown.seq
