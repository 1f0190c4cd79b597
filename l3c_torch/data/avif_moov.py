"""The movie box of an AVIF image sequence, read and checked as Pillow's
AVIF plugin has libavif 1.3.0 read it (avifParseMovieBox and the boxes
under it), and the colour and alpha tracks chosen and their sample
tables laid out as avifDecoderReset does for AVIF_DECODER_SOURCE_TRACKS.

A track is `trak` with `tkhd` (versions 0 and 1, its size in 16.16, the
track's ID), `edts/elst`, `tref` (`auxl`, `prem`), `meta`, and
`mdia/mdhd/hdlr` and `mdia/minf/stbl`: `stsd` (VisualSampleEntries; an
`av01` one's boxes are read as item properties are: `av1C`, `colr`,
`auxi`, ...), `stts`, `stsc`, `stsz`, `stco` / `co64` and `stss`. `mvhd`
is not read. Boxes that do not fit, versions libavif does not know,
repeated unique boxes and bad tables are refused with libavif's words.
The colour track is the first one with samples, an ID, an `av01` entry
and no `auxl`; its alpha the first such track whose `auxl` names it and
whose entry's first `auxi` (if it has one) names the alpha URN. Every
sample of both is laid out and checked to lie in the file; the frame
Pillow shows is the colour track's first sample, decoded by data/avif.py
and scaled to `tkhd`'s size.
"""
from __future__ import annotations

from types import SimpleNamespace

from . import avif

# avifDecoder's defaults, which Pillow keeps
IMAGE_COUNT_LIMIT = 12 * 3600 * 60
SIZE_LIMIT = 16384 * 16384
DIMENSION_LIMIT = 32768
VISUAL_SAMPLE_ENTRY = 78            # the bytes before an entry's boxes


def parse_moov(body: bytes, path: str) -> list:
    """The tracks of a `moov` box, in its order."""
    tracks = []
    for typ, b in avif._Stream(body, path, "moov").boxes():
        if typ == b"trak":
            tracks.append(_trak(b, path))
    if not tracks:
        raise avif._refuse(path, "moov box does not contain any tracks")
    return tracks


def _trak(body: bytes, path: str) -> SimpleNamespace:
    t = SimpleNamespace(id=0, width=0, height=0, aux_for=0, prem_by=0,
                        stbl=None, timescale=0, repeating=False,
                        duration=0)
    seen = set()
    for typ, b in avif._Stream(body, path, "trak").boxes():
        if typ in (b"tkhd", b"edts"):
            if typ in seen:
                raise avif._refuse(path, "Box[trak] contains a duplicate "
                                         f"unique box of type "
                                         f"'{typ.decode()}'")
            seen.add(typ)
        if typ == b"tkhd":
            _tkhd(avif._Stream(b, path, "tkhd"), t, path)
        elif typ == b"meta":
            # a track's own meta box, read as the file's is
            st = avif._Stream(b, path, "meta")
            avif._meta(st, SimpleNamespace(primary=None, props=[], items={},
                                           refs=[], idat=None), path)
        elif typ == b"mdia":
            _mdia(b, t, path)
        elif typ == b"tref":
            _tref(avif._Stream(b, path, "tref"), t, path)
        elif typ == b"edts":
            _edts(b, t, path)
    if b"tkhd" not in seen:
        raise avif._refuse(path, "Box[trak] does not contain a mandatory "
                                 "[tkhd] box")
    if b"edts" in seen and t.repeating and t.duration == 0:
        raise avif._refuse(path, "Invalid track duration 0.")
    return t


def _tkhd(st, t: SimpleNamespace, path: str):
    v = st.uint(1)
    st.read(3)
    if v not in (0, 1):
        raise avif._refuse(path, f"Box[tkhd] has an unsupported version "
                                 f"[{v}]")
    n = 8 if v else 4
    st.read(2 * n)                              # creation, modification
    tid = st.uint(4)
    st.read(4)
    t.duration = st.uint(n)
    st.read(52)                  # reserved, layer, group, volume, matrix
    w, h = st.uint(4) >> 16, st.uint(4) >> 16
    t.id = tid
    if not w or not h:
        raise avif._refuse(path, f"Track ID [{tid}] has an invalid size "
                                 f"[{w}x{h}]")
    if w > DIMENSION_LIMIT or h > DIMENSION_LIMIT or w * h > SIZE_LIMIT:
        raise avif._refuse(path, f"Track ID [{tid}] dimensions are too "
                                 f"large [{w}x{h}]")
    t.width, t.height = w, h


def _edts(body: bytes, t: SimpleNamespace, path: str):
    seen = False
    for typ, b in avif._Stream(body, path, "edts").boxes():
        if typ == b"elst":
            if seen:
                raise avif._refuse(path, "More than one [elst] Box was "
                                         "found.")
            seen = True
            st = avif._Stream(b, path, "elst")
            v, flags = st.uint(1), st.uint(3)
            t.repeating = bool(flags & 1)
            if not t.repeating:
                continue
            n = st.uint(4)
            if n != 1:
                raise avif._refuse(path, "Box[elst] contains an entry_count "
                                         f"!= 1 [{n}]")
            if v not in (0, 1):
                raise avif._refuse(path, "Box[elst] has an unsupported "
                                         f"version [{v}]")
            if not st.uint(8 if v else 4):
                raise avif._refuse(path, "Box[elst] Invalid value for "
                                         "segment_duration (0).")
    if not seen:
        raise avif._refuse(path, "Box[edts] contains no [elst] Box.")


def _tref(st, t: SimpleNamespace, path: str):
    """avifTrackReferenceBox: the first ID of each auxl and prem box, the
    last such box winning; the ID is read even where the box is shorter
    than it."""
    while st.left():
        typ, size = st.header()
        if typ in (b"auxl", b"prem"):
            tid = st.uint(4)
            if size < 4:
                raise avif._refuse(path, "Box[tref]: Failed to skip a box "
                                         "shorter than its track ID")
            st.read(size - 4)
            if typ == b"auxl":
                t.aux_for = tid
            else:
                t.prem_by = tid
        else:
            st.read(size)


def _mdia(body: bytes, t: SimpleNamespace, path: str):
    for typ, b in avif._Stream(body, path, "mdia").boxes():
        if typ == b"mdhd":
            st = avif._Stream(b, path, "mdhd")
            v = st.uint(1)
            st.read(3)
            if v not in (0, 1):
                raise avif._refuse(path, "Box[mdhd] has an unsupported "
                                         f"version [{v}]")
            st.read(16 if v else 8)             # creation, modification
            t.timescale = st.uint(4)
            st.read(8 if v else 4)              # duration
        elif typ == b"hdlr":
            # the handler type is not checked here (an alpha track's is
            # auxv)
            st = avif._Stream(b, path, "hdlr")
            v = st.uint(1)
            st.read(3)
            if v:
                raise avif._refuse(path, "Box[hdlr]: Expecting box version "
                                         f"0, got version {v}")
            if st.uint(4):
                raise avif._refuse(path, "Box[hdlr] contains a pre_defined "
                                         "value that is nonzero")
            st.read(16)
            st.string()
        elif typ == b"minf":
            for t2, b2 in avif._Stream(b, path, "minf").boxes():
                if t2 == b"stbl":
                    _stbl(b2, t, path)


def _stbl(body: bytes, t: SimpleNamespace, path: str):
    if t.stbl is not None:
        raise avif._refuse(path, "Duplicate Box[stbl] for a single track "
                                 "detected")
    s = t.stbl = SimpleNamespace(chunks=[], stsc=[], sizes=[], all_size=0,
                                 entries=[])
    for typ, b in avif._Stream(body, path, "stbl").boxes():
        name = typ.decode("latin-1")
        if typ not in (b"stco", b"co64", b"stsc", b"stsz", b"stss", b"stts",
                       b"stsd"):
            continue
        st = avif._Stream(b, path, name)
        v = st.uint(1)
        st.read(3)
        if v not in ((0, 1) if typ == b"stsd" else (0,)):
            raise avif._refuse(path, f"Box[{name}]: Expecting box version "
                                     f"{'0 or 1' if typ == b'stsd' else 0}"
                                     f", got version {v}")
        if typ in (b"stco", b"co64"):
            n = 8 if typ == b"co64" else 4
            s.chunks += [st.uint(n) for _ in range(st.uint(4))]
        elif typ == b"stsc":
            prev = 0
            for i in range(st.uint(4)):
                first, per, _ = st.uint(4), st.uint(4), st.uint(4)
                if i == 0 and first != 1:
                    raise avif._refuse(path, "Box[stsc] does not begin with "
                                             f"chunk 1 [{first}]")
                if i and first <= prev:
                    raise avif._refuse(path, "Box[stsc] chunks are not "
                                             "strictly increasing")
                prev = first
                s.stsc.append((first, per))
        elif typ == b"stsz":
            size, n = st.uint(4), st.uint(4)
            if size:
                s.all_size = size
            else:
                s.sizes += [st.uint(4) for _ in range(n)]
        elif typ in (b"stss", b"stts"):
            for _ in range(st.uint(4)):      # sync samples, time to sample
                st.read(4 if typ == b"stss" else 8)
        else:
            for _ in range(st.uint(4)):
                etyp, size = st.header()
                entry = st.read(size)
                props = []
                if etyp == b"av01":
                    if size < VISUAL_SAMPLE_ENTRY:
                        raise avif._refuse(path, "Not enough bytes to parse "
                                                 "VisualSampleEntry")
                    kids = avif._Stream(entry[VISUAL_SAMPLE_ENTRY:], path,
                                        "ipco").boxes()
                    props = [avif._property(t2, b2, path, track=True)
                             for t2, b2 in kids]
                s.entries.append((etyp, props))


def _av01(track: SimpleNamespace):
    """The properties of the track's first av01 sample entry, or None."""
    for typ, props in track.stbl.entries if track.stbl else ():
        if typ == b"av01":
            return props
    return None


def _usable(track: SimpleNamespace) -> bool:
    return track.stbl is not None and track.id != 0 and \
        bool(track.stbl.chunks) and _av01(track) is not None


def _is_alpha(track: SimpleNamespace) -> bool:
    auxi = [b for t, b in _av01(track) if t == b"auxi"]
    return not auxi or auxi[0][4:].split(b"\0")[0] in avif._ALPHA_URNS


def _per_chunk(stsc: list, chunk: int) -> int:
    for first, per in reversed(stsc):
        if first <= chunk + 1:
            return per
    return 0


def _samples(track: SimpleNamespace, size_hint: int, path: str) -> list:
    """avifCodecDecodeInputFillFromSampleTable: each sample's (offset,
    size), chunk by chunk, checked against the image count limit and the
    file's end."""
    s = track.stbl
    left = IMAGE_COUNT_LIMIT
    for c in range(len(s.chunks)):
        n = _per_chunk(s.stsc, c)
        if n == 0:
            raise avif._refuse(path, "Sample table contains a chunk with 0 "
                                     "samples")
        if n > left:
            raise avif._refuse(path, "Exceeded avifDecoder's "
                                     "imageCountLimit")
        left -= n
    out, k = [], 0
    for c, off in enumerate(s.chunks):
        for _ in range(_per_chunk(s.stsc, c)):
            size = s.all_size
            if not size:
                if k >= len(s.sizes):
                    raise avif._refuse(path, "Truncated sample table")
                size = s.sizes[k]
            if off + size > size_hint:
                raise avif._refuse(path, "Exceeded avifIO's sizeHint, "
                                         "possibly truncated data")
            out.append((off, size))
            off += size
            k += 1
    return out


def select(tracks: list, size_hint: int, path: str) -> SimpleNamespace:
    """avifDecoderReset over tracks: the colour track, its alpha track
    (None where it has none), the samples of each and the colour track's
    sample entry properties, checked as libavif checks them."""
    colour = next((t for t in tracks if _usable(t) and not t.aux_for), None)
    if colour is None:
        raise avif._refuse(path, "Failed to find AV1 color track")
    alpha = next((t for t in tracks if _usable(t) and
                  t.aux_for == colour.id and _is_alpha(t)), None)
    samples = {id(t): _samples(t, size_hint, path)
               for t in (colour, alpha) if t is not None}
    if any(size == 0 for ss in samples.values() for _, size in ss):
        raise avif._refuse(path, "a track has a sample of no bytes")
    props = _av01(colour)
    kinds = [b[:4] for t, b in props if t == b"colr"]
    if kinds.count(b"nclx") > 1 or sum(kinds.count(k) for k in (
            b"prof", b"rICC")) > 1:
        raise avif._refuse(path, "the colour track's sample entry has two "
                                 "colr boxes of a kind")
    if not any(t == b"av1C" for t, _ in props):
        raise avif._refuse(path, "the colour track's sample entry has no "
                                 "av1C box")
    return SimpleNamespace(
        colour=colour, alpha=alpha, props=props,
        samples=samples[id(colour)],
        alpha_samples=samples[id(alpha)] if alpha is not None else (),
        premultiplied=alpha is not None and colour.prem_by == alpha.id)
