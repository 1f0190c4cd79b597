"""The AV1 tools the port's AVIF decoder added last: superres
(l3c_torch/data/av1_superres.py, the frame header's superres_params and
restoration units of the upscaled frame), per-block loop filter deltas
(av1_block's DeltaLF, av1_loopfilter's level per block) and the segment
reference features (SEG_LVL_REF_FRAME, SEG_LVL_GLOBALMV), against
Pillow 12.1's AVIF plugin (libavif 1.3.0, dav1d 1.5.1, libyuv) and the
JAX package's loader.

aom 3.12.1 inside Pillow's libavif writes none of these into an AVIF, so
the fixtures (l3c_torch/data/fixtures/avif_tools, written by
`PYTHONPATH=. python tests/test_torch_port_avif_tools.py`) are Pillow's
files rewritten here:
- superres: the sequence header's enable_superres and max_frame_width,
  the frame header's use_superres and coded_denom, ispe or tkhd, with
  the tile data as it was (it codes the downscaled frame; the upscale
  comes after CDEF). The frame's header reads are logged and written
  again with the new fields (as test_torch_port_avif_deep's depth
  rewrite does).
- delta_lf, segment features and restoration units of a superres frame:
  a test-only AV1 range encoder. Every symbol the port's SymbolReader
  reads from a source tile is recorded, then written again through an
  exact encoder (libaom's od_ec arithmetic and its flush, which gives an
  unchanged tile back byte for byte) while the decoder walks the frame
  under the rewritten header: the delta_lf symbols are added with seeded
  values after each delta_q read, the segment id moves before `skip`
  where features 5 or 7 set SegIdPreSkip, and a superres frame's
  restoration units get seeded symbols where its walk reads them.
Each fixture is held to Pillow's pixels (expected.json), the upscale alone
and each in-loop filter stage to dav1d's planes (its exported API,
`test_torch_port_avif._dav1d_planes`), and seeded single-bit flips of a
superres file and a delta_lf file to Pillow.
"""
from __future__ import annotations

import ctypes
import json
import linecache
import os
import re
import struct
import sys

import numpy as np
import pytest
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from l3c_tpu.data import images as jimages  # noqa: E402
from l3c_torch.data import (av1_block, av1_obu, av1_superres,  # noqa: E402
                            av1_symbol, avif)
from l3c_torch.data import images as timages  # noqa: E402
import test_torch_port_avif as A  # noqa: E402
import test_torch_port_avif_deep as D  # noqa: E402
import test_torch_port_avif_seq as S  # noqa: E402

FIXTURES = os.path.join(A.ROOT, "l3c_torch", "data", "fixtures",
                        "avif_tools")
CODED = ("sr_coded_512.avif",)
FLIPS = 200
_OBU_SEQ, _OBU_FRAME_HEADER, _OBU_FRAME = 1, 3, 6


# ------------------------------------------------------- header rewrites

def header_reads(parse, data: bytes, at: int, end: int, *args):
    """(parse's result, its reads [bits, value, source line], the reader)
    of a header parsed from data[at:end]: each read named by the line of
    av1_obu that made it."""
    reads = []
    own = av1_obu.__file__

    class Log(av1_obu.Bits):
        def f(self, n):
            v = super().f(n)
            fr = sys._getframe(1)
            while fr.f_code.co_filename == own and fr.f_code.co_name in (
                    "su", "ns", "_delta_q", "_cdef_strength", "_points"):
                fr = fr.f_back
            reads.append([n, v, linecache.getline(
                fr.f_code.co_filename, fr.f_lineno).strip()])
            return v
    b = Log(data, at, end, "x")
    return parse(b, *args), reads, b


def emit(reads, trailing: bool) -> bytes:
    """The reads written MSB first, then trailing_bits or zeros to the
    byte."""
    bits = [(v >> (n - 1 - i)) & 1 for n, v, _ in reads for i in range(n)]
    bits += [1] if trailing else []
    bits += [0] * (-len(bits) % 8)
    return bytes(int("".join(map(str, bits[i:i + 8])), 2)
                 for i in range(0, len(bits), 8))


def _at(reads, text: str) -> int:
    return next(i for i, r in enumerate(reads) if text in r[2])


def _obu(typ: int, payload: bytes) -> bytes:
    return bytes([(typ << 3) | 2]) + D._leb128(len(payload)) + payload


def edit_obus(data: bytes, seq_edit=None, frame_edit=None) -> bytes:
    """The OBUs with the sequence header's reads edited by seq_edit(reads)
    and the first frame header's by frame_edit(reads, frame), each written
    again; the tile data copied as it is."""
    out, seq, done = b"", None, False
    for typ, _, _, at, end in av1_obu.obus(data, "x"):
        if typ == _OBU_SEQ:
            seq, reads, _ = header_reads(av1_obu.sequence_header, data, at,
                                         end)
            if seq_edit:
                seq_edit(reads)
                out += _obu(typ, emit(reads, True))
                continue
        elif typ in (_OBU_FRAME, _OBU_FRAME_HEADER) and not done:
            done = True
            f, reads, b = header_reads(av1_obu.frame_header, data, at, end,
                                       seq)
            if frame_edit:
                frame_edit(reads, f)
                b.byte_alignment()
                out += _obu(typ, emit(reads, False) + data[b.pos:end]
                            if typ == _OBU_FRAME else emit(reads, True))
                continue
        out += _obu(typ, data[at:end])
    return out


def up_width(w0: int, denom: int) -> int:
    """An UpscaledWidth whose frame is coded `w0` wide at `denom` (dav1d's
    floor of min(16, UpscaledWidth) included), the one nearest w0 * denom
    / 8."""
    fits = [w for w in range(w0, 2 * w0 + 2)
            if max((8 * w + denom // 2) // denom, min(16, w)) == w0]
    return min(fits, key=lambda w: abs(8 * w - w0 * denom))


def superres_obus(data: bytes, up_w: int, denom: int) -> bytes:
    """The OBUs with superres coded at `denom`: enable_superres and a
    max_frame_width of `up_w` (frame_width_bits widened where needed), and
    in the first frame header use_superres and coded_denom after the frame
    size (and a coded frame width of `up_w`); allow_intrabc, which dav1d
    does not read with superres, is left out."""
    bits = {}

    def seq_edit(reads):
        i = _at(reads, "wbits, hbits =")
        j = _at(reads, "s.max_width, s.max_height =")
        nb = max(reads[i][1] + 1, (up_w - 1).bit_length())
        bits["w"] = nb
        reads[i][1] = nb - 1
        reads[j][:2] = [nb, up_w - 1]
        reads[_at(reads, "s.enable_superres =")][1] = 1

    def frame_edit(reads, f):
        for r in reads:
            if "f.width = b.f(s.frame_width_bits)" in r[2]:
                r[:2] = [bits["w"], up_w - 1]
        reads[:] = [r for r in reads if "f.allow_intrabc = b.f(1)" not in
                    r[2]]
        k = _at(reads, "# render size")
        reads[k:k] = [[1, 1, "use_superres"], [3, denom - 9, "coded_denom"]]
    return edit_obus(data, seq_edit, frame_edit)


def _frame_width(data: bytes) -> int:
    return av1_obu.parse_av1(data, "x")[1].width


def set_superres(blob: bytes, denom: int, only=None, ispe="upscaled",
                 width=None, obus=superres_obus) -> bytes:
    """A still (or a grid's cells) with superres coded at `denom` in each
    AV1 item (those in `only`, else all): its OBUs (obus(OBUs, upscaled
    width, denom)) and av1C's, and ispe made the upscaled width (or left
    as it was, ispe="as is"); written again by `mux`. `width(w0)` chooses
    the upscaled width."""
    f = A.items_of(blob)
    for k, it in f["items"].items():
        if it["type"] != b"av01" or (only is not None and k not in only):
            continue
        w0 = _frame_width(it["data"])
        up = width(w0) if width else up_width(w0, denom)
        it["data"] = obus(it["data"], up, denom)
        props = []
        for t, b, e in it["props"]:
            if t == b"av1C" and b[4:]:
                b = b[:4] + superres_obus(b[4:], up, denom)
            elif t == b"ispe" and ispe == "upscaled":
                b = b[:4] + struct.pack(">I", up) + b[8:12]
            props.append((t, b, e))
        it["props"] = props
    return A.mux(f)


def _first_sample(fn):
    """fn for the sample that holds the sequence header (the key frame a
    still read decodes); the others as they are."""
    return lambda d: fn(d) if any(t == _OBU_SEQ for t, *_ in av1_obu.obus(
        d, "x")) else d


def seq_set_superres(blob: bytes, denom: int, samples=None) -> bytes:
    """A Pillow sequence whose first frame codes superres at `denom` (its
    sample's OBUs, each av1C's sequence header, ispe and the colour
    track's tkhd width); the upscaled width must keep frame_width_bits,
    so that av1C and ispe keep their size. The later frames are not
    rewritten: a still read decodes the first. `samples(upscaled
    width)`, where given, is the function of a sample's bytes that
    writes the samples instead."""
    nodes = S.parse_boxes(blob)
    first = S.track_samples(S.get(nodes, b"moov", b"trak"))[0]
    w0 = _frame_width(blob[first[0]:first[0] + first[1]])
    up = up_width(w0, denom)

    def fix_av1c(b):
        new = b[:4] + superres_obus(b[4:], up, denom)
        assert len(new) == len(b)
        return new

    def entry(n):
        for c in n[2]:
            if c[0] == b"av1C":
                c[1] = fix_av1c(c[1])

    def meta(body):
        body = bytearray(body)
        for typ in (b"av1C", b"ispe"):
            at = body.find(typ)
            size = struct.unpack(">I", body[at - 4:at])[0]
            box = bytes(body[at + 4:at - 4 + size])
            body[at + 4:at - 4 + size] = fix_av1c(box) if typ == b"av1C" \
                else box[:4] + struct.pack(">I", up) + box[8:]
        return bytes(body)
    out = S.rewrite_samples(blob, samples(up) if samples else _first_sample(
        lambda d: superres_obus(d, up, denom)), entry, meta)
    nodes = S.parse_boxes(out)
    tkhd = S.get(nodes, b"moov", b"trak", b"tkhd")
    b = bytearray(tkhd[1])
    at = 88 if b[0] == 1 else 76
    b[at:at + 4] = struct.pack(">I", up << 16)
    tkhd[1] = bytes(b)
    return S.write_boxes(nodes)


# --------------------------------------------------- the range re-encoder

class RangeEncoder:
    """AV1's symbol encoder (libaom's od_ec_encode_q15 / bool_q15 and
    od_ec_enc_done), the inverse of av1_symbol.SymbolReader: `low` held
    whole in one integer (carries need no propagation), `shift` the
    renormalisation bits so far."""

    def __init__(self):
        self.low, self.rng, self.shift = 0, 1 << 15, 0

    def _put(self, u, v):
        self.low += self.rng - u
        r = u - v
        d = 16 - r.bit_length()
        self.low, self.rng, self.shift = self.low << d, r << d, \
            self.shift + d

    def symbol(self, cdf, s):
        n, r8 = len(cdf) - 1, self.rng >> 8

        def edge(i):
            return ((r8 * (cdf[i] >> 6)) >> 1) + 4 * (n - i - 1)
        self._put(self.rng if s == 0 else edge(s - 1), edge(s))

    def bool(self, b):
        cur = ((self.rng >> 8) << 7) + 4
        self._put(*((self.rng, cur) if b == 0 else (cur, 0)))

    def done(self) -> bytes:
        """od_ec_enc_done: the value rounded up to 14 bits with its
        trailing one, in the fewest whole bytes."""
        e = ((self.low + 0x3FFF) & ~0x3FFF) | 0x4000
        n = (self.shift + 8) // 8
        sh = self.shift + 15 - 8 * n
        return (e >> sh if sh >= 0 else e << -sh).to_bytes(n, "big")


def _adapt(cdf, s, update):
    """SymbolReader.symbol's CDF adaptation."""
    n = len(cdf) - 1
    if not update:
        return
    cnt = cdf[n]
    rate = 3 + (cnt > 15) + (cnt > 31) + (2 if n > 3 else (n >> 1))
    for i in range(n - 1):
        cdf[i] += (32768 - cdf[i]) >> rate if i < s else -(cdf[i] >> rate)
    if cnt < 32:
        cdf[n] = cnt + 1


def _cdf_names(cdfs) -> dict:
    """id of each CDF list of a tile's _Cdfs -> its attribute's name."""
    out = {}

    def leaves(x, name):
        if not isinstance(x, list):
            return
        if x and all(isinstance(v, int) for v in x):
            out[id(x)] = name
        else:
            for y in x:
                leaves(y, name)
    for k, v in vars(cdfs).items():
        leaves(v, k)
    return out


class _Walk:
    """The decoder's symbol reads patched for the length of a `with`: the
    tile's CDF names and whether a restoration unit is being read are
    kept in `ctx` (a `lr` flag, `names`)."""

    def __init__(self, reader=None):
        self.reader, self.ctx = reader, {"lr": False, "names": {}}

    def __enter__(self):
        ctx, B = self.ctx, av1_block
        self.saved = (B._Cdfs.__init__, B.FrameDecoder._read_lr_unit,
                      B.SymbolReader)
        init, lr_unit, _ = self.saved

        def cdfs_init(c, *a):
            init(c, *a)
            ctx["names"] = _cdf_names(c)

        def read_lr_unit(d, *a):
            ctx["lr"] = True
            try:
                return lr_unit(d, *a)
            finally:
                ctx["lr"] = False
        B._Cdfs.__init__ = cdfs_init
        B.FrameDecoder._read_lr_unit = read_lr_unit
        if self.reader:
            B.SymbolReader = self.reader
        return ctx

    def __exit__(self, *exc):
        (av1_block._Cdfs.__init__, av1_block.FrameDecoder._read_lr_unit,
         av1_block.SymbolReader) = self.saved


def record(data: bytes):
    """Every symbol and bool the decoder reads from each tile of the
    frame, in order: (kind "s" / "b", CDF name, value, in a restoration
    unit)."""
    seq, f, tiles = av1_obu.parse_av1(data, "x")
    events = []
    walk = _Walk()

    class Logged(av1_symbol.SymbolReader):
        def symbol(self, cdf):
            v = super().symbol(cdf)
            events[-1].append(("s", ctx["names"].get(id(cdf)), v,
                               ctx["lr"]))
            return v

        def bool(self):
            v = super().bool()
            events[-1].append(("b", None, v, ctx["lr"]))
            return v
    walk.reader = Logged
    with walk as ctx:
        d = av1_block.FrameDecoder(seq, f, "x")
        for tr, tc, start, end in tiles:
            events.append([])
            d.decode_tile(data, start, end, tr, tc)
    return events


class Replayer(av1_symbol.SymbolReader):
    """A SymbolReader that writes what it returns: the recorded source's
    values, or those `policy` chooses (symbol(replayer, name) -> a value or
    None; `lr`, a RandomState for fresh restoration units, or None)."""

    def __init__(self, events, policy, disable_cdf_update, ctx):
        self.src, self.at, self.pending = list(events), 0, []
        self.enc, self.update = RangeEncoder(), not disable_cdf_update
        self.policy, self.ctx = policy, ctx

    def _fresh_lr(self):
        return self.ctx["lr"] and getattr(self.policy, "lr", None)

    def _next(self, kind, name):
        while getattr(self.policy, "lr", None) and self.src[self.at][3]:
            self.at += 1               # the source's units: written anew
        e = self.src[self.at]
        self.at += 1
        assert e[0] == kind and (kind == "b" or e[1] == name), (e, name)
        return e[2]

    def symbol(self, cdf):
        name = self.ctx["names"].get(id(cdf))
        if self._fresh_lr():
            v = int(self.policy.lr.randint(len(cdf) - 1))
        else:
            v = self.policy.symbol(self, name) if self.policy else None
            v = self._next("s", name) if v is None else v
        self.enc.symbol(cdf, v)
        _adapt(cdf, v, self.update)
        return v

    def bool(self):
        if self._fresh_lr():
            v = int(self.policy.lr.randint(2))
        else:
            v = self.pending.pop(0) if self.pending else self._next("b", None)
        self.enc.bool(v)
        return v

    def max_bits(self):
        return 0

    def rest(self):
        """The source's reads not written (only restoration units')."""
        return [e for e in self.src[self.at:] if not e[3]]


def _tile_group(tiles, size_bytes):
    out = b"\0" if len(tiles) > 1 else b""     # no tile start and end
    for k, t in enumerate(tiles):
        if k < len(tiles) - 1:
            out += (len(t) - 1).to_bytes(size_bytes, "little")
        out += t
    return out


def reencode(src: bytes, new: bytes, policy=None) -> bytes:
    """`new`'s OBUs (headers rewritten from `src`'s, tile data copied) with
    the frame's tiles coded again: the symbols `src`'s tiles hold, walked
    under `new`'s headers with `policy`'s additions. One tile group, in
    an OBU_FRAME."""
    events = record(src)
    seq, f, tiles = av1_obu.parse_av1(new, "x")
    made = []
    walk = _Walk()

    def reader(data, start, end, disable):
        made.append(Replayer(events[len(made)], policy, disable, ctx))
        return made[-1]
    walk.reader = reader
    with walk as ctx:
        d = av1_block.FrameDecoder(seq, f, "x")
        for tr, tc, start, end in tiles:
            d.decode_tile(new, start, end, tr, tc)
    assert all(not r.rest() for r in made)
    coded = [r.enc.done() for r in made]
    out = b""
    for typ, _, _, at, end in av1_obu.obus(new, "x"):
        if typ == _OBU_FRAME:
            b = av1_obu.Bits(new, at, end, "x")
            av1_obu.frame_header(b, seq)
            b.byte_alignment()
            out += _obu(typ, new[at:b.pos] + _tile_group(coded,
                                                         f.tile_size_bytes))
        else:
            out += _obu(typ, new[at:end])
    return out


class DeltaLF:
    """Seeded delta_lf values (0 .. `most` in size, 0 three times in ten
    but the first) after each delta_q read, and delta_q 0 where the source
    has none."""

    def __init__(self, seed, most=6, new_q=False):
        self.r, self.most, self.new_q = np.random.RandomState(seed), most, \
            new_q
        self.nonzero = 0

    def symbol(self, rep, name):
        if name == "delta_q" and self.new_q:
            return 0
        if name not in ("delta_lf", "delta_lf_multi"):
            return None
        a = int(self.r.randint(1, self.most + 1)) if self.r.rand() < 0.7 \
            or not self.nonzero else 0
        self.nonzero += a > 0
        if a >= 3:                   # delta_lf_rem_bits, delta_lf_abs_bits
            n = (a - 1).bit_length() - 1
            rem = a - (1 << n) - 1
            rep.pending += [((n - 1) >> (2 - i)) & 1 for i in range(3)] + \
                [(rem >> (n - 1 - i)) & 1 for i in range(n)]
        if a:
            rep.pending.append(int(self.r.rand() < 0.5))     # the sign
        return min(a, 3)


class PreSkip:
    """The segment id read before skip (SegIdPreSkip): the id the source
    gives the block, or 0 (the predicted id) where it is skipped."""

    def symbol(self, rep, name):
        if name != "segment":
            return None
        e = rep.src[rep.at]
        assert e[1] == "skip", e
        if e[2]:
            return 0
        nxt = rep.src.pop(rep.at + 1)
        assert nxt[1] == "segment", nxt
        return nxt[2]


class FreshLR:
    """Seeded restoration units wherever the walk reads one."""

    def __init__(self, seed):
        self.lr = np.random.RandomState(seed)

    def symbol(self, rep, name):
        return None


def with_delta_lf(res: int, multi: int, q_res=None):
    """A frame header edit: delta_lf_present with `res` and `multi`; with
    `q_res`, delta_q_present (of that resolution) too."""
    def edit(reads, f):
        k = _at(reads, "f.delta_q_present = b.f(1)")
        add = [[1, 1, "delta_lf_present"], [2, res, "delta_lf_res"],
               [1, multi, "delta_lf_multi"]]
        if q_res is not None:
            assert reads[k][1] == 0
            reads[k][1] = 1
            reads[k + 1:k + 1] = [[2, q_res, "delta_q_res"]] + add
        else:
            j = _at(reads, "f.delta_lf_present = b.f(1)")
            reads[j:j + 1] = add
    return edit


def _seg_reads(feature):
    out = []
    for i in range(8):
        for j in range(8):
            v = feature[i][j]
            out.append([1, int(v is not None), "feature_enabled"])
            bits = av1_obu.SEG_FEATURE_BITS[j]
            if v is not None and bits:
                if av1_obu.SEG_FEATURE_SIGNED[j]:
                    out.append([1 + bits, v & ((2 << bits) - 1), "value"])
                else:
                    out.append([bits, v, "value"])
    return out


def with_features(segs, ref=None, globalmv=False):
    """A frame header edit: SEG_LVL_REF_FRAME at `ref` and / or
    SEG_LVL_GLOBALMV on the segments `segs` of a frame with segmentation
    on."""
    def edit(reads, f):
        k = _at(reads, "f.seg_enabled = b.f(1)")
        assert reads[k][1] == 1
        new = [list(r) for r in f.seg_feature]
        for i in segs:
            if ref is not None:
                new[i][5] = ref
            if globalmv:
                new[i][7] = 0
        reads[k + 1:k + 1 + len(_seg_reads(f.seg_feature))] = \
            _seg_reads(new)
    return edit


def rewrite_item(blob: bytes, fn) -> bytes:
    """A still whose primary item's OBUs are fn(OBUs), written by mux."""
    f = A.items_of(blob)
    it = f["items"][f["primary"]]
    it["data"] = fn(it["data"])
    return A.mux(f)


def rewrite_first_frame(blob: bytes, fn) -> bytes:
    """A sequence whose first sample's OBUs are fn(OBUs)."""
    return S.rewrite_samples(blob, _first_sample(fn))


# ---------------------------------------------------------------- corpus

def _read_from(folder, name):
    with open(os.path.join(folder, name), "rb") as f:
        return f.read()


def _fixture(name):
    return _read_from(A.FIXTURES, name)


def _seq_fixture(name):
    return _read_from(S.FIXTURES, name)


# Pillow's saves the superres files start from (deblocking and CDEF on,
# restoration off, so that the tile data reads the same when upscaled)
FILTERS_ON = {"enable-cdef": "1", "enable-restoration": "0"}
LAYOUTS = ("4:2:0", "4:2:2", "4:4:4", "4:0:0")


def saves() -> dict:
    """name -> a Pillow still save (aom's stills are deterministic)."""
    out = {}
    for k, ss in enumerate(LAYOUTS):
        out[f"src_{ss.replace(':', '')}"] = lambda k=k, ss=ss: A.save(
            A.waves(40 + 8 * k, 52 - 6 * k, 70 + k), quality=45,
            subsampling=ss, advanced=FILTERS_ON)
    out["src_rgba"] = lambda: A.save(A.with_alpha(A.photo(36, 44, 75), 76),
                                     quality=60)
    out["src_narrow"] = lambda: A.save(A.photo(28, 16, 77), quality=50,
                                       advanced=FILTERS_ON)
    out["src_screen_narrow"] = lambda: A.save(
        A.glyphs(24, 16, 78), quality=60, speed=2,
        advanced={"tune-content": "screen", "enable-palette": "1"})
    out["src_coded"] = lambda: A.save(A.textured(512, 256, 79))
    return out


def sources() -> dict:
    """The sequences the segmentation files start from: Pillow's
    save_all with aq-mode 1 (segmentation on the key frame), committed as
    fixtures (a sequence save carries its creation time)."""
    aq = [("aq-mode", "1")]
    return {"aq_seq_420.avif": S.save_all([A.photo(128, 128, s)
                                           for s in (80, 81)], advanced=aq),
            "aq_seq_444.avif": S.save_all(
                [A.waves(96, 112, s) for s in (82, 83)], advanced=aq,
                subsampling="4:4:4", quality=50)}


def derived(src: dict) -> dict:
    """name -> a function writing the fixture, from the saves above, the
    committed fixtures of avif/, avif_seq/ and `src` (the aq sequences)."""
    s = saves()
    out = {}
    # superres at denominators 9, 12 and 16 in each layout
    for ss in LAYOUTS:
        tag = ss.replace(":", "")
        for d in (9, 12, 16):
            out[f"sr_{tag}_d{d}.avif"] = \
                lambda tag=tag, d=d: set_superres(s[f"src_{tag}"](), d)
    out["sr_rgba_colour.avif"] = lambda: set_superres(s["src_rgba"](), 12,
                                                      only={1})
    out["sr_rgba_both.avif"] = lambda: set_superres(s["src_rgba"](), 12)
    out["sr_grain_420.avif"] = lambda: set_superres(
        _fixture("v_grain05_420.avif"), 12)
    out["sr_tiles_sb128.avif"] = lambda: set_superres(
        _fixture("j_tiles_sb128.avif"), 16)
    out["sr_lr_tiles.avif"] = lambda: set_superres(
        _fixture("p_lr_tiles.avif"), 9)
    # restoration on: the header rewrite alone (the tile data's
    # restoration units no longer where the walk reads them), and the
    # tile data coded again with seeded units where the walk reads them
    out["sr_lr_switchable.avif"] = lambda: set_superres(
        _fixture("p_lr_q60_switchable.avif"), 12)
    for name, d, seed in (("p_lr_q60_switchable.avif", 12, 1),
                          ("p_lr_q75_units128.avif", 16, 2),
                          ("p_lr_q30_wiener.avif", 10, 3)):
        out[f"sr_lr_units_{name[5:-5]}_d{d}.avif"] = \
            lambda name=name, d=d, seed=seed: set_superres(
                _fixture(name), d, obus=lambda o, up, d: reencode(
                    o, superres_obus(o, up, d), FreshLR(seed)))
    out["sr_screen_420.avif"] = lambda: set_superres(
        _fixture("i_palette_screen_420.avif"), 9)
    # 16 wide: superres coded, FrameWidth floored to UpscaledWidth
    out["sr_screen_narrow.avif"] = lambda: set_superres(
        s["src_screen_narrow"](), 16, width=lambda w: w)
    out["sr_narrow_d16.avif"] = lambda: set_superres(
        s["src_narrow"](), 16, width=lambda w: 24)
    out["sr_seq_420.avif"] = lambda: seq_set_superres(
        _seq_fixture("seq_420.avif"), 9)
    out["sr_420_d12_10.avif"] = lambda: D.set_depth(
        set_superres(s["src_420"](), 12), 10)
    out["sr_444_d16_12.avif"] = lambda: D.set_depth(
        set_superres(s["src_444"](), 16), 12)
    out["sr_ispe_down.avif"] = lambda: set_superres(s["src_420"](), 16,
                                                    ispe="as is")
    out[CODED[0]] = lambda: set_superres(s["src_coded"](), 16)
    # per-block loop filter deltas: a still with delta_q, and the aq
    # sequences' key frames with delta_q added
    for res in range(4):
        for multi in (0, 1):
            out[f"dlf_qm444_r{res}_{'multi' if multi else 'one'}.avif"] = \
                lambda res=res, multi=multi: rewrite_item(
                    _fixture("q_qm_444_deltaq.avif"), lambda o: reencode(
                        o, edit_obus(o, frame_edit=with_delta_lf(res, multi)),
                        DeltaLF(10 * res + multi)))
    for res, multi, ss in ((0, 1, "420"), (1, 0, "420"), (2, 1, "444"),
                           (3, 0, "444")):
        out[f"dlf_aq{ss}_r{res}_{'multi' if multi else 'one'}.avif"] = \
            lambda res=res, multi=multi, ss=ss: rewrite_first_frame(
                src[f"aq_seq_{ss}.avif"], lambda o: reencode(
                    o, edit_obus(o, frame_edit=with_delta_lf(
                        res, multi, q_res=1)), DeltaLF(20 + res,
                                                       new_q=True)))
    out["dlf_400_multi.avif"] = lambda: rewrite_item(
        _fixture("n_deblock_q18_400.avif"), lambda o: reencode(
            o, edit_obus(o, frame_edit=with_delta_lf(3, 1, q_res=0)),
            DeltaLF(30, new_q=True)))
    # segment reference features: the ids moved before skip, and one file
    # with the header alone rewritten (the tile data then read otherwise)
    for name, segs, ref, gmv in (("ref0_seg3", (3,), 0, False),
                                 ("ref5_seg3", (3,), 5, False),
                                 ("gmv_seg2", (2,), None, True),
                                 ("ref1_gmv_all", range(8), 1, True),
                                 ("gmv_all_444", range(8), None, True)):
        out[f"seg_{name}.avif"] = \
            lambda segs=segs, ref=ref, gmv=gmv, name=name: \
            rewrite_first_frame(
                src["aq_seq_444.avif" if "444" in name else
                    "aq_seq_420.avif"], lambda o: reencode(
                    o, edit_obus(o, frame_edit=with_features(segs, ref, gmv)),
                    PreSkip()))
    out["seg_gmv_header_only.avif"] = lambda: rewrite_first_frame(
        src["aq_seq_420.avif"], lambda o: edit_obus(
            o, frame_edit=with_features((0, 1), None, True)))
    return out


def corpus() -> dict:
    """name -> file bytes of every fixture, the aq sequences saved now."""
    src = sources()
    return {**src, **{n: fn() for n, fn in derived(src).items()}}


# ------------------------------------------------------- expected.json

def tools_expected_now(folder=FIXTURES) -> dict:
    """Each file's format, mode, size and digest as Pillow and the JAX
    package give them, or Pillow's reason for refusing it ("pillow") and
    the port's ("port")."""
    files = {}
    for n in sorted(os.listdir(folder)):
        if n == "expected.json":
            continue
        p = os.path.join(folder, n)
        got, meta = D._pillow(p)
        if meta is None:
            files[n] = {"pillow": got, "port": D._port_refusal(p)}
        else:
            files[n] = {"format": meta[0], "mode": meta[1], "size": meta[2],
                        "sha256": A._digest(jimages.load_image_uint8(p))}
    return {"files": files, "coded": list(CODED)}


def _expected():
    with open(os.path.join(FIXTURES, "expected.json")) as f:
        return json.load(f)


def _names():
    if not os.path.exists(os.path.join(FIXTURES, "expected.json")):
        return []                     # before the maker's first run
    return sorted(_expected()["files"])


def _read(name):
    return _read_from(FIXTURES, name)


def _frame_data(name):
    """The primary item's (or first sample's) OBUs."""
    blob = _read(name)
    m = avif.parse(blob, name)
    if m.source == "tracks":
        off, size = m.seq.samples[0]
        return blob[off:off + size]
    return avif._item_bytes(blob, m, m.primary, name)


def _lib():
    path = A.libavif()
    if path is None:
        pytest.skip("this Pillow bundles no libavif")
    return ctypes.CDLL(path)


# ------------------------------------------------------------- the tests

def test_tools_fixtures_are_their_sources_rewritten():
    """Every fixture but the committed aq sequences is remade byte for
    byte from Pillow's deterministic still saves, the committed fixtures
    and the aq sequences; expected.json is what Pillow and the JAX loader
    give now."""
    src = {n: _read(n) for n in sources()}
    made = derived(src)
    assert sorted(list(src) + list(made)) == _names()
    for name, fn in made.items():
        assert fn() == _read(name), name
    want = _expected()
    assert tools_expected_now() == {k: want[k] for k in ("files", "coded")}
    assert want["made_by"]["libavif"] == "1.3.0"
    assert sum(os.path.getsize(os.path.join(FIXTURES, n))
               for n in os.listdir(FIXTURES)) < 200_000


@pytest.mark.parametrize("name", _names())
def test_port_reads_each_tools_fixture_as_expected(name):
    """Pillow's format, mode, size and digest and the JAX loader's pixels,
    or, where Pillow refuses the file, the port's refusal as recorded."""
    e = _expected()["files"][name]
    p = os.path.join(FIXTURES, name)
    if "pillow" in e:
        assert D._port_refusal(p) == e["port"]
        assert "and so does Pillow" in e["port"]
        return
    assert timages.image_format(p) == e["format"] == "AVIF"
    assert timages.image_mode(p) == e["mode"]
    assert list(timages.image_size(p)) == e["size"]
    got = timages.load_image_uint8(p)
    assert A._digest(got) == e["sha256"]
    assert np.array_equal(got, jimages.load_image_uint8(p))


def test_header_gives_pillows_mode_and_size_on_every_decoded_fixture():
    """avif_header against Pillow's Image.open itself."""
    n = 0
    for name, e in _expected()["files"].items():
        if "sha256" not in e:
            continue
        p = os.path.join(FIXTURES, name)
        with Image.open(p) as im:
            assert (timages.image_mode(p), timages.image_size(p)) == (
                im.mode, im.size[::-1]), name
        n += 1
    assert n >= 40


def test_each_kind_is_what_its_name_says():
    """The superres files code the frame they say at the denominator they
    say; the delta_lf files carry non-zero deltas and deblock otherwise
    than their source; the segment files set the features they say with
    SegIdPreSkip, and decode to their source's pixels; the restoration
    files Pillow decodes are those coded again."""
    e = _expected()["files"]
    for name in _names():
        if not name.startswith("sr_") or "pillow" in e[name]:
            continue
        seq, f, _ = av1_obu.parse_av1(_frame_data(name), name)
        assert f.use_superres and seq.enable_superres, name
        denom = re.search(r"_d(\d+)", name)
        if denom:
            assert f.superres_denom == int(denom.group(1)), name
        narrow = name == "sr_screen_narrow.avif"
        assert (f.width == f.upscaled_width) == narrow, name
    for layout in ("420", "422", "444", "400"):
        assert all(f"sr_{layout}_d{d}.avif" in e for d in (9, 12, 16))
    assert e["sr_ispe_down.avif"]["size"][1] < \
        e["sr_420_d16.avif"]["size"][1]
    assert e["sr_rgba_both.avif"]["mode"] == "RGBA"
    assert "pillow" in e["sr_lr_switchable.avif"]
    assert sum("sha256" in v for n, v in e.items()
               if n.startswith("sr_lr_units")) >= 2
    for name in _names():
        if name.startswith("dlf_"):
            _, f, _ = av1_obu.parse_av1(_frame_data(name), name)
            assert f.delta_lf_present and f.lf_level[:2] != [0, 0], name
            assert f.delta_lf_multi == name.endswith("multi.avif"), name
            assert "sha256" in e[name], name
        if name.startswith("seg_"):
            _, f, _ = av1_obu.parse_av1(_frame_data(name), name)
            assert f.seg_id_pre_skip and f.last_active_seg_id == 7, name
    source = {"qm444": A._expected()["files"]["q_qm_444_deltaq.avif"],
              "aq420": e["aq_seq_420.avif"], "aq444": e["aq_seq_444.avif"],
              "400": A._expected()["files"]["n_deblock_q18_400.avif"]}
    for name in _names():
        if name.startswith("dlf_"):
            data = _frame_data(name)
            seq, f, tiles = av1_obu.parse_av1(data, name)
            d = av1_block.FrameDecoder(seq, f, name)
            for tr, tc, start, end in tiles:
                d.decode_tile(data, start, end, tr, tc)
            assert len(d.lf_sets) > 1, name     # a non-zero delta
            assert e[name]["sha256"] != \
                source[name.split("_")[1]]["sha256"], name
    for name in ("seg_ref0_seg3", "seg_ref5_seg3", "seg_gmv_seg2",
                 "seg_ref1_gmv_all"):
        assert e[name + ".avif"]["sha256"] == e["aq_seq_420.avif"]["sha256"]
    assert e["seg_gmv_all_444.avif"]["sha256"] == \
        e["aq_seq_444.avif"]["sha256"]


def test_range_encoder_gives_unchanged_tiles_back_byte_for_byte():
    """The re-encoder proven first: recorded and written again with no
    change, the tiles of fixtures with every tool the walk reads
    (palettes, intra block copy, restoration units, delta_q, two tile
    columns, lossless) are their own bytes."""
    for name in ("q_qm_444_deltaq.avif", "i_palette_screen_420.avif",
                 "p_lr_tiles.avif", "a_lossless_444.avif",
                 "s_intrabc_420.avif", "o_cdef_420.avif"):
        data = A._item_data(name)[1]
        assert reencode(data, data) == data, name


def _port_planes(data, filters=True):
    """The port's cropped planes after each stage: deblocking, CDEF (each
    upscaled, as dav1d's planes with the later filters off are), then
    restoration; without `filters`, the reconstruction upscaled."""
    seq, f, tiles = av1_obu.parse_av1(data, "x")
    d = av1_block.FrameDecoder(seq, f, "x")
    for tr, tc, start, end in tiles:
        d.decode_tile(data, start, end, tr, tc)
    h, w = f.height, f.upscaled_width
    ch, cw = (h + seq.ssy) >> seq.ssy, (w + seq.ssx) >> seq.ssx
    t = np.uint8 if seq.bit_depth == 8 else np.uint16

    def crop(planes):
        if f.width != f.upscaled_width:        # dav1d's test: no upscale
            planes = av1_superres.upscale(planes, f, seq)   # where equal
        return [planes[0][:h, :w].astype(t)] + [
            p[:ch, :cw].astype(t) for p in planes[1:seq.num_planes]]
    if not filters:
        return crop(d.frame)
    stages = []
    final = av1_block.filter_frame(d, seq, f, stages=stages)
    return [crop(s) for s in stages[:2]] + [final]


SUPERRES = [n for n in _names() if n.startswith("sr_") and
            "sha256" in _expected()["files"][n]]


@pytest.mark.parametrize("name", SUPERRES)
def test_upscale_alone_equals_dav1ds(name):
    """The port's reconstruction upscaled against dav1d's planes with its
    in-loop filters off (the upscale is not one of them)."""
    lib = _lib()
    data = _frame_data(name)
    want = A._dav1d_planes(lib, data, 0, grain=0)
    got = _port_planes(data, filters=False)
    assert A._first_difference(got, want) is None, \
        A._first_difference(got, want)


FILTERED_NAMES = [n for n in _names() if "sha256" in _expected()["files"][n]
                  and not n.startswith("aq_")]


@pytest.mark.parametrize("name", FILTERED_NAMES)
def test_each_stage_equals_dav1ds(name):
    """Deblocking (per-block levels), CDEF and restoration in turn, each
    upscaled where the frame codes superres, against dav1d's planes with
    the later filters off; film grain with `apply_grain` on."""
    lib = _lib()
    data = _frame_data(name)
    seq, f, _ = av1_obu.parse_av1(data, name)
    got = _port_planes(data)
    for k, mask in enumerate((1, 3, 7)):
        want = A._dav1d_planes(lib, data, mask, grain=0)
        assert A._first_difference(got[k], want) is None, \
            (mask, A._first_difference(got[k], want))
    grained = av1_block.add_grain(got[-1], seq, f)
    assert A._first_difference(grained, A._dav1d_planes(lib, data, 7)) \
        is None


def _upscale_by(plane, f, seq, edge, cols=None):
    """A luma upscale with the source clamped at `edge` columns, or a
    tile column at a time (libaom's normative upscale), `cols` its mi
    column starts."""
    down, up = f.width, f.upscaled_width
    if cols is None:
        return av1_superres.upscale_plane(plane, down, up, edge,
                                          seq.bit_depth)
    out, x0 = [], 0
    for c0, c1 in zip(cols, cols[1:]):
        a, b = 4 * c0, min(4 * c1, down)
        w_up = (b * up + down - 1) // down - x0
        part = av1_superres.upscale_plane(plane[:, a:], b - a, w_up,
                                          min(4 * c1, 4 * f.mi_cols) - a,
                                          seq.bit_depth)
        out.append(part)
        x0 += w_up
    return np.concatenate(out, 1)[:, :up]


def test_upscale_clamps_at_the_mi_width_over_whole_rows():
    """Where dav1d's upscale reads its source: clamped at the mi-aligned
    width, not the frame's (a frame 52 wide reads up to column 55), over
    the whole row, not a tile column at a time; each alternative differs
    from dav1d's planes on these files."""
    lib = _lib()
    for name, alt in (("sr_420_d9.avif", "frame edge"),
                      ("sr_tiles_sb128.avif", "tile columns")):
        data = _frame_data(name)
        seq, f, tiles = av1_obu.parse_av1(data, name)
        assert f.width % 8 or alt == "tile columns"
        d = av1_block.FrameDecoder(seq, f, "x")
        for tr, tc, start, end in tiles:
            d.decode_tile(data, start, end, tr, tc)
        want = A._dav1d_planes(lib, data, 0, grain=0)[0]
        plane = d.frame[0][:f.height]
        ours = _upscale_by(plane, f, seq, 4 * f.mi_cols)
        assert np.array_equal(ours[:, :f.upscaled_width], want)
        other = _upscale_by(plane, f, seq, f.width) if alt == "frame edge" \
            else _upscale_by(plane, f, seq, 4 * f.mi_cols,
                             f.mi_col_starts)
        assert f.tile_cols > 1 or alt == "frame edge"
        assert not np.array_equal(other, want), alt


def test_superres_step_and_start_are_dav1ds():
    """resize_step and get_upscale_x0 against values worked by hand from
    dav1d's formulas (C division truncates toward zero)."""
    # 256 -> 512: step 2^13, err 0, x0 = -4095 (not floor's -4096) + 128
    assert av1_superres.step_and_start(256, 512) == (8192, 12417)
    # 8 -> 9: step 131076 // 9, err 4, x0 = -909 + 128 - 2
    assert av1_superres.step_and_start(8, 9) == (14564, 15601)
    for down in range(16, 80):
        for d in range(9, 17):
            up = (down * d + 4) // 8
            step, x0 = av1_superres.step_and_start(down, up)
            assert 0 <= x0 < 1 << 14 and step < 1 << 14


def _sweep(tmp_path, name, seed):
    """Seeded single-bit flips in the file's frame header and tile data:
    each as Pillow decodes it, or refused where Pillow refuses."""
    blob = _read(name)
    m = avif.parse(blob, name)
    data = avif._item_bytes(blob, m, m.primary, name)
    start = blob.find(data)
    first = next(at for typ, _, _, at, _ in av1_obu.obus(data, "x")
                 if typ == _OBU_FRAME)
    r = np.random.RandomState(seed)
    decoded = 0
    for k in range(FLIPS):
        at = start + first + int(r.randint(len(data) - first))
        b = bytearray(blob)
        b[at] ^= 1 << int(r.randint(8))
        p = str(tmp_path / f"f{k}.avif")
        with open(p, "wb") as f:
            f.write(bytes(b))
        pil, port = A._outcome(p)
        if pil is None:
            assert port is None or A._names_an_f6_tool(port), (k, port)
        elif isinstance(port, str):
            assert A._names_an_f6_tool(port), (k, port)
        else:
            assert np.array_equal(pil, port), k
            decoded += 1
    return decoded


@pytest.mark.parametrize("name", ["sr_444_d12.avif",
                                  "dlf_400_multi.avif"])
def test_flip_sweep_as_pillow(tmp_path, name):
    """200 seeded flips over a superres file's and a delta_lf file's
    frame header and tile data: 0 disagreements with Pillow (a flip in
    use_superres, coded_denom, the delta_lf fields or the symbols they
    steer included)."""
    decoded = _sweep(tmp_path, name, len(name))
    assert 40 <= decoded < FLIPS


def test_cli_l3c_codes_a_superres_file_bit_exactly_on_the_cpu(tmp_path):
    from l3c_torch.cli import l3c as l3c_cli
    src = os.path.join(FIXTURES, "sr_narrow_d16.avif")
    coded, back = str(tmp_path / "x.l3c"), str(tmp_path / "x.png")
    zoo = os.path.join(A.ROOT, "models_zoo")
    assert l3c_cli.main([zoo, "0820_0345", "enc", src, coded,
                         "--device", "cpu"]) == 0
    assert l3c_cli.main([zoo, "0820_0345", "dec", coded, back,
                         "--device", "cpu"]) == 0
    assert A._digest(timages.read_png(back)) == \
        _expected()["files"]["sr_narrow_d16.avif"]["sha256"]


def make_tools_fixtures(d=FIXTURES) -> dict:
    os.makedirs(d, exist_ok=True)
    for n in os.listdir(d):
        os.remove(os.path.join(d, n))
    for name, blob in corpus().items():
        with open(os.path.join(d, name), "wb") as f:
            f.write(blob)
    exp = {**tools_expected_now(d), "made_by": A._versions()}
    with open(os.path.join(d, "expected.json"), "w") as f:
        json.dump(exp, f, indent=1, sort_keys=True)
        f.write("\n")
    return exp


if __name__ == "__main__":
    exp = make_tools_fixtures()
    print(f"wrote {len(exp['files'])} fixtures and expected.json to "
          f"{FIXTURES}")
