"""AV1 inter frames in AVIF (l3c_torch/data/av1_inter.py, av1_mvs.py and
the inter half of av1_obu.py and av1_block.py), layered items (`a1op`,
`lsel`, `a1lx`) and dav1d's AVX-512 8-bit transforms past valid
coefficients (av1_recon.SHAPE_8BIT), against Pillow 12.1's AVIF plugin
(libavif 1.3.0, dav1d 1.5.1, aom 3.12.1) and the JAX package's loader.

The fixtures (l3c_torch/data/fixtures/avif_inter, written by
`PYTHONPATH=. python tests/test_torch_port_avif_inter.py`):
- s_: Pillow's save_all sequences of moving pictures (translated,
  rotated and zoomed crops of the synthetic photos), aom steered by
  Pillow's `speed` and `advanced` keys: compound prediction (average,
  distance weights, wedge, difference-weighted), OBMC, local warp,
  inter-intra, dual filters, skip mode, reference and temporal MV
  candidates, segmentation and delta q in inter frames, alpha tracks;
- d_: those sequences at 10 and 12 bits (every sequence header
  rewritten), with superres coded in every frame (a frame coded
  narrower than its upscaled references: scaled prediction), with
  global motion written into the inter frames' headers, with the
  references named by short signaling (set_frame_refs) or under frame
  ids (delta_frame_id), and frames whose tiles are coded again
  (`recode_frame`: a NEARESTMV block read as GLOBALMV under a ROTZOOM
  or AFFINE model, an inter-intra block as a wedge one), branches aom
  does not write here;
- h_: a sequence whose first sample holds all its frames, each hidden
  but the last (an inter frame shown after hidden ones);
- l_: layered items as `avifenc --progressive` writes them: a
  sequence's frames in one item, each OBU with its spatial id, the
  sequence header with operating points, with and without `a1op`,
  `lsel` and `a1lx`, in a colour and alpha item, a grid's cells and a
  track's first sample;
- r_: what Pillow refuses (an inter frame with no reference, or after a
  sequence header of another depth, which empties the slots; a
  reference out of scale; a frame id that fails its delta; short
  signaling with an empty slot);
- f13_: seeded noisy saves whose base_q_idx is raised (their tiles coded
  again to read the same levels), each taking one of the 8-bit
  transform paths SHAPE_8BIT names past valid coefficients;
- coded_inter_512.avif: a 512 x 512 layered still from bench.py's recipe
  pictures (a key frame, then an inter frame that the item shows).
expected.json holds Pillow's format, mode, size and digest of frame 0,
Pillow's seek(k) digest of every sample of a sequence, the inter tools
the port's walk counts in each file, or Pillow's and the port's
refusals. `PYTHONPATH=. python tests/test_torch_port_avif_inter.py f13
FIRST LAST [parent]` runs F13's seeded sweep (`f13_sweep`) over seeds
FIRST to LAST - 1.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import json
import os
import struct
import sys

import numpy as np
import pytest
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from l3c_tpu.data import images as jimages  # noqa: E402
from l3c_torch.data import (av1_block, av1_inter, av1_mvs,  # noqa: E402
                            av1_obu, av1_recon, av1_symbol, avif)
from l3c_torch.data import images as timages  # noqa: E402
import test_torch_port_av1 as V  # noqa: E402
import test_torch_port_avif as A  # noqa: E402
import test_torch_port_avif_deep as D  # noqa: E402
import test_torch_port_avif_hidden as Hd  # noqa: E402
import test_torch_port_avif_seq as S  # noqa: E402
import test_torch_port_avif_tools as T  # noqa: E402

FIXTURES = os.path.join(A.ROOT, "l3c_torch", "data", "fixtures",
                        "avif_inter")
CODED = ("coded_inter_512.avif",)
SWEPT = ("l_two_420.avif", "h_hidden_420.avif")
FLIPS = 80
OBU_SEQ, OBU_FH, OBU_FRAME = 1, 3, 6
TD = bytes([0x12, 0])


# ------------------------------------------------------------- pictures

def panned(h, w, n, seed, dy=2, dx=3):
    """n crops of a photo, each (dy, dx) on from the last."""
    base = A.photo(h + abs(dy) * n, w + abs(dx) * n, seed)
    y0, x0 = max(0, -dy) * n, max(0, -dx) * n
    return [np.ascontiguousarray(base[y0 + k * dy:y0 + k * dy + h,
                                      x0 + k * dx:x0 + k * dx + w])
            for k in range(n)]


def turned(h, w, n, seed, angle=2.0, zoom=1.02):
    """n crops of a photo twice the size, each turned by `angle` degrees
    more, zoomed by `zoom` more and moved on, scaled to h x w."""
    base = Image.fromarray(A.photo(2 * h, 2 * w, seed))
    out = []
    for k in range(n):
        im = base.rotate(angle * k, resample=Image.BICUBIC)
        cw, ch = int(2 * w / zoom ** k) // 2, int(2 * h / zoom ** k) // 2
        x0, y0 = w - cw // 2 + 3 * k, h - ch // 2 + 2 * k
        out.append(np.asarray(im.crop((x0, y0, x0 + cw, y0 + ch)).resize(
            (w, h), Image.BICUBIC)))
    return out


def with_alpha(frames, seed):
    return [np.dstack([f, A.with_alpha(f, seed + k)[..., 3]])
            for k, f in enumerate(frames)]


# the Pillow sequences: name -> (frames, save keys)
SAVES = {
    "s_turn_420": (lambda: turned(96, 128, 5, 1), dict(speed=1)),
    "s_turn6_420": (lambda: turned(96, 128, 6, 1), {}),
    "s_pan_444": (lambda: panned(48, 64, 4, 2),
                  dict(subsampling="4:4:4", quality=70)),
    "s_pan_400": (lambda: panned(48, 64, 4, 3, dy=-1, dx=2),
                  dict(subsampling="4:0:0")),
    "s_seg_420": (lambda: panned(64, 96, 4, 5),
                  dict(advanced={"aq-mode": "1"})),
    "s_deltaq_420": (lambda: panned(64, 96, 4, 6, dy=1, dx=-2),
                     dict(advanced={"deltaq-mode": "2"})),
    "s_rgba_420": (lambda: with_alpha(panned(48, 64, 3, 7), 8),
                   dict(quality=80)),
    "s_three_420": (lambda: panned(56, 48, 3, 3, dy=1, dx=2),
                    dict(quality=60)),
    "s_still_420": (lambda: panned(64, 64, 3, 12, dy=0, dx=0),
                    dict(quality=50)),
    "s_norest_420": (lambda: panned(48, 80, 3, 11, dy=2, dx=-1),
                     dict(advanced={"enable-restoration": "0",
                                    "enable-obmc": "0",
                                    "enable-warped-motion": "0"})),
}


def saves() -> dict:
    """name -> Pillow's sequence saved now (its boxes carry the time it
    was made, so the committed ones are the sources of the rest)."""
    return {n: S.save_all(frames(), **kw) for n, (frames, kw) in
            SAVES.items()}


# ---------------------------------------------------- inter header edits

def samples_of(blob: bytes):
    trak = S.get(S.parse_boxes(blob), b"moov", b"trak")
    return [blob[o:o + n] for o, n in S.track_samples(trak)]


def parsed(samples):
    """Each sample's OBUs [(type, tid, sid, payload, header)] as the
    port reads them through one context: a frame (header) OBU's header
    is (namespace, reads, tile bytes, refs before it) with its reads
    logged (test_torch_port_avif_tools.header_reads), else None."""
    ctx = av1_obu.context()
    out = []
    for data in samples:
        obus = []
        for typ, tid, sid, at, end in av1_obu.obus(data, "x"):
            head = None
            if typ == OBU_SEQ:
                ctx.seq = av1_obu.sequence_header(
                    av1_obu.Bits(data, at, end, "x"))
                head = T.header_reads(av1_obu.sequence_header, data, at,
                                      end)[:2]
            elif typ in (OBU_FRAME, OBU_FH):
                refs = list(ctx.refs)
                f, reads, b = T.header_reads(av1_obu.frame_header, data, at,
                                             end, ctx.seq, refs, tid, sid)
                b.byte_alignment()
                head = (f, reads, data[b.pos:end], refs)
                if not f.show_existing_frame:
                    done = type("F", (), {"frame": f, "seq": ctx.seq})()
                    ctx.refs = [done if (f.refresh >> i) & 1 else r
                                for i, r in enumerate(ctx.refs)]
            obus.append((typ, tid, sid, data[at:end], head))
        out.append(obus)
    return out


def obu(typ, payload, tid=None, sid=0) -> bytes:
    """An OBU with its size, and its extension header where `tid` is
    given."""
    if tid is None:
        return T._obu(typ, payload)
    return bytes([(typ << 3) | 6, (tid << 5) | (sid << 3)]) + \
        D._leb128(len(payload)) + payload


def frame_again(head, seq, over) -> bytes:
    """A frame OBU's payload: its header written again by the port's
    parser with `over`'s reads (test_torch_port_avif_hidden.Writer), its
    tile bytes as they were."""
    f, reads, tiles, refs = head
    _, out = Hd.write(av1_obu.frame_header, reads, over, seq, refs)
    return T.emit(out, False) + tiles


def seq_again(head, over) -> bytes:
    _, out = Hd.write(av1_obu.sequence_header, head[1], over)
    return T.emit(out, True)


def frames_rewritten(blob: bytes, frame_over, seq_edit=None) -> dict:
    """Each sample of a Pillow sequence -> its OBUs with each frame OBU's
    header written again with frame_over(k, namespace) (k counts the
    frames; None keeps it) under the sequence header as seq_edit(reads)
    edits it; the tile bytes kept."""
    samples = samples_of(blob)
    new, k, seq = {}, 0, None
    for data, obus in zip(samples, parsed(samples)):
        out = b""
        for typ, tid, sid, payload, head in obus:
            if typ == OBU_SEQ:
                if seq_edit:
                    reads = [list(r) for r in head[1]]
                    seq_edit(reads)
                    payload = T.emit(reads, True)
                seq = av1_obu.sequence_header(av1_obu.Bits(
                    payload, 0, len(payload), "x"))
            elif typ == OBU_FRAME:
                over = frame_over(k, head[0])
                k += 1
                if over is not None:
                    payload = frame_again(head, seq, over)
            out += obu(typ, payload)
        new[data] = out
    return new


def rewrite_frames(blob: bytes, frame_over, seq_edit=None) -> bytes:
    """The sequence with its samples as frames_rewritten writes them."""
    new = frames_rewritten(blob, frame_over, seq_edit)
    return S.rewrite_samples(blob, lambda d: new[d])


def superres_everywhere(blob: bytes, denom: int) -> bytes:
    """The sequence with superres coded at `denom` in every frame: the
    sequence header's enable_superres and a max_frame_width of the
    upscaled width (frame_width_bits kept), each frame's use_superres and
    coded_denom; av1C, ispe and tkhd as T.seq_set_superres writes them."""
    def samples(up):
        def seq_edit(reads):
            i = T._at(reads, "s.max_width, s.max_height =")
            assert (up - 1).bit_length() <= reads[i][0]
            reads[i][1] = up - 1
            reads[T._at(reads, "s.enable_superres =")][1] = 1

        def over(k, f):
            return {"f.use_superres = b.f(1) if s.enable_superres": 1,
                    "f.superres_denom = b.f(3) + 9": denom - 9}
        new = frames_rewritten(blob, over, seq_edit)
        return lambda d: new[d]
    return T.seq_set_superres(blob, denom, samples)


# a frame's reads written hidden (showable)
HIDDEN = {"f.show_frame = b.f(1)": 0, "f.showable_frame = 0 if": 1}


def hidden_key(refresh: int) -> dict:
    """A shown key frame's reads written hidden, refreshing the slots
    `refresh` names."""
    return {**HIDDEN, "f.error_resilient = 1 if shown_key": 0,
            "f.refresh = 0xFF if shown_key": refresh}


def hidden_first_sample(blob: bytes) -> bytes:
    """The sequence with every frame moved into the first sample, each
    hidden (show_frame 0, showable) but the last; the other samples as
    they were."""
    samples = samples_of(blob)
    frames = [(typ, payload, head) for obus in parsed(samples)
              for typ, _, _, payload, head in obus]
    seq = None
    out = TD
    last = max(i for i, (t, _, _) in enumerate(frames) if t == OBU_FRAME)
    for i, (typ, payload, head) in enumerate(frames):
        if typ == OBU_SEQ:
            if seq is None:
                seq = av1_obu.sequence_header(av1_obu.Bits(
                    payload, 0, len(payload), "x"))
                out += obu(typ, payload)
            continue
        if typ != OBU_FRAME:
            continue
        over = None
        if i != last:
            over = hidden_key(0xFF) if head[0].frame_type == \
                av1_obu.KEY_FRAME else HIDDEN
        out += obu(typ, payload if over is None else frame_again(
            head, seq, over))
    return S.rewrite_samples(blob, lambda d: out if d == samples[0] else d)


# ------------------------------------------- how references are named

def short_refs(blob: bytes, picks=None) -> bytes:
    """The sequence with every inter frame's references written by
    frame_refs_short_signaling: LAST and GOLDEN named (aom's slots, or
    picks[k]'s for frame k), the other five set by set_frame_refs."""
    def over(k, f):
        if f.intra:
            return None
        last, gold = (picks or {}).get(k, (f.ref_frame_idx[0],
                                           f.ref_frame_idx[3]))
        return {"# frame_refs_short_sig": 1,
                "# last_frame_idx, gold": [last, gold]}
    return rewrite_frames(blob, over)


def frame_ids(first: int, lie=None):
    """(frame_over, seq_edit) for frames_rewritten writing frame ids
    (Hd.FRAME_IDS: 8 bits, deltas of 4 bits): frame k's id first + k
    (mod 256), each inter frame's references named by their
    delta_frame_id; with `lie` (frame k, reference i), that delta names
    an id one above its picture's."""
    slots = [None] * 8

    def seq_edit(reads):
        reads[:] = Hd.write(av1_obu.sequence_header, reads, Hd.FRAME_IDS)[1]

    def over(k, f):
        f.frame_id = (first + k) % 256   # the writer checks later deltas
        o = {"f.frame_id = b.f(s.frame_id_length)": f.frame_id}
        if not f.intra:
            deltas = []
            for i, slot in enumerate(f.ref_frame_idx):
                ref = slots[slot]
                if (k, i) == lie:
                    ref.frame_id += 1    # past the writer's own check
                deltas.append((f.frame_id - ref.frame_id) % 256 - 1)
            o["# delta_frame_id"] = deltas
        slots[:] = [f if (f.refresh >> i) & 1 else r
                    for i, r in enumerate(slots)]
        return o
    return over, seq_edit




def one_unit(blob: bytes, frame_over, seq_edit=None, n=2) -> bytes:
    """A still whose item holds the sequence's first n samples, as
    frames_rewritten writes them, in one temporal unit (written without
    reading it back: the port refuses some)."""
    new = frames_rewritten(blob, frame_over, seq_edit)
    datas = [new[d] for d in samples_of(blob)[:n]]
    assert all(d.startswith(TD) for d in datas)
    return still_with(datas[0] + b"".join(d[len(TD):] for d in datas[1:]))


def reference_files(s) -> dict:
    """name -> a function writing a file whose inter frames name their
    references by short signaling or under frame ids, from the
    three-frame 4:2:0 sequence."""
    three = lambda: s["s_three_420"]()  # noqa: E731

    def bad_delta():
        # a hidden key frame, then an inter frame whose delta names an id
        # its LAST picture lacks
        over, seq_edit = frame_ids(254, lie=(1, 0))
        return one_unit(three(), lambda k, f: {**over(k, f), **(
            hidden_key(0xFF) if k == 0 else {})}, seq_edit)

    def empty_slot():
        # a hidden key frame that fills every slot but slot 0, then an
        # inter frame whose short signaling names slot 1 as LAST and
        # GOLDEN: set_frame_refs would fill the other five from slots 3-7
        # (ties go to the highest slot), but dav1d refuses any empty slot
        return one_unit(three(), lambda k, f: hidden_key(0xFE) if k == 0
                        else {"# frame_refs_short_sig": 1,
                              "# last_frame_idx, gold": [1, 1]})
    return {"d_short_refs_420.avif": lambda: short_refs(three()),
            # the third frame's LAST and GOLDEN swapped: other references
            # than aom's, its own pictures
            "d_short_refs_swapped_420.avif": lambda: short_refs(
                three(), {2: (0, 1)}),
            "d_frame_ids_420.avif": lambda: rewrite_frames(
                three(), *frame_ids(254)),
            "r_frame_id_delta_420.avif": bad_delta,
            "r_short_refs_empty_slot_420.avif": empty_slot}


# ------------------------------------------------------- global motion

def _recenter(r: int, v: int) -> int:
    if v > 2 * r:
        return v
    return 2 * (v - r) if v >= r else 2 * (r - v) - 1


def _subexp_reads(v: int, n: int):
    """decode_subexp's reads (k = 3) of v < n: (more bits, bits) lists,
    or None where v falls in its final ns() read."""
    more, bits, i, mk = [], [], 0, 0
    while True:
        b2 = 2 + i if i else 3
        a = 1 << b2
        if n <= mk + 3 * a:
            return None
        if v < mk + a:
            more.append(0)
            bits.append(v - mk)
            return more, bits
        more.append(1)
        i += 1
        mk += a


def gm_reads(params, allow_hp: int):
    """The frame header reads of global motion for LAST_FRAME alone:
    `params` (type, [p0..p5] at the warped model's precision) coded
    against the default parameters (a frame whose primary_ref_frame is
    none, or whose reference has none)."""
    typ, p = params
    is_global = [1] + [0] * 6
    more, bits = [], []
    idx = [2, 3] if typ >= av1_obu.ROTZOOM else []
    idx += [4, 5] if typ == av1_obu.AFFINE else []
    idx += [0, 1] if typ >= av1_obu.TRANSLATION else []
    for i in idx:
        abs_bits, prec_bits = 12, 15
        if i < 2:
            if typ == av1_obu.TRANSLATION:
                abs_bits, prec_bits = 9 - (1 - allow_hp), 3 - (1 - allow_hp)
            else:
                abs_bits, prec_bits = 12, 6
        prec_diff = 16 - prec_bits
        sub = (1 << prec_bits) if i % 3 == 2 else 0
        rnd = (1 << 16) if i % 3 == 2 else 0
        mx = 1 << abs_bits
        r = (av1_obu.DEFAULT_GM[i] >> prec_diff) - sub
        n, ref = 2 * mx + 1, r + mx
        x = ((p[i] - rnd) >> prec_diff) + mx
        assert ((x - mx) << prec_diff) + rnd == p[i], (i, p[i])
        v = _recenter(ref, x) if 2 * ref <= n else \
            _recenter(n - 1 - ref, n - 1 - x)
        m, bb = _subexp_reads(v, n)
        more += m
        bits += bb
    over = {"# is_global": is_global, "# subexp_more_bits": more,
            "# subexp_bits": bits}
    if typ != av1_obu.IDENTITY:
        over["# is_rot_zoom"] = [int(typ == av1_obu.ROTZOOM)]
        if typ != av1_obu.ROTZOOM:
            over["# is_translation"] = [int(typ == av1_obu.TRANSLATION)]
    return over


# each global motion fixture's model for LAST_FRAME: (type, parameters)
GLOBAL = {
    "d_global_translation_420": (av1_obu.TRANSLATION,
                                 [2 << 14, -3 << 14, 1 << 16, 0, 0,
                                  1 << 16]),
    "d_global_rotzoom_420": (av1_obu.ROTZOOM,
                             [-7 << 10, 9 << 10, (1 << 16) + (300 << 1),
                              -(900 << 1), 900 << 1,
                              (1 << 16) + (300 << 1)]),
    "d_global_affine_420": (av1_obu.AFFINE,
                            [5 << 10, 2 << 10, (1 << 16) - (200 << 1),
                             700 << 1, -(500 << 1),
                             (1 << 16) + (100 << 1)]),
}


def with_global(blob: bytes, params) -> bytes:
    """The sequence with the model written into every inter frame's
    header (its tile data kept: the frame reads its symbols against the
    new candidates, as dav1d reads them)."""
    def over(k, f):
        if f.intra:
            return None
        return gm_reads(params, f.allow_high_precision_mv)
    return rewrite_frames(blob, over)


# ------------------------------------------- an inter frame coded again

class _Named(T._Walk):
    """T._Walk whose CDF names follow a frame's CDFs loaded from its
    primary reference frame too."""

    def __enter__(self):
        ctx = super().__enter__()
        fd = av1_block.FrameDecoder
        self.initial = fd._initial_cdfs

        def initial(d):
            c = self.initial(d)
            ctx["names"] = T._cdf_names(c)
            return c
        fd._initial_cdfs = initial
        return ctx

    def __exit__(self, *exc):
        av1_block.FrameDecoder._initial_cdfs = self.initial
        return super().__exit__(*exc)


def recode_frame(blob: bytes, k: int, frame_over, policy) -> bytes:
    """The sequence with its frame k (counting frame OBUs) written again:
    its header with frame_over(namespace)'s reads, its tiles coded again
    (T.Replayer) to read the symbols the source's tiles hold, decoded
    after the frames before it as they are, with `policy`'s changes."""
    samples = samples_of(blob)
    new = frames_rewritten(blob, lambda j, f: frame_over(f) if j == k
                           else None)
    news = [new[d] for d in samples]
    events, made = [], []

    def walk(datas, at_k):
        ctx, j = av1_obu.context(), 0
        for data in datas:
            frames, _ = av1_obu.walk_av1(data, "x", ctx)
            for fr in frames:
                if j == k:
                    return at_k(fr)
                av1_block.decode_walked(fr, "x")
                j += 1

    def record(fr):
        w = _Named()

        class Logged(av1_symbol.SymbolReader):
            def __init__(self, *a):
                super().__init__(*a)
                events.append([])

            def symbol(self, cdf):
                v = super().symbol(cdf)
                events[-1].append(("s", w.ctx["names"].get(id(cdf)), v,
                                   w.ctx["lr"]))
                return v

            def bool(self):
                v = super().bool()
                events[-1].append(("b", None, v, w.ctx["lr"]))
                return v
        w.reader = Logged
        with w:
            av1_block.decode_walked(fr, "x")

    def replay(fr):
        w = _Named()

        def reader(data, start, end, disable):
            made.append(T.Replayer(events[len(made)], policy, disable,
                                   w.ctx))
            return made[-1]
        w.reader = reader
        with w:
            av1_block.decode_walked(fr, "x")
    walk(samples, record)
    walk(news, replay)
    assert all(not r.rest() for r in made)
    coded = [r.enc.done() for r in made]
    out, j = {}, 0
    for data, obus in zip(samples, parsed(news)):
        o = b""
        for typ, tid, sid, payload, head in obus:
            if typ == OBU_FRAME:
                if j == k:
                    f, _, tiles, _ = head
                    payload = payload[:len(payload) - len(tiles)] + \
                        T._tile_group(coded, f.tile_size_bytes)
                j += 1
            o += obu(typ, payload)
        out[data] = o
    return S.rewrite_samples(blob, lambda d: out[d])


class ToGlobal:
    """A recode policy: each NEARESTMV block (zero_mv 1, ref_mv 0) read
    as GLOBALMV (zero_mv 0); the source's motion mode and filter reads,
    which a GLOBALMV block under a ROTZOOM or AFFINE model does not
    make, dropped."""

    DROPPED = ("motion_mode", "obmc", "interp")

    def __init__(self):
        self.converted, self.dropping = 0, False

    def symbol(self, rep, name):
        src = rep.src
        if self.dropping and name not in self.DROPPED:
            while src[rep.at][1] in self.DROPPED:
                del src[rep.at]
            self.dropping = False
        if name == "zero_mv" and src[rep.at][2] == 1 and \
                src[rep.at + 1][1:3] == ("ref_mv", 0):
            del src[rep.at:rep.at + 2]
            self.converted += 1
            self.dropping = True
            return 0
        return None


class WedgeInterIntra:
    """A recode policy: each inter-intra block's wedge_interintra read as
    1, with wedge index `index`."""

    def __init__(self, index):
        self.index, self.converted = index, 0

    def symbol(self, rep, name):
        if name == "wedge_interintra":
            assert rep.src[rep.at][1:3] == ("wedge_interintra", 0)
            del rep.src[rep.at]
            self.converted += 1
            return 1
        if name == "wedge_idx" and rep.src[rep.at][1] != "wedge_idx":
            return self.index
        return None


# --------------------------------------------------------- layered items

def layered(frames, idcs, sids, tds=()) -> bytes:
    """One item's data: a temporal delimiter, the sequence header written
    with the operating points `idcs` (none where empty), then each frame
    OBU of `frames` (payloads, the first a key frame's) with its spatial
    id from `sids` (a temporal delimiter before those in `tds`)."""
    seq_head, payloads = frames
    over = {}
    if idcs:
        lvl = seq_head[0].seq_level_idx[0]
        over = {"cnt = b.f(5) + 1": len(idcs) - 1,
                "s.op_idc.append(b.f(12))": list(idcs),
                "lvl = b.f(5)": [lvl] * len(idcs)}
    out = TD + obu(OBU_SEQ, seq_again(seq_head, over))
    for k, (p, sid) in enumerate(zip(payloads, sids)):
        out += (TD if k in tds else b"") + obu(OBU_FRAME, p, 0, sid)
    return out


def frames_of(blob: bytes, n: int):
    """(the first sample's sequence header as parsed, the frame OBUs'
    payloads of the first n samples)."""
    obus = [o for s in parsed(samples_of(blob)[:n]) for o in s]
    seq = next(head for typ, _, _, _, head in obus if typ == OBU_SEQ)
    return (seq[0], seq[1]), [p for typ, _, _, p, _ in obus
                              if typ == OBU_FRAME]


def _lsel(layer):
    return (b"lsel", struct.pack(">H", layer), True)


def _a1op(op):
    return (b"a1op", bytes([op]), True)


def _a1lx(sizes):
    return (b"a1lx", bytes([0]) + struct.pack(">3H", *sizes), False)


def layer_sizes(data: bytes):
    """The byte count of each layer of a layered item's data: the
    sequence header with the first frame, then each frame."""
    ends = [end for typ, _, _, _, end in av1_obu.obus(data, "x")
            if typ == OBU_FRAME]
    return [b - a for a, b in zip([0] + ends, ends)]


def still_with(data: bytes, props=()) -> bytes:
    """Pillow's 48 x 56 still with its primary item's data replaced by
    `data` and `props` added."""
    f = A.items_of(A.save(A.photo(56, 48, 9), quality=60))
    it = f["items"][f["primary"]]
    it["data"] = data
    it["props"] = list(it["props"]) + list(props)
    return A.mux(f)


def layered_files(s) -> dict:
    """name -> a function writing a layered fixture, from the three-frame
    4:2:0 sequence (frames 0, 1, 2: a key frame, then two inter frames)."""
    three = lambda: frames_of(s["s_three_420"](), 3)  # noqa: E731
    two_ops, three_ops = [0x301, 0x101], [0x701, 0x301, 0x101]
    out = {}

    def item(idcs, sids, props=(), tds=(), cut=False):
        def make():
            fr = three()
            if cut:                    # the third frame's data cut short
                fr = (fr[0], fr[1][:2] + [fr[1][2][:len(fr[1][2]) // 3]])
            n = len(sids)
            data = layered((fr[0], fr[1][:n]), idcs, sids, tds)
            ps = [p(data) if callable(p) else p for p in props]
            return still_with(data, ps)
        return make
    sizes = lambda d: _a1lx(layer_sizes(d)[:-1] + [0] * (  # noqa: E731
        4 - len(layer_sizes(d))))
    out["l_two_420.avif"] = item(two_ops, (0, 1))
    out["l_two_a1op1_420.avif"] = item(two_ops, (0, 1), [_a1op(1)])
    out["l_two_lsel0_420.avif"] = item(two_ops, (0, 1), [_lsel(0)])
    out["l_three_420.avif"] = item(three_ops, (0, 1, 2))
    out["l_three_a1op1_420.avif"] = item(three_ops, (0, 1, 2), [_a1op(1)])
    out["l_three_a1op5_420.avif"] = item(three_ops, (0, 1, 2), [_a1op(5)])
    out["l_three_lsel1_420.avif"] = item(three_ops, (0, 1, 2), [_lsel(1)])
    out["l_three_lselffff_420.avif"] = item(three_ops, (0, 1, 2),
                                            [_lsel(0xFFFF)])
    out["l_three_a1lx_420.avif"] = item(three_ops, (0, 1, 2), [sizes])
    out["l_three_a1lx_lsel1_cut_420.avif"] = item(
        three_ops, (0, 1, 2), [sizes, _lsel(1)], cut=True)
    out["l_three_lsel1_cut_420.avif"] = item(three_ops, (0, 1, 2),
                                             [_lsel(1)], cut=True)
    out["l_three_a1lx_lsel3_420.avif"] = item(three_ops, (0, 1, 2),
                                              [sizes, _lsel(3)])
    out["l_no_ops_420.avif"] = item([], (0, 1))
    out["l_no_ops_lsel1_420.avif"] = item([], (0, 1), [_lsel(1)])
    out["l_temporal_units_420.avif"] = item(two_ops, (0, 1), tds=(1,))
    out["l_two_lsel2_420.avif"] = item(two_ops, (0, 1), [_lsel(2)])
    out["l_same_layer_420.avif"] = item(two_ops, (0, 0))
    out["l_alpha_420.avif"] = lambda: _layered_alpha(s)
    out["l_grid_420.avif"] = lambda: _layered_grid(s)
    out["l_track_420.avif"] = lambda: _layered_track(s)
    return out


def _layered_alpha(s) -> bytes:
    """The RGBA sequence's first two colour frames layered in the colour
    item and its first two alpha frames in the alpha item, each with two
    operating points."""
    blob = s["s_rgba_420"]()
    trak = [n for p, n in S.walk(S.parse_boxes(blob)) if n[0] == b"trak"]
    datas = []
    for t in trak[:2]:
        samples = [blob[o:o + n] for o, n in S.track_samples(t)][:2]
        obus = [o for sm in parsed(samples) for o in sm]
        seq = next(h for typ, _, _, _, h in obus if typ == OBU_SEQ)
        fr = ((seq[0], seq[1]), [p for typ, _, _, p, _ in obus
                                 if typ == OBU_FRAME])
        datas.append(layered(fr, [0x301, 0x101], (0, 1)))
    base = A.save(A.with_alpha(A.photo(48, 64, 9), 10), quality=60)
    f = A.items_of(base)
    m = avif.parse(base, "x")
    f["items"][m.primary]["data"] = datas[0]
    f["items"][avif._alpha_of(m, m.primary)]["data"] = datas[1]
    return A.mux(f)


def _layered_grid(s) -> bytes:
    """The 2 x 2 grid fixture's cells each a two-layer item of the
    segmented sequence's first two frames (one dav1d context for the
    cells: each cell's key frame refreshes every slot)."""
    f = A.items_of(Hd._read_from(A.FIXTURES, "grid_2x2_420.avif"))
    fr = frames_of(s["s_seg_420"](), 2)
    for k, it in f["items"].items():
        if it["type"] == b"av01":
            it["data"] = layered(fr, [0x301, 0x101], (0, 1))
            A.set_ispe(f, k, 96, 64)
    grid = next(k for k, it in f["items"].items() if it["type"] == b"grid")
    f["items"][grid]["data"] = bytes([0, 0, 1, 1]) + struct.pack(
        ">HH", 192, 128)
    A.set_ispe(f, grid, 192, 128)
    return A.mux(f)


def _layered_track(s) -> bytes:
    """The three-frame sequence with its first sample holding the first
    two frames as two layers (operating points in its sequence header);
    libavif's track decode shows the upper layer's inter frame."""
    blob = s["s_three_420"]()
    samples = samples_of(blob)
    data = layered(frames_of(blob, 2), [0x301, 0x101], (0, 1))
    return S.rewrite_samples(blob, lambda d: data if d == samples[0] else d)


# ------------------------------------------------------------- refusals

def refusals(s) -> dict:
    def no_refs():
        # the second sample's inter frame alone after the sequence header
        blob = s["s_three_420"]()
        fr = frames_of(blob, 2)
        data = TD + obu(OBU_SEQ, seq_again(fr[0], {})) + \
            obu(OBU_FRAME, fr[1][1])
        return still_with(data)

    def out_of_scale():
        # the second frame's header coded at a third of its width (its
        # references more than twice its size), layered behind the first
        blob = s["s_three_420"]()

        def over(k, f):
            if k != 1:
                return None
            return {"override = 0 if s.reduced": 1, "# found_ref": [0] * 7,
                    "f.width = b.f(s.frame_width_bits)": f.width // 3 - 1,
                    "f.height = b.f(s.frame_height_bits)": f.height - 1}
        # written past the port's own check, which refuses the header
        check, av1_obu._check_refs = av1_obu._check_refs, lambda *a: None
        try:
            blob = rewrite_frames(blob, over)
            return still_with(layered(frames_of(blob, 2), [0x301, 0x101],
                                      (0, 1)))
        finally:
            av1_obu._check_refs = check
    def new_depth():
        # a 10-bit sequence header between the key frame and the inter
        # frame: dav1d empties the slots, so the inter frame has none
        fr = frames_of(s["s_three_420"](), 2)
        sq = obu(OBU_SEQ, seq_again(fr[0], {}))
        return still_with(TD + sq + obu(OBU_FRAME, fr[1][0]) +
                          D.seq_at_depth(sq, 10)[0] + obu(OBU_FRAME,
                                                          fr[1][1]))
    return {"r_no_reference_420.avif": no_refs,
            "r_reference_emptied_420.avif": new_depth,
            "r_reference_out_of_scale_420.avif": out_of_scale}


# ------------------------------------------------------------------ F13

# name -> (seed of the noisy save whose base_q_idx is raised to 255, the
# (kind, pass, width, height) of SHAPE_8BIT its transforms run)
F13 = {
    "f13_8bit_dct16x32.avif": (28, [("DCT", "col", 16, 32),
                                    ("DCT", "row", 16, 32)]),
    "f13_8bit_dct32x16.avif": (52, [("DCT", "row", 32, 16),
                                    ("DCT", "col", 32, 16)]),
    "f13_8bit_adst16_cols.avif": (16, [("ADST", "col", 16, 16)]),
    "f13_8bit_adst8x16.avif": (53, [("ADST", "col", 8, 16)]),
    "f13_8bit_adst4x16.avif": (248, [("ADST", "col", 4, 16),
                                     ("ADST", "row", 4, 16)]),
    "f13_8bit_adst16x8.avif": (98, [("ADST", "row", 16, 8)]),
    "f13_8bit_adst16x4.avif": (20, [("ADST", "row", 16, 4)]),
    "f13_8bit_dct8x32.avif": (570, [("DCT", "row", 8, 32)]),
    "f13_8bit_dct4x16.avif": (437, [("DCT", "col", 4, 16, "DCT"),
                                    ("DCT", "row", 4, 16, "DCT")]),
}


def f13_derived() -> dict:
    return {name: (lambda seed=seed: Hd.with_q(Hd.noise_save(seed), 255))
            for name, (seed, _) in F13.items()}


def shapes_taken(data: bytes) -> collections.Counter:
    """Each SHAPE_8BIT key whose pass the frame's transforms run with
    inputs whose absolute sum is past 16 bits (where the table's rule can
    act)."""
    R = av1_recon
    got = collections.Counter()
    inverse = R.inverse_transform

    names = {R.DCT: "DCT", R.ADST: "ADST", R.FLIPADST: "ADST",
             R.IDTX: "IDTX"}

    def logged(coef, tx_type, tx_size, w, h, bd=8):
        vk, hk = R.TX_KINDS[tx_type]
        for kind, other, pass_ in ((hk, vk, "row"), (vk, hk, "col")):
            for key in ((names[kind], pass_, w, h, names[other]),
                        (names[kind], pass_, w, h)):
                if bd == 8 and key in R.SHAPE_8BIT and \
                        np.abs(coef).sum() > R.HI:
                    got[key] += 1
                    break
        return inverse(coef, tx_type, tx_size, w, h, bd)
    seq, f, tiles = av1_obu.parse_av1(data, "x")
    R.inverse_transform = logged
    try:
        av1_block.walk_frame(seq, f, tiles, data, "x")
    finally:
        R.inverse_transform = inverse
    return got


# -------------------------------------------------------------- corpus

def coded_512() -> bytes:
    """bench.py's recipe pictures at 512 x 512 (the synthetic photo and
    its crop moved by (5, 7)) saved as a two-frame sequence, then put in
    one item as two layers: the item shows the inter frame."""
    base = A.photo(520, 520, 123)
    seq = S.save_all([base[:512, :512], base[5:517, 7:519]])
    data = layered(frames_of(seq, 2), [0x301, 0x101], (0, 1))
    f = A.items_of(A.save(base[:512, :512]))
    f["items"][f["primary"]]["data"] = data
    return A.mux(f)


def derived(src: dict) -> dict:
    """name -> a function writing the fixture, from the Pillow sequences
    `src` (name -> bytes)."""
    s = {n: (lambda b=b: b) for n, b in src.items()}
    out = {f"{n}.avif": fn for n, fn in s.items()}
    out["d_turn_420_10.avif"] = lambda: S.seq_set_depth(
        s["s_turn_420"](), 10)
    out["d_pan_444_12.avif"] = lambda: S.seq_set_depth(s["s_pan_444"](), 12)
    out["d_superres_420.avif"] = lambda: superres_everywhere(
        s["s_norest_420"](), 12)
    for name, params in GLOBAL.items():
        out[f"{name}.avif"] = lambda params=params: with_global(
            s["s_still_420"](), params)
    # the static sequence's second frame under a ROTZOOM and an AFFINE
    # model, its NEARESTMV block coded again as GLOBALMV (warped); the
    # turned sequence's third frame with its inter-intra block coded
    # again as a wedge one
    for kind in ("rotzoom", "affine"):
        params = GLOBAL[f"d_global_{kind}_420"]
        out[f"d_global_warp_{kind}_420.avif"] = \
            lambda params=params: recode_frame(
                s["s_still_420"](), 1, lambda f, params=params: gm_reads(
                    params, f.allow_high_precision_mv), ToGlobal())
    out["d_wedge_interintra_420.avif"] = lambda: recode_frame(
        s["s_turn_420"](), 2, lambda f: None, WedgeInterIntra(5))
    out["h_hidden_420.avif"] = lambda: hidden_first_sample(
        s["s_pan_400"]())
    out.update(layered_files(s))
    out.update(reference_files(s))
    out.update(refusals(s))
    out.update(f13_derived())
    out[CODED[0]] = coded_512
    return out


# ------------------------------------------------------ tools, counted

# the tools each count names: block-level counts of the port's walk
TOOLS = ("inter", "intra_in_inter", "compound", "compound_wedge",
         "compound_diffwtd", "compound_average", "compound_distance",
         "obmc", "local_warp", "interintra", "interintra_wedge",
         "dual_filter", "switchable_filter", "skip_mode", "temporal_mv",
         "global_motion", "global_warp", "scaled", "segmentation",
         "delta_q", "lf_deltas", "hidden", "high_bitdepth")


def count_tools(walk):
    """The inter tools `walk()` (a decode) reaches, counted by wrapping the
    port's FrameDecoder (each block's mode info, each global warp of a
    plane block) and its temporal MV candidates (those that add to or
    weigh up the stack)."""
    c = collections.Counter()
    Fd = av1_block.FrameDecoder
    saved = (Fd._inter_block_info, Fd._intra_info, av1_mvs._temporal,
             Fd._warp_of)
    names = {av1_inter.COMPOUND_WEDGE: "compound_wedge",
             av1_inter.COMPOUND_DIFFWTD: "compound_diffwtd",
             av1_inter.COMPOUND_AVERAGE: "compound_average",
             av1_inter.COMPOUND_DISTANCE: "compound_distance"}

    def inter_info(self, b):
        saved[0](self, b)
        f = self.f
        c["inter"] += 1
        if b.ref_frame[1] > 0:
            c["compound"] += 1
            c[names.get(b.compound_type, "compound")] += 1
        c["obmc"] += b.motion_mode == av1_block.OBMC
        c["local_warp"] += b.motion_mode == av1_block.LOCALWARP
        if b.interintra:
            c["interintra"] += 1
            c["interintra_wedge"] += bool(b.wedge_ii)
        c["dual_filter"] += b.interp[0] != b.interp[1]
        c["switchable_filter"] += f.interpolation_filter == 4
        c["skip_mode"] += bool(b.skip_mode)
        c["global_motion"] += b.y_mode in (av1_block.GLOBALMV,
                                           av1_block.GLOBAL_GLOBALMV) and \
            any(f.gm_type[r] > 0 for r in b.ref_frame if r > 0)
        c["segmentation"] += bool(f.seg_enabled)
        c["delta_q"] += bool(f.delta_q_present)
        c["lf_deltas"] += bool(f.lf_delta_enabled)
        c["hidden"] += not f.show_frame
        c["high_bitdepth"] += self.bd > 8
        c["scaled"] += any(self.scales[r] != (1 << 14, 1 << 14)
                           for r in b.ref_frame if r > 0)

    def intra_info(self, b):
        saved[1](self, b)
        c["intra_in_inter"] += not self.f.intra

    def warp_of(self, b, ref, w, h):
        out = saved[3](self, b, ref, w, h)
        c["global_warp"] += out is not None and \
            b.motion_mode != av1_block.LOCALWARP
        return out

    def temporal(d, b, st, dr, dc, first):
        n = len(st.mvs), list(st.weights)
        out = saved[2](d, b, st, dr, dc, first)
        c["temporal_mv"] += (len(st.mvs), list(st.weights)) != n
        return out
    Fd._inter_block_info, Fd._intra_info = inter_info, intra_info
    av1_mvs._temporal, Fd._warp_of = temporal, warp_of
    try:
        walk()
    finally:
        Fd._inter_block_info, Fd._intra_info, av1_mvs._temporal, \
            Fd._warp_of = saved
    return {k: c[k] for k in TOOLS if c[k]}


def seek_digests(p):
    """Pillow's digest of each frame (seek(k), convert("RGB")), up to
    "refused" where it refuses one."""
    out = []
    with Image.open(p) as im:
        for k in range(getattr(im, "n_frames", 1)):
            try:
                im.seek(k)
                out.append(A._digest(np.asarray(im.convert("RGB"))))
            except (OSError, RuntimeError, ValueError):
                return out + ["refused"]
    return out


def port_frames(p):
    """The port's digest of each frame (avif.sequence_frames), up to
    "refused" where it refuses one."""
    with open(p, "rb") as f:
        blob = f.read()
    out = []
    try:
        for x in avif.sequence_frames(blob, p):
            out.append(A._digest(x))
    except ValueError:
        out.append("refused")
    return out


def inter_expected_now(folder=FIXTURES) -> dict:
    """Each file's format, mode, size and digest of frame 0 as Pillow and
    the JAX package give them, every frame's seek(k) digest, the tools
    the port's walk of every frame counts; where Pillow refuses,
    Pillow's reason ("pillow") and the port's ("port")."""
    files = {}
    for n in sorted(os.listdir(folder)):
        if n == "expected.json":
            continue
        p = os.path.join(folder, n)
        got, meta = D._pillow(p)
        if meta is None:
            files[n] = {"pillow": got, "port": D._port_refusal(p)}
            continue
        e = {"format": meta[0], "mode": meta[1], "size": meta[2],
             "sha256": A._digest(jimages.load_image_uint8(p))}
        if n not in CODED:
            e["frames"] = seek_digests(p)
            e["tools"] = count_tools(lambda: port_frames(p))
        files[n] = e
    return {"files": files, "coded": list(CODED)}


def _expected():
    with open(os.path.join(FIXTURES, "expected.json")) as f:
        return json.load(f)


def _names():
    if not os.path.exists(os.path.join(FIXTURES, "expected.json")):
        return []                     # before the maker's first run
    return sorted(_expected()["files"])


def _read(name):
    return Hd._read_from(FIXTURES, name)


# ------------------------------------------------------------- the tests

# the layered fixtures: the frame of the three-frame sequence each shows
# (its seek(k)), or None where Pillow refuses it
LAYERED = {"l_two_420.avif": 1, "l_two_a1op1_420.avif": 0,
           "l_two_lsel0_420.avif": 0, "l_three_420.avif": 2,
           "l_three_a1op1_420.avif": 1, "l_three_a1op5_420.avif": 2,
           "l_three_lsel1_420.avif": 1, "l_three_lselffff_420.avif": 2,
           "l_three_a1lx_420.avif": 2,
           "l_three_a1lx_lsel1_cut_420.avif": 1,
           "l_three_lsel1_cut_420.avif": None,
           "l_three_a1lx_lsel3_420.avif": None, "l_no_ops_420.avif": 0,
           "l_no_ops_lsel1_420.avif": 1, "l_temporal_units_420.avif": 0,
           "l_two_lsel2_420.avif": None, "l_same_layer_420.avif": 1}
# the tools a sequence of three or more frames must reach
REQUIRED = ("compound", "obmc", "local_warp", "temporal_mv",
            "segmentation", "lf_deltas", "interintra", "compound_wedge",
            "compound_diffwtd", "compound_distance", "dual_filter",
            "skip_mode", "scaled", "hidden", "global_warp",
            "interintra_wedge",
            "high_bitdepth", "intra_in_inter", "delta_q")


def _data(name):
    """The AV1 data Pillow's decode of frame 0 starts from: the primary
    item's, or the first sample's."""
    blob = _read(name)
    m = avif.parse(blob, name)
    if m.source == "tracks":
        off, size = m.seq.samples[0]
        return blob[off:off + size]
    return avif._item_bytes(blob, m, m.primary, name)


def test_inter_fixtures_are_their_sources_rewritten():
    """Every fixture is remade byte for byte from the committed Pillow
    sequences (their boxes carry the time they were made), whose AV1 data
    is what aom writes now; what expected.json records of Pillow (format,
    mode, size, frame 0's digest by the JAX loader, every frame's seek(k)
    digest, the refusals) is what Pillow gives now."""
    src = {n: _read(n + ".avif") for n in SAVES}
    for n, blob in saves().items():
        assert samples_of(blob) == samples_of(src[n]), n
    made = derived(src)
    assert sorted(made) == _names()
    for name, fn in made.items():
        assert fn() == _read(name), name
    want = _expected()
    for n, e in want["files"].items():
        p = os.path.join(FIXTURES, n)
        got, meta = D._pillow(p)
        if meta is None:
            assert e["pillow"] == got, n
            continue
        assert [e["format"], e["mode"], e["size"]] == list(meta), n
        assert e["sha256"] == A._digest(jimages.load_image_uint8(p)), n
        if n not in CODED:
            assert e["frames"] == seek_digests(p), n
    assert want["coded"] == list(CODED)
    assert want["made_by"]["libavif"] == "1.3.0"
    assert sum(os.path.getsize(os.path.join(FIXTURES, n))
               for n in os.listdir(FIXTURES)) < 250_000


@pytest.mark.parametrize("name", _names())
def test_port_reads_each_inter_fixture_as_expected(name):
    """Frame 0 through the loader: Pillow's format, mode, size and digest
    and the JAX loader's pixels; where Pillow refuses the file, the
    port's refusal as recorded."""
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


def _sequences():
    seq = [("avif_seq", n) for n, e in sorted(S._expected()["files"].items())
           if "sha256" in e and n not in S.CODED]
    return seq + [("avif_inter", n) for n in _names()
                  if "frames" in _expected()["files"][n]]


@pytest.mark.parametrize("folder, name", _sequences())
def test_every_frame_equals_pillows_seek(folder, name):
    """Every sample of every sequence (and an item's one frame), decoded
    in order through one dav1d context a track (avif.sequence_frames), is
    Pillow's seek(k) digest, up to the frame Pillow refuses; for
    avif_inter, with the inter tools the port's walk counts as
    recorded."""
    if folder == "avif_seq":
        p = os.path.join(S.FIXTURES, name)
        assert port_frames(p) == seek_digests(p)
        return
    p = os.path.join(FIXTURES, name)
    e = _expected()["files"][name]
    got = []
    tools = count_tools(lambda: got.extend(port_frames(p)))
    assert got == e["frames"]
    assert tools == e["tools"]


def test_sequences_reach_every_inter_tool():
    """Each tool REQUIRED names is reached in a sequence of three or more
    frames held to Pillow frame by frame (the counts recorded are held
    by test_every_frame_equals_pillows_seek)."""
    files = _expected()["files"]
    reached = collections.Counter()
    for n, e in files.items():
        if len(e.get("frames", ())) >= 3 and "refused" not in e["frames"]:
            reached.update(e["tools"])
    assert [t for t in REQUIRED if not reached[t]] == []
    assert files["s_turn_420.avif"]["tools"]["temporal_mv"] > 0
    assert files["d_superres_420.avif"]["tools"]["scaled"] == \
        files["d_superres_420.avif"]["tools"]["inter"]


def test_layered_items_show_the_frame_pillow_shows():
    """Each layered item shows what LAYERED says: with operating points
    and no lsel, the frame of the operating point's highest spatial layer
    (a1op choosing the point; one out of range is point 0); with lsel,
    the first frame of that layer (a1lx cutting the data after it, or
    refused when it names a layer a1lx does not have); without operating
    points, or with a temporal unit ending first, the first frame shown.
    The port decodes each to that digest (test_port_reads_each_...)."""
    files = _expected()["files"]
    src = files["s_three_420.avif"]["frames"]
    for name, k in LAYERED.items():
        e = files[name]
        if k is None:
            assert "pillow" in e, name
        else:
            assert e["sha256"] == src[k], name
    assert "lsel property requests layer index [3]" in files[
        "l_three_a1lx_lsel3_420.avif"]["port"]
    for name in ("l_alpha_420.avif", "l_grid_420.avif", "l_track_420.avif"):
        assert "sha256" in files[name], name
    # the track's first sample: two layers, the inter frame shown
    assert files["l_track_420.avif"]["frames"][0] == src[1]


def test_each_fixture_is_what_its_name_says():
    """The rewrites hold what they are named for: hidden frames before
    the one shown, global motion of each type in the inter frames'
    headers (moving what the static sequence's frame shows), superres
    in every frame, 10 and 12 bits, references named by short signaling
    and frame ids; the refusals are dav1d's own."""
    files = _expected()["files"]
    frames, shown = av1_obu.walk_av1(_data("h_hidden_420.avif"), "x",
                                     av1_obu.context())
    assert len(frames) == 4 and shown is frames[-1]
    assert [fr.frame.show_frame for fr in frames] == [0, 0, 0, 1]
    assert shown.frame.frame_type == av1_obu.INTER_FRAME
    assert files["h_hidden_420.avif"]["sha256"] == \
        files["s_pan_400.avif"]["frames"][3]
    for name, (typ, params) in GLOBAL.items():
        hs = [o[4][0] for smp in parsed(samples_of(_read(name + ".avif")))
              for o in smp if o[0] == OBU_FRAME]
        assert [h.gm_type[1] for h in hs] == [0] + [typ] * (len(hs) - 1)
        assert all(h.gm_params[1] == params for h in hs[1:]), name
        # the model moves the static sequence's second frame (its blocks
        # take the global candidates)
        assert files[name + ".avif"]["frames"][1] != \
            files["s_still_420.avif"]["frames"][1], name
    for name, depth in (("d_turn_420_10.avif", 10), ("d_pan_444_12.avif",
                                                      12)):
        assert av1_obu.parse_av1(_data(name), "x")[0].bit_depth == depth
    for typ, _, _, payload, head in parsed(samples_of(_read(
            "d_superres_420.avif")))[1]:
        if typ == OBU_FRAME:
            f = head[0]
            assert f.use_superres and f.width < f.upscaled_width
    for name in ("r_no_reference_420.avif", "r_reference_emptied_420.avif"):
        assert "no reference frame" in files[name]["port"], name
    assert "out of scale" in files[
        "r_reference_out_of_scale_420.avif"]["port"]
    # references named by short signaling (aom's LAST and GOLDEN: the
    # pictures of aom's references; the third frame's swapped: others)
    # and under frame ids (254, 255, 0: deltas across the wrap)
    src = files["s_three_420.avif"]["frames"]
    heads = {n: [o[4] for smp in parsed(samples_of(_read(n))) for o in smp
                 if o[0] == OBU_FRAME] for n in (
        "s_three_420.avif", "d_short_refs_420.avif",
        "d_short_refs_swapped_420.avif", "d_frame_ids_420.avif")}
    for name in ("d_short_refs_420.avif", "d_short_refs_swapped_420.avif"):
        assert [any(v == 1 and "# frame_refs_short_sig" in line
                    for _, v, line in h[1]) for h in heads[name]] == \
            [False, True, True], name
    assert files["d_short_refs_420.avif"]["frames"] == src
    aom, swapped = (heads[n][2][0] for n in (
        "s_three_420.avif", "d_short_refs_swapped_420.avif"))
    assert (swapped.ref_frame_idx[0], swapped.ref_frame_idx[3]) == (
        aom.ref_frame_idx[3], aom.ref_frame_idx[0]) == (0, 1)
    assert files["d_short_refs_swapped_420.avif"]["frames"][:2] == src[:2]
    assert files["d_short_refs_swapped_420.avif"]["frames"][2] != src[2]
    assert [h[0].frame_id for h in heads["d_frame_ids_420.avif"]] == \
        [254, 255, 0]
    assert files["d_frame_ids_420.avif"]["frames"] == src
    assert "fails its delta_frame_id" in files[
        "r_frame_id_delta_420.avif"]["port"]
    assert "short signaling meets an empty slot" in files[
        "r_short_refs_empty_slot_420.avif"]["port"]


def _unfiltered():
    """The port's in-loop filters and superres off (a frame's planes its
    reconstruction, cropped), as dav1d's with inloop_filters 0."""
    def crop(d, seq, frame, stages=None, times=None):
        h, w = frame.height, frame.upscaled_width
        out = [d.frame[0][:h, :w]]
        if seq.num_planes > 1:
            ch, cw = (h + seq.ssy) >> seq.ssy, (w + seq.ssx) >> seq.ssx
            out += [d.frame[1][:ch, :cw], d.frame[2][:ch, :cw]]
        t = np.uint8 if seq.bit_depth == 8 else np.uint16
        return [o.astype(t) for o in out]
    return crop


@pytest.mark.parametrize("name", ["s_turn_420.avif", "d_pan_444_12.avif",
                                  "d_global_rotzoom_420.avif"])
def test_unfiltered_frames_equal_dav1ds(name, monkeypatch):
    """Every frame's prediction and residual before the in-loop filters
    (references unfiltered too), against dav1d's planes with its filters
    off: a fault in prediction shows as the first plane and 4 x 4 block
    that differ, before deblocking, CDEF or restoration can hide or
    spread it."""
    path = A.libavif()
    if path is None:
        pytest.skip("this Pillow bundles no libavif")
    samples = samples_of(_read(name))
    want = A._dav1d_pictures(ctypes.CDLL(path), samples, 0)
    monkeypatch.setattr(av1_block, "filter_frame", _unfiltered())
    ctx = av1_obu.context()
    for k, data in enumerate(samples):
        frames, shown = av1_obu.walk_av1(data, name, ctx)
        for fr in frames:
            av1_block.decode_walked(fr, name)
        got = av1_block.planes_of(shown)
        assert A._first_difference(got, want[k]) is None, \
            (k, A._first_difference(got, want[k]))


@functools.lru_cache(maxsize=1)
def _library_tables():
    path = V.libavif()
    if path is None:
        return None
    with open(path, "rb") as f:
        return V.tables_from(f.read())


@pytest.mark.parametrize("name", V.INTER_CDFS + V.INTER_PLAIN)
def test_inter_table_is_the_bundled_librarys(name):
    """Each table inter prediction added (the inter CDFs; dav1d's subpel
    and warp filters and OBMC masks; aom's division LUT, wedge master
    lines and codebooks, inter-intra weights, distance weights and MV
    projection multipliers) is the bundled library's bytes, found by its
    leading values."""
    got = _library_tables()
    if got is None:
        pytest.skip("this Pillow bundles no libavif")
    from l3c_torch.data import av1_tables
    if name in V.INTER_CDFS:
        assert got["CDFS"][name] == av1_tables.CDFS[name]
    else:
        assert got[name] == tuple(getattr(av1_tables, name))


def _sweep(tmp_path, name, seed):
    """Seeded single-bit flips in the AV1 data of frame 0: each as Pillow
    decodes it, or refused where Pillow refuses."""
    blob = _read(name)
    data = _data(name)
    start = blob.find(data)
    r = np.random.RandomState(seed)
    decoded = 0
    for k in range(FLIPS):
        at = start + int(r.randint(len(data)))
        b = bytearray(blob)
        b[at] ^= 1 << int(r.randint(8))
        p = str(tmp_path / f"f{k}.avif")
        with open(p, "wb") as f:
            f.write(bytes(b))
        pil, port = A._outcome(p)
        assert not isinstance(port, str), (k, port)   # none by name
        if pil is None:
            assert port is None, k
        else:
            assert np.array_equal(pil, port), k
            decoded += 1
    return decoded


@pytest.mark.parametrize("name", SWEPT)
def test_flip_sweep_as_pillow(tmp_path, name):
    """Seeded flips over two inter files' AV1 data (a two-layer item: a
    key frame and the inter frame it shows; a track's first sample of
    three hidden frames and a shown inter frame): 0 disagreements with
    Pillow."""
    decoded = _sweep(tmp_path, name, len(name) + 29)
    assert 10 <= decoded < FLIPS


@pytest.mark.parametrize("name", sorted(F13))
def test_f13_file_takes_its_path_and_decodes_as_pillow(name):
    """Each f13_ file runs the rectangular or column passes its name says
    (SHAPE_8BIT) with inputs past 16 bits, and decodes to Pillow's
    digest (dav1d's AVX-512 code, which Pillow runs on this host)."""
    taken = shapes_taken(_data(name))
    for key in F13[name][1]:
        assert taken[key] > 0, (key, dict(taken))
    got = timages.load_image_uint8(os.path.join(FIXTURES, name))
    assert A._digest(got) == _expected()["files"][name]["sha256"]


def test_recoded_inter_frame_is_its_source_byte_for_byte():
    """recode_frame with nothing changed writes the sequence back byte
    for byte (the range encoder and the replayed reads are exact on an
    inter frame decoded after the frames before it)."""
    blob = _read("s_turn_420.avif")
    assert recode_frame(blob, 2, lambda f: None, None) == blob


def test_walk_carries_each_frames_references():
    """An inter frame decodes from the slots the frames before it left
    in the context: the second sample alone has no reference (refused as
    dav1d refuses it); after the first, every slot holds a frame and the
    second is shown."""
    samples = samples_of(_read("s_three_420.avif"))
    seq = av1_obu.parse_av1(samples[0], "x")[0]
    with pytest.raises(ValueError, match="no reference frame"):
        av1_obu.walk_av1(samples[1], "x", av1_obu.context(seq))
    ctx = av1_obu.context()
    av1_obu.walk_av1(samples[0], "x", ctx)
    frames, shown = av1_obu.walk_av1(samples[1], "x", ctx)
    assert shown.frame.frame_type == av1_obu.INTER_FRAME
    assert all(r is not None for r in ctx.refs)


def test_cli_l3c_codes_an_inter_frame_file_bit_exactly_on_the_cpu(
        tmp_path):
    """cli.l3c enc / dec of a layered item that shows an inter frame
    (48 x 56: the 512 x 512 one is coded on the card by chip_smoke)."""
    from l3c_torch.cli import l3c as l3c_cli
    src = os.path.join(FIXTURES, "l_two_420.avif")
    coded, back = str(tmp_path / "x.l3c"), str(tmp_path / "x.png")
    zoo = os.path.join(A.ROOT, "models_zoo")
    assert l3c_cli.main([zoo, "0820_0345", "enc", src, coded,
                         "--device", "cpu"]) == 0
    assert l3c_cli.main([zoo, "0820_0345", "dec", coded, back,
                         "--device", "cpu"]) == 0
    assert A._digest(timages.read_png(back)) == \
        _expected()["files"]["l_two_420.avif"]["sha256"]


def make_inter_fixtures(d=FIXTURES) -> dict:
    os.makedirs(d, exist_ok=True)
    for n in os.listdir(d):
        os.remove(os.path.join(d, n))
    for name, fn in derived(saves()).items():
        with open(os.path.join(d, name), "wb") as f:
            f.write(fn())
    exp = {**inter_expected_now(d), "made_by": {
        **A._versions(), "cpu_flags": Hd._cpu_flags()}}
    with open(os.path.join(d, "expected.json"), "w") as f:
        json.dump(exp, f, indent=1, sort_keys=True)
        f.write("\n")
    return exp


def f13_sweep(seeds, shapes=True):
    """The seeded sweep F13's tables were found and held out on: each
    seed's noisy save with base_q_idx raised to 255 (seeds whose tiles
    the test-only re-encoder cannot code again at that q are skipped),
    kept where an 8-bit pass's rotations leave 16 bits, its decoded
    planes against dav1d's (this host's, the code its CPU picks). With
    `shapes` False, SHAPE_8BIT is left out (the tables before it).
    Returns (saves that overflow, those equal to dav1d's)."""
    lib = ctypes.CDLL(A.libavif())
    table = dict(av1_recon.SHAPE_8BIT)
    if not shapes:
        av1_recon.SHAPE_8BIT.clear()
    over = same = 0
    try:
        for seed in seeds:
            try:
                blob = Hd.with_q(Hd.noise_save(seed), 255)
            except AssertionError:          # the re-encoder's limits
                continue
            m = avif.parse(blob, "x")
            data = avif._item_bytes(blob, m, m.primary, "x")
            planes, hits = Hd.branches(data)
            if not any(k[0] == 8 and k[-1] == "past 16 bits" for k in hits):
                continue
            over += 1
            same += all(np.array_equal(a, b) for a, b in zip(
                planes, A._dav1d_planes(lib, data, 7)))
    finally:
        av1_recon.SHAPE_8BIT.update(table)
    return over, same


if __name__ == "__main__":
    if sys.argv[1:2] == ["f13"]:
        # python tests/test_torch_port_avif_inter.py f13 FIRST LAST [parent]
        lo, hi = int(sys.argv[2]), int(sys.argv[3])
        n, ok = f13_sweep(range(lo, hi), sys.argv[4:5] != ["parent"])
        print(f"seeds {lo}-{hi - 1}: {ok} of {n} overflowing saves equal "
              f"dav1d's planes")
    else:
        exp = make_inter_fixtures()
        print(f"wrote {len(exp['files'])} fixtures and expected.json to "
              f"{FIXTURES}")
