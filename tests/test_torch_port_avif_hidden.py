"""AVIF frames shown through show_existing_frame (hidden frames kept in
dav1d's reference slots, l3c_torch/data/av1_obu.walk_av1) and dav1d's
deep transforms past valid coefficients (l3c_torch/data/av1_recon.py),
against Pillow 12.1's AVIF plugin (libavif 1.3.0, dav1d 1.5.1) and the
JAX package's loader.

No writer here makes a hidden frame, so the fixtures
(l3c_torch/data/fixtures/avif_hidden, written by `PYTHONPATH=. python
tests/test_torch_port_avif_hidden.py`) are Pillow's files rewritten:
- each source frame's header reads are logged and the header written
  again by the port's own parser (`Writer`), with the reads it asks for
  that the source lacks given here: a reduced still's sequence header
  written out in full, a frame made hidden (show_frame 0, showable_frame,
  error_resilient_mode, refresh_frame_flags, ref_order_hint), frame ids,
  and show_existing_frame headers of a slot;
- two saves whose sequence headers agree where their tile data reads
  them are spliced behind one sequence header, their tile data copied
  byte for byte;
- the f11_ files are saves whose base_q_idx is raised, their tiles coded
  again (test_torch_port_avif_tools.reencode) so that they read the same
  levels: each levels' dequantized values then run a transform pass past
  what a valid stream reaches.
What Pillow did with each rewrite settled the port's rules: dav1d
decodes every frame of the data handed to it (a damaged frame after the
one shown fails the file too), shows the first frame shown, keeps its
slots across a grid's cells unless a sequence header differs, shows a
slot whatever its showable_frame, refuses an empty slot, a frame id that
differs, a frame OBU with show_existing_frame and data that shows
nothing, and takes an intra-only frame that refreshes every slot;
libavif refuses a track whose first sample shows nothing.
"""
from __future__ import annotations

import collections
import io
import json
import linecache
import os
import sys

import numpy as np
import pytest
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from l3c_tpu.data import images as jimages  # noqa: E402
from l3c_torch.data import av1_obu, av1_recon, avif  # noqa: E402
from l3c_torch.data import images as timages  # noqa: E402
import test_torch_port_avif as A  # noqa: E402
import test_torch_port_avif_deep as D  # noqa: E402
import test_torch_port_avif_seq as S  # noqa: E402
import test_torch_port_avif_tools as T  # noqa: E402

FIXTURES = os.path.join(A.ROOT, "l3c_torch", "data", "fixtures",
                        "avif_hidden")
CODED = ("h_coded_512.avif",)
SWEPT = ("h_two_show2.avif", "h_ids_match.avif")
FLIPS = 200
OBU_SEQ, OBU_FH, OBU_FRAME = 1, 3, 6
TD = bytes([0x12, 0])                   # a temporal delimiter OBU


# --------------------------------------------------------- header writer

_SKIP = ("su", "ns", "_delta_q", "_cdef_strength", "_points")


def _line(fr) -> str:
    own = av1_obu.__file__
    while fr.f_code.co_filename == own and fr.f_code.co_name in _SKIP:
        fr = fr.f_back
    return linecache.getline(fr.f_code.co_filename, fr.f_lineno).strip()


class Writer(av1_obu.Bits):
    """A header written by the port's parser instead of read: a read takes
    the value of the first key of `over` in its source line (a list gives
    its values in turn), else the source header's next read at the same
    line (`src`, test_torch_port_avif_tools.header_reads' list); the reads
    made are kept in `out`."""

    def __init__(self, src, over):
        super().__init__(b"", 0, 1 << 20, "x")
        self.queue = {}
        for _, v, line in src:
            self.queue.setdefault(line, []).append(v)
        self.over = {k: list(v) if isinstance(v, list) else v
                     for k, v in over.items()}
        self.out = []

    def f(self, n):
        line = _line(sys._getframe(1))
        key = next((k for k in self.over if k in line), None)
        if key is None:
            v = self.queue[line].pop(0)
        else:
            v = self.over[key]
            v = v.pop(0) if isinstance(v, list) else v
        self.out.append([n, v, line])
        self.bit += n
        return v


def write(parse, src, over, *args):
    """(parse's result, the reads written)."""
    w = Writer(src, over)
    return parse(w, *args), w.out


# the reads a reduced still's sequence header lacks, written as what the
# reduced header implied: no timing info, one operating point, no frame
# ids, no order hints, screen content tools and integer MVs per frame
UNREDUCE = {"s.reduced = b.f(1)": 0, "timing = b.f(1)": 0,
            "delay_present = b.f(1)": 0, "cnt = b.f(5) + 1": 0,
            "s.op_idc.append(b.f(12))": 0,
            "s.frame_id_numbers = 0 if s.reduced": 0,
            "# interintra, masked compound": 0,
            "s.enable_order_hint = b.f(1)": 0,
            "s.force_screen_content_tools = SELECT if": 1,
            "s.force_integer_mv = SELECT if": 1}
ORDER_HINTS = {"s.enable_order_hint = b.f(1)": 1,
               "# jnt_comp, ref_frame_mvs": 0,
               "s.order_hint_bits = b.f(3) + 1": 6}
FRAME_IDS = {"s.frame_id_numbers = 0 if s.reduced": 1,
             "s.delta_frame_id_length = b.f(4) + 2": 2,
             "s.frame_id_length = b.f(3) + 1": 3}
# what the tile data reads of the sequence header: two frames spliced
# behind one header must agree on these
TILE_FIELDS = ("sb128", "enable_filter_intra", "enable_intra_edge_filter",
               "enable_cdef", "enable_restoration", "enable_superres",
               "bit_depth", "mono", "ssx", "ssy", "separate_uv_delta_q",
               "film_grain_present", "force_screen_content_tools",
               "force_integer_mv", "max_width", "max_height")


class Frame:
    """One still's or sample's frame: its sequence header's reads and
    namespace, its frame header's reads, and its tile bytes."""

    def __init__(self, data: bytes):
        for typ, _, _, at, end in av1_obu.obus(data, "x"):
            if typ == OBU_SEQ:
                self.seq, self.sreads, _ = T.header_reads(
                    av1_obu.sequence_header, data, at, end)
            elif typ == OBU_FRAME:
                self.f, self.freads, b = T.header_reads(
                    av1_obu.frame_header, data, at, end, self.seq)
                b.byte_alignment()
                self.tiles = data[b.pos:end]

    def seq_obu(self, **over):
        """The sequence header OBU written again (a reduced one in full)
        with `over`'s reads, and its namespace."""
        o = dict(UNREDUCE, **{"lvl = b.f(5)": self.seq.seq_level_idx[0]}) \
            if self.seq.reduced else {}
        o.update(over)
        s, reads = write(av1_obu.sequence_header, self.sreads, o)
        return T._obu(OBU_SEQ, T.emit(reads, True)), s

    def frame_obu(self, seq, **over):
        """A frame OBU: the header written under `seq` (a shown key frame
        unless `over` says otherwise), the tile bytes as they were."""
        assert all(getattr(seq, k) == getattr(self.seq, k)
                   for k in TILE_FIELDS), [k for k in TILE_FIELDS if getattr(
                       seq, k) != getattr(self.seq, k)]
        o = {"f.show_existing_frame = b.f(1)": 0, "f.frame_type = b.f(2)": 0,
             "f.show_frame = b.f(1)": 1, "override = 0 if s.reduced": 0,
             "# disable_frame_end_update_cdf": 1, "# ref_order_hint": 0,
             "f.frame_id = b.f(": 0, "b.f(s.order_hint_bits)": 0}
        o.update(over)
        _, reads = write(av1_obu.frame_header, self.freads, o, seq)
        return T._obu(OBU_FRAME, T.emit(reads, False) + self.tiles)


def hidden(slots, showable=1, resilient=0, intra_only=False, frame_id=0):
    """A frame header's reads that hide the frame in `slots` (a mask)."""
    return {"f.frame_type = b.f(2)": 2 if intra_only else 0,
            "f.show_frame = b.f(1)": 0, "f.showable_frame = 0 if": showable,
            "f.error_resilient = 1 if shown_key": resilient,
            "f.refresh = 0xFF if shown_key": slots,
            "f.frame_id = b.f(": frame_id}


def show(seq, slot, frame_id=0, typ=OBU_FH) -> bytes:
    """A frame header OBU with show_existing_frame of `slot`."""
    _, reads = write(av1_obu.frame_header, [], {
        "f.show_existing_frame = b.f(1)": 1, "f.frame_to_show = b.f(3)":
            slot, "f.display_frame_id = b.f(": frame_id}, seq)
    return T._obu(typ, T.emit(reads, True))


def cut(frame: Frame) -> Frame:
    """The frame with its tile data cut to a third (dav1d's tile checks
    fail on it)."""
    out = Frame.__new__(Frame)
    out.__dict__.update(frame.__dict__)
    out.tiles = frame.tiles[:len(frame.tiles) // 3]
    return out


# ------------------------------------------------------------- sources

def _read_from(folder, name):
    with open(os.path.join(folder, name), "rb") as f:
        return f.read()


def _primary(blob: bytes, item=None) -> Frame:
    m = avif.parse(blob, "x")
    return Frame(avif._item_bytes(blob, m, item or m.primary, "x"))


def with_item(blob: bytes, data: bytes, item=None) -> bytes:
    """The still with its primary item's (or `item`'s) data replaced."""
    f = A.items_of(blob)
    f["items"][item or f["primary"]]["data"] = data
    return A.mux(f)


def saves() -> dict:
    """name -> a Pillow still save (aom's stills are deterministic): two
    pictures each in 4:2:0, 4:4:4 and 4:0:0, an RGBA one and two 512 x
    512 default saves."""
    kw = {"420": {}, "444": {"subsampling": "4:4:4"},
          "400": {"subsampling": "4:0:0"}}
    out = {}
    for k, (tag, extra) in enumerate(kw.items()):
        for j in (0, 1):
            out[f"{tag}_{j}"] = lambda k=k, j=j, extra=extra: A.save(
                A.photo(48, 56, 110 + 2 * k + j), quality=50, **extra)
    out["rgba"] = lambda: A.save(A.with_alpha(A.photo(48, 56, 120), 121),
                                 quality=60)
    out["coded_0"] = lambda: A.save(A.textured(512, 512, 122))
    out["coded_1"] = lambda: A.save(A.photo(512, 512, 123))
    return out


def _two(s, tag):
    """(the first save's blob, its frame, the second's frame)."""
    blob = s[f"{tag}_0"]()
    return blob, _primary(blob), _primary(s[f"{tag}_1"]())


def derived() -> dict:
    """name -> a function writing the fixture."""
    s = saves()
    out = {}

    def still(tag, build, seq_over=None):
        def make():
            blob, a, b = _two(s, tag)
            sq, seq = a.seq_obu(**(seq_over or {}))
            return with_item(blob, build(sq, seq, a, b))
        return make
    # a hidden key frame shown from a slot, in each layout (in 4:0:0 not
    # showable, error resilient)
    for tag, slot in (("420", 3), ("444", 0), ("400", 7)):
        out[f"h_key_slot{slot}_{tag}.avif"] = still(
            tag, lambda sq, seq, a, b, slot=slot, tag=tag: sq + a.frame_obu(
                seq, **hidden(1 << slot, showable=int(tag != "400"),
                              resilient=int(tag == "400"))) +
            show(seq, slot))
    # two hidden frames in two slots, each shown; a slot written twice
    for k in (1, 2):
        out[f"h_two_show{k}.avif"] = still(
            "420", lambda sq, seq, a, b, k=k: sq + a.frame_obu(
                seq, **hidden(2)) + b.frame_obu(seq, **hidden(4)) +
            show(seq, k))
    out["h_overwritten.avif"] = still(
        "420", lambda sq, seq, a, b: sq + a.frame_obu(seq, **hidden(16)) +
        b.frame_obu(seq, **hidden(16)) + show(seq, 4))
    # intra-only frames (refreshing every slot: dav1d checks that only
    # with strict standard compliance, which libavif leaves off)
    out["h_intra_only.avif"] = still(
        "444", lambda sq, seq, a, b: sq + a.frame_obu(
            seq, **hidden(4, intra_only=True)) + show(seq, 2))
    out["h_intra_only_all.avif"] = still(
        "420", lambda sq, seq, a, b: sq + a.frame_obu(
            seq, **hidden(0xFF, intra_only=True)) + show(seq, 5))
    out["h_not_showable.avif"] = still(
        "420", lambda sq, seq, a, b: sq + a.frame_obu(
            seq, **hidden(8, showable=0)) + show(seq, 3))
    # error resilient with order hints: ref_order_hint read
    out["h_order_hints.avif"] = still(
        "444", lambda sq, seq, a, b: sq + a.frame_obu(
            seq, **hidden(0x41, resilient=1)) + show(seq, 6),
        ORDER_HINTS)
    # frame ids: display_frame_id that matches its slot's, and not
    for name, fid in (("h_ids_match.avif", 37), ("h_ids_mismatch.avif",
                                                 38)):
        out[name] = still(
            "420", lambda sq, seq, a, b, fid=fid: sq + a.frame_obu(
                seq, **hidden(2, frame_id=37)) + b.frame_obu(
                seq, **hidden(1, frame_id=99)) + show(seq, 1, fid),
            FRAME_IDS)
    # a hidden frame never shown: walked (damaged, it fails the file)
    out["h_never_shown.avif"] = still(
        "400", lambda sq, seq, a, b: sq + a.frame_obu(seq, **hidden(8)) +
        b.frame_obu(seq))
    out["h_never_shown_damaged.avif"] = still(
        "400", lambda sq, seq, a, b: sq + cut(a).frame_obu(
            seq, **hidden(8)) + b.frame_obu(seq))
    # the data after the frame shown: its frames decoded too
    out["h_rest_frames.avif"] = still(
        "420", lambda sq, seq, a, b: sq + a.frame_obu(seq, **hidden(8)) +
        show(seq, 3) + b.frame_obu(seq, **hidden(2)) + show(seq, 1))
    out["h_rest_damaged.avif"] = still(
        "420", lambda sq, seq, a, b: sq + a.frame_obu(seq, **hidden(8)) +
        show(seq, 3) + cut(b).frame_obu(seq))
    # what dav1d refuses
    out["h_empty_slot.avif"] = still(
        "420", lambda sq, seq, a, b: sq + a.frame_obu(seq, **hidden(2)) +
        show(seq, 6))
    out["h_nothing_shown.avif"] = still(
        "420", lambda sq, seq, a, b: sq + a.frame_obu(seq, **hidden(8)))
    out["h_frame_obu_shows.avif"] = still(
        "420", lambda sq, seq, a, b: sq + a.frame_obu(seq, **hidden(8)) +
        show(seq, 3, typ=OBU_FRAME))
    # film grain kept with a showable hidden frame (not read without)
    for name, showable in (("h_grain_showable.avif", 1),
                           ("h_grain_not_showable.avif", 0)):
        out[name] = lambda showable=showable: _one_tool(
            _read_from(A.FIXTURES, "v_grain05_420.avif"), 2, showable)
    # one hidden frame each with superres, loop restoration, 10 bits
    out["h_superres.avif"] = lambda: _one_tool(
        _read_from(T.FIXTURES, "sr_420_d12.avif"), 4)
    out["h_restoration.avif"] = lambda: _one_tool(
        _read_from(A.FIXTURES, "p_lr_q30_wiener.avif"), 5)
    out["h_10bit.avif"] = lambda: _one_tool(
        _read_from(D.FIXTURES, "o_cdef_420_10.avif"), 1)
    # the alpha item's frame hidden
    out["h_alpha.avif"] = lambda: _alpha(s["rgba"]())
    # a grid whose second cell is only a show_existing_frame header
    out["h_grid_cell_shows.avif"] = lambda: _grid(False)
    out["h_grid_new_sequence.avif"] = lambda: _grid(True)
    # a track's first sample
    out["h_track_first.avif"] = lambda: _track("show")
    out["h_track_nothing_shown.avif"] = lambda: _track("nothing")
    out["h_inter.avif"] = lambda: _track("inter")
    # the 512 x 512 default save hidden in slot 3 behind a second
    # picture in slot 5, then shown
    out[CODED[0]] = lambda: _coded(s)
    return out


def _one_tool(blob: bytes, slot: int, showable: int = 1) -> bytes:
    a = _primary(blob)
    sq, seq = a.seq_obu()
    return with_item(blob, sq + a.frame_obu(
        seq, **hidden(1 << slot, showable=showable)) + show(seq, slot))


def _alpha(blob: bytes) -> bytes:
    m = avif.parse(blob, "x")
    alpha = avif._alpha_of(m, m.primary)
    a = _primary(blob, alpha)
    sq, seq = a.seq_obu()
    return with_item(blob, sq + a.frame_obu(seq, **hidden(64)) +
                     show(seq, 6), alpha)


def _grid(new_sequence: bool) -> bytes:
    """The 2 x 2 grid fixture's cells behind one sequence header written
    in full: cell 0 holds cells 0 and 1 hidden as intra-only frames in
    slots 1 and 2 and shows slot 1; cell 1 is a show_existing_frame of
    slot 2 alone (libavif's one dav1d context keeps the slots across
    cells), or, with `new_sequence`, after a sequence header that differs
    (dav1d then empties the slots: refused)."""
    blob = _read_from(A.FIXTURES, "grid_2x2_420.avif")
    f = A.items_of(blob)
    cells = [k for k, it in sorted(f["items"].items())
             if it["type"] == b"av01"]
    fr = [Frame(f["items"][k]["data"]) for k in cells]
    sq, seq = fr[0].seq_obu()
    other = fr[0].seq_obu(**ORDER_HINTS)[0] if new_sequence else b""
    data = [sq + fr[0].frame_obu(seq, **hidden(2, intra_only=True)) +
            fr[1].frame_obu(seq, **hidden(4, intra_only=True)) +
            show(seq, 1), other + show(seq, 2),
            sq + fr[2].frame_obu(seq), fr[3].frame_obu(seq)]
    for k, d in zip(cells, data):
        f["items"][k]["data"] = d
    return A.mux(f)


def _track(kind: str) -> bytes:
    """The committed 4:2:0 sequence with its first sample's key frame
    hidden in slot 3: then shown ("show"), not shown ("nothing": libavif
    does not go on to the next sample), or followed by the second
    sample's inter frame, which predicts from it ("inter": Pillow opens
    it, the port refuses it by name)."""
    blob = _read_from(S.FIXTURES, "seq_420.avif")
    trak = S.get(S.parse_boxes(blob), b"moov", b"trak")
    (o0, n0), (o1, n1) = S.track_samples(trak)[:2]
    first, second = blob[o0:o0 + n0], blob[o1:o1 + n1]
    a = Frame(first)
    sq, seq = a.seq_obu()
    new = TD + sq + a.frame_obu(seq, **hidden(8 if kind != "inter" else
                                                0xFF))
    if kind == "show":
        new += show(seq, 3)
    elif kind == "inter":
        new += next(second[at - 2:end] for typ, _, _, at, end in
                    av1_obu.obus(second, "x") if typ == OBU_FRAME)
    return S.rewrite_samples(blob, lambda d: new if d == first else d)


def _coded(s) -> bytes:
    blob = s["coded_0"]()
    a, b = _primary(blob), _primary(s["coded_1"]())
    sq, seq = a.seq_obu()
    return with_item(blob, sq + a.frame_obu(seq, **hidden(8)) +
                     b.frame_obu(seq, **hidden(32)) + show(seq, 3))


# -------------------------------------------------- F11: deep transforms

def raise_q(q: int):
    """A frame header edit: base_q_idx set to `q`."""
    def edit(reads, f):
        reads[T._at(reads, "f.base_q_idx = b.f(8)")][1] = q
    return edit


def with_q(blob: bytes, q: int) -> bytes:
    """The still with its frame's base_q_idx at `q` and its tiles coded
    again to read the same symbols (the coefficient CDFs follow q)."""
    return T.rewrite_item(blob, lambda o: T.reencode(
        o, T.edit_obus(o, frame_edit=raise_q(q))))


def noise_save(seed: int) -> bytes:
    """A Pillow save of a seeded noisy photo at a high quality (large
    levels), its size, layout, quality and speed drawn from the seed."""
    r = np.random.RandomState(seed)
    h, w = int(r.choice([32, 48, 64, 96])), int(r.choice([32, 48, 64, 96,
                                                            128]))
    amp = int(r.choice([40, 80, 127]))
    ss = str(r.choice(["4:2:0", "4:4:4", "4:0:0"]))
    img = A.photo(h, w, seed).astype(int)
    img += np.random.RandomState(seed).randint(-amp, amp + 1, img.shape)
    return A.save(np.clip(img, 0, 255).astype(np.uint8),
                  quality=int(r.choice([90, 95, 100])), subsampling=ss,
                  speed=int(r.choice([2, 6, 9])))


# name -> (the save it raises q in, q, the branches it must take, as
# `branches` names them: (depth, pass, kind, length)); each file's
# transforms run past valid coefficients, where dav1d's x86 code (which
# Pillow runs, here with the AVX-512 ICL set) and its C code part
F11 = {
    "f11_10bit_column_rotations.avif": (
        lambda: _read_from(D.FIXTURES, "s_intrabc_420_sub8x8_10.avif"), 255,
        [(10, "col", "DCT", 16), (10, "col", "DCT", 8)]),
    "f11_10bit_adst4_identity.avif": (
        lambda: _read_from(D.FIXTURES, "i_palette_screen_420_10.avif"), 255,
        [(10, "col", "ADST", 4), (10, "col", "IDTX", 8)]),
    "f11_12bit_wrap_adst4.avif": (
        lambda: _read_from(D.FIXTURES, "s_intrabc_420_12.avif"), 255,
        [(12, "row", "ADST", 4)]),
    "f11_12bit_wrap_adst8.avif": (
        lambda: _read_from(D.FIXTURES, "s_intrabc_420_sub8x8_12.avif"), 255,
        [(12, "row", "ADST", 8)]),
    "f11_8bit_dct16_rows.avif": (
        lambda: _read_from(A.FIXTURES, "b_q94_444_odd.avif"), 255,
        [(8, "row", "DCT", 16)]),
    "f11_8bit_adst16_rows.avif": (
        lambda: _read_from(A.FIXTURES, "d_q60_420_tools.avif"), 255,
        [(8, "row", "ADST", 16)]),
    "f11_8bit_dct64_rows.avif": (
        lambda: _read_from(A.FIXTURES, "k_bands_h16.avif"), 255,
        [(8, "row", "DCT", 64, "past 16 bits")]),
    "f11_8bit_dct8.avif": (lambda: noise_save(2), 240,
                           [(8, "row", "DCT", 8), (8, "col", "DCT", 8)]),
    "f11_8bit_dct32.avif": (lambda: noise_save(7), 255,
                            [(8, "row", "DCT", 32), (8, "col", "DCT", 32)]),
    "f11_8bit_dct4.avif": (lambda: noise_save(36), 240,
                           [(8, "row", "DCT", 4), (8, "col", "DCT", 4)]),
    "f11_8bit_adst8.avif": (lambda: noise_save(30), 255,
                            [(8, "row", "ADST", 8)]),
}
# the files whose pixels dav1d's C arithmetic (every rotation exact, the
# sums clipped) gets wrong: the x86 rule the port follows shows in the
# pixels there (elsewhere the pixel clip hides it)
NOT_C = ("f11_12bit_wrap_adst4.avif", "f11_12bit_wrap_adst8.avif",
         "f11_8bit_dct16_rows.avif", "f11_8bit_adst16_rows.avif",
         "f11_8bit_dct8.avif", "f11_8bit_dct32.avif", "f11_8bit_dct4.avif",
         "f11_8bit_adst8.avif")


def f11_derived() -> dict:
    return {name: (lambda src=src, q=q: with_q(src(), q))
            for name, (src, q, _) in F11.items()}


_KINDS = ("DCT", "ADST", "ADST", "IDTX")


def branches(data: bytes, c_only: bool = False):
    """(planes, hits) of the frame's decode: hits counts each transform
    pass (depth, "row" / "col", kind, length) whose result the port's x86
    rule changes from dav1d's C arithmetic (every rotation exact, the
    sums clipped), and, with "past 16 bits" added, each 8-bit pass where
    an exact rotation leaves 16 bits; with `c_only`, the planes by the C
    arithmetic."""
    from l3c_torch.data import av1_block
    R = av1_recon
    hits = collections.Counter()
    one_d, inverse = R._one_d, R.inverse_transform
    at = {}

    def logged(kind, vecs, l1, hi=R.HI, hb=R._hb, stages=None):
        pass_ = "row" if at.pop("row", None) else "col"
        key = (at["bd"], pass_, _KINDS[kind], len(vecs))
        plain = one_d(kind, vecs, l1, hi, R._hb)
        out = plain if c_only else one_d(kind, vecs, l1, hi, hb, stages)
        if any(not np.array_equal(x, y) for x, y in zip(out, plain)):
            hits[key] += 1
        if at["bd"] == 8 and kind != R.IDTX and any(
                not np.array_equal(x, y) for x, y in zip(plain, one_d(
                    kind, vecs, 1 << 30, hi, R._hb_sat16))):
            hits[key + ("past 16 bits",)] += 1
        return out

    def transform(coef, tx_type, tx_size, w, h, bd=8):
        at.update(row=True, bd=bd)
        return inverse(coef, tx_type, tx_size, w, h, bd)
    seq, f, tiles = av1_obu.parse_av1(data, "x")
    R._one_d, R.inverse_transform = logged, transform
    try:
        d = av1_block.walk_frame(seq, f, tiles, data, "x")
    finally:
        R._one_d, R.inverse_transform = one_d, inverse
    return av1_block.add_grain(av1_block.filter_frame(d, seq, f), seq,
                               f), hits


# ---------------------------------------------------------------- corpus

def corpus() -> dict:
    return {n: fn() for n, fn in {**derived(), **f11_derived()}.items()}


def hidden_expected_now(folder=FIXTURES) -> dict:
    """Each file's format, mode, size and digest as Pillow and the JAX
    package give them; where Pillow refuses, Pillow's reason ("pillow")
    and the port's ("port")."""
    files = {}
    for n in sorted(os.listdir(folder)):
        if n == "expected.json":
            continue
        p = os.path.join(folder, n)
        got, meta = D._pillow(p)
        if meta is None:
            files[n] = {"pillow": got, "port": D._port_refusal(p)}
            continue
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


def _data(name, item=None):
    blob = _read(name)
    m = avif.parse(blob, name)
    if m.source == "tracks":
        off, size = m.seq.samples[0]
        return blob[off:off + size]
    return avif._item_bytes(blob, m, item or m.primary, name)


# ------------------------------------------------------------- the tests

def test_hidden_fixtures_are_their_sources_rewritten():
    """Every fixture is remade byte for byte from Pillow's deterministic
    saves and the committed fixtures; each frame's tile data is its
    source's, copied (the f11_ files' tiles are coded again and read the
    same symbols); expected.json is what Pillow and the JAX loader give
    now."""
    made = {**derived(), **f11_derived()}
    assert sorted(made) == _names()
    for name, fn in made.items():
        assert fn() == _read(name), name
    s = saves()
    a, b = _primary(s["420_0"]()), _primary(s["420_1"]())
    two = _data("h_two_show1.avif")
    assert two.count(a.tiles) == 1 and two.count(b.tiles) == 1
    coded = _data(CODED[0])
    for k in (0, 1):
        assert coded.count(_primary(s[f"coded_{k}"]()).tiles) == 1
    want = _expected()
    assert hidden_expected_now() == {k: want[k] for k in ("files", "coded")}
    assert want["made_by"]["libavif"] == "1.3.0"
    assert sum(os.path.getsize(os.path.join(FIXTURES, n))
               for n in os.listdir(FIXTURES)) < 250_000


@pytest.mark.parametrize("name", _names())
def test_port_reads_each_hidden_fixture_as_expected(name):
    """Pillow's format, mode, size and digest and the JAX loader's pixels;
    where Pillow refuses the file, the port's refusal as recorded. The
    inter frame (h_inter.avif, predicted from the hidden key frame) is
    decoded to Pillow's digest."""
    e = _expected()["files"][name]
    p = os.path.join(FIXTURES, name)
    if "pillow" in e:
        assert D._port_refusal(p) == e["port"]
        assert "and so does Pillow" in e["port"]
        return
    assert timages.image_format(p) == e["format"] == "AVIF"
    assert timages.image_mode(p) == e["mode"]
    assert list(timages.image_size(p)) == e["size"]
    if name == "h_inter.avif":
        with Image.open(p) as im:
            assert A._digest(np.asarray(im.convert("RGB"))) == e["sha256"]
    got = timages.load_image_uint8(p)
    assert A._digest(got) == e["sha256"]
    assert np.array_equal(got, jimages.load_image_uint8(p))


def test_each_fixture_shows_what_its_name_says():
    """The picture each decoded fixture shows is the save its name says
    (the slot shown, the frame written last to a slot, the grain kept or
    not), and the refusals are dav1d's own."""
    e = _expected()["files"]
    s = saves()
    pics = {k: A._digest(np.asarray(Image.open(
        io.BytesIO(fn())).convert("RGB")))
        for k, fn in s.items() if not k.startswith("coded")}
    for name, src in (("h_key_slot3_420", "420_0"),
                      ("h_key_slot0_444", "444_0"),
                      ("h_key_slot7_400", "400_0"),
                      ("h_two_show1", "420_0"), ("h_two_show2", "420_1"),
                      ("h_overwritten", "420_1"),
                      ("h_intra_only", "444_0"),
                      ("h_intra_only_all", "420_0"),
                      ("h_not_showable", "420_0"),
                      ("h_order_hints", "444_0"), ("h_ids_match", "420_0"),
                      ("h_never_shown", "400_1"),
                      ("h_rest_frames", "420_0")):
        assert e[name + ".avif"]["sha256"] == pics[src], name
    grain = A._expected()["files"]["v_grain05_420.avif"]["sha256"]
    assert e["h_grain_showable.avif"]["sha256"] == grain
    assert e["h_grain_not_showable.avif"]["sha256"] != grain
    assert e[CODED[0]]["sha256"] == A._digest(np.asarray(Image.open(
        io.BytesIO(s["coded_0"]())).convert("RGB")))
    for name, why in (("h_ids_mismatch", "display_frame_id"),
                      ("h_never_shown_damaged", "tile"),
                      ("h_rest_damaged", "tile"),
                      ("h_empty_slot", "which is empty"),
                      ("h_nothing_shown", "no frame is shown"),
                      ("h_frame_obu_shows", "a frame OBU shows"),
                      ("h_grid_new_sequence", "which is empty"),
                      ("h_track_nothing_shown", "no frame is shown")):
        assert why in e[name + ".avif"]["port"], name
        assert "pillow" in e[name + ".avif"], name
    assert [n for n, v in e.items() if "refused" in v] == []
    assert e["h_inter.avif"]["sha256"] != e["h_key_slot3_420.avif"]["sha256"]


def _frame_headers(data: bytes):
    """(sequence header, [(header, its reads)] of each frame header in
    the data, in order)."""
    seq, out = None, []
    for typ, _, _, at, end in av1_obu.obus(data, "x"):
        if typ == OBU_SEQ:
            seq = av1_obu.sequence_header(av1_obu.Bits(data, at, end, "x"))
        elif typ in (OBU_FH, OBU_FRAME):
            f, reads, _ = T.header_reads(av1_obu.frame_header, data, at,
                                         end, seq)
            out.append((f, reads))
    return seq, out


def _named(reads, text):
    return [r[:2] for r in reads if text in r[2]]


def test_frame_header_fields_of_hidden_frames_as_written():
    """Each field a hidden or shown-existing frame header carries, read
    back from the fixtures: showable_frame after show_frame 0,
    error_resilient_mode and refresh_frame_flags read for a hidden key
    frame (a shown one implies both), ref_order_hint where the slots
    refreshed are not all and the frame is error resilient with order
    hints, current_frame_id kept, film grain read for a showable hidden
    frame only, frame_to_show_map_idx and display_frame_id."""
    seq, hs = _frame_headers(_data("h_order_hints.avif"))
    (f, reads), (sh, sreads) = hs
    assert seq.enable_order_hint and seq.order_hint_bits == 7
    assert (f.show_frame, f.showable_frame, f.error_resilient,
            f.refresh) == (0, 1, 1, 0x41)
    assert _named(reads, "# ref_order_hint") == [[7, 0]] * 8
    assert (sh.show_existing_frame, sh.frame_to_show) == (1, 6)
    assert [n for n, _, _ in sreads] == [1, 3]   # no frame id read
    seq, hs = _frame_headers(_data("h_key_slot3_420.avif"))
    (f, reads), _ = hs
    assert (f.error_resilient, f.refresh) == (0, 8)
    assert not _named(reads, "# ref_order_hint")
    seq, hs = _frame_headers(_data("h_ids_match.avif"))
    assert seq.frame_id_numbers and seq.frame_id_length == 8
    assert [h[0].frame_id for h in hs[:2]] == [37, 99]
    assert (hs[2][0].frame_to_show, hs[2][0].display_frame_id) == (1, 37)
    for name, showable in (("h_grain_showable.avif", 1),
                           ("h_grain_not_showable.avif", 0)):
        seq, hs = _frame_headers(_data(name))
        assert seq.film_grain_present and hs[0][0].showable_frame == \
            showable
        assert (hs[0][0].grain is not None) == bool(showable), name
    seq, hs = _frame_headers(_data("h_intra_only_all.avif"))
    assert (hs[0][0].frame_type, hs[0][0].refresh) == (
        av1_obu.INTRA_ONLY_FRAME, 0xFF)
    f = _frame_headers(_data("h_key_slot7_400.avif"))[1][0][0]
    assert (f.showable_frame, f.error_resilient, f.refresh) == (0, 1, 0x80)
    # a shown key frame: neither read
    a = _primary(saves()["420_0"]())
    sq, seq = a.seq_obu()
    seq, hs = _frame_headers(sq + a.frame_obu(seq))
    assert (hs[0][0].error_resilient, hs[0][0].refresh,
            hs[0][0].showable_frame) == (1, 0xFF, 0)


def test_walk_keeps_slots_as_dav1d():
    """walk_av1 on the fixtures' data: the frames decoded and the one
    shown; a key frame shown from a slot fills every slot; the grid's
    context keeps the slots from cell to cell (Pillow decodes the grid
    whose second cell only shows slot 2) unless a sequence header that
    differs empties them (Pillow refuses)."""
    ctx = av1_obu.context()
    frames, shown = av1_obu.walk_av1(_data("h_two_show2.avif"), "x", ctx)
    assert len(frames) == 2 and shown is frames[1]
    assert ctx.refs == [frames[1]] * 8           # a key frame shown
    ctx = av1_obu.context()
    frames, shown = av1_obu.walk_av1(_data("h_intra_only.avif"), "x", ctx)
    assert [r is frames[0] for r in ctx.refs] == [i == 2 for i in range(8)]
    frames, shown = av1_obu.walk_av1(_data("h_rest_frames.avif"), "x",
                                     av1_obu.context())
    assert len(frames) == 2 and shown is frames[0]
    blob = _read("h_grid_cell_shows.avif")
    m = avif.parse(blob, "x")
    cells = m.grids[m.primary].cells
    ctx = av1_obu.context()
    walked = [av1_obu.walk_av1(avif._item_bytes(blob, m, c, "x"), "x", ctx)
              for c in cells]
    assert walked[1][0] == [] and walked[1][1] is walked[0][0][1]
    assert [len(w[0]) for w in walked] == [2, 0, 1, 1]
    with Image.open(os.path.join(FIXTURES, "h_grid_cell_shows.avif")) as im:
        assert np.array_equal(np.asarray(im.convert("RGB")),
                              timages.load_image_uint8(os.path.join(
                                  FIXTURES, "h_grid_cell_shows.avif")))
    assert "pillow" in _expected()["files"]["h_grid_new_sequence.avif"]


def _sweep(tmp_path, name, seed):
    """Seeded single-bit flips anywhere in the file's AV1 data: each as
    Pillow decodes it, or refused where Pillow refuses (a refusal by
    name would have to be one of F6_TOOLS, now none)."""
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
        if isinstance(port, str):
            assert A._names_an_f6_tool(port), (k, port)
        elif pil is None:
            assert port is None, k
        else:
            assert np.array_equal(pil, port), k
            decoded += 1
    return decoded


@pytest.mark.parametrize("name", SWEPT)
def test_flip_sweep_as_pillow(tmp_path, name):
    """200 seeded flips over two hidden-frame files' AV1 data (sequence
    header, both hidden frames, the show_existing_frame header): 0
    disagreements with Pillow."""
    decoded = _sweep(tmp_path, name, len(name) + 28)
    assert 20 <= decoded < FLIPS


def test_cli_l3c_codes_a_hidden_frame_file_bit_exactly_on_the_cpu(
        tmp_path):
    """cli.l3c enc / dec of a file that shows a hidden frame (56 x 48:
    the 512 x 512 one is coded on the card by chip_smoke)."""
    from l3c_torch.cli import l3c as l3c_cli
    src = os.path.join(FIXTURES, "h_two_show2.avif")
    coded, back = str(tmp_path / "x.l3c"), str(tmp_path / "x.png")
    zoo = os.path.join(A.ROOT, "models_zoo")
    assert l3c_cli.main([zoo, "0820_0345", "enc", src, coded,
                         "--device", "cpu"]) == 0
    assert l3c_cli.main([zoo, "0820_0345", "dec", coded, back,
                         "--device", "cpu"]) == 0
    assert A._digest(timages.read_png(back)) == \
        _expected()["files"]["h_two_show2.avif"]["sha256"]


@pytest.mark.parametrize("name", sorted(F11))
def test_f11_file_takes_its_branch_and_decodes_as_pillow(name):
    """Each f11_ file runs the transform branches its name says past
    valid coefficients (a 10-bit column's rotations, 4-point ADST or
    identity saturating to 16 bits; a 12-bit product wrapping to 32
    bits; an 8-bit pass whose rotations leave 16 bits, kept to their low
    16 bits or saturated as dav1d's AVX-512 code does, or exact in the
    64-point DCT) and decodes to Pillow's digest; where dav1d's C
    arithmetic would give other pixels, it does not give Pillow's."""
    data = _data(name)
    planes, hits = branches(data)
    for want in F11[name][2]:
        assert hits[want] > 0, (want, dict(hits))
    e = _expected()["files"][name]
    got = timages.load_image_uint8(os.path.join(FIXTURES, name))
    assert A._digest(got) == e["sha256"]
    c_planes, _ = branches(data, c_only=True)
    differs = any(not np.array_equal(a, b) for a, b in zip(planes, c_planes))
    assert differs == (name in NOT_C), name


@pytest.mark.parametrize("idc, refused", [(0x101, False), (0x800, True),
                                          (0x0FF, True), (0x100, True)])
def test_operating_point_without_a_layer_is_refused_as_dav1d(tmp_path, idc,
                                                              refused):
    """dav1d refuses an operating point whose idc names temporal layers
    and no spatial one, or the other way (found by the flip sweep: a size
    flip in a show_existing_frame OBU made the rest read as a sequence
    header): Pillow and the port refuse it, and open one that names
    both."""
    blob = A.save(A.photo(48, 56, 1), quality=50)
    a = _primary(blob)
    sq, seq = a.seq_obu(**{"s.op_idc.append(b.f(12))": 0x101})
    n = 8 * (len(sq) - 2)
    bits = int.from_bytes(sq[2:], "big") & ~(0xFFF << (n - 24))
    sq = sq[:2] + (bits | idc << (n - 24)).to_bytes(len(sq) - 2, "big")
    p = str(tmp_path / "op.avif")
    with open(p, "wb") as f:
        f.write(with_item(blob, sq + a.frame_obu(seq)))
    pil, port = A._outcome(p)
    assert (pil is None, port is None) == (refused, refused)
    if not refused:
        assert np.array_equal(pil, port)


def test_host_cpu_is_logged_for_dav1d():
    """dav1d picks its transform code from the CPU at run time: the CPU
    flags the fixtures were made under are in expected.json."""
    made = _expected()["made_by"]
    assert made["dav1d"].startswith("1.5.1") and "cpu_flags" in made


def _cpu_flags():
    """The x86 flags of this host that choose dav1d's code (AVX2, the
    AVX-512 ICL set), from /proc/cpuinfo where it is readable."""
    want = ("avx2", "avx512f", "avx512bw", "avx512vl", "avx512vbmi",
            "avx512_vbmi2", "avx512_vnni", "avx512_bitalg", "avx512ifma",
            "gfni", "vpclmulqdq")
    try:
        with open("/proc/cpuinfo") as f:
            have = set(next(line for line in f if line.startswith(
                "flags")).split()[2:])
    except (OSError, StopIteration):
        return None
    return [w for w in want if w in have]


def make_hidden_fixtures(d=FIXTURES) -> dict:
    os.makedirs(d, exist_ok=True)
    for n in os.listdir(d):
        os.remove(os.path.join(d, n))
    for name, blob in corpus().items():
        with open(os.path.join(d, name), "wb") as f:
            f.write(blob)
    exp = {**hidden_expected_now(d), "made_by": {
        **A._versions(), "cpu_flags": _cpu_flags()}}
    with open(os.path.join(d, "expected.json"), "w") as f:
        json.dump(exp, f, indent=1, sort_keys=True)
        f.write("\n")
    return exp


if __name__ == "__main__":
    exp = make_hidden_fixtures()
    print(f"wrote {len(exp['files'])} fixtures and expected.json to "
          f"{FIXTURES}")
