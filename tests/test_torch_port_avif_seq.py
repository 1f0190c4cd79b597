"""The port's reading of AVIF image sequences (l3c_torch/data/avif.py's
choice of source, data/avif_moov.py's movie box) against Pillow 12.1's
AVIF plugin (libavif 1.3.0, dav1d 1.5.1) and the JAX package's loader.

Pillow opens a sequence (`avis`: Pillow's `save_all`) with libavif's
AVIF_DECODER_SOURCE_AUTO and shows the first frame of its colour track:
the track is read where the major brand is avis, or is not avif and the
file has a movie box; the primary item otherwise. The fixtures
(l3c_torch/data/fixtures/avif_seq, written by `PYTHONPATH=. python
tests/test_torch_port_avif_seq.py`) are Pillow's saves of two or three
frames in 4:2:0, 4:4:4, 4:0:0 and RGBA (and premultiplied RGBA), each
rewritten without its meta box (the ftyp brands that ask for it
replaced, the sample offsets moved), single-bit flips a sweep found to
change the pixels (the sample entry's colr, tkhd's width and height) or
to make libavif refuse the file (one of each class), files whose brands
make libavif take the track or the primary item (an item that is
another image than the track's first frame), a 10-bit sequence
(`seq_set_depth`: every sample's sequence header, the av1C boxes and
pixi rewritten, the offsets moved) and a 512 x 512 default save for the
codec. expected.json holds Pillow's format, mode, size and the digest
of convert("RGB"), or Pillow's and libavif's reasons for refusing the
file and the port's ("port", as chip_smoke reads it).
"""
from __future__ import annotations

import copy
import ctypes
import io
import json
import os
import struct
import sys

import numpy as np
import pytest
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from l3c_tpu.data import images as jimages  # noqa: E402
from l3c_torch.data import images as timages  # noqa: E402
import test_torch_port_avif as A  # noqa: E402
import test_torch_port_avif_deep as D  # noqa: E402

FIXTURES = os.path.join(A.ROOT, "l3c_torch", "data", "fixtures", "avif_seq")
CODED = ("coded_seq_512_420.avif",)
SWEPT = ("seq_rgba_420.avif", "nometa_rgba_420.avif")
FLIPS = 300

# ---------------------------------------------------- a moov-aware writer

# boxes with child boxes, and the bytes before their first child
NEST = {b"moov": 0, b"trak": 0, b"edts": 0, b"mdia": 0, b"minf": 0,
        b"stbl": 0, b"dinf": 0, b"tref": 0, b"stsd": 8, b"av01": 78}


def parse_boxes(b: bytes) -> list:
    """A file's boxes as [type, body] or, for the movie box and the
    boxes under it, [type, head, children]."""
    out, at = [], 0
    while at + 8 <= len(b):
        size, typ = struct.unpack(">I4s", b[at:at + 8])
        size = size or len(b) - at
        body = b[at + 8:at + size]
        if typ in NEST:
            k = NEST[typ]
            out.append([typ, body[:k], parse_boxes(body[k:])])
        else:
            out.append([typ, body])
        at += size
    return out


def write_boxes(nodes: list) -> bytes:
    out = b""
    for n in nodes:
        body = n[1] + write_boxes(n[2]) if len(n) == 3 else n[1]
        out += struct.pack(">I", 8 + len(body)) + n[0] + body
    return out


def walk(nodes: list, path=()):
    for n in nodes:
        yield path + (n[0],), n
        if len(n) == 3:
            yield from walk(n[2], path + (n[0],))


def get(nodes: list, *path, k: int = 0):
    """The k-th box whose path ends with `path`."""
    return [n for p, n in walk(nodes) if p[-len(path):] == path][k]


def _uints(b: bytes, at: int, n: int, w: int = 4):
    return [int.from_bytes(b[at + w * i:at + w * (i + 1)], "big")
            for i in range(n)]


def track_samples(trak: list) -> list:
    """A track's samples (offset, size) from its stco, stsc and stsz."""
    chunks = _uints(get([trak], b"stco")[1], 8,
                    _uints(get([trak], b"stco")[1], 4, 1)[0])
    stsc = get([trak], b"stsc")[1]
    runs = [_uints(stsc, 8 + 12 * i, 2) for i in range(_uints(stsc, 4,
                                                              1)[0])]
    stsz = get([trak], b"stsz")[1]
    sizes = _uints(stsz, 12, _uints(stsz, 8, 1)[0])
    out = []
    for c, off in enumerate(chunks):
        per = [n for first, n in runs if first <= c + 1][-1]
        for _ in range(per):
            out.append((off, sizes[len(out)]))
            off += out[-1][1]
    return out


def _iloc_extents(box: bytearray):
    """(position of each extent's offset field, its width, position of
    its length field, its width) in an iloc box (base offsets 0)."""
    v = box[8]
    osz, lsz, bsz = box[12] >> 4, box[12] & 15, box[13] >> 4
    isz = box[13] & 15 if v else 0
    w = 2 if v < 2 else 4
    at, out = 14 + w, []
    for _ in range(int.from_bytes(box[14:14 + w], "big")):
        at += w + (2 if v else 0) + 2
        assert not int.from_bytes(box[at:at + bsz], "big")
        at += bsz
        for _ in range(int.from_bytes(box[at:at + 2], "big")):
            out.append((at + 2 + isz, osz, at + 2 + isz + osz, lsz))
            at += isz + osz + lsz
        at += 2
    return out


def rewrite_samples(blob: bytes, fn, entry=None, meta=None) -> bytes:
    """The file with each sample of each track (and each item extent,
    which Pillow's files share with the first samples) replaced by
    fn(bytes), mdat laid out again, and stco, stsz and iloc moved to
    match; entry(node) / meta(body) edit the av01 sample entries and the
    meta box on the way. mdat must be the last box."""
    nodes = parse_boxes(blob)
    assert nodes[-1][0] == b"mdat"
    start = len(write_boxes(nodes[:-1])) + 8
    regions = {}
    for p, n in walk(nodes):
        if n[0] == b"trak":
            for off, size in track_samples(n):
                regions[off] = size
    data, new_at, pos = bytearray(), {}, start
    for off in sorted(regions):
        data += blob[pos:off]
        new_at[off] = start + len(data)
        data += fn(blob[off:off + regions[off]])
        pos = off + regions[off]
    data += blob[pos:]
    moved = {off: (new_at[off], len(fn(blob[off:off + regions[off]])))
             for off in regions}
    for p, n in walk(nodes):
        if n[0] == b"trak":
            old = track_samples(n)
            stco, stsz = get([n], b"stco"), get([n], b"stsz")
            b = bytearray(stco[1])
            for i, off in enumerate(_uints(b, 8, _uints(b, 4, 1)[0])):
                b[8 + 4 * i:12 + 4 * i] = struct.pack(">I", moved[off][0])
            stco[1] = bytes(b)
            b = bytearray(stsz[1])
            for i, (off, _) in enumerate(old):
                b[12 + 4 * i:16 + 4 * i] = struct.pack(">I", moved[off][1])
            stsz[1] = bytes(b)
        elif n[0] == b"av01" and entry is not None:
            entry(n)
        elif n[0] == b"meta":
            body = bytearray(meta(n[1]) if meta else n[1])
            at = 4
            while at < len(body):
                size, typ = struct.unpack(">I4s", body[at:at + 8])
                if typ == b"iloc":
                    box = body[at:at + size]
                    for o, ow, ln, lw in _iloc_extents(box):
                        off = int.from_bytes(box[o:o + ow], "big")
                        new, size2 = moved[off]
                        box[o:o + ow] = new.to_bytes(ow, "big")
                        box[ln:ln + lw] = size2.to_bytes(lw, "big")
                    body[at:at + size] = box
                at += size
            n[1] = bytes(body)
    return write_boxes(nodes[:-1]) + struct.pack(
        ">I4s", 8 + len(data), b"mdat") + bytes(data)


def _av1c_at_depth(b: bytes, depth: int) -> bytes:
    """An av1C box's body for the same stream at `depth` bits, as
    test_torch_port_avif_deep.seq_at_depth writes its bytes 1-2 (profile 2
    at 12 bits, twelve_bit, high_bitdepth)."""
    prof = b[1] >> 5 if depth == 10 else 2
    return bytes([b[0], (prof << 5) | (b[1] & 31),
                  0x40 | (int(depth == 12) << 5) | (b[2] & 31)]) + b[3:4]


def seq_set_depth(blob: bytes, depth: int) -> bytes:
    """A Pillow sequence at `depth` bits: every sample's sequence header
    (test_torch_port_avif_deep's rewrite), each av1C (sample entries and
    item properties) and each pixi; the offsets moved (a header that
    grows moves the samples)."""
    def entry(n):
        for c in n[2]:
            if c[0] == b"av1C":
                c[1] = _av1c_at_depth(c[1], depth)

    def meta(body):
        body = bytearray(body)
        for typ, fix in ((b"av1C", lambda b: _av1c_at_depth(b, depth)),
                         (b"pixi", lambda b: b[:5] + bytes([depth]) * b[4])):
            at = body.find(typ)
            while at >= 0:
                size = struct.unpack(">I", body[at - 4:at])[0]
                body[at + 4:at - 4 + size] = fix(
                    bytes(body[at + 4:at - 4 + size]))
                at = body.find(typ, at + 4)
        return bytes(body)
    return rewrite_samples(blob, lambda d: D._obus_at_depth(d, depth)[0],
                           entry, meta)


def rewrite(blob: bytes, edit) -> bytes:
    """The file's boxes edited in place by edit(nodes) and written back,
    the sample and item offsets moved by what mdat moved."""
    nodes = parse_boxes(blob)
    old = _mdat_at(nodes)
    edit(nodes)
    d = _mdat_at(nodes) - old
    if d:
        for p, n in walk(nodes):
            if n[0] == b"stco":
                b = bytearray(n[1])
                for i, off in enumerate(_uints(b, 8, _uints(b, 4, 1)[0])):
                    b[8 + 4 * i:12 + 4 * i] = struct.pack(">I", off + d)
                n[1] = bytes(b)
            elif n[0] == b"meta":
                body, at = bytearray(n[1]), 4
                while at < len(body):
                    size, typ = struct.unpack(">I4s", body[at:at + 8])
                    if typ == b"iloc":
                        box = body[at:at + size]
                        for o, ow, _, _ in _iloc_extents(box):
                            off = int.from_bytes(box[o:o + ow], "big")
                            box[o:o + ow] = (off + d).to_bytes(ow, "big")
                        body[at:at + size] = box
                    at += size
                n[1] = bytes(body)
    return write_boxes(nodes)


def _mdat_at(nodes) -> int:
    return len(write_boxes(nodes[:[n[0] for n in nodes].index(b"mdat")]))


def set_brands(major: bytes, compatible) -> callable:
    def edit(nodes):
        nodes[0][1] = major + bytes(4) + b"".join(compatible)
    return edit


def drop_meta(blob: bytes, keep=()) -> bytes:
    """ROADMAP's recipe for a sequence without a meta box: the box
    removed, the samples moved back, and the brands that ask for it
    (avif; mif1 and miaf unless kept) taken out of ftyp."""
    def edit(nodes):
        nodes[:] = [n for n in nodes if n[0] != b"meta"]
        brands = [nodes[0][1][i:i + 4] for i in range(8, len(nodes[0][1]),
                                                      4)]
        nodes[0][1] = nodes[0][1][:8] + b"".join(
            b for b in brands if b not in (b"avif", b"mif1", b"miaf") or
            b in keep)
    return rewrite(blob, edit)


def flip(blob: bytes, at: int, mask: int) -> bytes:
    b = bytearray(blob)
    b[at] ^= mask
    return bytes(b)


def box_at(blob: bytes, *path, k: int = 0) -> int:
    """The file offset of the k-th box whose path ends with `path`."""
    def find(b, at, end, trail):
        while at + 8 <= end:
            size, typ = struct.unpack(">I4s", b[at:at + 8])
            here = trail + (typ,)
            yield here, at
            if typ in NEST:
                yield from find(b, at + 8 + NEST[typ], at + size, here)
            at += size
    return [at for p, at in find(blob, 0, len(blob), ())
            if p[-len(path):] == path][k]


# ---------------------------------------------------------------- corpus

def save_all(frames, **kw) -> bytes:
    f = io.BytesIO()
    ims = [Image.fromarray(x) for x in frames]
    ims[0].save(f, "AVIF", save_all=True, append_images=ims[1:], **kw)
    return f.getvalue()


def _rgba(h, w, seed):
    r = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    a = np.clip(128 + 120 * np.sin(x / 5.0 + seed) * np.cos(y / 4.0) +
                r.randint(-9, 10, (h, w)), 0, 255).astype(np.uint8)
    return np.dstack([A.photo(h, w, seed), a])


def sources() -> dict:
    """The Pillow saves the corpus starts from."""
    return {
        "seq_420.avif": save_all([A.photo(48, 56, s) for s in (1, 2)],
                                 quality=70),
        "seq_444.avif": save_all([A.waves(32, 40, s) for s in (3, 4, 5)],
                                 subsampling="4:4:4", quality=80),
        "seq_400.avif": save_all([A.photo(40, 48, s) for s in (6, 7)],
                                 subsampling="4:0:0"),
        "seq_rgba_420.avif": save_all([_rgba(32, 40, s) for s in (8, 9)]),
        "seq_rgba_prem.avif": save_all([_rgba(40, 32, s) for s in (10, 11)],
                                       alpha_premultiplied=True,
                                       subsampling="4:4:4"),
    }


def _with_item_of(blob: bytes, still: bytes) -> bytes:
    """A sequence whose primary item is another image (a keyframe of the
    same size and format): the still's AV1 data appended to mdat and the
    item's extent pointed at it."""
    item = A.items_of(still)["items"][1]["data"]
    nodes = parse_boxes(blob)
    at = len(blob)
    nodes[-1][1] += item
    body = bytearray(get(nodes, b"meta")[1])
    i = body.find(b"iloc") - 4
    box = body[i:i + struct.unpack(">I", body[i:i + 4])[0]]
    (o, ow, ln, lw) = _iloc_extents(box)[0]
    box[o:o + ow] = at.to_bytes(ow, "big")
    box[ln:ln + lw] = len(item).to_bytes(lw, "big")
    body[i:i + len(box)] = box
    get(nodes, b"meta")[1] = bytes(body)
    return write_boxes(nodes)


def _moov_renamed(blob: bytes) -> bytes:
    at = box_at(blob, b"moov")
    return blob[:at + 4] + b"free" + blob[at + 8:]


def derived(src: dict, x: bytes) -> dict:
    """name -> file bytes of every fixture made from the saves `src` and
    the sequence `x` whose item is another image."""
    out = {}
    for name in ("seq_420.avif", "seq_444.avif", "seq_400.avif",
                 "seq_rgba_420.avif", "seq_rgba_prem.avif"):
        out["nometa_" + name[4:]] = drop_meta(src[name])
    s = src["seq_420.avif"]
    out["nometa_mif1_miaf_420.avif"] = drop_meta(s, keep=(b"mif1", b"miaf"))
    out["nometa_avif_brand_420.avif"] = drop_meta(s, keep=(b"avif",))
    # the single-bit flips that changed the output in the sweep: the
    # sample entry's colr range flag; tkhd's width 56 -> 57 and height
    # 48 -> 8240
    out["flip_colr_range_420.avif"] = flip(
        s, box_at(s, b"av01", b"colr") + 18, 0x80)
    tkhd = box_at(s, b"tkhd") + 8
    out["flip_tkhd_width_420.avif"] = flip(s, tkhd + 89, 0x01)
    out["flip_tkhd_height_420.avif"] = flip(s, tkhd + 92, 0x20)
    # one flip of each class the sweep refuses
    r = src["seq_rgba_420.avif"]
    out["r_stsz_past_end.avif"] = flip(r, box_at(r, b"stsz") + 21, 0x10)
    out["r_stsc_first_chunk.avif"] = flip(r, box_at(r, b"stsc") + 19, 0x01)
    out["r_tkhd_version.avif"] = flip(r, box_at(r, b"tkhd") + 8, 0x02)
    out["r_elst_entry_count.avif"] = flip(r, box_at(r, b"elst") + 15, 0x04)
    out["r_box_header.avif"] = flip(r, box_at(r, b"mdia") + 2, 0x01)
    out["r_stco_past_end.avif"] = flip(r, box_at(r, b"stco", k=1) + 17,
                                       0x01)
    # the source libavif takes, by the brands
    brands = [b"avif", b"avis", b"msf1", b"iso8", b"mif1", b"miaf"]
    no_avis = [b for b in brands if b != b"avis"]
    out["src_avif_item.avif"] = rewrite(x, set_brands(b"avif", brands))
    out["src_mif1_tracks.avif"] = rewrite(x, set_brands(b"mif1", brands))
    out["src_mif1_item.avif"] = rewrite(x, set_brands(b"mif1", no_avis))
    out["src_msf1_nomoov_item.avif"] = _moov_renamed(
        rewrite(x, set_brands(b"msf1", no_avis)))
    out["src_avis_nomoov.avif"] = _moov_renamed(x)
    out["seq_420_10.avif"] = seq_set_depth(s, 10)
    out["seq_rgba_444_12.avif"] = seq_set_depth(
        src["seq_rgba_prem.avif"], 12)
    return out


def corpus() -> dict:
    """name -> file bytes: Pillow's saves now (their creation times
    differ from run to run) and what is made from them."""
    src = sources()
    still = A.save(A.photo(48, 56, 12), quality=70)
    x = _with_item_of(src["seq_420.avif"], still)
    coded = save_all([A.textured(512, 512, s) for s in (13, 14)])
    return {**src, **derived(src, x), "src_avis_tracks.avif": x,
            CODED[0]: coded}


def libavif_reason(blob: bytes) -> str:
    """libavif's result and diagnostic for the file (avifDecoderParse,
    then the first avifDecoderNextImage; avifDecoder.diag at byte 160
    in 1.3.0), "" where it decodes."""
    c = ctypes
    lib = A.libavif_lib()
    lib.avifResultToString.restype = c.c_char_p
    dec = lib.avifDecoderCreate()
    buf = c.create_string_buffer(blob, len(blob))
    try:
        lib.avifDecoderSetIOMemory(c.c_void_p(dec), buf, c.c_size_t(
            len(blob)))
        r = lib.avifDecoderParse(c.c_void_p(dec))
        if r == 0:
            r = lib.avifDecoderNextImage(c.c_void_p(dec))
        diag = c.string_at(dec + 160, 256).split(b"\0")[0].decode()
        return "" if r == 0 else \
            f"{lib.avifResultToString(r).decode()}: {diag}"
    finally:
        lib.avifDecoderDestroy(c.c_void_p(dec))


def _pillow(p):
    """(Pillow's RGB, (format, mode, [h, w])), or (its reason, None)."""
    try:
        with Image.open(p) as im:
            return np.asarray(im.convert("RGB")), (im.format, im.mode,
                                                   list(im.size[::-1]))
    except Exception as e:             # noqa: BLE001 (Pillow's refusals)
        return f"{type(e).__name__}: {e}".replace(p, os.path.basename(
            p)), None


def seq_expected_now(folder=FIXTURES) -> dict:
    files = {}
    for n in sorted(os.listdir(folder)):
        if n == "expected.json":
            continue
        p = os.path.join(folder, n)
        got, meta = _pillow(p)
        if meta is None:
            with open(p, "rb") as f:
                why = libavif_reason(f.read())
            files[n] = {"pillow": got, "libavif": why,
                        "port": D._port_refusal(p)}
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
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def _outcome(blob, tmp_path, name="x.avif"):
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(blob)
    return A._outcome(p)


# ------------------------------------------------------------- the tests

def test_seq_expected_json_equals_pillow_and_jax_now():
    want = _expected()
    assert seq_expected_now() == {k: want[k] for k in ("files", "coded")}
    assert want["made_by"]["libavif"] == "1.3.0"
    assert sum(os.path.getsize(os.path.join(FIXTURES, n))
               for n in os.listdir(FIXTURES)) < 400_000


def test_fixtures_are_their_sources_rewritten():
    """Every committed file made from the committed saves is what the
    producer makes from them now (the saves carry their creation time, so
    they are not made again here)."""
    src = {n: _read(n) for n in sources()}
    got = derived(src, _read("src_avis_tracks.avif"))
    assert sorted([*src, *got, "src_avis_tracks.avif", *CODED]) == _names()
    for n, b in got.items():
        assert b == _read(n), n


@pytest.mark.parametrize("name", _names())
def test_port_reads_each_seq_fixture_as_expected(name):
    e = _expected()["files"][name]
    p = os.path.join(FIXTURES, name)
    if "sha256" not in e:
        with pytest.raises(ValueError) as err:
            timages.load_image_uint8(p)
        assert e["port"] in str(err.value)
        return
    assert timages.image_format(p) == e["format"] == "AVIF"
    assert timages.image_mode(p) == e["mode"]
    assert list(timages.image_size(p)) == e["size"]
    got = timages.load_image_uint8(p)
    assert A._digest(got) == e["sha256"]
    assert np.array_equal(got, jimages.load_image_uint8(p))


def test_header_gives_pillows_mode_and_size_on_every_decoded_fixture():
    """avif_header (the loader's listing, prep's --min_res) against
    Pillow's Image.open itself, not expected.json."""
    n = 0
    for name, e in _expected()["files"].items():
        if "sha256" not in e:
            continue
        p = os.path.join(FIXTURES, name)
        with Image.open(p) as im:
            assert (timages.image_mode(p), timages.image_size(p)) == (
                im.mode, im.size[::-1]), name
        n += 1
    assert n >= 20


def test_each_kind_is_what_its_name_says():
    """The rewrites keep their source's first frame; the flips change what
    F10 found; the source follows the brands."""
    e = {n: v.get("sha256") for n, v in _expected()["files"].items()}
    for kind in ("420", "444", "400", "rgba_420", "rgba_prem"):
        assert e[f"nometa_{kind}.avif"] == e[f"seq_{kind}.avif"]
    assert e["nometa_mif1_miaf_420.avif"] == e["seq_420.avif"]
    assert e["nometa_avif_brand_420.avif"] is None
    assert e["flip_colr_range_420.avif"] not in (None, e["seq_420.avif"])
    files = _expected()["files"]
    assert files["flip_tkhd_width_420.avif"]["size"] == [48, 57]
    assert files["flip_tkhd_height_420.avif"]["size"] == [8240, 56]
    assert files["seq_rgba_420.avif"]["mode"] == "RGBA"
    for n in ("src_avis_tracks.avif", "src_mif1_tracks.avif"):
        assert e[n] == e["seq_420.avif"], n
    items = {e[n] for n in ("src_avif_item.avif", "src_mif1_item.avif",
                            "src_msf1_nomoov_item.avif")}
    assert len(items) == 1 and None not in items and \
        e["seq_420.avif"] not in items
    refused = [n for n, v in files.items() if "sha256" not in v]
    assert sorted(refused) == sorted(
        [n for n in files if n.startswith("r_")] +
        ["nometa_avif_brand_420.avif", "src_avis_nomoov.avif"])
    assert all(files[n]["libavif"] for n in refused)
    assert files["seq_420_10.avif"]["sha256"]


@pytest.mark.parametrize("name", SWEPT)
def test_moov_flip_sweep_as_pillow(tmp_path, name):
    """Seeded single-bit flips over the movie box: where Pillow decodes,
    the port gives its pixels; where it refuses, the port refuses."""
    blob = _read(name)
    at = box_at(blob, b"moov")
    size = struct.unpack(">I", blob[at:at + 4])[0]
    r = np.random.RandomState(26 + len(name))
    decoded = refused = 0
    for k in range(FLIPS):
        b = flip(blob, at + r.randint(size), 1 << r.randint(8))
        pil, port = _outcome(b, tmp_path)
        if pil is None:
            assert port is None, k
            refused += 1
        else:
            assert port is not None and not isinstance(port, str), k
            assert np.array_equal(port, pil), k
            decoded += 1
    assert decoded > FLIPS // 3 and refused > FLIPS // 5


def _dup(*path, k=0):
    def edit(n):
        par = get(n, *path[:-1], k=k)
        par[2].append(copy.deepcopy(get(par[2], path[-1])))
    return edit


def _drop(*path, k=0):
    def edit(n):
        par = get(n, *path[:-1], k=k)
        par[2][:] = [c for c in par[2] if c[0] != path[-1]]
    return edit


def _set(path, at, value, k=0):
    def edit(n):
        box = get(n, *path, k=k)
        box[1] = box[1][:at] + value + box[1][at + len(value):]
    return edit


def _tref(k, body):
    def edit(n):
        get(n, b"trak", k=k)[2].insert(1, [b"tref", b"", parse_boxes(body)])
    return edit


def _auxi(body):
    def edit(n):
        for c in get(n, b"av01", k=1)[2]:
            if c[0] == b"auxi":
                c[1] = body
    return edit


_URN = b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha"
# hand-made edits of the RGBA sequence, one per rule of libavif's
MOOV_EDITS = {
    "no_mvhd": _drop(b"moov", b"mvhd"),
    "no_trak": lambda n: get(n, b"moov")[2].__setitem__(
        slice(None), [c for c in get(n, b"moov")[2] if c[0] != b"trak"]),
    "two_tkhd": _dup(b"trak", b"tkhd"),
    "two_edts": _dup(b"trak", b"edts"),
    "two_elst": _dup(b"edts", b"elst"),
    "no_edts": _drop(b"trak", b"edts"),
    "elst_not_repeating": _set((b"elst",), 3, b"\0"),
    "elst_version_2": _set((b"elst",), 0, b"\2"),
    "elst_segment_0": _set((b"elst",), 8, bytes(8)),
    "tkhd_duration_0": _set((b"tkhd",), 28, bytes(8)),
    "tkhd_id_0": _set((b"tkhd",), 20, bytes(4)),
    "tkhd_width_0": _set((b"tkhd",), 88, bytes(4)),
    "tkhd_width_32769": _set((b"tkhd",), 88, struct.pack(">H", 32769)),
    "both_tkhd_33_wide": lambda n: [_set((b"tkhd",), 88, b"\0\x21", k=k)(n)
                                    for k in (0, 1)],
    "alpha_tkhd_33_wide": _set((b"tkhd",), 88, b"\0\x21", k=1),
    "two_mdhd": _dup(b"mdia", b"mdhd"),
    "no_mdhd": _drop(b"mdia", b"mdhd"),
    "mdhd_version_0": lambda n: get(n, b"mdhd").__setitem__(
        1, bytes(4) + get(n, b"mdhd")[1][8:12] + get(n, b"mdhd")[1][16:24] +
        get(n, b"mdhd")[1][28:]),
    "mdhd_version_2": _set((b"mdhd",), 0, b"\2"),
    "mdhd_timescale_0": _set((b"mdhd",), 20, bytes(4)),
    "hdlr_type_vide": _set((b"mdia", b"hdlr"), 8, b"vide"),
    "hdlr_no_name": lambda n: get(n, b"mdia", b"hdlr").__setitem__(
        1, get(n, b"mdia", b"hdlr")[1][:-1]),
    "hdlr_pre_defined": _set((b"mdia", b"hdlr"), 4, b"\1"),
    "no_hdlr": _drop(b"mdia", b"hdlr"),
    "two_minf": _dup(b"mdia", b"minf"),
    "no_stbl": _drop(b"minf", b"stbl"),
    "two_stco": _dup(b"stbl", b"stco"),
    "two_stsz": _dup(b"stbl", b"stsz"),
    "two_stsc": _dup(b"stbl", b"stsc"),
    "two_stsd": _dup(b"stbl", b"stsd"),
    "no_stts_stss": lambda n: (_drop(b"stbl", b"stts")(n),
                               _drop(b"stbl", b"stss")(n)),
    "co64": lambda n: get(n, b"stco").__setitem__(
        slice(None), [b"co64", get(n, b"stco")[1][:8] + bytes(4) +
                      get(n, b"stco")[1][8:12]]),
    "stsz_uniform_size": _set((b"stsz",), 4, b"\0\0\0\5"),
    "stsz_sample_0": _set((b"stsz",), 12, bytes(4)),
    "stsz_second_sample_0": _set((b"stsz",), 16, bytes(4)),
    "stsc_one_per_chunk": _set((b"stsc",), 12, b"\0\0\0\1"),
    "stsc_not_increasing": _set((b"stsc",), 0, bytes(4) + struct.pack(
        ">7I", 2, 1, 1, 1, 1, 2, 1)),
    "stsc_past_image_count_limit": _set((b"stsc",), 12, struct.pack(
        ">I", 2592001)),
    "stsd_version_1": _set((b"stsd",), 0, b"\1"),
    "stsd_entry_short": lambda n: get(n, b"stsd")[2].insert(
        0, [b"av01", bytes(20)]),
    "stsd_other_entry_first": lambda n: (
        get(n, b"stsd")[2].insert(0, [b"xxxx", bytes(20)]),
        get(n, b"stsd").__setitem__(1, b"\0\0\0\0\0\0\0\2")),
    "av01_renamed": lambda n: get(n, b"av01").__setitem__(0, b"av02"),
    "alpha_av01_renamed": lambda n: get(n, b"av01", k=1).__setitem__(
        0, b"av02"),
    "no_av1C": _drop(b"av01", b"av1C"),
    "alpha_no_av1C": _drop(b"av01", b"av1C", k=1),
    "two_nclx": _dup(b"av01", b"colr"),
    "nclx_and_icc": lambda n: get(n, b"av01")[2].append(
        [b"colr", b"prof" + bytes(20)]),
    "nclx_identity_420": _set((b"av01", b"colr"), 8, b"\0\0"),
    "nclx_reserved": _set((b"av01", b"colr"), 10, b"\x81"),
    "pixi_in_entry": lambda n: get(n, b"av01")[2].append(
        [b"pixi", bytes(4) + b"\3\x0a\x0a\x0a"]),
    "pixi_mixed": lambda n: get(n, b"av01")[2].append(
        [b"pixi", bytes(4) + b"\2\x08\x0a"]),
    "auxi_hevc": _auxi(bytes(4) + b"urn:mpeg:hevc:2015:auxid:1\0"),
    "auxi_other": _auxi(bytes(4) + _URN + b"x\0"),
    "auxi_no_terminator": _auxi(bytes(4) + _URN),
    "auxi_version_1": _auxi(b"\1\0\0\0" + _URN + b"\0"),
    "no_auxi": _drop(b"av01", b"auxi", k=1),
    "alpha_first": lambda n: get(n, b"moov")[2].sort(
        key=lambda c: c[0] == b"trak" and b"tref" not in [
            x[0] for x in c[2]]),
    "colour_auxl": _tref(0, struct.pack(">I4sI", 12, b"auxl", 2)),
    "colour_prem": _tref(0, struct.pack(">I4sI", 12, b"prem", 2)),
    "auxl_two_ids": lambda n: get(n, b"tref").__setitem__(
        2, parse_boxes(struct.pack(">I4sII", 16, b"auxl", 2, 1))),
    "auxl_short": lambda n: get(n, b"tref").__setitem__(
        2, parse_boxes(struct.pack(">I4s3s", 11, b"auxl", b"\0\0\1"))),
    "trak_meta": lambda n: get(n, b"trak")[2].append(
        [b"meta", bytes(4) + struct.pack(">I4s", 33, b"hdlr") + bytes(8) +
         b"pict" + bytes(13)]),
    "trak_meta_version_1": lambda n: get(n, b"trak")[2].append(
        [b"meta", b"\1\0\0\0"]),
    "uuid_in_trak": lambda n: get(n, b"trak")[2].insert(
        0, [b"uuid", bytes(16) + b"abc"]),
    "moov_before_meta": lambda n: n.sort(key=lambda c: [
        b"ftyp", b"moov"].index(c[0]) if c[0] in (b"ftyp", b"moov") else 2),
    "second_moov": lambda n: n.insert(3, copy.deepcopy(get(n, b"moov"))),
}


@pytest.mark.parametrize("edit", sorted(MOOV_EDITS))
def test_moov_rules_as_libavif(tmp_path, edit):
    """Each rule of libavif's movie box, source choice and track choice
    found by hand: the edited RGBA sequence decodes to Pillow's pixels and
    mode where Pillow decodes it, and is refused where Pillow refuses."""
    blob = rewrite(_read("seq_rgba_420.avif"), MOOV_EDITS[edit])
    p = str(tmp_path / "e.avif")
    with open(p, "wb") as f:
        f.write(blob)
    pil, port = A._outcome(p)
    if pil is None:
        assert port is None
        return
    assert port is not None and not isinstance(port, str)
    assert np.array_equal(port, pil)
    with Image.open(p) as im:
        assert (timages.image_mode(p), timages.image_size(p)) == (
            im.mode, im.size[::-1])


@pytest.mark.parametrize("major", [b"avis", b"avif", b"mif1", b"msf1"])
def test_source_choice_follows_the_brands_as_libavif(tmp_path, major):
    """AVIF_DECODER_SOURCE_AUTO over every major brand Pillow accepts,
    with and without avif and avis among the compatible brands and with
    and without the movie box: the track, the item or a refusal, as
    Pillow."""
    x = _read("src_avis_tracks.avif")
    brands = [b"avif", b"avis", b"msf1", b"iso8", b"mif1", b"miaf"]
    for drop in ((), (b"avis",), (b"avif",), (b"avif", b"avis")):
        b = rewrite(x, set_brands(major, [c for c in brands
                                          if c not in drop]))
        for blob in (b, _moov_renamed(b)):
            pil, port = _outcome(blob, tmp_path)
            assert (pil is None) == (port is None), drop
            if pil is not None:
                assert np.array_equal(port, pil), drop


def test_cli_l3c_codes_a_sequence_bit_exactly_on_the_cpu(tmp_path):
    from l3c_torch.cli import l3c as l3c_cli
    src = os.path.join(FIXTURES, "seq_444.avif")
    coded, back = str(tmp_path / "x.l3c"), str(tmp_path / "x.png")
    zoo = os.path.join(A.ROOT, "models_zoo")
    assert l3c_cli.main([zoo, "0820_0345", "enc", src, coded,
                         "--device", "cpu"]) == 0
    assert l3c_cli.main([zoo, "0820_0345", "dec", coded, back,
                         "--device", "cpu"]) == 0
    assert np.array_equal(timages.read_png(back),
                          timages.load_image_uint8(src))
    assert A._digest(timages.read_png(back)) == \
        _expected()["files"]["seq_444.avif"]["sha256"]


def test_prep_inp_dir_over_a_sequence_equals_jax(tmp_path, capsys):
    from l3c_tpu.cli import prep_pipeline as jpipe
    from l3c_torch.cli import prep_pipeline as tpipe
    dump = tmp_path / "dump"
    dump.mkdir()
    # the listing picks files by extension (JAX's list, no .avif): AVIF
    # sequences named .png, as users' renamed files are
    files = {n[:-5] + ".png": _read(n) for n in (
        CODED[0], "seq_420_10.avif", "r_stsc_first_chunk.avif")}
    files["nometa_coded.png"] = drop_meta(_read(CODED[0]))
    for name, blob in files.items():
        with open(str(dump / name), "wb") as f:
            f.write(blob)
    outs = []
    for main, name in ((tpipe.main, "t"), (jpipe.main, "j")):
        out = str(tmp_path / name)
        assert main(["--inp_dir", str(dump), out, "--min_res", "200"]) == 0
        outs.append(out)
    capsys.readouterr()
    listing = lambda o: sorted(os.path.relpath(os.path.join(b, f), o)  # noqa
                               for b, _, fs in os.walk(o) for f in fs
                               if f.endswith(".png"))
    assert listing(outs[0]) == listing(outs[1]) and len(listing(outs[0])) == 2
    for rel in listing(outs[0]):
        np.testing.assert_array_equal(
            timages.read_png(os.path.join(outs[0], rel)),
            np.asarray(Image.open(os.path.join(outs[1], rel)).convert(
                "RGB")))


def make_seq_fixtures(d=FIXTURES) -> dict:
    os.makedirs(d, exist_ok=True)
    for n in os.listdir(d):
        os.remove(os.path.join(d, n))
    for name, blob in corpus().items():
        with open(os.path.join(d, name), "wb") as f:
            f.write(blob)
    exp = {**seq_expected_now(d), "made_by": A._versions()}
    with open(os.path.join(d, "expected.json"), "w") as f:
        json.dump(exp, f, indent=1, sort_keys=True)
        f.write("\n")
    return exp


if __name__ == "__main__":
    exp = make_seq_fixtures()
    print(f"wrote {len(exp['files'])} fixtures and expected.json to "
          f"{FIXTURES}")
