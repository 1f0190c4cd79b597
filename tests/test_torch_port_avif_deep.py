"""The port's 10- and 12-bit AVIF decoding (l3c_torch/data/avif.py,
av1_*.py, avif_yuv.py, avif_scale.py) against Pillow 12.1's AVIF plugin
(libavif 1.3.0, dav1d 1.5.1, libyuv) and the JAX package's loader.

aom 3.12.1, the encoder inside Pillow's libavif, writes no depth above 8.
AV1's tile data is parsed the same at every depth but for palette
colours, so the fixtures (l3c_torch/data/fixtures/avif_deep, written by
`PYTHONPATH=. python tests/test_torch_port_avif_deep.py`) are 8-bit
Pillow and libavif saves whose depth is rewritten (`set_depth`: the
sequence header's profile, high_bitdepth, twelve_bit, mono_chrome and
profile 2's subsampling bits, av1C and every pixi, the container written
again by `mux`). dav1d decodes them through its high-bit-depth path:
the 10- and 12-bit dequantization lookups, prediction, transforms,
in-loop filters and film grain at that depth; libavif scales them to
`ispe` and converts them to Pillow's 8-bit RGB. Where Pillow opens such a
file the port gives its pixels and, stage by stage, dav1d's planes; where
Pillow refuses one (a palette's colours read at the new depth can run the
tile past its end), the port refuses it. The conversion paths are held to
libavif's avifImageYUVToRGB over seeded planes, the 16-bit scaler to its
avifImageScale, the lookups to the library's bytes.
"""
from __future__ import annotations

import ctypes
import json
import os
import struct
import sys

import numpy as np
import pytest
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from l3c_tpu.data import images as jimages  # noqa: E402
from l3c_torch.data import (av1_block, av1_obu, av1_tables, avif,  # noqa
                            avif_scale, avif_yuv)
from l3c_torch.data import images as timages  # noqa: E402
import test_torch_port_avif as A  # noqa: E402

ROOT = A.ROOT
FIXTURES = os.path.join(ROOT, "l3c_torch", "data", "fixtures", "avif_deep")
DEPTHS = (10, 12)
# the 8-bit fixtures rewritten at each depth: lossy 4:2:0 / 4:2:2 with
# deblocking, CDEF and loop restoration, restoration alone, AV1 lossless
# 4:4:4 and identity, grey, limited range at an odd size, FCC (libavif's
# float path), film grain (AR lag 3, chroma from luma, 4:4:4 at an odd
# size), quantizer matrices, palettes, intra block copy, RGBA and
# premultiplied RGBA, a 2 x 2 grid and a premultiplied one, frames and
# alpha scaled to ispe
SOURCES = ("o_cdef_420.avif", "o_cdef_422.avif", "p_lr_q30_wiener.avif",
           "a_lossless_444.avif", "h_identity_lossless.avif",
           "n_deblock_q18_400.avif", "f_limited_420.avif",
           "mc04_0_limited.avif", "v_grain05_420.avif",
           "v_grain15_422.avif", "v_grain16_444_odd.avif", "q_qm_420.avif",
           "i_palette_screen_420.avif", "i_palette_screen_444.avif",
           "s_intrabc_420.avif", "s_intrabc_420_sub8x8.avif",
           "r_default_rgba.avif", "t_premultiplied.avif",
           "grid_2x2_420.avif", "grid_premultiplied.avif",
           "ispe_down_420.avif", "ispe_alpha_up.avif")
# a 4:4:4 save with every in-loop filter at an odd size (no 8-bit
# fixture has one), Pillow's keywords
NEW = {"o_cdef_444_odd.avif": (lambda: A.waves(75, 93, 9), dict(
    quality=40, speed=2, subsampling="4:4:4",
    advanced={"enable-cdef": "1"}))}
# the 512^2 default save at 10 bits: coded in chip_smoke's phase avif
CODED = ("x_coded_default_512_420_10.avif",)


# ------------------------------------------------------- the depth rewrite

def _leb128(n: int) -> bytes:
    out = bytearray()
    while True:
        out.append((n & 0x7F) | (0x80 if n >> 7 else 0))
        n >>= 7
        if not n:
            return bytes(out)


def seq_at_depth(obu: bytes, depth: int):
    """The sequence header OBU at the start of `obu` written again at
    `depth` bits, and av1C's bytes 1-2 for it. Its reads are logged (as
    `_seq_positions` logs them) and replayed up to high_bitdepth; the
    colour config is written anew (profile 2 for 12 bits, with the
    mono_chrome bit a profile-1 header lacks and the subsampling bits
    profile 2 reads at 12 bits), then the trailing bits."""
    reads = []

    class Log(av1_obu.Bits):
        def f(self, n):
            v = super().f(n)
            reads.append((n, v))
            return v
    typ, _, _, at, end = next(av1_obu.obus(obu, "x"))
    assert typ == av1_obu.OBU_SEQUENCE_HEADER and obu[0] & 2
    s = av1_obu.sequence_header(Log(obu, at, end, "x"))
    ns = [n for n, _ in reads]
    cdp = any(ns[i:i + 4] == [1, 8, 8, 8] for i in range(len(ns)))
    identity = (s.cp, s.tc, s.mc) == (1, 13, 0)
    # the colour config's reads from high_bitdepth on, film grain's last
    tail = 1 + (s.profile == 2 and s.bit_depth > 8) + (s.profile != 1) + \
        1 + 3 * cdp + 1 + 1
    if not s.mono and not identity:
        tail += (s.profile == 2 and s.bit_depth == 12) * (1 + s.ssx) + \
            (s.ssx and s.ssy) + 1
    high = len(reads) - tail
    assert reads[high] == (1, int(s.bit_depth > 8))
    prof = s.profile if depth == 10 else 2
    out = [(3, prof)] + reads[1:high] + [(1, 1)]
    if prof == 2:
        out.append((1, int(depth == 12)))
    if prof != 1:
        out.append((1, s.mono))
    out.append((1, int(cdp)))
    if cdp:
        out += [(8, s.cp), (8, s.tc), (8, s.mc)]
    if s.mono or identity:
        out.append((1, s.full_range if s.mono else s.separate_uv_delta_q))
    else:
        out.append((1, s.full_range))
        if prof == 2 and depth == 12:
            out.append((1, s.ssx))
            if s.ssx:
                out.append((1, s.ssy))
        if s.ssx and s.ssy:
            out.append((2, s.csp))
        out.append((1, s.separate_uv_delta_q))
    out.append((1, s.film_grain_present))
    bits = [(v >> (n - 1 - i)) & 1 for n, v in out for i in range(n)] + [1]
    bits += [0] * (-len(bits) % 8)
    payload = bytes(int("".join(map(str, bits[i:i + 8])), 2)
                    for i in range(0, len(bits), 8))
    head = obu[:1 + ((obu[0] >> 2) & 1)]
    av1c = bytes([(prof << 5) | (s.seq_level_idx[0] & 31),
                  0x40 | (int(depth == 12) << 5) | (s.mono << 4) |
                  (s.ssx << 3) | (s.ssy << 2) | s.csp])
    return head + _leb128(len(payload)) + payload, av1c


def _obus_at_depth(data: bytes, depth: int):
    """OBUs with their sequence header at `depth` bits, and av1C's bytes
    1-2 for it."""
    out, at, av1c = b"", 0, None
    for typ, _, _, _, end in av1_obu.obus(data, "x"):
        if typ == av1_obu.OBU_SEQUENCE_HEADER:
            new, av1c = seq_at_depth(data[at:end], depth)
            out += new
        else:
            out += data[at:end]
        at = end
    return out, av1c


def set_depth(blob: bytes, depth: int, only=None) -> bytes:
    """The file with its AV1 items (those in `only`, else all) at `depth`
    bits: each item's sequence header, av1C (bytes 1-2 and its config
    OBUs) and pixi, and every other item's pixi; written again by `mux`,
    since a header that grows moves the OBU, mdat and iloc offsets."""
    f = A.items_of(blob)
    for k, it in f["items"].items():
        if only is not None and k not in only:
            continue
        if it["type"] == b"av01":
            it["data"], av1c = _obus_at_depth(it["data"], depth)
        props = []
        for t, b, e in it["props"]:
            if t == b"av1C":
                cfg = _obus_at_depth(b[4:], depth)[0] if b[4:] else b""
                b = b[:1] + av1c + b[3:4] + cfg
            elif t == b"pixi":
                b = b[:5] + bytes([depth]) * b[4]
            props.append((t, b, e))
        it["props"] = props
    return A.mux(f)


def _stem(name):
    return name.rsplit(".", 1)[0]


def deep_corpus() -> dict:
    """name -> a function writing the fixture."""
    def from_fixture(src, d):
        def make():
            with open(os.path.join(A.FIXTURES, src), "rb") as f:
                return set_depth(f.read(), d)
        return make

    def from_save(img, kw, d):
        return lambda: set_depth(A.save(img(), **kw), d)
    out = {}
    for d in DEPTHS:
        for src in SOURCES:
            out[f"{_stem(src)}_{d}.avif"] = from_fixture(src, d)
        for name, (img, kw) in NEW.items():
            out[f"{_stem(name)}_{d}.avif"] = from_save(img, kw, d)
    out[CODED[0]] = from_fixture("x_coded_default_512_420.avif", 10)
    return out


def _pillow(p):
    """Pillow's RGB of the file, or its reason for refusing it."""
    try:
        with Image.open(p) as im:
            return np.asarray(im.convert("RGB")), (im.format, im.mode,
                                                   list(im.size[::-1]))
    except Exception as e:             # noqa: BLE001 (Pillow's refusals)
        return str(e), None


def _port_refusal(p):
    try:
        timages.load_image_uint8(p)
    except ValueError as e:
        return str(e).split(": ", 1)[1]
    return None


def deep_expected_now(folder=FIXTURES):
    """expected.json as Pillow and the JAX package give it now: each
    file's format, mode, size and digest, or Pillow's reason for refusing
    it ("pillow") and the port's ("port", as chip_smoke's fixtures_hold
    reads it)."""
    files = {}
    for n in sorted(os.listdir(folder)):
        if n == "expected.json":
            continue
        p = os.path.join(folder, n)
        got, meta = _pillow(p)
        if meta is None:
            files[n] = {"pillow": got, "port": _port_refusal(p)}
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


def _lib():
    path = A.libavif()
    if path is None:
        pytest.skip("this Pillow bundles no libavif")
    return ctypes.CDLL(path)


def _read(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


# ------------------------------------------------------------- the fixtures

def test_deep_fixtures_are_their_sources_rewritten():
    """Each fixture is its 8-bit source with the depth rewritten, byte
    for byte (the sources are committed, or aom's deterministic saves),
    and expected.json is what Pillow and the JAX loader give now."""
    make = deep_corpus()
    assert sorted(make) == _names()
    for name, fn in make.items():
        assert fn() == _read(name), name
    want = _expected()
    assert deep_expected_now() == {k: want[k] for k in ("files", "coded")}
    assert want["made_by"]["libavif"] == "1.3.0"
    assert sum(os.path.getsize(os.path.join(FIXTURES, n))
               for n in os.listdir(FIXTURES)) < 300_000


@pytest.mark.parametrize("name", _names())
def test_port_reads_each_deep_fixture_as_pillow(name):
    """Pillow's digest and the JAX loader's pixels, or, where Pillow
    refuses the file, a refusal: the port's reason recorded beside
    Pillow's (dav1d's failed colour or alpha planes are the port's
    damaged tile data or alpha of another depth)."""
    e = _expected()["files"][name]
    p = os.path.join(FIXTURES, name)
    if "pillow" in e:
        assert _port_refusal(p) == e["port"]
        assert "Decoding of" in e["pillow"] and "damaged" in e["port"]
        return
    assert timages.image_format(p) == e["format"] == "AVIF"
    assert timages.image_mode(p) == e["mode"]
    assert list(timages.image_size(p)) == e["size"]
    got = timages.load_image_uint8(p)
    assert A._digest(got) == e["sha256"]
    assert np.array_equal(got, jimages.load_image_uint8(p))


def test_both_depths_and_every_kind_are_decoded():
    """At each depth the decoded fixtures cover every layout, lossless,
    palettes, intra block copy, grain, alpha, a grid and scaling; and
    Pillow refuses some flipped files, which the port refuses too."""
    e = _expected()["files"]
    for d in DEPTHS:
        ok = {n for n in e if n.endswith(f"_{d}.avif") and "sha256" in e[n]}
        for part in ("420", "422", "444", "400", "lossless", "palette",
                     "intrabc", "grain", "rgba", "premultiplied", "grid",
                     "ispe", "limited", "mc04", "qm"):
            assert any(part in n for n in ok), (d, part)
    assert any("pillow" in v for v in e.values())


# ----------------------------------------------------- planes, stage by stage

STAGED = [n for n in _names() if "sha256" in _expected()["files"].get(
    n, {}) and n not in CODED and not n.startswith(("grid", "ispe"))]


@pytest.mark.parametrize("name", STAGED)
def test_deep_planes_equal_dav1ds_at_every_stage(name):
    """The port's planes after deblocking, CDEF and loop restoration
    against dav1d's with the later filters off, the film grain with
    `apply_grain` off and on, and the decoded planes against libavif's:
    a fault shows as the first plane and 4 x 4 block that differ."""
    lib = _lib()
    blob = _read(name)
    m = avif.parse(blob, name)
    data = avif._item_bytes(blob, m, m.primary, name)
    seq, f, _ = av1_obu.parse_av1(data, name)
    got = A.port_stages(data)
    assert got[-1][0].dtype == np.uint16
    for k, mask in enumerate((1, 3, 7)):
        want = A._dav1d_planes(lib, data, mask, grain=0)
        assert A._first_difference(got[k], want) is None, \
            (mask, A._first_difference(got[k], want))
    grained = av1_block.add_grain(got[-1], seq, f)
    assert A._first_difference(grained, A._dav1d_planes(lib, data, 7)) \
        is None
    assert A._first_difference(grained, A._libavif_planes(lib, blob)) is None


def test_deep_grids_and_scaled_frames_equal_libavifs_planes():
    """A grid's assembled planes and frames or alpha scaled to their ispe
    (ScalePlane_16 at the frame's depth, before any conversion) equal
    the planes libavif hands Pillow."""
    lib = _lib()
    for name in _names():
        if not name.startswith(("grid", "ispe")) or \
                "pillow" in _expected()["files"][name]:
            continue
        blob = _read(name)
        m = avif.parse(blob, name)
        planes, seqs = avif._planes(blob, m, m.primary, name)
        assert seqs[0].bit_depth in DEPTHS
        assert A._first_difference(planes, A._libavif_planes(lib, blob)) \
            is None, name


def test_deep_quantizer_lookups_are_the_librarys():
    """The 10- and 12-bit DC / AC lookups are dav1d's dq_tbl in the
    bundled library, the pairs after the 8-bit ones."""
    from test_torch_port_av1 import DEEP_Q, deep_qlookups
    path = A.libavif()
    if path is None:
        pytest.skip("this Pillow bundles no libavif")
    with open(path, "rb") as f:
        got = deep_qlookups(f.read())
    for name in DEEP_Q:
        assert got[name] == getattr(av1_tables, name), name
    assert (av1_tables.DC_QLOOKUP_10[-1], av1_tables.AC_QLOOKUP_10[-1]) == \
        (5347, 7312)
    assert (av1_tables.DC_QLOOKUP_12[-1], av1_tables.AC_QLOOKUP_12[-1]) == \
        (21387, 29247)


# --------------------------------------------------------- the conversion

def _convert_by_libavif(planes, depth, layout, full, cicp, alpha=None,
                        prem=False):
    """avifImageYUVToRGB of an avifImage made here (libavif 1.3.0's
    offsets: yuvRange 16, planes 24, row bytes 48, alphaPlane 64,
    alphaRowBytes 72, alphaPremultiplied 80, CICP 104) to 8-bit RGB, or
    RGBA where there is alpha, as Pillow asks; None where it refuses."""
    c = ctypes
    lib = A.libavif_lib()
    h, w = planes[0].shape
    im = lib.avifImageCreate(w, h, depth, layout)
    try:
        struct.pack_into("<I", (c.c_char * 4).from_address(im + 16), 0,
                         int(full))
        struct.pack_into("<I", (c.c_char * 4).from_address(im + 80), 0,
                         int(prem))
        struct.pack_into("<3H", (c.c_char * 6).from_address(im + 104), 0,
                         *cicp)
        assert lib.avifImageAllocatePlanes(
            c.c_void_p(im), 1 | (2 if alpha is not None else 0)) == 0
        ptrs = (c.c_void_p * 3).from_address(im + 24)
        rows = (c.c_uint32 * 3).from_address(im + 48)
        dst = [(ptrs[k], rows[k], p) for k, p in enumerate(planes)]
        if alpha is not None:
            aptr, arow = struct.unpack_from(
                "<QI", (c.c_char * 12).from_address(im + 64))
            dst.append((aptr, arow, alpha))
        for ptr, row, p in dst:
            ph, pw = p.shape
            np.ctypeslib.as_array((c.c_uint16 * (row // 2 * ph)).from_address(
                ptr)).reshape(ph, row // 2)[:, :pw] = p
        rgb = c.create_string_buffer(256)
        lib.avifRGBImageSetDefaults(rgb, c.c_void_p(im))
        ch = 3 if alpha is None else 4
        struct.pack_into("<II", rgb, 8, 8, ch - 3)     # 8 bits, RGB(A)
        lib.avifRGBImageAllocatePixels(rgb)
        try:
            if lib.avifImageYUVToRGB(c.c_void_p(im), rgb):
                return None
            ptr, = struct.unpack_from("<Q", rgb, 48)
            stride, = struct.unpack_from("<I", rgb, 56)
            out = np.ctypeslib.as_array((c.c_uint8 * (stride * h))
                                        .from_address(ptr))
            return out.reshape(h, stride)[:, :ch * w].reshape(
                h, w, ch).copy()
        finally:
            lib.avifRGBImageFreePixels(rgb)
    finally:
        lib.avifImageDestroy(c.c_void_p(im))


_LAYOUT = {"444": (1, 0, 0), "422": (2, 1, 0), "420": (3, 1, 1),
           "400": (4, 1, 1)}


def _port_rgb(planes, depth, ss, full, cicp, alpha=None, prem=False):
    """What avif.decode_avif does with decoded planes: to_rgb, then the
    8-bit alpha and, for a premultiplied image libavif does not divide
    itself, ARGBUnattenuate."""
    _, ssx, ssy = _LAYOUT[ss]
    mono = ss == "400"
    cp, _, mc = cicp
    if avif_yuv.refused_matrix(mc, full, not mono and bool(ssx or ssy),
                               depth):
        return None
    rgb = avif_yuv.to_rgb(planes, ssx, ssy, mono, mc, full, "x", cp, alpha,
                          prem, depth)
    if alpha is None:
        return rgb
    a = avif_yuv.alpha_8bit(alpha, depth, ssx, ssy, mono, mc, cp, full)
    if prem and not avif_yuv.divides_alpha(ssx, ssy, mono, mc, cp, full,
                                           depth):
        rgb = avif.unpremultiply(rgb, a)
    return np.dstack([rgb, a])


def _random_planes(r, depth, ss, h, w):
    _, ssx, ssy = _LAYOUT[ss]
    planes = [r.randint(0, 1 << depth, (h, w))]
    if ss != "400":
        planes += [r.randint(0, 1 << depth, ((h + ssy) >> ssy,
                                             (w + ssx) >> ssx))
                   for _ in (1, 2)]
    return [p.astype(np.uint16) for p in planes]


@pytest.mark.parametrize("depth", DEPTHS)
def test_deep_rgb_over_a_million_triples_as_libavif(depth):
    """2^20 seeded (y, u, v) triples at 4:4:4, the range's edges among
    them, through libavif's avifImageYUVToRGB under BT.601, BT.709 and
    BT.2020 (libyuv after the downshift to 8 bits) and FCC (libavif's
    float path at full depth), full and limited range: equal to
    `avif_yuv.to_rgb`."""
    r = np.random.RandomState(depth)
    top = (1 << depth) - 1
    planes = _random_planes(r, depth, "444", 1024, 1024)
    edges = np.array([0, 1, 2, top - 1, top, 16 << (depth - 8),
                      235 << (depth - 8), 240 << (depth - 8)], np.uint16)
    for p, sh in zip(planes, (0, 1, 2)):
        p[sh, :] = np.tile(edges, 128)
    for cicp in ((1, 13, 6), (1, 1, 1), (9, 16, 9), (2, 2, 4)):
        for full in (1, 0):
            got = _port_rgb(planes, depth, "444", full, cicp)
            want = _convert_by_libavif(planes, depth, 1, full, cicp)
            assert np.array_equal(got, want), (cicp, full)


# (layout, matrix as (cp, tc, mc), alpha, premultiplied): every path of
# the deep conversion at odd sizes
CONVERSIONS = [(ss, cicp, alpha, prem)
               for ss in ("420", "422", "444", "400")
               for cicp in ((1, 13, 6), (1, 1, 1), (9, 16, 9), (2, 2, 4),
                            (2, 2, 8), (1, 13, 0), (12, 2, 12),
                            (2, 2, 16))
               for alpha, prem in ((0, 0), (1, 0), (1, 1))
               if not (cicp[2] == 0 and ss in ("420", "422"))]


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("ss", ["420", "422", "444", "400"])
def test_deep_conversion_paths_as_libavif(depth, ss):
    """Random planes at odd sizes through every path the deep conversion
    takes, in both ranges, without alpha (RGB) and with it (RGBA,
    premultiplied or not): libyuv after the downshift, libyuv's 16-bit
    rows with alpha (I010 / I210 / I410, and I012 at 4:2:0 with its
    nearest chroma), libyuv's I400 on the downshifted grey, the float path
    at full depth (FCC, YCgCo, identity, MC 12 over other primaries,
    YCgCo-Re at 10 bits, grey), alpha truncated or scaled, the colour
    divided by libavif or by ARGBUnattenuate: each equal to libavif's
    RGB(A), or refused where libavif refuses."""
    r = np.random.RandomState(depth * 7 + int(ss))
    layout = _LAYOUT[ss][0]
    for _, cicp, with_alpha, prem in [c for c in CONVERSIONS if c[0] == ss]:
        for full in (1, 0):
            planes = _random_planes(r, depth, ss, 37, 29)
            alpha = r.randint(0, 1 << depth, (37, 29)).astype(np.uint16) \
                if with_alpha else None
            want = _convert_by_libavif(planes, depth, layout, full, cicp,
                                       alpha, prem)
            got = _port_rgb(planes, depth, ss, full, cicp, alpha, prem)
            assert (got is None) == (want is None), (cicp, full, alpha)
            if got is not None:
                assert np.array_equal(got[..., :3], want[..., :3]), \
                    (cicp, full, with_alpha, prem)
                if alpha is not None:
                    assert np.array_equal(got[..., 3], want[..., 3])


# ScalePlane_16's paths: (source w, h, target w, h), as the 8-bit test's
@pytest.mark.parametrize("path_name", sorted(A.SCALE_PATHS))
def test_scale_plane_16_equals_libavifs(path_name):
    """Each path libyuv's ScalePlane_16 takes under libavif's box filter,
    on seeded random 10- and 12-bit planes and smooth ones, against
    libavif's own avifImageScale of a 16-bit avifImage."""
    _lib()
    r = np.random.RandomState(len(path_name) + 1)
    for depth in DEPTHS:
        for sw, sh, dw, dh in A.SCALE_PATHS[path_name]:
            for plane in (r.randint(0, 1 << depth, (sh, sw)),
                          np.cumsum(r.randint(-4, 5, (sh, sw)) << (
                              depth - 8), 1) + (128 << (depth - 8))):
                plane = np.clip(plane, 0, (1 << depth) - 1).astype(np.uint16)
                got = avif_scale.scale_plane(plane, dw, dh, depth)
                assert got.dtype == np.uint16
                assert np.array_equal(got, A._scale_by_libavif(
                    plane, dw, dh, depth)), (depth, sw, sh, dw, dh)


# ---------------------------------------------- libavif's rules, damage

def _outcome(blob, tmp_path, name):
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(blob)
    return A._outcome(p)


def test_alpha_of_another_depth_is_refused_as_libavif(tmp_path):
    """libavif fails the alpha plane ("Decoding of alpha plane failed")
    of an image whose alpha item's depth is not the colour's, whichever is
    deeper; so does the port."""
    for src in ("r_default_rgba.avif", "t_premultiplied.avif"):
        with open(os.path.join(A.FIXTURES, src), "rb") as f:
            blob = f.read()
        m = avif.parse(blob, src)
        colour, alpha = m.primary, m.alpha
        for dc, da in ((10, 8), (8, 10), (12, 10), (10, 12)):
            b = blob if dc == 8 else set_depth(blob, dc, {colour})
            b = b if da == 8 else set_depth(b, da, {alpha})
            pil, port = _outcome(b, tmp_path, f"mix{dc}{da}.avif")
            assert pil is None and port is None, (src, dc, da)


def test_grid_cell_of_another_depth_is_refused_as_libavif(tmp_path):
    """A grid whose cells differ in depth: libavif refuses it (the cells'
    av1C differ), and so does the port; the grid rewritten whole
    decodes."""
    blob = _read("grid_2x2_420_10.avif")
    m = avif.parse(blob, "x")
    cells = m.grids[m.primary].cells
    odd = set_depth(blob, 12, {cells[1]})
    pil, port = _outcome(odd, tmp_path, "cell.avif")
    assert pil is None and port is None
    pil, port = _outcome(blob, tmp_path, "whole.avif")
    assert np.array_equal(pil, port)


@pytest.mark.parametrize("name", ["p_lr_q30_wiener_10.avif",
                                  "v_grain05_420_10.avif",
                                  "o_cdef_444_odd_12.avif",
                                  "t_premultiplied_12.avif"])
def test_truncated_and_bit_flipped_deep_files_as_pillow(tmp_path, name):
    """10-bit files with loop restoration and with film grain, a 12-bit
    one with every in-loop filter and a premultiplied 12-bit one, cut or
    with a seeded bit flipped in its container, headers or
    tile data: where Pillow decodes, the port gives its pixels (the
    high-bit-depth coefficient clips included) or names a tool ROADMAP F6
    still lists; where Pillow refuses, the port refuses."""
    blob = _read(name)
    r = np.random.RandomState(len(name))
    cases = [blob[:n] for n in (len(blob) - 1, len(blob) // 2, 300)]
    for _ in range(40):
        b = bytearray(blob)
        b[r.randint(len(b))] ^= 1 << r.randint(8)
        cases.append(bytes(b))
    decoded = 0
    for k, b in enumerate(cases):
        pil, port = _outcome(b, tmp_path, f"f{k}.avif")
        if pil is None:
            assert port is None or A._names_an_f6_tool(port), k
        elif isinstance(port, str):
            assert A._names_an_f6_tool(port), (k, port)
        else:
            assert np.array_equal(pil, port), k
            decoded += 1
    assert 10 <= decoded < len(cases)


def make_deep_fixtures(d=FIXTURES):
    os.makedirs(d, exist_ok=True)
    for n in os.listdir(d):
        os.remove(os.path.join(d, n))
    for name, make in deep_corpus().items():
        with open(os.path.join(d, name), "wb") as f:
            f.write(make())
    exp = {**deep_expected_now(d), "made_by": A._versions()}
    with open(os.path.join(d, "expected.json"), "w") as f:
        json.dump(exp, f, indent=1, sort_keys=True)
        f.write("\n")
    return exp


if __name__ == "__main__":
    exp = make_deep_fixtures()
    print(f"wrote {len(exp['files'])} fixtures and expected.json to "
          f"{FIXTURES}")
