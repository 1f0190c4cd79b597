"""The port's AVIF reader (l3c_torch/data/avif.py, av1_*.py, avif_yuv.py)
against Pillow 12.1's AVIF plugin (libavif 1.3.0, dav1d 1.5.1, libyuv)
and the JAX package's loader.

The committed fixtures (l3c_torch/data/fixtures/avif, written by
`python tests/test_torch_port_avif.py`) are Pillow's own AVIF saves, aom
3.12.1 inside libavif: with the in-loop filters switched off
(`advanced=OFF`) and aom's keys steering the coding tools, and with them
on (Pillow's default saves run the deblocking filter; `speed=2` adds
loop restoration, `enable-cdef=1` CDEF); the matrices Pillow's save
cannot set (BT.709, identity) are Pillow's files with their colour
description rewritten (`set_cicp`). expected.json holds Pillow's format,
mode, size and the digest of convert("RGB"), or the port's refusal;
together the decoded files cover the tools the decoder has
(`test_fixtures_cover_the_decoder`). Each filter is held stage by stage
to dav1d's planes with the later filters switched off (its exported API,
`Dav1dSettings.inloop_filters`), and the decoded planes to libavif's;
film grain to dav1d's planes with `Dav1dSettings.apply_grain` at 0 and
at 1 (Pillow's pixels carry the grain: libavif's planes are dav1d's with
it on); quantizer-matrix and intra-block-copy frames to dav1d's planes
with every filter off; premultiplied alpha to libavif's own
avifRGBImageUnpremultiplyAlpha over every colour and alpha.
"""
from __future__ import annotations

import collections
import ctypes
import glob
import hashlib
import io
import json
import os
import struct
import sys

import numpy as np
import PIL
import pytest
from PIL import Image

from l3c_tpu.data import images as jimages
from l3c_torch.data import (av1_block, av1_cdef, av1_filmgrain,
                            av1_loopfilter, av1_obu, av1_recon,
                            av1_restoration, avif)
from l3c_torch.data import images as timages

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "l3c_torch", "data", "fixtures", "avif")
OFF = {"enable-cdef": "0", "enable-restoration": "0",
       "loopfilter-control": "0"}
CODED = ("y_coded_lossy_512_420.avif", "z_coded_lossless_444.avif",
         "x_coded_default_512_420.avif", "w_coded_grain_512_420.avif",
         "grid_coded_1024_420.avif")
SCREEN = {"tune-content": "screen", "enable-intrabc": "1"}
LISTING_MIN_SIZE = 20


def save(img: np.ndarray, **kw) -> bytes:
    f = io.BytesIO()
    Image.fromarray(img).save(f, "AVIF", **kw)
    return f.getvalue()


def photo(h, w, seed):
    from test_torch_port_prep import _photo
    return _photo(h, w, seed, noise=6)


def textured(h, w, seed):
    from test_torch_port_prep import _photo_textured
    return _photo_textured(h, w, seed)


def waves(h, w, seed):
    """Crossed sinusoids and a ramp with grain (directional, filter-intra
    and 1:4 transforms)."""
    r = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 7.0 + seed) * np.cos(y / 11.0),
                    128 + 90 * np.cos((x + y) / 9.0),
                    x * 255 // max(1, w - 1)], -1)
    return np.clip(img + r.randint(-20, 21, img.shape), 0, 255).astype(
        np.uint8)


def screen(h, w, seed):
    """Flat rectangles of a few colours (screen content: palettes)."""
    r = np.random.RandomState(seed)
    img = np.zeros((h, w, 3), np.uint8) + r.randint(0, 256, 3).astype(
        np.uint8)
    for _ in range(12):
        y0, x0 = r.randint(0, h), r.randint(0, w)
        img[y0:y0 + r.randint(2, h // 2), x0:x0 + r.randint(2, w // 2)] = \
            r.randint(0, 256, 3)
    return img


def bands(h, w, seed, period, vertical):
    """Bands `period` wide of flat colours with a ripple across them
    (rectangular partitions: 64 x 32 / 32 x 64 / 64 x 16 transforms)."""
    r = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    k = (x if vertical else y) // period
    out = r.randint(40, 220, (k.max() + 1, 3))[k] + \
        (np.sin((y if vertical else x) / 3.0) * 25)[..., None] + \
        r.randint(-3, 4, (h, w, 3))
    return np.clip(out, 0, 255).astype(np.uint8)


def glyphs(h, w, seed, gh=9, gw=6, n=8, step=(11, 7), noise=0):
    """Screen text: `n` random glyphs of gh x gw in three inks, set on a
    grid `step` apart, with seeded noise (intra block copy: odd steps put
    4:2:0 chroma half a sample off, noise leaves the copies residual)."""
    r = np.random.RandomState(seed)
    bank = [(r.rand(gh, gw) < 0.45) for _ in range(n)]
    img = np.full((h, w, 3), 240, np.int64)
    for y in range(1, h - gh, step[0]):
        for x in range(1, w - gw, step[1]):
            img[y:y + gh, x:x + gw][bank[r.randint(n)]] = (
                20 + r.randint(0, 3) * 60, 30, 90)
    if noise:
        img += r.randint(-noise, noise + 1, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _seq_positions(obu: bytes) -> dict:
    """Bit positions of the sequence header's colour primaries and matrix
    coefficients in the OBU (`obu` starts at its header byte)."""
    reads = []

    class Log(av1_obu.Bits):
        def f(self, n):
            reads.append((self.bit, n))
            return super().f(n)
    typ, _, _, at, end = next(av1_obu.obus(obu, "x"))
    assert typ == av1_obu.OBU_SEQUENCE_HEADER
    av1_obu.sequence_header(Log(obu, at, end, "x"))
    for i in range(len(reads) - 2):
        if [n for _, n in reads[i:i + 3]] == [8, 8, 8] and \
                reads[i - 1][1] == 1:
            return {"cp": reads[i][0], "mc": reads[i + 2][0]}
    return None                     # no colour description in the header


def _put(b: bytearray, bit: int, n: int, v: int):
    for k in range(n):
        byte, sh = (bit + k) >> 3, 7 - ((bit + k) & 7)
        b[byte] = (b[byte] & ~(1 << sh)) | (((v >> (n - 1 - k)) & 1) << sh)


def strip(h, w, seed):
    """Texture, a flat band and a photo side by side (restoration units
    that differ: Wiener, self-guided, none)."""
    img = textured(h, w, seed).copy()
    img[:, w // 3:2 * w // 3] = (90, 140, 200)
    img[:, 2 * w // 3:] = photo(h, w - 2 * w // 3, seed + 1)
    return img


def flat_middle(h, w, seed):
    img = textured(h, w, seed).copy()
    img[h // 4:3 * h // 4, w // 4:3 * w // 4] = (30, 200, 90)
    return img


def set_cicp(blob: bytes, cp: int, mc: int) -> bytes:
    """Pillow's file with another colour description: the colr nclx box,
    and the sequence headers (in av1C and in the item's OBUs) where they
    carry one (aom's do not: libavif takes the matrix from nclx)."""
    b = bytearray(blob)
    i = b.find(b"colrnclx")
    struct.pack_into(">H", b, i + 8, cp)
    struct.pack_into(">H", b, i + 12, mc)
    c = b.find(b"av1C")
    starts = [b.find(b"mdat") + 4]
    if struct.unpack(">I", b[c - 4:c])[0] > 12:        # configOBUs
        starts.append(c + 8)
    for at in starts:
        while b[at] >> 3 & 15 != av1_obu.OBU_SEQUENCE_HEADER:
            at += 1
        pos = _seq_positions(bytes(b[at:]))
        if pos:
            _put(b, 8 * at + pos["cp"], 8, cp)
            _put(b, 8 * at + pos["mc"], 8, mc)
    return bytes(b)


def corpus():
    """name -> (pixels, Pillow's save keywords, cicp rewrite or None)."""
    adv = lambda **kw: dict(OFF, **kw)  # noqa: E731
    tx = adv(**{"enable-tx64": "1", "enable-rect-partitions": "1",
                "enable-1to4-partitions": "1", "min-partition-size": "16",
                "enable-ab-partitions": "1"})
    return {
        "a_lossless_444.avif": (photo(40, 52, 1), dict(
            quality=100, subsampling="4:4:4"), None),
        "b_q94_444_odd.avif": (photo(45, 61, 2), dict(
            quality=94, subsampling="4:4:4", advanced=adv()), None),
        "c_q80_422.avif": (photo(50, 70, 3), dict(
            quality=80, subsampling="4:2:2", advanced=adv(
                **{"enable-cfl-intra": "1"})), None),
        "d_q60_420_tools.avif": (waves(96, 96, 4), dict(
            quality=60, subsampling="4:2:0", speed=2, advanced=adv(
                **{"enable-filter-intra": "1", "enable-cfl-intra": "1",
                   "enable-smooth-intra": "1", "enable-paeth-intra": "1",
                   "enable-angle-delta": "1"})), None),
        "d_q60_420_smooth.avif": (textured(96, 96, 4), dict(
            quality=60, subsampling="4:2:0", speed=2, advanced=adv(
                **{"enable-smooth-intra": "1", "enable-paeth-intra": "1",
                   "enable-angle-delta": "1"})), None),
        "e_q30_400.avif": (photo(40, 56, 5), dict(
            quality=30, subsampling="4:0:0", advanced=adv()), None),
        "f_limited_420.avif": (photo(37, 29, 6), dict(
            quality=70, subsampling="4:2:0", range="limited",
            advanced=adv()), None),
        "g_bt709_444.avif": (photo(36, 44, 7), dict(
            quality=85, subsampling="4:4:4", advanced=adv()), (1, 1)),
        "g_bt709_limited_420.avif": (photo(33, 35, 8), dict(
            quality=75, subsampling="4:2:0", range="limited",
            advanced=adv()), (1, 1)),
        "h_identity_lossless.avif": (photo(30, 42, 9), dict(
            quality=100, subsampling="4:4:4"), (2, 0)),
        "i_palette_screen_444.avif": (screen(64, 80, 10), dict(
            quality=85, subsampling="4:4:4", advanced=adv(
                **{"tune-content": "screen", "enable-palette": "1"})),
            None),
        "i_palette_screen_420.avif": (screen(48, 72, 11), dict(
            quality=70, subsampling="4:2:0", advanced=adv(
                **{"tune-content": "screen", "enable-palette": "1"})),
            None),
        "j_tiles_sb128.avif": (photo(160, 272, 12), dict(
            quality=50, subsampling="4:2:0", tile_rows=1, tile_cols=1,
            advanced=adv(**{"sb-size": "128"})), None),
        "k_bands_h32.avif": (bands(128, 128, 0, 32, False), dict(
            quality=80, subsampling="4:2:0", speed=0, advanced=tx), None),
        "k_bands_v32.avif": (bands(128, 128, 1, 32, True), dict(
            quality=80, subsampling="4:2:0", speed=0, advanced=tx), None),
        "k_bands_h16.avif": (bands(128, 128, 2, 16, False), dict(
            quality=80, subsampling="4:2:0", speed=0, advanced=tx), None),
        "l_deltaq_444.avif": (textured(64, 64, 13), dict(
            quality=70, subsampling="4:4:4", advanced=adv(
                **{"deltaq-mode": "2", "delta-lf-mode": "1"})), None),
        "m_q60_420_as.png": (textured(48, 64, 14), dict(
            quality=60, subsampling="4:2:0", advanced=adv()), None),
        # the deblocking filter at low quality (14-tap edges), sharpness
        "n_deblock_q20_422_sharp.avif": (photo(56, 72, 70), dict(
            quality=20, subsampling="4:2:2", advanced={"sharpness": "3"}),
            None),
        "n_deblock_q14_444.avif": (photo(48, 64, 71), dict(
            quality=14, subsampling="4:4:4"), None),
        "n_deblock_q18_400.avif": (photo(52, 60, 72), dict(
            quality=18, subsampling="4:0:0"), None),
        # CDEF (speed 2 adds loop restoration)
        "o_cdef_420.avif": (flat_middle(96, 160, 3), dict(
            quality=50, speed=2, advanced={"enable-cdef": "1"}), None),
        "o_cdef_422.avif": (waves(120, 136, 8), dict(
            quality=40, speed=2, subsampling="4:2:2",
            advanced={"enable-cdef": "1"}), None),
        "o_cdef_sb128.avif": (textured(136, 200, 75), dict(
            quality=35, speed=2, advanced={"enable-cdef": "1",
                                           "sb-size": "128"}), None),
        # loop restoration at speed 2: Wiener and self-guided units, 256
        # and 128 units, past one stripe, a last unit merged, two tiles
        "p_lr_q30_wiener.avif": (photo(120, 320, 76), dict(
            quality=30, speed=2), None),
        "p_lr_q60_switchable.avif": (strip(72, 640, 1), dict(
            quality=60, speed=2), None),
        "p_lr_q75_units128.avif": (strip(72, 640, 4), dict(
            quality=75, speed=2), None),
        "p_lr_q75_r1_0.avif": (waves(80, 384, 5), dict(
            quality=75, speed=2), None),
        "p_lr_tiles.avif": (textured(96, 320, 77), dict(
            quality=60, speed=2, tile_cols=1), None),
        # Pillow's default saves: the deblocking filter on
        "r_default_rgb.avif": (photo(40, 48, 20), {}, None),
        "r_default_rgba.avif": (np.dstack([photo(32, 40, 21), np.full(
            (32, 40), 200, np.uint8)]), {}, None),
        # at quality 90 aom writes no in-loop filter into a default save
        "u_default_q90.avif": (photo(40, 48, 22), dict(quality=90), None),
        "t_premultiplied.avif": (np.dstack([photo(24, 32, 23), np.full(
            (24, 32), 128, np.uint8)]), dict(alpha_premultiplied=True,
                                              advanced=OFF), None),
        # quantizer matrices (aom's qm-min / qm-max pick the levels)
        "q_qm_420.avif": (textured(96, 128, 3), dict(
            quality=40, subsampling="4:2:0", speed=6, advanced={
                "enable-qm": "1", "qm-min": "0", "qm-max": "4"}), None),
        "q_qm_444_deltaq.avif": (textured(72, 104, 32), dict(
            quality=60, subsampling="4:4:4", speed=0, advanced={
                "enable-qm": "1", "qm-min": "6", "qm-max": "12",
                "deltaq-mode": "2", "enable-rect-partitions": "1",
                "enable-1to4-partitions": "1"}), None),
        # intra block copy: inter transform sets 1-3, split transforms,
        # 4:2:0 chroma half a sample off and of sub-8 x 8 blocks, sb128
        "s_intrabc_444.avif": (glyphs(160, 160, 6, 20, 18, 5, (23, 21), 6),
                               dict(quality=60, subsampling="4:4:4", speed=2,
                                    advanced=SCREEN), None),
        "s_intrabc_444_reduced.avif": (glyphs(160, 160, 6, noise=8), dict(
            quality=60, subsampling="4:4:4", speed=2, advanced=dict(
                SCREEN, **{"reduced-tx-type-set": "1"})), None),
        "s_intrabc_420.avif": (glyphs(160, 160, 5, noise=8), dict(
            quality=60, subsampling="4:2:0", speed=2, advanced=SCREEN), None),
        "s_intrabc_420_sub8x8.avif": (glyphs(160, 160, 5), dict(
            quality=60, subsampling="4:2:0", speed=2, advanced=SCREEN), None),
        "s_intrabc_sb128.avif": (glyphs(160, 160, 6, noise=8), dict(
            quality=60, subsampling="4:4:4", speed=2, advanced=dict(
                SCREEN, **{"sb-size": "128"})), None),
        # film grain: aom's test vectors 5 (AR lag 3), 15 (chroma scaled
        # from luma), 16 and 1 (no overlap); its denoiser's own table
        "v_grain05_420.avif": (photo(64, 80, 24), dict(
            quality=55, subsampling="4:2:0", advanced={
                "film-grain-test": "5"}), None),
        "v_grain15_422.avif": (photo(56, 72, 25), dict(
            quality=55, subsampling="4:2:2", advanced={
                "film-grain-test": "15"}), None),
        "v_grain16_444_odd.avif": (photo(45, 67, 26), dict(
            quality=55, subsampling="4:4:4", advanced={
                "film-grain-test": "16"}), None),
        "v_grain01_400.avif": (photo(48, 64, 27), dict(
            quality=55, subsampling="4:0:0", advanced={
                "film-grain-test": "1"}), None),
        "v_denoise_420_odd.avif": (photo(153, 149, 7), dict(
            quality=60, subsampling="4:2:0", advanced={
                "denoise-noise-level": "25"}), None),
        CODED[0]: (textured(512, 512, 30), dict(
            quality=80, subsampling="4:2:0", advanced=adv()), None),
        CODED[1]: (textured(96, 128, 31), dict(
            quality=100, subsampling="4:4:4"), None),
        CODED[2]: (textured(512, 512, 30), dict(quality=75), None),
        CODED[3]: (textured(512, 512, 30), dict(advanced={
            "denoise-noise-level": "20"}), None),
    }


def libavif_lib():
    lib = ctypes.CDLL(libavif())
    for n in ("avifEncoderCreate", "avifImageCreate", "avifDecoderCreate",
              "avifImageCreateEmpty"):
        getattr(lib, n).restype = ctypes.c_void_p
    return lib


_LAYOUTS = {"4:4:4": 1, "4:2:2": 2, "4:2:0": 3, "4:0:0": 4}


def _avif_image(lib, px, subsampling, full, cicp, premultiplied):
    """An avifImage (offsets of libavif 1.3.0: yuvRange 16,
    alphaPremultiplied 80, CICP 104) converted from RGB(A) by
    avifImageRGBToYUV; returns it and the pixel buffer it borrows."""
    c = ctypes
    h, w, ch = px.shape
    im = lib.avifImageCreate(w, h, 8, _LAYOUTS[subsampling])
    struct.pack_into("<I", (c.c_char * 4).from_address(im + 16), 0,
                     int(full))
    struct.pack_into("<I", (c.c_char * 4).from_address(im + 80), 0,
                     int(premultiplied))
    struct.pack_into("<3H", (c.c_char * 6).from_address(im + 104), 0, *cicp)
    rgb = c.create_string_buffer(128)              # avifRGBImage
    lib.avifRGBImageSetDefaults(rgb, c.c_void_p(im))
    struct.pack_into("<I", rgb, 12, 0 if ch == 3 else 1)   # RGB / RGBA
    buf = c.create_string_buffer(np.ascontiguousarray(px).tobytes())
    struct.pack_into("<Q", rgb, 48, c.addressof(buf))
    struct.pack_into("<I", rgb, 56, w * ch)
    assert lib.avifImageRGBToYUV(c.c_void_p(im), rgb) == 0
    return im, buf


def libavif_encode(cells, subsampling="4:2:0", full=True, cicp=(1, 13, 6),
                   quality=75, speed=6, premultiplied=False, advanced=None):
    """libavif's encoder through its API (ctypes): `cells`, rows of (h, w,
    3 or 4) uint8 arrays, as one still (avifEncoderAddImage) or a grid
    (avifEncoderAddImageGrid), at the CICP and range given (the matrix
    Pillow's save cannot set), one thread, auto tiling as Pillow sets it
    (avifEncoder offsets: maxThreads 4, speed 8, quality and qualityAlpha
    32, autoTiling 64)."""
    c = ctypes
    lib = libavif_lib()
    enc = lib.avifEncoderCreate()
    struct.pack_into("<ii", (c.c_char * 8).from_address(enc + 4), 0, 1,
                     speed)
    struct.pack_into("<ii", (c.c_char * 8).from_address(enc + 32), 0,
                     quality, quality)
    struct.pack_into("<i", (c.c_char * 4).from_address(enc + 64), 0, 1)
    for k, v in (advanced or {}).items():
        assert lib.avifEncoderSetCodecSpecificOption(
            c.c_void_p(enc), k.encode(), v.encode()) == 0
    keep = [_avif_image(lib, px, subsampling, full, cicp, premultiplied)
            for row in cells for px in row]
    ims = (c.c_void_p * len(keep))(*[k[0] for k in keep])
    try:
        if len(keep) == 1:
            r = lib.avifEncoderAddImage(c.c_void_p(enc), c.c_void_p(ims[0]),
                                        c.c_uint64(1), 2)   # SINGLE
        else:
            r = lib.avifEncoderAddImageGrid(c.c_void_p(enc), len(cells[0]),
                                            len(cells), ims, 2)
        assert r == 0, r
        out = (c.c_uint64 * 2)()                   # avifRWData
        assert lib.avifEncoderFinish(c.c_void_p(enc), out) == 0
        blob = c.string_at(out[0], out[1])
        lib.avifRWDataFree(out)
        return blob
    finally:
        for im, _ in keep:
            lib.avifImageDestroy(c.c_void_p(im))
        lib.avifEncoderDestroy(c.c_void_p(enc))


def items_of(blob):
    """A file's items, references and primary item, as `mux` writes them
    back: each item's type, data, properties [(type, body, essential)]
    and whether its data goes to idat."""
    m = avif.parse(blob, "x")
    items = {k: dict(type=it.type, data=avif._item_bytes(blob, m, k, "x"),
                     props=[(t, b, t == b"av1C") for t, b in it.props],
                     idat=False) for k, it in sorted(m.items.items())}
    return dict(items=items, refs=[list(r) for r in m.refs],
                primary=m.primary)


def mux(f):
    """A test-only writer of `items_of`'s dict: ftyp, meta (hdlr, pitm,
    iloc version 1 with construction methods 0 and 1, iinf, iref, iprp,
    idat) and mdat."""
    ids = sorted(f["items"])
    props, assoc = [], {}
    for k in ids:
        for t, b, ess in f["items"][k]["props"]:
            if (t, b) not in props:
                props.append((t, b))
            assoc.setdefault(k, []).append((props.index((t, b)) + 1, ess))
    ipco = _box(b"ipco", b"".join(_box(t, b) for t, b in props))
    ipma = struct.pack(">I", len(assoc)) + b"".join(
        struct.pack(">HB", k, len(assoc[k])) + bytes(
            i | (0x80 if e else 0) for i, e in assoc[k]) for k in sorted(
                assoc))
    iprp = _box(b"iprp", ipco + _full(b"ipma", 0, 0, ipma))
    hdlr = _full(b"hdlr", 0, 0, bytes(4) + b"pict" + bytes(13))
    pitm = _full(b"pitm", 0, 0, struct.pack(">H", f["primary"]))
    iinf = _full(b"iinf", 0, 0, struct.pack(">H", len(ids)) + b"".join(
        _full(b"infe", 2, 0, struct.pack(">HH", k, 0) +
              f["items"][k]["type"] + b"\0") for k in ids))
    iref = _full(b"iref", 0, 0, b"".join(
        _box(t, struct.pack(">HH", s, len(d)) + b"".join(
            struct.pack(">H", x) for x in d))
        for t, s, d in f["refs"])) if f["refs"] else b""
    idat = b"".join(f["items"][k]["data"] for k in ids
                    if f["items"][k]["idat"])

    def iloc(base):
        body = bytes([0x44, 0]) + struct.pack(">H", len(ids))
        at = {False: base, True: 0}
        for k in ids:
            it = f["items"][k]
            body += struct.pack(">HHHHII", k, int(it["idat"]), 0, 1,
                                at[it["idat"]], len(it["data"]))
            at[it["idat"]] += len(it["data"])
        return _full(b"iloc", 1, 0, body)
    ftyp = _box(b"ftyp", b"avif" + bytes(4) + b"mif1avifmiaf")
    rest = iinf + iref + iprp + (_box(b"idat", idat) if idat else b"")
    size = len(_full(b"meta", 0, 0, hdlr + pitm + iloc(0) + rest))
    meta = _full(b"meta", 0, 0, hdlr + pitm + iloc(len(ftyp) + size + 8) +
                 rest)
    return ftyp + meta + _box(b"mdat", b"".join(
        f["items"][k]["data"] for k in ids if not f["items"][k]["idat"]))


def set_prop(f, item, typ, body):
    f["items"][item]["props"] = [(t, body if t == typ else b, e)
                                 for t, b, e in f["items"][item]["props"]]


def set_ispe(f, item, w, h):
    set_prop(f, item, b"ispe", bytes(4) + struct.pack(">II", w, h))


def quarters(img, rows, cols):
    """img cut into rows x cols cells of equal size."""
    h, w = img.shape[0] // rows, img.shape[1] // cols
    return [[img[r * h:(r + 1) * h, c * w:(c + 1) * w] for c in range(cols)]
            for r in range(rows)]


def with_alpha(img, seed):
    h, w = img.shape[:2]
    y, x = np.mgrid[0:h, 0:w]
    a = 60 + (x * 3 + y * 2) % 190 + np.random.RandomState(seed).randint(
        0, 6, (h, w))
    return np.dstack([img, a.astype(np.uint8)])


def cropped_grid():
    """A 2 x 2 grid of 64 x 64 4:2:0 cells whose ImageGrid output and ispe
    say 120 x 112: libavif crops the assembled frame."""
    f = items_of(libavif_encode(quarters(photo(128, 128, 103), 2, 2),
                                quality=60))
    f["items"][f["primary"]]["data"] = bytes([0, 0, 1, 1]) + struct.pack(
        ">HH", 120, 112)
    f["items"][f["primary"]]["idat"] = True       # construction method 1
    set_ispe(f, f["primary"], 120, 112)
    return mux(f)


def scaled_frame(w, h, alpha_from=None):
    """A 64 x 48 Pillow save with ispe rewritten to w x h (libavif scales
    the frame to it), or an RGBA one whose alpha item's data is that of an
    RGBA save of alpha_from (w, h): its alpha frame is scaled to 64 x
    48."""
    if alpha_from is None:
        f = items_of(save(photo(48, 64, 104), quality=70))
        set_ispe(f, f["primary"], w, h)
        return mux(f)
    f = items_of(save(with_alpha(photo(48, 64, 105), 5), quality=70))
    aw, ah = alpha_from
    g = items_of(save(with_alpha(photo(ah, aw, 106), 6), quality=70))
    alpha = [s for t, s, d in f["refs"] if t == b"auxl"][0]
    f["items"][alpha]["data"] = g["items"][alpha]["data"]
    return mux(f)


# the matrices libavif 1.3.0 converts and Pillow opens that Pillow's save
# cannot write: (colour primaries, matrix), the ranges each opens
MATRICES = {"mc04": ((2, 4), (1, 0)), "mc07": ((2, 7), (1, 0)),
            "mc09": ((9, 9), (1, 0)), "mc12": ((12, 12), (1, 0)),
            "mc15": ((2, 15), (1, 0)), "mc08": ((2, 8), (1,)),
            "mc00": ((2, 0), (0,))}


def libavif_corpus():
    """name -> a function writing the file: libavif's encoder (grids, the
    matrices), and Pillow saves with a rewritten ispe or alpha item."""
    grid = lambda img, r, c, **kw: lambda: libavif_encode(  # noqa: E731
        quarters(img, r, c), **kw)
    out = {
        "grid_2x2_420.avif": grid(photo(128, 128, 100), 2, 2, quality=60,
                                  advanced=OFF),
        "grid_3x1_444.avif": grid(waves(192, 64, 101), 3, 1, quality=70,
                                  subsampling="4:4:4", advanced=OFF),
        "grid_1x2_400.avif": grid(photo(64, 128, 102), 1, 2, quality=60,
                                  subsampling="4:0:0", advanced=OFF),
        "grid_cropped_420.avif": cropped_grid,
        "grid_rgba_420.avif": grid(with_alpha(photo(128, 128, 107), 7), 2, 2,
                                   quality=60, advanced=OFF),
        "grid_premultiplied.avif": grid(with_alpha(textured(128, 128, 108),
                                                   8), 2, 2, quality=60,
                                        premultiplied=True, advanced=OFF),
        # cells that run deblocking, CDEF and loop restoration
        "grid_filters_420.avif": grid(waves(128, 128, 109), 2, 2,
                                      quality=50, speed=2,
                                      advanced={"enable-cdef": "1"}),
        CODED[4]: grid(textured(1024, 1024, 33), 2, 2),
        "ispe_down_420.avif": lambda: scaled_frame(56, 40),
        "ispe_up_420.avif": lambda: scaled_frame(80, 60),
        "ispe_box_420.avif": lambda: scaled_frame(20, 15),
        "ispe_alpha_up.avif": lambda: scaled_frame(64, 48, (56, 40)),
        "ispe_alpha_down.avif": lambda: scaled_frame(64, 48, (128, 96)),
    }
    for name, (cicp, ranges) in MATRICES.items():
        for ss in ("4:2:0", "4:4:4"):
            for full in ranges:
                if cicp[1] == 0 and ss != "4:4:4":
                    continue            # identity: no subsampled chroma
                n = f"{name}_{ss[-1]}{'_full' if full else '_limited'}.avif"
                out[n] = (lambda cicp=cicp, ss=ss, full=full: libavif_encode(
                    [[photo(27, 35, cicp[1] * 2 + full)]], subsampling=ss,
                    full=full, cicp=(cicp[0], 13, cicp[1]), quality=70,
                    advanced=OFF))
    return out


def make_avif_fixtures(d):
    os.makedirs(d, exist_ok=True)
    for name, (img, kw, cicp) in corpus().items():
        blob = save(img, **kw)
        if cicp:
            blob = set_cicp(blob, *cicp)
        with open(os.path.join(d, name), "wb") as f:
            f.write(blob)
    for name, make in libavif_corpus().items():
        with open(os.path.join(d, name), "wb") as f:
            f.write(make())


def _digest(arr):
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _refusal(p):
    try:
        timages.load_image_uint8(p)
    except ValueError as e:
        return str(e).split(": ", 1)[1].split(" is not decoded")[0]
    return None


def avif_expected_now(folder=FIXTURES):
    """expected.json's content as Pillow and the JAX package give it;
    where the port refuses a file Pillow decodes, the port's reason."""
    files = {}
    for n in sorted(os.listdir(folder)):
        if n == "expected.json":
            continue
        p = os.path.join(folder, n)
        with Image.open(p) as im:
            e = {"format": im.format, "mode": im.mode,
                 "size": list(im.size[::-1])}
        reason = _refusal(p) if n[0] in "rt" else None
        if reason:
            e["refused"] = reason
        else:
            e["sha256"] = _digest(jimages.load_image_uint8(p))
        files[n] = e
    listing = jimages.ImagesCached(folder, min_size=LISTING_MIN_SIZE)
    return {"files": files, "listing_min_size": LISTING_MIN_SIZE,
            "listing": [os.path.basename(p) for p in listing.paths()],
            "tested": [os.path.basename(p)
                       for p in jimages.iter_images_in(folder)],
            "coded": list(CODED)}


def libavif():
    libs = glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..",
                                  "pillow.libs", "libavif*"))
    return libs[0] if libs else None


def _versions():
    from PIL import _avif
    codecs = dict(c.split(":", 1) for c in
                  _avif.codec_versions().replace(" [dec]", "").replace(
                      " [enc]", "").split(", "))
    lib = libavif()
    yuv = ctypes.CDLL(lib).avifLibYUVVersion() if lib else None
    return {"pillow": PIL.__version__,
            "libavif": PIL.features.version("avif"),
            "dav1d": codecs.get("dav1d"), "aom": codecs.get("aom"),
            "libyuv": yuv}


def _expected():
    with open(os.path.join(FIXTURES, "expected.json")) as f:
        return json.load(f)


# ------------------------------------------------------------- the tests

def test_avif_expected_json_equals_pillow_and_jax_now():
    want = _expected()
    got = avif_expected_now()
    assert got == {k: want[k] for k in got}
    assert sum(os.path.getsize(os.path.join(FIXTURES, n))
               for n in os.listdir(FIXTURES)) < 500_000
    assert want["tested"] == ["m_q60_420_as.png"]
    assert want["made_by"]["libavif"] == "1.3.0"


def _names():
    if not os.path.exists(os.path.join(FIXTURES, "expected.json")):
        return []                     # before the maker's first run
    return sorted(_expected()["files"])


@pytest.mark.parametrize("name", _names())
def test_port_reads_each_fixture_as_expected(name):
    e = _expected()["files"][name]
    p = os.path.join(FIXTURES, name)
    assert timages.image_format(p) == e["format"] == "AVIF"
    assert timages.image_mode(p) == e["mode"]
    assert list(timages.image_size(p)) == e["size"]
    if "refused" in e:
        with pytest.raises(ValueError) as err:
            timages.load_image_uint8(p)
        assert f"{e['refused']} is not decoded by the port yet" in \
            str(err.value)
    else:
        got = timages.load_image_uint8(p)
        assert _digest(got) == e["sha256"]
        assert np.array_equal(got, jimages.load_image_uint8(p))


def test_listing_keeps_the_avif_named_png():
    got = timages.ImagesCached(FIXTURES, min_size=LISTING_MIN_SIZE).paths()
    assert [os.path.basename(p) for p in got] == _expected()["listing"]


def decode_counting(paths):
    """Decode the files, counting the tools the decoder ran."""
    c = collections.Counter()
    R, B = av1_recon, av1_block
    saved = {}

    def wrap(mod, name, key):
        f = getattr(mod, name)
        saved[(mod, name)] = f

        def g(*a, **k):
            c[key(*a) if callable(key) else key] += 1
            return f(*a, **k)
        setattr(mod, name, g)
    wrap(R, "pred_filter_intra", "filter_intra")
    wrap(R, "cfl", "cfl")
    wrap(R, "upsample", "edge_upsample")
    wrap(R, "edge_filter", lambda e, sz, st: f"edge_filter_{st}")
    wrap(R, "pred_smooth", lambda a, l_, w, h, m: f"smooth_{m}")
    wrap(R, "pred_paeth", "paeth")
    wrap(R, "pred_directional", lambda a, l_, w, h, ang, *r:
         "directional_delta" if ang % 45 and ang not in (113, 157, 203, 67)
         else "directional")
    wrap(R, "inverse_transform", lambda co, t, tx, w, h: f"tx_{w}x{h}")
    wrap(R, "inverse_wht", "wht")
    wrap(B.FrameDecoder, "_palette_colors", lambda self, b, p, n:
         f"palette_{'uv' if p else 'y'}")
    wrap(B.FrameDecoder, "decode_tile", lambda self, *a: "tile")
    wrap(B.FrameDecoder, "_delta_q_lf", lambda self, b: "delta_q" if
         self.read_deltas else "no_delta_q")
    wrap_filters(c, saved)
    wrap_new_tools(c, saved)
    try:
        for p in paths:
            with open(p, "rb") as f:
                blob = f.read()
            m = avif.parse(blob, p)
            grid = m.grids.get(m.primary)
            seq, frame, tiles = av1_obu.parse_av1(avif._item_bytes(
                blob, m, grid.cells[0] if grid else m.primary, p), p)
            q = frame.base_q_idx
            c[f"qctx_{(q > 20) + (q > 60) + (q > 120)}"] += 1
            c[f"ss_{seq.ssx}{seq.ssy}{seq.mono}"] += 1
            c[f"sb128_{seq.sb128}"] += 1
            c[f"lossless_{frame.coded_lossless}"] += 1
            timages.load_image_uint8(p)
    finally:
        for (mod, name), f in saved.items():
            setattr(mod, name, f)
    return c


def wrap_filters(c, saved):
    """Count what the in-loop filters ran: deblocking lengths (y4, y8,
    y14, uv4, uv6), CDEF blocks by strengths, restoration frame types,
    unit sizes, unit types and self-guided set kinds."""
    LF, CD, LR = av1_loopfilter, av1_cdef, av1_restoration

    def deblock(*a, **k):
        ran = saved[(LF, "deblock")](*a, **k)
        c.update({key: 1 for key, v in ran.items() if v})
        return ran

    def cdef(*a, **k):
        out, ran = saved[(CD, "cdef")](*a, **k)
        c.update({key: 1 for key, v in ran.items() if v})
        return out, ran

    def restore(cdef_planes, pre, f, seq, lr):
        for p, u in enumerate(lr):
            if u is None:
                continue
            c[f"lr_size_{f.lr_unit_size[p]}"] += 1
            for t, st in zip(u.type.ravel(), u.sgr[..., 0].ravel()):
                if t == av1_obu.RESTORE_WIENER:
                    c["lr_wiener"] += 1
                elif t == av1_obu.RESTORE_SGRPROJ:
                    r0, r1 = LR.SGR[st, 0], LR.SGR[st, 1]
                    c["sgr_both" if r0 and r1 else "sgr_r1_0" if r0
                      else "sgr_r0_0"] += 1
                elif f.lr_type[p] == av1_obu.RESTORE_SWITCHABLE:
                    c["lr_none_in_switchable"] += 1
        return saved[(LR, "restore")](cdef_planes, pre, f, seq, lr)
    for mod, name, fn in ((LF, "deblock", deblock), (CD, "cdef", cdef),
                          (LR, "restore", restore)):
        saved[(mod, name)] = getattr(mod, name)
        setattr(mod, name, fn)


def wrap_new_tools(c, saved):
    """Count film grain (its kinds), quantizer matrices, premultiplied
    alpha and intra block copy: blocks, DVs half a chroma sample off,
    sub-8 x 8 chroma whose neighbour copies too, split transforms, each
    inter transform set."""
    B, FG = av1_block, av1_filmgrain

    def keep(mod, name, fn):
        saved[(mod, name)] = getattr(mod, name)
        setattr(mod, name, fn)

    def grain(planes, g, seq):
        c["grain"] += 1
        c["grain_lag3"] += g.ar_lag == 3
        c["grain_from_luma"] += g.chroma_from_luma
        c["grain_overlap"] += g.overlap
        c["grain_no_overlap"] += not g.overlap
        c[f"grain_ss_{seq.ssx}{seq.ssy}{seq.mono}"] += 1
        return saved[(FG, "apply_grain")](planes, g, seq)

    def qm(level, chroma, tx):
        c["qm"] += 1
        return saved[(B, "qmatrix")](level, chroma, tx)

    def unpremultiply(rgb, alpha):
        c["premultiplied"] += 1
        return saved[(avif, "unpremultiply")](rgb, alpha)

    def predict(self, b):
        for p in range(1 + 2 * b.has_chroma):
            ssx, ssy = (self.ssx, self.ssy) if p else (0, 0)
            x, y, dv = (b.c >> ssx) * 4, (b.r >> ssy) * 4, b.dv
            px, py = (x << 4) + ((2 * dv[1]) >> ssx), (y << 4) + (
                (2 * dv[0]) >> ssy)
            c["intrabc_bilinear"] += bool((px | py) & 15)
        return saved[(B.FrameDecoder, "_intrabc_predict")](self, b)

    def info(self, b):
        saved[(B.FrameDecoder, "_intrabc_info")](self, b)
        c["intrabc"] += 1
        bw4, bh4 = B.BLOCK_WH[b.size]
        if b.has_chroma and self.ssx and (
                bw4 == 1 and self.is_inter[b.r][b.c - 1] or
                bh4 == 1 and self.ssy and self.is_inter[b.r - 1][b.c]):
            c["intrabc_sub8x8_chroma"] += 1

    def var_tx(self, b, row, col, tx, depth):
        c[f"var_tx_depth_{depth}"] += 1
        return saved[(B.FrameDecoder, "_read_var_tx")](self, b, row, col, tx,
                                                      depth)

    def tx_type(self, b, tx, x4, y4):
        if b.is_inter:
            c[f"inter_tx_set_{self._tx_set(tx, 1)}"] += 1
        return saved[(B.FrameDecoder, "_read_tx_type")](self, b, tx, x4, y4)
    keep(FG, "apply_grain", grain)
    keep(B, "qmatrix", qm)
    keep(avif, "unpremultiply", unpremultiply)
    keep(B.FrameDecoder, "_intrabc_predict", predict)
    keep(B.FrameDecoder, "_intrabc_info", info)
    keep(B.FrameDecoder, "_read_var_tx", var_tx)
    keep(B.FrameDecoder, "_read_tx_type", tx_type)


def test_fixtures_cover_the_decoder():
    """The decoded fixtures (the coded files aside) run every coding
    tool and transform size the decoder has, and every path of the
    in-loop filters aom writes: each deblocking length, CDEF primary-only,
    secondary-only and both, Wiener, each self-guided set kind,
    RESTORE_NONE inside a switchable frame, two unit sizes. (A 64 x 64
    whose blocks all skip, CDEF's cdef_idx -1, comes from no writer here:
    aom marks no intra block skipped; `test_cdef_leaves_unsignalled_and_
    skipped_blocks` holds that path.)"""
    e = _expected()["files"]
    paths = [os.path.join(FIXTURES, n) for n in sorted(e)
             if "sha256" in e[n] and n not in CODED]
    c = decode_counting(paths)
    need = ["filter_intra", "cfl", "edge_upsample", "edge_filter_1",
            "edge_filter_2", "edge_filter_3", "smooth_9", "smooth_10",
            "smooth_11", "paeth", "directional", "directional_delta", "wht",
            "palette_y", "palette_uv", "delta_q", "qctx_0", "qctx_1",
            "qctx_2", "qctx_3", "ss_000", "ss_100", "ss_110", "ss_111",
            "sb128_1", "lossless_True"]
    need += [f"tx_{w}x{h}" for w, h in av1_block.TX_WH]
    need += ["y4", "y8", "y14", "uv4", "uv6", "cdef_pri", "cdef_sec",
             "cdef_both", "lr_wiener", "sgr_both", "sgr_r0_0", "sgr_r1_0",
             "lr_none_in_switchable"]
    need += ["grain", "grain_lag3", "grain_from_luma", "grain_overlap",
             "grain_no_overlap", "grain_ss_110", "grain_ss_100",
             "grain_ss_000", "grain_ss_111", "qm", "premultiplied",
             "intrabc", "intrabc_bilinear", "intrabc_sub8x8_chroma",
             "var_tx_depth_0", "var_tx_depth_1", "inter_tx_set_1",
             "inter_tx_set_2", "inter_tx_set_3"]
    assert [k for k in need if not c[k]] == []
    assert c["tile"] > len(paths)            # a file with several tiles
    assert len([k for k in c if k.startswith("lr_size_")]) >= 2


# ------------------------------------------------------ the in-loop filters

def _dav1d_planes(lib, obus, filters, grain=1):
    """dav1d's decoded planes of raw OBUs through the API libavif exports
    (dav1d 1.5: Dav1dSettings.apply_grain at byte 8, default 1;
    Dav1dSettings.inloop_filters at byte 72, a mask of deblocking 1, CDEF
    2, restoration 4; Dav1dPicture's data at 16, strides (in bytes) at
    40, width, height, layout and bits per component at 56): uint8, or
    uint16 above 8 bits."""
    return _dav1d_pictures(lib, [obus], filters, grain)[0]


def _dav1d_pictures(lib, samples, filters, grain=1):
    """_dav1d_planes of each of `samples` (raw OBUs) sent in turn to one
    dav1d context: a sequence's pictures."""
    c = ctypes
    lib.dav1d_data_create.restype = c.c_void_p
    settings = c.create_string_buffer(1024)
    lib.dav1d_default_settings(settings)
    struct.pack_into("<ii", settings, 0, 1, 1)      # one thread, no delay
    assert struct.unpack_from("<i", settings, 72)[0] == 7
    assert struct.unpack_from("<i", settings, 8)[0] == 1
    struct.pack_into("<i", settings, 72, filters)
    struct.pack_into("<i", settings, 8, grain)
    ctx = c.c_void_p()
    assert lib.dav1d_open(c.byref(ctx), settings) == 0
    pictures = []
    try:
        for obus in samples:
            data = c.create_string_buffer(256)
            buf = lib.dav1d_data_create(data, c.c_size_t(len(obus)))
            c.memmove(buf, obus, len(obus))
            assert lib.dav1d_send_data(ctx, data) == 0
            pic = c.create_string_buffer(1024)
            assert lib.dav1d_get_picture(ctx, pic) == 0
            ptrs = struct.unpack_from("<3Q", pic, 16)
            strides = struct.unpack_from("<2q", pic, 40)
            w, h, layout, bpc = struct.unpack_from("<4i", pic, 56)
            sx, sy = int(layout in (1, 2)), int(layout == 1)
            t = c.c_uint8 if bpc == 8 else c.c_uint16
            out = []
            for k in range(1 if layout == 0 else 3):
                pw, ph = (w, h) if k == 0 else ((w + sx) >> sx,
                                                (h + sy) >> sy)
                st = strides[min(k, 1)] // c.sizeof(t)
                a = np.ctypeslib.as_array((t * (st * ph)).from_address(
                    ptrs[k]))
                out.append(a.reshape(ph, st)[:, :pw].copy())
            lib.dav1d_picture_unref(pic)
            pictures.append(out)
        return pictures
    finally:
        lib.dav1d_close(c.byref(ctx))


def _libavif_planes(lib, blob):
    """The YUV planes libavif's avifDecoderReadMemory decodes (Pillow's
    decoder): the avifImage's planes at 24, their row bytes at 48; uint8,
    or uint16 above 8 bits."""
    c = ctypes
    lib.avifDecoderCreate.restype = c.c_void_p
    lib.avifImageCreateEmpty.restype = c.c_void_p
    dec, img = lib.avifDecoderCreate(), lib.avifImageCreateEmpty()
    try:
        assert lib.avifDecoderReadMemory(c.c_void_p(dec), c.c_void_p(img),
                                         blob, c.c_size_t(len(blob))) == 0
        w, h, depth, fmt = (c.c_uint32 * 4).from_address(img)
        ptrs = (c.c_void_p * 3).from_address(img + 24)
        rows = (c.c_uint32 * 3).from_address(img + 48)
        sx, sy = int(fmt in (2, 3)), int(fmt == 3)   # 444 1, 422 2, 420 3
        t = c.c_uint8 if depth == 8 else c.c_uint16
        out = []
        for k in range(1 if fmt == 4 else 3):        # 400 4
            pw, ph = (w, h) if k == 0 else ((w + sx) >> sx, (h + sy) >> sy)
            st = rows[k] // c.sizeof(t)
            a = np.ctypeslib.as_array((t * (st * ph)).from_address(ptrs[k]))
            out.append(a.reshape(ph, st)[:, :pw].copy())
        return out
    finally:
        lib.avifImageDestroy(c.c_void_p(img))
        lib.avifDecoderDestroy(c.c_void_p(dec))


def port_stages(data):
    """The port's cropped planes after each in-loop filter: deblocking,
    CDEF, loop restoration (the decoded planes)."""
    seq, f, tiles = av1_obu.parse_av1(data, "x")
    d = av1_block.FrameDecoder(seq, f, "x")
    for tr, tc, start, end in tiles:
        d.decode_tile(data, start, end, tr, tc)
    stages = []
    final = av1_block.filter_frame(d, seq, f, stages=stages)
    h, w = f.height, f.width
    ch, cw = (h + seq.ssy) >> seq.ssy, (w + seq.ssx) >> seq.ssx
    t = final[0].dtype
    crop = lambda pl: [pl[0][:h, :w].astype(t)] + [  # noqa: E731
        q[:ch, :cw].astype(t) for q in pl[1:seq.num_planes]]
    return [crop(st) for st in stages] + [final]


def _first_difference(got, want):
    for p, (a, b) in enumerate(zip(got, want)):
        if not np.array_equal(a, b):
            y, x = np.argwhere(a != b)[0]
            return (f"plane {p}, 4x4 block ({y // 4}, {x // 4}): "
                    f"{int(a[y, x])} against {int(b[y, x])}")
    return None


FILTERED = sorted(n for n in _names() if n[0] in "noprx")


@pytest.mark.parametrize("name", FILTERED)
def test_each_filter_stage_equals_dav1ds(name):
    """Deblocking, CDEF and restoration in turn against dav1d's planes
    with the later filters switched off, and the planes against
    libavif's: a fault shows as the first plane and 4 x 4 block of the
    first stage that differs."""
    path = libavif()
    if path is None:
        pytest.skip("this Pillow bundles no libavif")
    lib = ctypes.CDLL(path)
    with open(os.path.join(FIXTURES, name), "rb") as f:
        blob = f.read()
    m = avif.parse(blob, name)
    data = avif._item_bytes(blob, m, m.primary, name)
    got = port_stages(data)
    for k, (stage, mask) in enumerate((("deblocking", 1), ("CDEF", 3),
                                       ("restoration", 7))):
        want = _dav1d_planes(lib, data, mask)
        assert _first_difference(got[k], want) is None, \
            (stage, _first_difference(got[k], want))
    assert _first_difference(got[2], _libavif_planes(lib, blob)) is None


GRAIN = sorted(n for n in _names() if n[0] == "v")
UNFILTERED = sorted(n for n in _names() if n[0] in "qs")


def _item_data(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        blob = f.read()
    m = avif.parse(blob, name)
    return blob, avif._item_bytes(blob, m, m.primary, name)


@pytest.mark.parametrize("name", GRAIN)
def test_grain_stage_equals_dav1ds(name):
    """Film grain against dav1d: the filtered planes equal dav1d's with
    `apply_grain` at 0, the planes with grain dav1d's with it at 1; and
    libavif's planes (Pillow's decoder) are the latter, not the former:
    Pillow's pixels carry the grain."""
    path = libavif()
    if path is None:
        pytest.skip("this Pillow bundles no libavif")
    lib = ctypes.CDLL(path)
    blob, data = _item_data(name)
    seq, f, _ = av1_obu.parse_av1(data, name)
    pre = port_stages(data)[-1]
    off, on = (_dav1d_planes(lib, data, 7, grain=g) for g in (0, 1))
    assert _first_difference(pre, off) is None
    assert _first_difference(av1_block.add_grain(pre, seq, f), on) is None
    pillow = _libavif_planes(lib, blob)
    assert _first_difference(pillow, on) is None
    assert _first_difference(pillow, off) is not None


def _header_bits(data):
    """(OBU start, [(bit, n)] of each read) of the frame header."""
    reads = []

    class Log(av1_obu.Bits):
        def f(self, n):
            reads.append((self.bit, n))
            return super().f(n)
    obus = list(av1_obu.obus(data, "x"))
    seq_obu = [o for o in obus if o[0] == av1_obu.OBU_SEQUENCE_HEADER][0]
    seq = av1_obu.sequence_header(av1_obu.Bits(data, seq_obu[3],
                                               seq_obu[4], "x"))
    at, end = obus[-1][3], obus[-1][4]
    av1_obu.frame_header(Log(data, at, end, "x"), seq)
    return reads


@pytest.mark.parametrize("clip, overlap", [(1, 1), (1, 0), (0, 0)])
def test_grain_clip_and_overlap_flags_as_dav1d(clip, overlap):
    """clip_to_restricted_range (no aom vector sets it) and overlap_flag,
    the grain parameters' last two bits, rewritten in a file with grain:
    the port's planes equal dav1d's."""
    path = libavif()
    if path is None:
        pytest.skip("this Pillow bundles no libavif")
    _, data = _item_data("v_grain05_420.avif")
    reads = _header_bits(data)
    b = bytearray(data)
    _put(b, reads[-2][0], 1, overlap)
    _put(b, reads[-1][0], 1, clip)
    data = bytes(b)
    seq, f, tiles = av1_obu.parse_av1(data, "x")
    assert (f.grain.clip_restricted, f.grain.overlap) == (clip, overlap)
    got = av1_block.decode_frame(seq, f, tiles, data, "x")
    want = _dav1d_planes(ctypes.CDLL(path), data, 7)
    assert _first_difference(got, want) is None


def port_unfiltered(data):
    """The port's reconstruction before any in-loop filter, cropped."""
    seq, f, tiles = av1_obu.parse_av1(data, "x")
    d = av1_block.FrameDecoder(seq, f, "x")
    for tr, tc, start, end in tiles:
        d.decode_tile(data, start, end, tr, tc)
    h, w = f.height, f.width
    ch, cw = (h + seq.ssy) >> seq.ssy, (w + seq.ssx) >> seq.ssx
    return [d.frame[0][:h, :w].astype(np.uint8)] + [
        q[:ch, :cw].astype(np.uint8) for q in d.frame[1:seq.num_planes]], d


@pytest.mark.parametrize("name", UNFILTERED)
def test_qm_and_intrabc_frames_equal_dav1ds_unfiltered(name):
    """Dequantization with quantizer matrices and intra block copy against
    dav1d's planes with every in-loop filter off (a fault shows as the
    first plane and 4 x 4 block that differ), then the decoded planes
    against libavif's."""
    path = libavif()
    if path is None:
        pytest.skip("this Pillow bundles no libavif")
    lib = ctypes.CDLL(path)
    blob, data = _item_data(name)
    got, d = port_unfiltered(data)
    assert _first_difference(got, _dav1d_planes(lib, data, 0)) is None
    if name[0] == "s":
        assert d.f.allow_intrabc and sum(map(sum, d.is_inter)) > 0
    else:
        assert d.f.using_qmatrix and min(d.f.qm_y, d.f.qm_u) < 15
    final = av1_block.add_grain(av1_block.filter_frame(d, d.s, d.f), d.s,
                                d.f)
    assert _first_difference(final, _libavif_planes(lib, blob)) is None


def test_intrabc_sub8x8_chroma_at_420():
    """4:2:0 chroma of a sub-8 x 8 intrabc block whose left or upper
    neighbour copies too: in an intra frame every block's RefFrame[0] is
    INTRA_FRAME, so the specification (someUseIntra) and dav1d
    (ref[0] > 0) both predict the whole chroma block with the block's own
    DV, not the neighbours'. The file has such blocks, DVs half a chroma
    sample off among them, and its chroma equals dav1d's."""
    path = libavif()
    if path is None:
        pytest.skip("this Pillow bundles no libavif")
    _, data = _item_data("s_intrabc_420_sub8x8.avif")
    c = collections.Counter()
    saved = {}
    wrap_new_tools(c, saved)
    try:
        got, _ = port_unfiltered(data)
    finally:
        for (mod, name), f in saved.items():
            setattr(mod, name, f)
    assert c["intrabc_sub8x8_chroma"] > 0 and c["intrabc_bilinear"] > 0
    want = _dav1d_planes(ctypes.CDLL(path), data, 0)
    assert _first_difference(got[1:], want[1:]) is None


def test_premultiplied_alpha_unattenuates_as_libavif():
    """Every (colour, alpha) pair through libavif's
    avifRGBImageUnpremultiplyAlpha on an 8-bit RGBA image (libyuv's
    ARGBUnattenuate, which Pillow's RGBA decode of a `prem` file runs)
    equals `avif.unpremultiply`."""
    path = libavif()
    if path is None:
        pytest.skip("this Pillow bundles no libavif")
    lib = ctypes.CDLL(path)
    c, a = np.mgrid[0:256, 0:256]
    px = np.stack([c, 255 - c, c // 2, a], -1).astype(np.uint8)
    buf = ctypes.create_string_buffer(px.tobytes(), px.nbytes)
    rgb = ctypes.create_string_buffer(64)
    struct.pack_into("<IIII", rgb, 0, 256, 256, 8, 1)   # RGBA
    struct.pack_into("<I", rgb, 32, 1)                  # alphaPremultiplied
    struct.pack_into("<Q", rgb, 48, ctypes.addressof(buf))
    struct.pack_into("<I", rgb, 56, 256 * 4)
    assert lib.avifRGBImageUnpremultiplyAlpha(rgb) == 0
    want = np.frombuffer(buf.raw, np.uint8).reshape(256, 256, 4)
    assert np.array_equal(want[..., 3], px[..., 3])
    assert np.array_equal(avif.unpremultiply(px[..., :3], px[..., 3]),
                          want[..., :3])


def _cdef_reference(planes, f, seq, skips, cdef_idx):
    """The specification's CDEF process (7.15), a sample at a time."""
    def constrain(diff, t, damping):
        if not t:
            return 0
        adj = max(0, damping - (t.bit_length() - 1))
        v = min(abs(diff), max(0, t - (abs(diff) >> adj)))
        return v if diff > 0 else -v
    out = [p.copy() for p in planes]
    for r in range(0, f.mi_rows, 2):
        for c in range(0, f.mi_cols, 2):
            idx = cdef_idx[r >> 4, c >> 4]
            if idx == -1 or skips[r:r + 2, c:c + 2].all():
                continue
            y_dir, var = av1_cdef.direction(
                planes[0][4 * r:4 * r + 8, 4 * c:4 * c + 8][None])
            y_dir, var = int(y_dir[0]), int(var[0])
            for p in range(seq.num_planes):
                sx = seq.ssx if p else 0
                sy = seq.ssy if p else 0
                pri, sec = (f.cdef_uv if p else f.cdef_y)[idx]
                damping = f.cdef_damping - (p > 0)
                if p == 0:
                    dr = y_dir if pri else 0
                    vs = min((var >> 6).bit_length() - 1, 12) \
                        if var >> 6 else 0
                    pri = (pri * (4 + vs) + 8) >> 4 if var else 0
                else:
                    dr = int(av1_cdef.UV_DIR[int(sx and not sy)][y_dir]) \
                        if pri else 0
                x0, y0 = (4 * c) >> sx, (4 * r) >> sy
                ah, aw = (4 * f.mi_rows) >> sy, (4 * f.mi_cols) >> sx
                src = planes[p]
                for i in range(8 >> sy):
                    for j in range(8 >> sx):
                        x = int(src[y0 + i, x0 + j])
                        total, lo, hi = 0, x, x
                        for k in (0, 1):
                            for sign in (1, -1):
                                for d, taps, st in (
                                        (dr, av1_cdef.PRI_TAPS, pri),
                                        ((dr + 2) & 7, av1_cdef.SEC_TAPS,
                                         sec),
                                        ((dr - 2) & 7, av1_cdef.SEC_TAPS,
                                         sec)):
                                    dy, dx = av1_cdef.DIRS[d][k]
                                    yy = y0 + i + sign * dy
                                    xx = x0 + j + sign * dx
                                    if not (0 <= yy < ah and 0 <= xx < aw):
                                        continue
                                    v = int(src[yy, xx])
                                    total += int(taps[pri & 1][k]) * \
                                        constrain(v - x, st, damping)
                                    lo, hi = min(lo, v), max(hi, v)
                        out[p][y0 + i, x0 + j] = min(hi, max(
                            lo, x + ((8 + total - (total < 0)) >> 4)))
    return out


@pytest.mark.parametrize("ssx, ssy", [(1, 1), (1, 0), (0, 0)])
def test_cdef_leaves_unsignalled_and_skipped_blocks(ssx, ssy):
    """CDEF on seeded planes against the specification's process a
    sample at a time: a 64 x 64 whose cdef_idx is -1 (all its blocks
    skipped, so no index was read) and 8 x 8s whose four mi skip are
    left as they are, every other block filtered with its index's
    strengths (primary only, secondary only, both), taps outside the mi
    area left out."""
    from types import SimpleNamespace
    r = np.random.RandomState(80 + 2 * ssx + ssy)
    f = SimpleNamespace(mi_rows=30, mi_cols=34, cdef_damping=4, cdef_bits=2,
                        cdef_y=[(0, 2), (9, 0), (6, 4), (15, 1)],
                        cdef_uv=[(3, 1), (0, 2), (7, 0), (12, 4)])
    seq = SimpleNamespace(num_planes=3, ssx=ssx, ssy=ssy)
    smooth = np.cumsum(r.randint(-3, 4, (192, 192)), 1) + 128
    planes = [np.clip(smooth + r.randint(-12, 13, (192, 192)), 0, 255)]
    planes += [np.clip(smooth[::1 + ssy, ::1 + ssx] +
                       r.randint(-9, 10, (192 >> ssy, 192 >> ssx)), 0, 255)
               for _ in (1, 2)]
    skips = r.rand(64, 64) < 0.3
    skips[16:32, :16] = True                 # a 64 x 64 with no index
    cdef_idx = np.zeros((6, 6), np.int64)
    cdef_idx[:2, :3] = [[0, 1, 2], [-1, 3, 1]]   # the frame's 64 x 64s
    got, ran = av1_cdef.cdef(planes, f, seq, skips, cdef_idx)
    want = _cdef_reference(planes, f, seq, skips, cdef_idx)
    for p in range(3):
        assert np.array_equal(got[p], want[p]), p
    assert ran["cdef_idx_-1"] > 0 and ran["cdef_pri"] and ran["cdef_sec"] \
        and ran["cdef_both"]
    assert np.array_equal(got[0][64:128, :64], planes[0][64:128, :64])


# ------------------------------------------------- the colour conversion

def _libavif_rgb(lib, blob, planes):
    """libavif's avifImageYUVToRGB (Pillow's call) of `planes` written into
    the image it decodes from `blob`: the file gives the matrix, range and
    layout."""
    c = ctypes
    lib.avifDecoderCreate.restype = c.c_void_p
    lib.avifImageCreateEmpty.restype = c.c_void_p
    dec, img = lib.avifDecoderCreate(), lib.avifImageCreateEmpty()
    try:
        assert lib.avifDecoderReadMemory(c.c_void_p(dec), c.c_void_p(img),
                                         blob, c.c_size_t(len(blob))) == 0
        w, h = (c.c_uint32 * 2).from_address(img)
        ptrs = (c.c_void_p * 3).from_address(img + 24)
        rows = (c.c_uint32 * 3).from_address(img + 48)
        for k, p in enumerate(planes):
            ph, pw = p.shape
            dst = np.ctypeslib.as_array((c.c_uint8 * (rows[k] * ph))
                                        .from_address(ptrs[k]))
            dst.reshape(ph, rows[k])[:, :pw] = p
        rgb = c.create_string_buffer(256)    # avifRGBImage, 64 bytes
        lib.avifRGBImageSetDefaults(rgb, c.c_void_p(img))
        assert struct.unpack_from("<III", rgb, 0) == (w, h, 8)
        struct.pack_into("<I", rgb, 12, 0)    # AVIF_RGB_FORMAT_RGB
        lib.avifRGBImageAllocatePixels(rgb)
        try:
            assert lib.avifImageYUVToRGB(c.c_void_p(img), rgb) == 0
            ptr, = struct.unpack_from("<Q", rgb, 48)
            stride, = struct.unpack_from("<I", rgb, 56)
            out = np.ctypeslib.as_array((c.c_uint8 * (stride * h))
                                        .from_address(ptr))
            return out.reshape(h, stride)[:, :3 * w].reshape(h, w, 3).copy()
        finally:
            lib.avifRGBImageFreePixels(rgb)
    finally:
        lib.avifImageDestroy(c.c_void_p(img))
        lib.avifDecoderDestroy(c.c_void_p(dec))


@pytest.mark.parametrize("rng, cicp", [("full", None), ("limited", None),
                                       ("full", (1, 1)),
                                       ("limited", (1, 1)),
                                       ("full", (12, 12)),
                                       ("limited", (2, 0)),
                                       ("limited", (2, 9))])
def test_every_yuv_triple_converts_as_libavif(rng, cicp):
    """All 2^24 (y, u, v) at 4:4:4 through libavif's own conversion (the
    library Pillow bundles, ctypes): BT.601 and BT.709, full and limited,
    equal to `avif_yuv.to_rgb`; so are the chroma-derived matrix over P3
    primaries (kr and kb derived in float32) and identity in limited
    range, both libavif's float path, and BT.2020 in limited range. libyuv picks its row functions at run
    time (AVX2 here and on the card host, whose CPUs both have it; this
    build has no switch to force its C rows); the port's formula is the
    C rows', and the equality here shows the rows libyuv runs agree."""
    from l3c_torch.data import avif_yuv
    path = libavif()
    if path is None:
        pytest.skip("this Pillow bundles no libavif")
    lib = ctypes.CDLL(path)
    blob = save(photo(512, 512, 44), quality=50, subsampling="4:4:4",
                speed=9, range=rng, advanced=OFF)
    if cicp:
        blob = set_cicp(blob, *cicp)
    cp, mc = cicp if cicp else (2, 6)
    every = np.arange(1 << 24, dtype=np.uint32)
    for k in range(64):
        part = every[k << 18:(k + 1) << 18].reshape(512, 512)
        planes = [((part >> s) & 255).astype(np.uint8) for s in (16, 8, 0)]
        want = _libavif_rgb(lib, blob, planes)
        got = avif_yuv.to_rgb(planes, 0, 0, 0, mc, rng == "full", "x", cp)
        assert np.array_equal(got, want), k


@pytest.mark.parametrize("ss, shape", [("4:2:0", (37, 29)),
                                       ("4:2:0", (36, 48)),
                                       ("4:2:2", (21, 35)),
                                       ("4:0:0", (19, 23))])
def test_subsampled_chroma_converts_as_libavif(ss, shape):
    """Random planes through libavif's conversion at 4:2:0 / 4:2:2
    (libyuv's bilinear upsampling, edges included) and 4:0:0 (its own
    grey path), full and limited range."""
    from l3c_torch.data import avif_yuv
    path = libavif()
    if path is None:
        pytest.skip("this Pillow bundles no libavif")
    lib = ctypes.CDLL(path)
    h, w = shape
    sx, sy = (1, 1) if ss == "4:2:0" else (1, 0) if ss == "4:2:2" else (0, 0)
    r = np.random.RandomState(h * w)
    for rng in ("full", "limited"):
        blob = save(photo(h, w, 45), quality=50, subsampling=ss, speed=9,
                    range=rng, advanced=OFF)
        planes = [r.randint(0, 256, (h, w)).astype(np.uint8)]
        if ss != "4:0:0":
            ch, cw = (h + sy) >> sy, (w + sx) >> sx
            planes += [r.randint(0, 256, (ch, cw)).astype(np.uint8)
                       for _ in (1, 2)]
        want = _libavif_rgb(lib, blob, planes)
        got = avif_yuv.to_rgb(planes, sx, sy, int(ss == "4:0:0"), 6,
                              rng == "full", "x")
        assert np.array_equal(got, want), rng


# each matrix libavif converts in float32 (and BT.2020 through libyuv), as
# (colour primaries, matrix coefficients, range)
NEW_MATRICES = [(2, 4, "full"), (2, 4, "limited"), (2, 7, "limited"),
                (9, 9, "full"), (2, 9, "limited"), (12, 12, "full"),
                (22, 12, "limited"), (2, 12, "full"), (4, 12, "limited"),
                (2, 15, "full"), (2, 8, "full"), (2, 0, "limited")]


@pytest.mark.parametrize("cp, mc, rng", NEW_MATRICES)
def test_new_matrices_convert_as_libavif(cp, mc, rng):
    """Random planes at 4:4:4, 4:2:0 and 4:2:2, odd sizes included,
    through libavif's avifImageYUVToRGB with the file's primaries, matrix
    and range: FCC, SMPTE 240, YCgCo, identity in limited range, the
    chroma-derived matrix over several primaries and an unlisted matrix
    go through libavif's float conversion and its bilinear chroma, BT.2020
    through libyuv's constants; `avif_yuv.to_rgb` gives the same bytes
    (identity has no subsampled layout)."""
    from l3c_torch.data import avif_yuv
    path = libavif()
    if path is None:
        pytest.skip("this Pillow bundles no libavif")
    lib = ctypes.CDLL(path)
    r = np.random.RandomState(cp * 32 + mc)
    for ss, (h, w) in (("4:4:4", (37, 29)), ("4:2:0", (37, 29)),
                       ("4:2:0", (36, 48)), ("4:2:2", (21, 35))):
        if mc == 0 and ss != "4:4:4":
            continue
        sx, sy = (ss != "4:4:4") * 1, (ss == "4:2:0") * 1
        blob = set_cicp(save(photo(h, w, 45), quality=50, subsampling=ss,
                             speed=9, range=rng, advanced=OFF), cp, mc)
        ch, cw = (h + sy) >> sy, (w + sx) >> sx
        planes = [r.randint(0, 256, (h, w)).astype(np.uint8)] + [
            r.randint(0, 256, (ch, cw)).astype(np.uint8) for _ in (1, 2)]
        want = _libavif_rgb(lib, blob, planes)
        got = avif_yuv.to_rgb(planes, sx, sy, 0, mc, rng == "full", "x", cp)
        assert np.array_equal(got, want), (ss, h, w)


@pytest.mark.parametrize("ss", ["4:2:0", "4:2:2", "4:4:4", "4:0:0"])
def test_alpha_and_premultiplied_alpha_convert_as_pillow(tmp_path, ss):
    """RGBA stills of libavif's encoder over the matrices and ranges, plain
    and premultiplied, with alpha 0, 1, 254 and 255 among the rest:
    Pillow asks libavif for RGBA, so grey goes through libyuv's
    I400ToARGBMatrix where libavif has its constants (identity as
    BT.601), and a premultiplied colour is divided by its alpha in
    libavif's float path where that path converts it (subsampled chroma,
    YCgCo, identity in limited range), elsewhere by libyuv's
    ARGBUnattenuate after the conversion."""
    img = with_alpha(photo(24, 32, 112), 10)
    img[:4, :, 3], img[4:6, :, 3] = 0, 1
    img[6:8, :, 3], img[8:10, :, 3] = 255, 254
    cases = [(1, 1), (2, 6), (9, 9), (2, 4), (2, 7), (12, 12), (2, 12),
             (2, 15), (2, 8), (2, 0)]
    for prem in (False, True):
        for full in (1, 0):
            for cp, mc in cases:
                if mc == 8 and not full or mc == 0 and ss not in (
                        "4:4:4", "4:0:0"):
                    continue        # refused, or not written
                blob = libavif_encode([[img]], subsampling=ss, full=full,
                                      premultiplied=prem, quality=80,
                                      advanced=OFF)
                p = str(tmp_path / "a.avif")
                with open(p, "wb") as f:
                    f.write(set_cicp(blob, cp, mc))
                pil, port = _outcome(p)
                assert pil is not None and np.array_equal(port, pil), (
                    prem, full, cp, mc)


# ------------------------------------------------- grids and scaling to ispe

GRIDS_AND_SCALED = sorted(n for n in _names()
                          if n.startswith(("grid_", "ispe_")) and
                          n not in CODED)


@pytest.mark.parametrize("name", GRIDS_AND_SCALED)
def test_grid_and_scaled_planes_equal_libavifs(name):
    """The YUV planes the port hands to the conversion, a grid's cells
    assembled and cropped, a frame scaled to its ispe, against the planes
    libavif's decoder gives (a fault shows as the first plane and 4 x 4
    block that differ); and the alpha plane's size, which libavif checks
    against the colour planes after scaling."""
    path = libavif()
    if path is None:
        pytest.skip("this Pillow bundles no libavif")
    with open(os.path.join(FIXTURES, name), "rb") as f:
        blob = f.read()
    m = avif.parse(blob, name)
    planes, _ = avif._planes(blob, m, m.primary, name)
    want = _libavif_planes(ctypes.CDLL(path), blob)
    assert _first_difference(planes, want) is None
    alpha = avif._alpha_of(m, m.primary)
    if alpha is not None:
        a = avif._planes(blob, m, alpha, name, alpha=True)[0][0]
        assert a.shape == planes[0].shape


def _scale_by_libavif(plane, w, h, depth=8):
    """libavif's avifImageScale of a grey avifImage of `depth` bits
    (libyuv's ScalePlane, or ScalePlane_16, under libavif's filter)."""
    c = ctypes
    lib = libavif_lib()
    t = c.c_uint8 if depth == 8 else c.c_uint16
    ph, pw = plane.shape
    im = lib.avifImageCreate(pw, ph, depth, _LAYOUTS["4:0:0"])
    try:
        assert lib.avifImageAllocatePlanes(c.c_void_p(im), 1) == 0
        row = (c.c_uint32 * 1).from_address(im + 48)[0] // c.sizeof(t)
        ptr = (c.c_void_p * 1).from_address(im + 24)[0]
        np.ctypeslib.as_array((t * (row * ph)).from_address(
            ptr)).reshape(ph, row)[:, :pw] = plane
        assert lib.avifImageScale(c.c_void_p(im), w, h,
                                  c.create_string_buffer(512)) == 0
        row = (c.c_uint32 * 1).from_address(im + 48)[0] // c.sizeof(t)
        ptr = (c.c_void_p * 1).from_address(im + 24)[0]
        return np.ctypeslib.as_array((t * (row * h)).from_address(
            ptr)).reshape(h, row)[:, :w].copy()
    finally:
        lib.avifImageDestroy(c.c_void_p(im))


# ScalePlane's paths under kFilterBox: (source w, h) -> [(target w, h)]
SCALE_PATHS = {
    "bilinear_down": [(64, 48, 56, 40), (63, 47, 40, 30), (100, 30, 70, 17)],
    "bilinear_up": [(64, 48, 80, 60), (63, 47, 200, 150), (33, 17, 100, 30)],
    "vertical": [(64, 48, 64, 30), (64, 48, 64, 96), (40, 9, 40, 5)],
    "linear": [(64, 48, 30, 48), (64, 48, 130, 48), (64, 48, 129, 48)],
    "box": [(64, 48, 20, 15), (640, 480, 100, 70), (100, 30, 33, 10)],
    "down34": [(64, 48, 48, 36), (96, 96, 72, 72), (72, 24, 54, 18)],
    "down2": [(64, 48, 32, 24), (70, 26, 35, 13)],
    "down38": [(64, 48, 24, 18), (72, 24, 27, 9), (88, 37, 33, 14)],
    "down4": [(64, 64, 16, 16), (72, 44, 18, 11)],
    "up2": [(64, 48, 128, 96), (64, 48, 127, 95), (17, 9, 33, 18)],
    "point": [(1, 5, 3, 9), (5, 1, 9, 3), (90, 5, 30, 5)],
}


@pytest.mark.parametrize("path_name", sorted(SCALE_PATHS))
def test_scale_plane_equals_libavifs(path_name):
    """Each path libyuv's ScalePlane takes under libavif's box filter
    (after ScaleFilterReduce), on seeded random planes and a smooth one,
    against libavif's own avifImageScale: the SSSE3 rows' arithmetic of
    the 3/4 and 3/8 reductions included."""
    from l3c_torch.data import avif_scale
    if libavif() is None:
        pytest.skip("this Pillow bundles no libavif")
    r = np.random.RandomState(len(path_name))
    for sw, sh, dw, dh in SCALE_PATHS[path_name]:
        for plane in (r.randint(0, 256, (sh, sw)),
                      np.cumsum(r.randint(-4, 5, (sh, sw)), 1) + 128):
            plane = np.clip(plane, 0, 255).astype(np.uint8)
            assert np.array_equal(avif_scale.scale_plane(plane, dw, dh),
                                  _scale_by_libavif(plane, dw, dh)), \
                (sw, sh, dw, dh)


def _base_grid():
    return items_of(libavif_encode(quarters(photo(128, 128, 110), 2, 2),
                                   quality=60, advanced=OFF))


def _edit(fn):
    f = _base_grid()
    fn(f)
    return mux(f)


def _drop(f, item, typ):
    f["items"][item]["props"] = [p for p in f["items"][item]["props"]
                                 if p[0] != typ]


def _payload(f, body):
    f["items"][1]["data"] = bytes.fromhex(body)


# hand-edited grids: True where libavif 1.3.0 decodes the edit (Pillow's
# pixels), False where it refuses (Pillow refuses too)
GRID_EDITS = {
    "no_grid_ispe": (lambda f: _drop(f, 1, b"ispe"), False),
    "no_cell_ispe": (lambda f: _drop(f, 3, b"ispe"), False),
    "no_first_cell_av1c": (lambda f: _drop(f, 2, b"av1C"), False),
    "no_later_cell_av1c": (lambda f: _drop(f, 3, b"av1C"), False),
    "cell_av1c_level": (lambda f: set_prop(f, 3, b"av1C", bytes.fromhex(
        "81000d00")), False),
    "cell_ispe_other": (lambda f: set_ispe(f, 3, 64, 56), False),
    "odd_output": (lambda f: (_payload(f, "00000101007f0080"),
                              set_ispe(f, 1, 127, 128)), False),
    "spare_column": (lambda f: (_payload(f, "0000010100400080"),
                                set_ispe(f, 1, 64, 128)), False),
    "not_covered": (lambda f: (_payload(f, "0000010100820080"),
                               set_ispe(f, 1, 130, 128)), False),
    "version_1": (lambda f: _payload(f, "0100010100800080"), False),
    "bytes_past": (lambda f: _payload(f, "0001010100000080000000800000"),
                   False),
    "cut_short": (lambda f: _payload(f, "00000101008000"), False),
    "zero_width": (lambda f: _payload(f, "0000010100000080"), False),
    "three_refs": (lambda f: f.update(refs=[[b"dimg", 1, [2, 3, 4]]]),
                   False),
    "ref_twice": (lambda f: f.update(refs=[[b"dimg", 1, [2, 3, 4, 4]]]),
                  False),
    "two_dimg_boxes": (lambda f: f.update(refs=[[b"dimg", 1, [2, 3]],
                                                [b"dimg", 1, [4, 5]]]),
                       False),
    "cell_is_grid": (lambda f: f["items"][3].update(type=b"grid"), False),
    "cell_essential": (lambda f: f["items"][3]["props"].append(
        (b"xxxx", b"abcd", True)), False),
    "cells_range_differs": (lambda f: f["items"][3].update(
        data=_seq_range(f["items"][3]["data"], 0)), False),
    "output_past_ispe": (lambda f: _payload(f, "0000010100780070"), False),
    "wide_fields": (lambda f: _payload(f, "000101010000008000000080"),
                    True),
    "other_flags": (lambda f: _payload(f, "0002010100800080"), True),
    "cells_reordered": (lambda f: f.update(refs=[[b"dimg", 1,
                                                  [3, 2, 5, 4]]]), True),
    "payload_in_idat": (lambda f: f["items"][1].update(idat=True), True),
    "no_grid_colr_limited_cells": (lambda f: (_drop(f, 1, b"colr"), [
        f["items"][k].update(data=_seq_range(f["items"][k]["data"], 0))
        for k in (2, 3, 4, 5)]), True),
    "grid_colr_over_cells": (lambda f: [f["items"][k].update(
        data=_seq_range(f["items"][k]["data"], 0)) for k in (2, 3, 4, 5)],
        True),
    "ispe_below_output": (lambda f: set_ispe(f, 1, 120, 112), True),
    # one dav1d context decodes every cell: a later cell without a
    # sequence header takes the one before; the first cell has none
    "later_cell_without_sequence_header": (lambda f: f["items"][4].update(
        data=_without_sequence_header(f["items"][4]["data"])), True),
    "first_cell_without_sequence_header": (lambda f: f["items"][2].update(
        data=_without_sequence_header(f["items"][2]["data"])), False),
    # dav1d reads the data after a cell's frame: an OBU cut short there
    # fails the grid, a temporal delimiter does not
    "cut_obu_after_a_cell": (lambda f: f["items"][3].update(
        data=f["items"][3]["data"] + bytes([0x0A, 0x0B, 0])), False),
    "delimiter_after_the_last_cell": (lambda f: f["items"][5].update(
        data=f["items"][5]["data"] + bytes([0x12, 0])), True),
}


def _without_sequence_header(data):
    return b"".join(data[o[3] - 2:o[4]] for o in av1_obu.obus(data, "x")
                    if o[0] != av1_obu.OBU_SEQUENCE_HEADER)


def _seq_range(data, full):
    """An item's OBUs with the sequence header's colour range flag set to
    `full` (the bit read after color_description_present_flag)."""
    reads = []

    class Log(av1_obu.Bits):
        def f(self, n):
            reads.append((self.bit, n))
            return super().f(n)
    typ, _, _, at, end = next(o for o in av1_obu.obus(data, "x")
                              if o[0] == av1_obu.OBU_SEQUENCE_HEADER)
    seq = av1_obu.sequence_header(Log(data, at, end, "x"))
    assert not seq.mono and seq.ssx and seq.ssy    # 4:2:0: range, csp
    b = bytearray(data)
    _put(b, reads[-4][0], 1, full)
    return bytes(b)


def _iloc_reserved(blob):
    """The first item's construction-method field with a reserved bit
    set (iloc version 1, as `mux` writes it)."""
    i = blob.find(b"iloc") + 4 + 4 + 2 + 2 + 2
    return blob[:i] + b"\x01" + blob[i + 1:]


def _still_flag_cleared(data):
    """An item's OBUs with the sequence header's still_picture flag
    cleared under its reduced_still_picture_header."""
    typ, _, _, at, end = next(o for o in av1_obu.obus(data, "x")
                              if o[0] == av1_obu.OBU_SEQUENCE_HEADER)
    b = bytearray(data)
    assert b[at] & 0x18 == 0x18
    b[at] &= ~0x10
    return bytes(b)


def _rgba_edit(fn, **kw):
    f = items_of(save(with_alpha(photo(32, 40, 111), 9), quality=70, **kw))
    fn(f)
    return mux(f)


def _second_colour(f, refs):
    """A copy of the colour item as item 3, and iref `refs`."""
    f["items"][3] = dict(f["items"][1])
    f["refs"] = refs


# container and header rules a seeded flip sweep over the grid, scaled and
# new-matrix fixtures found: True where libavif decodes the edit
CONTAINER_EDITS = {
    "iloc_reserved_bits": (lambda: _iloc_reserved(_rgba_edit(
        lambda f: None)), False),
    "iref_item_0": (lambda: _rgba_edit(lambda f: f.update(
        refs=[[b"auxl", 2, [0]]])), False),
    "unreferenced_av01_without_ispe": (lambda: _rgba_edit(
        lambda f: f["items"].update({3: dict(
            type=b"av01", data=f["items"][2]["data"], props=[],
            idat=False)})), False),
    "alpha_without_ispe": (lambda: _rgba_edit(lambda f: f["items"][2].update(
        props=[p for p in f["items"][2]["props"] if p[0] != b"ispe"])),
        False),
    "pixi_of_one_channel": (lambda: _rgba_edit(lambda f: set_prop(
        f, 1, b"pixi", bytes.fromhex("000000000108"))), True),
    "pixi_and_av1c_of_10_bits": (lambda: _rgba_edit(lambda f: (set_prop(
        f, 1, b"pixi", bytes.fromhex("00000000030a0a0a")), set_prop(
        f, 1, b"av1C", bytes.fromhex("81004c00")))), True),
    "cut_obu_after_the_frame": (lambda: _rgba_edit(
        lambda f: f["items"][1].update(data=f["items"][1]["data"] + bytes(
            [0x0A, 0x0B, 0]))), False),
    # libavif keeps one target per item and reference type, the last
    "prem_from_the_alpha": (lambda: _rgba_edit(lambda f: f.update(
        refs=[[b"auxl", 2, [1]], [b"prem", 2, [1]]]),
        alpha_premultiplied=True), True),
    "prem_naming_another_item_last": (lambda: _rgba_edit(
        lambda f: _second_colour(f, [[b"auxl", 2, [1]],
                                     [b"prem", 1, [2, 3]]]),
        alpha_premultiplied=True), True),
    "auxl_naming_another_item_last": (lambda: _rgba_edit(
        lambda f: _second_colour(f, [[b"auxl", 2, [1, 3]]])), True),
    "two_nclx_colr": (lambda: _rgba_edit(lambda f: f["items"][1][
        "props"].append((b"colr", bytes.fromhex("6e636c780002000d000680"),
                         False))), False),
    "two_icc_colr": (lambda: _rgba_edit(lambda f: f["items"][1][
        "props"].extend([(b"colr", b"prof" + bytes(16), False),
                         (b"colr", b"rICC" + bytes(8), False)])), False),
    "primary_of_no_bytes": (lambda: _rgba_edit(
        lambda f: f["items"][1].update(data=b"")), False),
    "tile_group_after_the_frame": (lambda: _rgba_edit(
        lambda f: f["items"][1].update(data=f["items"][1]["data"] + bytes(
            [0x22, 1, 0]))), False),
    "reduced_header_not_still": (lambda: _rgba_edit(
        lambda f: f["items"][1].update(data=_still_flag_cleared(
            f["items"][1]["data"]))), False),
}


@pytest.mark.parametrize("edit", sorted(CONTAINER_EDITS))
def test_container_rules_as_libavif(tmp_path, edit):
    """An RGBA Pillow save written again by `mux` with one edit: a
    nonzero reserved field in iloc, item 0 in iref, an AV1 item (an alpha
    one too) without ispe, libavif's refusals; a pixi that disagrees with
    the frame's planes or depth, which libavif does not check against the
    frame; two colr boxes of one kind (nclx, ICC) on the image, libavif's
    refusal; an item of no bytes (an extent's length 0 is 0 bytes, and
    libavif skips the item); dav1d's refusals of a reduced still picture
    header not marked a still picture and of an OBU cut short or a tile
    group after the frame (dav1d reads the item's data to its end); a
    prem or auxl reference that names
    another item last (libavif keeps the last), a prem from the alpha.
    Each as Pillow, mode included."""
    make, decodes = CONTAINER_EDITS[edit]
    p = str(tmp_path / "c.avif")
    with open(p, "wb") as f:
        f.write(make())
    pil, port = _outcome(p)
    if decodes:
        assert pil is not None and np.array_equal(port, pil)
        with Image.open(p) as im:
            assert timages.image_mode(p) == im.mode
    else:
        assert pil is None and port is None, port


def _cells_own_alphas(drop=0, extra=False, prem=False):
    """The RGBA grid fixture with its alpha grid taken away and each
    alpha cell made the alpha of a colour cell (`drop` of them left
    without; `extra`: cell 2 given a second alpha; `prem`: a prem
    reference from the colour grid to an ID no item has)."""
    with open(os.path.join(FIXTURES, "grid_rgba_420.avif"), "rb") as f:
        g = items_of(f.read())
    del g["items"][6]
    pairs = list(zip((7, 8, 9, 10), (2, 3, 4, 5)))[drop:]
    g["refs"] = [[b"dimg", 1, [2, 3, 4, 5]]] + [[b"auxl", a, [c]]
                                                for a, c in pairs]
    if extra:
        g["items"][11] = dict(g["items"][7])
        g["refs"].append([b"auxl", 11, [2]])
    if prem:
        g["refs"].append([b"prem", 1, [11]])
    return mux(g)


@pytest.mark.parametrize("kind, mode", [
    ({}, "RGBA"), ({"drop": 1}, "RGB"), ({"extra": True}, None),
    ({"prem": True}, "RGBA")])
def test_grid_cells_with_their_own_alpha_as_pillow(tmp_path, kind, mode):
    """A colour grid with no alpha item whose cells each have one: libavif
    makes up an alpha grid of them under an ID past every ID the file
    names (so no prem reference can name it: not premultiplied); Pillow's
    RGBA; RGB where a cell has none; refused where a cell has two."""
    p = str(tmp_path / "g.avif")
    with open(p, "wb") as f:
        f.write(_cells_own_alphas(**kind))
    pil, port = _outcome(p)
    if mode is None:
        assert pil is None and port is None, port
        return
    with Image.open(p) as im:
        assert im.mode == timages.image_mode(p) == mode
    assert np.array_equal(port, pil)


@pytest.mark.parametrize("edit", sorted(GRID_EDITS))
def test_grid_rules_as_libavif(tmp_path, edit):
    """A 2 x 2 grid of libavif's encoder, hand-edited: libavif's refusals
    (the ImageGrid payload's version, sizes and length, the cells' count,
    types, essential properties, ispe and av1C, the cells' sizes and
    sequence headers, covering the output without a spare row or column,
    even sizes under subsampled chroma, two dimg boxes from one item;
    Pillow's where the output is larger than ispe) refused by the port
    with Pillow; the edits libavif takes (32-bit fields, other flags, the
    cells' order from iref, the payload in idat, the colour from the
    grid's colr box or else the first cell's sequence header, an ispe
    smaller than the output) decoded to Pillow's pixels."""
    fn, decodes = GRID_EDITS[edit]
    p = str(tmp_path / "g.avif")
    with open(p, "wb") as f:
        f.write(_edit(fn))
    pil, port = _outcome(p)
    if decodes:
        assert pil is not None and np.array_equal(port, pil)
    else:
        assert pil is None and port is None, port


# ------------------------------------------------------ the container

def _box(t, body):
    return struct.pack(">I", 8 + len(body)) + t + body


def _full(t, v, flags, body):
    return _box(t, bytes([v]) + flags.to_bytes(3, "big") + body)


def remux(blob, iloc=0, ipma=0, ipma_wide=False, idat=False, extents=1,
          index_size=0, data=None):
    """Pillow's still with its item written again by a test-only writer:
    `iloc` version 0-2 (construction method 1 puts the data in `idat`),
    the data in `extents` pieces, `ipma` version 0 / 1 with one- or
    two-byte property indices (av1C marked essential); `data` replaces
    the item's OBUs."""
    m = avif.parse(blob, "x")
    if data is None:
        data = avif._item_bytes(blob, m, m.primary, "x")
    props = [avif._prop(m, m.primary, t) for t in (b"ispe", b"pixi",
                                                    b"av1C")]
    colr = avif._prop(m, m.primary, b"colr")
    ipco = _box(b"ipco", _box(b"ispe", props[0]) + _box(b"pixi", props[1])
                + _box(b"av1C", props[2]) + _box(b"colr", colr))
    n = 2 if ipma_wide else 1
    idx = [(i | (0x8000 if i == 3 else 0)) if ipma_wide else
           (i | (0x80 if i == 3 else 0)) for i in (1, 2, 3, 4)]
    ipma_body = struct.pack(">I", 1) + (struct.pack(">I", 1) if ipma else
                                        struct.pack(">H", 1)) + bytes([4])
    ipma_body += b"".join(v.to_bytes(n, "big") for v in idx)
    iprp = _box(b"iprp", ipco + _full(b"ipma", ipma, int(ipma_wide),
                                      ipma_body))
    hdlr = _full(b"hdlr", 0, 0, bytes(4) + b"pict" + bytes(13))
    pitm = _full(b"pitm", 0, 0, struct.pack(">H", 1))
    iinf = _full(b"iinf", 0, 0, struct.pack(">H", 1) + _full(
        b"infe", 2, 0, struct.pack(">HH", 1, 0) + b"av01" + b"\0"))
    cuts = np.linspace(0, len(data), extents + 1).astype(int)
    pieces = [(int(a), int(b) - int(a)) for a, b in zip(cuts, cuts[1:])]

    def iloc_box(base):
        body = bytes([0x44, index_size if iloc else 0])
        body += struct.pack(">I" if iloc == 2 else ">H", 1)
        body += struct.pack(">I" if iloc == 2 else ">H", 1)
        if iloc:
            body += struct.pack(">H", 1 if idat else 0)
        body += struct.pack(">HH", 0, len(pieces))
        for k, (off, ln) in enumerate(pieces):
            if iloc and index_size:
                body += struct.pack(">I", k)
            body += struct.pack(">II", base + off, ln)
        return _full(b"iloc", iloc, 0, body)
    ftyp = _box(b"ftyp", b"avif" + bytes(4) + b"mif1avifmiaf")
    extra = _box(b"idat", data) if idat else b""
    meta = _full(b"meta", 0, 0, hdlr + pitm + iloc_box(0) + iinf + iprp +
                 extra)
    base = 0 if idat else len(ftyp) + len(meta) + 8
    meta = _full(b"meta", 0, 0, hdlr + pitm + iloc_box(base) + iinf + iprp
                 + extra)
    return ftyp + meta + (b"" if idat else _box(b"mdat", data))


@pytest.mark.parametrize("kw", [
    dict(iloc=0), dict(iloc=0, extents=3), dict(iloc=1), dict(
        iloc=1, idat=True), dict(iloc=2, extents=2), dict(
        iloc=2, idat=True, extents=3), dict(iloc=1, index_size=4,
                                            extents=2),
    dict(ipma=1), dict(ipma_wide=True), dict(ipma=1, ipma_wide=True,
                                             iloc=2)])
def test_container_variants_read_as_pillow_reads_them(tmp_path, kw):
    """The item's location (iloc versions, idat, several extents) and its
    properties' association (ipma versions and index widths) as the test
    writer lays them out: Pillow's mode, size and pixels, the port's
    too."""
    blob = remux(save(photo(26, 34, 40), quality=70, advanced=OFF), **kw)
    p = str(tmp_path / "x.avif")
    with open(p, "wb") as f:
        f.write(blob)
    with Image.open(p) as im:
        mode, size = im.mode, im.size[::-1]
        want = np.asarray(im.convert("RGB"))
    assert timages.image_format(p) == "AVIF"
    assert timages.image_mode(p) == mode
    assert timages.image_size(p) == size
    assert np.array_equal(timages.load_image_uint8(p), want)


def _obu(typ, payload):
    size, n = bytearray(), len(payload)
    while True:
        size.append((n & 0x7F) | (0x80 if n >> 7 else 0))
        n >>= 7
        if not n:
            break
    return bytes([(typ << 3) | 2]) + bytes(size) + payload


def _bits(data, start, stop):
    """data's bits [start, stop) as a list."""
    return [(data[i >> 3] >> (7 - (i & 7))) & 1 for i in range(start, stop)]


def _pack(bits):
    bits = bits + [0] * (-len(bits) % 8)
    return bytes(int("".join(map(str, bits[i:i + 8])), 2)
                 for i in range(0, len(bits), 8))


def split_tile_groups(data, first):
    """The item's OBU_FRAME as an OBU_FRAME_HEADER and two OBU_TILE_GROUPs
    (tiles [0, first) and [first, n), tile_start_and_end_present_flag
    set), as an encoder that sends tiles early writes them."""
    obus = list(av1_obu.obus(data, "x"))
    head = [o for o in obus if o[0] == av1_obu.OBU_SEQUENCE_HEADER][0]
    seq = av1_obu.sequence_header(av1_obu.Bits(data, head[3], head[4], "x"))
    typ, _, _, at, end = obus[-1]
    assert typ == av1_obu.OBU_FRAME
    b = av1_obu.Bits(data, at, end, "x")
    f = av1_obu.frame_header(b, seq)
    out = b"".join(data[o[3] - 2 if o[4] - o[3] < 128 else o[3] - 3:o[4]]
                   for o in obus[:-1])
    out += _obu(av1_obu.OBU_FRAME_HEADER, _pack(_bits(data, 8 * at, b.bit)
                                                + [1]))
    b.byte_alignment()
    tiles = av1_obu._tile_group(data, b.pos, end, f, "x")
    n_bits = f.tile_cols_log2 + f.tile_rows_log2
    for lo, hi in ((0, first), (first, len(tiles))):
        bits = [1] + [(v >> (n_bits - 1 - i)) & 1 for v in (lo, hi - 1)
                      for i in range(n_bits)]
        payload = _pack(bits)
        for k in range(lo, hi):
            s, e = tiles[k][2:]
            if k < hi - 1:
                payload += (e - s - 1).to_bytes(f.tile_size_bytes, "little")
            payload += data[s:e]
        out += _obu(av1_obu.OBU_TILE_GROUP, payload)
    return out


def test_frame_header_and_tile_group_obus_as_pillow(tmp_path):
    """A frame sent as a frame header OBU and two tile group OBUs decodes
    as its one frame OBU does, in Pillow and in the port."""
    with open(os.path.join(FIXTURES, "j_tiles_sb128.avif"), "rb") as f:
        blob = f.read()
    m = avif.parse(blob, "x")
    data = avif._item_bytes(blob, m, m.primary, "x")
    assert len(av1_obu.parse_av1(data, "x")[2]) == 4
    p = str(tmp_path / "tg.avif")
    with open(p, "wb") as f:
        f.write(remux(blob, data=split_tile_groups(data, 1)))
    want = jimages.load_image_uint8(os.path.join(FIXTURES,
                                                 "j_tiles_sb128.avif"))
    assert np.array_equal(np.asarray(Image.open(p).convert("RGB")), want)
    assert np.array_equal(timages.load_image_uint8(p), want)


def test_high_bit_depth_is_refused_by_name(tmp_path):
    """A 10-bit AV1 still (a written header, one tile of zero data in an
    8-bit save's container) was refused by name until the port decoded
    10 and 12 bits; now it is not refused, and the port gives Pillow's
    pixels (tests/test_torch_port_avif_deep.py holds the deep path)."""
    from test_torch_port_av1 import av1_still
    blob = remux(save(photo(16, 16, 43), quality=70, advanced=OFF),
                 data=av1_still(16, 16, high=1))
    p = str(tmp_path / "hbd.avif")
    with open(p, "wb") as f:
        f.write(blob)
    pil, port = _outcome(p)
    assert pil is not None and not isinstance(port, str)
    assert np.array_equal(port, pil)


def test_image_sequence_with_meta_gives_its_first_frame(tmp_path):
    """Pillow's save_all writes an avis file with tracks and a primary
    item: Pillow shows the first frame, the port decodes the item."""
    p = str(tmp_path / "seq.avif")
    frames = [Image.fromarray(photo(32, 40, k)) for k in (41, 42)]
    frames[0].save(p, "AVIF", save_all=True, append_images=frames[1:],
                   advanced=OFF)
    with Image.open(p) as im:
        assert im.n_frames == 2
        want = np.asarray(im.convert("RGB"))
    assert np.array_equal(timages.load_image_uint8(p), want)


# ------------------------------------------------- Pillow's saves and refusals

_KEYS = [{}, {"tune-content": "screen", "enable-palette": "1"},
         {"enable-filter-intra": "1"}, {"enable-cfl-intra": "1"},
         {"enable-smooth-intra": "1"}, {"enable-paeth-intra": "1"},
         {"enable-angle-delta": "1"}, {"enable-tx64": "1"},
         {"enable-rect-partitions": "1"}, {"deltaq-mode": "2"}]


@pytest.mark.parametrize("k", range(len(_KEYS)))
def test_seeded_saves_over_aoms_keys_equal_pillow_and_jax(tmp_path, k):
    r = np.random.RandomState(50 + k)
    h, w = (int(v) for v in r.randint(8, 97, 2))
    img = (screen if k == 1 else waves if k % 2 else photo)(h, w, 50 + k)
    ss = ("4:4:4", "4:2:2", "4:2:0", "4:0:0")[k % 4]
    p = str(tmp_path / "x.avif")
    with open(p, "wb") as f:
        f.write(save(img, quality=int(r.randint(30, 96)), subsampling=ss,
                     speed=int(r.choice([4, 6, 8])), range=("full",
                                                            "limited")[k % 2],
                     advanced=dict(OFF, **_KEYS[k])))
    got = timages.load_image_uint8(p)
    assert np.array_equal(got, np.asarray(Image.open(p).convert("RGB")))
    assert np.array_equal(got, jimages.load_image_uint8(p))


# what the port refuses by name: nothing since inter frames are decoded
# (tests/test_torch_port_avif_inter.py)
F6_TOOLS = ()


def _outcome(p):
    """Pillow's pixels or None where Pillow refuses; the port's pixels,
    None where it refuses, or its message where it refuses naming a tool
    it does not decode yet."""
    try:
        with Image.open(p) as im:
            pil = np.asarray(im.convert("RGB"))
    except Exception:                  # noqa: BLE001 (Pillow's refusals)
        pil = None
    try:
        port = timages.load_image_uint8(p)
    except ValueError as e:
        port = str(e) if "not decoded by the port yet" in str(e) else None
    return pil, port


def _names_an_f6_tool(msg):
    return any(f"AVIF with {t}" in msg or t in msg.split(
        "not decoded")[0] for t in F6_TOOLS)


@pytest.mark.parametrize("ss", ["4:2:0", "4:2:2", "4:4:4", "4:0:0"])
def test_seeded_saves_with_grain_qm_and_intrabc_equal_pillow_and_jax(
        tmp_path, ss):
    """Pillow's saves with aom's keys for the tools decoded since the
    filters, seeded: a film grain test vector, a denoiser's grain table,
    quantizer matrices over a random level range, screen text with intra
    block copy; each equal to Pillow and the JAX loader, or refused naming
    a tool ROADMAP F6 still lists."""
    r = np.random.RandomState(95 + ord(ss[2]) + ord(ss[4]))
    lo = int(r.randint(0, 12))
    cases = [
        (photo(int(r.randint(17, 97)), int(r.randint(17, 97)), 96),
         {"film-grain-test": str(r.randint(1, 17))}),
        (photo(97, 113, 97), {"denoise-noise-level": "20"}),
        (textured(int(r.randint(17, 97)), int(r.randint(17, 97)), 98),
         {"enable-qm": "1", "qm-min": str(lo),
          "qm-max": str(int(r.randint(lo, 16)))}),
        (glyphs(144, 160, 99, noise=int(r.randint(0, 9))), SCREEN)]
    for k, (img, adv) in enumerate(cases):
        if ss == "4:2:2" and "denoise-noise-level" in adv:
            continue             # aom's denoiser refuses 4:2:2
        kw = dict(quality=int(r.randint(40, 85)), subsampling=ss,
                  speed=2 if adv is SCREEN else 6, advanced=adv)
        p = str(tmp_path / f"n{k}.avif")
        with open(p, "wb") as f:
            f.write(save(img, **kw))
        pil, port = _outcome(p)
        if isinstance(port, str):
            assert _names_an_f6_tool(port), (kw, port)
            continue
        assert np.array_equal(port, pil), kw
        assert np.array_equal(port, jimages.load_image_uint8(p)), kw


def _flip(blob: bytes, at: int, mask: int) -> bytes:
    b = bytearray(blob)
    b[at] ^= mask
    return bytes(b)


def test_header_and_container_damage_as_pillow(tmp_path):
    """Damage a sweep of single-bit flips found where the port and Pillow
    parted: colr nclx's range flag (libavif takes the range from it, not
    from the sequence header) and its reserved bits (refused); matrix
    coefficients libavif never converts, grey images included (refused);
    a set OBU forbidden bit and an OBU of a reserved type (dav1d passes
    over both); an av1C depth against pixi (refused); an alpha item that
    is damaged (libavif decodes it for Pillow's RGBA: refused) or has no
    data (skipped: an RGB file). Each as Pillow: equal pixels and mode,
    or both refuse."""
    grey = save(photo(24, 32, 80), quality=60, subsampling="4:0:0")
    rgb = save(photo(24, 32, 81), quality=60, subsampling="4:2:0",
               range="limited")
    rgba = save(np.dstack([photo(24, 32, 82), np.full((24, 32), 90,
                                                      np.uint8)]),
                quality=60)
    m = avif.parse(rgba, "x")
    alpha = avif._alpha_of(m, m.primary)
    a_at, a_len = m.items[alpha].extents[0]
    nclx = rgb.find(b"colrnclx") + 14
    seq_at = m.items[m.primary].extents[0][0] + 2
    item = avif._item_bytes(rgb, avif.parse(rgb, "x"), 1, "x")
    obu_at = rgb.find(item)
    assert item[:2] == bytes([(av1_obu.OBU_TEMPORAL_DELIMITER << 3) | 2, 0])
    cases = [_flip(rgb, nclx, 0x80), _flip(rgb, nclx, 0x01),
             _flip(rgba, seq_at, 0x80),
             rgba[:a_at] + bytes(a_len) + rgba[a_at + a_len:],
             _flip(rgb, rgb.find(b"av1C") + 6, 0x40),
             _flip(rgb, obu_at, (av1_obu.OBU_TEMPORAL_DELIMITER ^ 10) << 3)]
    iloc = rgba.find(b"iloc")
    two = rgba.find(struct.pack(">H", alpha), iloc + 12)
    cases.append(rgba[:two] + struct.pack(">H", 0x2002) + rgba[two + 2:])
    cases += [set_cicp(grey, 2, mc) for mc in (3, 8, 10, 13, 15, 16, 40)]
    cases += [set_cicp(rgb, 2, mc) for mc in (0, 3, 8, 11, 255)]
    agree = 0
    for k, blob in enumerate(cases):
        p = str(tmp_path / f"h{k}.avif")
        with open(p, "wb") as f:
            f.write(blob)
        pil, port = _outcome(p)
        if pil is None:
            assert port is None or _names_an_f6_tool(port), k
            continue
        assert not isinstance(port, str) or _names_an_f6_tool(port), k
        if not isinstance(port, str):
            assert np.array_equal(pil, port), k
            with Image.open(p) as im:
                assert timages.image_mode(p) == im.mode, k
            agree += 1
    assert agree >= 5


def test_coefficients_past_dav1ds_clips_as_pillow(tmp_path):
    """Two bit flips found in tile data that give coefficients far past
    an encoder's (a 32 x 32 DCT with a level of 1689 in a CDEF and
    restoration save; a premultiplied file's alpha item): dav1d clips the
    transforms' sums to 16 bits, and so does the port, to Pillow's
    pixels."""
    alpha = np.random.RandomState(1).randint(0, 256, (32, 40)).astype(
        np.uint8)
    cases = [(save(waves(48, 64, 7), quality=40, speed=2,
                   advanced={"enable-cdef": "1"}), 354, 0x02),
             (save(np.dstack([photo(32, 40, 3), alpha]),
                   alpha_premultiplied=True, quality=70), 981, 0x40)]
    clipped = []
    real = av1_recon._clip

    def clip(v):
        clipped.append(bool((v < av1_recon.LO).any() or
                            (v > av1_recon.HI).any()))
        return real(v)
    av1_recon._clip = clip
    try:
        for k, (blob, at, mask) in enumerate(cases):
            p = str(tmp_path / f"c{k}.avif")
            with open(p, "wb") as f:
                f.write(_flip(blob, at, mask))
            clipped.clear()
            pil, port = _outcome(p)
            assert pil is not None and np.array_equal(pil, port), k
            assert any(clipped), k
    finally:
        av1_recon._clip = real


def test_truncated_and_bit_flipped_files_as_pillow(tmp_path):
    """Cut anywhere, or with a bit flipped in its container, headers or
    tile data, a filters-off save, one with every in-loop filter on, one
    with film grain and quantizer matrices, a grid of two cells and a file
    of the chroma-derived matrix (libavif's float conversion):
    where Pillow decodes, the port gives its pixels (dav1d's and the
    port's walk of damaged tile data agree, a flip in a filter's header
    fields or symbols included, and a flip that switches superres, delta_lf
    or a segment feature on) or names a tool ROADMAP F6 still lists;
    where Pillow refuses, the port
    refuses (libavif's box checks, dav1d's tile overread and 4:2:2
    partition checks), as damaged or, where a tool F6 lists comes first,
    by that tool's name."""
    blobs = [save(waves(40, 48, 60), quality=60, subsampling="4:2:0",
                  advanced=OFF),
             save(waves(72, 80, 62), quality=40, subsampling="4:2:0",
                  speed=2, advanced={"enable-cdef": "1"}),
             save(waves(40, 56, 64), quality=50, subsampling="4:2:0",
                  advanced={"film-grain-test": "5", "enable-qm": "1"}),
             libavif_encode(quarters(waves(64, 128, 65), 1, 2), quality=50,
                            advanced=OFF),
             libavif_encode([[photo(48, 64, 66)]], cicp=(12, 13, 12),
                            quality=85, advanced=OFF)]
    r = np.random.RandomState(61)
    for n, blob in enumerate(blobs):
        cases = [blob[:n] for n in (len(blob) - 1, len(blob) - 40,
                                    len(blob) // 2, 300, 40)]
        for _ in range(40 + 30 * (n == 1)):  # the filters' file: more
            b = bytearray(blob)
            b[r.randint(len(b))] ^= 1 << r.randint(8)
            cases.append(bytes(b))
        decoded = 0
        for k, b in enumerate(cases):
            p = str(tmp_path / f"c{n}_{k}.avif")
            with open(p, "wb") as f:
                f.write(b)
            pil, port = _outcome(p)
            if pil is None:
                # refused: as damaged, or naming a tool F6 lists that the
                # port meets before the damage (a flipped frame size)
                assert port is None or _names_an_f6_tool(port), (n, k)
            elif isinstance(port, str):
                assert _names_an_f6_tool(port), (n, k, port)
            else:
                assert np.array_equal(pil, port), (n, k)
                decoded += 1
        assert 20 <= decoded < len(cases), n


def test_defaults_decode_where_aom_wrote_no_filter(tmp_path):
    """Pillow's default save runs the deblocking filter below quality 90,
    and from 90 aom writes no in-loop filter: both decode to Pillow's
    pixels."""
    img = photo(40, 48, 62)
    for q, deblocked in ((75, True), (89, True), (90, False),
                         (100, False)):
        p = str(tmp_path / f"q{q}.avif")
        with open(p, "wb") as f:
            f.write(save(img, quality=q))
        m = avif.parse(open(p, "rb").read(), p)
        _, fr, _ = av1_obu.parse_av1(avif._item_bytes(
            open(p, "rb").read(), m, m.primary, p), p)
        assert bool(fr.lf_level[0] or fr.lf_level[1]) == deblocked
        got = timages.load_image_uint8(p)
        assert np.array_equal(got, jimages.load_image_uint8(p))
        assert np.array_equal(got, np.asarray(Image.open(p).convert("RGB")))


@pytest.mark.parametrize("speed", [None, 2])
@pytest.mark.parametrize("ss", ["4:2:0", "4:2:2", "4:4:4", "4:0:0"])
def test_seeded_filtered_saves_equal_pillow_and_jax(tmp_path, speed, ss):
    """Pillow's saves with the in-loop filters on, seeded: its default
    speed (deblocking) and speed 2 (loop restoration; CDEF switched on in
    every other file), qualities 20-89, RGB and RGBA, sizes 17-160: each
    equal to Pillow and the JAX loader, or refused naming a tool ROADMAP
    F6 still lists."""
    r = np.random.RandomState(90 + (speed or 0) + ord(ss[2]))
    for k in range(3):
        h, w = (int(v) for v in r.randint(17, 161, 2))
        img = (photo, textured, waves)[k](h, w, 91 + k)
        if k == 1:
            img = np.dstack([img, r.randint(100, 256, (h, w)).astype(
                np.uint8)])
        kw = dict(quality=int(r.randint(20, 90)), subsampling=ss)
        if speed:
            kw.update(speed=speed, advanced={"enable-cdef": str(k % 2)})
        p = str(tmp_path / f"s{k}.avif")
        with open(p, "wb") as f:
            f.write(save(img, **kw))
        pil, port = _outcome(p)
        if isinstance(port, str):
            assert _names_an_f6_tool(port), (kw, port)
            continue
        assert np.array_equal(port, pil), kw
        assert np.array_equal(port, jimages.load_image_uint8(p)), kw


def test_prep_inp_dir_over_avif_equals_jax(tmp_path, capsys):
    from l3c_tpu.cli import prep_pipeline as jpipe
    from l3c_torch.cli import prep_pipeline as tpipe
    dump = tmp_path / "dump"
    dump.mkdir()
    with open(str(dump / "photo.jpg"), "wb") as f:
        f.write(save(textured(200, 232, 63), quality=70, advanced=OFF))
    with open(str(dump / "still.avif"), "wb") as f:
        f.write(save(photo(176, 192, 64), quality=100,
                     subsampling="4:4:4"))
    outs = []
    for main, name in ((tpipe.main, "t"), (jpipe.main, "j")):
        out = str(tmp_path / name)
        assert main(["--inp_dir", str(dump), out, "--min_res", "160"]) == 0
        outs.append(out)
    capsys.readouterr()
    listing = lambda o: sorted(os.path.relpath(os.path.join(b, f), o)  # noqa
                               for b, _, fs in os.walk(o) for f in fs
                               if f.endswith(".png"))
    assert listing(outs[0]) == listing(outs[1]) and listing(outs[0])
    for rel in listing(outs[0]):
        np.testing.assert_array_equal(
            timages.read_png(os.path.join(outs[0], rel)),
            np.asarray(Image.open(os.path.join(outs[1], rel)).convert(
                "RGB")))


def test_cli_l3c_codes_an_avif_bit_exactly_on_the_cpu(tmp_path):
    from l3c_torch.cli import l3c as l3c_cli
    src = os.path.join(FIXTURES, "m_q60_420_as.png")
    coded, back = str(tmp_path / "x.l3c"), str(tmp_path / "x.png")
    zoo = os.path.join(ROOT, "models_zoo")
    assert l3c_cli.main([zoo, "0820_0345", "enc", src, coded,
                         "--device", "cpu"]) == 0
    assert l3c_cli.main([zoo, "0820_0345", "dec", coded, back,
                         "--device", "cpu"]) == 0
    assert np.array_equal(timages.read_png(back),
                          timages.load_image_uint8(src))


if __name__ == "__main__":
    for n in os.listdir(FIXTURES) if os.path.isdir(FIXTURES) else ():
        os.remove(os.path.join(FIXTURES, n))
    make_avif_fixtures(FIXTURES)
    exp = {**avif_expected_now(), "made_by": _versions()}
    with open(os.path.join(FIXTURES, "expected.json"), "w") as f:
        json.dump(exp, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {len(exp['files'])} fixtures and expected.json to "
          f"{FIXTURES}")
