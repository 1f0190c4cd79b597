"""The port's JPEG 2000 decoder (data/jpeg2000.py, data/jpeg2000_t1.py) on
what Pillow's save cannot write, against Pillow, which the JAX package's
load_image_uint8 decodes through (OpenJPEG 2.5 under Jpeg2KImagePlugin).

The files are made by a test-only writer over the libopenjp2 that Pillow
ships (ctypes here only; the port imports neither), and by hand around its
codestreams:
  - every code-block style bit (BYPASS, RESET, TERMALL, VSC, PTERM,
    SEGSYM) alone and all six at once, 5/3 and 9/7, over several layers;
  - SOP + EPH with TLM and PLT, POC changes, ROI (RGN) on one component;
  - sub-sampled components (4:2:0, 4:2:2, one chroma plane, the first
    plane, all planes, odd sizes), which a raw codestream's decoder takes
    as sYCC where the first component is full-size and another is not;
  - precisions from 4 to 16 bits, signed components, a canvas and a tile
    grid at odd offsets, precincts, 4 and 5 components;
  - JP2 files assembled around those codestreams: sYCC, sRGB, grey and
    e-sYCC colr boxes, an ICC profile, CMYK, a palette (pclr + cmap, with
    repeated and missing entries, 4-bit indices, with alpha), an ihdr
    that disagrees with the codestream;
  - packet headers packed into PPT and PPM, tile-parts interleaved across
    tiles, and a 9/7 decode of one-sample-wide resolutions;
  - COC and QCC over the main COD and QCD, a tile-part's COD and QCD over
    the main COC and QCC, scalar derived quantisation, 1 and 5 guard
    bits;
every pixel equal to Pillow's convert("RGB") and the JAX loader's, and the
mode and size from the header equal to Pillow's; where Pillow refuses a
file the port raises ValueError. A Part-1 codestream marked as HTJ2K is
refused as OpenJPEG refuses it (its MQ passes read as HT code-blocks).

The writer finds opj_cparameters_t's fields by what
opj_set_default_encoder_parameters writes (numresolution 6 followed by the
64 x 64 code-blocks; the sub-sampling 1, 1 followed by the formats -1, -1)
and places the rest by the header's order, which test_writer_sets_what_
it_is_asked checks on the codestreams it writes. The files are committed
(l3c_torch/data/fixtures/jpeg2000_coding, with expected.json), so the
port's checks need no library; `python tests/test_torch_port_jpeg2000_
coding.py` (from the repo root, PYTHONPATH=.) rewrites them.
"""
import ctypes
import glob
import hashlib
import json
import os
import struct
import sys

import numpy as np
import PIL
import PIL.features
import pytest
from PIL import Image

from l3c_tpu.data import images as jimages
from l3c_torch.data import images as timages

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_gif import check  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODING = os.path.join(ROOT, "l3c_torch", "data", "fixtures",
                      "jpeg2000_coding")


def content(h, w, seed):
    """Gradients with noise: every bit-plane busy, as a photograph's."""
    r = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 3 + y) % 256, (y * 2 + 50) % 256,
                     (x + y * 5) % 256], -1)
    return np.clip(base + r.randint(-20, 20, (h, w, 3)), 0,
                   255).astype(np.uint8)


# ------------------------------------------------------------ the writer

class _CmptParm(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in
                ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd")]


class _Comp(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in
                ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd",
                 "resno_decoded", "factor")] + [
        ("data", ctypes.POINTER(ctypes.c_int32)), ("alpha", ctypes.c_uint16)]


class _Image(ctypes.Structure):
    _fields_ = [("x0", ctypes.c_uint32), ("y0", ctypes.c_uint32),
                ("x1", ctypes.c_uint32), ("y1", ctypes.c_uint32),
                ("numcomps", ctypes.c_uint32), ("color_space", ctypes.c_int),
                ("comps", ctypes.POINTER(_Comp)),
                ("icc_profile_buf", ctypes.c_void_p),
                ("icc_profile_len", ctypes.c_uint32)]


_LIB = {}


def libopenjp2():
    """Pillow's libopenjp2, its functions typed, or None."""
    if "lib" not in _LIB:
        so = glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..",
                                    "pillow.libs", "libopenjp2-*.so*"))
        lib = ctypes.CDLL(so[0]) if so else None
        if lib is not None:
            vp = ctypes.c_void_p
            lib.opj_image_create.restype = ctypes.POINTER(_Image)
            lib.opj_image_create.argtypes = [
                ctypes.c_uint32, ctypes.POINTER(_CmptParm), ctypes.c_int]
            lib.opj_create_compress.restype = vp
            lib.opj_stream_create_default_file_stream.restype = vp
            lib.opj_stream_create_default_file_stream.argtypes = [
                ctypes.c_char_p, ctypes.c_int]
            for f in ("opj_setup_encoder", "opj_start_compress"):
                getattr(lib, f).argtypes = [vp, vp, vp]
            for f in ("opj_encode", "opj_end_compress"):
                getattr(lib, f).argtypes = [vp, vp]
            lib.opj_encoder_set_extra_options.argtypes = [
                vp, ctypes.POINTER(ctypes.c_char_p)]
            for f in ("opj_stream_destroy", "opj_destroy_codec",
                      "opj_image_destroy"):
                getattr(lib, f).argtypes = [vp]
        _LIB["lib"] = lib
    return _LIB["lib"]


def offsets():
    """opj_cparameters_t's size and the byte offsets of the fields the
    writer sets, anchored on the defaults."""
    if "off" in _LIB:
        return _LIB["off"]
    n = 65536
    buf = (ctypes.c_ubyte * n)(*([0xAB] * n))
    libopenjp2().opj_set_default_encoder_parameters(buf)
    raw = bytes(buf)
    size = max(i for i in range(n) if raw[i] != 0xAB) + 1
    words = np.frombuffer(raw[:size & ~3], np.int32).tolist()
    num = 4 * next(i for i in range(len(words))
                   if words[i:i + 6] == [6, 64, 64, 0, 0, -1])
    sub = 4 * next(i for i in range(len(words))
                   if words[i:i + 4] == [1, 1, -1, -1])
    # tile_size_on, cp_tx0 .. cp_tdy, the three allocation flags, two
    # pointers, csty, prog_order, then POC[32], numpocs, tcp_numlayers,
    # tcp_rates[100] and tcp_distoratio[100] up to numresolution
    npoc = num - 800 - 8
    poc_size = (npoc - 56) // 32
    assert poc_size * 32 == npoc - 56
    off = dict(size=size, tile_size_on=0, cp_tx0=4, cp_ty0=8, cp_tdx=12,
               cp_tdy=16, cp_disto_alloc=20, csty=48, prog_order=52,
               POC=56, poc_size=poc_size, numpocs=npoc,
               tcp_numlayers=npoc + 4, tcp_rates=npoc + 8,
               numresolution=num, cblockw_init=num + 4,
               cblockh_init=num + 8, mode=num + 12, irreversible=num + 16,
               roi_compno=num + 20, roi_shift=num + 24, res_spec=num + 28,
               prcw_init=num + 32, prch_init=num + 32 + 33 * 4,
               image_offset_x0=sub - 8, image_offset_y0=sub - 4)
    _LIB["off"] = off
    return off


def encode(planes, canvas, path, prec=8, sgnd=False, dx=None, dy=None,
           space=0, levels=5, cblk=(64, 64), mode=0, irreversible=False,
           roi=None, csty=0, precincts=None, tiles=None, rates=(0,),
           pocs=(), prog=0, extra=()):
    """A raw codestream of `planes` (each component's samples at its own
    sampling) on the canvas (x0, y0, x1, y1): code-block style `mode`,
    `csty` (2 SOP, 4 EPH), `roi` (component, shift), `tiles` (x0, y0,
    width, height), layer `rates` (0: lossless), `pocs` (resno0, compno0,
    layno1, resno1, compno1, progression, tile), `extra` options such as
    "TLM=YES"; written through `path`."""
    lib, o = libopenjp2(), offsets()
    n = len(planes)
    dx, dy = dx or [1] * n, dy or [1] * n
    prec = list(prec) if isinstance(prec, (list, tuple)) else [prec] * n
    sgnd = list(sgnd) if isinstance(sgnd, (list, tuple)) else [sgnd] * n
    x0, y0, x1, y1 = canvas
    parms = (_CmptParm * n)()
    for c in range(n):
        p = parms[c]
        p.dx, p.dy = dx[c], dy[c]
        p.x0, p.y0 = -(-x0 // dx[c]), -(-y0 // dy[c])
        p.w, p.h = -(-x1 // dx[c]) - p.x0, -(-y1 // dy[c]) - p.y0
        assert planes[c].shape == (p.h, p.w), (planes[c].shape, p.h, p.w)
        p.prec, p.bpp, p.sgnd = prec[c], prec[c], int(sgnd[c])
    img = lib.opj_image_create(n, parms, space)
    im = img.contents
    im.x0, im.y0, im.x1, im.y1 = x0, y0, x1, y1
    for c in range(n):
        a = np.ascontiguousarray(planes[c], np.int32).ravel()
        ctypes.memmove(im.comps[c].data, a.ctypes.data, a.nbytes)
    buf = (ctypes.c_ubyte * o["size"])()
    lib.opj_set_default_encoder_parameters(buf)

    def put(name, v, fmt="<i", at=0):
        struct.pack_into(fmt, buf, o[name] + at, v)
    put("numresolution", levels + 1)
    put("cblockw_init", cblk[0])
    put("cblockh_init", cblk[1])
    put("mode", mode)
    put("irreversible", int(irreversible))
    put("csty", csty | (1 if precincts else 0))
    put("prog_order", prog)
    if roi:
        put("roi_compno", roi[0])
        put("roi_shift", roi[1])
    for i, (pw, ph) in enumerate(precincts or ()):
        put("res_spec", len(precincts))
        put("prcw_init", pw, at=4 * i)
        put("prch_init", ph, at=4 * i)
    if tiles:
        put("tile_size_on", 1)
        for k, v in zip(("cp_tx0", "cp_ty0", "cp_tdx", "cp_tdy"), tiles):
            put(k, v)
    put("image_offset_x0", x0)
    put("image_offset_y0", y0)
    put("tcp_numlayers", len(rates))
    put("cp_disto_alloc", 1)
    for i, r in enumerate(rates):
        put("tcp_rates", float(r), "<f", 4 * i)
    for i, entry in enumerate(pocs):
        for k, v in zip((0, 4, 8, 12, 16, 32, 48), entry):
            put("POC", v, at=o["poc_size"] * i + k)
    put("numpocs", len(pocs))
    codec = lib.opj_create_compress(0)          # OPJ_CODEC_J2K
    assert lib.opj_setup_encoder(codec, buf, img)
    if extra:
        opts = (ctypes.c_char_p * (len(extra) + 1))(
            *[e.encode() for e in extra], None)
        assert lib.opj_encoder_set_extra_options(codec, opts)
    stream = lib.opj_stream_create_default_file_stream(path.encode(), 0)
    ok = lib.opj_start_compress(codec, img, stream) and \
        lib.opj_encode(codec, stream) and lib.opj_end_compress(codec, stream)
    lib.opj_stream_destroy(stream)
    lib.opj_destroy_codec(codec)
    lib.opj_image_destroy(img)
    assert ok
    with open(path, "rb") as f:
        return f.read()


# ------------------------------------------------- JP2 boxes, by hand

def box(typ, body):
    return struct.pack(">I4s", 8 + len(body), typ) + body


def jp2(cs, enumcs=16, pclr=None, icc=False, nc=None, hw=None):
    """A JP2 file around codestream `cs`: ihdr from its SIZ (or `nc`,
    `hw`), a colr box (an enumerated space, or an ICC profile), and a
    palette (pclr + cmap) of `pclr`'s rows."""
    x1, y1, x0, y0 = struct.unpack(">IIII", cs[8:24])
    n, = struct.unpack(">H", cs[40:42])
    h, w = hw or (y1 - y0, x1 - x0)
    hdr = box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc or n, cs[42], 7, 0,
                                   0))
    hdr += box(b"colr", bytes([2, 0, 0]) + bytes(20) if icc else
               struct.pack(">BBBI", 1, 0, 0, enumcs))
    if pclr is not None:
        ents = np.asarray(pclr, np.uint8)
        k = ents.shape[1]
        hdr += box(b"pclr", struct.pack(">HB", len(ents), k) +
                   bytes([7] * k) + ents.tobytes())
        hdr += box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, i)
                                     for i in range(k)))
    return (b"\0\0\0\x0cjP  \r\n\x87\n" +
            box(b"ftyp", b"jp2 \0\0\0\0jp2 ") + box(b"jp2h", hdr) +
            box(b"jp2c", cs))


# ------------------------------------ packed headers, tile-parts, by hand

def _seg(marker, body):
    return struct.pack(">HH", marker, len(body) + 2) + body


def _tile_parts(cs):
    """(main header, [((Isot, TPsot, TNsot), header, data)])."""
    at = cs.find(b"\xff\x90")
    main, parts = cs[:at], []
    while cs[at:at + 2] == b"\xff\x90":
        isot, psot, tpsot, tnsot = struct.unpack(">HIBB", cs[at + 4:at + 12])
        sod = cs.index(b"\xff\x93", at + 12)
        parts.append(((isot, tpsot, tnsot), cs[at + 12:sod],
                      cs[sod + 2:at + psot]))
        at += psot
    return main, parts


def _packets(data):
    """[(SOP segment, header with its EPH, body)] of data coded with SOP
    and EPH (neither marker can occur inside a header or a body)."""
    out, at = [], 0
    while at < len(data):
        assert data[at:at + 2] == b"\xff\x91"
        eph = data.index(b"\xff\x92", at + 6) + 2
        nxt = data.find(b"\xff\x91", eph)
        nxt = len(data) if nxt < 0 else nxt
        out.append((data[at:at + 6], data[at + 6:eph], data[eph:nxt]))
        at = nxt
    return out


def packed(cs, where):
    """`cs` (coded with SOP and EPH) with its packet headers moved into
    two PPT segments of each tile-part ("ppt") or two PPM segments of the
    main header ("ppm")."""
    main, parts = _tile_parts(cs)
    chunks, out = [], []
    for (isot, tpsot, tnsot), hdr, data in parts:
        pk = _packets(data)
        heads = b"".join(h for _, h, _ in pk)
        body = b"".join(s + b for s, _, b in pk)
        if where == "ppt":
            k = len(heads) // 2
            hdr += _seg(0xFF61, b"\0" + heads[:k]) + \
                _seg(0xFF61, b"\1" + heads[k:])
        else:
            chunks.append(struct.pack(">I", len(heads)) + heads)
        out.append(_seg(0xFF90, struct.pack(
            ">HIBB", isot, 14 + len(hdr) + len(body), tpsot, tnsot)) +
            hdr + b"\xff\x93" + body)
    if where == "ppm":
        allp = b"".join(chunks)
        k = len(allp) // 2
        main += _seg(0xFF60, b"\0" + allp[:k]) + _seg(0xFF60, b"\1" +
                                                        allp[k:])
    return main + b"".join(out) + b"\xff\xd9"


def interleaved(cs, k=2):
    """`cs` (coded with SOP and EPH) with each tile's packets split into k
    tile-parts, written part 0 of every tile, then part 1, ..."""
    main, parts = _tile_parts(cs)
    rounds = [[] for _ in range(k)]
    for (isot, _, _), hdr, data in parts:
        pk = _packets(data)
        cut = [round(i * len(pk) / k) for i in range(k + 1)]
        for j in range(k):
            body = b"".join(s + h + b for s, h, b in pk[cut[j]:cut[j + 1]])
            h = hdr if j == 0 else b""
            rounds[j].append(_seg(0xFF90, struct.pack(
                ">HIBB", isot, 14 + len(h) + len(body), j, k)) + h +
                b"\xff\x93" + body)
    return main + b"".join(b"".join(r) for r in rounds) + b"\xff\xd9"


def as_97(cs):
    """`cs` (5/3, no quantisation) read as 9/7: its COD's transform byte
    set to 0, the steps 2^(prec - exponent)."""
    i = cs.find(b"\xff\x52")
    b = bytearray(cs)
    b[i + 13] = 0
    return bytes(b)


def _segments(cs, at, stop):
    """[(marker, body)] of the marker segments from `at` up to `stop`."""
    out = []
    while at < stop:
        m, n = struct.unpack(">HH", cs[at:at + 4])
        out.append((m, cs[at + 4:at + 2 + n]))
        at += 2 + n
    return out


def overridden(cs, where):
    """`cs` (one tile-part, fewer than 257 components) with its COD and
    QCD moved out of reach: the main header's COD and QCD replaced by
    others (one decomposition level, 64 x 64 code-blocks, other guard
    bits) and the real ones given as a COC and QCC of every component
    (where="main"), or as a COD and QCD in the tile-part header under a
    main COC and QCC of every component that carry the wrong ones
    (where="tile")."""
    sot = cs.index(b"\xff\x90")
    siz_end = 4 + struct.unpack(">H", cs[4:6])[0]
    nc, = struct.unpack(">H", cs[40:42])
    segs = _segments(cs, siz_end, sot)
    cod = next(b for m, b in segs if m == 0xFF52)
    qcd = next(b for m, b in segs if m == 0xFF5C)
    rest = [_seg(m, b) for m, b in segs if m not in (0xFF52, 0xFF5C)]
    bad_cod = bytes([cod[0] & ~1]) + cod[1:5] + bytes([1, 4, 4]) + \
        cod[8:10]
    bad_qcd = bytes([(qcd[0] & 0x1F) | 0x20]) + qcd[1:]
    per_comp = lambda m, body: b"".join(_seg(m, bytes([c]) + body)
                                        for c in range(nc))
    if where == "main":
        main = _seg(0xFF52, bad_cod) + _seg(0xFF5C, bad_qcd) + \
            per_comp(0xFF53, bytes([cod[0] & 1]) + cod[5:]) + \
            per_comp(0xFF5D, qcd)
        tile_hdr = b""
    else:
        main = _seg(0xFF52, bad_cod) + _seg(0xFF5C, bad_qcd) + \
            per_comp(0xFF53, bytes([bad_cod[0] & 1]) + bad_cod[5:]) + \
            per_comp(0xFF5D, bad_qcd)
        tile_hdr = _seg(0xFF52, cod) + _seg(0xFF5C, qcd)
    isot, psot, tpsot, tnsot = struct.unpack(">HIBB", cs[sot + 4:sot + 12])
    tail = cs[sot + 12:]
    return (cs[:siz_end] + main + b"".join(rest) +
            _seg(0xFF90, struct.pack(">HIBB", isot, psot + len(tile_hdr),
                                     tpsot, tnsot)) + tile_hdr + tail)


def derived(cs):
    """`cs` (9/7, scalar expounded) with its QCD cut to the LL band's step
    and marked scalar derived: the other bands' steps derived from it."""
    at = cs.index(b"\xff\x5c")
    n = struct.unpack(">H", cs[at + 2:at + 4])[0]
    body = bytes([(cs[at + 4] & 0xE0) | 1]) + cs[at + 5:at + 7]
    return cs[:at] + _seg(0xFF5C, body) + cs[at + 2 + n:]


def htj2k(cs):
    """`cs` marked as HTJ2K: Rsiz bit 14, a CAP segment and the HT
    code-block style bit."""
    b = bytearray(cs)
    b[6] |= 0x40
    i = b.find(b"\xff\x52")
    b[i + 12] |= 0x40
    siz_end = 4 + struct.unpack(">H", bytes(b[4:6]))[0]
    cap = _seg(0xFF50, struct.pack(">IH", 0x00020000, 0))
    return bytes(b[:siz_end]) + cap + bytes(b[siz_end:])


# ------------------------------------------------------------ the corpus

def _cases(tmp):
    """name -> file bytes: what the writer and the hand-made boxes give."""
    out = {}
    w = lambda *a, **k: encode(*a, path=os.path.join(tmp, "w.j2k"), **k)
    img = content(45, 38, 1)
    rgb, cv = [img[..., c] for c in range(3)], (0, 0, 38, 45)
    for m in (1, 2, 4, 8, 16, 32, 63):
        out[f"style{m:02d}_53.j2k"] = w(rgb, cv, mode=m, cblk=(16, 16),
                                         rates=(30, 10, 0))
        out[f"style{m:02d}_97.j2k"] = w(rgb, cv, mode=m, cblk=(16, 16),
                                         rates=(30, 10), irreversible=True)
    out["sop_eph_tlm_plt.j2k"] = w(rgb, cv, csty=6, rates=(20, 0),
                                   extra=("PLT=YES", "TLM=YES"))
    out["sop_eph_tiles.j2k"] = w(rgb, cv, csty=6, tiles=(0, 0, 16, 16),
                                 levels=3, rates=(20, 0),
                                 extra=("PLT=YES", "TLM=YES"))
    out["roi_97.j2k"] = w(rgb, cv, roi=(0, 4), rates=(20,),
                          irreversible=True)
    out["roi_53.j2k"] = w(rgb, cv, roi=(1, 3))
    out["roi_53_layers.j2k"] = w(rgb, cv, roi=(0, 5), rates=(15, 0))
    out["poc.j2k"] = w(rgb, cv, levels=3, rates=(20, 5, 0), pocs=[
        (0, 0, 3, 2, 3, 1, 1), (2, 0, 3, 4, 3, 0, 1)])
    out["poc_components.j2k"] = w(rgb, cv, levels=3, rates=(20, 0), pocs=[
        (0, 0, 2, 4, 1, 2, 1), (0, 1, 2, 4, 3, 4, 1)])
    img = content(48, 48, 2)
    for name, dx, dy, n in (("420", [1, 2, 2], [1, 2, 2], 3),
                            ("422", [1, 2, 2], [1, 1, 1], 3),
                            ("chroma1", [1, 2, 1], [1, 1, 1], 3),
                            ("first", [2, 1, 1], [2, 1, 1], 3),
                            ("all", [2, 2, 2], [2, 2, 2], 3),
                            ("420_alpha", [1, 2, 2, 1], [1, 2, 2, 1], 4)):
        planes = [img[:40:dy[c], :36:dx[c], c % 3] for c in range(n)]
        out[f"sub_{name}.j2k"] = w(planes, (0, 0, 36, 40), dx=dx, dy=dy,
                                   levels=2)
    out["sub_420_odd.j2k"] = w(
        [img[:41, :37, 0], img[:41:2, :37:2, 1], img[:41:2, :37:2, 2]],
        (0, 0, 37, 41), dx=[1, 2, 2], dy=[1, 2, 2], levels=3)
    for p, signed, n, irr in ((4, False, 1, False), (12, False, 1, False),
                              (16, False, 1, False), (5, False, 3, True),
                              (10, False, 3, True), (7, True, 1, False),
                              (12, True, 1, False), (8, True, 3, False),
                              (12, True, 3, True)):
        planes = [(content(30, 33, p)[..., c].astype(np.int64) *
                   ((1 << p) - 1) // 255) - (signed << (p - 1))
                  for c in range(n)]
        kind = ("s" if signed else "u") + str(p)
        out[f"prec_{kind}_{n}c.j2k"] = w(
            planes, (0, 0, 33, 30), prec=p, sgnd=signed, levels=3,
            irreversible=irr, rates=(8,) if irr else (0,))
    img = content(33, 31, 3)
    out["canvas_tiles_odd.j2k"] = w([img[..., c] for c in range(3)],
                                    (5, 7, 36, 40), levels=4,
                                    tiles=(3, 2, 16, 20))
    img = content(45, 38, 1)
    out["precincts_rpcl.j2k"] = w(rgb, cv, levels=4, precincts=[
        (32, 32), (16, 16), (8, 8)], cblk=(8, 8), prog=2, rates=(30, 10, 0))
    out["four_components.j2k"] = w(rgb + [img[..., 0] ^ 0x55], cv, levels=3)
    out["five_components.j2k"] = w(rgb + rgb[:2], cv, levels=3)
    # JP2 boxes around those codestreams
    img = content(40, 36, 3)
    sub = w([img[..., 0], img[::2, ::2, 1], img[::2, ::2, 2]],
            (0, 0, 36, 40), dx=[1, 2, 2], dy=[1, 2, 2], levels=3)
    full = w([img[..., c] for c in range(3)], (0, 0, 36, 40), levels=3)
    four = w([img[..., 0], img[..., 1], img[..., 2], img[..., 0] // 2],
             (0, 0, 36, 40), levels=3)
    out["jp2_sycc_420.jp2"] = jp2(sub, 18)
    out["jp2_srgb_420.jp2"] = jp2(sub, 16)
    out["jp2_grey_for_rgb.jp2"] = jp2(sub, 17)
    out["jp2_icc_420.jp2"] = jp2(sub, icc=True)
    out["jp2_icc_444.jp2"] = jp2(full, icc=True)
    out["jp2_unknown_space.jp2"] = jp2(sub, 99)
    out["jp2_sycc_444.jp2"] = jp2(full, 18)
    out["jp2_esycc.jp2"] = jp2(full, 24)
    out["jp2_cmyk.jp2"] = jp2(four, 12)
    out["jp2_rgba.jp2"] = jp2(four, 16)
    out["jp2_sycc_alpha.jp2"] = jp2(four, 18)
    out["jp2_rgb_for_four.jp2"] = jp2(four, 16, nc=3)
    out["jp2_one_for_three.jp2"] = jp2(full, 16, nc=1)
    out["jp2_ihdr_larger.jp2"] = jp2(full, 16, hw=(44, 40))
    out["jp2_ihdr_smaller.jp2"] = jp2(full, 16, hw=(30, 40))
    idx = (img[..., 0] // 16).astype(np.int64)
    pal = np.random.RandomState(4).randint(0, 256, (16, 3))
    grey = w([idx], (0, 0, 36, 40), levels=3)
    out["jp2_palette.jp2"] = jp2(grey, 16, pclr=pal)
    rep = pal.copy()
    rep[5] = rep[2]
    out["jp2_palette_repeats.jp2"] = jp2(grey, 16, pclr=rep)
    out["jp2_palette_short.jp2"] = jp2(grey, 16, pclr=pal[:10])
    out["jp2_palette_4bit.jp2"] = jp2(w([idx], (0, 0, 36, 40), levels=3,
                                        prec=4), 16, pclr=pal)
    out["jp2_palette_alpha.jp2"] = jp2(w([idx, img[..., 1]], (0, 0, 36, 40),
                                         levels=3), 16, pclr=pal)
    out["jp2_palette_grey_space.jp2"] = jp2(grey, 17, pclr=pal)
    out["jp2_one_srgb.jp2"] = jp2(w([img[..., 0]], (0, 0, 36, 40),
                                    levels=3), 16)
    # packed headers and tile-parts
    img = content(45, 38, 1)
    for tiles in (None, (0, 0, 16, 16)):
        t = "tiles" if tiles else "one"
        cs = w(rgb, cv, csty=6, tiles=tiles, levels=3, rates=(20, 5, 0),
               cblk=(16, 16))
        out[f"ppt_{t}.j2k"] = packed(cs, "ppt")
        out[f"ppm_{t}.j2k"] = packed(cs, "ppm")
    out["ppm_tiles_97.j2k"] = packed(w(rgb, cv, csty=6, tiles=(0, 0, 16, 16),
                                       levels=3, rates=(20, 5),
                                       irreversible=True), "ppm")
    for tiles in ((0, 0, 16, 16), (3, 2, 20, 24)):
        cs = w([img[:45, :38, c] for c in range(3)], (5, 7, 43, 52), csty=6,
               tiles=tiles, levels=2, rates=(20, 5, 0), cblk=(16, 16))
        out[f"tile_parts_{tiles[0]}_2.j2k"] = interleaved(cs)
        out[f"tile_parts_{tiles[0]}_3.j2k"] = interleaved(cs, 3)
    # one-sample-wide resolutions through the 9/7
    for h, wd, x0, y0 in ((2, 3, 1, 1), (3, 2, 1, 0), (2, 7, 3, 2),
                          (5, 4, 1, 1), (7, 9, 3, 1)):
        im = content(h, wd, h * 10 + wd)
        out[f"thin_97_{h}x{wd}.j2k"] = as_97(w(
            [im[..., c] for c in range(3)], (x0, y0, x0 + wd, y0 + h),
            levels=min(h, wd).bit_length() - 1))
    out["htj2k.j2k"] = htj2k(w(rgb, cv, levels=3))
    # COC / QCC over COD / QCD, a tile's COD / QCD over the main COC /
    # QCC, derived quantisation, other guard bits
    for rev in (True, False):
        k = "53" if rev else "97"
        cs = w(rgb, cv, levels=3, cblk=(16, 16), irreversible=not rev,
               rates=(0,) if rev else (20,))
        out[f"coc_qcc_{k}.j2k"] = overridden(cs, "main")
        out[f"tile_cod_qcd_{k}.j2k"] = overridden(cs, "tile")
    out["quant_derived.j2k"] = derived(w(rgb, cv, levels=4,
                                         irreversible=True, rates=(10,)))
    out["guard_bits_1.j2k"] = w(rgb, cv, levels=3, irreversible=True,
                                rates=(10,), extra=("GUARD_BITS=1",))
    out["guard_bits_5.j2k"] = w(rgb, cv, levels=3, extra=("GUARD_BITS=5",))
    return out


def _digest(arr):
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


# files Pillow refuses: what the port's refusal says
_PORT_REFUSES = {
    "five_components.j2k": "JPEG 2000 of 5 components",
    "htj2k.j2k": "We do not support more than 3 coding passes in an HT "
                 "codeblock; This codeblocks has 19 passes.",
    "jp2_esycc.jp2": "mode RGB, 3 components in colour space EYCC",
    "jp2_grey_for_rgb.jp2": "mode RGB, 3 components in colour space GRAY",
    "jp2_ihdr_larger.jp2": "the JP2 header's size is not the codestream's",
    "jp2_ihdr_smaller.jp2": "the JP2 header's size is not the codestream's",
    "jp2_one_for_three.jp2": "mode L, 3 components in colour space SRGB",
    "jp2_one_srgb.jp2": "mode L, 1 components in colour space SRGB",
    "jp2_palette_grey_space.jp2": "mode P, 1 components in colour space "
                                  "GRAY"}


def expected_now(d):
    """Each file's Pillow format, mode, size and JAX pixel digest, or what
    refuses it."""
    out = {}
    for n in sorted(os.listdir(d)):
        if n == "expected.json":
            continue
        p = os.path.join(d, n)
        e = {}
        try:
            with Image.open(p) as im:
                e.update(format=im.format, mode=im.mode,
                         size=list(im.size[::-1]))
            e["sha256"] = _digest(jimages.load_image_uint8(p))
        except (OSError, SyntaxError, ValueError) as err:
            e["pillow_refuses"] = type(err).__name__
            e["port"] = _PORT_REFUSES.get(n)
        out[n] = e
    return out


def _expected():
    with open(os.path.join(CODING, "expected.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(
    n for n in (os.listdir(CODING) if os.path.isdir(CODING) else ())
    if n != "expected.json"))
def test_coding_fixture_equals_pillow_and_jax(name):
    p = os.path.join(CODING, name)
    e = _expected()["files"][name]
    if "refused" in e:
        with pytest.raises(ValueError, match=f"{e['refused']} is not decoded "
                           "by the port yet"):
            timages.load_image_uint8(p)
    elif "pillow_refuses" in e:
        with pytest.raises(Exception):
            jimages.load_image_uint8(p)
        with pytest.raises(ValueError) as err:
            timages.load_image_uint8(p)
        assert e["port"] in str(err.value)
    else:
        check(p)
        assert _digest(timages.load_image_uint8(p)) == e["sha256"]


def test_coding_expected_json_equals_pillow_and_jax_now():
    assert expected_now(CODING) == _expected()["files"]
    assert sum(os.path.getsize(os.path.join(CODING, n))
               for n in os.listdir(CODING)) < 400_000


needs_lib = pytest.mark.skipif(libopenjp2() is None,
                               reason="Pillow ships no libopenjp2 here")


def _markers(cs):
    """{marker: [bodies]} of the main header and the first tile-part's."""
    out, at = {}, 2
    while at + 4 <= len(cs):
        m, n = struct.unpack(">HH", cs[at:at + 4])
        if m == 0xFF93:
            break
        out.setdefault(m, []).append(cs[at + 4:at + 2 + n])
        at += 2 + n
    return out


@needs_lib
def test_writer_sets_what_it_is_asked(tmp_path):
    """The probed offsets reach the fields: the style byte, SOP / EPH,
    precincts, the RGN, POC, TLM and PLT segments, sub-sampling,
    precision, signedness and the tile grid in the codestream."""
    img = content(40, 36, 5)
    p = str(tmp_path / "x.j2k")
    cs = encode([img[..., 0], img[::2, ::2, 1]], (2, 4, 38, 44), path=p,
                dx=[1, 2], dy=[1, 2], prec=[7, 8], sgnd=[False, True],
                levels=3, cblk=(16, 8), mode=0x2D, csty=6,
                precincts=[(32, 32), (16, 16)], roi=(1, 3),
                tiles=(1, 2, 32, 24), rates=(20, 0), prog=3,
                pocs=[(0, 0, 2, 4, 2, 3, 1)],
                extra=("TLM=YES", "PLT=YES"))
    mk = _markers(cs)
    cod = mk[0xFF52][0]
    assert cod[0] == 7 and cod[1] == 3 and cod[5] == 3      # Scod, PCRL
    assert (cod[6], cod[7], cod[8]) == (2, 1, 0x2D)          # 16 x 8, style
    assert cod[10:14] == bytes([0x22, 0x33, 0x44, 0x55])     # precincts
    assert mk[0xFF5E][0] == bytes([1, 0, 3])                 # RGN
    assert 0xFF5F in mk and 0xFF55 in mk and 0xFF58 in mk    # POC TLM PLT
    siz = mk[0xFF51][0]
    assert struct.unpack(">IIIIIIII", siz[2:34]) == (38, 44, 2, 4, 32, 24,
                                                     1, 2)
    assert siz[36:42] == bytes([6, 1, 1, 0x87, 2, 2])


if __name__ == "__main__":
    import tempfile
    os.makedirs(CODING, exist_ok=True)
    for n in os.listdir(CODING):
        os.remove(os.path.join(CODING, n))
    with tempfile.TemporaryDirectory() as tmp:
        for n, blob in _cases(tmp).items():
            with open(os.path.join(CODING, n), "wb") as f:
                f.write(blob)
    exp = {"files": expected_now(CODING),
           "made_by": {"pillow": PIL.__version__,
                       "openjpeg": PIL.features.version("jpg_2000")}}
    with open(os.path.join(CODING, "expected.json"), "w") as f:
        json.dump(exp, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {len(exp['files'])} files and expected.json to {CODING}")
