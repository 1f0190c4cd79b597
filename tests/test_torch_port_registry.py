"""The port's readers of the rest of Pillow's registry (data/registry.py)
and IM's remaining variants (data/rasters.py) against Pillow, which the
JAX package's load_image_uint8 reads them through.

- files Pillow writes: XBM, BLP (BLP1 and BLP2 palettes, with alpha),
  SPIDER, IM (YCbCr, and the types below);
- files test-only writers make: X10 XBM, XPM (1 and 2 characters a
  pixel, "None", a "/* pixels */" line, more than 256 colours), FITS
  (BITPIX 8, 16, 32, -32, -64, one axis, an image extension after an
  empty primary, the GZIP_1 tile-compressed table), BLP2 DXT1 / DXT3 /
  DXT5 at odd sizes and BLP1 JPEG, big-endian SPIDER and a stack, PCD in
  each orientation, GBR v1 / v2, FLI / FLC (COLOR, COLOR256, BRUN, LC,
  SS2, BLACK, COPY), FTEX (FTU, FTC), PIXAR, MCIDAS (8, 16, 32 bits),
  IMT, IPTC (raw grey and raw bands of RGB / CMYK) and XVThumb;
every pixel equal to Pillow's convert("RGB") and to the JAX loader, and
format, mode and size from the header equal to Pillow's; truncated and
malformed files refused by both. `python tests/test_torch_port_registry.py`
(PYTHONPATH=.) rewrites l3c_torch/data/fixtures/registry/.
"""
import gzip
import io
import os
import struct
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from l3c_tpu.data import images as jimages
from l3c_torch.data import images as timages

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_gif import check  # noqa: E402

torch.set_num_threads(1)


def _write(tmp_path, name, blob):
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(blob)
    return p


def _img(h, w, seed):
    r = np.random.RandomState(seed)
    return (np.cumsum(r.randint(0, 12, (h, w, 3)), 1) % 256).astype(np.uint8)


def refused_by_both(p):
    """The port raises ValueError; Pillow's open, load or convert and the
    JAX loader raise too."""
    with pytest.raises(ValueError):
        timages.load_image_uint8(p)
    with pytest.raises(Exception):
        jimages.load_image_uint8(p)


# ---------------------------------------------------------------- writers

def xbm_x10(bits: np.ndarray) -> bytes:
    """An X10 bitmap: 16-bit words, of which Pillow reads the high byte."""
    h, w = bits.shape
    rows = np.packbits(bits, axis=1, bitorder="little")
    words = ", ".join(f"0x{b:02x}{(i * 37) & 255:02x}"
                      for i, b in enumerate(rows.ravel()))
    return (f"#define x10_width {w}\n#define x10_height {h}\n"
            f"static short x10_bits[] = {{\n   {words}}};\n").encode()


def xpm(idx: np.ndarray, colours, cpp=1, pixels_line=False, none=None):
    keys = [bytes(chr(33 + (k // 90)) + chr(35 + k % 90), "ascii")[-cpp:]
            if cpp == 2 else bytes([35 + k]) for k in range(len(colours))]
    h, w = idx.shape
    out = [b"/* XPM */", b"static char *x[] = {",
           b'"%d %d %d %d",' % (w, h, len(colours), cpp)]
    for k, c in zip(keys, colours):
        col = b"None" if none == k else b"#%02x%02x%02x" % tuple(c)
        out.append(b'"' + k + b" c " + col + b'",')
    if pixels_line:
        out.append(b"/* pixels */")
    for row in idx:
        out.append(b'"' + b"".join(keys[i] for i in row) + b'",')
    out.append(b"};")
    return b"\n".join(out) + b"\n"


def _card(k, v=None):
    s = k.ljust(8) + ("" if v is None else "= " + str(v).rjust(20))
    return s.ljust(80).encode()


def fits(data: np.ndarray, bitpix: int, extra=(), ext=False) -> bytes:
    """A FITS file of `data` (rows bottom first, as FITS stores them),
    big-endian as the standard says (Pillow reads it little-endian)."""
    dt = {8: ">u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}[bitpix]
    h, w = data.shape

    def header(cards):
        b = b"".join(cards) + _card("END")
        return b.ljust(-(-len(b) // 2880) * 2880, b" ")

    dims = [_card("NAXIS", 2), _card("NAXIS1", w), _card("NAXIS2", h)] \
        if h > 1 else [_card("NAXIS", 1), _card("NAXIS1", w)]
    body = data.astype(dt).tobytes()
    body = body.ljust(-(-len(body) // 2880) * 2880, b"\0")
    if ext:
        prim = header([_card("SIMPLE", "T"), _card("BITPIX", 8),
                       _card("NAXIS", 0)])
        return prim + header([_card("XTENSION", "'IMAGE   '"),
                              _card("BITPIX", bitpix)] + dims
                             + [_card(k, v) for k, v in extra]) + body
    return header([_card("SIMPLE", "T"), _card("BITPIX", bitpix)] + dims
                  + [_card(k, v) for k, v in extra]) + body


def fits_gzip(data: np.ndarray, zbitpix: int) -> bytes:
    """A tile-compressed FITS extension (GZIP_1) of 4-byte big-endian
    values, as Pillow's FitsGzipDecoder reads it."""
    h, w = data.shape

    def header(cards):
        b = b"".join(cards) + _card("END")
        return b.ljust(-(-len(b) // 2880) * 2880, b" ")

    prim = header([_card("SIMPLE", "T"), _card("BITPIX", 8),
                   _card("NAXIS", 0)])
    table = struct.pack(">ii", 0, 0)
    heap = gzip.compress(data.astype(">i4").tobytes(), mtime=0)
    ext = header([_card("XTENSION", "'BINTABLE'"), _card("BITPIX", 8),
                  _card("NAXIS", 2), _card("NAXIS1", 8), _card("NAXIS2", 1),
                  _card("ZIMAGE", "T"), _card("ZCMPTYPE", "'GZIP_1  '"),
                  _card("ZBITPIX", zbitpix), _card("ZNAXIS", 2),
                  _card("ZNAXIS1", w), _card("ZNAXIS2", h)])
    return prim + ext + table + heap


def _dxt1_block(r):
    return struct.pack("<HHI", *r.randint(0, 65536, 2), r.randint(0, 2**32))


def blp2(w, h, enc, alpha, aenc, payload, palette=None):
    head = b"BLP2" + struct.pack("<i", 1) + struct.pack(
        "<bbbb", enc, alpha, aenc, 0) + struct.pack("<II", w, h)
    pal = palette if palette is not None else bytes(1024)
    off = 20 + 128 + len(pal)
    return head + struct.pack("<16I", off, *([0] * 15)) + struct.pack(
        "<16I", len(payload), *([0] * 15)) + pal + payload


def blp1_jpeg(jpg: bytes, w, h, split=200):
    head = b"BLP1" + struct.pack("<iI", 0, 0) + struct.pack("<II", w, h) + \
        struct.pack("<ii", 5, 0)
    jh, body = jpg[:split], jpg[split:]
    off = 28 + 128 + 4 + len(jh) + 6
    return head + struct.pack("<16I", off, *([0] * 15)) + struct.pack(
        "<16I", len(body), *([0] * 15)) + struct.pack("<I", len(jh)) + \
        jh + b"PADPAD" + body


def spider(v: np.ndarray, order="<", stack=False) -> bytes:
    h, w = v.shape
    lenbyt = w * 4
    labrec = -(-1024 // lenbyt)
    labbyt = labrec * lenbyt
    hdr = [0.0] * (labbyt // 4)
    hdr[0], hdr[1], hdr[2], hdr[4] = 1.0, float(h), float(h), 1.0
    hdr[11], hdr[12], hdr[21], hdr[22] = float(w), float(labrec), \
        float(labbyt), float(lenbyt)
    if stack:
        hdr[23], hdr[25] = 2.0, 2.0
    head = struct.pack(order + f"{len(hdr)}f", *hdr)
    img = v.astype(order + "f4").tobytes()
    if stack:
        return head + head + img + head + img[::-1]
    return head + img


def pcd(seed, orientation) -> bytes:
    r = np.random.RandomState(seed)
    head = bytearray(96 * 2048)
    head[2048:2052] = b"PCD_"
    head[2048 + 1538] = orientation
    return bytes(head) + r.randint(0, 256, 256 * 3 * 768).astype(
        np.uint8).tobytes()


def gbr(px: np.ndarray, version=2, comment=b"brush\0") -> bytes:
    h, w, d = px.shape
    size = (28 if version == 2 else 20) + len(comment)
    head = struct.pack(">5I", size, version, w, h, d)
    if version == 2:
        head += b"GIMP" + struct.pack(">I", 10)
    return head + comment + px.tobytes()


def fli(w, h, chunks, magic=0xAF12, frames=1) -> bytes:
    """An FLI / FLC file of one frame of the given (type, payload)
    chunks."""
    head = bytearray(128)
    struct.pack_into("<IHHHHHH", head, 0, 0, magic, frames, w, h, 8, 3)
    body = b""
    for kind, payload in chunks:
        if len(payload) % 2:
            payload += b"\0"
        body += struct.pack("<IH", 6 + len(payload), kind) + payload
    frame = struct.pack("<IHH", 16 + len(body), 0xF1FA, len(chunks)) + \
        bytes(8) + body
    struct.pack_into("<I", head, 0, 128 + len(frame))
    return bytes(head) + frame


def fli_colour(pal: np.ndarray, six=False) -> bytes:
    v = (pal >> 2) if six else pal
    return struct.pack("<HBB", 1, 0, 0) + v.astype(np.uint8).tobytes()


def fli_brun(idx: np.ndarray) -> bytes:
    out = b""
    for row in idx:
        out += b"\0"
        x = 0
        while x < len(row):
            n = 1
            while x + n < len(row) and row[x + n] == row[x] and n < 127:
                n += 1
            if n > 1:
                out += bytes([n, row[x]])
                x += n
            else:
                lit = row[x:x + min(4, len(row) - x)]
                out += bytes([256 - len(lit)]) + lit.tobytes()
                x += len(lit)
    return out


def fli_lc(idx: np.ndarray, y0: int) -> bytes:
    out = struct.pack("<HH", y0, len(idx))
    for row in idx:
        out += bytes([2, 1, 3]) + row[1:4].tobytes() + bytes([1, 256 - 2,
                                                              row[5]])
    return out


def fli_ss2(idx: np.ndarray) -> bytes:
    out = struct.pack("<H", len(idx))
    for k, row in enumerate(idx):
        if k == 1:              # skip a line, then the line itself
            out += struct.pack("<H", 0xFFFF)
        out += struct.pack("<H", 2) + bytes([0, 2]) + row[:4].tobytes() + \
            bytes([2, 256 - 1]) + row[6:8].tobytes()
    return out


def ftex(w, h, fmt, data) -> bytes:
    return b"FTEX" + struct.pack("<i2i2i2i", 0, w, h, 1, 1, fmt, 32) + \
        struct.pack("<i", len(data)) + data


def pixar(img: np.ndarray) -> bytes:
    h, w, _ = img.shape
    head = bytearray(1024)
    head[:4] = b"\x80\xe8\0\0"
    struct.pack_into("<HH", head, 416, h, w)
    struct.pack_into("<HH", head, 424, 14, 2)
    return bytes(head) + img.tobytes()


def mcidas(v: np.ndarray, nbytes: int, prefix=0) -> bytes:
    h, w = v.shape
    words = [0] * 64
    words[1] = 4
    words[8], words[9], words[10], words[13] = h, w, nbytes, 1
    words[14] = prefix
    words[33] = 256
    head = struct.pack("!64i", *words)
    head = b"\0\0\0\0" + head[4:]
    dt = {1: ">u1", 2: ">u2", 4: ">i4"}[nbytes]
    rows = b"".join(bytes(prefix) + row.astype(dt).tobytes() for row in v)
    return head[:8].replace(head[:8], b"\0" * 7 + b"\x04") + head[8:] + \
        bytes(prefix) + rows


def imt(v: np.ndarray) -> bytes:
    h, w = v.shape
    return (b"* IM tools image\nwidth %d\nheight %d\npixel n8\n\x0c" % (w, h)
            + v.tobytes())


def iptc(v: np.ndarray, layers=1, component=0, band=None) -> bytes:
    h, w = v.shape

    def field(rec, ds, data):
        return bytes([0x1C, rec, ds]) + struct.pack(">H", len(data)) + data

    out = field(3, 60, bytes([layers, component]))
    if band is not None:
        out += field(3, 65, bytes([band]))
    out += field(3, 20, struct.pack(">H", w)) + field(3, 30, struct.pack(
        ">H", h)) + field(3, 120, bytes([1]))
    data = v.tobytes()
    for k in range(0, len(data), 100):
        out += field(8, 10, data[k:k + 100])
    return out + bytes(5)


def xvthumb(v: np.ndarray) -> bytes:
    h, w = v.shape
    return b"P7 332\n#XVVERSION:Version 2.28\n#END_OF_COMMENTS\n%d %d 255\n" \
        % (w, h) + v.tobytes()


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("hw", [(7, 9), (16, 16), (1, 30)])
def test_xbm_equals_pillow(tmp_path, hw):
    h, w = hw
    bits = np.random.RandomState(h * w).rand(h, w) > 0.5
    p = str(tmp_path / "x.xbm")
    Image.fromarray(bits).save(p, "XBM", hotspot=(1, 2))
    check(p)
    check(_write(tmp_path, "x10.xbm", xbm_x10(bits)))


def test_xbm_truncated_is_refused_by_both(tmp_path):
    bits = np.random.RandomState(0).rand(9, 17) > 0.5
    f = io.BytesIO()
    Image.fromarray(bits).save(f, "XBM")
    refused_by_both(_write(tmp_path, "t.xbm", f.getvalue()[:-30]))


@pytest.mark.parametrize("cpp, n, pixels_line", [(1, 5, False),
                                                  (2, 40, True),
                                                  (2, 300, False)])
def test_xpm_equals_pillow(tmp_path, cpp, n, pixels_line):
    r = np.random.RandomState(n)
    colours = r.randint(0, 256, (n, 3))
    idx = r.randint(0, n, (6, 11))
    check(_write(tmp_path, "x.xpm", xpm(idx, colours, cpp, pixels_line)))


def test_xpm_none_and_colour_names(tmp_path):
    r = np.random.RandomState(3)
    colours = r.randint(0, 256, (4, 3))
    idx = r.randint(1, 4, (5, 7))
    # a transparent colour no pixel uses: read; one a pixel uses: refused
    check(_write(tmp_path, "a.xpm", xpm(idx, colours, none=b"#")))
    idx[2, 3] = 0
    refused_by_both(_write(tmp_path, "b.xpm", xpm(idx, colours,
                                                  none=b"#")))
    blob = xpm(idx, colours).replace(b"c #", b"c red #", 1)
    refused_by_both(_write(tmp_path, "c.xpm", blob))


@pytest.mark.parametrize("bitpix", [8, 16, 32, -32, -64])
@pytest.mark.parametrize("ext", [False, True])
def test_fits_equals_pillow(tmp_path, bitpix, ext):
    r = np.random.RandomState(abs(bitpix))
    v = r.randint(0, 250, (9, 13)) if bitpix > 0 else r.rand(9, 13) * 300
    check(_write(tmp_path, "x.fits", fits(v, bitpix, ext=ext,
                                          extra=[("BZERO", 32768),
                                                 ("BSCALE", 1)])))


def test_fits_one_axis_gzip_and_refusals(tmp_path):
    r = np.random.RandomState(4)
    check(_write(tmp_path, "a.fits", fits(r.randint(0, 255, (1, 17)), 8)))
    for zb in (8, 16, 32):
        check(_write(tmp_path, f"g{zb}.fits", fits_gzip(
            r.randint(0, 40000, (5, 6)), zb)))
    refused_by_both(_write(tmp_path, "g.fits", fits_gzip(
        r.randint(0, 255, (5, 6)), -32)))
    blob = fits(r.randint(0, 255, (9, 13)), 8)
    refused_by_both(_write(tmp_path, "t.fits", blob[:2880 + 40]))
    refused_by_both(_write(tmp_path, "h.fits", blob[:2880]))


@pytest.mark.parametrize("version", ["BLP1", "BLP2"])
@pytest.mark.parametrize("alpha", [False, True])
def test_blp_palette_equals_pillow(tmp_path, version, alpha):
    img = _img(13, 21, 5)
    im = Image.fromarray(img).quantize(40)
    if alpha:
        pal = im.getpalette()[:120]
        im.putpalette(sum(([*pal[3 * i:3 * i + 3], 50 + i]
                           for i in range(40)), []), "RGBA")
    p = str(tmp_path / "x.blp")
    im.save(p, "BLP", blp_version=version)
    check(p)


@pytest.mark.parametrize("aenc, alpha", [(0, 0), (0, 1), (1, 1), (7, 1),
                                         (7, 0), (1, 0)])
@pytest.mark.parametrize("hw", [(8, 12), (9, 13), (4, 5)])
def test_blp2_dxt_equals_pillow(tmp_path, aenc, alpha, hw):
    h, w = hw
    r = np.random.RandomState(aenc * 7 + alpha + h)
    n = ((w + 3) // 4) * ((h + 3) // 4)
    size = 8 if aenc == 0 else 16
    data = b"".join((r.randint(0, 256, 8).astype(np.uint8).tobytes()
                     if size == 16 else b"") + _dxt1_block(r)
                    for _ in range(n))
    p = _write(tmp_path, "x.blp", blp2(w, h, 2, alpha, aenc, data))
    check(p)
    refused_by_both(_write(tmp_path, "t.blp", blp2(w, h, 2, alpha, aenc,
                                                   data[:-3])))


def test_blp1_jpeg_and_refusals(tmp_path):
    img = _img(16, 24, 6)
    f = io.BytesIO()
    Image.fromarray(img).save(f, "JPEG", quality=90)
    check(_write(tmp_path, "j.blp", blp1_jpeg(f.getvalue(), 24, 16)))
    refused_by_both(_write(tmp_path, "e.blp", blp2(4, 4, 3, 0, 0, bytes(64))))
    refused_by_both(_write(tmp_path, "a.blp", blp2(4, 4, 2, 1, 3, bytes(64))))


@pytest.mark.parametrize("order, stack", [("<", False), (">", False),
                                          (">", True)])
def test_spider_equals_pillow(tmp_path, order, stack):
    v = np.random.RandomState(1).rand(11, 19) * 300 - 20
    check(_write(tmp_path, "x.spi", spider(v, order, stack)))


def test_spider_saved_by_pillow_and_truncated(tmp_path):
    p = str(tmp_path / "x.spi")
    Image.fromarray(np.random.RandomState(2).rand(7, 300).astype(
        np.float32) * 255).save(p, "SPIDER")
    check(p)
    refused_by_both(_write(tmp_path, "t.spi", open(p, "rb").read()[:-50]))


@pytest.mark.parametrize("orientation", [0, 1, 3])
def test_pcd_equals_pillow(tmp_path, orientation):
    check(_write(tmp_path, "x.pcd", pcd(orientation, orientation)))


def test_pcd_truncated_is_refused_by_both(tmp_path):
    refused_by_both(_write(tmp_path, "t.pcd", pcd(9, 0)[:-1000]))


def test_pcd_tables_equal_pillows_unpacker():
    """Every PhotoYCC triple through the port's tables against Pillow's
    YCC;P unpacker (a sixteenth of the cube, every luma)."""
    from l3c_torch.data import registry
    a = np.arange(256)
    y = np.repeat(a, 1024)
    cb = np.tile(np.repeat(a[::16], 64), 256)
    cr = np.tile(a[::4], 16 * 256)
    raw = np.stack([y, cb, cr], -1).astype(np.uint8).tobytes()
    want = np.asarray(Image.frombytes("RGB", (len(y), 1), raw, "raw",
                                      "YCC;P"))[0]
    np.testing.assert_array_equal(registry.pcd_ycc_to_rgb(y, cb, cr), want)


@pytest.mark.parametrize("version, depth", [(1, 1), (2, 1), (2, 4)])
def test_gbr_equals_pillow(tmp_path, version, depth):
    r = np.random.RandomState(depth)
    px = r.randint(0, 256, (6, 9, depth)).astype(np.uint8)
    check(_write(tmp_path, "x.gbr", gbr(px, version)))
    refused_by_both(_write(tmp_path, "t.gbr", gbr(px, version)[:-5]))


@pytest.mark.parametrize("kind", ["brun", "copy", "lc", "ss2", "black"])
@pytest.mark.parametrize("six", [False, True])
def test_fli_first_frame_equals_pillow(tmp_path, kind, six):
    r = np.random.RandomState(len(kind))
    w, h = 14, 6
    pal = r.randint(0, 256, (256, 3))
    idx = r.randint(0, 6, (h, w)).astype(np.uint8)
    body = {"brun": (15, fli_brun(idx)), "copy": (16, idx.tobytes()),
            "lc": (12, fli_lc(idx[1:4], 1)), "ss2": (7, fli_ss2(idx[:3])),
            "black": (13, bytes(4))}[kind]
    chunks = [(11 if six else 4, fli_colour(pal, six)), body]
    check(_write(tmp_path, "x.fli", fli(w, h, chunks,
                                        0xAF11 if six else 0xAF12)))


def test_fli_unknown_chunk_and_truncated_refused_by_both(tmp_path):
    idx = np.zeros((4, 8), np.uint8)
    refused_by_both(_write(tmp_path, "u.fli", fli(8, 4, [(99, b"abcd")])))
    blob = fli(8, 4, [(16, idx.tobytes())])
    refused_by_both(_write(tmp_path, "t.fli", blob[:-10]))


@pytest.mark.parametrize("fmt, hw", [(1, (5, 7)), (0, (8, 8)), (0, (6, 9))])
def test_ftex_equals_pillow(tmp_path, fmt, hw):
    h, w = hw
    r = np.random.RandomState(fmt + h)
    if fmt == 1:
        data = _img(h, w, 3).tobytes()
    else:
        data = b"".join(_dxt1_block(r) for _ in range(
            ((w + 3) // 4) * ((h + 3) // 4)))
    check(_write(tmp_path, "x.ftc", ftex(w, h, fmt, data)))


def test_pixar_mcidas_imt_xvthumb_equal_pillow(tmp_path):
    check(_write(tmp_path, "x.pxr", pixar(_img(7, 10, 8))))
    r = np.random.RandomState(9)
    for nb, top in ((1, 256), (2, 600), (4, 400)):
        v = r.randint(0, top, (5, 8))
        check(_write(tmp_path, f"m{nb}.area", mcidas(v, nb)))
    check(_write(tmp_path, "m.area", mcidas(r.randint(0, 256, (5, 8)), 1,
                                            prefix=4)))
    check(_write(tmp_path, "x.imt", imt(r.randint(0, 256, (6, 9)).astype(
        np.uint8))))
    check(_write(tmp_path, "x.xv", xvthumb(r.randint(0, 256, (6, 9)).astype(
        np.uint8))))
    refused_by_both(_write(tmp_path, "t.xv", xvthumb(np.zeros((6, 9),
                                                              np.uint8))[:-4]))


@pytest.mark.parametrize("layers, component, band", [(1, 0, None),
                                                     (3, 1, 2), (4, 1, 1),
                                                     (3, 1, None)])
def test_iptc_equals_pillow(tmp_path, layers, component, band):
    v = np.random.RandomState(layers).randint(0, 256, (7, 30)).astype(
        np.uint8)
    check(_write(tmp_path, "x.iim", iptc(v, layers, component, band)))


def test_im_variants_equal_pillow(tmp_path):
    """IM's YCbCr (Pillow writes it), its 8- and 16-bit float types and
    the Luts applied to grey and RGB values."""
    img = _img(9, 12, 11)
    p = str(tmp_path / "y.im")
    Image.fromarray(img).convert("YCbCr").save(p, "IM")
    check(p)
    r = np.random.RandomState(12)
    for kind, data in (("L 8 image", r.randint(0, 256, (9, 12)).astype(
            np.uint8).tobytes()), ("L*16 image", r.randint(
                0, 600, (9, 12)).astype("<u2").tobytes()),
            ("L 16 image", r.randint(0, 600, (9, 12)).astype(
                "<u2").tobytes())):
        check(_write(tmp_path, "f.im", _im_file(kind, 12, 9, data)))
    grey_lut = np.tile((255 - np.arange(256)).astype(np.uint8), 3)
    v = r.randint(0, 256, (9, 12)).astype(np.uint8)
    check(_write(tmp_path, "l.im", _im_file("Greyscale image", 12, 9,
                                            v.tobytes(), lut=grey_lut)))
    rgb_lut = np.concatenate([np.arange(256)[::-1], np.arange(256) // 2,
                              np.full(256, 7)]).astype(np.uint8)
    planes = r.randint(0, 256, (9, 3, 12)).astype(np.uint8)
    check(_write(tmp_path, "c.im", _im_file("RGB image", 12, 9,
                                            planes.tobytes(), lut=rgb_lut)))


@pytest.mark.parametrize("kind, w, h, nbytes", [
    ("B2 image", 9, 4, 12), ("B4 image", 9, 4, 20), ("RGB3 image", 7, 5, 105),
    ("RYB3 image", 7, 5, 105), ("L*2 image", 9, 3, 9),
    ("L*4 image", 7, 3, 20), ("L*12 image", 5, 3, 40),
    ("L*5 image", 9, 3, 30), ("L*24 image", 3, 2, 40),
    ("L*30 image", 3, 2, 40)])
def test_im_packed_planar_and_bit_types_equal_pillow(tmp_path, kind, w, h,
                                                     nbytes):
    """B2 / B4 (P;2, P;4: black without a colour Lut, a byte a pixel with
    one), RGB3 / RYB3 (planes G, R, B) and the L*n types Pillow's bit
    decoder reads (LSB first, the count reset each row)."""
    r = np.random.RandomState(nbytes)
    data = r.randint(0, 256, max(nbytes, w * h)).astype(np.uint8).tobytes()
    check(_write(tmp_path, "a.im", _im_file(kind, w, h, data[:nbytes])))
    lut = r.randint(0, 256, 768).astype(np.uint8)
    check(_write(tmp_path, "b.im", _im_file(kind, w, h, data, lut=lut)))


def test_im_types_pillow_refuses(tmp_path):
    for kind in ("RLB image", "RYB image"):
        refused_by_both(_write(tmp_path, "r.im", _im_file(kind, 4, 4,
                                                          bytes(48))))


@pytest.mark.parametrize("mode", ["CMYK", "L"])
def test_blp1_jpeg_of_other_modes(tmp_path, mode):
    img = _img(16, 24, 7)
    f = io.BytesIO()
    Image.fromarray(img).convert(mode).save(f, "JPEG", quality=90)
    check(_write(tmp_path, "j.blp", blp1_jpeg(f.getvalue(), 24, 16)))


def _im_file(kind, w, h, data, lut=None):
    head = (f"Image type: {kind}\r\nImage size (x*y): {w}*{h}\r\n"
            + ("Lut: RGB\r\n" if lut is not None else "")).encode()
    head = head.ljust(510, b"\0") + b"\x1a\0"
    return head + (lut.tobytes() if lut is not None else b"") + data


# ------------------------------------------------------------- fixtures
#
# l3c_torch/data/fixtures/registry: what chip_smoke.py's phase
# registry_formats holds on the card machine, and expected.json with
# Pillow's format, mode, size and pixel digest of each file (or that it
# refuses it, or the port's refusal by name), the JAX listing and the
# library versions. `python tests/test_torch_port_registry.py` (from the
# repo root, PYTHONPATH=.) rewrites them.

import hashlib  # noqa: E402
import json  # noqa: E402
import zlib  # noqa: E402

import PIL  # noqa: E402
import PIL.features  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "l3c_torch", "data", "fixtures", "registry")
LISTING_MIN_SIZE = 60
# coded by chip_smoke's cli.l3c; timed for the rates
CODED = ("c_g4_page.tif", "b_fits_as.jpg")
RATES = ("r_g4_fax_page.tif", "r_zstd_rgb.tif")


def smooth(h, w, seed):
    """A smooth RGB picture with a little noise (it compresses as a
    photo's sky does)."""
    r = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w] / np.float32(max(h, w))
    out = []
    for _ in range(3):
        f = r.uniform(1, 5, 4)
        v = 127 + 60 * np.sin(f[0] * 6 * x + f[1]) * np.cos(f[2] * 6 * y
                                                            + f[3])
        v += 40 * ((x - r.rand()) ** 2 + (y - r.rand()) ** 2
                   < r.uniform(0.02, 0.08))
        out.append(v + r.randint(0, 2, (h, w)))
    return np.clip(np.stack(out, -1), 0, 255).astype(np.uint8)


def _saved(im, fmt, **kw):
    f = io.BytesIO()
    im.save(f, fmt, **kw)
    return f.getvalue()


def make_registry_fixtures(d):
    """One small file of each format and variant, the two files the
    listing keeps (an XPM named .png, a FITS named .jpg), the Group 4
    page chip_smoke codes and the two rate files."""
    from test_torch_port_ccitt import page
    from test_torch_port_tiff_codecs import (lzw_compat_encode,
                                             thunder_rows, ycc_blocks)
    from test_torch_port_tiff import make_tiff
    os.makedirs(d, exist_ok=True)
    r = np.random.RandomState(18)
    files = {}
    idx = (np.add.outer(np.arange(72) // 9, np.arange(96) // 12) % 12)
    files["a_xpm_as.png"] = xpm(idx, r.randint(0, 256, (12, 3)), cpp=2,
                                pixels_line=True)
    v = (np.add.outer(np.arange(64), np.arange(80)) * 1.6).astype(int)
    files["b_fits_as.jpg"] = fits(v[::-1] % 256, 8)
    files["c_g4_page.tif"] = _saved(Image.fromarray(page(432, 576, 2)),
                                    "TIFF", compression="group4")
    files["r_g4_fax_page.tif"] = _saved(Image.fromarray(
        page(2200, 1728, 1)), "TIFF", compression="group4")
    files["r_zstd_rgb.tif"] = _saved(Image.fromarray(smooth(256, 384, 1)),
                                     "TIFF", compression="zstd",
                                     tiffinfo={317: 2})
    bits = page(20, 37, 3, "noise")
    for name, comp, info in (("d_g3_1d.tif", "group3", {}),
                             ("d_g3_2d_fill.tif", "group3", {292: 5}),
                             ("d_mh_fill2.tif", "tiff_ccitt", {266: 2}),
                             ("d_g4_white0.tif", "group4", {262: 0})):
        files[name] = _saved(Image.fromarray(bits), "TIFF",
                             compression=comp, tiffinfo=info)
    img = _img(24, 32, 4)
    files["e_lzma.tif"] = _saved(Image.fromarray(img), "TIFF",
                                 compression="lzma")
    files["e_zstd_f_pred3.tif"] = _saved(Image.fromarray(
        img[..., 0].astype(np.float32) * 1.1 - 9), "TIFF",
        compression="zstd", tiffinfo={317: 3})
    files["e_lzw_old_style.tif"] = make_tiff(
        img, photo=2, bits=8, comp=5,
        jpeg_chunks=[lzw_compat_encode(img.tobytes())])
    files["e_thunderscan.tif"] = make_tiff(
        np.zeros((9, 23, 1), np.uint8), photo=1, bits=4, comp=32809,
        jpeg_chunks=[thunder_rows(r, 9, 23)])
    files["e_ycbcr_22_deflate.tif"] = make_tiff(
        np.zeros((13, 17, 3), np.uint8), photo=6, bits=8, comp=8,
        jpeg_chunks=[zlib.compress(ycc_blocks(img[:13, :17], 2, 2))],
        ycbcr=(2, 2))
    twelve = r.randint(0, 4096, (6, 9))
    from test_torch_port_tiff_codecs import _pack12
    files["e_grey12.tif"] = make_tiff(
        np.zeros((6, 9, 1), np.uint8), photo=1, bits=12,
        jpeg_chunks=[_pack12(twelve)])
    from test_torch_port_tiff_codecs import (_jpeg, _mh_row,
                                             ojpeg_interchange, ojpeg_tables)
    files["e_ojpeg_jif.tif"] = ojpeg_interchange(img, _jpeg(img))
    files["e_ojpeg_tables.tif"] = ojpeg_tables(img, _jpeg(img, "4:2:2"),
                                               (2, 1))
    files.update(ojpeg_corner_files())
    rlew = bytearray()
    for row in bits[:8]:
        rlew += _mh_row(row)
        rlew += bytes(len(rlew) % 2)
    files["e_ccitt_rlew.tif"] = make_tiff(
        np.zeros((8, 37, 1), np.uint8), photo=0, bits=1, comp=32771,
        jpeg_chunks=[bytes(rlew)])
    files["e_ycbcr_planar_raw.tif"] = make_tiff(img, photo=6, bits=8,
                                                planar=2, ycbcr=(1, 1))
    from test_torch_port_tiff_codecs import write_jpeg12_tiff
    tmp = os.path.join(d, "_j12.tif")
    write_jpeg12_tiff(tmp, np.cumsum(r.randint(0, 20, (24, 32)), 1) % 400,
                      90, 16)
    with open(tmp, "rb") as f:
        files["e_jpeg12.tif"] = f.read()
    os.remove(tmp)
    # a strip of libtiff's WebP codec is a whole WebP file (lossless here)
    files["e_webp.tif"] = make_tiff(
        np.zeros((8, 12, 3), np.uint8), photo=2, bits=8, comp=50001,
        jpeg_chunks=[_saved(Image.fromarray(img[:8, :12]), "WEBP",
                            lossless=True)])
    files["e_cielab.tif"] = _saved(Image.fromarray(img).convert("LAB"),
                                   "TIFF")
    files["f_xbm.xbm"] = _saved(Image.fromarray(bits), "XBM")
    files["f_xbm_x10.xbm"] = xbm_x10(bits)
    files["f_xpm_rgb.xpm"] = xpm(r.randint(0, 300, (6, 11)),
                                 r.randint(0, 256, (300, 3)), cpp=2)
    for bp in (16, 32, -32, -64):
        vv = r.randint(0, 250, (9, 13)) if bp > 0 else r.rand(9, 13) * 300
        files[f"g_fits_{bp}.fits".replace("-", "m")] = fits(vv, bp)
    files["g_fits_gzip.fits"] = fits_gzip(r.randint(0, 40000, (5, 6)), 16)
    pal = Image.fromarray(img).quantize(32)
    files["h_blp1_pal.blp"] = _saved(pal, "BLP", blp_version="BLP1")
    files["h_blp2_pal.blp"] = _saved(pal, "BLP", blp_version="BLP2")
    jpg = _saved(Image.fromarray(img), "JPEG", quality=85)
    files["h_blp1_jpeg.blp"] = blp1_jpeg(jpg, 32, 24)
    for aenc, size in ((0, 8), (1, 16), (7, 16)):
        data = b"".join((r.randint(0, 256, 8).astype(np.uint8).tobytes()
                         if size == 16 else b"") + _dxt1_block(r)
                        for _ in range(4 * 3))
        files[f"h_blp2_dxt{aenc}.blp"] = blp2(13, 9, 2, 1, aenc, data)
    files["i_spider.spi"] = spider(r.rand(11, 19) * 300 - 20, ">")
    files["j_gbr_v2.gbr"] = gbr(r.randint(0, 256, (6, 9, 4)).astype(
        np.uint8))
    fidx = r.randint(0, 6, (6, 14)).astype(np.uint8)
    files["k_fli_brun.fli"] = fli(14, 6, [(4, fli_colour(
        r.randint(0, 256, (256, 3)))), (15, fli_brun(fidx))])
    files["k_flc_ss2.flc"] = fli(14, 6, [(11, fli_colour(
        r.randint(0, 256, (256, 3)), True)), (7, fli_ss2(fidx[:3]))],
        0xAF11)
    files["l_ftex.ftc"] = ftex(9, 6, 0, b"".join(_dxt1_block(r)
                                                for _ in range(6)))
    files["l_ftex.ftu"] = ftex(7, 5, 1, _img(5, 7, 5).tobytes())
    files["m_pixar.pxr"] = pixar(_img(7, 10, 8))
    files["m_mcidas.area"] = mcidas(r.randint(0, 600, (5, 8)), 2)
    files["m_imt.imt"] = imt(r.randint(0, 256, (6, 9)).astype(np.uint8))
    files["m_iptc.iim"] = iptc(r.randint(0, 256, (7, 30)).astype(np.uint8),
                               3, 1, 2)
    files["m_xvthumb.xv"] = xvthumb(r.randint(0, 256, (6, 9)).astype(
        np.uint8))
    files["n_im_ycc.im"] = _saved(Image.fromarray(img).convert("YCbCr"),
                                  "IM")
    files["n_im_f16.im"] = _im_file("L 16S image", 12, 9, r.randint(
        -300, 600, (9, 12)).astype("<i2").tobytes())
    files["n_im_b4_lut.im"] = _im_file("B4 image", 9, 4, r.randint(
        0, 256, 36).astype(np.uint8).tobytes(), lut=r.randint(
            0, 256, 768).astype(np.uint8))
    files["n_im_l12.im"] = _im_file("L*12 image", 5, 3, r.randint(
        0, 256, 40).astype(np.uint8).tobytes())
    files["n_im_rgb3.im"] = _im_file("RGB3 image", 7, 5, r.randint(
        0, 256, 105).astype(np.uint8).tobytes())
    files["n_im_rlb.im"] = _im_file("RLB image", 4, 4, bytes(48))
    files["o_avif.avif"] = _saved(Image.fromarray(img), "AVIF")
    for n, blob in files.items():
        with open(os.path.join(d, n), "wb") as f:
            f.write(blob)


def ojpeg_corner_files():
    """Old-style JPEG at its corners: one grey sample from a taller stream,
    separate planes; a progressive stream and chroma sampled 2 x 1 / 1 x 2,
    which libtiff refuses."""
    from test_torch_port_jpeg import QTS, _coefs, encode
    from test_torch_port_tiff_codecs import _SAMPLINGS, _jpeg, ojpeg_file
    img = _img(24, 32, 6)
    comps = _SAMPLINGS["mixed"]
    return {
        "e_ojpeg_grey.tif": ojpeg_file(_jpeg(img[..., 0], "4:4:4"), 21, 32,
                                       1, 1),
        "e_ojpeg_planar.tif": ojpeg_file(_jpeg(img), 24, 32, sub=(2, 2),
                                         planar=2),
        "e_ojpeg_progressive.tif": ojpeg_file(_jpeg(img, progressive=True),
                                              24, 32),
        "e_ojpeg_sampling.tif": ojpeg_file(encode(
            32, 24, comps, _coefs(comps, 32, 24, 6), QTS), 24, 32)}


def _digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


# files Pillow reads that the port refuses by name (none since the port
# decodes Pillow's default AVIF save, its AV1 frame deblocked)
_BY_NAME = {}
# files Pillow refuses: what the port's refusal says
_PORT_REFUSES = {"e_webp.tif": "WEBP compression support is not configured",
                 "n_im_rlb.im": "Pillow has no raw mode for it",
                 "e_ojpeg_progressive.tif": "OJPEGReadHeaderInfoSec: Unknown "
                                            "marker type 194 in JPEG data",
                 "e_ojpeg_sampling.tif": "jpeg_start_decompress() returned "
                                         "max_h_samp_factor = 2 and "
                                         "max_v_samp_factor = 2, expected 1 "
                                         "and 1"}


def registry_expected_now():
    """expected.json's content as Pillow and the JAX package give it."""
    files = {}
    for n in sorted(os.listdir(FIXTURES)):
        if n == "expected.json":
            continue
        p = os.path.join(FIXTURES, n)
        e = {}
        try:
            with Image.open(p) as im:
                e = {"format": im.format, "mode": im.mode,
                     "size": list(im.size[::-1])}
                px = np.asarray(im.convert("RGB"))
            if n in _BY_NAME:
                e["refused"] = _BY_NAME[n]
            else:
                e["sha256"] = _digest(px)
        except Exception as err:            # Pillow refuses it
            e["pillow"] = f"{type(err).__name__}: {err}"[:120]
            e["port"] = _PORT_REFUSES[n]
        files[n] = e
    listing = jimages.ImagesCached(FIXTURES, min_size=LISTING_MIN_SIZE)
    return {"files": files,
            "listing": [os.path.basename(p) for p in listing.paths()],
            "listing_min_size": LISTING_MIN_SIZE,
            "tested": [os.path.basename(p)
                       for p in jimages.iter_images_in(FIXTURES)],
            "coded": list(CODED), "rates": list(RATES)}


def _versions():
    return {"pillow": PIL.__version__,
            "libtiff": PIL.features.version("libtiff"),
            "zlib": PIL.features.version("zlib")}


def _expected():
    with open(os.path.join(FIXTURES, "expected.json")) as f:
        return json.load(f)


def test_registry_expected_json_equals_pillow_and_jax_now():
    want = _expected()
    got = registry_expected_now()
    assert {k: want[k] for k in got} == got
    assert sum(os.path.getsize(os.path.join(FIXTURES, n))
               for n in os.listdir(FIXTURES)) < 400_000
    assert want["tested"] == ["a_xpm_as.png", "b_fits_as.jpg"]
    for n, e in want["files"].items():
        if "sha256" in e:
            assert _digest(jimages.load_image_uint8(
                os.path.join(FIXTURES, n))) == e["sha256"], n


def test_port_reads_the_registry_fixtures_as_expected():
    for n, e in sorted(_expected()["files"].items()):
        p = os.path.join(FIXTURES, n)
        if "format" in e:
            assert (timages.image_format(p), timages.image_mode(p),
                    list(timages.image_size(p))) == (
                        e["format"], e["mode"], e["size"]), n
        if "sha256" in e:
            assert _digest(timages.load_image_uint8(p)) == e["sha256"], n
            continue
        with pytest.raises(ValueError) as err:
            timages.load_image_uint8(p)
        if "refused" in e:
            assert f"{e['refused']} is not decoded" in str(err.value), n
        else:
            assert e["port"] in str(err.value), n
    got = timages.ImagesCached(FIXTURES, min_size=LISTING_MIN_SIZE).paths()
    assert [os.path.basename(p) for p in got] == _expected()["listing"]


if __name__ == "__main__":
    for n in os.listdir(FIXTURES) if os.path.isdir(FIXTURES) else ():
        os.remove(os.path.join(FIXTURES, n))
    make_registry_fixtures(FIXTURES)
    exp = {**registry_expected_now(), "made_by": _versions()}
    with open(os.path.join(FIXTURES, "expected.json"), "w") as f:
        json.dump(exp, f, indent=1, sort_keys=True)
    print(f"wrote {len(exp['files'])} fixtures and expected.json to "
          f"{FIXTURES}")
