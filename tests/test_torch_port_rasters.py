"""The port's readers of the small raster formats (data/rasters.py,
data/dds.py, and DIB through data/images.py) against Pillow, which the JAX
package's load_image_uint8 reads them through.

- TGA: Pillow's files (every mode, raw and RLE) and a test-only writer's:
  true colour at 16, 24 and 32 bits, colour maps of 16 and 24 bits
  starting past entry 0 (32-bit maps refused by both), grey, 1-bit, an ID
  field, the four origins, RLE packets across rows;
- ICO (PNG and BMP payloads, Pillow's choice among entries) and CUR
  (24-bit, 8-bit and 32-bit bitmaps with their AND masks);
- PCX (Pillow's 1, L, P and RGB; 2- and 4-plane palettes) and DCX;
- SGI (Pillow's; raw and RLE at 8 and 16 bits), QOI, IM (every mode Pillow
  writes), MSP (versions 1 and 2), SUN (1, 8 grey and palette, 24 and 32
  bits, raw and RLE), PSD (bitmap, grey, indexed, RGB, RGBA, CMYK,
  multichannel and duotone composites, raw and PackBits with packets
  across rows);
- DDS: Pillow's uncompressed, DXT1, DXT3, DXT5 and BC5 files, and a
  test-only writer's BC1 to BC5 (FourCC and DX10), BC5S, R8G8B8A8, 8-bit
  palettes, bit masks, and BC6H (unsigned and signed) and BC7 of seeded
  random blocks (every mode and partition);
- DIB (a BMP without its file header);
every pixel equal to Pillow's convert("RGB") and to the JAX loader, and
format, mode and size from the header equal to Pillow's. JPEG 2000 (JP2
and raw codestreams) decodes as Pillow decodes it (more in
test_torch_port_jpeg2000*.py); AVIF too, Pillow's default save (its AV1
frame deblocked) included (more in test_torch_port_avif.py); EPS is refused by both (no Ghostscript). A TGA file that
starts with the CUR magic is a TGA file, as for Pillow, and files saved
under another format's name are read by their bytes.
"""
import io
import os
import struct
import sys

import numpy as np
import pytest
from PIL import Image

from l3c_tpu.data import images as jimages
from l3c_torch.data import images as timages

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_gif import check  # noqa: E402
from test_torch_port_tiff import packbits_encode  # noqa: E402


def _write(tmp_path, name, blob):
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(blob)
    return p


def _img(h, w, seed, smooth=True):
    r = np.random.RandomState(seed)
    if smooth:
        return (np.cumsum(r.randint(0, 12, (h, w, 3)), 1) % 256).astype(
            np.uint8)
    return r.randint(0, 256, (h, w, 3)).astype(np.uint8)


def _pillow_file(tmp_path, name, img, fmt, mode, **kw):
    p = str(tmp_path / name)
    Image.fromarray(img).convert(mode).save(p, fmt, **kw)
    return p


# ------------------------------------------------------------------ TGA

@pytest.mark.parametrize("rle", [False, True])
@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P", "1"])
def test_pillow_tga_equals_pillow(tmp_path, mode, rle):
    if mode == "1" and rle:
        mode = "L"       # Pillow writes an RLE 1-bit file it cannot read
    p = _pillow_file(tmp_path, "t.tga", _img(23, 37, len(mode)), "TGA", mode,
                     **({"compression": "tga_rle"} if rle else {}))
    check(p)


def _tga_rle(px: bytes, size: int) -> bytes:
    """Run packets of equal pixels, raw packets otherwise, up to 128
    pixels each, across rows."""
    pix = [px[i:i + size] for i in range(0, len(px), size)]
    out, i = bytearray(), 0
    while i < len(pix):
        j = i
        while j + 1 < len(pix) and pix[j + 1] == pix[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([0x80 | (j - i)]) + pix[i]
            i = j + 1
            continue
        j = i
        while j + 1 < len(pix) and pix[j + 1] != pix[j] and j - i < 127:
            j += 1
        out += bytes([j - i]) + b"".join(pix[i:j + 1])
        i = j + 1
    return bytes(out)


def make_tga(px, depth, itype, *, origin=0x20, cmap=None, start=0,
             mdepth=0, ident=b""):
    """TGA of file-order pixel bytes px (h, w, depth // 8) or, at 1 bit,
    packed rows."""
    h, w = px.shape[:2]
    raw = px.tobytes()
    if itype & 8:
        raw = _tga_rle(raw, px.shape[2])
    hd = struct.pack("<BBBHHBHHHHBB", len(ident), int(cmap is not None),
                     itype, start, 0 if cmap is None else len(cmap) //
                     (mdepth // 8), mdepth, 0, 0, w, h, depth, origin)
    return hd + ident + (b"" if cmap is None else cmap) + raw


@pytest.mark.parametrize("origin", [0x00, 0x10, 0x20, 0x30])
@pytest.mark.parametrize("case", ["rgb16", "rgb24", "rgb32", "grey8",
                                  "grey16", "map16", "map24", "map32"])
@pytest.mark.parametrize("rle", [False, True])
def test_tga_variants_equal_pillow(tmp_path, case, origin, rle):
    r = np.random.RandomState(len(case) + origin)
    h, w = 9, 13
    cmap, mdepth, start = None, 0, 0
    if case.startswith("rgb"):
        depth, itype = int(case[3:]), 2
        px = r.randint(0, 256, (h, w, depth // 8)).astype(np.uint8)
        px[2, 3:9] = px[2, 3]                  # a run
    elif case.startswith("grey"):
        depth, itype = int(case[4:]), 3
        px = r.randint(0, 256, (h, w, depth // 8)).astype(np.uint8)
    else:
        depth, itype, mdepth, start = 8, 1, int(case[3:]), 5
        cmap = r.randint(0, 256, 40 * mdepth // 8).astype(np.uint8).tobytes()
        px = r.randint(0, 50, (h, w, 1)).astype(np.uint8)
    p = _write(tmp_path, "v.tga", make_tga(
        px, depth, itype | (8 if rle else 0), origin=origin, cmap=cmap,
        start=start, mdepth=mdepth, ident=b"an id"))
    if mdepth == 32:                   # Pillow has no BGRA palette mode
        with pytest.raises(ValueError, match="32-bit colour map"):
            timages.load_image_uint8(p)
        with pytest.raises(ValueError):
            jimages.load_image_uint8(p)
        return
    check(p)


def test_tga_starting_with_the_cur_magic_is_a_tga(tmp_path):
    """Image type 2 without a colour map begins 00 00 02 00, the CUR
    magic; CurImagePlugin finds no cursors and Pillow goes on to TGA."""
    px = np.random.RandomState(3).randint(0, 256, (6, 7, 3)).astype(np.uint8)
    p = _write(tmp_path, "c.tga", make_tga(px, 24, 2))
    assert open(p, "rb").read(4) == b"\0\0\2\0"
    check(p)
    assert timages.image_format(p) == "TGA"


def test_one_bit_tga_equals_pillow(tmp_path):
    bits = np.random.RandomState(4).randint(0, 2, (7, 19)).astype(np.uint8)
    packed = np.packbits(bits, axis=1)[..., None]
    check(_write(tmp_path, "b.tga", make_tga(packed, 1, 3)))


# ----------------------------------------------------------- ICO and CUR

@pytest.mark.parametrize("kw", [{}, {"sizes": [(16, 16), (32, 32), (48, 48)]},
                                {"bitmap_format": "bmp"}])
@pytest.mark.parametrize("mode", ["RGB", "P", "RGBA"])
def test_pillow_ico_equals_pillow(tmp_path, mode, kw):
    p = _pillow_file(tmp_path, "i.ico", _img(48, 48, len(mode) + len(kw)),
                     "ICO", mode, **kw)
    try:
        with Image.open(p) as im:
            im.load()
    except OSError:                 # Pillow cannot read its own file
        with pytest.raises(ValueError):
            timages.load_image_uint8(p)
        return
    check(p)


def _dib(img, bits, palette=None):
    """A BITMAPINFOHEADER bitmap of img (h, w, 3) or indices (h, w), the
    height doubled and an AND mask after the pixels, as icons store it."""
    h, w = img.shape[:2]
    if bits == 8:
        rows = img[::-1].astype(np.uint8)
        pal = np.zeros((256, 4), np.uint8)
        pal[:len(palette), :3] = palette[:, ::-1]
        stride = (w + 3) & ~3
        body = b"".join(r.tobytes().ljust(stride, b"\0") for r in rows)
        pal = pal.tobytes()
    else:
        ch = bits // 8
        px = img[::-1, :, ::-1]
        if ch == 4:
            alpha = np.random.RandomState(1).randint(0, 256, (h, w, 1))
            px = np.concatenate([px, alpha.astype(np.uint8)], -1)
        stride = (w * ch + 3) & ~3
        body = b"".join(r.tobytes().ljust(stride, b"\0") for r in px)
        pal = b""
    mask_stride = ((w + 31) // 32) * 4
    mask = bytes(mask_stride * h)
    hd = struct.pack("<IiiHHIIiiII", 40, w, 2 * h, 1, bits, 0,
                     len(body), 0, 0, 0, 0)
    return hd + pal + body + mask


def _icon(kind, entries):
    """ICO (kind 1) or CUR (kind 2) of [(w, h, bpp, payload)]."""
    out = struct.pack("<HHH", 0, kind, len(entries))
    at = 6 + 16 * len(entries)
    blobs = b""
    for w, h, bpp, payload in entries:
        out += struct.pack("<BBBBHHII", w % 256, h % 256, 0, 0, 1, bpp,
                           len(payload), at + len(blobs))
        blobs += payload
    return out + blobs


@pytest.mark.parametrize("bits", [8, 24, 32])
@pytest.mark.parametrize("kind", [1, 2])
def test_bitmap_icons_equal_pillow(tmp_path, kind, bits):
    r = np.random.RandomState(bits + kind)
    small = _img(16, 16, 1)
    big = _img(24, 24, 2)
    pal = r.randint(0, 256, (200, 3)).astype(np.uint8)
    if bits == 8:
        small, big = r.randint(0, 200, (16, 16)), r.randint(0, 200, (24, 24))
    entries = [(16, 16, bits, _dib(small, bits, pal)),
               (24, 24, bits, _dib(big, bits, pal))]
    name = "i.ico" if kind == 1 else "c.cur"
    check(_write(tmp_path, name, _icon(kind, entries)))


def test_ico_picks_the_largest_then_fewest_colours(tmp_path):
    """Two 24 x 24 entries: Pillow takes the 8-bit one over the 24-bit."""
    r = np.random.RandomState(5)
    pal = r.randint(0, 256, (256, 3)).astype(np.uint8)
    entries = [(24, 24, 24, _dib(_img(24, 24, 6), 24)),
               (24, 24, 8, _dib(r.randint(0, 256, (24, 24)), 8, pal)),
               (16, 16, 24, _dib(_img(16, 16, 7), 24))]
    check(_write(tmp_path, "m.ico", _icon(1, entries)))


# ------------------------------------------------------------ PCX, DCX

@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB"])
@pytest.mark.parametrize("w", [1, 8, 13, 64])
def test_pillow_pcx_equals_pillow(tmp_path, mode, w):
    img = _img(11, w, w)
    if mode == "P":
        img = np.asarray(Image.fromarray(img).quantize(60).convert("RGB"))
    p = _pillow_file(tmp_path, "x.pcx", img, "PCX", mode)
    if (mode, w) == ("RGB", 1):       # Pillow cannot read this file back
        with pytest.raises(ValueError, match="truncated PCX"):
            timages.load_image_uint8(p)
        with pytest.raises(OSError):
            jimages.load_image_uint8(p)
        return
    check(p)


def _pcx_rle(data: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j + 1 < len(data) and data[j + 1] == data[i] and j - i < 62:
            j += 1
        n = j - i + 1
        if n > 1 or data[i] >= 0xC0:
            out += bytes([0xC0 | n, data[i]])
        else:
            out.append(data[i])
        i = j + 1
    return bytes(out)


@pytest.mark.parametrize("planes", [2, 4])
def test_planar_pcx_palettes_equal_pillow(tmp_path, planes):
    r = np.random.RandomState(planes)
    h, w = 7, 21
    idx = r.randint(0, 1 << planes, (h, w))
    stride = (w + 7) // 8
    stride += stride % 2
    rows = b""
    for y in range(h):
        for p in range(planes):
            bits = np.packbits((idx[y] >> p) & 1).tobytes()
            rows += bits.ljust(stride, b"\0")
    hd = bytearray(128)
    hd[0:4] = bytes([10, 5, 1, 1])
    hd[4:12] = struct.pack("<HHHH", 0, 0, w - 1, h - 1)
    hd[16:64] = r.randint(0, 256, 48).astype(np.uint8).tobytes()
    hd[65] = planes
    hd[66:68] = struct.pack("<H", stride)
    check(_write(tmp_path, "pl.pcx", bytes(hd) + _pcx_rle(rows)))


def test_dcx_first_page_equals_pillow(tmp_path):
    pages = []
    for i in range(2):
        f = io.BytesIO()
        Image.fromarray(_img(9 + i, 14, 20 + i)).save(f, "PCX")
        pages.append(f.getvalue())
    head = struct.pack("<I", 987654321)
    at = 4 + 4 * 3
    offs = [at, at + len(pages[0]), 0]
    check(_write(tmp_path, "d.dcx", head + struct.pack("<3I", *offs)
                 + pages[0] + pages[1]))


# ---------------------------------------------------------- SGI and QOI

@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_pillow_sgi_equals_pillow(tmp_path, mode):
    check(_pillow_file(tmp_path, "s.sgi", _img(17, 26, len(mode)), "SGI",
                       mode))


@pytest.mark.parametrize("bpc", [1, 2])
@pytest.mark.parametrize("z", [1, 3, 4])
def test_raw_16_bit_sgi_equals_pillow(tmp_path, bpc, z):
    r = np.random.RandomState(bpc + z)
    h, w = 5, 9
    planes = r.randint(0, 1 << (8 * bpc), (z, h, w))
    hd = bytearray(512)
    hd[:12] = struct.pack(">HBBHHHH", 474, 0, bpc, 3 if z > 1 else 2, w, h,
                          z)
    data = planes.astype(">u2" if bpc == 2 else np.uint8).tobytes()
    check(_write(tmp_path, "w.sgi", bytes(hd) + data))


@pytest.mark.parametrize("bpc", [1, 2])
@pytest.mark.parametrize("z", [1, 3, 4])
def test_rle_sgi_equals_pillow(tmp_path, bpc, z):
    r = np.random.RandomState(bpc * 10 + z)
    h, w = 6, 11
    dt = ">u2" if bpc == 2 else np.uint8
    planes = r.randint(0, 4, (z, h, w)) * (9000 if bpc == 2 else 60)
    planes[:, :, 4:] = r.randint(0, 256 * bpc, (z, h, w - 4))
    rows, starts, lens = [], [], []
    at = 512 + 8 * h * z
    for c in range(z):
        for y in range(h):
            vals = planes[c, y]
            out = []
            i = 0
            while i < w:
                j = i
                while j + 1 < w and vals[j + 1] == vals[i] and j - i < 126:
                    j += 1
                if j > i:
                    out += [j - i + 1, int(vals[i])]
                else:
                    out += [0x80 | 1, int(vals[i])]
                i = j + 1
            out.append(0)
            blob = np.array(out, dt).tobytes()
            starts.append(at)
            lens.append(len(blob))
            rows.append(blob)
            at += len(blob)
    hd = bytearray(512)
    hd[:12] = struct.pack(">HBBHHHH", 474, 1, bpc, 3 if z > 1 else 2, w, h,
                          z)
    tab = struct.pack(f">{h * z}I", *starts) + struct.pack(f">{h * z}I",
                                                            *lens)
    check(_write(tmp_path, "r.sgi", bytes(hd) + tab + b"".join(rows)))


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
@pytest.mark.parametrize("smooth", [False, True])
def test_qoi_equals_pillow(tmp_path, mode, smooth):
    img = _img(29, 31, 8, smooth)
    img[3, :20] = img[3, 0]
    im = Image.fromarray(img).convert(mode)
    if mode == "RGBA":
        a = np.asarray(im).copy()
        a[..., 3] = np.random.RandomState(1).randint(250, 256, a.shape[:2])
        im = Image.fromarray(a)
    p = str(tmp_path / "q.qoi")
    im.save(p, "QOI")
    check(p)


# ------------------------------------------------------------- IM, MSP

@pytest.mark.parametrize("mode", ["1", "L", "LA", "P", "PA", "RGB", "RGBA",
                                  "RGBX", "CMYK", "I", "F"])
def test_pillow_im_equals_pillow(tmp_path, mode):
    im = Image.fromarray(_img(13, 22, len(mode)))
    if mode in ("P", "PA"):
        im = im.quantize(50).convert(mode)
    elif mode in ("I", "F"):
        im = im.convert("L").convert(mode).point(lambda v: v * 2 - 100)
    else:
        im = im.convert(mode)
    p = str(tmp_path / "x.im")
    im.save(p, "IM")
    check(p)


def test_ycbcr_im_is_not_decoded_yet(tmp_path):
    """Once refused by name; IM's YCbCr now decodes to Pillow's pixels
    (its ConvertYCbCr tables, as data/jpeg2000.py has them)."""
    p = str(tmp_path / "y.im")
    Image.fromarray(_img(5, 6, 1)).convert("YCbCr").save(p, "IM")
    with Image.open(p) as im:
        assert (timages.image_mode(p), timages.image_size(p)) == (
            im.mode, im.size[::-1])
    check(p)


def test_msp_equals_pillow(tmp_path):
    check(_pillow_file(tmp_path, "m.msp", _img(19, 45, 3, False), "MSP",
                       "1"))


def test_msp_v2_rle_equals_pillow(tmp_path):
    r = np.random.RandomState(9)
    h, w = 8, 30
    stride = (w + 7) // 8
    rows = []
    for y in range(h):
        if y == 3:
            rows.append(b"")                  # an empty row: white
            continue
        raw = r.randint(0, 256, stride).astype(np.uint8).tobytes()
        rows.append(bytes([0, 2, raw[0]]) + bytes([stride - 2]) + raw[2:])
    hd = bytearray(struct.pack("<4sHH", b"LinS", w, h) + bytes(24))
    chk = 0
    for v in struct.unpack("<16H", bytes(hd)):
        chk ^= v
    hd[30:32] = struct.pack("<H", chk)
    body = struct.pack(f"<{h}H", *map(len, rows)) + b"".join(rows)
    check(_write(tmp_path, "v2.msp", bytes(hd) + body))


# ------------------------------------------------------------------ SUN

def _sun_rle(data: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j + 1 < len(data) and data[j + 1] == data[i] and j - i < 255:
            j += 1
        n = j - i + 1
        if n > 2 or data[i] == 0x80:
            out += bytes([0x80, n - 1, data[i]])
        else:
            out += data[i:i + 1] * n
        i = j + 1
    return bytes(out)


def make_sun(px, depth, ftype, pal=b""):
    """A SUN raster of file-order rows px (h, row bytes): rows padded to
    16 bits, or (ftype 2) RLE over the unpadded rows."""
    h = px.shape[0]
    w = px.shape[1] * 8 // depth
    if ftype == 2:
        data = _sun_rle(px.tobytes())
    else:
        stride = (w * depth + 15) // 16 * 2
        data = b"".join(row.tobytes().ljust(stride, b"\0") for row in px)
    hd = struct.pack(">8I", 0x59A66A95, w, h, depth, len(data), ftype,
                     1 if pal else 0, len(pal))
    return hd + pal + data


@pytest.mark.parametrize("case", ["1", "8", "8p", "24", "24rgb", "32"])
@pytest.mark.parametrize("rle", [False, True])
def test_sun_equals_pillow(tmp_path, case, rle):
    r = np.random.RandomState(len(case) + rle)
    h, w = 7, 16 if case == "1" else 11
    depth = int(case.rstrip("prgb"))
    ftype = 2 if rle else (3 if case == "24rgb" else 1)
    pal = b""
    if depth == 1:
        px = np.packbits(r.randint(0, 2, (h, w)), axis=1)
    else:
        px = r.randint(0, 4, (h, w * depth // 8)) * 70
        px[:, 5:] = r.randint(0, 256, (h, w * depth // 8 - 5))
    px = px.astype(np.uint8)
    if case == "8p":
        pal = r.randint(0, 256, 3 * 100).astype(np.uint8).tobytes()
        px %= 100
    check(_write(tmp_path, "s.ras", make_sun(px, depth, ftype, pal)))


# ------------------------------------------------------------------ PSD

_PSD_KINDS = {"bitmap": (0, 1, 1), "grey": (1, 8, 1), "indexed": (2, 8, 1),
              "rgb": (3, 8, 3), "rgba": (3, 8, 4), "cmyk": (4, 8, 4),
              "multichannel": (7, 8, 2), "duotone": (8, 8, 1),
              "lab": (9, 8, 3)}


def make_psd(planes, kind, rle, cmdata=b""):
    """A PSD whose merged composite is `planes` (channels, h, row bytes)."""
    cmode, bits, ch = _PSD_KINDS[kind]
    _, h, stride = planes.shape
    w = stride * 8 // bits
    out = struct.pack(">4sH6sHIIHH", b"8BPS", 1, bytes(6), ch, h, w, bits,
                      cmode)
    out += struct.pack(">I", len(cmdata)) + cmdata
    out += struct.pack(">I", 0) + struct.pack(">I", 0)
    if rle:
        rows = [packbits_encode(planes[c, y].tobytes()) for c in range(ch)
                for y in range(h)]
        out += struct.pack(">H", 1) + struct.pack(f">{ch * h}H",
                                                  *map(len, rows))
        out += b"".join(rows)
    else:
        out += struct.pack(">H", 0)
        for c in range(ch):             # Pillow steps w * h bytes a channel
            out += planes[c].tobytes().ljust(w * h, b"\0")
    return out


@pytest.mark.parametrize("case", list(_PSD_KINDS))
@pytest.mark.parametrize("rle", [False, True])
def test_psd_composite_equals_pillow(tmp_path, case, rle):
    r = np.random.RandomState(len(case) + 2 * rle)
    h, w = 9, 16 if case == "bitmap" else 14
    _, bits, ch = _PSD_KINDS[case]
    planes = r.randint(0, 256, (ch, h, w * bits // 8)).astype(np.uint8)
    planes[:, 2, :] = 17
    cmdata = b""
    if case == "indexed":
        cmdata = r.randint(0, 256, 768).astype(np.uint8).tobytes()
    check(_write(tmp_path, "p.psd", make_psd(planes, case, rle, cmdata)))


@pytest.mark.parametrize("rle", [False, True])
@pytest.mark.parametrize("hw", [(1, 1), (6, 33), (31, 8)])
def test_lab_psd_equals_pillow(tmp_path, rle, hw):
    """Lab PSDs, which Pillow opens as LAB and converts through
    LittleCMS, at several sizes, every a / b sign."""
    r = np.random.RandomState(hw[0] * 100 + hw[1] + rle)
    planes = r.randint(0, 256, (3,) + hw).astype(np.uint8)
    planes[1, 0, 0], planes[2, 0, 0] = 0x7F, 0x80
    check(_write(tmp_path, "l.psd", make_psd(planes, "lab", rle)))


@pytest.mark.parametrize("rle", [False, True])
@pytest.mark.parametrize("seed", [10, 11])
def test_lab_psd_with_a_fourth_channel_as_pillow(tmp_path, monkeypatch,
                                                rle, seed):
    """Pillow reads a Lab file's first three channels: raw ones as they
    lie, PackBits ones after three channels' row counts, so the fourth
    channel's counts are read as data; where that decode runs past the
    end of the file Pillow and the port both refuse it (seed 11)."""
    r = np.random.RandomState(seed)
    planes = r.randint(0, 256, (4, 9, 14)).astype(np.uint8)
    planes[:, 2, :] = 17
    monkeypatch.setitem(_PSD_KINDS, "lab4", (9, 8, 4))
    p = _write(tmp_path, "l.psd", make_psd(planes, "lab4", rle))
    if not (rle and seed == 11):
        check(p)
        return
    with pytest.raises(OSError, match="truncated"):
        jimages.load_image_uint8(p)
    with pytest.raises(ValueError, match="truncated PSD PackBits data"):
        timages.load_image_uint8(p)


@pytest.mark.parametrize("n", [0, 3, 767, 769])
@pytest.mark.parametrize("rle", [False, True])
@pytest.mark.parametrize("hw", [(4, 9), (16, 16)])
def test_indexed_psd_without_a_768_byte_palette_equals_pillow(tmp_path, n,
                                                              rle, hw):
    """Colour-mode data of other lengths than 768 sets no palette: Pillow
    looks every index up in an empty one."""
    r = np.random.RandomState(n + rle)
    planes = r.randint(0, 256, (1,) + hw).astype(np.uint8)
    cmdata = r.randint(0, 256, n).astype(np.uint8).tobytes()
    check(_write(tmp_path, "p.psd", make_psd(planes, "indexed", rle,
                                             cmdata)))


# ------------------------------------------------------------------ DDS

@pytest.mark.parametrize("mode, fmt", [
    ("RGB", None), ("RGBA", None), ("L", None), ("LA", None),
    ("RGB", "DXT1"), ("RGBA", "DXT1"), ("RGBA", "DXT3"), ("RGBA", "DXT5"),
    ("RGB", "BC5"), ("RGBA", "BC3")])
@pytest.mark.parametrize("hw", [(8, 12), (13, 21)])
def test_pillow_dds_equals_pillow(tmp_path, mode, fmt, hw):
    kw = {"pixel_format": fmt} if fmt else {}
    check(_pillow_file(tmp_path, "d.dds", _img(*hw, len(mode), False), "DDS",
                       mode, **kw))


def make_dds(w, h, data, *, fourcc=b"", dxgi=None, flags=0, bitcount=0,
             masks=(0, 0, 0, 0)):
    pf = struct.pack("<II4sI4I", 32, flags, fourcc, bitcount, *masks)
    hd = struct.pack("<4sII", b"DDS ", 124, 0x1007) + struct.pack(
        "<II", h, w) + bytes(12) + bytes(44) + pf + bytes(20)
    if dxgi is not None:
        hd += struct.pack("<IIIII", dxgi, 3, 0, 1, 0)
    return hd + data


_BLOCK = {b"DXT1": 8, b"DXT3": 16, b"DXT5": 16, b"ATI1": 8, b"BC4U": 8,
          b"ATI2": 16, b"BC5U": 16, b"BC5S": 16}
_DXGI_BLOCK = {71: 8, 74: 16, 77: 16, 80: 8, 83: 16, 84: 16, 95: 16,
               96: 16, 98: 16}


@pytest.mark.parametrize("code", list(_BLOCK) + list(_DXGI_BLOCK))
@pytest.mark.parametrize("hw", [(8, 8), (10, 14)])
def test_bcn_blocks_equal_pillow(tmp_path, code, hw):
    """Seeded random blocks (both BC1 colour orderings, every alpha ramp,
    every BC7 mode and partition)."""
    h, w = hw
    size = _BLOCK.get(code) or _DXGI_BLOCK[code]
    n = -(-h // 4) * -(-w // 4)
    if code in (95, 96, 98):
        h, w, n = 4 * 48, 4 * 48, 48 * 48    # 2304 blocks: every BC6H and
                                              # BC7 mode and partition
    data = np.random.RandomState(size * n + len(str(code))).randint(
        0, 256, n * size).astype(np.uint8).tobytes()
    if isinstance(code, bytes):
        blob = make_dds(w, h, data, fourcc=code, flags=0x4)
    else:
        blob = make_dds(w, h, data, fourcc=b"DX10", dxgi=code, flags=0x4)
    check(_write(tmp_path, "b.dds", blob))


@pytest.mark.parametrize("case", ["rgba8", "palette", "masks565",
                                  "masks32"])
def test_uncompressed_dds_variants_equal_pillow(tmp_path, case):
    r = np.random.RandomState(len(case))
    h, w = 5, 7
    if case == "rgba8":
        blob = make_dds(w, h, r.randint(0, 256, 4 * w * h).astype(
            np.uint8).tobytes(), fourcc=b"DX10", dxgi=28, flags=0x4)
    elif case == "palette":
        blob = make_dds(w, h, r.randint(0, 256, 1024 + w * h).astype(
            np.uint8).tobytes(), flags=0x20, bitcount=8)
    elif case == "masks565":
        blob = make_dds(w, h, r.randint(0, 256, 2 * w * h).astype(
            np.uint8).tobytes(), flags=0x40, bitcount=16,
            masks=(0xF800, 0x7E0, 0x1F, 0))
    else:
        blob = make_dds(w, h, r.randint(0, 256, 4 * w * h).astype(
            np.uint8).tobytes(), flags=0x41, bitcount=32,
            masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000))
    check(_write(tmp_path, "u.dds", blob))


# -------------------------------------------------------------- the rest

def test_dib_equals_pillow(tmp_path):
    f = io.BytesIO()
    Image.fromarray(_img(10, 13, 4)).save(f, "BMP")
    p = _write(tmp_path, "x.dib", f.getvalue()[14:])
    check(p)
    assert timages.image_format(p) == "DIB"


@pytest.mark.parametrize("fmt, mode, kw", [
    ("JPEG2000", "RGB", {}), ("JPEG2000", "L", {}), ("JPEG2000", "RGBA", {}),
    ("JPEG2000", "RGB", {"no_jp2": True}), ("JPEG2000", "LA", {}),
    ("JPEG2000", "I;16", {}), ("AVIF", "RGB", {}), ("AVIF", "RGBA", {}),
    ("AVIF", "L", {})])
def test_whole_codecs_give_pillows_header_and_raise_naming_them(
        tmp_path, fmt, mode, kw):
    """JPEG 2000 decodes to Pillow's pixels (data/jpeg2000.py); AVIF
    (data/avif.py) gives Pillow's header, and Pillow's default save, whose
    AV1 frame runs the deblocking filter, once refused naming the filter,
    decodes to Pillow's pixels."""
    img = _img(21, 34, 2)
    im = Image.fromarray(img[..., 0].astype(np.uint16) * 100) \
        if mode == "I;16" else Image.fromarray(img).convert(mode)
    p = str(tmp_path / ("x.j2k" if kw else "x.bin"))
    im.save(p, fmt, **kw)
    with Image.open(p) as pim:
        assert timages.image_format(p) == pim.format
        assert timages.image_mode(p) == pim.mode
        assert timages.image_size(p) == pim.size[::-1]
    check(p)


@pytest.mark.parametrize("fmt, mode", [("BLP", "P"), ("XBM", "1"),
                                       ("SPIDER", "F")])
def test_formats_not_decoded_yet_raise_naming_them(tmp_path, fmt, mode):
    """Once refused by name; BLP, XBM and SPIDER now decode to Pillow's
    pixels (data/registry.py, more in test_torch_port_registry.py)."""
    p = str(tmp_path / "x.bin")
    Image.fromarray(_img(8, 8, 1)).convert(mode).save(p, fmt)
    assert timages.image_format(p) == fmt
    check(p)


def test_eps_is_refused_by_both(tmp_path):
    p = str(tmp_path / "x.eps")
    Image.fromarray(_img(8, 8, 1)).save(p, "EPS")
    assert timages.image_format(p) == "EPS"
    with pytest.raises(ValueError, match="Pillow opens it but cannot load"):
        timages.load_image_uint8(p)
    with pytest.raises(OSError):
        jimages.load_image_uint8(p)


@pytest.mark.parametrize("fmt, name", [("TGA", "x.png"), ("QOI", "x.jpg"),
                                       ("PCX", "x.bmp"), ("SGI", "x.webp")])
def test_mislabelled_files_are_read_by_their_bytes(tmp_path, fmt, name):
    p = _pillow_file(tmp_path, name, _img(12, 17, 5), fmt, "RGB")
    check(p)


# ------------------------------------------------------------- fixtures
#
# l3c_torch/data/fixtures/pillow_formats: what chip_smoke.py's phase
# pillow_formats holds on the card machine, and expected.json with
# Pillow's modes, sizes and pixel digests, the JAX listing and the
# library versions. `python tests/test_torch_port_rasters.py` (from the
# repo root, PYTHONPATH=.) rewrites them.

import hashlib  # noqa: E402
import json  # noqa: E402

import PIL  # noqa: E402
import PIL.features  # noqa: E402
import zlib  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "l3c_torch", "data", "fixtures",
                        "pillow_formats")
LISTING_MIN_SIZE = 90
# decoded by the port, coded by chip_smoke's cli.l3c, timed for the rates
CODED = ("c_photo.gif", "d_photo_lzw.tif")


def _photo(h, w, seed):
    from test_torch_port_prep import _photo as photo
    return photo(h, w, seed)


def make_pillow_formats(d):
    """The fixtures: two files under another format's name that the
    listing keeps (a GIF as .png, an LZW TIFF as .jpg), the GIF and TIFF
    that chip_smoke codes and times, and one file of each other kind the
    port reads, under names the listing leaves out, JPEG 2000 among them,
    and AVIF, Pillow's default save (its AV1 frame deblocked)."""
    from test_torch_port_tiff import make_tiff, _jpeg_strip
    os.makedirs(d, exist_ok=True)
    ph = lambda h, w, s: Image.fromarray(_photo(h, w, s))
    save = lambda name, im, fmt, **kw: im.save(os.path.join(d, name), fmt,
                                               **kw)
    save("a_gif_as.png", ph(96, 128, 1).quantize(200), "GIF")
    save("b_tiff_lzw_as.jpg", ph(80, 112, 2), "TIFF", compression="tiff_lzw",
         tiffinfo={317: 2})
    save("c_photo.gif", ph(200, 200, 3).quantize(256), "GIF")
    save("d_photo_lzw.tif", ph(160, 200, 4), "TIFF", compression="tiff_lzw",
         tiffinfo={317: 2})
    save("e_deflate.tif", ph(48, 64, 5).convert("L"), "TIFF",
         compression="tiff_adobe_deflate")
    save("f_packbits.tif", ph(40, 56, 6).convert("CMYK"), "TIFF",
         compression="packbits")
    save("g_jpeg.tif", ph(48, 72, 7), "TIFF", compression="jpeg")
    with open(os.path.join(d, "h_tiles_planar.tif"), "wb") as f:
        f.write(make_tiff(_photo(45, 50, 8), photo=2, bits=8, order=">",
                          comp=5, pred=2, tile=(16, 16), planar=2))
    img = _photo(48, 40, 9)
    chunks, tables = [], None
    for y in range(0, 48, 16):
        strip, tables = _jpeg_strip(img[y:y + 16], True)
        chunks.append(strip)
    with open(os.path.join(d, "i_ycbcr_jpeg.tif"), "wb") as f:
        f.write(make_tiff(np.zeros((48, 40, 3), np.uint8), photo=6, bits=8,
                          comp=7, rows=16, jpeg_chunks=chunks,
                          jpeg_tables=tables, ycbcr=(2, 2)))
    save("j_rle.tga", ph(44, 60, 10), "TGA", compression="tga_rle")
    save("k.ico", ph(48, 48, 11), "ICO", sizes=[(16, 16), (48, 48)])
    pal = np.random.RandomState(12).randint(0, 256, (256, 3)).astype(
        np.uint8)
    with open(os.path.join(d, "l.cur"), "wb") as f:
        f.write(_icon(2, [(32, 32, 24, _dib(_photo(32, 32, 12), 24)),
                          (16, 16, 8, _dib(np.random.RandomState(13).randint(
                              0, 256, (16, 16)), 8, pal))]))
    save("m.pcx", ph(40, 50, 14), "PCX")
    save("n.sgi", ph(40, 52, 15).convert("RGBA"), "SGI")
    save("o.qoi", ph(48, 48, 16), "QOI")
    save("p.im", ph(40, 44, 17).quantize(64), "IM")
    save("q.msp", ph(40, 64, 18).convert("1"), "MSP")
    px = _photo(40, 48, 19).reshape(40, 48 * 3)[:, ::-1].copy()
    with open(os.path.join(d, "r.ras"), "wb") as f:
        f.write(make_sun(px, 24, 2))
    planes = _photo(40, 56, 20).transpose(2, 0, 1).copy()
    with open(os.path.join(d, "s.psd"), "wb") as f:
        f.write(make_psd(planes, "rgb", True))
    write_psd_repairs(d)
    save("t_dxt5.dds", ph(48, 64, 21).convert("RGBA"), "DDS",
         pixel_format="DXT5")
    blocks = np.random.RandomState(22).randint(0, 256, 12 * 16 * 16).astype(
        np.uint8).tobytes()
    with open(os.path.join(d, "u_bc7.dds"), "wb") as f:
        f.write(make_dds(64, 48, blocks, fourcc=b"DX10", dxgi=98, flags=0x4))
    blocks = np.random.RandomState(27).randint(0, 256, 12 * 16 * 16).astype(
        np.uint8).tobytes()
    with open(os.path.join(d, "u_bc6h.dds"), "wb") as f:
        f.write(make_dds(64, 48, blocks, fourcc=b"DX10", dxgi=95, flags=0x4))
    f = io.BytesIO()
    ph(40, 52, 23).save(f, "BMP")
    with open(os.path.join(d, "v.dib"), "wb") as out:
        out.write(f.getvalue()[14:])
    save("w.jp2", ph(48, 64, 24), "JPEG2000")
    save("x.j2k", ph(40, 40, 25).convert("L"), "JPEG2000", no_jp2=True)
    save("y.avif", ph(48, 56, 26).convert("RGBA"), "AVIF")


def write_psd_repairs(d):
    """A Lab PSD and an indexed PSD with a 767-byte colour-mode block."""
    planes = _photo(40, 48, 28).transpose(2, 0, 1).copy()
    with open(os.path.join(d, "s_lab.psd"), "wb") as f:
        f.write(make_psd(planes, "lab", True))
    with open(os.path.join(d, "s_short_palette.psd"), "wb") as f:
        f.write(make_psd(planes[:1], "indexed", False, bytes(range(256)) * 2
                         + bytes(255)))


def _digest(arr):
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def pillow_formats_expected_now():
    """expected.json's content as Pillow and the JAX package give it."""
    files = {}
    for n in sorted(os.listdir(FIXTURES)):
        if n == "expected.json":
            continue
        p = os.path.join(FIXTURES, n)
        with Image.open(p) as im:
            e = {"format": im.format, "mode": im.mode,
                 "size": list(im.size[::-1])}
        e["sha256"] = _digest(jimages.load_image_uint8(p))
        files[n] = e
    listing = jimages.ImagesCached(FIXTURES, min_size=LISTING_MIN_SIZE)
    return {"files": files, "listing_min_size": LISTING_MIN_SIZE,
            "listing": [os.path.basename(p) for p in listing.paths()],
            "tested": [os.path.basename(p)
                       for p in jimages.iter_images_in(FIXTURES)],
            "coded": list(CODED)}


def _versions():
    return {"pillow": PIL.__version__,
            "libtiff": PIL.features.version("libtiff"),
            "libjpeg_turbo": PIL.features.version("libjpeg_turbo"),
            "zlib": PIL.features.version("zlib"),
            "python_zlib": zlib.ZLIB_RUNTIME_VERSION,
            "openjpeg": PIL.features.version("jpg_2000"),
            "libavif": PIL.features.version("avif")}


def _expected():
    with open(os.path.join(FIXTURES, "expected.json")) as f:
        return json.load(f)


def test_pillow_formats_expected_json_equals_pillow_and_jax_now():
    want = _expected()
    got = pillow_formats_expected_now()
    assert got == {k: want[k] for k in got}
    assert sum(os.path.getsize(os.path.join(FIXTURES, n))
               for n in os.listdir(FIXTURES)) < 600_000
    assert want["tested"] == ["a_gif_as.png", "b_tiff_lzw_as.jpg"]
    assert want["listing"] == ["a_gif_as.png"]


def test_port_reads_the_pillow_formats_fixtures_as_expected():
    for n, e in _expected()["files"].items():
        p = os.path.join(FIXTURES, n)
        assert timages.image_format(p) == e["format"], n
        assert timages.image_mode(p) == e["mode"], n
        assert list(timages.image_size(p)) == e["size"], n
        if "refused" in e:
            with pytest.raises(ValueError, match=f"{e['refused']} is not "
                               "decoded by the port yet"):
                timages.load_image_uint8(p)
        else:
            assert _digest(timages.load_image_uint8(p)) == e["sha256"], n
    got = timages.ImagesCached(FIXTURES, min_size=LISTING_MIN_SIZE).paths()
    assert [os.path.basename(p) for p in got] == _expected()["listing"]


if __name__ == "__main__":
    for n in os.listdir(FIXTURES) if os.path.isdir(FIXTURES) else ():
        os.remove(os.path.join(FIXTURES, n))
    make_pillow_formats(FIXTURES)
    exp = {**pillow_formats_expected_now(), "made_by": _versions()}
    with open(os.path.join(FIXTURES, "expected.json"), "w") as f:
        json.dump(exp, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {len(exp['files'])} fixtures and expected.json to "
          f"{FIXTURES}")
