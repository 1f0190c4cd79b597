"""The port's TIFF reader (data/tiff.py) against Pillow, which the JAX
package's load_image_uint8 reads TIFF through (TiffImagePlugin with
libtiff, then convert("RGB")).

- files Pillow writes: raw, LZW, Adobe Deflate, Deflate, PackBits and JPEG
  compression, modes 1, L, P, RGB, RGBA, CMYK, LA, I;16, I and F, the
  horizontal predictor, and a TIFF saved under a .jpg name;
- files a test-only writer makes: both byte orders and BigTIFF, strips and
  tiles, contiguous and planar data, every compression above with and
  without the predictor (8- and 16-bit), 16-bit RGB, associated and
  unassociated alpha and unused extra samples, min-is-white and
  min-is-black at 1, 2, 4 and 8 bits, palettes at 1, 2, 4 and 8 bits,
  FillOrder 2, 16-bit CMYK, signed and float grey, every Orientation,
  and YCbCr JPEG strips (4:2:0) with and without JPEGTables;
every pixel equal to Pillow's convert("RGB") and to the JAX loader, and
format, mode and size from the header equal to Pillow's. Compressions
the port does not decode yet raise naming them.
"""
import io
import os
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from l3c_torch.data import images as timages

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_gif import check  # noqa: E402


def _write(tmp_path, name, blob):
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(blob)
    return p


# ------------------------------------------------------------- encoders

def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW: MSB first, a clear code first, the width growing after
    the encoder adds entry 2^n - 1 (the decoder, one code behind, after
    2^n - 2), a clear before the table would need 13 bits."""
    out, acc, nacc = bytearray(), 0, 0

    def emit(code, size):
        nonlocal acc, nacc
        acc = acc << size | code
        nacc += size
        while nacc >= 8:
            out.append(acc >> (nacc - 8) & 255)
            nacc -= 8
        acc &= (1 << nacc) - 1

    def reset():
        return {bytes([v]): v for v in range(256)}, 258, 9

    table, nxt, size = reset()
    emit(256, 9)
    w = b""
    for v in data:
        wc = w + bytes([v])
        if wc in table:
            w = wc
            continue
        emit(table[w], size)
        table[wc] = nxt
        if nxt == (1 << size) - 1:
            size += 1
        nxt += 1
        if nxt == 4094:
            emit(256, size)
            table, nxt, size = reset()
        w = bytes([v])
    if w:
        emit(table[w], size)
    if nxt == (1 << size) - 1:
        size += 1
    emit(257, size)
    if nacc:
        out.append(acc << (8 - nacc) & 255)
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j + 1 < len(data) and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1), data[i]])
            i = j + 1
            continue
        j = i
        while j + 1 < len(data) and data[j + 1] != data[j] and j - i < 127:
            j += 1
        out += bytes([j - i]) + data[i:j + 1]
        i = j + 1
    return bytes(out)


def _compress(raw: bytes, comp: int) -> bytes:
    if comp == 5:
        return lzw_encode(raw)
    if comp in (8, 32946):
        return zlib.compress(raw)
    if comp == 32773:
        return packbits_encode(raw)
    return raw


_REV = bytes(int(f"{v:08b}"[::-1], 2) for v in range(256))


def _pack_rows(s: np.ndarray, bits: int, order: str) -> bytes:
    """(rows, cols, spp) samples -> row-padded bytes at `bits` a sample."""
    r, c, n = s.shape
    if bits >= 8:
        return s.astype(s.dtype.newbyteorder(order)).tobytes()
    v = s.reshape(r, c * n).astype(np.uint8)
    b = ((v[..., None] >> np.arange(bits - 1, -1, -1)) & 1).reshape(r, -1)
    return np.packbits(b, axis=1).tobytes()


def make_tiff(s, *, photo, bits, order="<", big=False, comp=1, pred=1,
              rows=None, tile=None, planar=1, extra=(), fmt=None, fill=1,
              orient=None, cmap=None, jpeg_chunks=None, jpeg_tables=None,
              ycbcr=None):
    """A TIFF of samples s (H, W, spp): strips of `rows` rows, or tiles
    (tw, th), contiguous or planar (2)."""
    h, w, spp = s.shape
    if pred == 2:
        assert bits >= 8
    chunks = []
    planes = [s] if planar == 1 else [s[..., i:i + 1] for i in range(spp)]
    if tile:
        tw, th = tile
        boxes = [(y, x, th, tw) for y in range(0, h, th)
                 for x in range(0, w, tw)]
    else:
        rows = rows or h
        boxes = [(y, 0, min(rows, h - y), w) for y in range(0, h, rows)]
    for pl in planes:
        for y, x, bh, bw in boxes:
            part = np.zeros((bh, bw, pl.shape[2]), pl.dtype)
            src = pl[y:y + bh, x:x + bw]
            part[:src.shape[0], :src.shape[1]] = src
            if pred == 2:
                u = part.view(part.dtype.str.replace("i", "u").replace(
                    "f", "u")).astype(np.int64)
                d = u.copy()
                d[:, 1:] = u[:, 1:] - u[:, :-1]
                part = (d % (1 << (8 * part.dtype.itemsize))).astype(
                    u.dtype).astype(part.dtype.str.replace("i", "u")
                                    .replace("f", "u")).view(part.dtype)
            raw = _pack_rows(part, bits, order)
            if fill == 2:
                raw = raw.translate(_REV)
            chunks.append(_compress(raw, comp))
    if jpeg_chunks is not None:
        chunks = jpeg_chunks
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp),
            259: (3, [comp]), 262: (3, [photo]), 277: (3, [spp]),
            284: (3, [planar])}
    if fill != 1:
        tags[266] = (3, [fill])
    if orient:
        tags[274] = (3, [orient])
    if pred != 1:
        tags[317] = (3, [pred])
    if extra:
        tags[338] = (3, list(extra))
    if fmt:
        tags[339] = (3, [fmt] * spp)
    if cmap is not None:
        tags[320] = (3, list(cmap))
    if jpeg_tables is not None:
        tags[347] = (7, jpeg_tables)
    if ycbcr:
        tags[530] = (3, list(ycbcr))
    off_tag, cnt_tag = (324, 325) if tile else (273, 279)
    if tile:
        tags[322] = (4, [tile[0]])
        tags[323] = (4, [tile[1]])
    else:
        tags[278] = (4, [rows])
    head = 16 if big else 8
    data = bytearray()
    offsets = []
    for c in chunks:
        offsets.append(head + len(data))
        data += c
        if len(data) % 2:
            data += b"\0"
    tags[off_tag] = (16 if big else 4, offsets)
    tags[cnt_tag] = (16 if big else 4, [len(c) for c in chunks])
    # IFD after the data, its long values after it
    ifd_at = head + len(data)
    n = len(tags)
    entry, cnt_fmt, vsz = (20, "Q", 8) if big else (12, "H", 4)
    extra_at = ifd_at + struct.calcsize(cnt_fmt) + n * entry + vsz
    ifd, tail = bytearray(struct.pack(order + cnt_fmt, n)), bytearray()
    codes = {3: "H", 4: "I", 16: "Q"}
    for tag in sorted(tags):
        typ, vals = tags[tag]
        if typ == 7:
            payload = bytes(vals)
        else:
            payload = struct.pack(order + codes[typ] * len(vals), *vals)
        count = len(payload) if typ == 7 else len(vals)
        ifd += struct.pack(order + "HH", tag, typ)
        ifd += struct.pack(order + ("Q" if big else "I"), count)
        if len(payload) <= vsz:
            ifd += payload.ljust(vsz, b"\0")
        else:
            ifd += struct.pack(order + ("Q" if big else "I"),
                               extra_at + len(tail))
            tail += payload
            if len(tail) % 2:
                tail += b"\0"
    ifd += bytes(vsz)
    magic = (b"II" if order == "<" else b"MM")
    if big:
        hdr = magic + struct.pack(order + "HHHQ", 43, 8, 0, ifd_at)
    else:
        hdr = magic + struct.pack(order + "HI", 42, ifd_at)
    return bytes(hdr + data + ifd + tail)


def _rgb(h, w, seed, dtype=np.uint8, smooth=True):
    r = np.random.RandomState(seed)
    top = np.iinfo(dtype).max if dtype != np.float32 else 300
    if smooth:
        v = np.cumsum(r.randint(0, max(2, top // 40), (h, w, 3)), 1)
        return (v % (int(top) + 1)).astype(dtype)
    return r.randint(0, int(top) + 1, (h, w, 3)).astype(dtype)


# ----------------------------------------------------------------- tests

PILLOW_COMPS = ["raw", "tiff_lzw", "tiff_adobe_deflate", "tiff_deflate",
                "packbits", "jpeg"]


@pytest.mark.parametrize("comp, mode", [
    (c, m) for c in PILLOW_COMPS
    for m in ("RGB", "L", "P", "1", "RGBA", "CMYK", "LA", "I;16", "I", "F")
    if c != "jpeg" or m in ("RGB", "L")])   # libtiff's JPEG: grey and RGB
def test_pillow_tiffs_equal_pillow(tmp_path, comp, mode):
    r = np.random.RandomState(len(comp) * 11 + len(mode))
    h, w = r.randint(1, 90, 2)
    img = _rgb(h, w, len(mode))
    if mode == "I;16":
        im = Image.fromarray((img[..., 0].astype(np.uint16) * 199))
    elif mode in ("I", "F"):
        im = Image.fromarray(img[..., 0]).convert(mode).point(lambda v: v - 9)
    else:
        im = Image.fromarray(img).convert(mode)
    p = str(tmp_path / "p.tif")
    kw = {}
    if comp in ("tiff_lzw", "tiff_adobe_deflate") and mode not in ("1",):
        kw["tiffinfo"] = {317: 2}
    im.save(p, compression=comp, **kw)
    check(p)


def test_mislabelled_tiff_is_read_by_its_bytes(tmp_path):
    p = str(tmp_path / "really_a_tiff.jpg")
    Image.fromarray(_rgb(30, 41, 1)).save(p, format="TIFF",
                                          compression="tiff_lzw")
    check(p)
    assert timages.image_format(p) == "TIFF"


@pytest.mark.parametrize("comp", [1, 5, 8, 32946, 32773])
@pytest.mark.parametrize("layout", ["strips", "tiles", "planar_strips",
                                    "planar_tiles"])
@pytest.mark.parametrize("order", ["<", ">"])
def test_layouts_and_compressions_equal_pillow(tmp_path, order, layout, comp):
    s = _rgb(37, 45, comp + len(layout))
    kw = dict(rows=5) if "strips" in layout else dict(tile=(16, 16))
    if layout.startswith("planar"):
        kw["planar"] = 2
    pred = 2 if comp in (5, 8) else 1
    check(_write(tmp_path, "l.tif", make_tiff(
        s, photo=2, bits=8, order=order, comp=comp, pred=pred, **kw)))


@pytest.mark.parametrize("case", [
    "rgb16", "rgb16_pred", "rgba_assoc", "rgba_assoc16", "rgba_unassoc",
    "rgbx", "rgba_plain", "la", "cmyk", "cmyk16", "grey16_be", "grey16s",
    "grey32f", "grey32s", "bigtiff"])
@pytest.mark.parametrize("order", ["<", ">"])
def test_sample_layouts_equal_pillow(tmp_path, case, order):
    r = np.random.RandomState(len(case))
    h, w = 19, 23
    rgb16 = _rgb(h, w, 3, np.uint16)
    alpha = r.randint(0, 256, (h, w, 1)).astype(np.uint8)
    alpha[0, :4, 0] = (0, 255, 1, 128)
    kw = dict(order=order, comp=5)
    if case.startswith("rgb16"):
        s, kw = rgb16, dict(kw, photo=2, bits=16,
                            pred=2 if case == "rgb16_pred" else 1)
    elif case == "rgba_assoc":
        s = np.concatenate([_rgb(h, w, 4) // 2, alpha], -1)
        kw.update(photo=2, bits=8, extra=(1,))
    elif case == "rgba_assoc16":
        a16 = alpha.astype(np.uint16) * 257
        s = np.concatenate([rgb16 // 3, a16], -1)
        kw.update(photo=2, bits=16, extra=(1,))
    elif case in ("rgba_unassoc", "rgbx", "rgba_plain"):
        s = np.concatenate([_rgb(h, w, 5), alpha], -1)
        kw.update(photo=2, bits=8, extra={"rgba_unassoc": (2,), "rgbx": (0,),
                                          "rgba_plain": ()}[case])
    elif case == "la":
        s = np.concatenate([_rgb(h, w, 6)[..., :1], alpha], -1)
        kw.update(photo=1, bits=8, extra=(2,))
    elif case.startswith("cmyk"):
        s = np.concatenate([_rgb(h, w, 7), alpha], -1)
        if case == "cmyk16":
            s = s.astype(np.uint16) * 257 + 3
        kw.update(photo=5, bits=16 if case == "cmyk16" else 8)
    elif case == "grey16_be":
        s, kw = rgb16[..., :1] // 128, dict(kw, photo=1, bits=16)
    elif case == "grey16s":
        s = (rgb16[..., :1].astype(np.int32) // 64 - 300).astype(np.int16)
        kw.update(photo=1, bits=16, fmt=2)
    elif case == "grey32f":
        s = (rgb16[..., :1] / 100.0 - 20).astype(np.float32)
        s[0, 0, 0] = np.nan
        kw.update(photo=1, bits=32, fmt=3, comp=8)
    elif case == "grey32s":
        s = (rgb16[..., :1].astype(np.int32) * 5 - 1000)
        kw.update(photo=1, bits=32, fmt=2, comp=8)
    else:
        s, kw = _rgb(h, w, 8), dict(kw, photo=2, bits=8, big=True, rows=4)
    p = _write(tmp_path, f"{case}.tif", make_tiff(s, **kw))
    if case == "bigtiff" and order == ">":
        # Pillow tests byte 2 for 43 and takes this file for a classic one
        with pytest.raises(ValueError, match="TIFF"):
            timages.load_image_uint8(p)
        with pytest.raises(OSError):
            Image.open(p)
        return
    check(p)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["min_is_black", "min_is_white", "palette"])
@pytest.mark.parametrize("fill", [1, 2])
@pytest.mark.parametrize("comp", [1, 32773, 8])
def test_grey_and_palette_depths_equal_pillow(tmp_path, bits, kind, fill,
                                              comp):
    r = np.random.RandomState(bits * 3 + len(kind))
    s = r.randint(0, 1 << bits, (13, 21, 1)).astype(np.uint8)
    photo = {"min_is_black": 1, "min_is_white": 0, "palette": 3}[kind]
    cmap = None
    if kind == "palette":
        cmap = r.randint(0, 65536, 3 << bits)
    p = _write(tmp_path, "g.tif", make_tiff(s, photo=photo, bits=bits,
                                           fill=fill, comp=comp, cmap=cmap,
                                           rows=4))
    try:
        with Image.open(p) as im:
            im.load()
    except (OSError, SyntaxError, ValueError):      # Pillow refuses it
        with pytest.raises(ValueError):
            timages.load_image_uint8(p)
        return
    check(p)


@pytest.mark.parametrize("orient", range(1, 9))
def test_orientation_equals_pillow(tmp_path, orient):
    s = _rgb(11, 17, orient)
    check(_write(tmp_path, "o.tif", make_tiff(s, photo=2, bits=8,
                                             orient=orient)))


def _jpeg_strip(img, tables_apart):
    """A Pillow JPEG of the strip (4:2:0); with tables_apart its DQT and
    DHT segments go to JPEGTables (returned) and the strip keeps SOF, SOS
    and the data."""
    f = io.BytesIO()
    Image.fromarray(img).save(f, "JPEG", quality=85, subsampling=2)
    blob = f.getvalue()
    if not tables_apart:
        return blob, None
    at, tables, rest = 2, b"\xff\xd8", b"\xff\xd8"
    while True:
        marker = blob[at + 1]
        if marker == 0xDA:
            rest += blob[at:]
            break
        n = struct.unpack(">H", blob[at + 2:at + 4])[0]
        seg = blob[at:at + 2 + n]
        if marker in (0xDB, 0xC4):
            tables += seg
        elif marker != 0xE0:
            rest += seg
        at += 2 + n
    return rest, tables + b"\xff\xd9"


@pytest.mark.parametrize("tables_apart", [False, True])
@pytest.mark.parametrize("hw", [(32, 48), (37, 45)])
def test_ycbcr_jpeg_strips_equal_pillow(tmp_path, tables_apart, hw):
    """Photometric YCbCr, JPEG (7), strips of 16 rows coded 4:2:0: libtiff
    asks libjpeg for RGB, which upsamples each strip on its own."""
    h, w = hw
    img = _rgb(h, w, 9, smooth=False) // 2 + _rgb(h, w, 10) // 2
    chunks, tables = [], None
    for y in range(0, h, 16):
        strip, t = _jpeg_strip(img[y:y + 16], tables_apart)
        chunks.append(strip)
        tables = t or tables
    s = np.zeros((h, w, 3), np.uint8)
    check(_write(tmp_path, "y.tif", make_tiff(
        s, photo=6, bits=8, comp=7, rows=16, jpeg_chunks=chunks,
        jpeg_tables=tables, ycbcr=(2, 2))))


@pytest.mark.parametrize("comp, name", [(3, "CCITT Group 3"), (4,
                                        "CCITT Group 4"), (32809,
                                                           "ThunderScan")])
def test_what_is_not_decoded_yet_raises_naming_it(tmp_path, comp, name):
    """Once refused by name; CCITT (data/ccitt.py) and ThunderScan now
    decode to Pillow's pixels (more in test_torch_port_ccitt.py and
    test_torch_port_tiff_codecs.py)."""
    if comp == 32809:          # 4-bit raw samples, one code byte each
        s = np.arange(64, dtype=np.uint8).reshape(8, 8, 1) % 16
        blob = make_tiff(np.zeros((8, 8, 1), np.uint8), photo=1, bits=4,
                         comp=comp, jpeg_chunks=[bytes(0xC0 | s.ravel())])
        p = _write(tmp_path, "c.tif", blob)
    else:
        p = str(tmp_path / "c.tif")
        Image.fromarray(np.eye(8, dtype=bool)).save(
            p, compression={3: "group3", 4: "group4"}[comp])
    check(p)
    with Image.open(p) as im:
        assert timages.image_mode(p) == im.mode
        assert timages.image_size(p) == im.size[::-1]


def test_prep_keeps_an_rgb_tiff_named_jpg_as_jax_does(tmp_path):
    """prep_pipeline --inp_dir over a TIFF named .jpg (RGB: kept, its
    pixels resampled as the JAX pipeline resamples them) and a GIF named
    .png (mode P: skipped by both)."""
    import contextlib
    from l3c_tpu.cli import prep_pipeline as jpipe
    from l3c_tpu.data import images as jimages
    from l3c_torch.cli import prep_pipeline as tpipe
    src = tmp_path / "dump"
    src.mkdir()
    Image.fromarray(_rgb(90, 120, 1)).save(str(src / "photo.jpg"), "TIFF",
                                           compression="tiff_lzw")
    Image.fromarray(_rgb(90, 120, 2)).quantize(64).save(
        str(src / "icon.png"), "GIF")
    outs = {}
    for tag, pipe, mod in (("t", tpipe, timages), ("j", jpipe, jimages)):
        out = str(tmp_path / tag)
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            assert pipe.main(["--inp_dir", str(src), out, "--min_res",
                              "48"]) == 0
        outs[tag] = {(sub, n): mod.load_image_uint8(os.path.join(out, sub,
                                                                 n)).tobytes()
                     for sub in ("train", "val")
                     for n in sorted(os.listdir(os.path.join(out, sub)))}
    assert outs["t"] == outs["j"]
    assert [n for _, n in outs["t"]] == ["photo.png"]
