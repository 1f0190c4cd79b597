"""The port's PNM and BMP readers (data/images.py) against the JAX
package's loader, which decodes through Pillow.

Files are written by Pillow from seeded arrays (top-down BMPs, PNM header
comments and the refused variants Pillow does not write are made from
Pillow's files or by hand); `load_image_uint8` and `image_size` of the
port must give exactly what `l3c_tpu.data.images.load_image_uint8` and
Pillow give, and the listing with a minimum size (over PNG, PNM, BMP and
JPEG files) the JAX package's. PNM: P1 to P6, maxvals other than 255 and
16-bit samples (Pillow's scaling); BMP: 1, 4 and 8-bit palettes (grey ones
as Pillow's "1" and "L"), RLE8, RLE4, 16-bit, bit-field layouts, OS/2, V4
and V5 headers. What the port does not read raises ValueError with a
message pinned here. The listing-cache CLI (`python -m
l3c_torch.data.images update|show CACHE_PKL [SPEC] [--min_size N]`) gives
the JAX CLI's pickle, lines and exit codes over a folder with mislabelled
GIF, TIFF and JPEG 2000 files.
"""
import io
import os
import struct

import numpy as np
import pytest
from PIL import Image

from l3c_tpu.data import images as jimages
from l3c_torch.data import images as timages


def _rgb(h, w, seed):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)


def _top_down(blob: bytes) -> bytes:
    """A bottom-up BMP written by Pillow as the same image stored
    top-down: the height negated and the rows reversed."""
    offset = struct.unpack("<I", blob[10:14])[0]
    w, h, _, bits = struct.unpack("<iiHH", blob[18:30])
    stride = (w * bits // 8 + 3) // 4 * 4
    rows = [blob[offset + i * stride:offset + (i + 1) * stride]
            for i in range(h)]
    return (blob[:22] + struct.pack("<i", -h) + blob[26:offset]
            + b"".join(reversed(rows)))


def _bmp(w, h, bits, rows, comp=0, header=40, palette=None, masks=None,
         top_down=False):
    """A BMP of the given rows (file order, each padded by the caller or
    RLE-coded) with a header of `header` bytes (12: OS/2, 40, 108: V4,
    124: V5), a palette of (n, 3) RGB and bit-field masks."""
    pal = b""
    if palette is not None:
        ent = 3 if header == 12 else 4
        pal = b"".join(bytes([b_, g, r]) + b"\0" * (ent - 3)
                       for r, g, b_ in np.asarray(palette).tolist())
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h,
                           1, bits, comp, len(rows), 2835, 2835,
                           0 if palette is None else len(palette), 0)
        if header > 40:
            m = tuple(masks or (0, 0, 0, 0))
            info += struct.pack("<IIII", *m) + bytes(header - 56)
    extra = b"" if header > 40 or masks is None else struct.pack(
        "<III", *masks[:3])
    offset = 14 + len(info) + len(extra) + len(pal)
    return (b"BM" + struct.pack("<IHHI", offset + len(rows), 0, 0, offset)
            + info + extra + pal + rows)


def _pad_rows(rows):
    """(h, nbytes) uint8 rows, bottom-up, each padded to 4 bytes."""
    rows = rows[::-1]
    pad = -rows.shape[1] % 4
    return np.concatenate([rows, np.zeros((rows.shape[0], pad), np.uint8)],
                          1).tobytes()


def _rle(idx, rle4):
    """RLE8 / RLE4 rows of (h, w) indices, bottom-up: runs, absolute runs
    (an even count for RLE4, as Pillow reads them) and the end codes."""
    out = bytearray()
    for row in idx[::-1].tolist():
        x = 0
        while x < len(row):
            n = 1
            while x + n < len(row) and n < 255 and row[x + n] == row[x]:
                n += 1
            lit = min(len(row) - x, 8)
            lit -= lit % 2
            if n == 1 and lit >= 4 and len(set(row[x:x + lit])) == lit:
                out += bytes([0, lit])
                if rle4:
                    out += bytes(row[x + i] << 4 | row[x + i + 1]
                                 for i in range(0, lit, 2))
                    size = lit // 2
                else:
                    out += bytes(row[x:x + lit])
                    size = lit
                out += bytes(size % 2)
                x += lit
            else:
                v = row[x] << 4 | row[x] if rle4 else row[x]
                out += bytes([n, v])
                x += n
        out += b"\0\0"
    return bytes(out + b"\0\1")


def _write(path, variant, img):
    """img in the file format of `variant`, by Pillow or built here (PNM
    header comments, plain and deep PNMs, palette, RLE, 16-bit, bit-field
    and OS/2 / V4 / V5 BMPs)."""
    h, w, _ = img.shape
    grey = img[..., 1]
    if variant == "P6":
        Image.fromarray(img).save(path, "PPM")
    elif variant == "P5":
        Image.fromarray(grey).save(path, "PPM")
    elif variant == "P4":
        Image.fromarray(grey).convert("1").save(path, "PPM")
    elif variant == "P5 16-bit":
        Image.fromarray(grey.astype(np.int32) * 257 // 3, "I").save(path,
                                                                   "PPM")
    elif variant.startswith("P6 maxval") or variant.startswith("P5 maxval"):
        maxval = int(variant.split()[-1])
        v = (img if variant[1] == "6" else grey).astype(np.int64) * maxval \
            // 255
        dt = np.uint8 if maxval < 256 else ">u2"
        open(path, "wb").write(f"P{variant[1]}\n{w} {h}\n{maxval}\n".encode()
                               + v.astype(dt).tobytes())
    elif variant in ("P1", "P2", "P3"):
        v = {"P1": grey > 127, "P2": grey, "P3": img}[variant].astype(int)
        maxval = "" if variant == "P1" else "\n# max\n300\n" if \
            variant == "P2" else "\n255\n"
        sep = "" if variant == "P1" else " "
        body = "\n".join(sep.join(map(str, row)) for row in v.reshape(h, -1))
        open(path, "wb").write(f"{variant}\n{w} {h}{maxval}\n".encode()
                               + body.encode() + b"\n")
    elif variant == "P6 comments":
        head = f"P6\n# a comment\n{w} # another\n{h}\n255\n".encode()
        open(path, "wb").write(head + img.tobytes())
    elif variant in ("BMP1", "BMP8 grey", "BMP8 palette"):
        im = Image.fromarray(grey).convert("1") if variant == "BMP1" else \
            Image.fromarray(grey) if variant == "BMP8 grey" else \
            Image.fromarray(img).quantize(37)
        im.save(path, "BMP")
    elif variant in ("BMP4 palette", "RLE8", "RLE4", "OS/2 8-bit"):
        n = 16 if variant in ("BMP4 palette", "RLE4") else 200
        idx = (grey.astype(np.int64) * n // 256).astype(np.uint8)
        idx[::3, ::2] = idx[::3, :1]              # runs for the RLE coders
        pal = np.random.RandomState(n).randint(0, 256, (n, 3))
        if variant == "BMP4 palette":
            packed = np.concatenate([idx, np.zeros((h, w % 2), np.uint8)], 1)
            rows = _pad_rows(packed[:, 0::2] << 4 | packed[:, 1::2])
            blob = _bmp(w, h, 4, rows, palette=pal)
        elif variant == "OS/2 8-bit":
            blob = _bmp(w, h, 8, _pad_rows(idx), header=12, palette=pal)
        else:
            blob = _bmp(w, h, 4 if variant == "RLE4" else 8,
                        _rle(idx, variant == "RLE4"),
                        comp=2 if variant == "RLE4" else 1, palette=pal)
        open(path, "wb").write(blob)
    elif variant.startswith("BMP16"):
        g6 = variant.endswith("565")
        r = img[..., 0].astype(np.uint16) >> 3
        b_ = img[..., 2].astype(np.uint16) >> 3
        g = img[..., 1].astype(np.uint16) >> (2 if g6 else 3)
        v = r << (11 if g6 else 10) | g << 5 | b_
        rows = _pad_rows(v.astype("<u2").view(np.uint8).reshape(h, 2 * w))
        blob = _bmp(w, h, 16, rows, comp=3 if g6 else 0,
                    masks=(0xF800, 0x7E0, 0x1F) if g6 else None)
        open(path, "wb").write(blob)
    elif variant in ("V5 BGRA", "V4 XBGR", "OS/2 24-bit", "V5 24-bit"):
        if variant == "V5 BGRA":
            px = np.concatenate([img[..., ::-1], grey[..., None] ^ 0x33], 2)
            blob = _bmp(w, h, 32, _pad_rows(px.reshape(h, -1)), comp=3,
                        header=124, masks=(0xFF0000, 0xFF00, 0xFF,
                                           0xFF000000))
        elif variant == "V4 XBGR":
            px = np.concatenate([np.zeros((h, w, 1), np.uint8),
                                 img[..., ::-1]], 2)
            blob = _bmp(w, h, 32, _pad_rows(px.reshape(h, -1)), comp=3,
                        header=108, masks=(0xFF000000, 0xFF0000, 0xFF00, 0),
                        top_down=True)
        else:
            blob = _bmp(w, h, 24, _pad_rows(img[..., ::-1].reshape(h, -1)),
                        header=12 if variant.startswith("OS/2") else 124)
        if variant == "V4 XBGR":           # rows written top-down
            off = struct.unpack("<I", blob[10:14])[0]
            stride = len(blob[off:]) // h
            rows = [blob[off + i * stride:off + (i + 1) * stride]
                    for i in range(h)]
            blob = blob[:off] + b"".join(reversed(rows))
        open(path, "wb").write(blob)
    else:
        im = Image.fromarray(img)
        if variant.startswith("BMP32"):
            im.putalpha(Image.fromarray(img[..., 0] ^ 0x5A))
        buf = io.BytesIO()
        im.save(buf, "BMP")
        blob = buf.getvalue()
        assert struct.unpack("<H", blob[28:30])[0] == (
            32 if variant.startswith("BMP32") else 24)
        open(path, "wb").write(_top_down(blob) if variant.endswith("top-down")
                               else blob)


VARIANTS = ["P6", "P5", "P6 comments", "P4", "P1", "P2", "P3", "P5 16-bit",
            "P6 maxval 15", "P5 maxval 1000", "P6 maxval 65535",
            "BMP24", "BMP32", "BMP24 top-down", "BMP32 top-down", "BMP1",
            "BMP8 grey", "BMP8 palette", "BMP4 palette", "RLE8", "RLE4",
            "OS/2 8-bit", "OS/2 24-bit", "BMP16 555", "BMP16 565",
            "V5 BGRA", "V4 XBGR", "V5 24-bit"]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("hw", [(1, 1), (7, 13), (33, 20)])
def test_pnm_and_bmp_read_as_the_jax_loader(tmp_path, variant, hw):
    """Every pixel equal to the JAX package's load_image_uint8; the size
    and mode from the header equal to Pillow's; odd widths pad BMP rows."""
    ext = ".ppm" if variant.startswith("P") else ".bmp"
    p = str(tmp_path / f"im{ext}")
    _write(p, variant, _rgb(*hw, seed=hw[1]))
    want = jimages.load_image_uint8(p)
    got = timages.load_image_uint8(p)
    assert got.dtype == np.uint8 and got.shape == want.shape == (*hw, 3)
    np.testing.assert_array_equal(got, want)
    with Image.open(p) as im:
        assert timages.image_size(p) == hw == im.size[::-1]
        assert timages.image_mode(p) == im.mode


def _refused(tmp_path):
    """(file name, bytes, the message pinned) of what the port refuses."""
    img = _rgb(6, 5, seed=3)
    out = []

    def pillow(im, fmt, **kw):
        buf = io.BytesIO()
        im.save(buf, fmt, **kw)
        return buf.getvalue()

    # a WebP file's container whose image chunk is cut short
    webp = b"RIFF" + struct.pack("<I", 12) + b"WEBPVP8 " + bytes(8)
    out.append(("x.webp", webp, "truncated WebP VP8 frame header"))
    out.append(("xf.ppm", b"Pf\n5 6\n0\n" + bytes(120),
                "PNM scale 0.0, not finite and non-zero"))
    bmp = pillow(Image.fromarray(img), "BMP")
    out.append(("x1.bmp", bmp[:30] + struct.pack("<I", 1) + bmp[34:],
                "RLE8 BMP of 24 bits is not read \\(nor by Pillow\\)"))
    out.append(("x3.bmp", bmp[:30] + struct.pack("<I", 3) + bmp[34:],
                "BI_BITFIELDS BMP with masks"))
    out.append(("x4.bmp", bmp[:30] + struct.pack("<I", 4) + bmp[34:],
                "JPEG BMP is not read \\(nor by Pillow\\)"))
    idx = (img[..., 0] // 16).astype(np.uint8)
    packed = np.concatenate([idx, np.zeros((6, 1), np.uint8)], 1)
    out.append(("x16.bmp", _bmp(5, 6, 2, _pad_rows(packed[:, 0::2] << 4
                                                    | packed[:, 1::2]),
                                palette=np.repeat(np.arange(4)[:, None], 3,
                                                  1)),
                "2-bit BMP is not read"))
    out.append(("x.ppm", b"not an image at all",
                "unknown image format; the port reads PNG, JPEG, PNM, BMP "
                "and WebP"))
    return out


def test_what_is_not_read_raises_with_the_reason(tmp_path):
    """A cut-short WebP, a float PNM with a zero scale, RLE on a 24-bit
    BMP, bit-field masks Pillow does not read, JPEG-in-BMP, a 2-bit BMP
    and an unknown format: ValueError
    naming the format and the reason, from the reader and from the header
    read of the listing (a float PNM and grey-palette BMPs Pillow reads:
    test_float_pnm_equals_pillow, test_grey_palette_bmps_equal_pillow)."""
    for name, blob, msg in _refused(tmp_path):
        p = str(tmp_path / name)
        open(p, "wb").write(blob)
        with pytest.raises(ValueError, match=msg):
            timages.load_image_uint8(p)
        with pytest.raises(ValueError, match=msg):
            timages.image_size(p)


@pytest.mark.parametrize("order", ["<f4", ">f4"])
def test_float_pnm_equals_pillow(tmp_path, order):
    """Pf (Pillow's mode "F"): float32 rows bottom-up, the scale's sign
    giving the byte order, convert("RGB") clipping at 0 and 255 and
    truncating (NaN and -inf 0, inf 255); cut short, both refuse it."""
    v = np.array([[0.5, 300, -2, np.nan, np.inf, -np.inf, 254.99, 1e10],
                  [1, 2, 3, 127.5, 128.49, 0.999, -0.7, 255.5]], np.float32)
    scale = "-1.0" if order == "<f4" else "2.5"
    blob = (f"Pf\n# a comment\n8 2\n{scale}\n".encode()
            + v[::-1].astype(order).tobytes())
    p = str(tmp_path / "f.ppm")
    open(p, "wb").write(blob)
    np.testing.assert_array_equal(timages.load_image_uint8(p),
                                  jimages.load_image_uint8(p))
    with Image.open(p) as im:
        assert timages.image_mode(p) == im.mode == "F"
        assert timages.image_size(p) == im.size[::-1]
    open(p, "wb").write(blob[:-3])
    with pytest.raises(ValueError, match="truncated PNM"):
        timages.load_image_uint8(p)
    with pytest.raises(OSError):
        jimages.load_image_uint8(p)


@pytest.mark.parametrize("magic", [b"PyRGBA", b"PyCMYK", b"P0CMYK", b"PyP"])
def test_pillows_own_pnm_types_equal_pillow(tmp_path, magic):
    """Pillow's PNM extensions: RGBA (alpha dropped), CMYK (cmyk2rgb, not
    inverted) and P (no palette: black), raw at maxval 255, scaled at
    others, 16-bit past 255; cut short, both refuse."""
    ch = 1 if magic == b"PyP" else 4
    r = np.random.RandomState(len(magic))
    p = str(tmp_path / "x.ppm")
    for maxval in (255, 100, 1000):
        data = r.randint(0, maxval + 1, (4, 5, ch)).astype(
            ">u2" if maxval > 255 else np.uint8)
        blob = magic + b"\n5 4\n" + str(maxval).encode() + b"\n" + \
            data.tobytes()
        open(p, "wb").write(blob)
        np.testing.assert_array_equal(timages.load_image_uint8(p),
                                      jimages.load_image_uint8(p))
        with Image.open(p) as im:
            assert timages.image_mode(p) == im.mode
        open(p, "wb").write(blob[:-3])
        with pytest.raises(ValueError, match="truncated PNM"):
            timages.load_image_uint8(p)
        with pytest.raises((OSError, ValueError)):   # mmap's or a decoder's
            jimages.load_image_uint8(p)


@pytest.mark.parametrize("bits", [1, 4, 8])
def test_grey_palette_bmps_equal_pillow(tmp_path, bits):
    """Palette BMPs whose palette Pillow takes as grey (a ramp 0, 1, 2, ...
    or black and white) and so reads each row as 8- or 1-bit samples
    whatever the file's bits (the 8-bit ones mapped onto the file, past
    each row's end), and palettes shorter than their indices (black past
    the end): pixels equal to the JAX loader's, or both refuse."""
    p = str(tmp_path / "g.bmp")
    r = np.random.RandomState(bits)
    for pal in ([0, 255], list(range(16)), [0, 1, 2], [255, 0],
                [7, 9, 200]):
        if len(pal) > 1 << bits:
            continue
        for w in (3, 7, 8, 10, 33):
            stride = ((w * bits + 31) >> 3) & ~3
            rows = r.randint(0, 256, (5, stride)).astype(np.uint8)
            open(p, "wb").write(_bmp(w, 5, bits, rows.tobytes(),
                                     palette=np.repeat(np.array(pal)[:, None],
                                                       3, 1)))
            try:
                want = jimages.load_image_uint8(p)
            except OSError:
                with pytest.raises(ValueError, match="not read"):
                    timages.load_image_uint8(p)
                continue
            np.testing.assert_array_equal(timages.load_image_uint8(p), want)


def test_listing_with_min_size_equals_jax(tmp_path):
    """ImagesCached with a minimum side over a directory of PNG, PNM and
    BMP files of several sizes lists what the JAX package lists, and so it
    does with a baseline and a progressive JPEG among them (sizes from
    their headers)."""
    sizes = {"a.png": (9, 12), "b.ppm": (7, 20), "c.bmp": (12, 8),
             "d.ppm": (15, 11), "sub/e.bmp": (3, 30), "sub/f.png": (8, 8),
             "sub/g.bmp": (10, 9)}
    (tmp_path / "sub").mkdir()
    for i, (name, hw) in enumerate(sizes.items()):
        p = str(tmp_path / name)
        img = _rgb(*hw, seed=i)
        if name.endswith(".png"):
            Image.fromarray(img).save(p)
        else:
            _write(p, {"b.ppm": "P6", "d.ppm": "P5", "c.bmp": "BMP24",
                       "sub/e.bmp": "BMP32", "sub/g.bmp": "BMP24 top-down"}[
                           name], img)
    root = str(tmp_path)
    for min_size in (None, 8, 9, 12):
        got = timages.ImagesCached(root, min_size=min_size).paths()
        want = jimages.ImagesCached(root, min_size=min_size).paths()
        assert got == want, min_size
    assert len(timages.ImagesCached(root, min_size=9).paths()) == 3
    Image.fromarray(_rgb(16, 16, seed=0)).save(str(tmp_path / "h.jpg"))
    Image.fromarray(_rgb(8, 16, seed=0)).save(str(tmp_path / "i.jpg"),
                                              progressive=True)
    for min_size in (8, 9):
        got = timages.ImagesCached(root, min_size=min_size).paths()
        assert got == jimages.ImagesCached(root, min_size=min_size).paths()
        assert len(got) == (7 if min_size == 8 else 4)


def _cli_folder(tmp_path):
    """A folder with PNG, a GIF saved as .png, a TIFF saved as .jpg, a JPEG
    2000 file saved as .png (its header read, its pixels not), and .gif
    and .tif files the listing leaves out."""
    root = tmp_path / "imgs"
    (root / "sub").mkdir(parents=True)
    for i, (name, hw, fmt) in enumerate([
            ("a.png", (9, 12), "PNG"), ("sub/b.png", (20, 14), "PNG"),
            ("gif_as.png", (14, 16), "GIF"), ("tif_as.jpg", (15, 14), "TIFF"),
            ("sub/j2k_as.png", (13, 13), "JPEG2000"), ("c.gif", (30, 30),
                                                       "GIF"),
            ("d.tif", (30, 30), "TIFF")]):
        im = Image.fromarray(_rgb(*hw, seed=i))
        im.save(str(root / name), fmt)
    return str(root)


def test_cache_cli_equals_jax(tmp_path, capsys):
    """`update` with --min_size and `show`, in both packages, on a folder
    with mislabelled files: the same pickle contents, the same lines, and
    either package shows the other's cache."""
    import pickle
    root = _cli_folder(tmp_path)
    outs = {}
    for tag, mod in (("port", timages), ("jax", jimages)):
        pkl = str(tmp_path / f"{tag}.pkl")
        lines = []
        for min_size in (None, 12, 14):
            argv = ["update", pkl, root] + (
                [] if min_size is None else ["--min_size", str(min_size)])
            assert mod._cache_cli(argv) == 0
        assert mod._cache_cli(["show", pkl]) == 0
        lines = capsys.readouterr().out.replace(str(tmp_path), "T")
        with open(pkl, "rb") as f:
            outs[tag] = (pickle.load(f), lines)
    assert outs["port"] == outs["jax"]
    cache = outs["port"][0]
    assert sorted(os.path.basename(p) for p in cache[(root, 14)]) == [
        "b.png", "gif_as.png", "tif_as.jpg"]
    for reader, writer in ((timages, "jax"), (jimages, "port")):
        assert reader._cache_cli(["show", str(tmp_path / f"{writer}.pkl")]) \
            == 0
        assert capsys.readouterr().out.replace(str(tmp_path), "T") == \
            outs["port"][1].split("\n", 3)[3]


def test_cache_cli_runs_as_a_module(tmp_path):
    """`python -m l3c_torch.data.images update|show ...` prints the lines
    and exits 0; update without SPEC fails as the JAX CLI's does."""
    import subprocess
    import sys
    root = _cli_folder(tmp_path)
    pkl = str(tmp_path / "c.pkl")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    run = lambda *a: subprocess.run([sys.executable, "-m",
                                     "l3c_torch.data.images", *a],
                                    capture_output=True, text=True, env=env)
    r = run("update", pkl, root, "--min_size", "12")
    assert r.returncode == 0 and r.stdout == f"cached 4 paths for {root!r}\n"
    r = run("show", pkl)
    assert r.returncode == 0 and r.stdout == f"{root!r} min_size=12: 4 paths\n"
    assert run("update", pkl).returncode == 1
