"""The port's own PNG reader and writer (data/images.py) against Pillow.

The port reads and writes PNG with zlib and numpy, because the card machine
is not known to have Pillow; Pillow is present where these tests run. The
reader is held to `Image.open(...).convert("RGB")`, what the JAX package's
`load_image_uint8` returns, on files Pillow wrote in every supported
colour type, on hand-filtered files for each of the five row filters, and
on hand-written files at every bit depth and colour type the standard
defines, non-interlaced and Adam7; the writer is read back by Pillow.
What is not a PNG the standard defines raises ValueError with the
reason.
"""
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from l3c_tpu.data import images as jimages
from l3c_torch.data import images as timages


def _rgb(h, w, seed):
    """Smooth gradients plus noise: every adaptive filter gets chosen."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([yy * 3, xx * 5, yy + xx], -1)
    return ((base + rng.randint(0, 12, base.shape)) % 256).astype(np.uint8)


def _pillow_rgb(path):
    return np.asarray(Image.open(path).convert("RGB"))


@pytest.mark.parametrize("mode", ["L", "RGB", "P", "RGBA"])
@pytest.mark.parametrize("hw", [(1, 1), (7, 13), (33, 20)])
def test_reader_equals_pillow(tmp_path, mode, hw):
    """Colour types 0 (grey), 2 (RGB), 3 (palette) and 6 (RGBA)."""
    img = Image.fromarray(_rgb(*hw, seed=hw[0]))
    if mode == "P":
        img = img.quantize(colors=17)
    elif mode == "RGBA":
        img.putalpha(Image.fromarray(_rgb(*hw, seed=9)[..., 0]))
    else:
        img = img.convert(mode)
    p = str(tmp_path / f"{mode}.png")
    # (Pillow packs a small palette into fewer bits unless told not to)
    img.save(p, **({"bits": 8} if mode == "P" else {}))
    colour = {"L": 0, "RGB": 2, "P": 3, "RGBA": 6}[mode]
    assert open(p, "rb").read()[25] == colour
    got = timages.read_png(p)
    assert got.dtype == np.uint8 and got.shape == hw + (3,)
    np.testing.assert_array_equal(got, _pillow_rgb(p))
    np.testing.assert_array_equal(timages.load_image_uint8(p),
                                  jimages.load_image_uint8(p))
    assert timages.image_size(p) == hw


def _png(path, w, h, colour, raw_rows, interlace=0, depth=8, split=1,
         plte=False):
    """A PNG from already filtered rows (bytes with the filter byte), with
    a seeded 7-entry palette if `plte`."""
    def chunk(t, d):
        return (struct.pack(">I", len(d)) + t + d
                + struct.pack(">I", zlib.crc32(t + d) & 0xFFFFFFFF))
    z = zlib.compress(raw_rows)
    cut = [z[i * len(z) // split:(i + 1) * len(z) // split]
           for i in range(split)]
    with open(path, "wb") as f:
        f.write(timages.PNG_SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour,
                                           0, 0, interlace)))
        f.write(chunk(b"tEXt", b"note\0ancillary chunks are skipped"))
        if plte:
            f.write(chunk(b"PLTE", np.random.RandomState(5).randint(
                0, 256, 21).astype(np.uint8).tobytes()))
        for c in cut:
            f.write(chunk(b"IDAT", c))
        f.write(chunk(b"IEND", b""))


def _filter_rows(img, ftypes):
    """Apply PNG filter ftypes[r] to each row of (H, W, bpp) uint8."""
    h, w, bpp = img.shape
    px = np.zeros((h + 1, w + 1, bpp), np.int32)
    px[1:, 1:] = img
    out = bytearray()
    for r in range(h):
        a, b, c = px[r + 1, :-1], px[r, 1:], px[r, :-1]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        pred = [0, a, b, (a + b) // 2, paeth][ftypes[r]]
        out += bytes([ftypes[r]]) + ((px[r + 1, 1:] - pred) & 255) \
            .astype(np.uint8).tobytes()
    return bytes(out)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4, "mixed"])
def test_every_row_filter(tmp_path, ftype):
    """Each of the five filters on every row, and all of them mixed, in
    several IDAT chunks; Pillow reads the same file the same way."""
    img = _rgb(19, 23, seed=3)
    ftypes = ([i % 5 for i in range(19)] if ftype == "mixed"
              else [ftype] * 19)
    p = str(tmp_path / "f.png")
    _png(p, 23, 19, 2, _filter_rows(img, ftypes), split=3)
    np.testing.assert_array_equal(timages.read_png(p), img)
    np.testing.assert_array_equal(_pillow_rgb(p), img)


@pytest.mark.parametrize("hw", [(1, 1), (8, 8), (21, 19), (64, 48)])
def test_writer_read_back_by_pillow(tmp_path, hw):
    img = _rgb(*hw, seed=hw[1])
    p = str(tmp_path / "w.png")
    timages.write_png(p, img)
    with Image.open(p) as im:
        assert im.mode == "RGB" and im.size == (hw[1], hw[0])
    np.testing.assert_array_equal(_pillow_rgb(p), img)
    np.testing.assert_array_equal(timages.read_png(p), img)
    # it compresses: smooth content takes less than its raw size
    if hw[0] >= 21:
        assert os.path.getsize(p) < img.size


def _pack(samples, depth):
    """(h, w, ch) samples -> (h, row bytes) uint8 as PNG stores them:
    big-endian at 16 bits, packed from the most significant bit below 8."""
    h, w, ch = samples.shape
    flat = samples.reshape(h, w * ch).astype(np.uint16)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = ((flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1)
    return np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)


def _filter_bytes(rows, bpp, ftypes):
    """Filter (h, n) bytes with ftypes[r] at byte distance bpp."""
    h, n = rows.shape
    px = np.zeros((h + 1, n + bpp), np.int32)
    px[1:, bpp:] = rows
    out = bytearray()
    for r in range(h):
        a, b, c = px[r + 1, :-bpp], px[r, bpp:], px[r, :-bpp]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        pred = [0, a, b, (a + b) // 2, paeth][ftypes[r % len(ftypes)]]
        out += bytes([ftypes[r % len(ftypes)]]) + (
            (px[r + 1, bpp:] - pred) & 255).astype(np.uint8).tobytes()
    return bytes(out)


def _image_data(samples, depth, interlace):
    """The (uncompressed) image data of `samples`: every filter in turn,
    Adam7's passes one after another when interlaced."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    passes = ([(0, 0, 1, 1)] if not interlace else
              [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
               (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)])
    out = b""
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            out += _filter_bytes(_pack(sub, depth), bpp, [0, 1, 2, 3, 4])
    return out


# (colour type, bit depth) -> samples a pixel; every one Pillow reads
VARIANTS = [(0, 1), (0, 2), (0, 4), (0, 16), (2, 16), (3, 1), (3, 2),
            (3, 4), (4, 8), (4, 16), (6, 16), (2, 8)]


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("colour,depth", VARIANTS)
def test_depths_colour_types_and_adam7_equal_jax(tmp_path, colour, depth,
                                                 interlace):
    """1-, 2-, 4- and 16-bit samples, grey + alpha and Adam7 interlace,
    on hand-written files (Pillow writes no interlaced PNG): the port
    gives JAX's load_image_uint8 pixels (Pillow's convert("RGB")), its
    size and Pillow's mode. 16-bit grey holds values past 255 (Pillow
    clips them) and 16-bit colour low bytes that differ from the high."""
    h, w = (11, 13) if interlace else (5, 19)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[colour]
    rng = np.random.RandomState(colour * 100 + depth)
    top = 7 if colour == 3 and depth > 2 else (1 << depth)
    samples = rng.randint(0, top, (h, w, ch)).astype(np.uint16)
    if depth == 16:
        samples[0, :4, 0] = [0, 255, 256, 771]
    p = str(tmp_path / "v.png")
    _png(p, w, h, colour, _image_data(samples, depth, interlace),
         interlace=interlace, depth=depth, split=2, plte=colour == 3)
    want = jimages.load_image_uint8(p)
    got = timages.load_image_uint8(p)
    assert got.dtype == np.uint8 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, want)
    assert timages.image_size(p) == (h, w)
    with Image.open(p) as im:
        assert timages.image_mode(p) == im.mode


def test_what_is_not_read_raises_with_the_reason(tmp_path):
    img = _rgb(4, 4, seed=0)
    rows = _filter_rows(img, [0] * 4)
    p = str(tmp_path / "x.png")
    _png(p, 4, 4, 2, rows, interlace=2)
    with pytest.raises(ValueError, match="interlace method"):
        timages.read_png(p)
    _png(p, 4, 4, 2, rows, depth=4)
    with pytest.raises(ValueError, match="bit depth 4 is not defined"):
        timages.read_png(p)
    _png(p, 4, 4, 5, rows)
    with pytest.raises(ValueError, match="colour type 5"):
        timages.read_png(p)
    _png(p, 4, 4, 2, rows[:-5])
    with pytest.raises(ValueError, match="expected"):
        timages.read_png(p)
    _png(p, 4, 4, 2, _image_data(img, 8, 1)[:-3], interlace=1)
    with pytest.raises(ValueError, match="expected"):
        timages.read_png(p)
    _png(p, 4, 4, 2, bytes([7]) + rows[1:])
    with pytest.raises(ValueError, match="filter type 7"):
        timages.read_png(p)
    _png(p, 4, 4, 3, _filter_rows(img[..., :1], [0] * 4))
    with pytest.raises(ValueError, match="palette"):
        timages.read_png(p)
    _png(p, 4, 4, 2, rows)
    blob = bytearray(open(p, "rb").read())
    blob[-20] ^= 1                 # zlib's check, ending the IDAT data
    open(p, "wb").write(bytes(blob))
    with pytest.raises(ValueError, match="incorrect data check"):
        timages.read_png(p)
    open(p, "wb").write(bytes(blob[:40]))
    with pytest.raises(ValueError, match="truncated"):
        timages.read_png(p)
    Image.fromarray(img).save(str(tmp_path / "x.bmp"))
    with pytest.raises(ValueError, match="not a PNG"):
        timages.read_png(str(tmp_path / "x.bmp"))
    with pytest.raises(ValueError, match="uint8"):
        timages.write_png(p, img.astype(np.float32))


def test_listing_and_testset_equal_jax(tmp_path):
    """iter_images_in (dir, glob, file) and Testset's subsampling, id and
    filename filter give the JAX package's answers."""
    (tmp_path / "sub").mkdir()
    for name in ("b.png", "a.png", "sub/c.PNG", "sub/d.png", "e.png",
                 "notes.txt"):
        if name.endswith("txt"):
            (tmp_path / name).write_text("x")
        else:
            timages.write_png(str(tmp_path / name), _rgb(4, 4, seed=1))
    root = str(tmp_path)
    for arg in (root, os.path.join(root, "*.png"),
                os.path.join(root, "**", "*.png"),
                os.path.join(root, "a.png")):
        assert timages.iter_images_in(arg) == jimages.iter_images_in(arg)
    assert len(timages.iter_images_in(root)) == 5
    for kw in (dict(), dict(max_imgs=3), dict(max_imgs=2, name="nm"),
               dict(append_id="_crop8")):
        t, j = timages.Testset(root, **kw), jimages.Testset(root, **kw)
        assert (t.id, list(t), len(t)) == (j.id, list(j), len(j))
    t, j = timages.Testset(root), jimages.Testset(root)
    t.filter_filenames(["a", "d"])
    j.filter_filenames(["a", "d"])
    assert list(t) == list(j) and len(t) == 2
    with pytest.raises(ValueError, match="no files left"):
        t.filter_filenames(["zzz"])
    with pytest.raises(ValueError, match="no images"):
        timages.Testset(str(tmp_path / "sub" / "none*"))
