"""The port's PNM and BMP readers (data/images.py) against the JAX
package's loader, which decodes through Pillow.

Files are written by Pillow from seeded arrays (top-down BMPs, PNM header
comments and the refused variants Pillow does not write are made from
Pillow's files or by hand); `load_image_uint8` and `image_size` of the
port must give exactly what `l3c_tpu.data.images.load_image_uint8` and
Pillow give, and the listing with a minimum size (over PNG, PNM, BMP and JPEG files) the
JAX package's. What the port does not read, progressive JPEG and WebP
among it, raises ValueError with a message pinned here.
"""
import io
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


def _write(path, variant, img):
    """img in the file format of `variant`, by Pillow."""
    if variant == "P6":
        Image.fromarray(img).save(path, "PPM")
    elif variant == "P5":
        Image.fromarray(img[..., 1]).save(path, "PPM")
    elif variant == "P6 comments":
        h, w, _ = img.shape
        head = f"P6\n# a comment\n{w} # another\n{h}\n255\n".encode()
        open(path, "wb").write(head + img.tobytes())
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


@pytest.mark.parametrize("variant", ["P6", "P5", "P6 comments", "BMP24",
                                     "BMP32", "BMP24 top-down",
                                     "BMP32 top-down"])
@pytest.mark.parametrize("hw", [(1, 1), (7, 13), (33, 20)])
def test_pnm_and_bmp_read_as_the_jax_loader(tmp_path, variant, hw):
    """Every pixel equal to the JAX package's load_image_uint8; the size
    from the header equal to Pillow's; odd widths pad BMP rows."""
    ext = ".bmp" if variant.startswith("BMP") else ".ppm"
    p = str(tmp_path / f"im{ext}")
    _write(p, variant, _rgb(*hw, seed=hw[1]))
    want = jimages.load_image_uint8(p)
    got = timages.load_image_uint8(p)
    assert got.dtype == np.uint8 and got.shape == want.shape == (*hw, 3)
    np.testing.assert_array_equal(got, want)
    assert timages.image_size(p) == hw == Image.open(p).size[::-1]


def _refused(tmp_path):
    """(file name, bytes, the message pinned) of what the port refuses."""
    img = _rgb(6, 5, seed=3)
    out = []

    def pillow(name, im, fmt, **kw):
        buf = io.BytesIO()
        im.save(buf, fmt, **kw)
        return buf.getvalue()

    out.append(("x.jpg", pillow("x.jpg", Image.fromarray(img), "JPEG",
                                progressive=True),
                "progressive JPEG is not decoded; the port reads baseline "
                "\\(Huffman sequential\\) JPEG only"))
    # a WebP file's container, as Pillow tells the format (from its first
    # bytes; Pillow may be built without a WebP encoder)
    webp = b"RIFF" + struct.pack("<I", 12) + b"WEBPVP8 " + bytes(8)
    out.append(("x.webp", webp, "WebP is not read by the port: it decodes "
                "PNG, JPEG, PNM \\(P5, P6\\) and BMP itself and has no "
                "WebP decoder"))
    deep = Image.fromarray(img[..., 0].astype(np.int32) * 257, "I")
    out.append(("x16.ppm", pillow("x16.ppm", deep, "PPM"),
                "PNM maxval 65535; only 8-bit PNMs \\(maxval 255\\) are "
                "read, not 16-bit ones"))
    out.append(("x3.ppm", b"P3\n1 1\n255\n0 0 0\n",
                "PNM type P3; only binary P5 \\(grey\\) and P6 \\(RGB\\) "
                "are read"))
    bmp = pillow("x.bmp", Image.fromarray(img), "BMP")
    for comp, name in ((1, "RLE8"), (3, "BI_BITFIELDS")):
        out.append((f"x{comp}.bmp", bmp[:30] + struct.pack("<I", comp)
                    + bmp[34:], f"{name} BMP; only uncompressed \\(BI_RGB\\) "
                    "BMPs are read"))
    out.append(("x8.bmp", pillow("x8.bmp", Image.fromarray(img[..., 0]),
                                 "BMP"),
                "8-bit BMP; only 24- and 32-bit BMPs are read"))
    out.append(("x.ppm", b"not an image at all",
                "unknown image format; the port reads PNG, JPEG, PNM \\(P5, "
                "P6\\) and BMP"))
    return out


def test_what_is_not_read_raises_with_the_reason(tmp_path):
    """Progressive JPEG, WebP, 16-bit and ASCII PNM, RLE, bitfield and 8-bit
    BMP and an unknown format: ValueError naming the format and the
    reason, from the reader and from the header read of the listing (a
    progressive JPEG's header gives Pillow's size: only its pixels are
    refused)."""
    for name, blob, msg in _refused(tmp_path):
        p = str(tmp_path / name)
        open(p, "wb").write(blob)
        with pytest.raises(ValueError, match=msg):
            timages.load_image_uint8(p)
        if name == "x.jpg":
            assert timages.image_size(p) == Image.open(p).size[::-1]
            continue
        with pytest.raises(ValueError, match=msg):
            timages.image_size(p)


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
