"""The port's CCITT decoder (data/ccitt.py, through data/tiff.py) against
Pillow, which reads CCITT TIFFs through libtiff 4.7's tif_fax3.c.

- files Pillow writes (libtiff's encoder): compression 2 (Modified
  Huffman), 3 (T.4 1-D, and 2-D with T4Options bit 0, fill bits with
  bit 2) and 4 (T.6), at odd widths, at the fax width of 1728 and past
  2560 (the extended make-up codes), in several strips, FillOrder 2 and
  Photometric 0 (min-is-white);
- damaged files, held to Pillow (libtiff 4.7.1's tif_fax3.c, whose
  tables and control flow were read out of Pillow's bundled library):
  bad code words, stray EOLs and patterns inside Modified Huffman, Group
  3 (1-D and 2-D) and Group 4 strips; truncated Modified Huffman and
  Group 3 strips (refused where libtiff fails the strip; Group 3 read
  again from its start without EOLs once its data ends); a truncated
  Group 4 strip (the rows libtiff writes; below them a one-strip file
  shows Pillow's uninitialised buffer, a later strip the previous
  strip's rows);
every pixel equal to Pillow's convert("RGB") and to the JAX loader, and
format, mode and size equal to Pillow's.
"""
import io
import os
import struct
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from l3c_tpu.data import images as jimages
from l3c_torch.data import ccitt
from l3c_torch.data import images as timages

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_gif import check  # noqa: E402

torch.set_num_threads(1)


def page(h, w, seed, kind="strokes"):
    """A bilevel page: text-like strokes, or noise, or long runs."""
    r = np.random.RandomState(seed)
    if kind == "noise":
        return r.rand(h, w) > 0.6
    if kind == "runs":
        a = np.zeros((h, w), bool)
        for y in range(h):
            for _ in range(r.randint(0, 3)):
                x = r.randint(0, w)
                a[y, x:x + r.randint(1, 4 * w)] = True
        return a
    a = np.zeros((h, w), bool)
    for _ in range(max(1, h * w // 300)):
        y, x = r.randint(0, h), r.randint(0, w)
        a[y:y + r.randint(1, 4), x:x + r.randint(1, 30)] = True
    return a


def save(a, compression, info=None):
    f = io.BytesIO()
    Image.fromarray(a).save(f, "TIFF", compression=compression,
                            tiffinfo=info or {})
    return f.getvalue()


def _write(tmp_path, name, blob):
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(blob)
    return p


CASES = [("tiff_ccitt", {}), ("group3", {}), ("group3", {292: 1}),
         ("group3", {292: 5}), ("group3", {292: 4}), ("group4", {}),
         ("group3", {266: 2}), ("group4", {266: 2}), ("tiff_ccitt",
                                                      {266: 2}),
         ("group4", {262: 0}), ("group3", {262: 0, 292: 1}),
         ("group4", {278: 5}), ("group3", {278: 3, 292: 1})]


@pytest.mark.parametrize("compression, info", CASES)
@pytest.mark.parametrize("hw, kind", [((13, 37), "strokes"),
                                      ((9, 61), "noise"),
                                      ((11, 3000), "runs"),
                                      ((1, 1), "noise")])
def test_pillow_files_equal_pillow(tmp_path, compression, info, hw, kind):
    a = page(*hw, seed=hw[1] + len(info), kind=kind)
    check(_write(tmp_path, "c.tif", save(a, compression, info)))


@pytest.mark.parametrize("compression", ["group3", "group4"])
def test_fax_page_width(tmp_path, compression):
    a = page(40, 1728, 3)
    check(_write(tmp_path, "fax.tif", save(a, compression)))


def _strip(blob):
    with Image.open(io.BytesIO(blob)) as im:
        return im.tag_v2[273][0], im.tag_v2[279][0]


def _cut(blob, count, strip=0):
    """The file with a strip's byte count set to `count`."""
    b = bytearray(blob)
    ifd = struct.unpack("<I", blob[4:8])[0]
    for i in range(struct.unpack("<H", blob[ifd:ifd + 2])[0]):
        e = ifd + 2 + 12 * i
        tag, typ, n, v = struct.unpack("<HHII", blob[e:e + 12])
        if tag == 279:
            size = 2 if typ == 3 else 4
            at = v if n * size > 4 else e + 8
            struct.pack_into("<H" if typ == 3 else "<I", b,
                             at + strip * size, count)
    return bytes(b)


def _patched(blob, at, byte):
    b = bytearray(blob)
    b[at] = byte
    return bytes(b)


def same_or_both_refuse(p, written=None):
    """Pillow's pixels, or both refuse; with `written`, only that many
    rows are held (below them a one-strip file shows Pillow's
    uninitialised buffer)."""
    try:
        with Image.open(p) as im:
            want = np.asarray(im.convert("RGB"))
    except OSError:             # libtiff failed the strip: both refuse
        with pytest.raises(ValueError):
            timages.load_image_uint8(p)
        with pytest.raises(OSError):
            jimages.load_image_uint8(p)
        return
    if written is None or written >= len(want):
        check(p)
        return
    got = timages.load_image_uint8(p)
    np.testing.assert_array_equal(got[:written], want[:written])


DAMAGE = [("tiff_ccitt", {}), ("group3", {}), ("group3", {292: 1}),
          ("group4", {})]


@pytest.mark.parametrize("compression, info", DAMAGE)
@pytest.mark.parametrize("where", [0.2, 0.5, 0.8])
def test_bad_code_words_read_as_libtiff_reads_them(tmp_path, compression,
                                                   info, where):
    """A byte of zeros, ones or a pattern inside the strip: bad code words
    end rows white and decoding goes on; eleven zeros are an EOL (Group 4
    reads on past it); a Group 3 strip whose data runs out while looking
    for an EOL's last bit is read again from its start without EOLs;
    libtiff's run arrays keep what earlier rows left past a row's runs."""
    for kind in ("strokes", "noise"):
        a = page(20, 70, int(where * 10), kind)
        blob = save(a, compression, info)
        off, n = _strip(blob)
        for byte in (0x00, 0xFF, 0x5A):
            bad = _patched(blob, off + int(n * where), byte)
            written = None
            if compression == "group4":     # an EOL may end the strip
                try:
                    written = ccitt.decode(bad[off:off + n], 70, 20, 4)[1] + 1
                except ValueError:
                    pass
            same_or_both_refuse(_write(tmp_path, f"d{kind}{byte}.tif", bad),
                                written)


@pytest.mark.parametrize("compression, info", DAMAGE[:3])
@pytest.mark.parametrize("frac", [0.3, 0.6, 0.9])
def test_truncated_strips_read_as_libtiff_reads_them(tmp_path, compression,
                                                     info, frac):
    """Modified Huffman and Group 3 strips cut short: refused where
    libtiff fails the strip, else its rows (Group 3 read again from the
    start without EOLs once the data ends)."""
    a = page(20, 70, 11, "noise")
    blob = save(a, compression, info)
    _, n = _strip(blob)
    same_or_both_refuse(_write(tmp_path, "t.tif", _cut(blob, int(n * frac))))


@pytest.mark.parametrize("frac", [0.3, 0.7, 0.97])
def test_truncated_group4_keeps_the_rows_libtiff_writes(tmp_path, frac):
    """A one-strip Group 4 file cut short: the rows before the cut and the
    cut row as libtiff writes them; the rows after it are Pillow's
    uninitialised strip buffer, so only the written rows are held."""
    a = page(30, 50, 7, "noise")
    blob = save(a, "group4")
    off, n = _strip(blob)
    cut = int(n * frac)
    p = _write(tmp_path, "t.tif", _cut(blob, cut))
    bits, done = ccitt.decode(blob[off:off + cut], 50, 30, 4)
    assert 0 < done < 30 or (done == 30 and frac > 0.9)
    with Image.open(p) as im:
        want = np.asarray(im.convert("RGB"))
    got = timages.load_image_uint8(p)
    keep = min(done + 1, 30)
    np.testing.assert_array_equal(got[:keep], want[:keep])
    np.testing.assert_array_equal(
        got[:keep], jimages.load_image_uint8(p)[:keep])


@pytest.mark.parametrize("strip", [1, 2, 3])
def test_truncated_group4_strip_keeps_the_previous_strips_rows(tmp_path,
                                                               strip):
    """Pillow hands libtiff one strip buffer for all strips: a cut strip's
    unwritten rows show the previous strip's."""
    a = page(40, 50, 3, "noise")
    blob = save(a, "group4", {278: 10})
    with Image.open(io.BytesIO(blob)) as im:
        counts = im.tag_v2[279]
    check(_write(tmp_path, "m.tif", _cut(blob, int(counts[strip] * 0.4),
                                         strip)))


def test_decode_rate_page_is_exact():
    """The decoder alone on a page: every row decoded, none short."""
    a = page(64, 1728, 11)
    blob = save(a, "group4")
    off, n = _strip(blob)
    bits, done = ccitt.decode(blob[off:off + n], 1728, 64, 4)
    assert done == 64
    np.testing.assert_array_equal(bits.astype(bool), a)
