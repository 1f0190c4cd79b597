"""The port's baseline JPEG encoder (data/jpeg_encode.py) against Pillow:
the whole file byte for byte equal to what
Image.fromarray(rgb).save(f, format="JPEG", quality=q) writes (libjpeg-
turbo), at qualities 1 to 100, sizes from 1 x 1 to 255 x 257 (none or
some a multiple of the 16 x 16 MCU), on flat, seeded noise, smooth and
procedural (data/synth.py) content. decode_jpeg(blob) gives
read_jpeg(path)'s pixels and refusals on the data-prep fixtures, and
Pillow's pixels for a block outside the inverse DCT's agreed range.
"""
import glob
import io
import os
import sys

import numpy as np
import pytest
from PIL import Image

from l3c_torch.data import jpeg, jpeg_encode, synth

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_jpeg import QTS, _coefs, encode  # noqa: E402

QUALITIES = [1, 8, 20, 39, 55, 75, 91, 95, 100]
SIZES = [(1, 1), (8, 8), (17, 33), (64, 64), (200, 136), (255, 257)]
FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "l3c_torch", "data", "fixtures", "prep")


def pillow_jpeg(rgb, quality):
    b = io.BytesIO()
    Image.fromarray(rgb).save(b, format="JPEG", quality=quality)
    return b.getvalue()


def _content(h, w, kind, seed):
    r = np.random.RandomState(seed)
    if kind == "flat":
        return np.full((h, w, 3), r.randint(0, 256, 3), np.uint8)
    if kind == "noise":
        return r.randint(0, 256, (h, w, 3)).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([yy * 3 % 256, xx * 5 % 256, (yy + xx) % 256], -1)
    return np.clip(base + r.randint(-9, 9, base.shape), 0,
                   255).astype(np.uint8)


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("hw", SIZES)
def test_file_bytes_equal_pillow(hw, quality):
    for i, kind in enumerate(("flat", "noise", "smooth")):
        rgb = _content(*hw, kind, quality * 7 + i)
        got = jpeg_encode.encode_jpeg(rgb, quality)
        assert got == pillow_jpeg(rgb, quality), (hw, quality, kind)


@pytest.mark.parametrize("fam", ["shapes", "text", "vector", "cells",
                                 "foliage", "sky"])
def test_synth_tiles_bytes_equal_pillow(fam):
    """jpegtex's base families at its qualities (8 to 39, then 30 to 69)
    and render_tile's noise branch's (55 to 91), 256 x 256 and cut to a
    size no multiple of 16."""
    rgb = synth.FAMILIES[fam](np.random.RandomState(5), 256)
    u8 = (rgb * 255.0 + 0.5).astype(np.uint8)
    for q in (8, 23, 39, 69, 91):
        for tile in (u8, u8[:200, :136]):
            tile = np.ascontiguousarray(tile)
            assert jpeg_encode.encode_jpeg(tile, q) == pillow_jpeg(tile, q)


def test_quality_tables_and_default_equal_pillow():
    """Every quality's DQT (force_baseline clamps at 255), out-of-range
    qualities clamped as libjpeg clamps them, and Pillow's default, 75."""
    rgb = _content(8, 8, "smooth", 0)
    for q in range(1, 101):
        assert jpeg_encode.encode_jpeg(rgb, q) == pillow_jpeg(rgb, q), q
    b = io.BytesIO()
    Image.fromarray(rgb).save(b, format="JPEG")
    assert jpeg_encode.encode_jpeg(rgb) == b.getvalue()
    assert jpeg_encode.encode_jpeg(rgb, 0) == jpeg_encode.encode_jpeg(rgb, 1)
    assert jpeg_encode.encode_jpeg(rgb, 101) == \
        jpeg_encode.encode_jpeg(rgb, 100)


def test_encoder_refuses_what_it_does_not_write():
    for bad in (np.zeros((4, 4), np.uint8), np.zeros((4, 4, 4), np.uint8),
                np.zeros((4, 4, 3), np.float64), np.zeros((0, 4, 3),
                                                          np.uint8)):
        with pytest.raises(ValueError, match="uint8 RGB"):
            jpeg_encode.encode_jpeg(bad, 75)


def test_decode_jpeg_equals_read_jpeg_on_the_fixtures():
    files = sorted(glob.glob(os.path.join(FIXTURES, "*.jpg")))
    assert len(files) >= 9
    decoded = 0
    for p in files:
        blob = open(p, "rb").read()
        try:
            want = jpeg.read_jpeg(p)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                jpeg.decode_jpeg(blob, p)
            assert str(got.value) == str(e)
            continue
        np.testing.assert_array_equal(jpeg.decode_jpeg(blob), want)
        decoded += 1
    assert decoded >= 7


@pytest.mark.parametrize("dc,pillow", [(-1000, 0), (2000, 255)])
def test_out_of_range_block_gives_pillows_pixels(dc, pillow):
    """A block outside [-512, 511] after the inverse DCT: decode_jpeg gives
    Pillow's (its SIMD code's saturated) pixels and counts the block."""
    comps = [(1, 1, 0)]
    blob = encode(8, 8, comps, _coefs(comps, 8, 8, 3, dc=dc), QTS)
    want = np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))
    assert (want[0] == pillow).all()
    before = jpeg.COUNTS["saturated_blocks"]
    np.testing.assert_array_equal(jpeg.decode_jpeg(blob), want)
    assert jpeg.COUNTS["saturated_blocks"] == before + 1


def test_round_trip_equals_pillows_at_the_synth_qualities():
    """synth._jpeg_roundtrip against Pillow's save and open on a tile
    whose sides are no multiple of 16, over hard content (noise, sharp
    bars) at every quality jpegtex and render_tile draw: pixels equal and
    no block saturated."""
    r = np.random.RandomState(0)
    yy, xx = np.mgrid[0:136, 0:200]
    tiles = [r.randint(0, 256, (136, 200, 3)).astype(np.uint8),
             np.repeat((((yy + xx // 3) % 2) * 255).astype(np.uint8)[
                 ..., None], 3, 2)]
    before = jpeg.COUNTS["saturated_blocks"]
    for q in list(range(8, 40, 3)) + list(range(55, 92, 6)) + [1, 100]:
        for u8 in tiles:
            want = np.asarray(Image.open(io.BytesIO(pillow_jpeg(u8, q)))
                              .convert("RGB"))
            np.testing.assert_array_equal(synth._jpeg_roundtrip(u8, q),
                                          want)
    assert jpeg.COUNTS["saturated_blocks"] == before
