"""The port's lossless JPEG decoding (SOF3, Huffman-coded; data/jpeg.py)
against Pillow, whose libjpeg-turbo 3 reads it, and the JAX package's
load_image_uint8.

Files are written here by a test-only encoder (T.81 Annex H: the seven
predictors, the point transform, a difference a sample coded by its
size category): grey, three components as RGB (libjpeg-turbo assumes RGB
for a lossless file without a JFIF or Adobe marker) and as YCbCr (a JFIF
marker: refused, as libjpeg-turbo converts no colour in lossless mode),
chroma subsampled (replicated on decoding), interleaved and
single-component scans, restart intervals of whole MCU rows. Every
pixel, the mode and the size equal Pillow's. Damaged data decodes as
libjpeg decodes it; a restart interval that is no multiple of an MCU row
is refused as Pillow refuses it.
"""
import os
import struct
import sys

import numpy as np
import pytest

from l3c_tpu.data import images as jimages
from l3c_torch.data import images as timages

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_jpeg import JFIF, Bits, _codes  # noqa: E402
from test_torch_port_jpeg_progressive import _dht, check  # noqa: E402

TABLE = _dht(0, list(range(17)), 5)       # sizes 0..16, 5 bits each
CODES = _codes(TABLE)


def _predict(psv, ra, rb, rc):
    return [None, ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1),
            rb + ((ra - rc) >> 1), (ra + rb) >> 1][psv]


def differences(x, psv, pt, fresh):
    """(h, w) samples -> their differences (T.81 H.1.2), the rows in
    `fresh` predicted from the left alone (from 1 << (7 - Pt))."""
    x = x.astype(np.int64) >> pt
    h, w = x.shape
    d = np.zeros((h, w), np.int64)
    for r in range(h):
        for c in range(w):
            if r in fresh:
                pred = x[r, c - 1] if c else 1 << (7 - pt)
            elif c == 0:
                pred = x[r - 1, 0]
            else:
                pred = _predict(psv, x[r, c - 1], x[r - 1, c],
                                x[r - 1, c - 1])
            d[r, c] = (x[r, c] - pred) & 0xFFFF
    return np.where(d > 32768, d - 65536, d)


def _put(bits, d):
    s = 16 if d == 32768 else abs(int(d)).bit_length()
    bits.put(*CODES[s])
    if 0 < s < 16:
        bits.put(d if d > 0 else d + (1 << s) - 1, s)


def encode_lossless(planes, comps, psv=1, pt=0, restart=0,
                    interleaved=True, app=b"", ids=None):
    """A lossless (SOF3) JPEG of components' samples (each its own
    (h, w) extent) under sampling factors comps [(h, v)]; restart in
    MCUs, a multiple of an MCU row."""
    def seg(marker, data):
        return bytes([0xFF, marker]) + struct.pack(">H", len(data) + 2) + data

    ids = ids or list(range(1, len(comps) + 1))
    hmax = max(c[0] for c in comps)
    vmax = max(c[1] for c in comps)
    height = max(p.shape[0] * vmax // c[1] for p, c in zip(planes, comps))
    width = max(p.shape[1] * hmax // c[0] for p, c in zip(planes, comps))
    height = min(height, planes[0].shape[0] * vmax // comps[0][1])
    width = min(width, planes[0].shape[1] * hmax // comps[0][0])
    out = b"\xff\xd8" + app
    sof = struct.pack(">BHHB", 8, height, width, len(comps))
    for i, (h, v) in enumerate(comps):
        sof += bytes([ids[i], h << 4 | v, 0])
    out += seg(0xC3, sof) + seg(0xC4, TABLE)
    if restart:
        out += seg(0xDD, struct.pack(">H", restart))
    scans = [list(range(len(comps)))] if interleaved else [
        [i] for i in range(len(comps))]
    for sc in scans:
        hdr = bytes([len(sc)]) + b"".join(bytes([ids[i], 0]) for i in sc)
        out += seg(0xDA, hdr + bytes([psv, 0, pt]))
        if len(sc) == 1:
            per_row, rows = planes[sc[0]].shape[1], planes[sc[0]].shape[0]
            vs = {sc[0]: 1}
        else:
            per_row, rows = -(-width // hmax), -(-height // vmax)
            vs = {i: comps[i][1] for i in sc}
        every = restart // per_row if restart else rows
        diffs = {i: differences(planes[i], psv, pt, {
            r * vs[i] for r in range(0, rows, every)}) for i in sc}
        bits, data = Bits(), b""
        for my in range(rows):
            if restart and my and my % every == 0:
                data += bits.flush() + bytes([0xFF, 0xD0 + (
                    my // every - 1) % 8])
            for mx in range(per_row):
                for i in sc:
                    h, v = (1, 1) if len(sc) == 1 else comps[i]
                    d = diffs[i]
                    for y in range(v):
                        for x in range(h):
                            r, c = my * v + y, mx * h + x
                            _put(bits, d[r, c] if r < d.shape[0]
                                 and c < d.shape[1] else 0)
        out += data + bits.flush()
    return out + b"\xff\xd9"


def _planes(h, w, comps, seed):
    r = np.random.RandomState(seed)
    hmax = max(c[0] for c in comps)
    vmax = max(c[1] for c in comps)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (yy * 3 + xx * 5 + r.randint(0, 40, (h, w))) % 256
    out = []
    for k, (ch, cv) in enumerate(comps):
        p = np.roll(base, 7 * k, 1)[::vmax // cv, ::hmax // ch]
        out.append(p[:-(-h * cv // vmax), :-(-w * ch // hmax)].astype(
            np.uint8))
    return out


SAMPLINGS = {"grey": [(1, 1)], "4:4:4": [(1, 1)] * 3,
             "4:2:0": [(2, 2), (1, 1), (1, 1)], "4:2:2": [(2, 1), (1, 1),
                                                         (1, 1)]}


@pytest.mark.parametrize("psv", range(1, 8))
@pytest.mark.parametrize("sampling", ["grey", "4:4:4", "4:2:0"])
def test_predictors_equal_pillow(tmp_path, sampling, psv):
    """Each predictor at point transforms 0 and 2, odd sizes, with a
    restart every two MCU rows or none."""
    comps = SAMPLINGS[sampling]
    p = str(tmp_path / "l.jpg")
    for (h, w), pt, rst in (((23, 17), 0, 0), ((9, 33), 2, 2), ((1, 5), 0,
                                                                0)):
        per_row = -(-w // max(c[0] for c in comps))
        with open(p, "wb") as f:
            f.write(encode_lossless(_planes(h, w, comps, psv), comps, psv,
                                    pt, restart=rst * per_row))
        check(p)


@pytest.mark.parametrize("sampling", ["4:4:4", "4:2:0", "4:2:2"])
@pytest.mark.parametrize("marker", ["none", "JFIF"])
def test_colour_and_scans_equal_pillow(tmp_path, sampling, marker):
    """Three components as RGB (no marker), in one interleaved scan or
    one scan each; as YCbCr (a JFIF marker) libjpeg-turbo converts no
    colour in lossless mode, and both refuse the file."""
    comps = SAMPLINGS[sampling]
    p = str(tmp_path / "c.jpg")
    for interleaved in (True, False):
        with open(p, "wb") as f:
            f.write(encode_lossless(_planes(21, 30, comps, 3), comps, 6, 1,
                                    interleaved=interleaved,
                                    app=JFIF if marker == "JFIF" else b""))
        if marker == "none":
            check(p)
            continue
        with pytest.raises(ValueError, match="converts no colour"):
            timages.load_image_uint8(p)
        with pytest.raises(OSError):
            jimages.load_image_uint8(p)


def test_damage_and_bad_restart_equal_pillow(tmp_path):
    """Single-byte damage to the data (zero bits to the end of the MCU
    row, then rows at the starting predictor), and a restart interval
    that is no multiple of an MCU row (refused)."""
    comps = SAMPLINGS["4:4:4"]
    blob = encode_lossless(_planes(24, 32, comps, 9), comps, 4, 0,
                           restart=64)
    p = str(tmp_path / "d.jpg")
    lo = blob.index(b"\xff\xda") + 14
    for seed in range(25):
        r = np.random.RandomState(seed)
        out = bytearray(blob)
        out[r.randint(lo, len(blob) - 2)] ^= r.randint(1, 256)
        with open(p, "wb") as f:
            f.write(bytes(out))
        try:
            got = timages.load_image_uint8(p)
        except ValueError:
            got = None
        try:
            want = jimages.load_image_uint8(p)
        except Exception:
            want = None
        assert (got is None) == (want is None), seed
        if got is not None:
            np.testing.assert_array_equal(got, want)
    at = blob.index(b"\xff\xdd")
    with open(p, "wb") as f:
        f.write(blob[:at + 4] + struct.pack(">H", 40) + blob[at + 6:])
    with pytest.raises(ValueError, match="restart interval"):
        timages.load_image_uint8(p)
    with pytest.raises(OSError):
        jimages.load_image_uint8(p)


def test_what_pillow_refuses_is_refused(tmp_path):
    """A lossless file without its Huffman table (jdlhuff.c installs no
    Annex K tables, unlike jdhuff.c) and an arithmetic-coded lossless one
    (SOF11; libjpeg-turbo refuses it whatever its data): both refuse."""
    comps = SAMPLINGS["grey"]
    blob = encode_lossless(_planes(6, 8, comps, 1), comps)
    at = blob.index(b"\xff\xc4")
    n = struct.unpack(">H", blob[at + 2:at + 4])[0]
    sof = blob.index(b"\xff\xc3")
    p = str(tmp_path / "r.jpg")
    for bad, msg in ((blob[:at] + blob[at + 2 + n:], "undefined Huffman"),
                     (blob[:sof + 1] + b"\xcb" + blob[sof + 2:],
                      "arithmetic-coded lossless JPEG is not decoded")):
        with open(p, "wb") as f:
            f.write(bad)
        with pytest.raises(ValueError, match=msg):
            timages.load_image_uint8(p)
        with pytest.raises(OSError):
            jimages.load_image_uint8(p)
