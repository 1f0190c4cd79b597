"""Damaged and partly refined files through the port's loader
(l3c_torch.data.images) against the JAX package's, l3c_tpu.data.images.
load_image_uint8, which is Pillow (libjpeg-turbo, zlib, libwebp): every
case either decodes to equal pixels in both or is refused by both.

- seeded single-byte damage (one byte XORed with a seeded value) over the
  entropy-coded data of Pillow-written JPEGs: baseline 4:2:0 and 4:4:4,
  grey, restart intervals every 1 and 4 MCUs, progressive with and
  without restarts (libjpeg-turbo's recovery: zero bits after the data of
  an MCU, the rest of the restart interval left alone, bad codes as
  symbol 0, runs past the band into coefficient 63, jdmarker.c's
  resynchronisation at a restart marker);
- the same near the 64 KiB boundaries at which Pillow hands libjpeg the
  file, over the 1024 x 768 rate fixtures;
- scans cut short with and without EOI, restart markers rewritten to
  every other code or removed, markers written into the data;
- the inverse DCT out of range (libjpeg-turbo's SIMD code: 16-bit
  dequantization and sums, saturated passes, the shortcut of a block with
  AC rows 1..7 zero), the DC and one AC coefficient across +-(400..4095)
  at quantization steps 1..64;
- block smoothing of progressive files whose AC 1..9 are not all exact
  (jdcoefct.c's decompress_smooth_data), scripts leaving the DC alone,
  AC 1..5, Al = 1 or 2 unrefined, at 4:2:0, 4:4:4 and grey;
- PNG chunks damaged (Pillow checks every CRC before the image data but
  IDAT's; zlib's own check decides where its bytes are read), and WebP;
- each row of the probe that found the port refusing what Pillow reads;
- l3c_torch/data/fixtures/damaged (readable) and damaged_refused, which
  chip_smoke.py holds the card host to, as expected.json records them.

`python tests/test_torch_port_damaged.py` rewrites the fixtures and
expected.json (with the JAX pipeline's prep outputs over them).
"""
import contextlib
import io
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
from l3c_torch.data import jpeg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "l3c_torch", "data", "fixtures")
DAMAGED = os.path.join(FIXTURES, "damaged")
REFUSED = os.path.join(FIXTURES, "damaged_refused")
MIN_RES = 96
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_jpeg import QTS, SAMPLINGS, encode  # noqa: E402
from test_torch_port_jpeg_progressive import (  # noqa: E402
    _big_coefs, encode_progressive)
from test_torch_port_prep import _photo, _photo_textured, digest  # noqa


def outcome(p):
    """('ok', pixels) or ('refused', reason) of the port and of the JAX
    package's loader for the file at p."""
    try:
        got = ("ok", timages.load_image_uint8(p))
    except ValueError as e:
        got = ("refused", str(e))
    try:
        want = ("ok", jimages.load_image_uint8(p))
    except Exception as e:        # Pillow raises OSError, SyntaxError, ...
        want = ("refused", f"{type(e).__name__}: {e}")
    return got, want


def same(p) -> bool:
    """Asserts the port and the JAX loader agree on p; whether it read."""
    got, want = outcome(p)
    assert got[0] == want[0], (p, got[0], want[0],
                               got[1] if got[0] == "refused" else want[1])
    if got[0] == "ok":
        np.testing.assert_array_equal(got[1], want[1])
    return got[0] == "ok"


def jpeg_bytes(img, **kw):
    b = io.BytesIO()
    Image.fromarray(img).save(b, "JPEG", **kw)
    return b.getvalue()


def scan_start(blob):
    """Offset of the first scan's entropy-coded data."""
    sos = blob.index(b"\xff\xda")
    return sos + 2 + struct.unpack(">H", blob[sos + 2:sos + 4])[0]


def xor_one(blob, seed, lo, hi):
    """blob with one seeded byte in [lo, hi) XORed with a seeded value."""
    r = np.random.RandomState(seed)
    at = r.randint(lo, hi)
    out = bytearray(blob)
    out[at] ^= r.randint(1, 256)
    return bytes(out)


def _visible(blob, clean):
    """Pillow reads the damaged bytes, and not as the clean file."""
    try:
        with Image.open(io.BytesIO(blob)) as im:
            got = np.asarray(im.convert("RGB"))
    except Exception:
        return False
    return not np.array_equal(got, clean)


def _refused(blob):
    try:
        with Image.open(io.BytesIO(blob)) as im:
            im.load()
    except Exception:
        return True
    return False


def _first(blob, pick, lo, hi, start=0):
    """The first seed from `start` whose damage `pick` accepts."""
    for seed in range(start, start + 500):
        d = xor_one(blob, seed, lo, hi)
        if pick(d):
            return d
    raise RuntimeError("no seed found")


PHOTO = _photo(96, 128, 0, noise=12)
JPEG_SOURCES = {
    "baseline": dict(quality=85),
    "baseline 4:4:4": dict(quality=95, subsampling=0),
    "grey": dict(quality=85),
    "restart 4": dict(quality=85, restart_marker_blocks=4),
    "restart 1": dict(quality=60, restart_marker_blocks=1),
    "progressive": dict(quality=85, progressive=True),
    "progressive restart": dict(quality=85, progressive=True,
                                restart_marker_blocks=3),
}


def source(kind):
    img = PHOTO[..., 0] if kind == "grey" else PHOTO
    return jpeg_bytes(img, **JPEG_SOURCES[kind])


# ------------------------------------------------------------ the sweeps


@pytest.mark.parametrize("part", range(3))
@pytest.mark.parametrize("kind", list(JPEG_SOURCES))
def test_jpeg_entropy_damage_equals_pillow(tmp_path, kind, part):
    """20 seeds a part, 60 a kind: one byte of the scans XORed (from the
    first SOS on for progressive files, whose later scan headers lie
    there)."""
    blob = source(kind)
    lo = blob.index(b"\xff\xda") if "progressive" in kind else scan_start(
        blob)
    p = str(tmp_path / "d.jpg")
    for seed in range(20 * part, 20 * part + 20):
        with open(p, "wb") as f:
            f.write(xor_one(blob, seed, lo, len(blob) - 2))
        same(p)


@pytest.mark.parametrize("name", ["p_1024x768_q90.jpg",
                                  "r_prog_1024x768_q90.jpg"])
def test_large_file_damage_near_chunk_boundaries_equals_pillow(tmp_path,
                                                               name):
    """Above 64 KiB Pillow hands libjpeg the file in chunks (its Huffman
    decoder takes a faster path when enough bytes are buffered): damage
    just before, at and after each 64 KiB boundary, and at random."""
    d = "rate" if name.startswith("p_") else "formats_rate"
    blob = open(os.path.join(FIXTURES, d, name), "rb").read()
    assert len(blob) > 1 << 16
    r = np.random.RandomState(len(blob))
    spots = [(1 << 16) - 1, 1 << 16, (1 << 16) + 2] + list(
        r.randint(scan_start(blob), len(blob) - 2, 2))
    p = str(tmp_path / "big.jpg")
    for at in spots:
        out = bytearray(blob)
        out[at] ^= r.randint(1, 256)
        with open(p, "wb") as f:
            f.write(bytes(out))
        same(p)


@pytest.mark.parametrize("kind", ["baseline", "restart 4", "progressive",
                                  "progressive restart", "grey"])
def test_cut_scans_equal_pillow(tmp_path, kind):
    """Cut at several points of the scans with EOI appended (zero bits,
    then the MCUs left alone: Pillow reads it), and without (both refuse
    it as truncated), and the file without its EOI."""
    blob = source(kind)
    s0 = scan_start(blob)
    p = str(tmp_path / "c.jpg")
    for cut in (0, 7, 40, 150, 333, 1000, len(blob) - s0 - 3):
        for tail, reads in ((b"\xff\xd9", True), (b"", False)):
            with open(p, "wb") as f:
                f.write(blob[:s0 + cut] + tail)
            assert same(p) == reads
    with open(p, "wb") as f:
        f.write(blob[:-2])
    assert not same(p)


@pytest.mark.parametrize("kind", ["restart 4", "restart 1",
                                  "progressive restart"])
def test_restart_markers_rewritten_equal_pillow(tmp_path, kind):
    """Each of the first restart markers rewritten to every other RSTn,
    to a marker libjpeg does not know, or removed: jdmarker.c's
    resynchronisation (discard it, scan to the next, or leave it and read
    empty intervals until the expected one comes)."""
    blob = source(kind)
    at = [i for i in range(scan_start(blob), len(blob) - 1)
          if blob[i] == 0xFF and 0xD0 <= blob[i + 1] <= 0xD7][:4]
    p = str(tmp_path / "r.jpg")
    for i in at:
        variants = [blob[:i + 1] + bytes([code]) + blob[i + 2:]
                    for code in list(range(0xD0, 0xD8)) + [0x12, 0xE3]
                    if code != blob[i + 1]]
        variants.append(blob[:i] + blob[i + 2:])
        for v in variants:
            with open(p, "wb") as f:
                f.write(v)
            same(p)


@pytest.mark.parametrize("kind", ["baseline", "restart 4", "progressive",
                                  "grey"])
def test_markers_inside_the_data_equal_pillow(tmp_path, kind):
    """Two bytes of the data overwritten by a marker: the data ends there
    (zero bits after it); libjpeg then reads the marker as the next
    segment, refusing those it does not know and those whose contents it
    finds broken before the file ends."""
    blob = source(kind)
    r = np.random.RandomState(5)
    p = str(tmp_path / "m.jpg")
    for code in (0x00, 0x01, 0x02, 0x46, 0xC0, 0xC2, 0xC4, 0xC5, 0xC8,
                 0xCC, 0xCF, 0xD0, 0xD3, 0xD8, 0xD9, 0xDA, 0xDB, 0xDC,
                 0xDD, 0xDE, 0xE0, 0xEE, 0xF0, 0xFE):
        at = r.randint(scan_start(blob), len(blob) - 4)
        out = bytearray(blob)
        out[at:at + 2] = bytes([0xFF, code])
        with open(p, "wb") as f:
            f.write(bytes(out))
        same(p)


@pytest.mark.parametrize("kind", ["baseline", "grey", "baseline 4:4:4",
                                  "restart 4"])
def test_ff_ff_inside_the_data_equals_pillow(tmp_path, kind):
    """0xFF written before a stuffed 0xFF (0xFF 0xFF 0x00: one 0xFF data
    byte to libjpeg's slow path, a marker to its fast one, whose
    coefficients then stay where the slow path's redo writes none), and
    0xFF 0xFF written over two bytes of the data."""
    blob = source(kind)
    s0 = scan_start(blob)
    stuffed = [i for i in range(s0 + 1, len(blob) - 2)
               if blob[i:i + 2] == b"\xff\x00"]
    r = np.random.RandomState(len(blob))
    p = str(tmp_path / "f.jpg")
    variants = [blob[:i - 1] + b"\xff" + blob[i:] for i in stuffed[:10]]
    for at in r.randint(s0, len(blob) - 4, 8):
        variants.append(blob[:at] + b"\xff\xff" + blob[at + 2:])
    for v in variants:
        with open(p, "wb") as f:
            f.write(v)
        same(p)


@pytest.mark.parametrize("kind", ["baseline", "grey", "restart 4"])
def test_junk_after_the_scan_without_eoi_equals_pillow(tmp_path, kind):
    """A single-scan file without its EOI and with bytes after its scan:
    Pillow reads it where libjpeg's bit reader never had to wait at the
    file's end, and refuses it as truncated where it had to."""
    blob = source(kind)[:-2]
    p = str(tmp_path / "j.jpg")
    for n in (0, 3, 7, 8, 12, 20, 64):
        for byte in (0, 0x5A):
            with open(p, "wb") as f:
                f.write(blob + bytes([byte]) * n)
            same(p)


def test_large_file_ff_ff_and_missing_eoi_equal_pillow(tmp_path):
    """The same above 64 KiB, near the boundary at which Pillow hands
    libjpeg more (the fast path's choice and the slow path's waits depend
    on what it holds)."""
    blob = open(os.path.join(FIXTURES, "rate", "p_1024x768_q90.jpg"),
                "rb").read()
    near = [i for i in range((1 << 16) - 600, (1 << 16) + 600)
            if blob[i:i + 2] == b"\xff\x00"]
    p = str(tmp_path / "b.jpg")
    for v in ([blob[:i - 1] + b"\xff" + blob[i:] for i in near[:2]]
              + [blob[:(1 << 16) - 2] + b"\xff\xff" + blob[1 << 16:],
                 blob[:-2] + bytes(100)]):
        with open(p, "wb") as f:
            f.write(v)
        same(p)


IDCT_VALUES = [400, 700, 1023, 1500, 2047, 2500, 3000, 4095]


@pytest.mark.parametrize("q", [1, 2, 3, 5, 8, 13, 16, 32, 64])
def test_inverse_dct_out_of_range_equals_pillow(tmp_path, q):
    """A row of blocks: the DC at +-(400..4095) alone, and beside one AC
    coefficient (zig-zag 1, 2, 4, 9, 20, 63) at +-400, +-1023 and small
    values, every quantization entry q (dequantized values wrap in 16
    bits); then AC up to +-4092 through a progressive file's Al = 2."""
    comps = [(1, 1, 0)]
    p = str(tmp_path / "i.jpg")
    for pos in (0, 1, 2, 4, 9, 20, 63):
        blocks, prev = [], 0
        for dc in [v * s for v in IDCT_VALUES for s in (1, -1)]:
            for ac in [0] if pos == 0 else [0, 400, -400, 1023, -1023, 37]:
                while abs(dc - prev) > 2047:      # the DC table's reach
                    prev += int(np.sign(dc - prev)) * 2047
                    blocks.append(np.eye(64, dtype=np.int64)[0] * prev)
                b = np.zeros(64, np.int64)
                b[0], b[pos] = dc, ac if pos else dc
                blocks.append(b)
                prev = dc
        cf = np.array(blocks)[None]
        with open(p, "wb") as f:
            f.write(encode(8 * cf.shape[1], 8, comps, [cf],
                           {0: np.full(64, q)}))
        assert same(p)
    cf = np.zeros((1, 16, 64), np.int64)
    cf[0, :, 0] = np.arange(16) * 250 - 2000
    cf[0, :, 1] = np.linspace(-4092, 4092, 16).astype(np.int64) // 4 * 4
    cf[0, :, 5] = 1020
    with open(p, "wb") as f:
        f.write(encode_progressive(128, 8, comps, [cf], {0: np.full(64, q)},
                                   [([0], 0, 0, 0, 0), ([0], 1, 63, 0, 2),
                                    ([0], 1, 63, 2, 1), ([0], 1, 63, 1, 0)]))
    assert same(p)


def _smoothing_scripts(n):
    every = list(range(n))
    return {
        "DC only": [(every, 0, 0, 0, 0)],
        "AC 1..5": [(every, 0, 0, 0, 0)] + [([c], 1, 5, 0, 0)
                                             for c in every],
        "Al = 1 left": [(every, 0, 0, 0, 0)] + [([c], 1, 63, 0, 1)
                                                 for c in every],
        "Al = 2 left": [(every, 0, 0, 0, 1)] + [([c], 1, 63, 0, 2)
                                                 for c in every]
        + [(every, 0, 0, 1, 0)],
    }


@pytest.mark.parametrize("script", list(_smoothing_scripts(1)))
@pytest.mark.parametrize("sampling", ["4:2:0", "4:4:4", "grey"])
def test_block_smoothing_equals_pillow(tmp_path, sampling, script):
    """Progressive files left incompletely refined (the DC only, AC 1..5
    only, AC left at Al = 1 or 2) at sizes no multiple of the MCU, one and
    two blocks wide among them (the sliding registers' edges): libjpeg-
    turbo estimates the missing AC 1..9 (and, with no AC sent, the DC)
    from 5 x 5 blocks' DC values."""
    comps = [(1, 1, 0)] if sampling == "grey" else SAMPLINGS[sampling]
    sc = _smoothing_scripts(len(comps))[script]
    p = str(tmp_path / "s.jpg")
    for w, h in ((33, 23), (17, 9), (9, 40), (16, 16), (70, 35)):
        with open(p, "wb") as f:
            f.write(encode_progressive(w, h, comps,
                                       _big_coefs(comps, w, h, w * h), QTS,
                                       sc))
        assert same(p)


def _png(mode, seed, **kw):
    im = Image.fromarray(_photo(40, 56, seed, noise=20))
    im = {"P": lambda: im.quantize(16), "L": lambda: im.convert("L"),
          "RGBA": lambda: im.convert("RGBA")}.get(mode, lambda: im)()
    b = io.BytesIO()
    im.save(b, "PNG", **kw)
    return b.getvalue()


def _png_chunks(blob):
    at, out = 8, []
    while at < len(blob):
        n = struct.unpack(">I", blob[at:at + 4])[0]
        out.append((blob[at + 4:at + 8], at, n))
        at += 12 + n
    return out


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("mode", ["RGB", "P", "L", "RGBA"])
def test_png_damage_equals_pillow(tmp_path, mode, optimize):
    """Single-byte damage to every chunk's length, type, data and CRC, to
    the zlib header and to its check: Pillow refuses a bad CRC before the
    image data, skips IDAT's, reads nothing after the image, and lets zlib
    refuse what it notices."""
    blob = _png(mode, 1, optimize=optimize)
    r = np.random.RandomState(len(blob))
    spots = []
    for ctype, at, n in _png_chunks(blob):
        spots += [at + r.randint(0, 4), at + 4 + r.randint(0, 4),
                  at + 8 + n + r.randint(0, 4)]
        spots += [at + 8 + r.randint(0, n) for _ in range(
            (6 if ctype == b"IDAT" else 2) if n else 0)]
        if ctype == b"IDAT":
            spots += [at + 8 + n - 1 - r.randint(0, 4), at + 8]
    p = str(tmp_path / "d.png")
    for at in spots:
        for x in (1, 0x80, int(r.randint(1, 256))):
            out = bytearray(blob)
            out[at] ^= x
            with open(p, "wb") as f:
                f.write(bytes(out))
            same(p)


def test_png_stream_ending_early_and_overlong_equal_pillow(tmp_path):
    """A zlib stream that ends cleanly at a row before the image does
    (Pillow leaves the rest zero), one that ends inside a row (refused),
    one longer than the image (the rest unread), and a palette shorter
    than its indices (black past its end)."""
    import zlib

    def png(w, h, ctype, raw, plte=None):
        def chunk(t, d):
            return (struct.pack(">I", len(d)) + t + d
                    + struct.pack(">I", zlib.crc32(t + d) & 0xFFFFFFFF))
        out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
            ">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
        if plte:
            out += chunk(b"PLTE", plte)
        return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")
    p = str(tmp_path / "s.png")
    for blob, reads in ((png(2, 3, 0, b"\x00\x05\x06"), True),
                        (png(2, 3, 0, b"\x00\x05\x06\x00\x07"), False),
                        (png(2, 1, 0, b"\x00\x05\x06\x00\x07\x08"), True),
                        (png(4, 1, 3, b"\x00\x00\x01\x02\x05",
                             bytes(range(6))), True)):
        with open(p, "wb") as f:
            f.write(blob)
        assert same(p) == reads


@pytest.mark.parametrize("kind", ["lossy", "lossless", "alpha"])
def test_webp_damage_equals_pillow(tmp_path, kind):
    """40 seeds of single-byte damage after the RIFF header."""
    im = Image.fromarray(_photo(48, 64, 3, noise=20))
    if kind == "alpha":
        im = im.convert("RGBA")
    b = io.BytesIO()
    im.save(b, "WEBP", quality=80, lossless=kind == "lossless")
    blob = b.getvalue()
    p = str(tmp_path / "d.webp")
    for seed in range(40):
        with open(p, "wb") as f:
            f.write(xor_one(blob, seed, 12, len(blob)))
        same(p)


def _probe_rows():
    """The probe that found the port refusing files Pillow reads: each row
    -> (bytes, file suffix, whether Pillow reads it)."""
    base, prog = source("baseline"), source("progressive")
    rst = source("restart 4")
    s0 = scan_start(base)
    one = [i for i in range(scan_start(rst), len(rst) - 1)
           if rst[i:i + 2] == b"\xff\xd1"][0]
    dc_end = prog.index(b"\xff\xda", prog.index(b"\xff\xda") + 2)
    png = _png("RGB", 2)
    idat = [at for t, at, n in _png_chunks(png) if t == b"IDAT"][0]
    n_idat = struct.unpack(">I", png[idat:idat + 4])[0]

    def flip(blob, at):
        out = bytearray(blob)
        out[at] ^= 0x5A
        return bytes(out)
    webp = io.BytesIO()
    Image.fromarray(PHOTO).save(webp, "WEBP", quality=80)
    webp = webp.getvalue()
    lossless = io.BytesIO()
    Image.fromarray(PHOTO).save(lossless, "WEBP", lossless=True)
    lossless = lossless.getvalue()
    return {
        "baseline, one byte of data XORed": (flip(base, s0 + 500), "jpg",
                                             True),
        "restart markers, one byte XORed": (flip(rst, scan_start(rst) + 300),
                                            "jpg", True),
        "progressive, one byte XORed": (flip(prog, dc_end + 300), "jpg",
                                        True),
        "scan cut short, EOI appended": (base[:s0 + 150] + b"\xff\xd9",
                                         "jpg", True),
        "RST1 rewritten as RST3": (rst[:one + 1] + b"\xd3" + rst[one + 2:],
                                   "jpg", True),
        "progressive, DC scan only, then EOI": (prog[:dc_end] + b"\xff\xd9",
                                                "jpg", True),
        "PNG, IDAT's CRC wrong": (flip(png, idat + 8 + n_idat), "png", True),
        "PNG, IHDR's CRC wrong": (flip(png, 8 + 8 + 13), "png", False),
        "PNG, zlib's check wrong": (flip(png, idat + 8 + n_idat - 1), "png",
                                    False),
        "baseline cut mid-scan, no EOI": (base[:s0 + 150], "jpg", False),
        "progressive cut mid-scan, no EOI": (prog[:dc_end + 150], "jpg",
                                             False),
        "lossy WebP, byte at 50 % XORed": (flip(webp, len(webp) // 2),
                                           "webp", True),
        "lossless WebP, one byte XORed": (_first(
            lossless, _refused, 12, len(lossless)), "webp", False),
    }


@pytest.mark.parametrize("row", list(_probe_rows()))
def test_probe_rows_equal_pillow(tmp_path, row):
    blob, suffix, reads = _probe_rows()[row]
    p = str(tmp_path / f"x.{suffix}")
    with open(p, "wb") as f:
        f.write(blob)
    assert same(p) == reads


# ------------------------------------------------------------- fixtures


def make_fixtures():
    """The damaged fixtures, readable ones in DAMAGED and refused ones in
    REFUSED: each kind of damage this loader recovers from, at sizes prep
    keeps; one file above 64 KiB; one file of each kind ROADMAP item 18
    left (arithmetic-coded sequential and progressive JPEG, lossless JPEG,
    a float PNM, a 4-bit BMP with a grey palette)."""
    for d in (DAMAGED, REFUSED):
        os.makedirs(d, exist_ok=True)
    files, refused = {}, {}
    img = _photo(144, 176, 31, noise=6)
    clean = lambda b: np.asarray(Image.open(io.BytesIO(b)).convert("RGB"))  # noqa: E731
    base = jpeg_bytes(img, quality=85)
    files["a_baseline_damaged.jpg"] = _first(
        base, lambda d: _visible(d, clean(base)), scan_start(base),
        len(base) - 2)
    rst = jpeg_bytes(img, quality=85, restart_marker_blocks=4)
    files["b_restart_damaged.jpg"] = _first(
        rst, lambda d: _visible(d, clean(rst)), scan_start(rst),
        len(rst) - 2)
    prog = jpeg_bytes(img, quality=85, progressive=True)
    files["c_progressive_damaged.jpg"] = _first(
        prog, lambda d: _visible(d, clean(prog)), scan_start(prog),
        len(prog) - 2)
    big = jpeg_bytes(_photo_textured(768, 1024, 32), quality=75)
    assert (1 << 16) < len(big) <= 120_000, len(big)
    files["d_large_damaged.jpg"] = _first(
        big, lambda d: _visible(d, clean(big)), (1 << 16) - 64,
        (1 << 16) + 64)
    s0 = scan_start(base)
    files["e_cut_with_eoi.jpg"] = base[:s0 + len(base) // 3] + b"\xff\xd9"
    one = [i for i in range(scan_start(rst), len(rst) - 1)
           if rst[i:i + 2] == b"\xff\xd1"][0]
    files["f_wrong_rst.jpg"] = rst[:one + 1] + b"\xd3" + rst[one + 2:]
    dc_end = prog.index(b"\xff\xda", prog.index(b"\xff\xda") + 2)
    files["g_prog_dc_only.jpg"] = prog[:dc_end] + b"\xff\xd9"
    comps = SAMPLINGS["4:2:0"]
    w, h = 150, 130
    files["h_prog_al1.jpg"] = encode_progressive(
        w, h, comps, _big_coefs(comps, w, h, 3), QTS,
        _smoothing_scripts(3)["Al = 1 left"])
    cf = _big_coefs(comps, w, h, 4)
    cf[0][3, 5, 0] = 2000
    cf[0][6, 9, 0] = -1500
    files["i_out_of_range.jpg"] = encode(w, h, comps, cf, QTS)
    png = io.BytesIO()
    Image.fromarray(_photo(120, 136, 33, noise=6)).save(png, "PNG")
    png = png.getvalue()
    idat = [at for t, at, n in _png_chunks(png) if t == b"IDAT"][0]
    n = struct.unpack(">I", png[idat:idat + 4])[0]
    out = bytearray(png)
    out[idat + 8 + n] ^= 0xFF                # the IDAT chunk's CRC
    files["j_png_bad_idat_crc.png"] = bytes(out)
    from test_torch_port_jpeg_arith import encode_arith
    from test_torch_port_jpeg_lossless import encode_lossless
    from test_torch_port_jpeg_progressive import _script
    cf = _big_coefs(comps, w, h, 5)
    files["k_arith_sequential.jpg"] = encode_arith(
        w, h, comps, cf, QTS, restart=6, dac={0: (1, 4, 9), 1: (0, 1, 5)})
    files["l_arith_progressive.jpg"] = encode_arith(
        w, h, comps, cf, QTS, _script(3, "libjpeg"))
    photo = _photo(130, 150, 34, noise=4)
    files["m_lossless.jpg"] = encode_lossless(
        [photo[..., c] for c in range(3)], [(1, 1)] * 3, psv=6, pt=1,
        restart=2 * 150)
    grey = _photo(120, 136, 35, noise=4)[..., 1].astype(np.float32)
    files["n_float.ppm"] = b"Pf\n136 120\n-1.0\n" + (
        grey[::-1] * 1.37 - 20.25).astype("<f4").tobytes()
    idx = _photo(120, 136, 36, noise=4)[..., 0] // 16
    rows = (idx[::-1, 0::2] << 4 | idx[::-1, 1::2]).astype(np.uint8)
    pal = b"".join(bytes([i, i, i, 0]) for i in range(16))
    info = struct.pack("<IiiHHIIiiII", 40, 136, 120, 1, 4, 0, rows.size, 0,
                       0, 16, 0)
    files["o_bmp_grey_palette_4bit.bmp"] = (
        b"BM" + struct.pack("<IHHI", 14 + 40 + 64 + rows.size, 0, 0,
                            14 + 40 + 64) + info + pal + rows.tobytes())
    refused["cut_no_eoi.jpg"] = base[:s0 + len(base) // 3]
    big_cf = _big_coefs([(1, 1, 0)] * 3, 256, 256, 6)
    for c in big_cf:
        c[..., 1:40] += np.random.RandomState(7).randint(-30, 30,
                                                         c[..., 1:40].shape)
    refused["arith_past_64k.jpg"] = encode_arith(256, 256, [(1, 1, 0)] * 3,
                                                 big_cf, QTS)
    refused["progressive_refused.jpg"] = _first(
        prog, _refused, scan_start(prog), len(prog) - 2)
    refused["marker_in_data.jpg"] = base[:s0 + 200] + b"\xff\x46" + base[
        s0 + 202:]
    out = bytearray(png)
    out[8 + 8 + 13] ^= 1                     # IHDR's CRC
    refused["png_bad_ihdr_crc.png"] = bytes(out)
    out = bytearray(png)
    out[idat + 8 + n - 1] ^= 1               # zlib's check
    refused["png_bad_adler.png"] = bytes(out)
    lossless = io.BytesIO()
    Image.fromarray(img).save(lossless, "WEBP", lossless=True)
    refused["lossless_damaged.webp"] = _first(
        lossless.getvalue(), _refused, 12, len(lossless.getvalue()))
    for d, group in ((DAMAGED, files), (REFUSED, refused)):
        for name, blob in group.items():
            assert len(blob) <= 120_000, (name, len(blob))
            with open(os.path.join(d, name), "wb") as f:
                f.write(blob)


def _entry(p):
    """Pillow's mode, size and pixel digest of a file, or its refusal."""
    try:
        with Image.open(p) as im:
            return {"mode": im.mode, "size": list(im.size[::-1]),
                    "sha256": digest(np.asarray(im.convert("RGB")))}
    except Exception as e:
        msg = str(e).replace(p, os.path.basename(p))
        return {"refused": f"{type(e).__name__}: {msg}"}


def expected_now(tmp):
    """expected.json's content as Pillow and the JAX pipeline give it."""
    from l3c_tpu.cli import prep_pipeline as jpipe
    files = {n: _entry(os.path.join(DAMAGED, n))
             for n in sorted(os.listdir(DAMAGED)) if n != "expected.json"}
    refused = {n: _entry(os.path.join(REFUSED, n))
               for n in sorted(os.listdir(REFUSED))}
    out = os.path.join(tmp, "jax_out")
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        assert jpipe.main(["--inp_dir", DAMAGED, out, "--min_res",
                           str(MIN_RES)]) == 0
    prep = {sub: {n: digest(jimages.load_image_uint8(os.path.join(out, sub,
                                                                  n)))
                  for n in sorted(os.listdir(os.path.join(out, sub)))}
            for sub in ("train", "val")}
    return {"min_res": MIN_RES, "files": files, "refused": refused,
            "prep": prep, "rate": rate_copies()}


RATE_SOURCES = ("rate/p_1024x768_q90.jpg",
                "formats_rate/r_prog_1024x768_q90.jpg")


def rate_copies():
    """The damaged copies of the 1024 x 768 rate fixtures chip_smoke.py
    times beside the clean ones: the first seeded byte of the scans whose
    XOR Pillow reads, visibly -> where, with what, and Pillow's pixels."""
    out = {}
    for rel in RATE_SOURCES:
        blob = open(os.path.join(FIXTURES, rel), "rb").read()
        with Image.open(io.BytesIO(blob)) as im:
            clean = np.asarray(im.convert("RGB"))
        for seed in range(500):
            r = np.random.RandomState(seed)
            at = int(r.randint(scan_start(blob), len(blob) - 2))
            x = int(r.randint(1, 256))
            d = bytearray(blob)
            d[at] ^= x
            if _visible(bytes(d), clean):
                with Image.open(io.BytesIO(bytes(d))) as im:
                    out[rel] = {"at": at, "xor": x,
                                "size": list(im.size[::-1]),
                                "sha256": digest(np.asarray(
                                    im.convert("RGB")))}
                break
    return out


def _expected():
    with open(os.path.join(DAMAGED, "expected.json")) as f:
        return json.load(f)


def test_damaged_expected_json_equals_pillow_and_jax_now(tmp_path):
    want = _expected()
    got = expected_now(str(tmp_path))
    assert got == {k: want[k] for k in got}
    assert all("refused" not in e for e in want["files"].values())
    assert all("refused" in e for e in want["refused"].values())
    sizes = {n: os.path.getsize(os.path.join(d, n))
             for d in (DAMAGED, REFUSED) for n in os.listdir(d)}
    assert max(sizes.values()) <= 120_000
    assert os.path.getsize(os.path.join(DAMAGED,
                                        "d_large_damaged.jpg")) > 1 << 16


def test_port_decodes_the_damaged_fixtures_as_expected():
    exp = _expected()
    for rel, e in exp["rate"].items():
        blob = bytearray(open(os.path.join(FIXTURES, rel), "rb").read())
        blob[e["at"]] ^= e["xor"]
        assert digest(jpeg.decode_jpeg(bytes(blob))) == e["sha256"], rel
    for n, e in exp["files"].items():
        p = os.path.join(DAMAGED, n)
        assert timages.image_mode(p) == e["mode"], n
        assert list(timages.image_size(p)) == e["size"], n
        assert digest(timages.load_image_uint8(p)) == e["sha256"], n
    for n in exp["refused"]:
        with pytest.raises(ValueError):
            timages.load_image_uint8(os.path.join(REFUSED, n))


def test_prep_pipeline_over_the_damaged_gives_jax_outputs(tmp_path):
    """cli.prep_pipeline --inp_dir keeps what the JAX pipeline keeps of
    the damaged files (it reads them all), with its pixels."""
    from l3c_torch.cli import prep_pipeline as tpipe
    out = str(tmp_path / "t")
    assert tpipe.main(["--inp_dir", DAMAGED, out, "--min_res",
                       str(MIN_RES)]) == 0
    got = {sub: {n: digest(timages.load_image_uint8(os.path.join(out, sub,
                                                                 n)))
                 for n in sorted(os.listdir(os.path.join(out, sub)))}
           for sub in ("train", "val")}
    assert got == _expected()["prep"]


def test_idct_counts_the_out_of_range_fixture():
    """The inverse DCT's counter sees the out-of-range fixture's blocks
    (phase synth on the card prints it)."""
    before = jpeg.COUNTS["saturated_blocks"]
    timages.load_image_uint8(os.path.join(DAMAGED, "i_out_of_range.jpg"))
    assert jpeg.COUNTS["saturated_blocks"] > before


def _versions():
    return {"pillow": PIL.__version__,
            "libjpeg_turbo": PIL.features.version_feature("libjpeg_turbo"),
            "libwebp": PIL.features.version("webp"),
            "zlib": PIL.features.version("zlib")}


if __name__ == "__main__":
    import tempfile
    for d in (DAMAGED, REFUSED):
        for n in os.listdir(d) if os.path.isdir(d) else ():
            os.remove(os.path.join(d, n))
    make_fixtures()
    with tempfile.TemporaryDirectory() as tmp:
        exp = {**expected_now(tmp), "made_by": _versions()}
    with open(os.path.join(DAMAGED, "expected.json"), "w") as f:
        json.dump(exp, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {len(exp['files'])} + {len(exp['refused'])} fixtures and "
          f"expected.json to {DAMAGED} and {REFUSED}")
