"""The TIFF codecs and photometrics data/tiff.py reads beyond the basic ones
(none, LZW, Deflate, PackBits, JPEG), against Pillow (libtiff 4.7 underneath):

- LZMA and ZSTD (Pillow's files: RGB, L, I;16 and F, with the horizontal
  predictor and, for floats, the floating-point one; a big-endian float
  file a test-only writer predicts);
- old-style LSB-first LZW (libtiff's compat decoder; a test-only
  encoder), ThunderScan (a test-only encoder of runs, 2- and 3-bit
  deltas and raw samples; random byte streams read or refused alike);
- YCbCr without JPEG: Pillow's LZW files, hand-made ones at every
  subsampling libtiff's RGBA reader takes, at sizes that cut blocks,
  with ReferenceBlackWhite and YCbCrCoefficients, and an uncompressed
  one (Pillow's RGBX reading, short data refused by both);
- 12-bit grey (I;12), raw, LZW, Deflate and JPEG (libtiff's 12-bit JPEG
  codec, files written by Pillow's bundled libtiff through ctypes);
- old-style JPEG (6): JPEGInterchangeFormat streams and streams made from
  the JPEGQTables / DCTables / ACTables tags, 4:4:4, 4:2:2 and 4:2:0 at
  sizes that cut MCUs, restart intervals, a YCbCrSubSampling tag that
  disagrees with the stream (the stream wins), a truncated stream
  refused by both;
- CCITT RLEW (32771: Modified Huffman rows on 16-bit words);
  uncompressed YCbCr planar and tiled, as Pillow's raw reader takes them;
- what Pillow refuses: WebP (this libtiff lacks it), LogL / LogLuv
  (SGILog, no Pillow mode; SGILog of other photometrics, which libtiff
  refuses), CCITT and ThunderScan at other bit depths;
- CIELAB (8-bit LAB), converted as Pillow converts it through
  LittleCMS, and that conversion on a grid of inputs;
every pixel equal to Pillow's convert("RGB") and to the JAX loader, and
format, mode and size from the header equal to Pillow's.
"""
import io
import os
import struct
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from l3c_tpu.data import images as jimages
from l3c_torch.data import images as timages

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_gif import check  # noqa: E402
from test_torch_port_tiff import lzw_encode, make_tiff  # noqa: E402

torch.set_num_threads(1)


def _write(tmp_path, name, blob):
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(blob)
    return p


def _rgb(h, w, seed):
    r = np.random.RandomState(seed)
    return (np.cumsum(r.randint(0, 9, (h, w, 3)), 1) % 256).astype(np.uint8)


def refused_by_both(p, match=None):
    with pytest.raises(ValueError, match=match):
        timages.load_image_uint8(p)
    with pytest.raises(Exception):
        jimages.load_image_uint8(p)


def with_tags(blob: bytes, extra: dict) -> bytes:
    """A little-endian classic TIFF with (tag: (type, values)) appended to
    its first directory (rewritten after the file's end)."""
    ifd = struct.unpack("<I", blob[4:8])[0]
    n = struct.unpack("<H", blob[ifd:ifd + 2])[0]
    entries = [blob[ifd + 2 + 12 * i:ifd + 14 + 12 * i] for i in range(n)]
    tail = bytearray()
    base = len(blob)
    new = {}
    for tag, (typ, vals) in extra.items():
        code = {3: "H", 4: "I", 5: "II"}[typ]
        flat = [x for v in vals for x in (v if typ == 5 else (v,))]
        payload = struct.pack("<" + code[0] * len(flat), *flat)
        if len(payload) <= 4:
            val = payload.ljust(4, b"\0")
        else:
            val = struct.pack("<I", base + len(tail))
            tail += payload
        new[tag] = struct.pack("<HHI", tag, typ, len(vals)) + val
    for e in entries:
        new.setdefault(struct.unpack("<H", e[:2])[0], e)
    ifd_at = base + len(tail)
    body = struct.pack("<H", len(new)) + b"".join(new[t] for t in
                                                  sorted(new)) + bytes(4)
    out = bytearray(blob) + tail + body
    out[4:8] = struct.pack("<I", ifd_at)
    return bytes(out)


# ----------------------------------------------------------- LZMA, ZSTD

def _pillow(img, mode, compression, predictor=1):
    if mode == "I;16":
        im = Image.fromarray(img[..., 0].astype(np.uint16) * 257)
    elif mode == "F":
        im = Image.fromarray(img[..., 0].astype(np.float32) * 1.3 - 20)
    else:
        im = Image.fromarray(img).convert(mode)
    f = io.BytesIO()
    im.save(f, "TIFF", compression=compression,
            tiffinfo={317: predictor} if predictor > 1 else {})
    return f.getvalue()


@pytest.mark.parametrize("compression", ["lzma", "zstd"])
@pytest.mark.parametrize("mode, predictor", [("RGB", 1), ("RGB", 2),
                                             ("L", 1), ("L", 2),
                                             ("I;16", 2), ("F", 1),
                                             ("F", 3)])
def test_lzma_zstd_equal_pillow(tmp_path, compression, mode, predictor):
    p = _write(tmp_path, "x.tif", _pillow(_rgb(23, 37, 1), mode,
                                          compression, predictor))
    check(p)


def _oversized_block() -> bytes:
    """A frame whose one compressed block expands to 6.5 MB, past the
    largest block."""
    head = (0xFD2FB528).to_bytes(4, "little") + bytes([0, 7 << 3])
    body = b"\x00" + bytes([100, 0x54, 0, 2, 52]) + bytes(225) + b"\x01"
    return head + ((1 << 3) | 0).to_bytes(3, "little") + b"a" \
        + ((len(body) << 3) | 5).to_bytes(3, "little") + body


def test_zstd_strips_read_as_libtiff_reads_them(tmp_path):
    """libtiff's ZSTDDecode streams one frame into the strip's bytes: a
    frame longer than its strip is read as far as the strip goes (a wrong
    checksum past it unread), bytes after the frame are ignored; a wrong
    checksum within the strip, a second frame or a skippable one first,
    and a block past the largest size are refused."""
    from test_torch_port_zstd import _LIB, compress
    if _LIB is None:
        pytest.skip("libzstd not found")
    img = _rgb(8, 16, 4)[..., :1]
    raw = img.tobytes()
    more = raw + bytes(range(256)) * 2

    def strip(name, chunk):
        return _write(tmp_path, name, make_tiff(
            img, photo=1, bits=8, comp=50000, jpeg_chunks=[chunk]))

    bad = bytearray(compress(more, 3, checksum=True))
    bad[-1] ^= 1
    check(strip("longer.tif", compress(more, 3)))
    check(strip("longer_bad_sum.tif", bytes(bad)))
    check(strip("junk.tif", compress(raw, 3) + b"junkjunk"))
    bad = bytearray(compress(raw, 3, checksum=True))
    bad[-1] ^= 1
    refused_by_both(strip("bad_sum.tif", bytes(bad)), "checksum")
    refused_by_both(strip("two.tif", compress(raw[:64], 3)
                          + compress(raw[64:], 3)), "truncated")
    skip = (0x184D2A50).to_bytes(4, "little") + (4).to_bytes(4, "little")
    refused_by_both(strip("skip.tif", skip + b"abcd" + compress(raw, 3)),
                    "truncated")
    refused_by_both(strip("huge.tif", _oversized_block()), "largest")


@pytest.mark.parametrize("compression", ["tiff_adobe_deflate", "tiff_lzw"])
def test_float_predictor_equals_pillow(tmp_path, compression):
    check(_write(tmp_path, "x.tif", _pillow(_rgb(9, 31, 2), "F",
                                            compression, 3)))


def _fp_predict(v: np.ndarray) -> bytes:
    """The floating-point predictor's encoding of (rows, cols) floats:
    each row's bytes split into planes, most significant first, then
    differenced byte by byte."""
    out = bytearray()
    nb = v.dtype.itemsize
    for row in v.astype(">f%d" % nb):
        b = np.frombuffer(row.tobytes(), np.uint8).reshape(-1, nb)
        planes = b.T.ravel().astype(np.int64)
        d = planes.copy()
        d[1:] = planes[1:] - planes[:-1]
        out += (d % 256).astype(np.uint8).tobytes()
    return bytes(out)


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("bits", [32, 64])
def test_float_predictor_either_byte_order(tmp_path, order, bits):
    v = np.random.RandomState(bits).rand(7, 11) * 300 - 10
    s = v.astype(np.float64 if bits == 64 else np.float32)[..., None]
    blob = make_tiff(s, photo=1, bits=bits, order=order, comp=8, fmt=3,
                     jpeg_chunks=[zlib.compress(_fp_predict(s[..., 0]))])
    p = _write(tmp_path, "x.tif", _set_predictor(blob, order, 3))
    if bits == 64:              # Pillow has no mode for 64-bit floats
        refused_by_both(p)
        return
    check(p)


def _set_predictor(blob: bytes, order: str, pred: int) -> bytes:
    """The directory's Predictor entry added (make_tiff writes it only
    with its own predictor)."""
    ifd = struct.unpack(order + "I", blob[4:8])[0]
    n = struct.unpack(order + "H", blob[ifd:ifd + 2])[0]
    entries = [blob[ifd + 2 + 12 * i:ifd + 14 + 12 * i] for i in range(n)]
    entries.append(struct.pack(order + "HHIHH", 317, 3, 1, pred, 0))
    entries.sort(key=lambda e: struct.unpack(order + "H", e[:2])[0])
    body = struct.pack(order + "H", len(entries)) + b"".join(entries) + \
        bytes(4)
    out = bytearray(blob) + body
    out[4:8] = struct.pack(order + "I", len(blob))
    return bytes(out)


# ----------------------------------------------- old-style LZW, ThunderScan

def lzw_compat_encode(data: bytes) -> bytes:
    """Old-style TIFF LZW: codes LSB first, a clear code first; the code
    width grows once the decoder's next free entry passes 2^n - 1."""
    out, acc, nacc = bytearray(), 0, 0

    def emit(code, size):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += size
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8

    table = {bytes([v]): v for v in range(256)}
    size, nxt, dec = 9, 258, 258
    emit(256, 9)
    w = b""
    first = True
    for v in data:
        wc = w + bytes([v])
        if wc in table:
            w = wc
            continue
        emit(table[w], size)
        if not first:
            dec += 1                 # the decoder's entry for this code
            if dec > (1 << size) - 1:
                size += 1
        first = False
        table[wc] = nxt
        nxt += 1
        w = bytes([v])
        if nxt >= 4000:
            emit(table[w], size)
            emit(256, size)
            table = {bytes([x]): x for x in range(256)}
            size, nxt, dec, w, first = 9, 258, 258, b"", True
    if w:
        emit(table[w], size)
        if not first:
            dec += 1
            if dec > (1 << size) - 1:
                size += 1
    emit(257, size)
    if nacc:
        out.append(acc & 255)
    return bytes(out)


@pytest.mark.parametrize("hw", [(9, 13), (64, 200)])
def test_old_style_lzw_equals_pillow(tmp_path, hw):
    img = _rgb(*hw, 3)
    blob = make_tiff(img, photo=2, bits=8, comp=5,
                     jpeg_chunks=[lzw_compat_encode(img.tobytes())])
    check(_write(tmp_path, "x.tif", blob))


def thunder_rows(r, h, w):
    """ThunderScan bytes for h rows of w 4-bit samples."""
    out = bytearray()
    for _ in range(h):
        left, last = w, 0
        while left > 0:
            k = r.randint(4)
            if k == 0 or left < 3:
                v = r.randint(16)
                out.append(0xC0 | v)
                last, left = v, left - 1
            elif k == 1:
                n = r.randint(1, min(left, 63) + 1)
                out.append(n)
                left -= n
            elif k == 2:
                ds = [r.choice([0, 1, 3]) for _ in range(3)]
                out.append(0x40 | ds[0] << 4 | ds[1] << 2 | ds[2])
                left -= 3
            else:
                ds = [r.choice([0, 1, 2, 3, 5, 6, 7]) for _ in range(2)]
                out.append(0x80 | ds[0] << 3 | ds[1])
                left -= 2
    return bytes(out)


@pytest.mark.parametrize("seed", range(6))
def test_thunderscan_equals_pillow(tmp_path, seed):
    r = np.random.RandomState(seed)
    h, w = r.randint(1, 9), r.randint(1, 45)
    blob = make_tiff(np.zeros((h, w, 1), np.uint8), photo=1, bits=4,
                     comp=32809, jpeg_chunks=[thunder_rows(r, h, w)])
    check(_write(tmp_path, "x.tif", blob))
    junk = bytes(r.randint(0, 256, 40).astype(np.uint8))
    p = _write(tmp_path, "j.tif", make_tiff(
        np.zeros((h, w, 1), np.uint8), photo=1, bits=4, comp=32809,
        jpeg_chunks=[junk]))
    try:
        with Image.open(p) as im:
            im.convert("RGB")
    except OSError:
        refused_by_both(p)
    else:
        check(p)


# ------------------------------------------------------------ YCbCr

def ycc_blocks(img, h, v):
    H, W, _ = img.shape
    bx, by = -(-W // h), -(-H // v)
    pad = np.zeros((by * v, bx * h, 3), np.uint8)
    pad[:H, :W] = img
    out = bytearray()
    for j in range(by):
        for i in range(bx):
            blk = pad[j * v:(j + 1) * v, i * h:(i + 1) * h]
            out += blk[..., 0].tobytes() + bytes([blk[0, 0, 1],
                                                  blk[0, 0, 2]])
    return bytes(out)


@pytest.mark.parametrize("sub", [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1),
                                 (4, 2), (4, 4)])
@pytest.mark.parametrize("hw", [(16, 24), (13, 17), (1, 5)])
def test_ycbcr_subsampled_equals_pillow(tmp_path, sub, hw):
    img = np.random.RandomState(sum(sub) + hw[0]).randint(
        0, 256, hw + (3,)).astype(np.uint8)
    blob = make_tiff(np.zeros(hw + (3,), np.uint8), photo=6, bits=8,
                     comp=8, jpeg_chunks=[zlib.compress(ycc_blocks(
                         img, *sub))], ycbcr=sub)
    check(_write(tmp_path, "x.tif", blob))


def test_ycbcr_tags_and_pillows_files(tmp_path):
    img = _rgb(12, 20, 4)
    f = io.BytesIO()
    Image.fromarray(img).convert("YCbCr").save(f, "TIFF",
                                               compression="tiff_lzw")
    check(_write(tmp_path, "p.tif", f.getvalue()))
    f = io.BytesIO()
    Image.fromarray(img).convert("YCbCr").save(
        f, "TIFF", compression="tiff_lzw", tiffinfo={317: 2})
    check(_write(tmp_path, "q.tif", f.getvalue()))
    raw = np.random.RandomState(5).randint(0, 256, (12, 20, 3)).astype(
        np.uint8)
    blob = make_tiff(np.zeros((12, 20, 3), np.uint8), photo=6, bits=8,
                     comp=5, jpeg_chunks=[lzw_encode(ycc_blocks(raw, 2, 2))],
                     ycbcr=(2, 2))
    for tags in ({532: (5, [(16, 1), (235, 1), (128, 1), (240, 1),
                            (128, 1), (240, 1)])},
                 {529: (5, [(2126, 10000), (7152, 10000), (722, 10000)])},
                 {529: (5, [(299, 1000), (587, 1000), (114, 1000)]),
                  532: (5, [(0, 1), (255, 1), (100, 1), (200, 1),
                            (30, 1), (250, 1)])}):
        check(_write(tmp_path, "t.tif", with_tags(blob, tags)))


def test_uncompressed_ycbcr_as_pillow_reads_it(tmp_path):
    """Pillow reads an uncompressed YCbCr TIFF with its own RGBX raw mode:
    a Pillow-written one is too short for it (both refuse), a file with
    four bytes a pixel reads as their first three."""
    img = _rgb(8, 10, 6)
    f = io.BytesIO()
    Image.fromarray(img).convert("YCbCr").save(f, "TIFF")
    refused_by_both(_write(tmp_path, "p.tif", f.getvalue()))
    quad = np.random.RandomState(6).randint(0, 256, (8, 10, 4)).astype(
        np.uint8)
    blob = make_tiff(np.zeros((8, 10, 3), np.uint8), photo=6, bits=8,
                     jpeg_chunks=[quad.tobytes()], ycbcr=(1, 1))
    check(_write(tmp_path, "q.tif", blob))


# ----------------------------------------------------------- 12-bit grey

def _pack12(v: np.ndarray) -> bytes:
    out = bytearray()
    for row in v:
        bits = ((row[:, None] >> np.arange(11, -1, -1)) & 1).ravel()
        out += np.packbits(bits).tobytes()
    return bytes(out)


@pytest.mark.parametrize("comp", [1, 5, 8])
@pytest.mark.parametrize("w", [7, 8])
def test_twelve_bit_grey_equals_pillow(tmp_path, comp, w):
    v = np.random.RandomState(w).randint(0, 4096, (5, w)) // (
        1 if comp == 1 else 16)
    data = _pack12(v)
    chunk = {1: data, 5: lzw_encode(data), 8: zlib.compress(data)}[comp]
    blob = make_tiff(np.zeros((5, w, 1), np.uint8), photo=1, bits=12,
                     comp=comp, jpeg_chunks=[chunk])
    check(_write(tmp_path, "x.tif", blob))


def _as_12_bit(jb, marker):
    """`jb` with its frame header turned into `marker` at 12 bits."""
    i = jb.index(b"\xff" + bytes([marker if marker == 0xC3 else 0xC0]))
    b = bytearray(jb)
    b[i + 1], b[i + 4] = marker, 12
    return bytes(b)


def test_jpeg12_lossless_and_wrong_streams_as_pillow(tmp_path):
    """A lossless 12-bit stream in a 12-bit grey TIFF decodes as Pillow
    decodes it (an even width: at an odd one libtiff leaves the last
    sample of each row unwritten, and Pillow shows whatever its buffer
    held); a three-component one is refused by both (libtiff: Improper
    JPEG component count)."""
    from test_torch_port_jpeg import QTS, _coefs, encode
    from test_torch_port_jpeg_lossless import encode_lossless
    r = np.random.RandomState(14)
    h, w = 16, 22
    for psv in (1, 4, 7):
        jl = encode_lossless([r.randint(0, 256, (h, w))], [(1, 1)], psv=psv)
        check(_write(tmp_path, f"l{psv}.tif", make_tiff(
            np.zeros((h, w, 1), np.uint8), photo=1, bits=12, comp=7,
            jpeg_chunks=[_as_12_bit(jl, 0xC3)])))
    comps = [(1, 1, 0), (1, 1, 1), (1, 1, 1)]
    jb = _as_12_bit(encode(w, h, comps, _coefs(comps, w, h, 3), QTS), 0xC1)
    refused_by_both(_write(tmp_path, "c.tif", make_tiff(
        np.zeros((h, w, 1), np.uint8), photo=1, bits=12, comp=7,
        jpeg_chunks=[jb])), "Improper JPEG component count")


@pytest.mark.parametrize("comp", [9, 32766, 32908, 34712, 50002])
def test_compression_pillow_has_no_codec_for_is_refused_at_open(tmp_path,
                                                                comp):
    p = _write(tmp_path, "u.tif", make_tiff(
        np.zeros((4, 6, 1), np.uint8), photo=1, bits=8, comp=comp,
        jpeg_chunks=[bytes(24)]))
    with pytest.raises(Exception):
        Image.open(p)
    with pytest.raises(ValueError, match="Pillow has no codec"):
        timages.image_mode(p)
    refused_by_both(p)


# ------------------------------------------------------ old-style JPEG

def _jpeg(img, subsampling="4:2:0", **kw):
    f = io.BytesIO()
    Image.fromarray(img).save(f, "JPEG", quality=85, subsampling=subsampling,
                              **kw)
    return f.getvalue()


def ojpeg_interchange(img, jb, sub=(2, 2)):
    """Compression 6 with JPEGInterchangeFormat pointing at the whole JPEG
    stream, which is also the one strip."""
    return ojpeg_file(jb, *img.shape[:2], sub=sub)


def _split_jpeg(jb):
    """(quantisation tables, DC tables, AC tables by id, the scan's entropy
    data, the restart interval) of a baseline JPEG."""
    at, q, dc, ac, restart = 2, {}, {}, {}, 0
    while True:
        m = jb[at + 1]
        n = struct.unpack(">H", jb[at + 2:at + 4])[0]
        seg = jb[at + 4:at + 2 + n]
        k = 0
        if m == 0xDB:
            while k < len(seg):
                q[seg[k] & 15] = seg[k + 1:k + 65]
                k += 65
        elif m == 0xC4:
            while k < len(seg):
                nv = sum(seg[k + 1:k + 17])
                (dc if seg[k] >> 4 == 0 else ac)[seg[k] & 15] = \
                    seg[k + 1:k + 17 + nv]
                k += 17 + nv
        elif m == 0xDD:
            restart = struct.unpack(">H", seg[:2])[0]
        elif m == 0xDA:
            data = jb[at + 2 + n:]
            return q, dc, ac, data[:data.rfind(b"\xff\xd9")], restart
        at += 2 + n


def ojpeg_tables(img, jb, sub=(2, 2), spp=3, photo=6, planar=1):
    """Compression 6 without JPEGInterchangeFormat: the tables in the
    JPEGQTables / DCTables / ACTables tags, the strip only entropy data."""
    h, w = img.shape[:2]
    q, dc, ac, data, restart = _split_jpeg(jb)
    blob = make_tiff(np.zeros((h, w, spp), np.uint8), photo=photo, bits=8,
                     comp=6, jpeg_chunks=[data], ycbcr=sub, planar=planar)
    area, offs = bytearray(), {}
    for name, d in (("q", q), ("dc", dc), ("ac", ac)):
        for k, v in d.items():
            offs[name, k] = len(blob) + len(area)
            area += v
    tags = {512: (3, [1])}
    for tag, name in ((519, "q"), (520, "dc"), (521, "ac")):
        tags[tag] = (4, [offs[name, 0]] + [offs.get((name, 1), 0)] * (spp - 1))
    if restart:
        tags[515] = (3, [restart])
    return with_tags(blob + bytes(area), tags)


@pytest.mark.parametrize("subsampling, sub", [("4:4:4", (1, 1)),
                                              ("4:2:2", (2, 1)),
                                              ("4:2:0", (2, 2))])
@pytest.mark.parametrize("hw", [(32, 48), (13, 21)])
@pytest.mark.parametrize("make", [ojpeg_interchange, ojpeg_tables])
def test_old_style_jpeg_equals_pillow(tmp_path, subsampling, sub, hw, make):
    img = _rgb(*hw, sum(hw))
    check(_write(tmp_path, "o.tif", make(img, _jpeg(img, subsampling), sub)))


def test_old_style_jpeg_restarts_mismatch_and_truncation(tmp_path):
    img = _rgb(32, 48, 9)
    jb = _jpeg(img, restart_marker_blocks=2)
    check(_write(tmp_path, "r.tif", ojpeg_tables(img, jb)))
    check(_write(tmp_path, "i.tif", ojpeg_interchange(img, jb)))
    check(_write(tmp_path, "m.tif", ojpeg_interchange(
        img, _jpeg(img, "4:2:0"), (1, 1))))
    jb = _jpeg(img, "4:2:0")
    refused_by_both(_write(tmp_path, "t.tif", ojpeg_interchange(
        img, jb[:len(jb) // 2])))


def ojpeg_file(jb, h, w, spp=3, photo=6, sub=None, planar=1):
    """Compression 6 with JPEGInterchangeFormat over `jb`, the tags saying
    h x w, `spp` samples of photometric `photo`."""
    blob = make_tiff(np.zeros((h, w, spp), np.uint8), photo=photo, bits=8,
                     comp=6, jpeg_chunks=[jb], ycbcr=sub, planar=planar)
    return with_tags(blob, {513: (4, [8]), 514: (4, [len(jb)])})


@pytest.mark.parametrize("photo", [0, 1])
@pytest.mark.parametrize("hw", [(32, 48), (13, 21)])
@pytest.mark.parametrize("rows", [0, 5])
def test_old_style_jpeg_grey_equals_pillow(tmp_path, photo, hw, rows):
    """One sample, MinIsBlack or MinIsWhite: the component as libjpeg
    decodes it (from JPEGInterchangeFormat, or the tables' tags), and a
    stream taller than the tags, cut to them."""
    g = _rgb(*hw, sum(hw) + photo)[..., 0]
    jb = _jpeg(g, "4:4:4")
    check(_write(tmp_path, "g.tif", ojpeg_file(jb, hw[0] - rows, hw[1], 1,
                                               photo)))
    check(_write(tmp_path, "t.tif", ojpeg_tables(g[:hw[0] - rows], jb, None,
                                                 1, photo)))


@pytest.mark.parametrize("planar", [1, 2])
@pytest.mark.parametrize("rows", [1, 7, 15])
def test_old_style_jpeg_taller_stream_and_separate_planes_equal_pillow(
        tmp_path, planar, rows):
    img = _rgb(32, 48, 11 + rows)
    check(_write(tmp_path, "o.tif", ojpeg_file(
        _jpeg(img, "4:2:0"), 32 - rows, 48, sub=(2, 2), planar=planar)))


_SAMPLINGS = {"mixed": [(2, 2, 0), (2, 1, 1), (1, 2, 1)],
              "chroma_2x2": [(1, 1, 0), (2, 2, 1), (1, 1, 1)],
              "all_2x2": [(2, 2, 0), (2, 2, 1), (2, 2, 1)],
              "luma_3x1": [(3, 1, 0), (1, 1, 1), (1, 1, 1)]}


def _ojpeg_refusals():
    """name -> (file bytes, libtiff's reason)."""
    from test_torch_port_jpeg import QTS, _coefs, encode
    img = _rgb(32, 48, 12)
    g = img[..., 0]
    out = {
        "progressive": (ojpeg_file(_jpeg(img, progressive=True), 32, 48),
                        "Unknown marker type 194 in JPEG data"),
        "progressive_grey": (ojpeg_file(_jpeg(g, "4:4:4", progressive=True), 32,
                                        48, 1, 1),
                             "Unknown marker type 194 in JPEG data"),
        "grey_sampled_2x2": (ojpeg_file(_jpeg(g), 32, 48, 1, 1),
                             "indicates unexpected subsampling values"),
        "grey_stream_three_samples": (
            ojpeg_file(_jpeg(g, "4:4:4"), 32, 48),
            "indicates unexpected number of samples"),
        "colour_stream_one_sample": (
            ojpeg_file(_jpeg(img, "4:4:4"), 32, 48, 1, 1),
            "indicates unexpected number of samples"),
        "one_sample_rgb": (ojpeg_file(_jpeg(g, "4:4:4"), 32, 48, 1, 2),
                           "Cannot handle zero strip size"),
        "one_sample_ycbcr": (ojpeg_file(_jpeg(g, "4:4:4"), 32, 48, 1, 6),
                             "Cannot handle zero strip size"),
        "shorter_stream": (ojpeg_file(_jpeg(img), 40, 48),
                           "indicates unexpected height"),
        "narrower_stream": (ojpeg_file(_jpeg(img), 32, 56),
                            "indicates unexpected width"),
        "wider_stream": (ojpeg_file(_jpeg(img), 32, 40),
                         "image width exceeds expected image width"),
    }
    for photo in (0, 1, 5):
        out[f"three_samples_photometric_{photo}"] = (
            ojpeg_file(_jpeg(img), 32, 48, photo=photo),
            "decoder error -2")
    for name, comps in _SAMPLINGS.items():
        jb = encode(48, 32, comps, _coefs(comps, 48, 32, 7), QTS)
        why = "Sampling factors too large" if name == "all_2x2" else \
            "returned max_h_samp_factor"
        out[f"sampling_{name}"] = (ojpeg_file(jb, 32, 48), why)
    return out


@pytest.mark.parametrize("name", sorted(_ojpeg_refusals()))
def test_old_style_jpeg_refused_as_libtiff_refuses(tmp_path, name):
    blob, why = _ojpeg_refusals()[name]
    refused_by_both(_write(tmp_path, "r.tif", blob), match=why)


def test_old_style_jpeg_of_four_samples_is_not_opened(tmp_path):
    """Pillow takes old-style JPEG for YCbCr and has no mode for four
    8-bit YCbCr samples: neither opens it."""
    img = _rgb(16, 16, 13)
    f = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(f, "JPEG")
    p = _write(tmp_path, "c.tif", ojpeg_file(f.getvalue(), 16, 16, 4, 5))
    with pytest.raises(Exception):
        Image.open(p)
    with pytest.raises(ValueError, match="unknown pixel mode"):
        timages.image_mode(p)
    refused_by_both(p)


# ------------------------------------------- CCITT RLEW, raw YCbCr layouts

def _mh_row(bits: np.ndarray) -> bytes:
    """One row's Modified Huffman codes, as libtiff writes them."""
    f = io.BytesIO()
    Image.fromarray(bits[None, :]).save(f, "TIFF", compression="tiff_ccitt")
    with Image.open(io.BytesIO(f.getvalue())) as im:
        off, n = im.tag_v2[273][0], im.tag_v2[279][0]
    return f.getvalue()[off:off + n]


@pytest.mark.parametrize("seed", range(4))
def test_ccitt_rlew_equals_pillow(tmp_path, seed):
    """Compression 32771: Modified Huffman rows on 16-bit boundaries."""
    r = np.random.RandomState(seed)
    h, w = r.randint(1, 8), r.randint(1, 90)
    a = r.rand(h, w) > 0.6
    data = bytearray()
    for row in a:
        data += _mh_row(row)
        if len(data) % 2:
            data += bytes([r.randint(256)])     # the word's pad, any bits
    check(_write(tmp_path, "w.tif", make_tiff(
        np.zeros((h, w, 1), np.uint8), photo=0, bits=1, comp=32771,
        jpeg_chunks=[bytes(data)])))


@pytest.mark.parametrize("hw", [(20, 24), (16, 16), (33, 17)])
def test_uncompressed_ycbcr_planar_and_tiled_as_pillow_reads_them(
        tmp_path, hw):
    """Planar: the planes as R, G and B; tiled: RGBX tiles, a row three
    bytes a pixel apart where a tile overhangs (Pillow's stride), or both
    refuse where the file is too short for that."""
    r = np.random.RandomState(sum(hw))
    h, w = hw
    img = r.randint(0, 256, (h, w, 3)).astype(np.uint8)
    check(_write(tmp_path, "p.tif", make_tiff(img, photo=6, bits=8, planar=2,
                                              ycbcr=(1, 1), rows=7)))
    check(_write(tmp_path, "q.tif", make_tiff(img, photo=6, bits=8, planar=2,
                                              ycbcr=(2, 2), tile=(16, 16))))
    n = -(-h // 16) * -(-w // 16)
    quads = r.randint(0, 256, (n, 16 * 16 * 4)).astype(np.uint8)
    check(_write(tmp_path, "t.tif", make_tiff(
        np.zeros((h, w, 3), np.uint8), photo=6, bits=8, tile=(16, 16),
        ycbcr=(1, 1), jpeg_chunks=[q.tobytes() for q in quads])))


# ------------------------------------------- JPEG tables strip to strip

def _segments(blob: bytes):
    """(marker, segment bytes) of a JPEG up to and with its SOS and data."""
    at, out = 2, []
    while True:
        marker = blob[at + 1]
        if marker == 0xDA:
            return out + [(marker, blob[at:])]
        n = struct.unpack(">H", blob[at + 2:at + 4])[0]
        out.append((marker, blob[at:at + 2 + n]))
        at += 2 + n


def test_jpeg_tables_carried_strip_to_strip_equal_pillow(tmp_path):
    """Many grey JPEG strips, each at its own quality: a strip carries its
    DQT only where its quality differs from the strip before it, and only
    the first carries DHT, so a strip decodes with the latest definition
    of each table, as libjpeg's one object keeps them for libtiff; the
    port keeps one copy of each table, however many strips define it."""
    from l3c_torch.data import tiff as ttiff
    img = _rgb(96, 40, 8)[..., 0]
    qualities = [50, 50, 90, 90, 90, 20, 75, 75] * 3
    chunks, prev, defs = [], None, {}
    for k, q in enumerate(qualities):
        f = io.BytesIO()
        Image.fromarray(img[4 * k:4 * k + 4]).save(f, "JPEG", quality=q)
        keep = [seg for m, seg in _segments(f.getvalue())
                if (m == 0xDB and q != prev) or (m == 0xC4 and k == 0)
                or m in (0xC0, 0xDA)]
        chunks.append(b"\xff\xd8" + b"".join(keep))
        ttiff._table_defs(chunks[-1], defs)
        prev = q
    assert sorted(defs) == [(0xC4, 0x00), (0xC4, 0x10), (0xDB, 0)]
    check(_write(tmp_path, "strips.tif", make_tiff(
        img[..., None], photo=1, bits=8, comp=7, rows=4,
        jpeg_chunks=chunks)))


# ------------------------------------------------- 12-bit JPEG in TIFF

def _bundled_libtiff():
    """Pillow's own libtiff (its wheel bundles one built with 12-bit JPEG),
    through ctypes, in this test only; None where the wheel has none."""
    import ctypes
    import glob
    import PIL
    found = glob.glob(os.path.join(os.path.dirname(PIL.__file__), os.pardir,
                                   "pillow.libs", "libtiff-*.so*"))
    if not found:
        return None
    lib = ctypes.CDLL(found[0])
    lib.TIFFOpen.restype = ctypes.c_void_p
    lib.TIFFOpen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.TIFFClose.argtypes = [ctypes.c_void_p]
    lib.TIFFWriteEncodedStrip.argtypes = [ctypes.c_void_p, ctypes.c_uint,
                                          ctypes.c_void_p, ctypes.c_ssize_t]
    lib.TIFFWriteEncodedStrip.restype = ctypes.c_ssize_t
    return lib


def write_jpeg12_tiff(path, v, quality, rows):
    """A 12-bit grey JPEG-compressed TIFF written by libtiff (its JPEG
    tables in JPEGTables, optimised tables in the first strip)."""
    import ctypes
    lib = _bundled_libtiff()
    h, w = v.shape

    def setf(t, tag, val):
        return lib.TIFFSetField(ctypes.c_void_p(t), ctypes.c_uint(tag),
                                ctypes.c_int(val))

    t = lib.TIFFOpen(path.encode(), b"w")
    for tag, val in ((256, w), (257, h), (258, 12), (277, 1), (262, 1),
                     (259, 7), (278, rows), (284, 1), (65537, quality)):
        setf(t, tag, val)
    data = _pack12(v)
    stride = (w * 12 + 7) // 8
    for i, y in enumerate(range(0, h, rows)):
        chunk = data[y * stride:(y + rows) * stride]
        buf = ctypes.create_string_buffer(chunk, len(chunk))
        assert lib.TIFFWriteEncodedStrip(t, i, buf, len(chunk)) > 0
    lib.TIFFClose(t)


@pytest.mark.parametrize("hw, quality, rows", [((16, 24), 90, 16),
                                               ((13, 22), 75, 13),
                                               ((40, 32), 95, 16),
                                               ((30, 50), 100, 8)])
@pytest.mark.parametrize("kind", ["low", "full"])
def test_jpeg12_tiff_equals_pillow(tmp_path, hw, quality, rows, kind):
    """12-bit grey JPEG strips (Pillow's I;16): libjpeg's 12-bit islow
    IDCT, the tables libjpeg keeps from strip to strip, libtiff's packing
    of sample pairs. (Even widths: libtiff's 12-bit packing reads and
    writes sample pairs, and an odd row's last sample is left to whatever
    its buffers held.)"""
    if _bundled_libtiff() is None:
        pytest.skip("Pillow's wheel bundles no libtiff here")
    r = np.random.RandomState(hw[0] + quality)
    v = (np.cumsum(r.randint(0, 20, hw), 1) % 400) if kind == "low" \
        else r.randint(0, 4096, hw)
    p = str(tmp_path / "j12.tif")
    write_jpeg12_tiff(p, v, quality, rows)
    check(p)


# ------------------------------------------------------------ refusals

def test_webp_sgilog_and_bad_depths_refused_by_both(tmp_path):
    z = np.zeros((4, 6, 3), np.uint8)
    refused_by_both(_write(tmp_path, "w.tif", make_tiff(
        z, photo=2, bits=8, comp=50001, jpeg_chunks=[b"RIFF0000WEBP"])),
        "WebP")
    for photo, spp in ((32844, 1), (32845, 3)):
        refused_by_both(_write(tmp_path, f"l{photo}.tif", make_tiff(
            z[..., :spp].astype(np.uint16), photo=photo, bits=16,
            comp=34676, jpeg_chunks=[bytes(48 * spp)])))
    refused_by_both(_write(tmp_path, "g.tif", make_tiff(
        z[..., :1], photo=1, bits=8, comp=4, jpeg_chunks=[bytes(8)])))
    refused_by_both(_write(tmp_path, "t.tif", make_tiff(
        z[..., :1], photo=1, bits=8, comp=32809, jpeg_chunks=[bytes(8)])))
    refused_by_both(_write(tmp_path, "s.tif", make_tiff(
        z[..., :1], photo=1, bits=8, comp=34676, jpeg_chunks=[bytes(32)])),
        "SGILog")


@pytest.mark.parametrize("compression", [None, "tiff_lzw"])
def test_cielab_equals_pillow(tmp_path, compression):
    """Pillow converts LAB to RGB through LittleCMS (data/cielab.py)."""
    p = str(tmp_path / "lab.tif")
    Image.fromarray(np.random.RandomState(7).randint(
        0, 256, (23, 37, 3)).astype(np.uint8)).convert("LAB").save(
            p, "TIFF", compression=compression)
    check(p)


def test_cielab_grid_and_cube_equal_littlecms():
    """Every L with a and b a sixteenth apart (and their ends) through the
    port's LittleCMS grid and interpolation against Pillow's transform."""
    from l3c_torch.data import cielab
    a = np.arange(256)
    ab = np.union1d(a[::16], [1, 127, 128, 129, 254, 255])
    lab = np.stack(np.meshgrid(a, ab, ab, indexing="ij"), -1).reshape(
        256, -1, 3).astype(np.uint8)
    im = Image.frombytes("LAB", (lab.shape[1], 256), lab.tobytes())
    np.testing.assert_array_equal(cielab.lab_to_rgb(lab),
                                  np.asarray(im.convert("RGB")))
