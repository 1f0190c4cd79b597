"""The port's baseline JPEG decoder (data/jpeg.py) against Pillow, which
the JAX package's load_image_uint8 decodes through (libjpeg-turbo).

- the six JPEG sources of the offline corpus (skipped where their package
  is not installed);
- Pillow-written files: qualities 10 to 100, 4:4:4, 4:2:2 and 4:2:0, with
  and without restart markers, odd sizes down to 1 x 1, noise and smooth
  content, grey;
- files written here from given coefficients (Pillow's Huffman tables),
  for what Pillow does not write: 4:4:0 (1x2), 4:1:1 (4x1) and mixed
  sampling factors, single-component (non-interleaved) scans, restart
  intervals over them, RGB by an Adobe marker or by component ids;
every pixel equal, and the mode from the header equal to Pillow's.
Lossless and hierarchical processes, 12-bit samples and a truncated file
raise ValueError naming the reason (progressive and four-component files:
test_torch_port_jpeg_progressive.py; arithmetic-coded ones:
test_torch_port_jpeg_arith.py). A scan cut
short and a block whose inverse DCT leaves the range where libjpeg-turbo's
C and SIMD code agree decode as Pillow decodes them (damaged files:
test_torch_port_damaged.py).
"""
import io
import itertools
import os
import struct
import sysconfig

import numpy as np
import pytest
from PIL import Image

from l3c_tpu.data import images as jimages
from l3c_torch.data import images as timages
from l3c_torch.data import jpeg


# ------------------------------------- a baseline encoder for the tests


def pillow_tables():
    """Pillow's (Annex K) Huffman tables, from a JPEG it writes: the DHT
    payloads by (class, id)."""
    b = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(b, "JPEG")
    blob, at, out = b.getvalue(), 2, {}
    while blob[at + 1] != 0xDA:
        n = struct.unpack(">H", blob[at + 2:at + 4])[0]
        if blob[at + 1] == 0xC4:
            seg, i = blob[at + 4:at + 2 + n], 0
            while i < len(seg):
                k = 17 + sum(seg[i + 1:i + 17])
                out[seg[i] >> 4, seg[i] & 15] = seg[i:i + k]
                i += k
        at += 2 + n
    return out


def _codes(table):
    """A DHT table -> {symbol: (code, length)}, the canonical codes."""
    counts, syms = table[1:17], table[17:]
    code, k, out = 0, 0, {}
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            out[syms[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


class Bits:
    """MSB-first bit writer with 0xFF00 stuffing; flush pads with ones."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, v, n):
        self.acc, self.n = (self.acc << n) | (v & ((1 << n) - 1)), self.n + n
        while self.n >= 8:
            self.n -= 8
            b = (self.acc >> self.n) & 255
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0)

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        data, self.out = bytes(self.out), bytearray()
        return data


def _block(bits, zz, pred, dc, ac):
    """Huffman-code one block (zig-zag coefficients); returns its DC."""
    diff = int(zz[0]) - pred
    s = abs(diff).bit_length()
    bits.put(*dc[s])
    if s:
        bits.put(diff if diff > 0 else diff + (1 << s) - 1, s)
    run = 0
    last = max([k for k in range(1, 64) if zz[k]], default=0)
    for k in range(1, last + 1):
        v = int(zz[k])
        if not v:
            run += 1
            continue
        while run > 15:
            bits.put(*ac[0xF0])
            run -= 16
        s = abs(v).bit_length()
        bits.put(*ac[(run << 4) | s])
        bits.put(v if v > 0 else v + (1 << s) - 1, s)
        run = 0
    if last < 63:
        bits.put(*ac[0x00])
    return int(zz[0])


def encode(width, height, comps, coefs, qts, restart=0, interleaved=True,
           app=b"", ids=None):
    """A baseline JPEG of given quantized coefficients.

    comps: [(h, v, tq)]; coefs[i]: (rows, cols, 64) zig-zag, covering the
    MCU-padded extent; qts: {tq: 64 values, zig-zag}."""
    tabs = pillow_tables()
    dc = [_codes(tabs[0, 0]), _codes(tabs[0, 1])]
    ac = [_codes(tabs[1, 0]), _codes(tabs[1, 1])]
    ids = ids or list(range(1, len(comps) + 1))

    def seg(marker, data):
        return bytes([0xFF, marker]) + struct.pack(">H", len(data) + 2) + data

    out = b"\xff\xd8" + app
    for tq, q in qts.items():
        out += seg(0xDB, bytes([tq]) + bytes(int(v) for v in q))
    sof = struct.pack(">BHHB", 8, height, width, len(comps))
    for i, (h, v, tq) in enumerate(comps):
        sof += bytes([ids[i], h << 4 | v, tq])
    out += seg(0xC0, sof)
    out += seg(0xC4, b"".join(tabs[k] for k in sorted(tabs)))
    if restart:
        out += seg(0xDD, struct.pack(">H", restart))
    hmax = max(c[0] for c in comps)
    vmax = max(c[1] for c in comps)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    tsel = [min(i, 1) for i in range(len(comps))]
    scans = [list(range(len(comps)))] if interleaved else [
        [i] for i in range(len(comps))]
    for sc in scans:
        hdr = bytes([len(sc)])
        for i in sc:
            hdr += bytes([ids[i], tsel[i] << 4 | tsel[i]])
        out += seg(0xDA, hdr + b"\x00\x3f\x00")
        if len(sc) == 1:
            h, v, _ = comps[sc[0]]
            bw = -(-(-(-width * h // hmax)) // 8)
            bh = -(-(-(-height * v // vmax)) // 8)
            mcus = [[(sc[0], by, bx)] for by in range(bh)
                    for bx in range(bw)]
        else:
            mcus = []
            for my in range(mcuy):
                for mx in range(mcux):
                    m = []
                    for i in sc:
                        h, v, _ = comps[i]
                        m += [(i, my * v + y, mx * h + x) for y in range(v)
                              for x in range(h)]
                    mcus.append(m)
        bits, preds, data = Bits(), [0] * len(comps), b""
        for n, m in enumerate(mcus):
            if restart and n and n % restart == 0:
                data += bits.flush() + bytes([0xFF, 0xD0 + (n // restart - 1)
                                              % 8])
                preds = [0] * len(comps)
            for i, by, bx in m:
                preds[i] = _block(bits, coefs[i][by, bx], preds[i],
                                  dc[tsel[i]], ac[tsel[i]])
        out += data + bits.flush()
    return out + b"\xff\xd9"


# ----------------------------------------------------------------- tests

CORPUS = ("sklearn/datasets/images/flower.jpg",
          "matplotlib/mpl-data/sample_data/grace_hopper.jpg",
          "pygame/docs/generated/_images/camera_average.jpg",
          "pygame/docs/generated/_images/camera_background.jpg",
          "sklearn/datasets/images/china.jpg",
          "pygame/docs/generated/_images/camera_rgb.jpg")


@pytest.mark.parametrize("rel", CORPUS)
def test_corpus_jpegs_equal_jax(rel):
    p = os.path.join(sysconfig.get_paths()["purelib"], rel)
    if not os.path.isfile(p):
        pytest.skip(f"corpus source {rel} is not installed")
    np.testing.assert_array_equal(timages.load_image_uint8(p),
                                  jimages.load_image_uint8(p))
    with Image.open(p) as im:
        assert timages.image_mode(p) == im.mode
        assert timages.image_size(p) == im.size[::-1]


def _content(h, w, seed, kind):
    r = np.random.RandomState(seed)
    if kind == "noise":
        return r.randint(0, 256, (h, w, 3)).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([yy * 7 % 256, xx * 3 % 256, (yy * xx) % 256], -1)
    return np.clip(base + r.randint(-20, 20, base.shape), 0,
                   255).astype(np.uint8)


def _check(p):
    with Image.open(p) as im:
        mode = im.mode
        want = np.asarray(im.convert("RGB"))
    got = timages.load_image_uint8(p)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert timages.image_mode(p) == mode


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("hw", [(1, 1), (2, 2), (3, 5), (17, 23), (33, 65)])
def test_pillow_written_equal_pillow(tmp_path, hw, subsampling):
    """Qualities, content, restart markers (every 3 blocks) at each size and
    subsampling."""
    p = str(tmp_path / "x.jpg")
    for q, kind, rst in itertools.product((10, 50, 95, 100),
                                          ("noise", "smooth"), (0, 3)):
        Image.fromarray(_content(*hw, q + rst, kind)).save(
            p, quality=q, subsampling=subsampling,
            restart_marker_blocks=rst)
        _check(p)


@pytest.mark.parametrize("hw", [(1, 1), (17, 23), (33, 65)])
def test_grey_equals_pillow(tmp_path, hw):
    p = str(tmp_path / "g.jpg")
    for q in (20, 90, 100):
        Image.fromarray(_content(*hw, q, "smooth")[..., 0]).save(p, quality=q)
        _check(p)
    assert timages.image_mode(p) == "L"


def _coefs(comps, w, h, seed, dc=None):
    """Seeded quantized coefficients (zig-zag) over the MCU-padded extent:
    a DC walk and sparse low-frequency AC terms, a few high ones."""
    r = np.random.RandomState(seed)
    hmax = max(c[0] for c in comps)
    vmax = max(c[1] for c in comps)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    out = []
    for ch, cv, _ in comps:
        c = np.zeros((mcuy * cv, mcux * ch, 64), np.int64)
        n = c.shape[:2]
        c[..., 0] = r.randint(-40, 40, n)
        c[..., 1:10] = r.randint(-6, 7, n + (9,)) * (r.rand(*n, 9) < 0.5)
        c[..., 40:42] = r.randint(-2, 3, n + (2,)) * (r.rand(*n, 2) < 0.2)
        if dc is not None:
            c[0, 0, 0] = dc
        out.append(c)
    return out


QTS = {0: np.clip(np.arange(64) // 3 + 4, 1, 255),
       1: np.clip(np.arange(64) // 2 + 6, 1, 255)}
SAMPLINGS = {"4:4:0": [(1, 2, 0), (1, 1, 1), (1, 1, 1)],
             "4:2:2": [(2, 1, 0), (1, 1, 1), (1, 1, 1)],
             "4:2:0": [(2, 2, 0), (1, 1, 1), (1, 1, 1)],
             "4:1:1": [(4, 1, 0), (1, 1, 1), (1, 1, 1)],
             "4:4:4": [(1, 1, 0), (1, 1, 1), (1, 1, 1)],
             "mixed": [(2, 2, 0), (2, 1, 1), (1, 2, 1)],
             "chroma 2x2": [(1, 1, 0), (2, 2, 1), (1, 1, 1)],
             "grey 2x2": [(2, 2, 0)]}


@pytest.mark.parametrize("interleaved", [True, False])
@pytest.mark.parametrize("sampling", list(SAMPLINGS))
def test_sampling_factors_and_scans_equal_pillow(tmp_path, sampling,
                                                 interleaved):
    comps = SAMPLINGS[sampling]
    if not interleaved and len(comps) == 1:
        interleaved = True        # one component: a single scan either way
    p = str(tmp_path / "e.jpg")
    for (w, h), rst in itertools.product([(17, 23), (33, 65), (2, 9),
                                          (40, 3)], (0, 2)):
        with open(p, "wb") as f:
            f.write(encode(w, h, comps, _coefs(comps, w, h, w * h), QTS,
                           restart=rst, interleaved=interleaved))
        _check(p)


ADOBE_RGB = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"
JFIF = b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"


@pytest.mark.parametrize("app,ids", [(ADOBE_RGB, None), (b"", [82, 71, 66]),
                                     (JFIF, [82, 71, 66])])
def test_colour_space_equals_pillow(tmp_path, app, ids):
    """Adobe transform 0 and ids 'R', 'G', 'B' mean RGB; a JFIF marker means
    YCbCr whatever the ids."""
    comps = SAMPLINGS["4:4:4"]
    p = str(tmp_path / "c.jpg")
    with open(p, "wb") as f:
        f.write(encode(17, 23, comps, _coefs(comps, 17, 23, 1), QTS, app=app,
                       ids=ids))
    _check(p)


def test_what_is_not_decoded_raises_with_the_reason(tmp_path):
    """Lossless and hierarchical processes, 12-bit samples, a truncated
    file, a progressive frame over a sequential scan and a marker libjpeg
    refuses inside the scan's data raise, as Pillow refuses them; the
    header of each is still read (arithmetic-coded files:
    test_torch_port_jpeg_arith.py).
    Corrupt entropy data Pillow reads decodes as Pillow decodes it
    (libjpeg-turbo's recovery; test_torch_port_damaged.py sweeps it). (Progressive and CMYK files
    decode: test_torch_port_jpeg_progressive.)"""
    img = _content(24, 16, 0, "smooth")
    p = str(tmp_path / "x.jpg")
    Image.fromarray(img).save(p)
    blob = open(p, "rb").read()
    sof = blob.index(b"\xff\xc0")
    for marker, msg in ((0xC3, "lossless JPEG"),
                        (0xCA, "corrupt JPEG progression"),
                        (0xC5, "differential sequential JPEG")):
        open(p, "wb").write(blob[:sof + 1] + bytes([marker])
                            + blob[sof + 2:])
        with pytest.raises(ValueError, match=msg):
            timages.load_image_uint8(p)
        with pytest.raises(OSError):
            jimages.load_image_uint8(p)
        assert timages.image_size(p) == (24, 16)     # the header is read
    # Huffman data under an arithmetic-coded frame header: Pillow reads
    # it as arithmetic-coded data, and so does the port
    open(p, "wb").write(blob[:sof + 1] + b"\xc9" + blob[sof + 2:])
    _check(p)
    open(p, "wb").write(blob[:sof + 4] + b"\x0c" + blob[sof + 5:])
    with pytest.raises(ValueError, match="12-bit JPEG is not decoded"):
        timages.load_image_uint8(p)
    with pytest.raises(OSError):          # nor does Pillow open it here
        Image.open(p)
    open(p, "wb").write(blob[:len(blob) // 2])
    with pytest.raises(ValueError, match="truncated"):
        timages.load_image_uint8(p)
    with pytest.raises(OSError, match="(?i)truncated"):
        jimages.load_image_uint8(p)
    sos = blob.index(b"\xff\xda")
    n = struct.unpack(">H", blob[sos + 2:sos + 4])[0]
    open(p, "wb").write(blob[:sos + 2 + n] + b"\xff\xff\xff\xff"
                        + blob[sos + 2 + n + 4:])
    with pytest.raises(ValueError, match="unsupported JPEG marker 0xFF46"):
        timages.load_image_uint8(p)       # the scan's data ends at 0xFF46,
    with pytest.raises(OSError):          # a marker libjpeg refuses
        jimages.load_image_uint8(p)


@pytest.mark.parametrize("cut", [0, 7, 40, 150, 333])
def test_scan_cut_short_equals_pillow(tmp_path, cut):
    """A scan cut short with EOI appended: libjpeg feeds zero bits to the
    MCU the data ends in ("premature end of data segment") and leaves the
    later ones grey, and Pillow reads the file; so does the port, pixel for
    pixel. Without the EOI both refuse it as truncated."""
    img = np.random.RandomState(cut).randint(0, 256, (64, 64, 3)).astype(
        np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=95)
    blob = buf.getvalue()
    sos = blob.index(b"\xff\xda")
    start = sos + 2 + struct.unpack(">H", blob[sos + 2:sos + 4])[0]
    p = str(tmp_path / "cut.jpg")
    open(p, "wb").write(blob[:start + cut] + b"\xff\xd9")
    _check(p)
    np.testing.assert_array_equal(timages.load_image_uint8(p),
                                  jimages.load_image_uint8(p))
    open(p, "wb").write(blob[:start + cut + 1])
    with pytest.raises(ValueError, match="truncated"):
        timages.load_image_uint8(p)
    with pytest.raises(OSError, match="(?i)truncated"):
        jimages.load_image_uint8(p)


@pytest.mark.parametrize("dc,pillow", [(-1000, 0), (2000, 255)])
def test_out_of_range_blocks_equal_pillow(tmp_path, dc, pillow):
    """A DC so large the inverse DCT leaves [-512, 511]: Pillow (its SIMD
    code saturates) gives `pillow` across the block's first row, where
    libjpeg-turbo's C table would wrap (dc 2000: 104); the port gives
    Pillow's pixels and counts the block."""
    comps = [(1, 1, 0)]
    p = str(tmp_path / "big.jpg")
    with open(p, "wb") as f:
        f.write(encode(8, 8, comps, _coefs(comps, 8, 8, 3, dc=dc), QTS))
    with Image.open(p) as im:
        assert (np.asarray(im)[0] == pillow).all()
    before = jpeg.COUNTS["saturated_blocks"]
    _check(p)
    assert jpeg.COUNTS["saturated_blocks"] == before + 1
