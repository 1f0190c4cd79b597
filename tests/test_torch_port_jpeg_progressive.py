"""The port's progressive and four-component JPEG decoding (data/jpeg.py)
against Pillow (libjpeg-turbo), which the JAX package's load_image_uint8
decodes through.

- Pillow-written progressive files: qualities 10 to 100, 4:4:4, 4:2:2 and
  4:2:0, grey, with and without restart markers, odd sizes down to 1 x 1;
- files written here from given coefficients by a test-only progressive
  encoder (jcphuff.c's rules: EOBRUN across blocks, correction bits
  buffered across an end-of-band run, ZRL only before the last newly
  nonzero coefficient), under custom scan scripts: spectral selection
  alone, successive approximation of DC and AC down several bits,
  non-interleaved DC scans, narrow bands, restart intervals over each;
- CMYK written by Pillow, and CMYK / YCCK written here under an Adobe
  marker with transform 0 and 2 and without one;
every pixel equal to Pillow's convert("RGB") and to
l3c_tpu.data.images.load_image_uint8, and the mode and size from the header
equal to Pillow's. A file whose first nine AC coefficients are not all
refined to Al = 0 decodes with libjpeg-turbo's block smoothing, as Pillow
decodes it; so does one that leaves only higher coefficients unsent.
"""
import itertools
import os
import struct
import sys

import numpy as np
import pytest
from PIL import Image

from l3c_tpu.data import images as jimages
from l3c_torch.data import images as timages

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_jpeg import (  # noqa: E402
    ADOBE_RGB, JFIF, QTS, SAMPLINGS, Bits, _codes, _coefs, _content, encode)


def check(p):
    """The port's pixels, mode and size equal Pillow's and the JAX
    loader's."""
    with Image.open(p) as im:
        mode, size = im.mode, im.size[::-1]
        want = np.asarray(im.convert("RGB"))
    got = timages.load_image_uint8(p)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jimages.load_image_uint8(p))
    assert timages.image_mode(p) == mode
    assert timages.image_size(p) == size


# ------------------------------------ a progressive encoder for the tests


def _dht(tc, syms, length):
    """A DHT table giving every symbol a code of `length` bits (the
    all-ones code left unused, as T.81 requires)."""
    counts = [0] * 16
    counts[length - 1] = len(syms)
    return bytes([tc << 4]) + bytes(counts) + bytes(syms)


DC_SYMS = list(range(12))
AC_SYMS = [r << 4 for r in range(16)] + [r << 4 | s for r in range(16)
                                         for s in range(1, 11)]
DC_TABLE, AC_TABLE = _dht(0, DC_SYMS, 4), _dht(1, AC_SYMS, 8)


class _Scan:
    """jcphuff.c's encoder state for one scan: the bit writer, the pending
    end-of-band run and its buffered correction bits."""

    def __init__(self):
        self.bits, self.eobrun, self.be = Bits(), 0, []
        self.dc, self.ac = _codes(DC_TABLE), _codes(AC_TABLE)

    def emit_eobrun(self):
        if self.eobrun:
            n = self.eobrun.bit_length() - 1
            self.bits.put(*self.ac[n << 4])
            if n:
                self.bits.put(self.eobrun, n)
            self.eobrun = 0
            for b in self.be:
                self.bits.put(b, 1)
            self.be = []

    def dc_first(self, zz, pred, al):
        v = int(zz[0]) >> al
        diff = v - pred
        s = abs(diff).bit_length()
        self.bits.put(*self.dc[s])
        if s:
            self.bits.put(diff if diff > 0 else diff + (1 << s) - 1, s)
        return v

    def dc_refine(self, zz, al):
        self.bits.put((int(zz[0]) >> al) & 1, 1)

    def ac_first(self, zz, ss, se, al):
        r = 0
        for k in range(ss, se + 1):
            c = int(zz[k])
            t = abs(c) >> al
            if not t:
                r += 1
                continue
            self.emit_eobrun()
            while r > 15:
                self.bits.put(*self.ac[0xF0])
                r -= 16
            n = t.bit_length()
            self.bits.put(*self.ac[r << 4 | n])
            self.bits.put(t if c > 0 else ~t, n)
            r = 0
        if r:
            self.eobrun += 1
            if self.eobrun == 0x7FFF:
                self.emit_eobrun()

    def ac_refine(self, zz, ss, se, al):
        absv = [abs(int(v)) >> al for v in zz]
        eob = max([k for k in range(ss, se + 1) if absv[k] == 1], default=0)
        r, br = 0, []
        for k in range(ss, se + 1):
            t = absv[k]
            if not t:
                r += 1
                continue
            while r > 15 and k <= eob:
                self.emit_eobrun()
                self.bits.put(*self.ac[0xF0])
                r -= 16
                for b in br:
                    self.bits.put(b, 1)
                br = []
            if t > 1:
                br.append(t & 1)
                continue
            self.emit_eobrun()
            self.bits.put(*self.ac[r << 4 | 1])
            self.bits.put(1 if zz[k] > 0 else 0, 1)
            for b in br:
                self.bits.put(b, 1)
            r, br = 0, []
        if r or br:
            self.eobrun += 1
            self.be += br
            if self.eobrun == 0x7FFF or len(self.be) > 937:
                self.emit_eobrun()


def encode_progressive(width, height, comps, coefs, qts, script, restart=0,
                       app=b"", ids=None):
    """A progressive (SOF2) JPEG of given quantized coefficients.

    comps, coefs, qts: as test_torch_port_jpeg.encode's; script: scans
    (component indices, Ss, Se, Ah, Al)."""
    ids = ids or list(range(1, len(comps) + 1))

    def seg(marker, data):
        return bytes([0xFF, marker]) + struct.pack(">H", len(data) + 2) + data

    out = b"\xff\xd8" + app
    for tq, q in qts.items():
        out += seg(0xDB, bytes([tq]) + bytes(int(v) for v in q))
    sof = struct.pack(">BHHB", 8, height, width, len(comps))
    for i, (h, v, tq) in enumerate(comps):
        sof += bytes([ids[i], h << 4 | v, tq])
    out += seg(0xC2, sof) + seg(0xC4, DC_TABLE + AC_TABLE)
    if restart:
        out += seg(0xDD, struct.pack(">H", restart))
    hmax = max(c[0] for c in comps)
    vmax = max(c[1] for c in comps)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    for sc, ss, se, ah, al in script:
        hdr = bytes([len(sc)]) + b"".join(bytes([ids[i], 0]) for i in sc)
        out += seg(0xDA, hdr + bytes([ss, se, ah << 4 | al]))
        if len(sc) == 1:
            h, v, _ = comps[sc[0]]
            bw = -(-(-(-width * h // hmax)) // 8)
            bh = -(-(-(-height * v // vmax)) // 8)
            mcus = [[(sc[0], by, bx)] for by in range(bh)
                    for bx in range(bw)]
        else:
            mcus = [[(i, my * comps[i][1] + y, mx * comps[i][0] + x)
                     for i in sc for y in range(comps[i][1])
                     for x in range(comps[i][0])]
                    for my in range(mcuy) for mx in range(mcux)]
        enc, preds, data = _Scan(), [0] * len(comps), b""
        for n, m in enumerate(mcus):
            if restart and n and n % restart == 0:
                enc.emit_eobrun()
                data += enc.bits.flush() + bytes([0xFF, 0xD0 + (
                    n // restart - 1) % 8])
                preds = [0] * len(comps)
            for i, by, bx in m:
                zz = coefs[i][by, bx]
                if ss == 0 and not ah:
                    preds[i] = enc.dc_first(zz, preds[i], al)
                elif ss == 0:
                    enc.dc_refine(zz, al)
                elif ah:
                    enc.ac_refine(zz, ss, se, al)
                else:
                    enc.ac_first(zz, ss, se, al)
        enc.emit_eobrun()
        out += data + enc.bits.flush()
    return out + b"\xff\xd9"


def _script(n, kind):
    """Scan scripts over n components."""
    every = list(range(n))
    if kind == "spectral":
        return [(every, 0, 0, 0, 0)] + [([c], 1, 63, 0, 0) for c in every]
    if kind == "libjpeg":          # jcparam.c's jpeg_simple_progression
        return ([(every, 0, 0, 0, 1)] + [([c], 1, 5, 0, 2) for c in every]
                + [([c], 6, 63, 0, 2) for c in every]
                + [([c], 1, 63, 2, 1) for c in every] + [(every, 0, 0, 1, 0)]
                + [([c], 1, 63, 1, 0) for c in every])
    if kind == "deep":             # three bits of DC and AC refined
        return ([(every, 0, 0, 0, 3)] + [(every, 0, 0, a + 1, a)
                                          for a in (2, 1, 0)]
                + [([c], 1, 9, 0, 3) for c in every]
                + [([c], 10, 63, 0, 1) for c in every]
                + [([c], 1, 9, a + 1, a) for c in every for a in (2, 1, 0)]
                + [([c], 10, 63, 1, 0) for c in every])
    if kind == "bands":            # narrow bands, DC one component a scan
        return ([([c], 0, 0, 0, 1) for c in every]
                + [([c], ss, se, 0, 1) for c in every
                   for ss, se in ((1, 1), (2, 2), (3, 9), (10, 40),
                                  (41, 63))]
                + [([c], 0, 0, 1, 0) for c in every]
                + [([c], ss, se, 1, 0) for c in every
                   for ss, se in ((1, 5), (6, 63))])
    if kind == "high unsent":      # AC 10..63 never sent: no smoothing
        return [(every, 0, 0, 0, 0)] + [([c], 1, 9, 0, 0) for c in every]
    raise KeyError(kind)


def _big_coefs(comps, w, h, seed):
    """_coefs with larger AC terms, so refinement passes carry several
    bits."""
    out = _coefs(comps, w, h, seed)
    r = np.random.RandomState(seed + 1)
    for c in out:
        c[..., 1:6] *= r.randint(1, 5, c[..., 1:6].shape)
    return out


# ----------------------------------------------------------------- tests


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("hw", [(1, 1), (3, 5), (17, 23), (33, 65)])
def test_pillow_progressive_equals_pillow(tmp_path, hw, subsampling):
    """Pillow's progressive files (libjpeg's simple progression: DC and AC
    refinement, EOBRUN) at each quality, content and restart setting."""
    p = str(tmp_path / "p.jpg")
    for q, kind, rst in itertools.product((10, 50, 95, 100),
                                          ("noise", "smooth"), (0, 3)):
        Image.fromarray(_content(*hw, q + rst, kind)).save(
            p, quality=q, subsampling=subsampling, progressive=True,
            restart_marker_blocks=rst)
        check(p)


@pytest.mark.parametrize("hw", [(1, 1), (17, 23), (33, 65)])
def test_progressive_grey_equals_pillow(tmp_path, hw):
    p = str(tmp_path / "g.jpg")
    for q in (20, 90, 100):
        Image.fromarray(_content(*hw, q, "smooth")[..., 0]).save(
            p, quality=q, progressive=True)
        check(p)
    assert timages.image_mode(p) == "L"


@pytest.mark.parametrize("kind", ["spectral", "libjpeg", "deep", "bands",
                                  "high unsent"])
@pytest.mark.parametrize("sampling", ["4:2:0", "4:2:2", "mixed",
                                      "grey 2x2"])
def test_scan_scripts_equal_pillow(tmp_path, sampling, kind):
    """Custom scan scripts over given coefficients, at odd sizes, with and
    without restart intervals (2 MCUs)."""
    comps = SAMPLINGS[sampling]
    p = str(tmp_path / "s.jpg")
    for (w, h), rst in itertools.product([(17, 23), (33, 65), (2, 9)],
                                         (0, 2)):
        with open(p, "wb") as f:
            f.write(encode_progressive(
                w, h, comps, _big_coefs(comps, w, h, w + h), QTS,
                _script(len(comps), kind), restart=rst))
        check(p)


def test_long_eob_runs_and_zero_runs(tmp_path):
    """Blocks with nothing in a band for many blocks in a row (EOBRUN
    coded with many extra bits) and runs of more than 16 zeros before a
    newly nonzero coefficient in a refinement scan (ZRL with correction
    bits)."""
    comps = [(1, 1, 0)]
    w, h = 200, 48
    c = np.zeros((6, 25, 64), np.int64)
    c[..., 0] = np.arange(150).reshape(6, 25) % 50 - 25
    c[0, 3, 40] = 5                # a lone high term: runs of 39 zeros
    c[2, 7, 1:40:3] = 3            # history bits across long runs
    c[2, 7, 38] = 1                # newly nonzero after them
    c[5, 24, 63] = -7
    p = str(tmp_path / "r.jpg")
    for kind in ("spectral", "libjpeg", "deep", "bands"):
        with open(p, "wb") as f:
            f.write(encode_progressive(w, h, comps, [c], QTS,
                                       _script(1, kind)))
        check(p)


ADOBE = {"transform 0": b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00",
         "transform 2": b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x02",
         "no marker": b""}


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("hw", [(1, 1), (17, 23), (33, 65)])
def test_pillow_cmyk_equals_pillow(tmp_path, hw, progressive):
    """Pillow's CMYK files (an Adobe marker, transform 0): Pillow reads
    the samples inverted and converts them by its cmyk2rgb."""
    p = str(tmp_path / "k.jpg")
    for q in (20, 90, 100):
        for kind in ("noise", "smooth"):
            Image.fromarray(_content(*hw, q, kind)).convert("CMYK").save(
                p, quality=q, progressive=progressive)
            check(p)
    assert timages.image_mode(p) == "CMYK"


@pytest.mark.parametrize("adobe", list(ADOBE))
@pytest.mark.parametrize("sampling", ["4:4:4 4", "4:2:0 4"])
def test_cmyk_and_ycck_equal_pillow(tmp_path, adobe, sampling):
    """Four components written here: YCCK under Adobe transform 2 (libjpeg
    turns it into CMYK), CMYK under transform 0 or without the marker;
    baseline and progressive, subsampled K or not."""
    comps = {"4:4:4 4": [(1, 1, 0), (1, 1, 1), (1, 1, 1), (1, 1, 0)],
             "4:2:0 4": [(2, 2, 0), (1, 1, 1), (1, 1, 1), (2, 2, 0)]}[
                 sampling]
    p = str(tmp_path / "y.jpg")
    for w, h in ((17, 23), (33, 65), (1, 1)):
        cf = _coefs(comps, w, h, w * h)
        for blob in (encode(w, h, comps, cf, QTS, app=ADOBE[adobe]),
                     encode_progressive(w, h, comps, cf, QTS,
                                        _script(4, "libjpeg"),
                                        app=ADOBE[adobe])):
            with open(p, "wb") as f:
                f.write(blob)
            check(p)
    assert timages.image_mode(p) == "CMYK"


@pytest.mark.parametrize("app,ids", [(ADOBE_RGB, None), (b"", [82, 71, 66]),
                                     (JFIF, [82, 71, 66])])
def test_progressive_colour_space_equals_pillow(tmp_path, app, ids):
    comps = SAMPLINGS["4:4:4"]
    p = str(tmp_path / "c.jpg")
    with open(p, "wb") as f:
        f.write(encode_progressive(17, 23, comps, _coefs(comps, 17, 23, 1),
                                   QTS, _script(3, "deep"), app=app,
                                   ids=ids))
    check(p)


@pytest.mark.parametrize("script", [
    [([0, 1, 2], 0, 0, 0, 0), ([0], 1, 63, 0, 1), ([1], 1, 63, 0, 0),
     ([2], 1, 63, 0, 0)],                       # Y's AC left at Al = 1
    [([0, 1, 2], 0, 0, 0, 0), ([0], 1, 5, 0, 0), ([1], 1, 63, 0, 0),
     ([2], 1, 63, 0, 0)],                       # Y's AC 6..9 never sent
])
def test_incompletely_refined_equals_pillow(tmp_path, script):
    """libjpeg-turbo smooths such a file's blocks (jdcoefct.c's
    decompress_smooth_data), and so does the port: pixels, size and mode
    equal Pillow's (more scripts: test_torch_port_damaged.py)."""
    comps = SAMPLINGS["4:2:0"]
    p = str(tmp_path / "i.jpg")
    with open(p, "wb") as f:
        f.write(encode_progressive(33, 23, comps,
                                   _coefs(comps, 33, 23, 5), QTS, script))
    check(p)


def test_bad_progression_raises(tmp_path):
    comps = SAMPLINGS["4:4:4"]
    p = str(tmp_path / "b.jpg")
    blob = encode_progressive(17, 23, comps, _coefs(comps, 17, 23, 1), QTS,
                              _script(3, "spectral"))
    at = blob.index(b"\xff\xda", blob.index(b"\xff\xda") + 2)
    n = struct.unpack(">H", blob[at + 2:at + 4])[0]
    bad = blob[:at + 2 + n - 3] + bytes([1, 64, 0]) + blob[at + 2 + n:]
    open(p, "wb").write(bad)
    with pytest.raises(ValueError, match="corrupt JPEG progression"):
        timages.load_image_uint8(p)
    open(p, "wb").write(blob[:len(blob) * 2 // 3] + b"\xff\xd9")
    check(p)                      # cut short with EOI: Pillow reads it
    open(p, "wb").write(blob[:len(blob) * 2 // 3])
    with pytest.raises(ValueError, match="truncated"):
        timages.load_image_uint8(p)
