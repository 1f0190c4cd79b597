"""The port's arithmetic-coded JPEG decoding (SOF9 sequential, SOF10
progressive; data/jpeg.py) against Pillow, whose libjpeg-turbo reads
them, and the JAX package's load_image_uint8.

Files are written here from given coefficients by a test-only encoder
(jcarith.c's QM coder and its DC / AC statistics, T.81 Annexes D, F and
G): interleaved and single-component scans, 4:2:0, 4:4:4, grey and mixed
sampling, restart intervals, conditioning (DAC) other than the defaults,
progressive scripts with spectral selection and successive
approximation, and coefficients up to the 16-bit range. Every pixel,
the mode and the size equal Pillow's. Damaged data decodes as libjpeg
decodes it (a bad code leaves the rest of the restart interval alone);
a scan that runs past the 64 KiB Pillow hands libjpeg first is refused
as Pillow refuses it (jdarith.c cannot wait for more bytes).
"""
import os
import struct
import sys

import numpy as np
import pytest

from l3c_tpu.data import images as jimages
from l3c_torch.data import images as timages
from l3c_torch.data.jpeg import _ARITAB

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_jpeg import QTS, SAMPLINGS  # noqa: E402
from test_torch_port_jpeg_progressive import (  # noqa: E402
    _big_coefs, _script, check)


class QMEncoder:
    """jcarith.c's arith_encode and finish_pass: T.81's QM coder, the
    output unstuffed (0xFF bytes get their 0x00 when the segment is
    written), carries propagated back through it."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.ct = 0, 0x10000, 11

    def _byte(self):
        t = self.c >> 19
        if t > 0xFF:                       # carry into what is written
            i = len(self.out) - 1
            while self.out[i] == 0xFF:
                self.out[i] = 0
                i -= 1
            self.out[i] += 1
        self.out.append(t & 0xFF)
        self.c &= 0x7FFFF
        self.ct = 8

    def bit(self, st, i, val):
        sv = st[i]
        e = _ARITAB[sv & 0x7F]
        qe, nm, nl = e >> 16, (e >> 8) & 0xFF, e & 0xFF
        self.a -= qe
        if val != sv >> 7:                 # the less probable symbol
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while self.a < 0x8000:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._byte()

    def flush(self):
        t = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = t + 0x8000 if t < self.c else t
        self.c <<= self.ct
        self._byte()
        self.c <<= 8
        self._byte()
        data = bytes(self.out)
        while data.endswith(b"\0"):        # zeros come from the marker on
            data = data[:-1]
        return data.replace(b"\xff", b"\xff\x00")


FIXED = bytearray([113])


class Stats:
    """One restart interval's statistics: 64 DC and 256 AC bins a
    table, each component's DC context and prediction."""

    def __init__(self):
        self.dc, self.ac = {}, {}
        self.ctx, self.last = {}, {}

    def dcb(self, t):
        return self.dc.setdefault(t, bytearray(64))

    def acb(self, t):
        return self.ac.setdefault(t, bytearray(256))


def _magnitude(qm, st, i, v, dc, k=0, kx=5):
    """Figures F.8 and F.9 for |v| - 1 = v from bin st[i]: the category,
    then its bits below the top one."""
    m = 0
    if v:
        qm.bit(st, i, 1)
        m, v2 = 1, v
        if dc:
            i = 20
            v2 >>= 1
            while v2:
                qm.bit(st, i, 1)
                m <<= 1
                i += 1
                v2 >>= 1
        else:
            v2 >>= 1
            if v2:
                qm.bit(st, i, 1)
                m <<= 1
                i = 189 if k <= kx else 217
                v2 >>= 1
                while v2:
                    qm.bit(st, i, 1)
                    m <<= 1
                    i += 1
                    v2 >>= 1
    qm.bit(st, i, 0)
    i += 14
    m >>= 1
    while m:
        qm.bit(st, i, 1 if m & v else 0)
        m >>= 1


def encode_dc(qm, s, ci, t, diff, dac):
    """Figure F.4: one DC difference, and the context it leaves."""
    st, ctx = s.dcb(t), s.ctx.get(ci, 0)
    if diff == 0:
        qm.bit(st, ctx, 0)
        s.ctx[ci] = 0
        return
    qm.bit(st, ctx, 1)
    sign = diff < 0
    qm.bit(st, ctx + 1, int(sign))
    v = abs(diff) - 1
    _magnitude(qm, st, ctx + 2 + sign, v, True)
    lo, hi, _ = dac[t]
    m = 1 << v.bit_length() - 1 if v else 0     # the category's top bit
    if m < (1 << lo) >> 1:
        s.ctx[ci] = 0
    elif m > (1 << hi) >> 1:
        s.ctx[ci] = 12 + 4 * sign
    else:
        s.ctx[ci] = 4 + 4 * sign


def encode_ac_band(qm, s, t, vals, ss, se, dac):
    """Figure F.5 over coefficients ss..se (already shifted by Al)."""
    st, kx = s.acb(t), dac[t][2]
    ke = max([k for k in range(ss, se + 1) if vals[k]], default=0)
    k = ss
    while k <= ke:
        i = 3 * (k - 1)
        qm.bit(st, i, 0)
        while not vals[k]:
            qm.bit(st, i + 1, 0)
            i += 3
            k += 1
        qm.bit(st, i + 1, 1)
        qm.bit(FIXED, 0, int(vals[k] < 0))
        _magnitude(qm, st, i + 2, abs(int(vals[k])) - 1, False, k, kx)
        k += 1
    if k <= se:
        qm.bit(st, 3 * (k - 1), 1)


def encode_ac_refine(qm, s, t, zz, ss, se, ah, al):
    """Figure G.10: bit Al of coefficients ss..se."""
    st = s.acb(t)
    a = [abs(int(v)) for v in zz]
    ke = max([k for k in range(ss, se + 1) if a[k] >> al], default=0)
    kex = max([k for k in range(1, ke + 1) if a[k] >> ah], default=0)
    k = ss
    while k <= ke:
        i = 3 * (k - 1)
        if k > kex:
            qm.bit(st, i, 0)
        while True:
            v = a[k] >> al
            if v:
                if v >> 1:
                    qm.bit(st, i + 2, v & 1)
                else:
                    qm.bit(st, i + 1, 1)
                    qm.bit(FIXED, 0, int(zz[k] < 0))
                break
            qm.bit(st, i + 1, 0)
            i += 3
            k += 1
        k += 1
    if k <= se:
        qm.bit(st, 3 * (k - 1), 1)


def encode_arith(width, height, comps, coefs, qts, script=None, restart=0,
                 dac=None, tsel=None):
    """An arithmetic-coded JPEG of given quantized coefficients (zig-zag):
    SOF9 with one interleaved scan where `script` is None, else SOF10
    with its scans (component indices, Ss, Se, Ah, Al). dac: {table:
    (L, U, Kx)} written as a DAC segment; tsel: per component (DC, AC)
    conditioning table."""
    def seg(marker, data):
        return bytes([0xFF, marker]) + struct.pack(">H", len(data) + 2) + data

    tsel = tsel or [(min(i, 1), min(i, 1)) for i in range(len(comps))]
    conds = [(0, 1, 5)] * 16
    out = b"\xff\xd8"
    for tq, q in qts.items():
        out += seg(0xDB, bytes([tq]) + bytes(int(v) for v in q))
    sof = struct.pack(">BHHB", 8, height, width, len(comps))
    for i, (h, v, tq) in enumerate(comps):
        sof += bytes([i + 1, h << 4 | v, tq])
    out += seg(0xCA if script else 0xC9, sof)
    if dac:
        payload = b""
        for t, (lo, hi, kx) in dac.items():
            conds[t] = (lo, hi, kx)
            payload += bytes([t, hi << 4 | lo, 16 + t, kx])
        out += seg(0xCC, payload)
    if restart:
        out += seg(0xDD, struct.pack(">H", restart))
    hmax = max(c[0] for c in comps)
    vmax = max(c[1] for c in comps)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    for sc, ss, se, ah, al in script or [(list(range(len(comps))), 0, 63,
                                          0, 0)]:
        hdr = bytes([len(sc)]) + b"".join(
            bytes([i + 1, tsel[i][0] << 4 | tsel[i][1]]) for i in sc)
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
        qm, s, data = QMEncoder(), Stats(), b""
        for n, m in enumerate(mcus):
            if restart and n and n % restart == 0:
                data += qm.flush() + bytes([0xFF, 0xD0 + (n // restart - 1)
                                            % 8])
                qm, s = QMEncoder(), Stats()
            for i, by, bx in m:
                zz = coefs[i][by, bx]
                dt, at = tsel[i]
                if not script:
                    encode_dc(qm, s, i, dt, int(zz[0]) - s.last.get(i, 0),
                              conds)
                    s.last[i] = int(zz[0])
                    encode_ac_band(qm, s, at, zz, 1, 63, conds)
                elif ss == 0 and not ah:
                    v = int(zz[0]) >> al
                    encode_dc(qm, s, i, dt, v - s.last.get(i, 0), conds)
                    s.last[i] = v
                elif ss == 0:
                    qm.bit(FIXED, 0, (int(zz[0]) >> al) & 1)
                elif not ah:
                    sh = [int(np.sign(v)) * (abs(int(v)) >> al) for v in zz]
                    encode_ac_band(qm, s, at, sh, ss, se, conds)
                else:
                    encode_ac_refine(qm, s, at, zz, ss, se, ah, al)
        out += data + qm.flush()
    return out + b"\xff\xd9"


# ----------------------------------------------------------------- tests


@pytest.mark.parametrize("sampling", ["4:2:0", "4:4:4", "grey 2x2",
                                      "mixed", "4:2:2"])
def test_sequential_equals_pillow(tmp_path, sampling):
    """SOF9, one interleaved scan, at odd sizes, with and without restart
    intervals (2 MCUs)."""
    comps = SAMPLINGS[sampling]
    p = str(tmp_path / "a.jpg")
    for (w, h), rst in [((17, 23), 0), ((33, 65), 2), ((2, 9), 0),
                        ((40, 3), 3)]:
        with open(p, "wb") as f:
            f.write(encode_arith(w, h, comps, _big_coefs(comps, w, h, w + h),
                                 QTS, restart=rst))
        check(p)


@pytest.mark.parametrize("kind", ["spectral", "libjpeg", "deep", "bands"])
@pytest.mark.parametrize("sampling", ["4:2:0", "grey 2x2", "mixed"])
def test_progressive_equals_pillow(tmp_path, sampling, kind):
    """SOF10 under the progressive tests' scan scripts, with and without
    restarts."""
    comps = SAMPLINGS[sampling]
    p = str(tmp_path / "p.jpg")
    for (w, h), rst in [((17, 23), 0), ((33, 65), 2)]:
        with open(p, "wb") as f:
            f.write(encode_arith(w, h, comps, _big_coefs(comps, w, h, w * h),
                                 QTS, _script(len(comps), kind),
                                 restart=rst))
        check(p)


@pytest.mark.parametrize("dac", [{0: (0, 1, 5), 1: (0, 1, 5)},
                                 {0: (2, 5, 1), 1: (1, 3, 40)},
                                 {0: (0, 0, 63), 1: (5, 9, 0)}])
def test_conditioning_equals_pillow(tmp_path, dac):
    """DAC's DC bounds L, U and AC bound Kx other than the defaults, the
    components on tables 0 and 1 (and chroma sharing table 1's bins)."""
    comps = SAMPLINGS["4:2:0"]
    p = str(tmp_path / "c.jpg")
    cf = _big_coefs(comps, 33, 23, 7)
    for blob in (encode_arith(33, 23, comps, cf, QTS, dac=dac),
                 encode_arith(33, 23, comps, cf, QTS,
                              _script(3, "libjpeg"), dac=dac)):
        with open(p, "wb") as f:
            f.write(blob)
        check(p)


def test_large_coefficients_equal_pillow(tmp_path):
    """DC walks and AC values up to the 16-bit range (the DC difference's
    categories to 15), dequantized past it."""
    comps = [(1, 1, 0)]
    r = np.random.RandomState(3)
    cf = np.zeros((2, 6, 64), np.int64)
    cf[..., 0] = r.randint(-30000, 30000, (2, 6))
    cf[..., 1:20] = r.randint(-20000, 20000, (2, 6, 19)) * (
        r.rand(2, 6, 19) < 0.3)
    p = str(tmp_path / "l.jpg")
    for q in (1, 3):
        with open(p, "wb") as f:
            f.write(encode_arith(48, 16, comps, [cf], {0: np.full(64, q)}))
        check(p)


@pytest.mark.parametrize("part", range(2))
def test_damaged_arithmetic_data_equals_pillow(tmp_path, part):
    """Seeded single-byte damage to the scans of sequential and
    progressive files (a bad code stops the interval; a marker feeds
    zeros), and cut scans with EOI."""
    comps = SAMPLINGS["4:2:0"]
    cf = _big_coefs(comps, 64, 48, 11)
    blobs = [encode_arith(64, 48, comps, cf, QTS, restart=4),
             encode_arith(64, 48, comps, cf, QTS, _script(3, "libjpeg"))]
    p = str(tmp_path / "d.jpg")
    for blob in blobs:
        lo = blob.index(b"\xff\xda")
        for seed in range(20 * part, 20 * part + 20):
            r = np.random.RandomState(seed)
            at = r.randint(lo, len(blob) - 2)
            out = bytearray(blob)
            out[at] ^= r.randint(1, 256)
            with open(p, "wb") as f:
                f.write(bytes(out))
            _same(p)
        with open(p, "wb") as f:
            f.write(blob[:lo + (len(blob) - lo) // 2] + b"\xff\xd9")
        _same(p)


def _same(p):
    try:
        got = timages.load_image_uint8(p)
    except ValueError:
        got = None
    try:
        want = jimages.load_image_uint8(p)
    except Exception:
        want = None
    assert (got is None) == (want is None), p
    if got is not None:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("script", [None, "libjpeg", "bands"])
def test_past_the_first_64_kib_equals_pillow(tmp_path, script):
    """Files of 64-100 KB: Pillow hands libjpeg 64 KiB, then more only when
    reading markers makes it wait, and jdarith.c cannot wait inside a
    scan, so a scan whose data runs past what was handed over is refused
    by both; a progressive file whose scans straddle the boundary at a
    marker is read by both."""
    comps = SAMPLINGS["4:4:4"]
    p = str(tmp_path / "b.jpg")
    for w, rst in ((272, 0), (264, 4)):
        cf = _big_coefs(comps, w, 200, 5)
        r = np.random.RandomState(w)
        for c in cf:
            c[..., 1:40] += r.randint(-14, 14, c[..., 1:40].shape)
        blob = encode_arith(w, 200, comps, cf, QTS,
                            script and _script(3, script), restart=rst)
        assert 1 << 16 < len(blob) < 100_000
        with open(p, "wb") as f:
            f.write(blob)
        _same(p)
