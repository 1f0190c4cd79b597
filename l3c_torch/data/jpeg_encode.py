"""Baseline JPEG encoding, byte for byte as Pillow writes it.

Image.fromarray(rgb).save(f, format="JPEG", quality=q) runs libjpeg-turbo
with its defaults: jpeg_set_quality(q, force_baseline=TRUE) on the Annex K
tables, YCbCr 4:2:0 (Y 2x2, Cb and Cr 1x1), the "islow" integer forward
DCT, the standard Huffman tables (no optimisation, no restart markers) and
a JFIF APP0 marker. This module repeats each of those integer stages in
numpy, so its files are Pillow's:

  - jpeg_quality_scaling and jpeg_add_quant_table (jcparam.c);
  - rgb_ycc_convert's fixed-point tables (jccolor.c, SCALEBITS 16, the
    B -> Cb / R -> Cr table shared, with its ONE_HALF - 1 rounding);
  - the edges replicated to the block extent (expand_right_edge, then the
    bottom rows, jcprepct.c / jcsample.c) and h2v2_downsample's 2x2 mean
    with the bias alternating 1, 2 along a row;
  - jpeg_fdct_islow (jfdctint.c: CONST_BITS 13, PASS1_BITS 2) on samples
    centred by -128, and quantize() with compute_reciprocal's divisors
    (jcdctmgr.c): |coef| + correction times the reciprocal, shifted;
  - the dummy blocks of a partial MCU (jccoefct.c): AC zero, DC copied
    from the block before;
  - Huffman coding with the standard tables, 0xFF00 stuffing and the last
    byte padded with ones (jchuff.c), the markers in jcmarker.c's order:
    SOI, APP0, DQT (one a table), SOF0, DHT (DC0, AC0, DC1, AC1), SOS,
    the scan, EOI.

The pixel stages are vectorised; the Huffman stage too (the symbols of all
blocks laid out in stream order, then packed as one bit array).
"""
from __future__ import annotations

import struct

import numpy as np

from .jpeg import CONST_BITS, FIX, PASS1_BITS, ZIGZAG

# Annex K.1, natural (row-major) order
STD_LUMINANCE_QT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
STD_CHROMINANCE_QT = np.full(64, 99)
STD_CHROMINANCE_QT[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]

# Annex K.3: the DHT payload of each table after its class/id byte (16
# code counts, then the symbols), by (class, id): class 0 DC, 1 AC
STD_HUFFMAN = {k: bytes.fromhex(v) for k, v in {
    (0, 0): "00010501010101010100000000000000000102030405060708090a0b",
    (1, 0): "0002010303020403050504040000017d0102030004110512213141061351"
            "6107227114328191a1082342b1c11552d1f02433627282090a161718191a"
            "25262728292a3435363738393a434445464748494a535455565758595a63"
            "6465666768696a737475767778797a838485868788898a92939495969798"
            "999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2"
            "d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa",
    (0, 1): "00030101010101010101010000000000000102030405060708090a0b",
    (1, 1): "000201020404030407050404000102770001020311040521310612415107"
            "61711322328108144291a1b1c109233352f0156272d10a162434e125f117"
            "18191a262728292a35363738393a434445464748494a535455565758595a"
            "636465666768696a737475767778797a82838485868788898a9293949596"
            "9798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9"
            "cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"}.items()}

JFIF_APP0 = b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"


def quant_tables(quality: int) -> tuple:
    """jpeg_set_quality(quality, force_baseline=TRUE): the luminance and
    chrominance tables, natural order."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255)
                 for t in (STD_LUMINANCE_QT, STD_CHROMINANCE_QT))


def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)


def rgb_to_ycc(rgb: np.ndarray) -> tuple:
    """jccolor.c's rgb_ycc_convert: (H, W, 3) uint8 -> Y, Cb, Cr (H, W)
    int64 planes."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half = 1 << 15
    cbcr = (128 << 16) + half - 1
    y = (_fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b
         + half) >> 16
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b
          + cbcr) >> 16
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b
          + cbcr) >> 16
    return y, cb, cr


def h2v2_downsample(c: np.ndarray) -> np.ndarray:
    """jcsample.c's h2v2_downsample of an even-sized plane: the 2x2 sum
    plus a bias of 1, 2, 1, 2, ... along each output row, over 4."""
    s = c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] + c[1::2, 1::2]
    bias = np.tile([1, 2], s.shape[1] // 2 + 1)[:s.shape[1]]
    return (s + bias) >> 2


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def _fdct_1d(d: np.ndarray, even_shift: int, odd_shift: int,
             even_left: bool) -> np.ndarray:
    """One pass of jpeg_fdct_islow over the last axis (int64). Outputs 0
    and 4 are shifted left by PASS1_BITS in the first pass and descaled
    by it in the second; the rest descaled by `odd_shift`."""
    f = FIX
    tmp0, tmp7 = d[..., 0] + d[..., 7], d[..., 0] - d[..., 7]
    tmp1, tmp6 = d[..., 1] + d[..., 6], d[..., 1] - d[..., 6]
    tmp2, tmp5 = d[..., 2] + d[..., 5], d[..., 2] - d[..., 5]
    tmp3, tmp4 = d[..., 3] + d[..., 4], d[..., 3] - d[..., 4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = np.empty_like(d)
    if even_left:
        out[..., 0] = (tmp10 + tmp11) << even_shift
        out[..., 4] = (tmp10 - tmp11) << even_shift
    else:
        out[..., 0] = _descale(tmp10 + tmp11, even_shift)
        out[..., 4] = _descale(tmp10 - tmp11, even_shift)
    z1 = (tmp12 + tmp13) * f["0_541196100"]
    out[..., 2] = _descale(z1 + tmp13 * f["0_765366865"], odd_shift)
    out[..., 6] = _descale(z1 + tmp12 * -f["1_847759065"], odd_shift)
    z1, z2 = tmp4 + tmp7, tmp5 + tmp6
    z3, z4 = tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * f["1_175875602"]
    tmp4 = tmp4 * f["0_298631336"]
    tmp5 = tmp5 * f["2_053119869"]
    tmp6 = tmp6 * f["3_072711026"]
    tmp7 = tmp7 * f["1_501321110"]
    z1 = z1 * -f["0_899976223"]
    z2 = z2 * -f["2_562915447"]
    z3 = z3 * -f["1_961570560"] + z5
    z4 = z4 * -f["0_390180644"] + z5
    out[..., 7] = _descale(tmp4 + z1 + z3, odd_shift)
    out[..., 5] = _descale(tmp5 + z2 + z4, odd_shift)
    out[..., 3] = _descale(tmp6 + z2 + z3, odd_shift)
    out[..., 1] = _descale(tmp7 + z1 + z4, odd_shift)
    return out


def fdct_islow(samples: np.ndarray) -> np.ndarray:
    """(N, 8, 8) samples 0..255 -> (N, 8, 8) int64 coefficients, scaled up
    by 8 as jfdctint.c leaves them: rows, then columns."""
    d = samples.astype(np.int64) - 128
    d = _fdct_1d(d, PASS1_BITS, CONST_BITS - PASS1_BITS, True)
    d = _fdct_1d(np.swapaxes(d, 1, 2), PASS1_BITS, CONST_BITS + PASS1_BITS,
                 False)
    return np.swapaxes(d, 1, 2)


def _divisors(qt: np.ndarray) -> tuple:
    """compute_reciprocal for each divisor q << 3 (16-bit DCTELEM):
    (reciprocal, correction, total shift)."""
    recip, corr, shift = (np.empty(64, np.int64) for _ in range(3))
    for i, q in enumerate(qt):
        d = int(q) << 3
        b = d.bit_length() - 1
        r = 16 + b
        fq, fr = divmod(1 << r, d)
        c = d // 2
        if fr == 0:
            fq >>= 1
            r -= 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        recip[i], corr[i], shift[i] = fq, c, r
    return recip, corr, shift


def quantize(coefs: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """jcdctmgr.c's quantize of (N, 8, 8) coefficients by a natural-order
    table: (|x| + correction) * reciprocal >> shift, the sign restored."""
    recip, corr, shift = (v.reshape(8, 8) for v in _divisors(qt))
    mag = ((np.abs(coefs) + corr) * recip) >> shift
    return np.where(coefs < 0, -mag, mag)


def _blocks(plane: np.ndarray, bh: int, bw: int) -> np.ndarray:
    """The (bh, bw) 8x8 blocks of a plane at least that large, as
    (bh * bw, 8, 8), row-major."""
    p = plane[:8 * bh, :8 * bw]
    return p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)


def _coefficients(rgb: np.ndarray, quality: int) -> tuple:
    """The quantized coefficients in stream order: (blocks, 64) zig-zag
    int64, the component of each block, and the two tables."""
    h, w = rgb.shape[:2]
    qy, qc = quant_tables(quality)
    mcux, mcuy = -(-w // 16), -(-h // 16)
    y, cb, cr = rgb_to_ycc(rgb)
    # Y: replicated to its own block extent; blocks of the MCU past it
    # are dummies
    wb, hb = -(-w // 8), -(-h // 8)
    yp = np.pad(y, ((0, 8 * hb - h), (0, 8 * wb - w)), mode="edge")
    yq = quantize(fdct_islow(_blocks(yp, hb, wb)), qy).reshape(hb, wb, 64)
    ygrid = np.zeros((2 * mcuy, 2 * mcux, 64), np.int64)
    ygrid[:hb, :wb] = yq
    if wb % 2:                       # right dummies: DC of the block left
        ygrid[:hb, wb, 0] = ygrid[:hb, wb - 1, 0]
    if hb % 2:                       # bottom dummies: DC of the MCU's
        top_right = ygrid[hb - 1, 1::2, 0]        # block before them
        ygrid[hb, 0::2, 0] = top_right
        ygrid[hb, 1::2, 0] = top_right
    # Cb, Cr: replicated to even rows and the MCU's columns, downsampled,
    # then replicated down to the MCU's rows
    chroma = []
    for c in (cb, cr):
        cp = np.pad(c, ((0, h % 2), (0, 16 * mcux - w)), mode="edge")
        d = h2v2_downsample(cp)
        d = np.pad(d, ((0, 8 * mcuy - d.shape[0]), (0, 0)), mode="edge")
        chroma.append(quantize(fdct_islow(_blocks(d, mcuy, mcux)), qc))
    # MCU order: Y00 Y01 Y10 Y11 Cb Cr
    yb = ygrid.reshape(mcuy, 2, mcux, 2, 64).transpose(0, 2, 1, 3, 4)
    mcus = np.concatenate([yb.reshape(mcuy, mcux, 4, 64)]
                          + [c.reshape(mcuy, mcux, 1, 64) for c in chroma],
                          axis=2).reshape(-1, 64)
    comp = np.tile([0, 0, 0, 0, 1, 2], mcuy * mcux)
    return mcus[:, ZIGZAG], comp, qy, qc


def _code_table(payload: bytes) -> tuple:
    """A DHT payload -> (code, length) arrays indexed by symbol."""
    counts, syms = payload[:16], payload[16:]
    code = np.zeros(256, np.int64)
    length = np.zeros(256, np.int64)
    c = k = 0
    for n in range(1, 17):
        for _ in range(counts[n - 1]):
            code[syms[k]], length[syms[k]] = c, n
            c += 1
            k += 1
        c <<= 1
    return code, length


_TABLES = {k: _code_table(v) for k, v in STD_HUFFMAN.items()}


def _nbits(v: np.ndarray) -> np.ndarray:
    """Bits of |v| (jchuff.c's JPEG_NBITS)."""
    a = np.abs(v)
    n = np.zeros_like(a)
    for b in range(16):
        n += (a >> b) > 0
    return n


def _huffman(zz: np.ndarray, comp: np.ndarray) -> bytes:
    """Entropy-code the blocks (stream order) with the standard tables:
    each symbol's code and its extra bits as one item (value, length),
    the items laid out in stream order, packed MSB first, stuffed."""
    nblk = len(zz)
    tsel = np.minimum(comp, 1)              # Y: tables 0, Cb/Cr: tables 1
    # DC differences, per component
    dc = zz[:, 0]
    diff = np.empty(nblk, np.int64)
    for ci in range(3):
        idx = np.flatnonzero(comp == ci)
        d = dc[idx]
        diff[idx] = d - np.concatenate([[0], d[:-1]])
    s = _nbits(diff)
    dcode = np.where(tsel == 0, _TABLES[0, 0][0][s], _TABLES[0, 1][0][s])
    dlen = np.where(tsel == 0, _TABLES[0, 0][1][s], _TABLES[0, 1][1][s])
    extra = np.where(diff < 0, diff - 1, diff) & ((1 << s) - 1)
    keys = [np.arange(nblk) * 2048]
    vals = [(dcode << s) | extra]
    lens = [dlen + s]
    # AC: each nonzero coefficient after a run of zeros (ZRL for each 16)
    blk, k = np.nonzero(zz[:, 1:])
    k = k + 1
    v = zz[blk, k]
    first = np.ones(len(blk), bool)
    first[1:] = blk[1:] != blk[:-1]
    prev = np.where(first, 0, np.concatenate([[0], k[:-1]]))
    run = k - prev - 1
    zrl, r = run // 16, run % 16
    s = _nbits(v)
    sym = (r << 4) | s
    ac0, ac1 = _TABLES[1, 0], _TABLES[1, 1]
    t = tsel[blk]
    acode = np.where(t == 0, ac0[0][sym], ac1[0][sym])
    alen = np.where(t == 0, ac0[1][sym], ac1[1][sym])
    keys.append(blk * 2048 + k * 32 + 16)
    vals.append((acode << s) | (np.where(v < 0, v - 1, v) & ((1 << s) - 1)))
    lens.append(alen + s)
    zb = np.repeat(np.arange(len(blk)), zrl)
    if len(zb):
        zi = np.arange(len(zb)) - np.repeat(np.cumsum(zrl) - zrl, zrl)
        zt = t[zb]
        keys.append(blk[zb] * 2048 + k[zb] * 32 + zi)
        vals.append(np.where(zt == 0, ac0[0][0xF0], ac1[0][0xF0]))
        lens.append(np.where(zt == 0, ac0[1][0xF0], ac1[1][0xF0]))
    # EOB where the block's last coefficient is zero
    last = np.zeros(nblk, np.int64)
    np.maximum.at(last, blk, k)
    eob = np.flatnonzero(last < 63)
    te = tsel[eob]
    keys.append(eob * 2048 + 2047)
    vals.append(np.where(te == 0, ac0[0][0], ac1[0][0]))
    lens.append(np.where(te == 0, ac0[1][0], ac1[1][0]))
    order = np.argsort(np.concatenate(keys), kind="stable")
    val = np.concatenate(vals)[order]
    ln = np.concatenate(lens)[order]
    # pack: bit j of an item of length n is bit n - 1 - j of its value
    total = int(ln.sum())
    pad = -total % 8
    start = np.cumsum(ln) - ln
    pos = np.arange(total) - np.repeat(start, ln)
    bits = (np.repeat(val, ln) >> (np.repeat(ln, ln) - 1 - pos)) & 1
    bits = np.concatenate([bits, np.ones(pad, np.int64)]).astype(np.uint8)
    return np.packbits(bits).tobytes().replace(b"\xff", b"\xff\x00")


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) \
        + payload


def encode_jpeg(rgb: np.ndarray, quality: int = 75) -> bytes:
    """The JPEG file Image.fromarray(rgb).save(f, format="JPEG",
    quality=quality) writes, for an (H, W, 3) uint8 array."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3 \
            or not (1 <= rgb.shape[0] <= 65535 and 1 <= rgb.shape[1]
                    <= 65535):
        raise ValueError(f"encode_jpeg takes (H, W, 3) uint8 RGB with sides "
                         f"1..65535, got {rgb.dtype} {rgb.shape}")
    h, w = rgb.shape[:2]
    zz, comp, qy, qc = _coefficients(rgb, quality)
    out = [b"\xff\xd8", JFIF_APP0]
    for tq, qt in enumerate((qy, qc)):
        out.append(_segment(0xDB, bytes([tq]) + bytes(
            int(v) for v in qt[ZIGZAG])))
    out.append(_segment(0xC0, struct.pack(">BHHB", 8, h, w, 3) + bytes(
        [1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for tc, th in ((0, 0), (1, 0), (0, 1), (1, 1)):
        out.append(_segment(0xC4, bytes([tc << 4 | th])
                            + STD_HUFFMAN[tc, th]))
    out.append(_segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11,
                                     0, 63, 0])))
    out.append(_huffman(zz, comp))
    out.append(b"\xff\xd9")
    return b"".join(out)
