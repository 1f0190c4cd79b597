"""JPEG 2000 Tier-1 (EBCOT): one code-block's coefficients from its coded
segments, as OpenJPEG 2.5's opj_t1_decode_cblk decodes them.

The MQ decoder is ISO 15444-1 Annex C's (C.3.2 DECODE, C.3.3 RENORMD,
C.3.4 BYTEIN) over its 47-state table, each segment followed by an
artificial 0xFF 0xFF marker so that a pass read past its data reads
1-bits, as OpenJPEG pads it. BYPASS passes are read raw, bit-unstuffed
after 0xFF. The three passes (significance propagation, magnitude
refinement and cleanup with its run mode) use the 19 contexts of Annex D,
and every code-block style bit: BYPASS, RESET, TERMALL (through the
segments the packet headers gave), VSC, PTERM (nothing to do when
decoding) and SEGSYM. Coefficients keep OpenJPEG's one extra low bit: a
coefficient found significant at bit-plane p is 3 * 2^(p-1) of those
units, its mid-point, and each refinement moves it by half a plane.

Each sample's state is one int of flags: its eight neighbours'
significance, the signs of the four direct ones, and its own
significance, "visited in this bit-plane" and "refined before" bits,
updated on the neighbours whenever a sample becomes significant.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

# code-block style bits (COD/COC SPcod)
BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM, HT = 1, 2, 4, 8, 16, 32, 64
HT_MIXED = 128

# Table C.2: Qe, the next state after an MPS and after an LPS, switch
_QE = (0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401,
       0x4801, 0x3801, 0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401,
       0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201,
       0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1,
       0x08A1, 0x0521, 0x0441, 0x02A1, 0x0221, 0x0141, 0x0111, 0x0085,
       0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601)
_NMPS = (1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16, 17, 18,
         19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
         35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46)
_NLPS = (1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14, 15,
         16, 17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30,
         31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46)
_SWITCH = (1, 0, 0, 0, 0, 0, 1) + (0,) * 7 + (1,) + (0,) * 32
# a context is one int, state * 2 + MPS; these tables are indexed by it
QE = [_QE[s >> 1] for s in range(94)]
NMPS = [_NMPS[s >> 1] * 2 + (s & 1) for s in range(94)]
NLPS = [_NLPS[s >> 1] * 2 + ((s & 1) ^ _SWITCH[s >> 1]) for s in range(94)]

# contexts: 0-8 zero coding, 9-13 sign, 14-16 refinement, run, uniform
CTX_AGG, CTX_UNI = 17, 18

# flag bits of one sample
NW, N, NE, W, E, SW, S, SE = 1, 2, 4, 8, 16, 32, 64, 128
NEIGH = 0xFF
NNEG, WNEG, ENEG, SNEG = 256, 512, 1024, 2048
SIG, VISIT, REFINED = 4096, 8192, 16384


def _zc(f: int, band: int) -> int:
    """Table D.1: the zero-coding context of neighbourhood `f` in a band
    (0 LL, 1 HL, 2 LH, 3 HH)."""
    h = bool(f & W) + bool(f & E)
    v = bool(f & N) + bool(f & S)
    d = bool(f & NW) + bool(f & NE) + bool(f & SW) + bool(f & SE)
    if band == 1:
        h, v = v, h
    if band == 3:
        hv = h + v
        if d >= 3:
            return 8
        if d == 2:
            return 7 if hv else 6
        if d == 1:
            return 5 if hv >= 2 else 4 if hv else 3
        return 2 if hv >= 2 else hv
    if h == 2:
        return 8
    if h == 1:
        return 7 if v else 6 if d else 5
    if v:
        return 2 + v
    return min(d, 2)


def _sc(f: int) -> int:
    """Table D.3: the sign context * 2 + the XOR bit of flags `f`."""
    def part(a, an, b, bn):
        s = (0 if not f & a else -1 if f & an else 1) + \
            (0 if not f & b else -1 if f & bn else 1)
        return max(-1, min(1, s))
    h, v = part(W, WNEG, E, ENEG), part(N, NNEG, S, SNEG)
    if h == 0:
        return (9 + abs(v)) * 2 + (v < 0)
    return (12 + h * v) * 2 + (h < 0)


ZC = [[_zc(f, b) for f in range(256)] for b in range(4)]
SC = [_sc(f) for f in range(4096)]


class _MQ:
    """The MQ decoder over one segment (INITDEC, DECODE, RENORMD,
    BYTEIN) or, raw, its bits with a 0 bit stuffed after each 0xFF."""

    __slots__ = ("d", "bp", "a", "c", "ct")

    def __init__(self, data: bytes, raw: bool):
        self.d = data + b"\xff\xff"
        self.bp = 0
        if raw:
            self.c = self.ct = 0
            return
        self.c = self.d[0] << 16
        self._bytein()
        self.c <<= 7
        self.ct -= 7
        self.a = 0x8000

    def _bytein(self):
        d, bp = self.d, self.bp
        if d[bp] == 0xFF:
            if d[bp + 1] > 0x8F:
                self.c += 0xFF00
                self.ct = 8
            else:
                self.bp = bp + 1
                self.c += d[bp + 1] << 9
                self.ct = 7
        else:
            self.bp = bp + 1
            self.c += d[bp + 1] << 8
            self.ct = 8

    def decode(self, cx: list, k: int) -> int:
        s = cx[k]
        q = QE[s]
        a = self.a - q
        c = self.c
        if (c >> 16) < q:
            if a < q:
                bit = s & 1
                cx[k] = NMPS[s]
            else:
                bit = (s & 1) ^ 1
                cx[k] = NLPS[s]
            a = q
        else:
            c -= q << 16
            if a & 0x8000:
                self.a, self.c = a, c
                return s & 1
            if a < q:
                bit = (s & 1) ^ 1
                cx[k] = NLPS[s]
            else:
                bit = s & 1
                cx[k] = NMPS[s]
        ct = self.ct
        while True:
            if ct == 0:
                self.c = c
                self._bytein()
                c, ct = self.c, self.ct
            a <<= 1
            c <<= 1
            ct -= 1
            if a >= 0x8000:
                break
        self.a, self.c, self.ct = a, c, ct
        return bit

    def raw(self) -> int:
        if self.ct == 0:
            d, bp = self.d, self.bp
            if self.c == 0xFF:
                if d[bp] > 0x8F:
                    self.ct = 8
                else:
                    self.c = d[bp]
                    self.bp = bp + 1
                    self.ct = 7
            else:
                self.c = d[bp]
                self.bp = bp + 1
                self.ct = 8
        self.ct -= 1
        return (self.c >> self.ct) & 1


def _fresh_contexts() -> list:
    cx = [0] * 19
    cx[CTX_UNI] = 46 * 2
    cx[CTX_AGG] = 3 * 2
    cx[0] = 4 * 2
    return cx


def _significant(F: list, i: int, neg: int, W2: int, top: bool) -> None:
    """Sample `i` became significant: tell its neighbours (not the stripe
    above when `top`, a stripe's first row under VSC)."""
    F[i] |= SIG
    F[i - 1] |= E | (ENEG if neg else 0)
    F[i + 1] |= W | (WNEG if neg else 0)
    if not top:
        u = i - W2
        F[u] |= S | (SNEG if neg else 0)
        F[u - 1] |= SE
        F[u + 1] |= SW
    u = i + W2
    F[u] |= N | (NNEG if neg else 0)
    F[u - 1] |= NE
    F[u + 1] |= NW


def _order(w: int, h: int, W2: int) -> List[Tuple[int, int, int]]:
    """The stripe scan: (flag index, row within the stripe, value index)."""
    out = []
    for y0 in range(0, h, 4):
        for x in range(w):
            for y in range(y0, min(y0 + 4, h)):
                out.append(((y + 1) * W2 + x + 1, y - y0, y * w + x))
    return out


def _sigpass(mq, cx, F, V, scan, zc, one, vsc, W2, raw):
    oph = one | (one >> 1)
    for i, ci, j in scan:
        f = F[i]
        if f & (SIG | VISIT) or not f & NEIGH:
            continue
        if raw:
            hit = mq.raw()
        else:
            hit = mq.decode(cx, zc[f & NEIGH])
        if hit:
            if raw:
                neg = mq.raw()
            else:
                s = SC[f & 0xFFF]
                neg = mq.decode(cx, s >> 1) ^ (s & 1)
            V[j] = -oph if neg else oph
            _significant(F, i, neg, W2, vsc and ci == 0)
        F[i] |= VISIT


def _refpass(mq, cx, F, V, scan, one, raw):
    half = one >> 1
    for i, ci, j in scan:
        f = F[i]
        if (f & (SIG | VISIT)) != SIG:
            continue
        if raw:
            bit = mq.raw()
        else:
            bit = mq.decode(cx, 16 if f & REFINED else
                            15 if f & NEIGH else 14)
        v = V[j]
        V[j] = v + (half if bit ^ (v < 0) else -half)
        F[i] = f | REFINED


def _clnpass(mq, cx, F, V, w, h, W2, zc, one, vsc, segsym):
    oph = one | (one >> 1)
    decode = mq.decode
    for y0 in range(0, h, 4):
        rows = min(4, h - y0)
        for x in range(w):
            i0 = (y0 + 1) * W2 + x + 1
            start, partial = 0, False
            if rows == 4 and not (F[i0] | F[i0 + W2] | F[i0 + 2 * W2]
                                  | F[i0 + 3 * W2]):
                if not decode(cx, CTX_AGG):
                    continue
                start = decode(cx, CTX_UNI) << 1
                start |= decode(cx, CTX_UNI)
                partial = True
            for ci in range(start, rows):
                i = i0 + ci * W2
                f = F[i]
                if not partial:
                    if f & (SIG | VISIT):
                        F[i] = f & ~VISIT
                        continue
                    if not decode(cx, zc[f & NEIGH]):
                        continue
                partial = False
                s = SC[f & 0xFFF]
                neg = decode(cx, s >> 1) ^ (s & 1)
                V[(y0 + ci) * w + x] = -oph if neg else oph
                _significant(F, i, neg, W2, vsc and ci == 0)
    if segsym:
        for _ in range(4):
            decode(cx, CTX_UNI)


def decode_cblk(w: int, h: int, band: int, segments: Sequence[
        Tuple[bytes, int]], numbps: int, roishift: int, style: int
        ) -> np.ndarray:
    """(h, w) int64 coefficients, in units of half the finest bit-plane,
    of a code-block of band `band` (0 LL, 1 HL, 2 LH, 3 HH) from its
    segments (data, passes), `numbps` bit-planes (OpenJPEG's: the band's
    Mb + 1 less the zero bit-planes) and the ROI shift."""
    W2 = w + 2
    F = [0] * (W2 * (h + 2))
    V = [0] * (w * h)
    scan = _order(w, h, W2)
    zc = ZC[band]
    vsc, segsym = bool(style & VSC), bool(style & SEGSYM)
    cx = _fresh_contexts()
    bpno = roishift + numbps
    passtype = 2
    for data, npasses in segments:
        raw = bool(style & BYPASS) and passtype < 2 and bpno <= numbps - 4
        mq = _MQ(data, raw)
        for _ in range(npasses):
            if bpno < 1:
                break
            one = 1 << bpno
            if passtype == 0:
                _sigpass(mq, cx, F, V, scan, zc, one, vsc, W2, raw)
            elif passtype == 1:
                _refpass(mq, cx, F, V, scan, one, raw)
            else:
                _clnpass(mq, cx, F, V, w, h, W2, zc, one, vsc, segsym)
            if style & RESET and not raw:
                cx[:] = _fresh_contexts()
            passtype += 1
            if passtype == 3:
                passtype = 0
                bpno -= 1
    out = np.array(V, np.int64).reshape(h, w)
    if roishift:
        mag = np.abs(out)
        big = mag >= (1 << roishift)
        out = np.where(big, np.sign(out) * (mag >> roishift), out)
    return out
