"""HTJ2K (ISO 15444-15) block decoding: one HT code-block's coefficients
from its cleanup segment and its refinement segment, as OpenJPEG 2.5.4's
opj_t1_ht_decode_cblk (ht_dec.c) decodes them, bit for bit.

  - the cleanup pass: Lcup and Scup from the segment's last two bytes;
    the MEL stream (forward, MSB first, its last byte's low nibble set,
    0xFF after its end) over the 13-state exponent table; the VLC stream
    (backward from the Scup nibble, LSB first, a 0x7F / 0xFF byte after a
    byte above 0x8F holding 7 bits, 0s after its end) decoded a quad pair
    at a time through the CxtVLC tables, the first quad row's U-VLC rule
    (a MEL event when both quads need u) and the other rows' kappa from
    the exponents of the row above; the MagSgn stream (forward, 7 bits
    after an 0xFF byte, 1s after its end);
  - SigProp (forward over the second segment, 0s after its end) and MagRef
    (backward from its end), a stripe of four rows at a time, with the
    stripe-causal (VSC) bit;
  - OpenJPEG's refusals (ROI, more than 3 passes, Mb above 30, more zero
    bit-planes than Mb, bad segment lengths, Scup outside [2, min(Lcup,
    4079)], a bad MEL start, U_q past the zero bit-planes + 2, a
    significant sample outside the block) raise HTError with its
    message; where it only warns (a second pass with no bytes, passes
    past the last bit-plane) the cleanup pass is decoded alone, as it
    does.

Each stream is first unstuffed into packed LSB-first bits (each byte at
its position, a 7-bit byte's top bit ORed into the next position, as
OpenJPEG's 64-bit readers leave it), so that what is read does not depend
on where the data sits in memory; only mel_init's check of the MEL's
first bytes does. The result is in decode_cblk's units
(data/jpeg2000_t1.py): OpenJPEG's 32-bit sign-magnitude words with their
one extra low bit, as its dequantisation takes them.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .jpeg2000_ht_tables import MEL_EXP, UVLC_DEC, VLC_TBL0, VLC_TBL1
from .jpeg2000_t1 import VSC

M32 = 0xFFFFFFFF


class HTError(ValueError):
    """An HT code-block OpenJPEG refuses: its decode of the image fails."""


def _lsb_bits(vals: np.ndarray, nbits: np.ndarray, fill: int, pad: int
              ) -> bytes:
    """LSB-first bits of `vals` (each value's first nbits bits at its
    position, the bit past them ORed into the next position), then `fill`
    (0 or 1) bits, `pad` bytes of them, packed LSB first."""
    pos = np.zeros(len(vals), np.int64)
    if len(vals):
        pos[1:] = np.cumsum(nbits)[:-1]
    total = int(nbits.sum())
    bits = np.zeros(total + 8 * pad + 16, np.uint8)
    bits[total:] = fill
    for j in range(8):
        m = nbits > j
        bits[pos[m] + j] = (vals[m] >> j) & 1
    over = (vals >> nbits) & 1
    bits[pos + nbits] |= over.astype(np.uint8)
    return np.packbits(bits, bitorder="little").tobytes()


def _forward(data: bytes, fill: int, pad: int) -> bytes:
    """A forward stream (MagSgn with 1s after its end, SigProp with 0s):
    a byte after 0xFF holds 7 bits."""
    v = np.frombuffer(data, np.uint8).astype(np.int64)
    nb = np.full(len(v), 8, np.int64)
    nb[1:][v[:-1] == 0xFF] = 7
    return _lsb_bits(v, nb, fill, pad)


def _backward(data: bytes, unstuff: bool, pad: int, head=None) -> bytes:
    """A backward stream (VLC, MagRef) of `data` read from its end (after
    the VLC's first nibble `head`, (value, bits)): a byte whose low 7 bits
    are set holds 7 bits after a byte above 0x8F; 0s after its end."""
    v = np.frombuffer(data[::-1], np.uint8).astype(np.int64)
    prev = np.empty(len(v), bool)
    if len(v):
        prev[0] = unstuff
        prev[1:] = v[:-1] > 0x8F
    nb = np.where(prev & ((v & 0x7F) == 0x7F), 7, 8)
    if head is not None:
        v = np.concatenate([[head[0]], v])
        nb = np.concatenate([[head[1]], nb])
    return _lsb_bits(v, nb.astype(np.int64), 0, pad)


class _Reader:
    """An LSB-first bit reader over a packed stream."""
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf, self.pos = buf, 0

    def fetch(self) -> int:
        """The next 32 bits (at least)."""
        p = self.pos
        return int.from_bytes(self.buf[p >> 3:(p >> 3) + 5], "little") >> \
            (p & 7)


def _mel_runs(mel: bytes):
    """The MEL decoder's runs, as mel_get_run returns them: 2n for n zero
    events, 2n + 1 for n zeros then a one."""
    bits: List[int] = []
    prev = 0
    for i, d in enumerate(mel):
        if i == len(mel) - 1:
            d |= 0xF
        nb = 7 if prev == 0xFF else 8
        bits.extend((d >> k) & 1 for k in range(nb - 1, -1, -1))
        prev = d
    n, at, k = len(bits), 0, 0
    while True:
        e = MEL_EXP[k]
        if (bits[at] if at < n else 1):
            at += 1
            k = min(k + 1, 12)
            yield ((1 << e) - 1) << 1
        else:
            r = 0
            for i in range(at + 1, at + 1 + e):
                r = (r << 1) | (bits[i] if i < n else 1)
            at += e + 1
            k = max(k - 1, 0)
            yield (r << 1) + 1


def _mel_start_ok(coded: bytes, lcup: int, scup: int, at: int) -> bool:
    """mel_init's check of the MEL's first bytes (as many as reach the
    next 4-byte boundary of the buffer, `at` being the segment's offset
    in it): no byte above 0x8F after an 0xFF."""
    start = lcup - scup
    num = 4 - ((at + start) & 3)
    size, p, unstuff = scup - 1, start, False
    for _ in range(num):
        if unstuff and coded[p] > 0x8F:
            return False
        d = coded[p] if size > 0 else 0xFF
        if size == 1:
            d |= 0xF
        if size > 0:
            p += 1
        size -= 1
        unstuff = d == 0xFF
    return True


def _uvlc(v: int, mode: int, first: bool):
    """(u_q0 + 1, u_q1 + 1, bits used) of a quad pair's U-VLC codes:
    decode_init_uvlc where `first`, else decode_noninit_uvlc (mode 4:
    the first row's MEL event was 1)."""
    if mode == 0:
        return 1, 1, 0
    d1 = UVLC_DEC[v & 7]
    v >>= d1 & 3
    used = d1 & 3
    if mode <= 2:
        sl = (d1 >> 2) & 7
        u = (d1 >> 5) + (v & ((1 << sl) - 1)) + 1
        return (u, 1, used + sl) if mode == 1 else (1, u, used + sl)
    if first and mode == 3 and (d1 & 3) > 2:
        u1 = (v & 1) + 2
        v >>= 1
        sl = (d1 >> 2) & 7
        return (d1 >> 5) + (v & ((1 << sl) - 1)) + 1, u1, used + 1 + sl
    d2 = UVLC_DEC[v & 7]
    v >>= d2 & 3
    used += d2 & 3
    add = 3 if first and mode == 4 else 1
    sl = (d1 >> 2) & 7
    u0 = (d1 >> 5) + (v & ((1 << sl) - 1)) + add
    v >>= sl
    sl2 = (d2 >> 2) & 7
    u1 = (d2 >> 5) + (v & ((1 << sl2) - 1)) + add
    return u0, u1, used + sl + sl2


def _cleanup(coded, lcup, scup, w, h, p, zbp1, pad, align):
    """The cleanup pass: the (h * w) 32-bit words and the significance
    of each sample."""
    if not _mel_start_ok(coded, lcup, scup, align):
        raise HTError("Malformed HT codeblock. Incorrect MEL segment "
                      "sequence.")
    mel = _mel_runs(coded[lcup - scup:lcup - 1])
    d = coded[lcup - 2]
    nib = d >> 4
    vlc = _Reader(_backward(coded[lcup - scup:lcup - 2], (d | 0xF) > 0x8F,
                            pad, (nib, 3 if nib & 7 == 7 else 4)))
    ms = _Reader(_forward(coded[:lcup - scup], 1, pad))
    out = [0] * (w * h)
    sig = bytearray(w * h)
    ls = [0] * (w // 2 + 6)          # line state: 0x80 sigma, 0x7F E
    run = next(mel)
    shift = p - 1
    for y in range(0, h, 2):
        first = y == 0
        tbl = VLC_TBL0 if first else VLC_TBL1
        row = y * w
        two = (h > 1) if first else (y + 2 <= h)
        c_q = 0
        ls0 = ls[0]
        ls[0] = 0
        li = 0
        for x in range(0, w, 4):
            vv = vlc.fetch()
            if not first:
                c_q |= (ls0 >> 7) | ((ls[li + 1] >> 5) & 4)
            q0 = tbl[(c_q << 7) | (vv & 0x7F)]
            if c_q == 0:
                run -= 2
                if run != -1:
                    q0 = 0
                if run < 0:
                    run = next(mel)
            if first:
                c_q = ((q0 & 0x10) >> 4) | ((q0 & 0xE0) >> 5)
            else:
                c_q = ((q0 & 0x40) >> 5) | ((q0 & 0x80) >> 6)
            vlc.pos += q0 & 7
            q1 = 0
            if x + 2 < w:
                vv = vlc.fetch()
                if not first:
                    c_q |= (ls[li + 1] >> 7) | ((ls[li + 2] >> 5) & 4)
                q1 = tbl[(c_q << 7) | (vv & 0x7F)]
                if c_q == 0:
                    run -= 2
                    if run != -1:
                        q1 = 0
                    if run < 0:
                        run = next(mel)
                if first:
                    c_q = ((q1 & 0x10) >> 4) | ((q1 & 0xE0) >> 5)
                else:
                    c_q = ((q1 & 0x40) >> 5) | ((q1 & 0x80) >> 6)
                vlc.pos += q1 & 7
            mode = ((q0 & 8) >> 3) | ((q1 & 8) >> 2)
            if first and mode == 3:
                run -= 2
                if run == -1:
                    mode = 4
                if run < 0:
                    run = next(mel)
            u0, u1, used = _uvlc(vlc.fetch(), mode, first)
            vlc.pos += used
            if first:
                if u0 > zbp1 or u1 > zbp1:
                    raise HTError("Malformed HT codeblock. Decoding this "
                                  "codeblock is stopped. U_q is larger than "
                                  "zero bitplanes + 1")
            else:
                r0 = q0 & 0xF0
                if r0 & (r0 - 1):
                    e = max(ls0 & 0x7F, ls[li + 1] & 0x7F)
                    u0 += e - 2 if e > 2 else 0
                r1 = q1 & 0xF0
                if r1 & (r1 - 1):
                    e = max(ls[li + 1] & 0x7F, ls[li + 2] & 0x7F)
                    u1 += e - 2 if e > 2 else 0
                if u0 > zbp1 or u1 > zbp1:
                    raise HTError("Malformed HT codeblock. Decoding this "
                                  "codeblock is stopped. U_q islarger than "
                                  "bitplanes + 1")
                ls0 = ls[li + 2]
                ls[li + 1] = ls[li + 2] = 0
            locs = 0xFF
            if x + 4 > w:
                locs >>= (x + 4 - w) << 1
            if not two:
                locs &= 0x55
            if (((q0 & 0xF0) >> 4) | (q1 & 0xF0)) & ~locs:
                raise HTError("Malformed HT codeblock. VLC code produces "
                              "significant samples outside the codeblock "
                              "area.")
            for q, u, col, lj in ((q0, u0, x, li), (q1, u1, x + 2, li + 1)):
                if not q & 0xF0:
                    ls[lj + 1] = 0
                    continue
                for n in range(4):
                    if not (q >> (4 + n)) & 1:
                        if n == 2:
                            ls[lj + 1] = 0
                        continue
                    b = ms.pos
                    msv = int.from_bytes(ms.buf[b >> 3:(b >> 3) + 5],
                                         "little") >> (b & 7)
                    m = u - ((q >> (12 + n)) & 1)
                    ms.pos = b + m
                    v = (msv & ((1 << m) - 1)) | \
                        (((q >> (8 + n)) & 1) << m) | 1
                    at = row + (w if n & 1 else 0) + col + (n >> 1)
                    out[at] = (((msv & 1) << 31) | ((v + 2) << shift)) & M32
                    sig[at] = 1
                    if n == 1:
                        t = ls[lj] & 0x7F
                        e = v.bit_length()
                        ls[lj] = 0x80 | (t if t > e else e)
                    elif n == 2:
                        ls[lj + 1] = 0
                    elif n == 3:
                        ls[lj + 1] = 0x80 | v.bit_length()
            li += 2
    return out, sig


def _words(sig: bytearray, w: int, h: int, s: int) -> List[int]:
    """Stripe s's significance as ht_dec.c's sigma words: 8 columns a
    word, a nibble a column, a bit a row; one extra word of 0s."""
    g = (w + 7) // 8
    words = [0] * (g + 2)
    for r in range(4):
        y = 4 * s + r
        if y >= h:
            break
        base = y * w
        for x in range(w):
            if sig[base + x]:
                words[x >> 3] |= 1 << (4 * (x & 7) + r)
    return words


def _spread(sw: List[int], g: int) -> List[int]:
    """Each word's columns ORed with their left and right neighbours'."""
    out, prev = [], 0
    for i in range(g):
        s = sw[i]
        out.append((s | (prev >> 28) | ((s << 4) & M32) | (s >> 4) |
                    ((sw[i + 1] << 28) & M32)))
        prev = s
    return out


def _refine(out, sig, w, h, p, coded, lcup, len2, passes, causal, pad):
    """SigProp and (with 3 passes) MagRef over every stripe, in
    ht_dec.c's order and with its membership rules."""
    stripes = (h + 3) // 4
    g = (w + 7) // 8
    sigw = [_words(sig, w, h, s) for s in range(stripes)]
    seg2 = coded[lcup:lcup + len2]
    if passes > 2:
        mrp = _Reader(_backward(seg2, True, pad))
        half = 1 << (p - 2)
        bit = 1 << (p - 1)
        for s in range(stripes):
            sw = sigw[s]
            for i in range(g):
                cwd = mrp.fetch()
                wd = sw[i]
                k = 0
                for j in range(8):
                    col = (wd >> (4 * j)) & 0xF
                    if not col:
                        continue
                    for r in range(4):
                        if col >> r & 1:
                            at = (4 * s + r) * w + 8 * i + j
                            sym = (cwd >> k) & 1
                            out[at] = (out[at] ^ ((1 - sym) * bit)) | half
                            k += 1
                mrp.pos += bin(wd).count("1")
    sp = _Reader(_forward(seg2, 0, pad))
    mbr = []
    for s in range(stripes):
        sw = sigw[s]
        row = []
        for i, t in enumerate(_spread(sw, g)):
            z = t | ((t & 0x77777777) << 1) | ((t & 0xEEEEEEEE) >> 1)
            row.append(z & ~sw[i] & M32)
        mbr.append(row + [0, 0])
    val = 3 << (p - 2)
    nxt_pat = (0x11111111, 0x33333333, 0x77777777, M32)
    for s in range(stripes):
        rows = min(4, h - 4 * s)
        pattern = nxt_pat[rows - 1]
        cur_sig, cur_mbr = sigw[s], mbr[s]
        last = s + 1 >= stripes
        nxt_sig = sigw[s + 1] if not last else [0] * (g + 2)
        nxt_mbr = mbr[s + 1] if not last else [0] * (g + 2)
        if not last:
            for i, t in enumerate(_spread(nxt_sig, g)):
                if not causal:
                    cur_mbr[i] |= (t & 0x11111111) << 3
                cur_mbr[i] &= ~cur_sig[i] & M32
        y = 4 * s
        for i in range(g):
            m = cur_mbr[i] & pattern
            new_sig = 0
            if m:
                inv_sig = ~cur_sig[i] & pattern & M32
                for n in (0, 4):
                    cwd = sp.fetch()
                    cnt = 0
                    end = n + 4 if n + 4 + 8 * i < w else w - 8 * i
                    for j in range(n, end):
                        cm = 0xF << (4 * j)
                        if not cm & m:
                            continue
                        sm = 0x11111111 & cm
                        for tp in (0x32, 0x74, 0xE8, 0xC0):
                            if m & sm:
                                if cwd & 1:
                                    new_sig |= sm
                                    m |= (tp << (4 * j)) & inv_sig
                                cwd >>= 1
                                cnt += 1
                            sm <<= 1
                    if new_sig & (0xFFFF << (4 * n)):
                        for j in range(n, end):
                            cm = 0xF << (4 * j)
                            if not cm & new_sig:
                                continue
                            sm = 0x11111111 & cm
                            for r in range(4):
                                if new_sig & sm:
                                    at = (y + r) * w + 8 * i + j
                                    out[at] |= ((cwd & 1) << 31) | val
                                    cwd >>= 1
                                    cnt += 1
                                sm <<= 1
                    sp.pos += cnt
                    if n == 4:
                        t = new_sig >> 28
                        t |= ((t & 0xE) >> 1) | ((t & 7) << 1)
                        cur_mbr[i + 1] |= t & ~cur_sig[i + 1] & M32
            new_sig |= cur_sig[i]
            ux = (new_sig & 0x88888888) >> 3
            tx = (ux | (ux << 4) | (ux >> 4)) & M32
            if i > 0:
                nxt_mbr[i - 1] |= (ux << 28) & ~nxt_sig[i - 1] & M32
            nxt_mbr[i] |= tx & ~nxt_sig[i] & M32
            nxt_mbr[i + 1] |= (ux >> 28) & ~nxt_sig[i + 1] & M32


def decode_cblk(w: int, h: int, coded: bytes, lengths: Sequence[int],
                passes: Sequence[int], mb: int, numbps: int, roishift: int,
                style: int, align: int = 0) -> np.ndarray:
    """(h, w) int64 coefficients of an HT code-block, in decode_cblk's
    units: `coded` its chunks joined in arrival order, `lengths` /
    `passes` its segments' bytes and passes, `mb` the band's Mb, `numbps`
    OpenJPEG's (Mb + 1 less the zero bit-planes tag), `align` the
    offset of `coded` in the buffer OpenJPEG reads it from (only the MEL
    start check sees it)."""
    if roishift:
        raise HTError("We do not support ROI in decoding HT codeblocks")
    if mb == 0:
        return np.zeros((h, w), np.int64)
    zero_bplanes = mb + 1 - numbps
    num_passes = passes[0] + (passes[1] if len(passes) > 1 else 0)
    lengths1 = lengths[0] if num_passes > 0 else 0
    lengths2 = (lengths[1] if len(lengths) > 1 else 0) \
        if num_passes > 1 else 0
    if num_passes > 1 and lengths2 == 0:
        num_passes = 1                  # OpenJPEG warns and goes on
    if num_passes > 3:
        raise HTError("We do not support more than 3 coding passes in an "
                      "HT codeblock; This codeblocks has "
                      f"{num_passes} passes.")
    if mb > 30:
        raise HTError("32 bits are not enough to decode this codeblock, "
                      f"since the number of bitplane, {mb}, is larger than "
                      "30.")
    if zero_bplanes > mb:
        raise HTError("Malformed HT codeblock. Decoding this codeblock is "
                      f"stopped. There are {zero_bplanes} zero bitplanes in "
                      f"{mb} bitplanes.")
    if zero_bplanes == mb and num_passes > 1:
        num_passes = 1                  # OpenJPEG warns and goes on
    if lengths1 < 2 or lengths1 > len(coded) or \
            lengths1 + lengths2 > len(coded):
        raise HTError("Malformed HT codeblock. Invalid codeblock length "
                      "values.")
    lcup = lengths1
    scup = (coded[lcup - 1] << 4) + (coded[lcup - 2] & 0xF)
    if scup < 2 or scup > lcup or scup > 4079:
        raise HTError("Malformed HT codeblock. One of the following "
                      "condition is not met: 2 <= Scup <= min(Lcup, 4079)")
    pad = 4 * w * h + 16
    out, sig = _cleanup(coded, lcup, scup, w, h, numbps, zero_bplanes + 1,
                        pad, align)
    if num_passes > 1:
        _refine(out, sig, w, h, numbps, coded, lcup, lengths2, num_passes,
                bool(style & VSC), pad)
    a = np.array(out, np.int64).reshape(h, w)
    mag = a & 0x7FFFFFFF
    return np.where(a >> 31, -mag, mag)
