"""The port's HTJ2K decoder (data/jpeg2000_ht.py under data/jpeg2000.py)
against Pillow, which the JAX package's load_image_uint8 decodes through
(OpenJPEG 2.5.4 under Jpeg2KImagePlugin; OpenJPEG decodes HT code-blocks
but writes none).

The files come from a test-only HT writer here:
  - the cleanup encoder: MEL, CxtVLC (its codewords found by inverting the
    decoder's committed tables), U-VLC with the first row's MEL rule,
    MagSgn and the Scup trailer; refinement (SigProp + MagRef) segments
    are seeded bytes, which any HT decoder reads, with 2 or 3 passes
    declared;
  - the codestream around it: SIZ with Rsiz bit 14, CAP, COD with style
    0x40 (and VSC), QCD (reversible 5/3 with the RCT, or irreversible 9/7
    with the ICT and a quantiser step), tiles, precincts, LRCP / RPCL,
    one quality layer of packet headers (inclusion and zero bit-plane tag
    trees, pass counts, Lblock); the geometry and packet order are the
    port's own (data/jpeg2000.py's _resolutions and _packets), held by
    the lossless self-check: a lossless file decodes in Pillow to exactly
    its source image;
  - damaged files: a byte flipped in each stream, segments cut short, bad
    Scup values, 4 passes, more zero bit-planes than Mb, RGN with HT, the
    mixed HT style.
Every decodable file's pixels, mode and size equal Pillow's convert("RGB")
and the JAX loader's; where Pillow refuses a file, the port raises
ValueError with OpenJPEG's reason, which `opj_reason` reads from
libopenjp2's error handler (ctypes here only).

l3c_torch/data/fixtures/htj2k holds the corpus chip_smoke.py's phase htj2k
decodes on the card machine, with expected.json; `python
tests/test_torch_port_htj2k.py` (from the repo root, PYTHONPATH=.)
rewrites them. Other test files import the writer from here.
"""
import ctypes
import hashlib
import io
import json
import os
import struct
import sys
import tempfile

import numpy as np
import PIL
import PIL.features
import pytest
import torch
from PIL import Image

from l3c_tpu.data import images as jimages
from l3c_torch.data import images as timages
from l3c_torch.data import jpeg2000 as tj2k
from l3c_torch.data import jpeg2000_ht as tht
from l3c_torch.data.jpeg2000_ht_tables import (MEL_EXP, UVLC_DEC, VLC_TBL0,
                                               VLC_TBL1)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_port_gif import check  # noqa: E402
from test_torch_port_jpeg2000_coding import jp2, libopenjp2  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "l3c_torch", "data", "fixtures", "htj2k")
# coded by chip_smoke's cli.l3c and timed for the host decode rates
CODED = ("y_coded_lossless_512.j2k", "z_coded_lossy_256.jp2")

torch.set_num_threads(1)


# ---------------------------------------------------- the cleanup encoder

def _enc_table(tbl):
    """(context, rho, u_off) -> [(e_k, e_1, codeword, length)] from a
    decoder table: each entry's codeword is the low `length` bits of the
    7 it was found at."""
    out = {}
    for c in range(8):
        for bits in range(128):
            e = tbl[(c << 7) | bits]
            n = e & 7
            if n == 0:
                continue
            key = (c, (e >> 4) & 15, (e >> 3) & 1)
            ent = (e >> 12, (e >> 8) & 15, bits & ((1 << n) - 1), n)
            if ent not in out.setdefault(key, []):
                out[key].append(ent)
    return out


_ENC = {0: _enc_table(VLC_TBL0), 1: _enc_table(VLC_TBL1)}


def _uvlc_code(u):
    """[(bits, n)] of U-VLC value u >= 1 (prefix, then suffix), LSB
    first."""
    if u == 1:
        return (1, 1), (0, 0)
    if u == 2:
        return (2, 2), (0, 0)
    if u <= 4:
        return (4, 3), (u - 3, 1)
    assert u <= 36
    return (0, 3), (u - 5, 5)


def _pack_mel(events):
    """MEL's bytes of the events: the adaptive run-length code, MSB
    first, 7 bits after an 0xFF, the tail padded with 0s."""
    bits, k, run = [], 0, 0
    for e in events:
        if e == 0:
            run += 1
            if run == 1 << MEL_EXP[k]:
                bits.append(1)
                run = 0
                k = min(k + 1, 12)
        else:
            bits.append(0)
            bits.extend((run >> i) & 1 for i in range(MEL_EXP[k] - 1, -1, -1))
            run = 0
            k = max(k - 1, 0)
    if run:
        bits.append(1)
    out, at, prev = [], 0, 0
    while at < len(bits):
        nb = 7 if prev == 0xFF else 8
        chunk = bits[at:at + nb] + [0] * max(0, at + nb - len(bits))
        v = 0
        for b in chunk:
            v = (v << 1) | b
        out.append(v)
        at += nb
        prev = v
    if out and out[-1] == 0xFF:
        out.append(0)
    return bytes(out)


def _bits_lsb(codes):
    out = []
    for v, n in codes:
        out.extend((v >> i) & 1 for i in range(n))
    return out


def _pack_vlc(codes):
    """The VLC stream's bytes in reading order (the Scup byte's upper
    nibble first, then backward): a byte holds 7 bits where the one before
    it is above 0x8F and its 7 bits would be 1s."""
    bits = _bits_lsb(codes)
    bits += [0] * 8
    if bits[:3] == [1, 1, 1]:
        nib, at = 7, 3
    else:
        nib, at = sum(b << i for i, b in enumerate(bits[:4])), 4
    unstuff = nib >= 9
    out = []
    n = len(bits) - 8
    while at < n:
        seven = bits[at:at + 7] + [0] * 7
        if unstuff and all(seven[:7]):
            v, at = 0x7F, at + 7
        else:
            eight = (bits[at:at + 8] + [0] * 8)[:8]
            v, at = sum(b << i for i, b in enumerate(eight)), at + 8
        out.append(v)
        unstuff = v > 0x8F
    return nib, bytes(out)


def _pack_forward(codes):
    """MagSgn's bytes: LSB first, 7 bits after an 0xFF, padded with 1s."""
    bits = _bits_lsb(codes)
    out, at, prev = [], 0, 0
    while at < len(bits):
        nb = 7 if prev == 0xFF else 8
        chunk = bits[at:at + nb]
        chunk = chunk + [1] * (nb - len(chunk))
        v = sum(b << i for i, b in enumerate(chunk))
        out.append(v)
        prev = v
        at += nb
    return bytes(out)


def _emb(ents, rho, E, U):
    """A table entry whose EMB pattern fits the quad's exponents."""
    for ek, e1, cwd, n in sorted(ents, key=lambda z: z[3]):
        if ek & ~rho or e1 & ~ek:
            continue
        if all(((e1 >> i) & 1) == (E[i] == U) for i in range(4)
               if (ek >> i) & 1):
            return ek, e1, cwd, n
    raise AssertionError(f"no codeword for rho {rho}, E {E}, U {U}")


def encode_cleanup(q, p):
    """The HT cleanup segment of code-block `q` ((h, w) signed ints) at
    bit-plane p: magnitudes |q| >> p, the streams laid out as ht_dec.c
    reads them (MagSgn, MEL, VLC reversed, the Scup nibble and byte)."""
    h, w = q.shape
    mu = np.abs(q) >> p
    neg = q < 0
    mel, vlc, ms = [], [], []
    ls = [0] * (w // 2 + 6)
    for y in range(0, h, 2):
        first = y == 0
        c_q = 0
        ls0 = ls[0]
        ls[0] = 0
        li = 0
        for x in range(0, w, 4):
            quads = []
            for k in range(2 if x + 2 < w else 1):
                col = x + 2 * k
                m_, s_ = [], []
                for n in range(4):
                    yy, xx = y + (n & 1), col + (n >> 1)
                    inside = yy < h and xx < w
                    m_.append(int(mu[yy, xx]) if inside else 0)
                    s_.append(int(neg[yy, xx]) if inside else 0)
                rho = sum(1 << n for n in range(4) if m_[n])
                E = [(((v - 1) << 1) | 1).bit_length() if v else 0
                     for v in m_]
                if not first:
                    if k == 0:
                        c_q |= (ls0 >> 7) | ((ls[li + 1] >> 5) & 4)
                        above = max(ls0 & 0x7F, ls[li + 1] & 0x7F)
                    else:
                        c_q |= (ls[li + 1] >> 7) | ((ls[li + 2] >> 5) & 4)
                        above = max(ls[li + 1] & 0x7F, ls[li + 2] & 0x7F)
                kappa = 1
                if not first and rho & (rho - 1):
                    kappa = max(above - 1, 1)
                U = max(max(E), kappa)
                u = U - kappa
                uoff = int(u > 0)
                qinf = 0
                ek = 0
                if c_q == 0:
                    ev = int(bool(rho) or bool(uoff))
                    mel.append(ev)
                if c_q != 0 or rho or uoff:
                    ents = _ENC[0 if first else 1].get((c_q, rho, uoff), [])
                    ek, e1, cwd, n = _emb(ents, rho, E, U)
                    vlc.append((cwd, n))
                    qinf = n | (uoff << 3) | (rho << 4) | (e1 << 8) | \
                        (ek << 12)
                if first:
                    c_q = ((qinf & 0x10) >> 4) | ((qinf & 0xE0) >> 5)
                else:
                    c_q = ((qinf & 0x40) >> 5) | ((qinf & 0x80) >> 6)
                quads.append((m_, s_, E, U, u, uoff, ek, rho))
            # U-VLC of the pair
            us = [qd[4] for qd in quads]
            offs = [qd[5] for qd in quads] + [0]
            mode = offs[0] | (offs[1] << 1)
            if mode == 1:
                vlc.extend(_uvlc_code(us[0]))
            elif mode == 2:
                vlc.extend(_uvlc_code(us[1]))
            elif mode == 3:
                if first and us[0] > 2 and us[1] > 2:
                    mel.append(1)
                    a, b = _uvlc_code(us[0] - 2), _uvlc_code(us[1] - 2)
                    vlc.extend([a[0], b[0], a[1], b[1]])
                elif first:
                    mel.append(0)
                    a = _uvlc_code(us[0])
                    if us[0] > 2:
                        vlc.extend([a[0], (us[1] - 1, 1), a[1]])
                    else:
                        b = _uvlc_code(us[1])
                        vlc.extend([a[0], b[0], a[1], b[1]])
                else:
                    a, b = _uvlc_code(us[0]), _uvlc_code(us[1])
                    vlc.extend([a[0], b[0], a[1], b[1]])
            if not first:
                ls0 = ls[li + 2]
                ls[li + 1] = ls[li + 2] = 0
            # MagSgn and the line state, as the decoder updates it
            for k, lj in ((0, li), (1, li + 1)):
                if k >= len(quads):
                    ls[lj + 1] = 0
                    continue
                m_, s_, E, U, u, uoff, ek, rho = quads[k]
                for n in range(4):
                    if not m_[n]:
                        if n == 2:
                            ls[lj + 1] = 0
                        continue
                    mm = U - ((ek >> n) & 1)
                    vs = ((m_[n] - 1) << 1) | s_[n]
                    ms.append((vs & ((1 << mm) - 1), mm))
                    e = (((m_[n] - 1) << 1) | 1).bit_length()
                    if n == 1:
                        ls[lj] = 0x80 | max(ls[lj] & 0x7F, e)
                    elif n == 2:
                        ls[lj + 1] = 0
                    elif n == 3:
                        ls[lj + 1] = 0x80 | e
            li += 2
    mel_b = _pack_mel(mel)
    nib, vlc_b = _pack_vlc(vlc)
    ms_b = _pack_forward(ms)
    scup = len(mel_b) + len(vlc_b) + 2
    assert scup <= 4079
    return ms_b + mel_b + vlc_b[::-1] + bytes([(nib << 4) | (scup & 0xF),
                                              scup >> 4])


def refinement_bytes(n, seed):
    """n seeded bytes for a SigProp + MagRef segment, no byte above 0x8F
    after an 0xFF."""
    b = bytearray(np.random.RandomState(seed).randint(0, 256, n).tolist())
    for i in range(1, n):
        if b[i - 1] == 0xFF:
            b[i] &= 0x7F
    return bytes(b)


# ------------------------------------------------------ transforms, Tier-2

def _fwd53(x, cas):
    """The forward 5/3 along the last axis: [low | high], the inverse of
    jpeg2000._lift53."""
    n = x.shape[-1]
    if n == 1:
        return x.copy() if cas == 0 else x * 2
    if cas == 0:
        lo, hi = x[..., 0::2], x[..., 1::2]
        sn, dn = lo.shape[-1], hi.shape[-1]
        si, di = np.arange(dn), np.arange(sn)
        hi = hi - ((lo[..., si] + lo[..., np.clip(si + 1, 0, sn - 1)]) >> 1)
        lo = lo + ((hi[..., np.clip(di - 1, 0, dn - 1)] +
                    hi[..., np.clip(di, 0, dn - 1)] + 2) >> 2)
    else:
        hi, lo = x[..., 0::2], x[..., 1::2]
        sn, dn = lo.shape[-1], hi.shape[-1]
        si, di = np.arange(dn), np.arange(sn)
        hi = hi - ((lo[..., np.clip(si - 1, 0, sn - 1)] +
                    lo[..., np.clip(si, 0, sn - 1)]) >> 1)
        lo = lo + ((hi[..., di] + hi[..., np.clip(di + 1, 0, dn - 1)] + 2)
                   >> 2)
    return np.concatenate([lo, hi], -1)


def _fwd97(x, cas):
    """The forward 9/7 along the last axis in float64: the inverse of
    jpeg2000._lift97."""
    n = x.shape[-1]
    if n == 1:
        return x.copy()
    if cas == 0:
        lo, hi = x[..., 0::2].copy(), x[..., 1::2].copy()
    else:
        hi, lo = x[..., 0::2].copy(), x[..., 1::2].copy()
    sn, dn = lo.shape[-1], hi.shape[-1]
    li, hi_i = np.arange(sn), np.arange(dn)
    if cas == 0:
        ll, lr = np.clip(li - 1, 0, dn - 1), np.clip(li, 0, dn - 1)
        hl, hr = hi_i, np.clip(hi_i + 1, 0, sn - 1)
    else:
        ll, lr = li, np.clip(li + 1, 0, dn - 1)
        hl, hr = np.clip(hi_i - 1, 0, sn - 1), np.clip(hi_i, 0, sn - 1)
    c1, c2, c3, c4 = (float(c) for c in tj2k._LIFT)
    hi = hi - (lo[..., hl] + lo[..., hr]) * c4
    lo = lo - (hi[..., ll] + hi[..., lr]) * c3
    hi = hi - (lo[..., hl] + lo[..., hr]) * c2
    lo = lo - (hi[..., ll] + hi[..., lr]) * c1
    return np.concatenate([lo / float(tj2k._K), hi / float(tj2k._TWO_INV_K)],
                          -1)


def _fdwt(a, res, reversible):
    """The forward DWT of a tile-component, laid out as jpeg2000._idwt
    reads it: columns, then rows, each level from the top."""
    f = _fwd53 if reversible else _fwd97
    for r in range(len(res) - 1, 0, -1):
        rr = res[r]
        w, h = rr.x1 - rr.x0, rr.y1 - rr.y0
        if w == 0 or h == 0:
            continue
        blk = a[:h, :w]
        blk = f(blk.T, rr.y0 & 1).T
        a[:h, :w] = f(blk, rr.x0 & 1)
    return a


class _BitWriter:
    """Packet-header bits, MSB first, 7 bits after an 0xFF; an 0xFF at the
    end is followed by a 0 byte."""

    def __init__(self):
        self.bits = []

    def put(self, b, n=1):
        for i in range(n - 1, -1, -1):
            self.bits.append((b >> i) & 1)

    def flush(self):
        out, at, prev, bits = [], 0, 0, self.bits
        while at < len(bits):
            nb = 7 if prev == 0xFF else 8
            v = 0
            for b in (bits[at:at + nb] + [0] * nb)[:nb]:
                v = (v << 1) | b
            out.append(v)
            prev = v
            at += nb
        if not out:
            out.append(0)
        if out[-1] == 0xFF:
            out.append(0)
        return bytes(out)


class _TagTree:
    """opj_tgt's encoder over w x h leaves."""

    def __init__(self, w, h, values):
        self.levels, n = [], 0
        while True:
            self.levels.append((n, w, h))
            n += w * h
            if w * h <= 1:
                break
            w, h = (w + 1) // 2, (h + 1) // 2
        self.value = [0] * n
        self.low = [0] * n
        self.known = [False] * n
        off, lw, lh = self.levels[0]
        for i, v in enumerate(values):
            self.value[i] = v
        for (o0, w0, h0), (o1, w1, h1) in zip(self.levels, self.levels[1:]):
            for y in range(h1):
                for x in range(w1):
                    kids = [self.value[o0 + yy * w0 + xx]
                            for yy in (2 * y, 2 * y + 1)
                            for xx in (2 * x, 2 * x + 1)
                            if yy < h0 and xx < w0]
                    self.value[o1 + y * w1 + x] = min(kids)

    def encode(self, bw, x, y, threshold):
        path = []
        for off, w, _ in self.levels:
            path.append(off + y * w + x)
            x, y = x >> 1, y >> 1
        low = 0
        for node in reversed(path):
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold:
                if low >= self.value[node]:
                    if not self.known[node]:
                        bw.put(1)
                        self.known[node] = True
                    break
                bw.put(0)
                low += 1
            self.low[node] = low


def _passes_code(bw, n):
    if n == 1:
        bw.put(0)
    elif n == 2:
        bw.put(2, 2)
    elif n <= 5:
        bw.put(3, 2)
        bw.put(n - 3, 2)
    elif n <= 36:
        bw.put(15, 4)
        bw.put(n - 6, 5)
    else:
        bw.put(0x1FF, 9)
        bw.put(n - 37, 7)


def _seg(marker, body):
    return struct.pack(">HH", marker, len(body) + 2) + body


def _precinct(b, prec, res, r, coeffs, reversible, drop, passes, zbp,
              damage, c, rng, layers):
    """A band's precinct: each code-block's zero bit-plane count and its
    contributions a layer ([(segment bytes, passes)] or None where the
    block is never included), its tag trees and Lblocks."""
    blocks, cw, ch = prec[:3]
    ox = res[r - 1].x1 - res[r - 1].x0 if b.no & 1 else 0
    oy = res[r - 1].y1 - res[r - 1].y0 if b.no & 2 else 0
    mb = b.numbps
    coded = []
    for k, blk in enumerate(blocks):
        y, x = blk.y0 - b.y0 + oy, blk.x0 - b.x0 + ox
        v = coeffs[y:y + blk.y1 - blk.y0, x:x + blk.x1 - blk.x0]
        if reversible:
            qv = v.astype(np.int64)
        else:
            qv = (np.sign(v) * np.floor(np.abs(v) / float(b.step))).astype(
                np.int64)
        assert np.abs(qv).max(initial=0) < (1 << mb), (mb, c, r)
        pc = drop(c, b.no, k, mb) if drop else 0
        P = mb - 1 - pc
        if not (np.abs(qv) >> pc).any():
            coded.append(None)
            continue
        segs = [(encode_cleanup(qv, pc), 1)]
        if passes > 1:
            segs.append((refinement_bytes(int(rng.randint(1, 12)),
                                          int(rng.randint(1 << 30))),
                         passes - 1))
        if zbp:
            P = zbp(P, mb, k)
        if damage:
            segs = damage(c, b.no, k, segs)
        # one layer: every segment at once; two: the cleanup, then the rest
        # as one segment (the standard's), or, as OpenJPEG reads a later
        # layer, one more (empty) pass of the cleanup's segment first
        later = segs[1:]
        if layers == 3 and later:
            later = [(b"", 1), (later[0][0], later[0][1] - 1)]
        coded.append((P, [segs] if layers == 1 else [segs[:1], later]))
    return {"cw": cw, "coded": coded, "lblock": [3] * len(coded),
            "incl": _TagTree(cw, ch, [0 if x else 2 for x in coded]),
            "imsb": _TagTree(cw, ch, [x[0] if x else 999 for x in coded])}


def _packet_blocks(bw, pr, l):
    """One band's part of a layer-l packet header -> its segments."""
    out = []
    cw = pr["cw"]
    for k, x in enumerate(pr["coded"]):
        bx, by = k % cw, k // cw
        if l == 0 or x is None:
            pr["incl"].encode(bw, bx, by, l + 1)
        else:
            bw.put(int(bool(x[1][l])))
        if x is None or not x[1][l]:
            continue
        P, layer_segs = x
        segs = layer_segs[l]
        if l == 0:
            i = 0
            while True:
                pr["imsb"].encode(bw, bx, by, i + 1)
                if P < i + 1:
                    break
                i += 1
        _passes_code(bw, sum(sp for _, sp in segs))
        need = 0
        for sd, sp in segs:
            need = max(need, len(sd).bit_length() - (sp.bit_length() - 1))
        inc = max(0, need - pr["lblock"][k])
        pr["lblock"][k] += inc
        bw.put((1 << (inc + 1)) - 2, inc + 1)
        for sd, sp in segs:
            bw.put(len(sd), pr["lblock"][k] + sp.bit_length() - 1)
        out += [sd for sd, _ in segs]
    return out


def ht_codestream(planes, dx=None, dy=None, prec=8, levels=3, cblk=(64, 64),
                  reversible=True, mct=None, tile=None, precincts=None,
                  prog=0, style=0, guard=2, step=(8, 0), passes=1,
                  drop=None, zbp=None, seed=0, rgn=None, cap=True,
                  rsiz=0x4000, damage=None, exp_add=0, layers=1):
    """A raw HTJ2K codestream of `planes` (each component's samples at its
    own sampling, the canvas at 0, 0): `levels` decompositions, code-blocks
    `cblk`, code-block style 0x40 | `style`, the RCT / ICT where `mct`
    (default: three or more components), tiles (width, height), precinct
    exponents per resolution, progression `prog`, the 9/7 step (exponent,
    mantissa) of every band (`exp_add` more on the 5/3 exponents). Each
    code-block's cleanup pass sits at
    bit-plane `drop(component, band, block index, Mb)` (default 0); `passes`
    > 1 appends a seeded refinement segment; `zbp(P, Mb, index)` may change
    the zero bit-plane count it signals and `damage(component, band,
    index, [(segment, passes)])` its segments. `layers` 2 puts the
    refinement segment in a second quality layer as the standard writes
    it, 3 as OpenJPEG 2.5.4 reads a later layer (one more pass of the
    cleanup's segment, then the rest); two layers either way."""
    n = len(planes)
    dx, dy = dx or [1] * n, dy or [1] * n
    Y1, X1 = planes[0].shape             # component 0 at full size
    XT, YT = tile or (X1, Y1)
    mct = (n >= 3) if mct is None else mct
    siz = struct.pack(">HIIIIIIIIH", rsiz, X1, Y1, 0, 0, XT, YT, 0, 0, n)
    siz += b"".join(bytes([prec - 1, dx[c], dy[c]]) for c in range(n))
    scod = 1 if precincts else 0
    spcod = bytes([levels, cblk[0].bit_length() - 3,
                   cblk[1].bit_length() - 3, 0x40 | style,
                   1 if reversible else 0])
    if precincts:
        spcod += bytes((py << 4) | px for px, py in precincts)
    cod = struct.pack(">BBHB", scod, prog, min(layers, 2), int(mct)) + spcod
    nb = 3 * levels + 1
    if reversible:
        gains = [0] + [1, 1, 2] * levels
        ex = [prec + g + (1 if mct else 0) + exp_add for g in gains]
        qcd = bytes([guard << 5]) + bytes(e << 3 for e in ex)
    else:
        qcd = bytes([(guard << 5) | 2]) + struct.pack(
            f">{nb}H", *[(step[0] << 11) | step[1]] * nb)
    main = b"\xff\x4f" + _seg(0xFF51, siz)
    if cap:
        main += _seg(0xFF50, struct.pack(">IH", 0x00020000, 0))
    main += _seg(0xFF52, cod) + _seg(0xFF5C, qcd)
    if rgn:
        main += _seg(0xFF5E, bytes([rgn[0], 0, rgn[1]]))
    coding = tj2k._Coding(spcod[:3] + bytes([spcod[3] & 0x7F]) + spcod[4:],
                          bool(scod), "w")
    quant = tj2k._Quant(qcd, "w")
    rng = np.random.RandomState(seed)
    data = [np.asarray(p, np.int64) - (1 << (prec - 1)) for p in planes]
    nx, ny = -(-X1 // XT), -(-Y1 // YT)
    parts = []
    for t in range(nx * ny):
        tx0, ty0 = (t % nx) * XT, (t // nx) * YT
        tx1, ty1 = min(tx0 + XT, X1), min(ty0 + YT, Y1)
        comps, coeffs = [], []
        tcs = []
        for c in range(n):
            tc = (-(-tx0 // dx[c]), -(-ty0 // dy[c]), -(-tx1 // dx[c]),
                  -(-ty1 // dy[c]))
            tcs.append(tc)
            comps.append((dx[c], dy[c], tj2k._resolutions(
                tc, coding, quant, prec, reversible)))
        samples = [data[c][tcs[c][1]:tcs[c][3], tcs[c][0]:tcs[c][2]]
                   for c in range(n)]
        if mct:
            r_, g_, b_ = samples[:3]
            if reversible:
                samples[:3] = [(r_ + 2 * g_ + b_) >> 2, b_ - g_, r_ - g_]
            else:
                r_, g_, b_ = (s.astype(np.float64) for s in (r_, g_, b_))
                y_ = 0.299 * r_ + 0.587 * g_ + 0.114 * b_
                samples[:3] = [y_, (b_ - y_) / 1.772, (r_ - y_) / 1.402]
        for c in range(n):
            a = samples[c].astype(np.int64 if reversible else np.float64)
            coeffs.append(_fdwt(a.copy(), comps[c][2], reversible))
        nl = min(layers, 2)
        order = tj2k._packets([(0, 0, nl, 33, n, prog)], comps, nl,
                              (tx0, ty0, tx1, ty1), n)
        cache = {}
        body = b""
        for l, r, c, p in order:
            res = comps[c][2]
            bw = _BitWriter()
            contrib = []
            if l == 0:
                for b in res[r].bands:
                    if b.x1 > b.x0 and b.y1 > b.y0:
                        cache[r, c, p, b.no] = _precinct(
                            b, b.precs[p], res, r, coeffs[c], reversible,
                            drop, passes, zbp, damage, c, rng, layers)
            here = [cache[r, c, p, b.no] for b in res[r].bands
                    if (r, c, p, b.no) in cache]
            any_in = any(x is not None and x[1][l] for pr in here
                         for x in pr["coded"])
            bw.put(int(any_in))
            if any_in:
                for pr in here:
                    contrib += _packet_blocks(bw, pr, l)
            body += bw.flush() + b"".join(contrib)
        parts.append(_seg(0xFF90, struct.pack(">HIBB", t, 14 + len(body), 0,
                                              1)) + b"\xff\x93" + body)
    return main + b"".join(parts) + b"\xff\xd9"


# ------------------------------------------------------ OpenJPEG's reasons

_CB = ctypes.CFUNCTYPE(None, ctypes.c_char_p, ctypes.c_void_p)


def opj_reason(blob):
    """The errors libopenjp2 reports decoding `blob` (a raw codestream),
    or None where it decodes it."""
    lib = libopenjp2()
    if lib is None:
        return "no libopenjp2"
    vp = ctypes.c_void_p
    msgs = []
    cb = _CB(lambda m, _: msgs.append(m.decode().strip()))
    with tempfile.NamedTemporaryFile(suffix=".j2k", delete=False) as f:
        f.write(blob)
        path = f.name
    try:
        lib.opj_create_decompress.restype = vp
        codec = lib.opj_create_decompress(0)
        lib.opj_set_error_handler.argtypes = [vp, _CB, vp]
        lib.opj_set_error_handler(codec, cb, None)
        params = (ctypes.c_ubyte * 65536)()
        lib.opj_set_default_decoder_parameters(params)
        lib.opj_setup_decoder.argtypes = [vp, vp]
        lib.opj_setup_decoder(codec, params)
        lib.opj_stream_create_default_file_stream.restype = vp
        stream = lib.opj_stream_create_default_file_stream(path.encode(), 1)
        img = vp()
        lib.opj_read_header.argtypes = [vp, vp, ctypes.POINTER(vp)]
        lib.opj_decode.argtypes = [vp, vp, vp]
        lib.opj_end_decompress.argtypes = [vp, vp]
        ok = lib.opj_read_header(stream, codec, ctypes.byref(img)) and \
            lib.opj_decode(codec, stream, img) and \
            lib.opj_end_decompress(codec, stream)
        lib.opj_stream_destroy(vp(stream))
        lib.opj_destroy_codec(vp(codec))
        if img:
            lib.opj_image_destroy(img)
    finally:
        os.remove(path)
    return None if ok else " | ".join(msgs)


# ------------------------------------------------------------ the corpus

def _photo(h, w, seed):
    from test_torch_port_prep import _photo as photo
    return photo(h, w, seed)


def _rgb(img):
    return [img[..., c] for c in range(img.shape[-1])]


def _at(k0, fn, band=0, comp=0):
    """A `damage` that applies fn to one code-block's segments."""
    def damage(c, b, k, segs):
        return fn(segs) if (c, b, k) == (comp, band, k0) else segs
    return damage


def _flip(seg, i, x):
    b = bytearray(seg)
    b[i % len(b)] ^= x
    return bytes(b)


def _with_scup(seg, v):
    b = bytearray(seg)
    b[-1] = v >> 4
    b[-2] = (b[-2] & 0xF0) | (v & 15)
    return bytes(b)


def _scup(seg):
    return (seg[-1] << 4) | (seg[-2] & 15)


def _mel_start(seg):
    """The MEL's first two bytes set to 0xFF 0x95, which OpenJPEG's
    mel_init refuses where both fall before the buffer's next 4-byte
    boundary."""
    b = bytearray(seg)
    at = len(seg) - _scup(seg)
    b[at:at + 2] = b"\xff\x95"
    return bytes(b)


def _cleanup_only(fn):
    return lambda segs: [(fn(segs[0][0]), 1)] + segs[1:]


def corpus():
    """name -> (writer keywords, source pixels where the file is lossless
    or None, JP2 wrapper colour space or None): the folder's small files.
    """
    img = _photo(29, 37, 1)
    rgb = _rgb(img)
    g = _photo(18, 20, 2)[..., 0]
    rgba = np.dstack([_photo(20, 24, 3), _photo(20, 24, 4)[..., :1]])
    r = np.random.RandomState(5)
    g12 = (_photo(21, 19, 6)[..., 0].astype(np.int64) * 16 +
           r.randint(0, 16, (21, 19)))
    g16 = _photo(19, 22, 7)[..., 1].astype(np.int64) * 257 + \
        r.randint(0, 200, (19, 22))
    sub = _photo(24, 30, 8)
    big = r.randint(0, 65536, (64, 64))
    base = dict(planes=rgb, levels=2, cblk=(16, 16))
    drop1 = lambda c, b, k, mb: 1                                 # noqa
    mel0 = lambda s: _flip(s, len(s) - _scup(s), 0xF0)            # noqa
    return {
        "a_rgb_lossless_as.png": (dict(planes=rgb, levels=3), img, 16),
        "b_grey_cb4.j2k": (dict(planes=[g], levels=2, cblk=(4, 4)), g, None),
        "c_rgba.jp2": (dict(planes=_rgb(rgba), cblk=(16, 16)), rgba, 16),
        "d_grey12.j2k": (dict(planes=[g12], prec=12, levels=2), g12, None),
        "e_grey16.j2k": (dict(planes=[g16], prec=16, levels=2), g16, None),
        "f_sub420.j2k": (dict(planes=[sub[..., 0], sub[::2, ::2, 1],
                                      sub[::2, ::2, 2]], dx=[1, 2, 2],
                              dy=[1, 2, 2], levels=2, cblk=(8, 8),
                              mct=False), None, None),
        "g_cb128x8.j2k": (dict(planes=rgb, levels=1, cblk=(128, 8)), img,
                          None),
        "h_cb8x128_p3.j2k": (dict(planes=rgb, levels=1, cblk=(8, 128),
                                  passes=3, drop=drop1, seed=1), None, None),
        "i_vsc_p3.j2k": (dict(base, passes=3, drop=drop1, style=8, seed=2),
                         None, None),
        "j_p2.j2k": (dict(base, passes=2, drop=drop1, seed=3), None, None),
        "k_p3_cb64.j2k": (dict(planes=rgb, levels=2, passes=3,
                               drop=lambda c, b, k, mb: 2, seed=4), None,
                          None),
        "l_tiles_lrcp.j2k": (dict(planes=rgb, levels=3, cblk=(8, 8),
                                  tile=(24, 16), precincts=[(4, 4)] * 3 +
                                  [(5, 5)]), img, None),
        "m_tiles_rpcl.jp2": (dict(planes=rgb, levels=3, cblk=(8, 8),
                                  tile=(24, 16), precincts=[(4, 4)] * 3 +
                                  [(5, 5)], prog=2), img, 16),
        "n_zbp_range.j2k": (dict(base, drop=lambda c, b, k, mb:
                                 (3 * k + c + b) % mb), None, None),
        "o_p2_empty.j2k": (dict(base, passes=2, drop=drop1, damage=_at(
            0, lambda s: [s[0], (b"", 1)])), None, None),
        "p_zbp_last_p3.j2k": (dict(base, passes=3), None, None),
        "q_lossy97.jp2": (dict(planes=rgb, levels=3, reversible=False,
                               step=(8, 100), guard=3, passes=3,
                               drop=lambda c, b, k, mb: 1), None, 16),
        "r_no_cap.j2k": (dict(base, cap=False, rsiz=0), img, None),
        "s_mel_flip.j2k": (dict(base, damage=_at(0, _cleanup_only(
            lambda s: _flip(s, len(s) - _scup(s) + 1, 0xF0)), band=1)),
            None, None),
        "t_magsgn_flip.j2k": (dict(base, damage=_at(0, _cleanup_only(
            lambda s: _flip(s, 1, 0x55)))), None, None),
        "u_ref_flip.j2k": (dict(base, passes=3, drop=drop1, damage=_at(
            0, lambda s: [s[0], (_flip(s[1][0], 0, 0x55), 2)])), None,
            None),
        "x_mel_flip.j2k": (dict(base, damage=_at(0, _cleanup_only(mel0),
                                                 band=1)), None, None),
        "x_vlc_flip.j2k": (dict(base, damage=_at(0, _cleanup_only(
            lambda s: _flip(s, len(s) - 4, 0x0F)), band=1)), None, None),
        "x_vlc_flip_rows.j2k": (dict(base, damage=_at(0, _cleanup_only(
            lambda s: _flip(s, len(s) - 8, 0x0F)))), None, None),
        "x_mel_start.j2k": (dict(base, damage=_at(0, _cleanup_only(
            _mel_start))), None, None),
        "x_mel_start_past_check.j2k": (dict(base, damage=_at(
            0, _cleanup_only(_mel_start), band=2)), None, None),
        "x_trunc_half.j2k": (dict(base, damage=_at(0, _cleanup_only(
            lambda s: s[:len(s) // 2]))), None, None),
        "x_trunc_1.j2k": (dict(base, damage=_at(0, _cleanup_only(
            lambda s: s[:1]))), None, None),
        "x_scup0.j2k": (dict(base, damage=_at(0, _cleanup_only(
            lambda s: _with_scup(s, 0)))), None, None),
        "x_scup1.j2k": (dict(base, damage=_at(0, _cleanup_only(
            lambda s: _with_scup(s, 1)))), None, None),
        "x_scup_over_lcup.j2k": (dict(base, damage=_at(0, _cleanup_only(
            lambda s: _with_scup(s, len(s) + 1)))), None, None),
        "x_scup4080.j2k": (dict(planes=[big], prec=16, levels=0,
                                damage=_at(0, _cleanup_only(
                                    lambda s: _with_scup(s, 4080)))),
                           None, None),
        "x_passes4.j2k": (dict(base, passes=4, drop=drop1), None, None),
        "x_zbp_over_mb.j2k": (dict(base, zbp=lambda P, mb, k:
                                   mb if k == 0 else P), None, None),
        "x_zbp_0.j2k": (dict(base, zbp=lambda P, mb, k: 0), None, None),
        "x_mb31.j2k": (dict(planes=[g], levels=1, guard=7, exp_add=17),
                       None, None),
        "x_rgn.j2k": (dict(base, rgn=(0, 3)), None, None),
        "x_mixed.j2k": (dict(base, style=0x80), None, None),
    }


def coded_images():
    """The two files chip_smoke codes: a 512 x 512 lossless RGB raw
    codestream (the serving image's size) and a 256 x 256 9/7 JP2."""
    from test_torch_port_prep import _photo_textured
    from test_torch_port_registry import smooth
    return {
        CODED[0]: (dict(planes=_rgb(smooth(512, 512, 12)), levels=5), True,
                   None),
        CODED[1]: (dict(planes=_rgb(_photo_textured(256, 256, 13)),
                        levels=5, reversible=False, step=(7, 0), guard=2),
                   False, 16)}


def make_htj2k_fixtures(d):
    """Every file of the folder: the corpus, the two HT-marked Part-1
    codestreams' kin (an MQ codestream with the HT bits set) and the coded
    files; each lossless one checked against its source in Pillow."""
    from test_torch_port_jpeg2000_coding import encode, htj2k
    os.makedirs(d, exist_ok=True)
    files = {}
    for name, (kw, src, space) in corpus().items():
        files[name] = (ht_codestream(**kw), src, space, kw.get("prec", 8))
    for name, (kw, lossless, space) in coded_images().items():
        src = np.stack(kw["planes"], -1) if lossless else None
        files[name] = (ht_codestream(**kw), src, space, 8)
    img = _photo(40, 48, 9)
    with tempfile.TemporaryDirectory() as tmp:
        files["w_part1_marked_ht.j2k"] = (htj2k(encode(
            _rgb(img), (0, 0, 48, 40), path=os.path.join(tmp, "w.j2k"),
            levels=3)), None, None, 8)
    for name, (cs, src, space, prec) in files.items():
        blob = jp2(cs, space) if space else cs
        if src is not None:
            assert_lossless(blob, src, prec, name)
        with open(os.path.join(d, name), "wb") as f:
            f.write(blob)


def assert_lossless(blob, src, prec, name=""):
    """The writer's self-check: Pillow decodes a lossless file to its
    source (scaled to 8 or 16 bits as Pillow scales it)."""
    with Image.open(io.BytesIO(blob)) as im:
        got = np.asarray(im)
    want = src << ((16 if im.mode == "I;16" else 8) - prec)
    assert np.array_equal(got, want), name


def _digest(arr):
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _codestream(blob):
    if blob[:4] == b"\xff\x4f\xff\x51":
        return blob
    return tj2k._jp2_codestream(blob, "x")[0]


LISTING_MIN_SIZE = 20


def htj2k_expected_now(folder=FIXTURES):
    """expected.json's content as Pillow and the JAX package give it: the
    port's refusal is OpenJPEG's own first message."""
    files = {}
    for n in sorted(os.listdir(folder)):
        if n == "expected.json":
            continue
        p = os.path.join(folder, n)
        with Image.open(p) as im:
            e = {"format": im.format, "mode": im.mode,
                 "size": list(im.size[::-1])}
        try:
            e["sha256"] = _digest(jimages.load_image_uint8(p))
        except OSError as err:
            e["pillow_refuses"] = str(err).split(" (")[0]
            with open(p, "rb") as f:
                e["port"] = opj_reason(_codestream(f.read())).split(" | ")[0]
        files[n] = e
    listing = jimages.ImagesCached(folder, min_size=LISTING_MIN_SIZE)
    return {"files": files, "listing_min_size": LISTING_MIN_SIZE,
            "listing": [os.path.basename(p) for p in listing.paths()],
            "tested": [os.path.basename(p)
                       for p in jimages.iter_images_in(folder)],
            "coded": list(CODED)}


def _versions():
    return {"pillow": PIL.__version__,
            "openjpeg": PIL.features.version("jpg_2000"),
            "zlib": PIL.features.version("zlib")}


def _expected():
    with open(os.path.join(FIXTURES, "expected.json")) as f:
        return json.load(f)

# ------------------------------------------------------------- the tests

def test_tables_are_openjpegs():
    """The committed tables are the bytes of the libopenjp2 Pillow
    bundles, where it is installed."""
    import glob
    so = glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..",
                                "pillow.libs", "libopenjp2-*.so*"))
    if not so or PIL.features.version("jpg_2000") != "2.5.4":
        pytest.skip("no libopenjp2 2.5.4 here")
    with open(so[0], "rb") as f:
        lib = f.read()
    for tbl in (VLC_TBL0, VLC_TBL1):
        assert len(tbl) == 1024
        assert lib.count(struct.pack("<1024H", *tbl)) == 1
    assert lib.count(bytes(UVLC_DEC)) >= 1
    assert lib.count(struct.pack("<13i", *MEL_EXP)) == 1


def _hold(tmp_path, blob, name="x.j2k"):
    """The port against Pillow (and the JAX loader) on `blob`: the same
    pixels, or a ValueError with OpenJPEG's reason where Pillow refuses."""
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(blob)
    try:
        with Image.open(p) as im:
            im.load()
    except OSError as err:
        assert "broken data stream" in str(err)
        why = opj_reason(_codestream(blob)).split(" | ")[0]
        with pytest.raises(ValueError, match="broken data stream") as got:
            timages.load_image_uint8(p)
        assert why in str(got.value)
        return None
    check(p)
    return timages.load_image_uint8(p)


WRITER = {
    "grey_cb4": dict(cblk=(4, 4), levels=2),
    "rgb_cb16_l3": dict(cblk=(16, 16), levels=3),
    "rgb_cb64_l5": dict(levels=5),
    "rgb_cb128x8": dict(cblk=(128, 8), levels=1),
    "rgb_cb8x128": dict(cblk=(8, 128), levels=1),
    "rgb_cb32x16_l0": dict(cblk=(32, 16), levels=0),
    "tiles_precincts_lrcp": dict(cblk=(8, 8), tile=(16, 24),
                                 precincts=[(4, 4), (4, 4), (5, 4)],
                                 levels=2),
    "tiles_precincts_rpcl": dict(cblk=(8, 8), tile=(24, 16),
                                 precincts=[(4, 4), (4, 4), (5, 4)],
                                 levels=2, prog=2),
    "pcrl": dict(cblk=(8, 8), precincts=[(4, 4), (4, 4), (5, 5)], levels=2,
                 prog=3),
    "cprl_rlcp": dict(cblk=(16, 8), levels=2, prog=4),
}


@pytest.mark.parametrize("case", sorted(WRITER))
@pytest.mark.parametrize("hw", [(13, 21), (32, 32), (40, 27)])
def test_lossless_files_decode_to_their_source_in_pillow_and_the_port(
        tmp_path, case, hw):
    kw = dict(WRITER[case])
    img = _photo(*hw, seed=hw[0] + hw[1])
    planes = [img[..., 0]] if case.startswith("grey") else _rgb(img)
    src = planes[0] if len(planes) == 1 else img
    blob = ht_codestream(planes, **kw)
    assert_lossless(blob, src, 8)
    got = _hold(tmp_path, blob)
    assert np.array_equal(got, img if len(planes) == 3 else
                          np.repeat(src[..., None], 3, -1))
    got = _hold(tmp_path, jp2(blob, 16 if len(planes) == 3 else 17),
                "x.jp2")
    assert got is not None


@pytest.mark.parametrize("prec", [4, 10, 12, 16])
def test_grey_precisions_lossless(tmp_path, prec):
    r = np.random.RandomState(prec)
    g = r.randint(0, 1 << prec, (17, 23))
    blob = ht_codestream([g], prec=prec, levels=2, cblk=(16, 16))
    assert_lossless(blob, g, prec)
    _hold(tmp_path, blob)


@pytest.mark.parametrize("passes", [2, 3])
@pytest.mark.parametrize("vsc", [0, 8])
@pytest.mark.parametrize("cblk,drop", [((16, 16), 1), ((8, 8), 2),
                                       ((64, 64), 3), ((4, 32), 1),
                                       ((32, 4), 2)])
@pytest.mark.parametrize("seed", [0, 1])
def test_sigprop_and_magref_equal_pillow(tmp_path, passes, vsc, cblk, drop,
                                         seed):
    """Seeded refinement segments over cleanup passes at bit-plane
    `drop`: the port's SigProp / MagRef (and VSC) give OpenJPEG's
    pixels."""
    img = _photo(22 + seed, 26 - seed, seed + 30)
    blob = ht_codestream(_rgb(img), levels=2, cblk=cblk, passes=passes,
                         style=vsc, drop=lambda c, b, k, mb: drop,
                         seed=seed * 10 + passes + vsc)
    assert _hold(tmp_path, blob) is not None


@pytest.mark.parametrize("kw", [
    dict(step=(8, 100), guard=3), dict(step=(7, 1000), guard=2),
    dict(step=(9, 0), guard=3, passes=3, drop=lambda c, b, k, mb: 1),
    dict(step=(8, 0), guard=2, passes=2, drop=lambda c, b, k, mb: 2,
         style=8)], ids=["q8", "q7", "q9_p3", "q8_p2_vsc"])
def test_irreversible_97_equals_pillow(tmp_path, kw):
    img = _photo(30, 34, 41)
    assert _hold(tmp_path, jp2(ht_codestream(_rgb(img), levels=3,
                                             reversible=False, **kw), 16),
                 "x.jp2") is not None


def test_subsampled_and_four_components_equal_pillow(tmp_path):
    img = _photo(26, 30, 42)
    sub = [img[..., 0], img[::2, ::2, 1], img[::2, ::2, 2]]
    _hold(tmp_path, ht_codestream(sub, dx=[1, 2, 2], dy=[1, 2, 2], levels=2,
                                  cblk=(8, 8), mct=False))
    a = _photo(26, 30, 43)[..., :1]
    blob = jp2(ht_codestream(_rgb(np.dstack([img, a])), cblk=(16, 16)), 16)
    assert_lossless(blob, np.dstack([img, a]), 8)
    _hold(tmp_path, blob, "x.jp2")


@pytest.mark.parametrize("step", [1, 3, 5])
def test_every_zero_bitplane_count_equals_pillow(tmp_path, step):
    """Cleanup passes at every bit-plane from the top one (P = 0) to the
    last (P = Mb - 1), and one block past it (P = Mb): OpenJPEG refuses
    that one."""
    img = _photo(24, 24, 44)
    kw = dict(levels=1, cblk=(8, 8))
    got = _hold(tmp_path, ht_codestream(
        _rgb(img), drop=lambda c, b, k, mb: (step * k + c + b) % mb, **kw))
    assert got is not None
    assert _hold(tmp_path, ht_codestream(
        _rgb(img), zbp=lambda P, mb, k: mb if k == step % 4 else P,
        **kw)) is None


def _damaged():
    out = {}
    for n, (kw, _, _) in corpus().items():
        if "damage" in kw or n.startswith("x_"):
            out[n] = kw
    return out


@pytest.mark.parametrize("name", sorted(_damaged()))
def test_damaged_files_as_pillow(tmp_path, name):
    _hold(tmp_path, ht_codestream(**_damaged()[name]))


@pytest.mark.parametrize("seed", range(6))
def test_random_byte_flips_as_pillow(tmp_path, seed):
    """A byte of a code-block's cleanup or refinement segment flipped at
    random: decoded as OpenJPEG decodes it, or refused with its reason."""
    r = np.random.RandomState(seed)
    img = _photo(20, 24, 50 + seed)
    k0, band, seg_no, at, x = (int(r.randint(4)), int(r.randint(4)),
                               int(r.randint(2)), int(r.randint(1 << 20)),
                               int(r.randint(1, 256)))

    def damage(segs):
        segs = list(segs)
        s, n = segs[min(seg_no, len(segs) - 1)]
        segs[min(seg_no, len(segs) - 1)] = (_flip(s, at, x), n)
        return segs
    _hold(tmp_path, ht_codestream(_rgb(img), levels=1, cblk=(8, 8),
                                  passes=3, drop=lambda c, b, k, mb: 1,
                                  damage=_at(k0, damage, band=band),
                                  seed=seed))


def test_mel_start_check_follows_the_buffer_alignment():
    """mel_init checks the MEL bytes up to the next 4-byte boundary of
    the buffer: an 0xFF 0x95 start is refused before the boundary and
    read past it."""
    seg = bytes([0xFF, 0x95, 0x00, 0x00, 0x00, 0x00, 0x70, 0x00])
    assert not tht._mel_start_ok(seg, 8, 8, 0)
    assert tht._mel_start_ok(seg, 8, 8, 3)
    assert tht._mel_start_ok(seg, 8, 8, 1) is False


@pytest.mark.parametrize("layers", [2, 3])
@pytest.mark.parametrize("prog", [0, 2])
def test_refinement_in_a_second_layer_as_openjpeg(tmp_path, layers, prog):
    """OpenJPEG reads a later layer's passes as one more pass of the
    cleanup's segment and the rest: a standard two-layer file fails there
    in both (a bad Scup, or a segment past the data), and one written as
    OpenJPEG reads it decodes to its pixels in both."""
    img = _photo(29, 37, 60 + prog)
    blob = ht_codestream(_rgb(img), levels=2, cblk=(16, 16), prog=prog,
                         precincts=[(4, 4), (4, 4), (5, 5)], passes=3,
                         drop=lambda c, b, k, mb: 1, layers=layers,
                         seed=layers)
    assert (_hold(tmp_path, blob) is None) == (layers == 2)


@pytest.mark.parametrize("cut", [1, 40, 400])
def test_tile_data_cut_short_as_openjpeg(tmp_path, cut):
    """A tile-part whose data ends inside a code-block's segment (its
    Psot shortened to match): refused with OpenJPEG's own message."""
    img = _photo(40, 44, 61)
    cs = ht_codestream(_rgb(img), levels=2, cblk=(16, 16), passes=2,
                       drop=lambda c, b, k, mb: 1)
    sot = cs.index(b"\xff\x90")
    psot, = struct.unpack(">I", cs[sot + 6:sot + 10])
    cut = min(cut, psot - 20)
    cs = cs[:sot + 6] + struct.pack(">I", psot - cut) + \
        cs[sot + 10:sot + psot - cut] + b"\xff\xd9"
    assert _hold(tmp_path, cs) is None


def test_only_avif_is_left_not_decoded_by_the_port():
    """Every other refusal of the loader is Pillow's own (held in the
    format's tests): "not decoded / read by the port yet" is said only of
    the AVIF tool the port does not decode yet (an inter frame:
    data/av1_obu.py; data/avif.py reads
    sequences with or without a meta box, data/avif_yuv.py converts
    every matrix libavif converts) and in the loader's fallback; AVIF
    itself now has a decoder."""
    import re
    from l3c_torch.data import avif as tavif
    data = os.path.join(ROOT, "l3c_torch", "data")
    found = []
    for n in sorted(os.listdir(data)):
        if n.endswith(".py"):
            with open(os.path.join(data, n)) as f:
                text = f.read()
            found += [(n, m.start()) for m in re.finditer(
                r"by the port yet", text)]
    assert sorted({n for n, _ in found}) == ["av1_obu.py", "images.py"]
    with open(os.path.join(data, "avif.py")) as f:
        assert "AVIF without a meta box" not in f.read()
    assert [n for n, (_, dec) in timages._FORMATS.items()
            if dec is None] == []
    assert timages._FORMATS["AVIF"] == (tavif.avif_header,
                                        tavif.decode_avif)
    assert not [n for n, _ in timages._ORDER
                if n not in timages._FORMATS and
                n not in timages._PILLOW_REFUSES]


def test_htj2k_expected_json_equals_pillow_and_jax_now():
    want = _expected()
    got = htj2k_expected_now()
    assert got == {k: want[k] for k in got}
    assert sum(os.path.getsize(os.path.join(FIXTURES, n))
               for n in os.listdir(FIXTURES)) < 450_000
    assert want["tested"] == ["a_rgb_lossless_as.png"]
    assert want["listing"] == ["a_rgb_lossless_as.png"]


def test_maker_writes_the_committed_files(tmp_path):
    make_htj2k_fixtures(str(tmp_path))
    names = sorted(n for n in os.listdir(FIXTURES) if n != "expected.json")
    assert sorted(os.listdir(tmp_path)) == names
    for n in names:
        with open(os.path.join(FIXTURES, n), "rb") as f, \
                open(os.path.join(tmp_path, n), "rb") as g:
            assert f.read() == g.read(), n


def test_port_reads_the_htj2k_fixtures_as_expected():
    for n, e in _expected()["files"].items():
        p = os.path.join(FIXTURES, n)
        assert timages.image_format(p) == e["format"], n
        assert timages.image_mode(p) == e["mode"], n
        assert list(timages.image_size(p)) == e["size"], n
        if "pillow_refuses" in e:
            with pytest.raises(ValueError, match="broken data stream") as err:
                timages.load_image_uint8(p)
            assert e["port"] in str(err.value), n
        else:
            got = timages.load_image_uint8(p)
            assert _digest(got) == e["sha256"], n
            assert np.array_equal(got, jimages.load_image_uint8(p)), n
    got = timages.ImagesCached(FIXTURES, min_size=LISTING_MIN_SIZE).paths()
    assert [os.path.basename(p) for p in got] == _expected()["listing"]


if __name__ == "__main__":
    for n in os.listdir(FIXTURES) if os.path.isdir(FIXTURES) else ():
        os.remove(os.path.join(FIXTURES, n))
    make_htj2k_fixtures(FIXTURES)
    exp = {**htj2k_expected_now(), "made_by": _versions()}
    with open(os.path.join(FIXTURES, "expected.json"), "w") as f:
        json.dump(exp, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {len(exp['files'])} fixtures and expected.json to "
          f"{FIXTURES}")
