"""AV1 intra prediction and inverse transforms (the AV1 specification,
sections 7.11.2 and 7.13), in integers, as dav1d computes them for 8-,
10- and 12-bit samples (`bd`; predictions clip to its range).

Prediction works on the edge arrays the specification builds (`above`
and `left`, index 0 standing for position -1, two more entries in front
when upsampled): DC, smooth (plain, V, H), Paeth, directional with the
intra-edge filter and upsampling, recursive filter intra, and the
chroma-from-luma step. The inverse transforms (DCT 4-64, ADST 4-16 with
their flips, identity 4-32, the lossless WHT) run one 1-D pass over all
rows (or all columns) of a block at once: each of the `n` inputs is a
numpy vector. The DCT and ADST butterflies are the ones libaom and dav1d
use (12-bit cosines, a rounding after every rotation), every sum and
difference clipped as dav1d's transforms clip it (`itx_1d.c`; a valid
stream never reaches the clip, a damaged one can): to 16 bits at 8-bit
depth, else the rows to bd + 8 bits and the columns to max(bd + 6, 16)
(`clip_ranges`). The clips run only where a pass could reach them: no
sum or difference of the DCT or ADST networks weighs an input by more
than 1 (`test_torch_port_av1.py` measures it), so a pass whose inputs'
absolute sum stays `MARGIN` below its clip runs unclipped.

Past valid coefficients (damaged streams; a valid one never gets there)
the arithmetic of the x86 code dav1d runs is followed, as Pillow's
pixels show it on an AVX-512 host: at 8 bits the rotations of the 4- to
32-point DCT passes and the 8- and 16-point ADST passes saturate to 16
bits or keep their low 16 bits, by pass and, where dav1d's code for a
shape differs, by transform shape (`DCT_8BIT`, `ADST_8BIT`,
`SHAPE_8BIT`); at 10 bits the columns' rotations, 4-point ADSTs and
identities saturate to 16 bits; at 12 bits the products wrap to 32 bits
but for the ADST's last rotations (`_ADST_12BIT`).
"""
from __future__ import annotations

from typing import List

import numpy as np

from . import av1_tables as T

COS = T.COS128
SINPI = T.SINPI
LO, HI = -(1 << 15), (1 << 15) - 1       # dav1d's 8-bit intermediate range
MARGIN = 512            # past the roundings a pass's values can gather


def _clip(v):
    return np.clip(v, LO, HI)


def _keep(v):
    return v


def clip_ranges(bd: int):
    """dav1d's (row, column) clip maxima of the inverse transforms at
    depth bd (the minima are -max - 1)."""
    if bd == 8:
        return HI, HI
    return (1 << (bd + 7)) - 1, (1 << max(bd + 5, 15)) - 1


# modes (V_PRED .. D67_PRED, 1-8, are the directional ones)
DC_PRED, SMOOTH, SMOOTH_V, SMOOTH_H, UV_CFL = 0, 9, 10, 11, 13
MODE_TO_ANGLE = (0, 90, 180, 45, 135, 113, 157, 203, 67, 0, 0, 0, 0)
EDGE_KERNEL = ((0, 4, 8, 4, 0), (0, 5, 6, 5, 0), (2, 4, 4, 4, 2))
_SMW = {n: np.array(T.SM_WEIGHTS[n - 4:2 * n - 4], np.int64)
        for n in (4, 8, 16, 32, 64)}
FILTER_TAPS = np.array(T.FILTER_INTRA_TAPS, np.int64).reshape(5, 8, 8)[
    :, :, :7]


# ------------------------------------------------------------ prediction

def pred_dc(above, left, w, h, have_a, have_l, bd=8):
    if have_a and have_l:
        s = int(above[1:w + 1].sum()) + int(left[1:h + 1].sum())
        v = (s + ((w + h) >> 1)) // (w + h)
    elif have_l:
        v = (int(left[1:h + 1].sum()) + (h >> 1)) >> (h.bit_length() - 1)
    elif have_a:
        v = (int(above[1:w + 1].sum()) + (w >> 1)) >> (w.bit_length() - 1)
    else:
        v = 1 << (bd - 1)
    return np.full((h, w), v, np.int64)


def pred_smooth(above, left, w, h, mode):
    a = above[1:w + 1]
    l_ = left[1:h + 1]
    if mode == SMOOTH:
        wy, wx = _SMW[h][:, None], _SMW[w][None, :]
        p = wy * a[None, :] + (256 - wy) * left[h] + wx * l_[:, None] + \
            (256 - wx) * above[w]
        return (p + 256) >> 9
    if mode == SMOOTH_V:
        wy = _SMW[h][:, None]
        return (wy * a[None, :] + (256 - wy) * left[h] + 128) >> 8
    wx = _SMW[w][None, :]
    return (wx * l_[:, None] + (256 - wx) * above[w] + 128) >> 8


def pred_paeth(above, left, w, h):
    a = above[1:w + 1][None, :]
    l_ = left[1:h + 1][:, None]
    tl = above[0]
    base = a + l_ - tl
    pl, pt, ptl = np.abs(base - l_), np.abs(base - a), np.abs(base - tl)
    return np.where((pl <= pt) & (pl <= ptl), l_,
                    np.where(pt <= ptl, a, tl)).astype(np.int64)


def pred_filter_intra(above, left, w, h, mode, bd=8):
    taps = FILTER_TAPS[mode]
    pred = np.zeros((h, w), np.int64)
    for i2 in range(h >> 1):
        for j4 in range(w >> 2):
            p = [0] * 7
            for i in range(7):
                if i < 5:
                    if i2 == 0:
                        p[i] = above[(j4 << 2) + i]          # index - 1
                    elif j4 == 0 and i == 0:
                        p[i] = left[(i2 << 1)]               # (i2<<1) - 1
                    else:
                        p[i] = pred[(i2 << 1) - 1, (j4 << 2) + i - 1]
                else:
                    if j4 == 0:
                        p[i] = left[(i2 << 1) + i - 4]
                    else:
                        p[i] = pred[(i2 << 1) + i - 5, (j4 << 2) - 1]
            pv = np.array(p, np.int64)
            pr = taps @ pv
            pr = np.where(pr >= 0, (pr + 8) >> 4, -((-pr + 8) >> 4))
            pred[(i2 << 1):(i2 << 1) + 2, (j4 << 2):(j4 << 2) + 4] = \
                np.clip(pr, 0, (1 << bd) - 1).reshape(2, 4)
    return pred


def edge_strength(w, h, ftype, delta):
    d = abs(delta)
    s = 0
    wh = w + h
    if ftype == 0:
        if wh <= 8:
            s = 1 if d >= 56 else 0
        elif wh <= 16:
            s = 1 if d >= 40 else 0
        elif wh <= 24:
            s = 3 if d >= 32 else 2 if d >= 16 else 1 if d >= 8 else 0
        elif wh <= 32:
            s = 3 if d >= 32 else 2 if d >= 4 else 1 if d >= 1 else 0
        else:
            s = 3 if d >= 1 else 0
    else:
        if wh <= 8:
            s = 2 if d >= 64 else 1 if d >= 40 else 0
        elif wh <= 16:
            s = 2 if d >= 48 else 1 if d >= 20 else 0
        elif wh <= 24:
            s = 3 if d >= 4 else 0
        else:
            s = 3 if d >= 1 else 0
    return s


def edge_filter(edge, sz, strength):
    """intra_edge_filter over edge[0:sz] (index 0 is position -1)."""
    if not strength or sz <= 1:
        return
    k = EDGE_KERNEL[strength - 1]
    e = edge[:sz].copy()
    idx = np.arange(1, sz)
    s = np.zeros(sz - 1, np.int64)
    for j in range(5):
        s += k[j] * e[np.clip(idx - 2 + j, 0, sz - 1)]
    edge[1:sz] = (s + 8) >> 4


def use_upsample(w, h, ftype, delta):
    d = abs(delta)
    if d <= 0 or d >= 40:
        return 0
    return int(w + h <= (8 if ftype else 16))


def upsample(edge, num_px, bd=8):
    """upsample(numPx): edge (index 0 = position -1) -> the doubled edge
    with index 0 = position -2."""
    dup = np.empty(num_px + 3, np.int64)
    dup[0] = edge[0]
    dup[1:num_px + 2] = edge[0:num_px + 1]
    dup[num_px + 2] = edge[num_px]
    out = np.zeros(2 * num_px + 2 + len(edge), np.int64)
    out[0] = dup[0]                                  # position -2
    s = -dup[0:num_px] + 9 * dup[1:num_px + 1] + 9 * dup[2:num_px + 2] - \
        dup[3:num_px + 3]
    s = np.clip((s + 8) >> 4, 0, (1 << bd) - 1)
    out[1:2 * num_px + 1:2] = s                      # positions 2i - 1
    out[2:2 * num_px + 2:2] = dup[2:num_px + 2]      # positions 2i
    return out


def pred_directional(above, left, w, h, p_angle, have_a, have_l, ftype,
                     edge_on, max_x_px, max_y_px, bd=8):
    """`above` / `left` hold w + h + 1 entries from position -1;
    max_x_px / max_y_px: pixels from the block's origin to the plane's
    decoded edge."""
    above = above.copy()
    left = left.copy()
    up_a = up_l = 0
    if edge_on:
        if p_angle != 90 and p_angle != 180:
            if 90 < p_angle < 180 and w + h >= 24:
                c = (left[1] * 5 + above[0] * 6 + above[1] * 5 + 8) >> 4
                above[0] = left[0] = c
            if have_a:
                st = edge_strength(w, h, ftype, p_angle - 90)
                n = min(w, max_x_px) + (h if p_angle < 90 else 0) + 1
                edge_filter(above, n, st)
            if have_l:
                st = edge_strength(w, h, ftype, p_angle - 180)
                n = min(h, max_y_px) + (w if p_angle > 180 else 0) + 1
                edge_filter(left, n, st)
        up_a = use_upsample(w, h, ftype, p_angle - 90)
        if up_a:
            above = upsample(above, w + (h if p_angle < 90 else 0), bd=bd)
        up_l = use_upsample(w, h, ftype, p_angle - 180)
        if up_l:
            left = upsample(left, h + (w if p_angle > 180 else 0), bd=bd)
    # index offsets: position p lives at p + 1 (+1 more when upsampled)
    oa = 2 if up_a else 1
    ol = 2 if up_l else 1
    i = np.arange(h)[:, None]
    j = np.arange(w)[None, :]
    if p_angle == 90:
        return np.broadcast_to(above[1:w + 1][None, :], (h, w)).astype(
            np.int64)
    if p_angle == 180:
        return np.broadcast_to(left[1:h + 1][:, None], (h, w)).astype(
            np.int64)
    if p_angle < 90:
        dx = T.DR_INTRA_DERIVATIVE[p_angle]
        idx = (i + 1) * dx
        base = (idx >> (6 - up_a)) + (j << up_a)
        shift = ((idx << up_a) >> 1) & 0x1F
        max_base = (w + h - 1) << up_a
        b = np.minimum(base, max_base)
        b1 = np.minimum(base + 1, max_base)
        p = (above[b + oa] * (32 - shift) + above[b1 + oa] * shift + 16) >> 5
        return np.where(base < max_base, p, above[max_base + oa])
    if p_angle > 180:
        dy = T.DR_INTRA_DERIVATIVE[270 - p_angle]
        idx = (j + 1) * dy
        base = (idx >> (6 - up_l)) + (i << up_l)
        shift = ((idx << up_l) >> 1) & 0x1F
        max_base = (w + h - 1) << up_l
        b = np.minimum(base, max_base)
        b1 = np.minimum(base + 1, max_base)
        p = (left[b + ol] * (32 - shift) + left[b1 + ol] * shift + 16) >> 5
        return np.where(base < max_base, p, left[max_base + ol])
    dx = T.DR_INTRA_DERIVATIVE[180 - p_angle]
    dy = T.DR_INTRA_DERIVATIVE[p_angle - 90]
    idx = (j << 6) - (i + 1) * dx
    base = idx >> (6 - up_a)
    shift = ((idx << up_a) >> 1) & 0x1F
    use_a = base >= -(1 << up_a)
    ba = np.where(use_a, base, 0)
    pa = (above[ba + oa] * (32 - shift) + above[ba + 1 + oa] * shift + 16) \
        >> 5
    idx2 = (i << 6) - (j + 1) * dy
    base2 = idx2 >> (6 - up_l)
    shift2 = ((idx2 << up_l) >> 1) & 0x1F
    bl = np.where(use_a, 0, base2)
    pl = (left[bl + ol] * (32 - shift2) + left[bl + 1 + ol] * shift2 + 16) \
        >> 5
    return np.where(use_a, pa, pl)


def cfl(pred_dc_block, luma, alpha, bd=8):
    """predict_chroma_from_luma on the DC prediction, `luma` the
    subsampled, padded luma values (L in the specification)."""
    h, w = pred_dc_block.shape
    avg = (int(luma.sum()) + ((w * h) >> 1)) >> ((w * h).bit_length() - 1)
    d = alpha * (luma - avg)
    scaled = np.where(d >= 0, (d + 32) >> 6, -((-d + 32) >> 6))
    return np.clip(pred_dc_block + scaled, 0, (1 << bd) - 1)


# ------------------------------------------------------ inverse transforms

def _hb(w0, a, w1, b):
    return (w0 * a + w1 * b + 2048) >> 12


def _wrap32(v):
    """v as a 32-bit two's-complement integer."""
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _hb_wrap(w0, a, w1, b):
    """A rotation whose products wrap in 32-bit lanes (dav1d's 12-bit
    transforms on x86 multiply by the whole 12-bit constants)."""
    return _wrap32(w0 * a + w1 * b + 2048) >> 12


def _hb_sat16(w0, a, w1, b):
    """A rotation whose result saturates to 16 bits (the second pass of
    dav1d's 10-bit transforms on x86 runs in 16-bit lanes)."""
    return np.clip((w0 * a + w1 * b + 2048) >> 12, LO, HI)


def _hb_low16(w0, a, w1, b):
    """A rotation that keeps the low 16 bits of its result (dav1d's
    AVX-512 8-bit transforms take the high words of 32-bit sums)."""
    return (((w0 * a + w1 * b + 2048) >> 12) + (1 << 15) & 0xFFFF) - \
        (1 << 15)


# dav1d's AVX-512 8-bit passes (x86 with the AVX-512 ICL set, as
# Pillow's builds run it), past valid coefficients: a pass of an n-point
# DCT or ADST named here saturates its rotations to 16 bits but for
# those its table names, which keep the low 16 bits ("odd", n: the first
# rotations of a DCT's odd half or of an ADST; "rot", n, g: a DCT's later
# ones on groups of g, an ADST's after its sums over g). `DCT_8BIT` and
# `ADST_8BIT` give a pass of any transform; `SHAPE_8BIT`, by (kind,
# pass, width, height) and, where the other pass's kind matters, that
# kind, the passes whose code differs (the rectangular DCTs of 16 x 32,
# 32 x 16, 8 x 32 and 4 x 16, the 16-point ADST columns, the 16-point
# ADST rows of 16 x 8 and 16 x 4, the 4 x 16 ADSTs). Found by holding
# files to Pillow
# (tests/test_torch_port_avif_hidden.py,
# tests/test_torch_port_avif_inter.py); the 64-point DCT, the 4-point
# ADST and the identities follow dav1d's C code.
DCT_8BIT = {4: {}, 8: {("odd", 8): _hb_low16},
            16: {("odd", 8): _hb_low16, ("odd", 16): _hb_low16,
                 ("rot", 16, 2): _hb_low16},
            32: {}}
ADST_8BIT = {("row", 8): {("odd", 8): _hb_low16, ("rot", 8, 4): _hb_low16},
             ("col", 8): {},
             ("row", 16): {("odd", 16): _hb_low16, ("rot", 16, 8): _hb_low16,
                           ("rot", 16, 4): _hb_low16}}
_ADST16_WIDE = {("odd", 16): _hb_low16, ("rot", 16, 8): _hb_low16}
_DCT16_RECT = {("odd", 8): _hb_low16, ("odd", 16): _hb_low16}
_DCT32_RECT = {("rot", 32, 2): _hb_low16, ("rot", 32, 4): _hb_low16,
               ("rot", 16, 2): _hb_low16}
SHAPE_8BIT = {
    ("DCT", "col", 16, 32): _DCT32_RECT, ("DCT", "row", 16, 32): _DCT16_RECT,
    ("DCT", "row", 32, 16): _DCT32_RECT,
    ("DCT", "col", 32, 16): _DCT16_RECT,
    ("ADST", "col", 16, 16): ADST_8BIT["row", 16],
    ("ADST", "col", 8, 16): {("rot", 16, 8): _hb_low16},
    ("ADST", "col", 4, 16): {("rot", 16, 8): _hb_low16},
    ("ADST", "row", 4, 16): {},
    ("DCT", "row", 8, 32): {},
    ("DCT", "col", 4, 16, "DCT"): _DCT16_RECT,
    ("DCT", "row", 4, 16, "DCT"): {("odd", 4): _hb_low16,
                                   ("odd", 2): _hb_low16},
    ("ADST", "row", 16, 8): _ADST16_WIDE,
    ("ADST", "row", 16, 4): _ADST16_WIDE}
# dav1d's 12-bit ADST (32-bit lanes): the last rotations, by cos(pi / 4),
# do not wrap
_ADST_12BIT = {("rot", 8, 2): _hb, ("rot", 16, 2): _hb}


def idct(x: List, clip=_keep, hb=_hb, stages=None) -> List:
    """The DCT of len(x) = 2^n inputs (n = 1..6): even half recursively,
    odd half through libaom's butterfly network; `clip` (none by default)
    after each sum and difference, `hb` each rotation but those `stages`
    names (("odd", n): the odd half's first rotations, the 2-point DCT's
    at n = 2; ("rot", n, g): its later ones)."""
    n = len(x)
    c32 = COS[32]
    stages = stages or {}
    if n == 2:
        hb = stages.get(("odd", 2), hb)
        return [hb(c32, x[0], c32, x[1]), hb(c32, x[0], -c32, x[1])]
    e = idct(x[0::2], clip, hb, stages)
    m = n // 2
    bits = m.bit_length() - 1
    o = [x[2 * _brev(bits, j) + 1] for j in range(m)]
    unit = 64 // n
    half_bits = (m // 2).bit_length() - 1
    first = stages.get(("odd", n), hb)
    for j in range(m // 2):
        b = unit * (1 + 4 * _brev(half_bits, j))
        a = 64 - b
        p, q = o[j], o[m - 1 - j]
        o[j] = first(COS[a], p, -COS[b], q)
        o[m - 1 - j] = first(COS[b], p, COS[a], q)
    g = 2
    while g < m:
        _bfly(o, g, clip)
        _odd_rot(o, g, m, stages.get(("rot", n, g), hb))
        g *= 2
    return [clip(e[i] + o[m - 1 - i]) for i in range(m)] + \
        [clip(e[m - 1 - i] - o[i]) for i in range(m)]


def _brev(bits: int, v: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (v & 1)
        v >>= 1
    return r


def _bfly(o, g, clip):
    for t in range(len(o) // g):
        s = t * g
        for i in range(g // 2):
            a, b = o[s + i], o[s + g - 1 - i]
            if t % 2 == 0:
                o[s + i], o[s + g - 1 - i] = clip(a + b), clip(a - b)
            else:
                o[s + i], o[s + g - 1 - i] = clip(b - a), clip(a + b)


def _odd_rot(o, g, m, hb):
    c32 = COS[32]
    size = 2 * g
    if size == m:
        for p in range(g // 2, g // 2 + g):
            if p >= m - 1 - p:
                break
            q = m - 1 - p
            a, b = o[p], o[q]
            o[p] = hb(-c32, a, c32, b)
            o[q] = hb(c32, a, c32, b)
        return
    pairs = m // size // 2
    unit = 16 // pairs
    pb = pairs.bit_length() - 1
    for s in range(pairs):
        th = unit * (1 + 4 * _brev(pb, s))
        ct, cc = COS[th], COS[64 - th]
        for k in range(g):
            p = s * size + g // 2 + k
            q = m - 1 - p
            a, b = o[p], o[q]
            if k < g // 2:
                o[p] = hb(-ct, a, cc, b)
                o[q] = hb(cc, a, ct, b)
            else:
                o[p] = hb(-cc, a, -ct, b)
                o[q] = hb(-ct, a, cc, b)


def iadst4(x: List, hb=_hb) -> List:
    """The 4-point ADST; with `hb` _hb_wrap its sums wrap to 32 bits, with
    _hb_sat16 its outputs saturate to 16 bits, as the rotations do."""
    s1, s2, s3, s4 = SINPI[1:5]
    x0, x1, x2, x3 = x
    wrap = _wrap32 if hb is _hb_wrap else _keep
    a0 = wrap(s1 * x0 + s4 * x2 + s2 * x3)
    a1 = wrap(s2 * x0 - s1 * x2 - s4 * x3)
    a2 = wrap(s3 * (x0 - x2 + x3))
    a3 = wrap(s3 * x1)
    out = [wrap(a0 + a3 + 2048) >> 12, wrap(a1 + a3 + 2048) >> 12,
           wrap(a2 + 2048) >> 12, wrap(a0 + a1 - a3 + 2048) >> 12]
    return [np.clip(v, LO, HI) for v in out] if hb is _hb_sat16 else out


_ADST_OUT = {8: (0, -4, 6, -2, 3, -7, 5, -1),
             16: (0, -8, 12, -4, 6, -14, 10, -2, 3, -11, 15, -7, 5, -13, 9,
                  -1)}


def iadst(x: List, clip=_keep, hb=_hb, stages=None) -> List:
    """The ADST of len(x) = 4, 8 or 16 inputs; `clip` after each sum and
    difference, `hb` each rotation but those `stages` names (("odd", n):
    the first rotations; ("rot", n, span): those after the sums over
    `span`)."""
    n = len(x)
    if n == 4:
        return iadst4(x, hb)
    stages = stages or {}
    b = [None] * n
    for k in range(n // 2):
        b[2 * k] = x[n - 1 - 2 * k]
        b[2 * k + 1] = x[2 * k]
    unit = 32 // n
    first = stages.get(("odd", n), hb)
    for k in range(n // 2):
        al = unit * (1 + 4 * k)
        p, q = b[2 * k], b[2 * k + 1]
        b[2 * k] = first(COS[al], p, COS[64 - al], q)
        b[2 * k + 1] = first(COS[64 - al], p, -COS[al], q)
    span = n // 2
    while span >= 2:
        for s in range(0, n, 2 * span):
            for i in range(span):
                p, q = b[s + i], b[s + i + span]
                b[s + i], b[s + i + span] = clip(p + q), clip(p - q)
        # rotations on the second half of each block of 2 * span
        u = 64 // span
        npairs = span // 2
        hb_s = stages.get(("rot", n, span), hb)
        for s in range(0, n, 2 * span):
            for k in range(npairs):
                th = u * (1 + 4 * (k % max(1, npairs // 2)))
                j = s + span + 2 * k
                p, q = b[j], b[j + 1]
                if k < max(1, npairs // 2):
                    b[j] = hb_s(COS[th], p, COS[64 - th], q)
                    b[j + 1] = hb_s(COS[64 - th], p, -COS[th], q)
                else:
                    b[j] = hb_s(-COS[64 - th], p, COS[th], q)
                    b[j + 1] = hb_s(COS[th], p, COS[64 - th], q)
        span //= 2
    return [b[v] if v >= 0 else -b[-v] for v in _ADST_OUT[n]]


def iidentity(x: List) -> List:
    n = len(x)
    if n == 4:
        return [(5793 * v + 2048) >> 12 for v in x]
    if n == 8:
        return [2 * v for v in x]
    if n == 16:
        return [(11586 * v + 2048) >> 12 for v in x]
    return [4 * v for v in x]


DCT, ADST, FLIPADST, IDTX = 0, 1, 2, 3
# tx type -> (vertical, horizontal) 1-D kinds
TX_KINDS = ((DCT, DCT), (ADST, DCT), (DCT, ADST), (ADST, ADST),
            (FLIPADST, DCT), (DCT, FLIPADST), (FLIPADST, FLIPADST),
            (ADST, FLIPADST), (FLIPADST, ADST), (IDTX, IDTX), (DCT, IDTX),
            (IDTX, DCT), (ADST, IDTX), (IDTX, ADST), (FLIPADST, IDTX),
            (IDTX, FLIPADST))
ROW_SHIFT = (0, 1, 2, 2, 2, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2)


def _one_d(kind, vecs, l1, hi=HI, hb=_hb, stages=None):
    """One pass; `l1`, the largest absolute sum of a transform's inputs,
    says whether the network's clips to [-hi - 1, hi] can act, and
    whether `hb`'s (and `stages`') saturation or low 16 bits (as the
    clips) or wrapping (no product sum of a pass passes 8192 l1, so not
    below l1 = 2^18) can."""
    if kind == IDTX:
        out = iidentity(vecs)
        return [np.clip(v, LO, HI) for v in out] if hb is _hb_sat16 else out
    if l1 <= hi - MARGIN:
        clip = _keep
    elif hi == HI:
        clip = _clip
    else:
        def clip(v):
            return np.clip(v, -hi - 1, hi)
    if hb is _hb_wrap and l1 < 1 << 18 or hb is _hb_sat16 and \
            clip is _keep:
        hb, stages = _hb, None
    if kind == DCT:
        return idct(vecs, clip, hb, stages)
    return iadst(vecs, clip, hb, stages)


def _avx512_8bit(kind, hb, pass_, w, h, other):
    """(rotation, stages) of an 8-bit pass (`pass_` "row" or "col") of a
    w x h transform, the pass of kind `kind` and the other of kind
    `other`, as dav1d's AVX-512 code computes it where known
    (`SHAPE_8BIT`, `DCT_8BIT`, `ADST_8BIT`), else `hb` (dav1d's C)."""
    n = w if pass_ == "row" else h
    names = {DCT: "DCT", ADST: "ADST", FLIPADST: "ADST", IDTX: "IDTX"}
    kind, name = ADST if kind == FLIPADST else kind, names[kind]
    for key in ((name, pass_, w, h, names[other]), (name, pass_, w, h)):
        if key in SHAPE_8BIT:
            return _hb_sat16, SHAPE_8BIT[key]
    if kind == DCT and n in DCT_8BIT:
        return _hb_sat16, DCT_8BIT[n]
    if kind == ADST and (pass_, n) in ADST_8BIT:
        return _hb_sat16, ADST_8BIT[pass_, n]
    return hb, None


def inverse_transform(coef: np.ndarray, tx_type: int, tx_size: int,
                      w: int, h: int, bd: int = 8) -> np.ndarray:
    """The 2-D inverse transform of the (h, w) dequantized block (zero
    outside its top-left 32 x 32), flips applied: the residual. Past the
    range of valid coefficients the x86 code dav1d runs is followed: at
    8 bits the AVX-512 passes of 4- to 32-point DCTs and 8- and 16-point
    ADSTs (`DCT_8BIT`, `ADST_8BIT`), at 10 bits the columns' rotations,
    4-point ADSTs and identities saturate to 16 bits, at 12 bits the
    products wrap to 32 bits (but the ADST's last rotations)."""
    row_hi, col_hi = clip_ranges(bd)
    row_hb, col_hb = {8: (_hb, _hb), 10: (_hb, _hb_sat16),
                      12: (_hb_wrap, _hb_wrap)}[bd]
    vk, hk = TX_KINDS[tx_type]
    row_st = col_st = _ADST_12BIT if bd == 12 else None
    if bd == 8:
        row_hb, row_st = _avx512_8bit(hk, row_hb, "row", w, h, vk)
        col_hb, col_st = _avx512_8bit(vk, col_hb, "col", w, h, hk)
    lw, lh = w.bit_length() - 1, h.bit_length() - 1
    rows = min(h, 32)
    c = coef[:rows].astype(np.int64)
    if abs(lw - lh) == 1:
        c = (c * 2896 + 2048) >> 12
    out = _one_d(hk, [c[:, j] for j in range(w)],
                 int(np.abs(c).sum(1).max()), row_hi, row_hb, row_st)
    r = np.stack(out, 1)
    sh = ROW_SHIFT[tx_size]
    if sh:
        r = (r + (1 << (sh - 1))) >> sh
    r = np.clip(r, -col_hi - 1, col_hi)
    if rows < h:
        r = np.concatenate([r, np.zeros((h - rows, w), np.int64)])
    out = _one_d(vk, [r[i] for i in range(h)], int(np.abs(r).sum(0).max()),
                 col_hi, col_hb, col_st)
    res = (np.stack(out, 0) + 8) >> 4
    if hk == FLIPADST:
        res = res[:, ::-1]
    if vk == FLIPADST:
        res = res[::-1]
    return res


def inverse_wht(coef) -> List[List[int]]:
    """The lossless 4x4 inverse Walsh-Hadamard transform (rows with shift
    2, then columns), `coef` a row-major list of 16."""
    t = [0] * 16
    for i in range(4):
        a, c, d, b = (coef[4 * i] >> 2, coef[4 * i + 1] >> 2,
                      coef[4 * i + 2] >> 2, coef[4 * i + 3] >> 2)
        a += c
        d -= b
        e = (a - d) >> 1
        b = e - b
        c = e - c
        a -= b
        d += c
        t[4 * i:4 * i + 4] = a, b, c, d
    out = [[0] * 4 for _ in range(4)]
    for j in range(4):
        a, c, d, b = t[j], t[4 + j], t[8 + j], t[12 + j]
        a += c
        d -= b
        e = (a - d) >> 1
        b = e - b
        c = e - c
        a -= b
        d += c
        out[0][j], out[1][j], out[2][j], out[3][j] = a, b, c, d
    return out
