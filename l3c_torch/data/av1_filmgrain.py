"""AV1's film grain synthesis (the AV1 specification, section 7.18.3), as
dav1d 1.5 applies it to the 8-, 10- and 12-bit frames it outputs
(`filmgrain_tmpl.c`, `fg_apply_tmpl.c`), which is what Pillow's libavif
hands on: dav1d's `apply_grain` is on there.

`apply_grain(planes, grain, seq)` takes the cropped, filtered planes and
the frame header's `grain` parameters (av1_obu) and returns the planes
with grain: the 16-bit LFSR; the 73 x 82 luma grain template and the
chroma templates (38 x 44 at 4:2:0, 73 x 44 at 4:2:2, 73 x 82 at 4:4:4)
from the Gaussian sequence; their autoregressive filter (serial along a
row, the rows above as numpy); the scaling functions (256 entries, at
10 and 12 bits 2^bd, interpolated between them as dav1d's
generate_scaling does); the noise
of each 32-row stripe from 32 x 32 blocks at random offsets seeded by the
stripe's number, blended over two columns (one at half width) where
blocks meet and over two rows (one) where stripes meet; chroma scaled by
its own points or from luma; the result clipped to the restricted range
where the header asks. Above 8 bits (sh = bd - 8) the grain's range
and the clip ranges scale by 2^sh, the Gaussian values are rounded by sh
bits less and the chroma offset shifts left by sh.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import List

import numpy as np

from . import av1_tables as T

GAUSS = np.array(T.GAUSSIAN_SEQUENCE, np.int64)


class _Lfsr:
    def __init__(self, seed: int):
        self.r = seed & 0xFFFF

    def get(self, bits: int) -> int:
        r = self.r
        bit = (r ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1
        self.r = r = (r >> 1) | (bit << 15)
        return (r >> (16 - bits)) & ((1 << bits) - 1)


def _gaussian(seed: int, h: int, w: int, shift: int) -> np.ndarray:
    rng = _Lfsr(seed)
    idx = np.array([rng.get(11) for _ in range(h * w)], np.int64)
    return (GAUSS[idx].reshape(h, w) + (1 << shift >> 1)) >> shift


def _autoregress(buf: np.ndarray, coeffs, lag: int, shift: int,
                 luma=None, sh: int = 0):
    """The AR filter over buf[3:, 3:-3] in place: `coeffs` in raster order
    over the rows above and the samples to the left; `luma`, where given,
    the co-located luma grain times the last coefficient."""
    h, w = buf.shape
    rnd = 1 << (shift - 1)
    lo, hi = -(128 << sh), (128 << sh) - 1
    taps = list(zip([(dy, dx) for dy in range(-lag, 1)
                     for dx in range(-lag, lag + 1) if (dy, dx) < (0, 0)],
                    coeffs))
    above = [(dy, dx, c) for (dy, dx), c in taps if dy < 0 and c]
    left = [(dx, c) for (dy, dx), c in taps if dy == 0 and c]
    for y in range(3, h):
        part = np.zeros(w - 6, np.int64)
        for dy, dx, c in above:
            part += c * buf[y + dy, 3 + dx:w - 3 + dx]
        if luma is not None:
            part += luma[y - 3]
        row = buf[y].tolist()
        part = part.tolist()
        for x in range(3, w - 3):
            s = part[x - 3]
            for dx, c in left:
                s += c * row[x + dx]
            v = row[x] + ((s + rnd) >> shift)
            row[x] = lo if v < lo else hi if v > hi else v
        buf[y] = row


def templates(g: SimpleNamespace, seq: SimpleNamespace) -> List:
    """The grain templates of the planes: luma 73 x 82, chroma by its
    subsampling (None where the plane gets no grain)."""
    sh = seq.bit_depth - 8
    shift = 4 - sh + g.grain_scale_shift
    n_luma = 2 * g.ar_lag * (g.ar_lag + 1)
    luma = np.zeros((73, 82), np.int64)
    if g.y_points:
        luma = _gaussian(g.seed, 73, 82, shift)
        _autoregress(luma, g.ar_y, g.ar_lag, g.ar_shift, sh=sh)
    out = [luma if g.y_points else None]
    if seq.mono:
        return out
    ssx, ssy = seq.ssx, seq.ssy
    ch, cw = (38 if ssy else 73), (44 if ssx else 82)
    lum = None
    if g.y_points:
        # each chroma grain sample's co-located luma grain, averaged
        lum = np.zeros((ch - 3, cw - 6), np.int64)
        for i in range(ssy + 1):
            for j in range(ssx + 1):
                lum += luma[3 + i:3 + i + ((ch - 3) << ssy):1 + ssy,
                            3 + j:3 + j + ((cw - 6) << ssx):1 + ssx]
        if ssx + ssy:
            lum = (lum + (1 << (ssx + ssy - 1))) >> (ssx + ssy)
    for seed_x, points, ar in ((0xB524, g.cb_points, g.ar_cb),
                               (0x49D8, g.cr_points, g.ar_cr)):
        if not (points or g.chroma_from_luma):
            out.append(None)
            continue
        buf = _gaussian(g.seed ^ seed_x, ch, cw, shift)
        _autoregress(buf, ar[:n_luma], g.ar_lag, g.ar_shift,
                     None if lum is None else ar[n_luma] * lum, sh)
        out.append(buf)
    return out


def scaling_lut(points, sh: int = 0) -> np.ndarray:
    """The piecewise-linear scaling function of the points: 256 entries,
    or at depth 8 + sh the 256 at every 2^sh-th entry and the ones between
    rounded from their neighbours, (range * n + 2^(sh - 1)) >> sh."""
    lut = np.zeros(256 << sh, np.int64)
    if not points:
        return lut
    lut[:points[0][0] << sh] = points[0][1]
    for (bx, by), (ex, ey) in zip(points, points[1:]):
        dx = ex - bx
        delta = (ey - by) * ((0x10000 + (dx >> 1)) // dx)
        x = np.arange(dx, dtype=np.int64)
        lut[(bx + x) << sh] = by + ((x * delta + 0x8000) >> 16)
    lut[points[-1][0] << sh:] = points[-1][1]
    if sh:
        pad = 1 << sh
        for (bx, _), (ex, _) in zip(points, points[1:]):
            at = np.arange(bx << sh, ex << sh, pad)
            rng = lut[at + pad] - lut[at]
            n = np.arange(1, pad)
            lut[at[:, None] + n] = lut[at][:, None] + (
                (pad >> 1) + rng[:, None] * n >> sh)
    return lut


def _blend(old, new, w_old, w_new, sh):
    return np.clip((old * w_old + new * w_new + 16) >> 5, -(128 << sh),
                   (128 << sh) - 1)


def noise_planes(g: SimpleNamespace, seq: SimpleNamespace, h: int, w: int,
                 tmpl: List) -> List:
    """Each plane's noise image (None where the plane gets no grain): the
    stripes' 32 x 32 blocks at their random offsets, overlapped."""
    sh = seq.bit_depth - 8
    stripes = []
    rows = (h + 1) // 2
    cols = (w + 1) // 2
    for num, y in enumerate(range(0, rows, 16)):
        rng = _Lfsr(g.seed ^ (((num * 37 + 178) & 255) << 8) ^
                    ((num * 173 + 105) & 255))
        offs = [rng.get(8) for _ in range(0, cols, 16)]
        stripes.append(offs)
    out = []
    for p, t in enumerate(tmpl):
        if t is None:
            out.append(None)
            continue
        sx = seq.ssx if p else 0
        sy = seq.ssy if p else 0
        bh, bw = 34 >> sy, 34 >> sx           # a block with its overlap
        step_y, step_x = 32 >> sy, 32 >> sx
        ph, pw = (h + sy) >> sy, (w + sx) >> sx
        n_blocks = len(stripes[0])
        stripe_w = (n_blocks - 1) * step_x + bw
        stripe_list = []
        for offs in stripes:
            st = np.zeros((bh, stripe_w), np.int64)
            for k, rand in enumerate(offs):
                ox = (6 + (rand >> 4)) if sx else (9 + 2 * (rand >> 4))
                oy = (6 + (rand & 15)) if sy else (9 + 2 * (rand & 15))
                blk = t[oy:oy + bh, ox:ox + bw].copy()
                x0 = k * step_x
                if g.overlap and k:
                    if sx:
                        blk[:, 0] = _blend(st[:, x0], blk[:, 0], 23, 22, sh)
                    else:
                        blk[:, 0] = _blend(st[:, x0], blk[:, 0], 27, 17, sh)
                        blk[:, 1] = _blend(st[:, x0 + 1], blk[:, 1], 17, 27,
                                           sh)
                st[:, x0:x0 + bw] = blk
            stripe_list.append(st)
        img = np.zeros((len(stripe_list) * step_y, stripe_w), np.int64)
        for k, st in enumerate(stripe_list):
            top = st[:step_y].copy()
            if g.overlap and k:
                prev = stripe_list[k - 1]
                if sy:
                    top[0] = _blend(prev[step_y], top[0], 23, 22, sh)
                else:
                    top[0] = _blend(prev[step_y], top[0], 27, 17, sh)
                    top[1] = _blend(prev[step_y + 1], top[1], 17, 27, sh)
            img[k * step_y:(k + 1) * step_y] = top
        out.append(img[:ph, :pw])
    return out


def apply_grain(planes, g: SimpleNamespace, seq: SimpleNamespace):
    """The planes (uint8, or uint16 above 8 bits; cropped) with the
    frame's film grain added."""
    h, w = planes[0].shape
    tmpl = templates(g, seq)
    noise = noise_planes(g, seq, h, w, tmpl)
    shift = g.scaling_shift
    sh = seq.bit_depth - 8
    dtype = planes[0].dtype
    lo, hi_y, hi_c = (16 << sh, 235 << sh, (235 if seq.mc == 0 else 240)
                      << sh) if g.clip_restricted else (0,) + (
                          (256 << sh) - 1,) * 2
    y = planes[0].astype(np.int64)
    out = []
    if noise[0] is not None:
        lut = scaling_lut(g.y_points, sh)
        out.append(np.clip(y + ((lut[y] * noise[0] + (1 << shift >> 1))
                                >> shift), lo, hi_y).astype(dtype))
    else:
        out.append(planes[0])
    if seq.mono:
        return out
    sx, sy = seq.ssx, seq.ssy
    ch, cw = planes[1].shape
    luma = y[::1 + sy][:ch]
    if sx:
        nxt = np.concatenate([luma[:, 1:], luma[:, -1:]], 1)
        avg = ((luma + nxt + 1) >> 1)[:, ::2]
    else:
        avg = luma
    avg = avg[:, :cw]
    for p, points, mult, luma_mult, offset in (
            (1, g.cb_points, g.cb_mult, g.cb_luma_mult, g.cb_offset),
            (2, g.cr_points, g.cr_mult, g.cr_luma_mult, g.cr_offset)):
        if noise[p] is None:
            out.append(planes[p])
            continue
        orig = planes[p].astype(np.int64)
        if g.chroma_from_luma:
            merged = avg
            lut = scaling_lut(g.y_points, sh)
        else:
            combined = avg * (luma_mult - 128) + orig * (mult - 128)
            merged = np.clip((combined >> 6) + ((offset - 256) << sh), 0,
                             (256 << sh) - 1)
            lut = scaling_lut(points, sh)
        n = (lut[merged] * noise[p] + (1 << shift >> 1)) >> shift
        out.append(np.clip(orig + n, lo, hi_c).astype(dtype))
    return out
