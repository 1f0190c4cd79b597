"""AV1's inter prediction (the AV1 specification, section 7.11.3, as dav1d
1.5 rounds it), a block at a time in numpy: motion vector scaling (a
reference of another size, as superres makes one, is predicted scaled),
the 8-tap subpel filters (regular, smooth, sharp, their 4-tap forms at
widths and heights of 4 or less, bilinear) with the reference's edges
extended, at the rounding of 8, 10 and 12 bits (InterRound0 /
InterRound1 and the compound intermediate); warped prediction (local
warp's least-squares fit from its samples, setup_shear's validity, and
global motion) an 8 x 8 at a time; the compound average, distance
weights, wedge and difference-weighted masks; inter-intra's smooth and
wedge masks; OBMC's blend of the above and left neighbours' predictions.

The filters and masks are the library's tables (data/av1_tables.py):
dav1d's halved subpel taps, doubled here to the specification's, its
warp filter and OBMC masks, aom's wedge master lines and codebooks,
inter-intra weights, distance weights and division LUT.
"""
from __future__ import annotations

import numpy as np

from . import av1_tables as T

EIGHTTAP, EIGHTTAP_SMOOTH, EIGHTTAP_SHARP, BILINEAR = 0, 1, 2, 3
COMPOUND_WEDGE, COMPOUND_DIFFWTD, COMPOUND_AVERAGE = 0, 1, 2
COMPOUND_INTRA, COMPOUND_DISTANCE = 3, 4
WARPEDMODEL_PREC_BITS = 16


def _filters():
    """The specification's Subpel_Filters[6][16][8] (regular, smooth,
    sharp, bilinear, 4-tap regular, 4-tap smooth) from dav1d's halved
    table (regular, smooth, sharp, 4-tap regular, 4-tap smooth,
    bilinear; phases 1-15)."""
    d = np.array(T.MC_SUBPEL_FILTERS, np.int64).reshape(6, 15, 8) * 2
    out = np.zeros((6, 16, 8), np.int64)
    out[:, 0, 3] = 128
    for spec, dav in enumerate((0, 1, 2, 5, 3, 4)):
        out[spec, 1:] = d[dav]
    return out


FILTERS = _filters()
WARP_FILTER = np.array(T.MC_WARP_FILTER, np.int64).reshape(193, 8)


def rounding(bd: int, compound: bool):
    """(InterRound0, InterRound1, InterPostRound)."""
    r0 = 5 if bd == 12 else 3
    r1 = 7 if compound else (9 if bd == 12 else 11)
    return r0, r1, 14 - r0 - r1


def _round2(x, n):
    return (x + (1 << (n - 1))) >> n if n else x


def _round2signed(x, n):
    return (x + (1 << (n - 1))) >> n if x >= 0 else \
        -((-x + (1 << (n - 1))) >> n)


def scale_of(ref_w, ref_h, frame_w, frame_h):
    """(xScale, yScale) of a reference of ref_w x ref_h (its upscaled
    width) for a frame coded at frame_w x frame_h."""
    return (((ref_w << 14) + (frame_w // 2)) // frame_w,
            ((ref_h << 14) + (frame_h // 2)) // frame_h)


def predict(ref, x, y, w, h, mv, sx, sy, scale, ref_wh, filt, bd, comp):
    """block_inter_prediction after motion_vector_scaling: the w x h
    prediction at plane position (x, y) from the reference plane `ref`
    (its frame's upscaled width and height `ref_wh`, in luma samples) by
    mv (row, col in 1/8 luma pixel), with interpolation filters `filt`
    (vertical, horizontal); pixels, or the compound intermediate."""
    xs, ys = scale
    ox = (x << 4) + ((2 * mv[1]) >> sx) + 8
    oy = (y << 4) + ((2 * mv[0]) >> sy) + 8
    start_x = _round2signed(ox * xs - (8 << 14), 8) + 32
    start_y = _round2signed(oy * ys - (8 << 14), 8) + 32
    step_x = _round2signed(xs, 4)
    step_y = _round2signed(ys, 4)
    last_x = ((ref_wh[0] + sx) >> sx) - 1
    last_y = ((ref_wh[1] + sy) >> sy) - 1
    r0, r1, _ = rounding(bd, comp)
    fy, fx = filt
    if w <= 4:
        fx = 4 if fx in (EIGHTTAP, EIGHTTAP_SHARP) else \
            5 if fx == EIGHTTAP_SMOOTH else fx
    if h <= 4:
        fy = 4 if fy in (EIGHTTAP, EIGHTTAP_SHARP) else \
            5 if fy == EIGHTTAP_SMOOTH else fy
    ih = (((h - 1) * step_y + (1 << 10) - 1) >> 10) + 8
    px = start_x + step_x * np.arange(w)
    cols = np.clip((px >> 10)[:, None] + np.arange(-3, 5)[None, :], 0,
                   last_x)
    rows = np.clip((start_y >> 10) + np.arange(ih) - 3, 0, last_y)
    taps = FILTERS[fx][(px >> 6) & 15]                      # (w, 8)
    src = ref[rows[:, None, None], cols[None, :, :]].astype(np.int64)
    mid = _round2((src * taps[None]).sum(-1), r0)           # (ih, w)
    py = (start_y & 1023) + step_y * np.arange(h)
    vt = FILTERS[fy][(py >> 6) & 15]                        # (h, 8)
    idx = (py >> 10)[:, None] + np.arange(8)[None, :]       # (h, 8)
    out = _round2((mid[idx] * vt[:, :, None]).sum(1), r1)
    if not comp:
        out = np.clip(out, 0, (1 << bd) - 1)
    return out


# ------------------------------------------------------------------ warp

def resolve_divisor(d):
    """(shift, divisor factor) of d > 0 through the division LUT."""
    n = d.bit_length() - 1
    e = d - (1 << n)
    if n > 8:
        f = (e + (1 << (n - 9))) >> (n - 8)
    else:
        f = e << (8 - n)
    return n + 14, T.DIV_LUT[f]


def setup_shear(p):
    """(valid, alpha, beta, gamma, delta) of warp parameters p."""
    if p[2] <= 0:
        return False, 0, 0, 0, 0
    alpha0 = max(-32768, min(32767, p[2] - (1 << 16)))
    beta0 = max(-32768, min(32767, p[3]))
    shift, div = resolve_divisor(p[2])
    v = (p[4] << 16) * div
    gamma0 = max(-32768, min(32767, _round2signed(v, shift)))
    w = p[3] * p[4] * div
    delta0 = max(-32768, min(32767, p[5] - _round2signed(w, shift) -
                             (1 << 16)))
    a, b, g, d = (_round2signed(v, 6) << 6 for v in (alpha0, beta0, gamma0,
                                                      delta0))
    valid = 4 * abs(a) + 7 * abs(b) < (1 << 16) and \
        4 * abs(g) + 4 * abs(d) < (1 << 16)
    return valid, a, b, g, d


def warp_estimate(samples, r, c, bw4, bh4, mv):
    """warp_estimation: the local warp parameters fitted to the samples
    (None where the fit's determinant is 0)."""
    a00 = a01 = a11 = bx0 = bx1 = by0 = by1 = 0
    mid_y = r * 4 + bh4 * 2 - 1
    mid_x = c * 4 + bw4 * 2 - 1
    suy, sux = mid_y * 8, mid_x * 8
    duy, dux = suy + mv[0], sux + mv[1]

    def ls(a, b):
        return ((a * b) >> 2) + (a + b)
    for s in samples:
        sy, sx = s[0] - suy, s[1] - sux
        dy, dx = s[2] - duy, s[3] - dux
        if abs(sx - dx) < 256 and abs(sy - dy) < 256:
            a00 += ls(sx, sx) + 8
            a01 += ls(sx, sy) + 4
            a11 += ls(sy, sy) + 8
            bx0 += ls(sx, dx) + 8
            bx1 += ls(sy, dx) + 4
            by0 += ls(sx, dy) + 4
            by1 += ls(sy, dy) + 8
    det = a00 * a11 - a01 * a01
    if det == 0:
        return None
    shift, div = resolve_divisor(abs(det))
    if det < 0:
        div = -div
    shift -= 16
    if shift < 0:
        div <<= -shift
        shift = 0

    def solve(v, lo, hi):
        return max(lo, min(hi, _round2signed(v * div, shift)))
    diag = ((1 << 16) - (1 << 13) + 1, (1 << 16) + (1 << 13) - 1)
    nond = (-(1 << 13) + 1, (1 << 13) - 1)
    p = [0] * 6
    p[2] = solve(a11 * bx0 - a01 * bx1, *diag)
    p[3] = solve(-a01 * bx0 + a00 * bx1, *nond)
    p[4] = solve(a11 * by0 - a01 * by1, *nond)
    p[5] = solve(-a01 * by0 + a00 * by1, *diag)
    vx = mv[1] * (1 << 13) - (mid_x * (p[2] - (1 << 16)) + mid_y * p[3])
    vy = mv[0] * (1 << 13) - (mid_x * p[4] + mid_y * (p[5] - (1 << 16)))
    p[0] = max(-(1 << 23), min((1 << 23) - 1, vx))
    p[1] = max(-(1 << 23), min((1 << 23) - 1, vy))
    return p


def warp(ref, x, y, w, h, p, shear, sx, sy, ref_wh, bd, comp):
    """block_warp over the w x h block at plane position (x, y), an 8 x 8
    at a time, with dav1d's rounding of the filter positions."""
    _, alpha, beta, gamma, delta = shear
    last_x = ((ref_wh[0] + sx) >> sx) - 1
    last_y = ((ref_wh[1] + sy) >> sy) - 1
    r0, r1, _ = rounding(bd, comp)
    out = np.zeros((h, w), np.int64)
    k8 = np.arange(8)
    for i8 in range(0, h, 8):
        for j8 in range(0, w, 8):
            src_x = (x + j8 + 4) << sx
            src_y = (y + i8 + 4) << sy
            dst_x = p[2] * src_x + p[3] * src_y + p[0]
            dst_y = p[4] * src_x + p[5] * src_y + p[1]
            x4, y4 = dst_x >> sx, dst_y >> sy
            ix4, iy4 = x4 >> 16, y4 >> 16
            mx = ((x4 & 0xFFFF) - alpha * 4 - beta * 7) & ~0x3F
            my = ((y4 & 0xFFFF) - gamma * 4 - delta * 4) & ~0x3F
            rows = np.clip(iy4 - 7 + np.arange(15), 0, last_y)
            cols = np.clip(ix4 - 7 + np.arange(15), 0, last_x)
            blk = ref[rows[:, None], cols[None, :]].astype(np.int64)
            # horizontal: row k (0-14), output column l (0-7)
            tmx = mx + beta * np.arange(15)[:, None] + alpha * k8[None, :]
            offs = 64 + ((tmx + 512) >> 10)                 # (15, 8)
            taps = WARP_FILTER[offs]                         # (15, 8, 8)
            win = blk[:, k8[:, None] + k8[None, :]]          # (15, 8, 8)
            mid = _round2((win * taps).sum(-1), r0)          # (15, 8)
            tmy = my + delta * k8[:, None] + gamma * k8[None, :]
            vt = WARP_FILTER[64 + ((tmy + 512) >> 10)]       # (8, 8, 8)
            col = mid[k8[:, None] + k8[None, :]]             # (8 y, 8 t, 8 x)
            res = _round2((col.transpose(0, 2, 1) * vt).sum(-1), r1)
            hh, ww = min(8, h - i8), min(8, w - j8)
            out[i8:i8 + hh, j8:j8 + ww] = res[:hh, :ww]
    if not comp:
        out = np.clip(out, 0, (1 << bd) - 1)
    return out


# ----------------------------------------------------------------- masks

def _master():
    """aom's wedge masters, 64 x 64 each: horizontal, vertical, oblique
    27, 63, 117, 153."""
    odd = np.array(T.WEDGE_MASTER[:64], np.int64)
    even = np.array(T.WEDGE_MASTER[64:], np.int64)
    vert = np.array(T.WEDGE_MASTER_VERTICAL, np.int64)
    m = np.zeros((6, 64, 64), np.int64)
    j = np.arange(64)
    shift = 16
    for i in range(0, 64, 2):
        m[3, i] = even[np.clip(j - shift, 0, 63)]
        shift -= 1
        m[3, i + 1] = odd[np.clip(j - shift, 0, 63)]
        m[1, i] = m[1, i + 1] = vert
    m[2] = m[3].T
    m[4] = (64 - m[3])[:, ::-1]
    m[5] = (64 - m[3]).T[::-1, :]
    m[0] = m[1].T
    return m


_MASTER = []
_WEDGE = {}


def wedge_mask(bw, bh, sign, index):
    """WedgeMasks[bsize][sign][index]: the (bh, bw) wedge mask."""
    key = (bw, bh)
    if key not in _WEDGE:
        if not _MASTER:
            _MASTER.append(_master())
        m = _MASTER[0]
        book = np.array(T.WEDGE_CODEBOOK, np.int64).reshape(3, 16, 3)
        cb = book[1 if bh > bw else 0 if bh < bw else 2]
        masks = []
        for n in range(16):
            d, xo, yo = cb[n]
            xoff = 32 - ((xo * bw) >> 3)
            yoff = 32 - ((yo * bh) >> 3)
            s = int(m[d, yoff, xoff:xoff + bw].sum() +
                    m[d, yoff + 1:yoff + bh, xoff].sum())
            avg = (s + (bw + bh - 1) // 2) // (bw + bh - 1)
            flip = int(avg < 32)
            mk = m[d, yoff:yoff + bh, xoff:xoff + bw]
            masks.append((mk, flip))
        _WEDGE[key] = masks
    mk, flip = _WEDGE[key][index]
    return mk if sign == flip else 64 - mk


def ii_mask(mode, w, h):
    """The smooth inter-intra mask (the intra prediction's weight) of a
    w x h plane block."""
    scale = 128 // max(w, h)
    wts = np.array(T.II_WEIGHTS_1D, np.int64)
    i = np.arange(h)[:, None]
    j = np.arange(w)[None, :]
    if mode == 1:                                     # II_V_PRED
        return np.broadcast_to(wts[i * scale], (h, w))
    if mode == 2:                                     # II_H_PRED
        return np.broadcast_to(wts[j * scale], (h, w))
    if mode == 3:                                     # II_SMOOTH_PRED
        return wts[np.minimum(i, j) * scale]
    return np.full((h, w), 32, np.int64)


def diff_mask(p0, p1, mask_type, bd, post):
    """The difference-weighted mask of two compound predictions."""
    diff = _round2(np.abs(p0 - p1), (bd - 8) + post)
    m = np.clip(38 + diff // 16, 0, 64)
    return 64 - m if mask_type else m


def subsample(mask, sx, sy):
    """A luma mask at a chroma plane's sampling."""
    if sx and sy:
        return _round2(mask[0::2, 0::2] + mask[0::2, 1::2] +
                       mask[1::2, 0::2] + mask[1::2, 1::2], 2)
    if sx:
        return _round2(mask[:, 0::2] + mask[:, 1::2], 1)
    return mask


def distance_weights(s, f, refs):
    """(FwdWeight, BckWeight) of a distance-weighted compound."""
    from .av1_obu import get_relative_dist
    qw = np.array(T.QUANT_DIST[:8]).reshape(4, 2)
    ql = np.array(T.QUANT_DIST[8:]).reshape(4, 2)
    dist = [max(0, min(31, abs(get_relative_dist(
        s, f.order_hints[r], f.order_hint)))) for r in refs]
    d0, d1 = dist[1], dist[0]
    order = int(d0 <= d1)
    if d0 == 0 or d1 == 0:
        return int(ql[3][order]), int(ql[3][1 - order])
    i = 0
    while i < 3:
        c0, c1 = qw[i][order], qw[i][1 - order]
        if order and d0 * c0 > d1 * c1:
            break
        if not order and d0 * c0 < d1 * c1:
            break
        i += 1
    return int(ql[i][order]), int(ql[i][1 - order])


def obmc_blend(cur, nb, above):
    """OBMC: the neighbour's prediction blended into the first rows (or
    columns) of the block's with dav1d's masks (the neighbour's weight)."""
    if above:
        n = nb.shape[0]
        m = np.array(T.OBMC_MASKS[n:2 * n], np.int64)[:, None]
    else:
        n = nb.shape[1]
        m = np.array(T.OBMC_MASKS[n:2 * n], np.int64)[None, :]
    return (cur * (64 - m) + nb * m + 32) >> 6
