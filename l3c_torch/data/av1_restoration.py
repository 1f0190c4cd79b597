"""AV1's loop restoration on an intra frame (the AV1 specification,
section 7.17), as dav1d runs it: the Wiener filter and the self-guided
filter, per restoration unit, on the CDEF frame (with superres, both it
and the deblocked frame upscaled: units and planes of UpscaledWidth).

A plane is filtered in stripes of 64 luma rows (64 >> ss_y in the
plane), the first starting 8 luma rows above the frame. Inside a stripe
the filters read the CDEF frame; the rows above and below it come from
the deblocked frame before CDEF, at most 2 rows past the stripe, and
samples past the plane's edges repeat its last row or column (a unit's
edge reads its neighbour's samples). A stripe lies in one unit row, and
the units split it by columns (the last unit of a row or column takes
up to 1.5 units), so the stripes of a unit column that share a filter
type are filtered at once in numpy with their units' parameters:
Wiener's InterRound0 / 1 (3 / 11, at 12 bits 5 / 9) and its intermediate
clip, the self-guided box sums by cumulative sums (r = 2 on every other
row), rounded to 8 bits for the filter strength at 10 and 12 bits.
"""
from __future__ import annotations

import numpy as np

from . import av1_tables as T
from .av1_obu import RESTORE_NONE, RESTORE_SGRPROJ, RESTORE_WIENER

SGR = np.array(T.SGR_PARAMS).reshape(16, 4)          # r0, r1, s0, s1
X_BY_XPLUS1 = np.array(T.X_BY_XPLUS1, np.int64)
STRIPES = 8                  # stripes filtered at once (bounds the memory)


def units(size, extent):
    """count_units_in_frame."""
    return max((extent + (size >> 1)) // size, 1)


def restore(cdef_planes, pre_planes, f, seq, lr):
    """The restored planes: `cdef_planes` where a unit is RESTORE_NONE.
    `pre_planes`: the deblocked planes before CDEF; `lr[p]`: the units'
    `type`, `wiener` (unit row, unit col, pass, 3) and `sgr` (set, xqd0,
    xqd1)."""
    out = list(cdef_planes)
    for p in range(seq.num_planes):
        if f.lr_type[p] == RESTORE_NONE:
            continue
        sx = seq.ssx if p else 0
        sy = seq.ssy if p else 0
        pw = (f.upscaled_width + sx) >> sx
        ph = (f.height + sy) >> sy
        size = f.lr_unit_size[p]
        u = lr[p]
        if not u.type.any():
            continue
        sh, off = 64 >> sy, 8 >> sy
        n = (ph - 1 + off) // sh + 1
        start = np.arange(n) * sh - off
        urow = np.minimum(u.type.shape[0] - 1, (np.arange(n) * sh) // size)
        n_c = u.type.shape[1]
        cols = [(c * size, pw if c == n_c - 1 else (c + 1) * size)
                for c in range(n_c)]
        plane = cdef_planes[p].copy()
        for k0 in range(0, n, STRIPES):
            g = np.arange(k0, min(n, k0 + STRIPES))
            src = _stripes(cdef_planes[p], pre_planes[p], start[g], sh, pw,
                           ph)
            for uc, (c0, c1) in enumerate(cols):
                typ = u.type[urow[g], uc]
                for kind, fn, par in ((RESTORE_WIENER, _wiener, u.wiener),
                                      (RESTORE_SGRPROJ, _self_guided,
                                       u.sgr)):
                    sel = np.nonzero(typ == kind)[0]
                    if not len(sel):
                        continue
                    res = fn(src[sel, :, c0:c1 + 6], par[urow[g[sel]], uc],
                             sh, c1 - c0, seq.bit_depth)
                    for k, r in zip(g[sel], res):
                        y0, y1 = max(0, start[k]), min(ph, start[k] + sh)
                        plane[y0:y1, c0:c1] = r[y0 - start[k]:y1 - start[k]]
        out[p] = plane
    return out


def _stripes(cdef, pre, start, sh, pw, ph):
    """(n, sh + 6, pw + 6): each stripe's samples as get_source_sample
    reads them, 3 rows and columns around it."""
    y = start[:, None] + np.arange(-3, sh + 3)[None, :]
    end = (start + sh - 1)[:, None]
    st = start[:, None]
    yc = np.clip(y, 0, ph - 1)
    above, below = yc < st, yc > end
    yc = np.where(above, np.maximum(st - 2, yc), yc)
    yc = np.where(below, np.minimum(end + 2, yc), yc)
    xc = np.clip(np.arange(-3, pw + 3), 0, pw - 1)
    a = cdef[yc[..., None], xc[None, None, :]]
    b = pre[yc[..., None], xc[None, None, :]]
    return np.where((above | below)[..., None], b, a).astype(np.int64)


def _wiener(src, coef, sh, w, bd=8):
    """wiener_filter (7.17.4) of stripes of one unit column (coef: (n,
    pass, 3) per stripe): vertical taps from pass 0, horizontal from pass
    1, each symmetric around 128 - 2 * their sum; the horizontal sums
    rounded by r0 bits and clipped to bd + 8 - r0 bits, offset by their
    2^(bd + 6 - r0) bias, the vertical ones rounded by r1."""
    def taps(c):
        c = c[:, None, None, :]
        mid = 128 - 2 * c.sum(-1)
        return (c[..., 0], c[..., 1], c[..., 2], mid, c[..., 2], c[..., 1],
                c[..., 0])
    hf = taps(coef[:, 1])
    vf = taps(coef[:, 0])
    acc = np.zeros((src.shape[0], sh + 6, w), np.int64)
    for t in range(7):
        acc += hf[t] * src[:, :, t:t + w]
    r0, r1 = (5, 9) if bd == 12 else (3, 11)
    off = 1 << (bd + 6 - r0)
    inter = np.clip((acc + (1 << (r0 - 1))) >> r0, -off,
                    (1 << (bd + 8 - r0)) - 1 - off)
    acc = np.zeros((src.shape[0], sh, w), np.int64)
    for t in range(7):
        acc += vf[t] * inter[:, t:t + sh, :]
    return np.clip((acc + (1 << (r1 - 1))) >> r1, 0, (1 << bd) - 1)


def _box(src, r):
    """Sums of the (2r + 1)^2 boxes and of their squares, centred on rows
    -1 .. sh and columns -1 .. w of the stripe (src's 2 .. end - 2)."""
    n, hh, ww = src.shape
    out = []
    for v in (src, src * src):
        c = np.zeros((n, hh + 1, ww + 1), np.int64)
        c[:, 1:, 1:] = v.cumsum(1).cumsum(2)
        y0 = np.arange(2, hh - 2) - r
        x0 = np.arange(2, ww - 2) - r
        y1, x1 = y0 + 2 * r + 1, x0 + 2 * r + 1
        out.append(c[:, y1][:, :, x1] - c[:, y0][:, :, x1] -
                   c[:, y1][:, :, x0] + c[:, y0][:, :, x0])
    return out


def _box_filter(src, r, s, sh, w, bd=8):
    """box_filter (7.17.3) of radius r and scale s (per stripe) over
    stripes of one unit column: the filtered stripes (n, sh, w)."""
    b, a = _box(src, r)
    nn = (2 * r + 1) ** 2
    d = bd - 8
    a8 = (a + ((1 << (2 * d)) >> 1)) >> (2 * d)
    b8 = (b + ((1 << d) >> 1)) >> d
    p = np.maximum(0, a8 * nn - b8 * b8)
    z = (p * s[:, None, None] + (1 << 19)) >> 20
    A = X_BY_XPLUS1[np.clip(z, 0, 255)]
    B = ((256 - A) * b * T.ONE_BY_X[nn - 1] + (1 << 11)) >> 12
    u = src[:, 3:3 + sh, 3:3 + w]
    # A, B at rows i = -1 .. sh (index i + 1), columns j = -1 .. w
    if r == 1:
        return (_cross(A, sh, w) * u + _cross(B, sh, w) + (1 << 8)) >> 9
    # r = 2: A and B on odd rows only; an even row weighs the odd rows
    # above and below it, an odd row its own
    even = np.arange(sh) % 2 == 0
    out = []
    for M in (A, B):
        row = 6 * M[:, :, 1:w + 1] + 5 * (M[:, :, :w] + M[:, :, 2:])
        acc = row[:, 1:sh + 1].copy()
        acc[:, even] = row[:, :sh][:, even] + row[:, 2:][:, even]
        out.append(acc)
    shift = np.where(even, 9, 8)[None, :, None]
    return (out[0] * u + out[1] + (1 << (shift - 1))) >> shift


def _cross(M, sh, w):
    """4 x the centre and its four neighbours, 3 x the diagonals."""
    mid, cen = slice(1, sh + 1), slice(1, w + 1)
    cross = M[:, mid, cen] + M[:, :sh, cen] + M[:, 2:, cen] + \
        M[:, mid, :w] + M[:, mid, 2:]
    diag = M[:, :sh, :w] + M[:, :sh, 2:] + M[:, 2:, :w] + M[:, 2:, 2:]
    return 4 * cross + 3 * diag


def _self_guided(src, sgr, sh, w, bd=8):
    """self_guided_filter (7.17.3) of stripes of one unit column (sgr:
    (n, 3) set, xqd0, xqd1 per stripe): the set's two box filters (a
    radius of 0 leaves its pass out) projected with the xqd."""
    st = sgr[:, 0]
    w0 = sgr[:, 1, None, None]
    w1 = sgr[:, 2, None, None]
    u = src[:, 3:3 + sh, 3:3 + w] << 4
    v = w1 * u
    for r, wt, scale, radius in ((2, w0, SGR[st, 2], SGR[st, 0]),
                                 (1, 128 - w0 - w1, SGR[st, 3],
                                  SGR[st, 1])):
        flt = u
        on = radius > 0
        if on.any():
            flt = u.copy()
            flt[on] = _box_filter(src[on], r, scale[on], sh, w, bd)
        v = v + wt * flt
    return np.clip((v + (1 << 10)) >> 11, 0, (1 << bd) - 1)
