"""AV1's constrained directional enhancement filter on an intra frame (the
AV1 specification, section 7.15), as dav1d runs it.

The deblocked frame is filtered in 8 x 8 blocks (4 x 4 / 4 x 8 in
subsampled chroma) grouped in 64 x 64 filter blocks: a filter block
whose `cdef_idx` is -1 is left as it is, and so is an 8 x 8 whose four
mi are all skipped. Luma gives each block its direction and variance
(the variance scales the luma primary strength); chroma takes the luma
direction (through the 4:2:2 table) and damping - 1. A tap is available
inside the frame's mi area (MiRows x MiCols), whatever the tile. Every
block reads only the deblocked input, so all blocks of a plane are
filtered at once in numpy, a tap a gather. At 10 and 12 bits (sh = bd -
8) the direction search runs on the samples shifted right by sh, the
strengths shift left by sh and the damping grows by sh, as in dav1d.
"""
from __future__ import annotations

import numpy as np

from . import av1_tables as T

UNAVAILABLE = -(1 << 28)     # below any sample; huge as unsigned
CHUNK = 8192                 # blocks filtered at once (bounds the memory)


def _yx(v):
    """dav1d's offset in a 12-sample stride as (dy, dx)."""
    dy = (v + 6) // 12
    return dy, v - 12 * dy


# DIRS[d][k] = (dy, dx) of direction d's tap k (the spec's
# Cdef_Directions; dav1d's table holds direction d at entry d + 2)
DIRS = tuple(tuple(_yx(T.CDEF_DIRECTIONS[2 * (d + 2) + k]) for k in (0, 1))
             for d in range(8))
PRI_TAPS = np.array(T.CDEF_PRI_TAPS).reshape(2, 2)
SEC_TAPS = np.array(T.CDEF_SEC_TAPS).reshape(2, 2)
UV_DIR = np.array(T.CDEF_UV_DIR).reshape(2, 8)   # [4:2:2][luma direction]
DY = np.array([[DIRS[d][k][0] for d in range(8)] for k in (0, 1)])
DX = np.array([[DIRS[d][k][1] for d in range(8)] for k in (0, 1)])


def _partial_matrix():
    """(64, 8 * 15): pixel (i, j) of an 8 x 8 into each direction's
    partial sums (7.15.2)."""
    m = np.zeros((64, 8, 15))
    for i in range(8):
        for j in range(8):
            for d, at in enumerate((i + j, i + j // 2, i, 3 + i - j // 2,
                                    7 + i - j, 3 - i // 2 + j, j,
                                    i // 2 + j)):
                m[i * 8 + j, d, at] += 1
    return m.reshape(64, 120)


PARTIAL = _partial_matrix()


def direction(blocks):
    """cdef_direction_process of (N, 8, 8) luma blocks: (direction,
    variance) per block."""
    x = blocks.reshape(len(blocks), 64).astype(np.float64) - 128
    part = np.rint(x @ PARTIAL).astype(np.int64).reshape(-1, 8, 15)
    sq = part * part
    div = np.array(T.CDEF_DIV_TABLE, np.int64)
    cost = np.zeros((len(blocks), 8), np.int64)
    for d in (2, 6):
        cost[:, d] = sq[:, d, :8].sum(1) * div[8]
    w = div[1:8]
    for d in (0, 4):
        cost[:, d] = ((sq[:, d, :7] + sq[:, d, 14:7:-1]) * w).sum(1) + \
            sq[:, d, 7] * div[8]
    w = div[[2, 4, 6]]
    for d in (1, 3, 5, 7):
        cost[:, d] = sq[:, d, 3:8].sum(1) * div[8] + \
            ((sq[:, d, :3] + sq[:, d, 10:7:-1]) * w).sum(1)
    best = np.argmax(cost, axis=1)
    n = np.arange(len(blocks))
    var = (cost[n, best] - cost[n, (best + 4) & 7]) >> 10
    return best, var


def _floor_log2(v):
    """FloorLog2 per element (0 where v is 0)."""
    return np.where(v > 0, np.floor(np.log2(np.maximum(v, 1))), 0).astype(
        np.int32)


def _constrain(diff, threshold, shift):
    """constrain() with its damping shift, max(0, damping -
    FloorLog2(threshold)), given: a threshold of 0 gives 0, and so does
    an UNAVAILABLE tap (its |diff| shifted still passes any threshold)."""
    ad = np.abs(diff)
    val = np.minimum(ad, np.maximum(0, threshold - (ad >> shift)))
    return np.where(diff < 0, -val, val)


def cdef(planes, f, seq, skips, cdef_idx, bd=8):
    """The CDEF frame of the deblocked `planes` (padded arrays, the frame
    at their origin) of depth `bd`; `skips` per mi, `cdef_idx` per 64 x
    64. Returns the new planes and counts of the blocks filtered by
    kind."""
    ran = {}
    mi_rows, mi_cols = f.mi_rows, f.mi_cols
    nby, nbx = mi_rows // 2, mi_cols // 2
    sk = skips[:mi_rows, :mi_cols].reshape(nby, 2, nbx, 2).all(axis=(1, 3))
    idx = cdef_idx[np.ix_(np.arange(nby) // 8, np.arange(nbx) // 8)]
    ran["cdef_idx_-1"] = int((idx < 0).sum())
    on = (idx >= 0) & ~sk
    out = [p.copy() for p in planes]
    if not on.any():
        return out, ran
    by, bx = np.nonzero(on)
    k = idx[by, bx]
    ys = 8 * by[:, None, None] + np.arange(8)[None, :, None]
    xs = 8 * bx[:, None, None] + np.arange(8)[None, None, :]
    sh = bd - 8
    ydir, var = direction(planes[0][ys, xs] >> sh)
    ypri = np.array([s[0] for s in f.cdef_y])[k] << sh
    ysec = np.array([s[1] for s in f.cdef_y])[k] << sh
    vstr = np.where(var >> 6, np.minimum(_floor_log2(var >> 6), 12), 0)
    adj = np.where(var > 0, (ypri * (4 + vstr) + 8) >> 4, 0)
    dirs = np.where(ypri == 0, 0, ydir)
    for name, sel in (("cdef_pri", (adj > 0) & (ysec == 0)),
                      ("cdef_sec", (adj == 0) & (ysec > 0)),
                      ("cdef_both", (adj > 0) & (ysec > 0))):
        ran[name] = int(sel.sum())
    jobs = [(0, 0, 0, adj, ysec, f.cdef_damping + sh, dirs)]
    if seq.num_planes > 1:
        upri = np.array([s[0] for s in f.cdef_uv])[k] << sh
        usec = np.array([s[1] for s in f.cdef_uv])[k] << sh
        row = int(seq.ssx and not seq.ssy)
        udirs = np.where(upri == 0, 0, UV_DIR[row][ydir])
        jobs += [(p, seq.ssy, seq.ssx, upri, usec, f.cdef_damping - 1 + sh,
                  udirs) for p in (1, 2)]
    for p, sy, sx, pri, sec, damping, dr in jobs:
        bh, bw = 8 >> sy, 8 >> sx
        ah, aw = (mi_rows * 4) >> sy, (mi_cols * 4) >> sx
        pad = np.full((ah + 4, aw + 4), UNAVAILABLE, np.int32)
        pad[2:2 + ah, 2:2 + aw] = planes[p][:ah, :aw]
        for c in range(0, len(by), CHUNK):
            part = slice(c, c + CHUNK)
            _filter(pad, out[p], by[part], bx[part], bh, bw, pri[part],
                    sec[part], damping, dr[part], sh)
    return out, ran


def _filter(pad, dst, by, bx, bh, bw, pri, sec, damping, dirs, sh=0):
    """cdef_filter of blocks (by, bx) of size bh x bw; `pad` holds the
    plane's available (mi) area with 2 samples of UNAVAILABLE around it,
    taps that are left out: constrain gives them 0, the maximum never
    picks them, nor does the minimum taken unsigned."""
    wp = pad.shape[1]
    flat = pad.ravel()
    ys = bh * by[:, None, None] + np.arange(bh)[None, :, None]
    xs = bw * bx[:, None, None] + np.arange(bw)[None, None, :]
    base = (ys + 2) * wp + xs + 2
    x = flat[base]
    col = lambda v: v[:, None, None].astype(np.int32)  # noqa: E731 (a block)
    pri_b, sec_b = col(pri), col(sec)
    pri_sh = col(np.maximum(0, damping - _floor_log2(pri)))
    sec_sh = col(np.maximum(0, damping - _floor_log2(sec)))
    taps = (pri >> sh) & 1
    total = np.zeros_like(x)
    lo, hi = x.view(np.uint32).copy(), x.copy()
    for k in (0, 1):
        ptap = col(PRI_TAPS[taps, k])
        stap = col(SEC_TAPS[taps, k])
        for sign in (1, -1):
            for off, t, sh, mul in ((0, pri_b, pri_sh, ptap),
                                    (2, sec_b, sec_sh, stap),
                                    (-2, sec_b, sec_sh, stap)):
                d = (dirs + off) & 7
                v = flat[base + sign * col(DY[k][d] * wp + DX[k][d])]
                np.minimum(lo, v.view(np.uint32), out=lo)
                np.maximum(hi, v, out=hi)
                total += mul * _constrain(v - x, t, sh)
    dst[ys, xs] = np.clip(x + ((8 + total - (total < 0)) >> 4),
                          lo.view(np.int32), hi)
