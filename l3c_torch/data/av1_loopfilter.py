"""AV1's deblocking loop filter (the AV1 specification, section 7.14), as
dav1d runs it: per plane every vertical edge, then
every horizontal one, on the 4 x 4 grid inside FrameWidth x FrameHeight.

An edge is a transform block's edge (the tx sizes of the plane, per 4 x
4, as the block walk recorded them); its filter length is the smaller
transform across it (luma 4 / 8 / 14 taps, chroma 4 / 6), its level the
block's (its loop filter deltas, segment feature, reference and mode
deltas: a table by segment, reference and mode, and by set of deltas
where the frame has per-block deltas), or its left or upper
neighbour's where that is 0; a skipped inter block's transform edges
inside it are not filtered; sharpness sets the limits. In a pass the
rows of samples do not interact, and the spec's raster order only sets
the edges' order within a row; but no edge reads or writes a sample
past half its filter size, which both transforms it joins hold, so the
edges of a row touch disjoint samples and every edge of the pass is
filtered at once in numpy, in any order; the horizontal pass is the same
on the transposed plane. At 10 and 12 bits the limits, the flatness
threshold and the narrow filter's signed range scale by 2^(bd - 8).
"""
from __future__ import annotations

import numpy as np

PAD = 8
CHUNK = 1 << 16              # edges filtered at once (bounds the memory)


def _wide_taps(n, n2, log2):
    """The wide filter (7.14.6.4) as a (16, 2n) weight matrix over the
    window p7..p0 q0..q7 (columns 0..15), its outputs p(n-1)..q(n-1)."""
    w = np.zeros((16, 2 * n), np.float64)
    for o, i in enumerate(range(-n, n)):
        for j in range(-n, n + 1):
            k = min(max(i + j, -(n + 1)), n)
            w[8 + k, o] += 2 if abs(j) <= n2 else 1
    return w, 1 << (log2 - 1), log2


WIDE = {16: _wide_taps(6, 1, 4), 8: _wide_taps(3, 0, 3),
        6: _wide_taps(2, 1, 3)}


def levels(f, deltas=((0, 0, 0, 0),)):
    """Filter level by [set of per-block deltas][segment][reference frame
    (0 intra)][mode type (1: a mode with an MV other than global)][plane
    and pass: y vertical, y horizontal, u, v] (7.14.4,
    dav1d_calc_lf_values): the frame's level plus the block's DeltaLF
    (the one for the pass with delta_lf_multi, else the first), clipped,
    then the segment feature and the reference and mode deltas."""
    out = np.zeros((len(deltas), 8, 8, 2, 4), np.int64)
    for k, seg, i in np.ndindex(len(deltas), 8, 4):
        lvl = f.lf_level[i]
        if i >= 2 and not lvl:
            continue                          # chroma off: dav1d's zeros
        lvl = max(0, min(63, lvl + deltas[k][i if f.delta_lf_multi else 0]))
        feat = f.seg_feature[seg][1 + i] if f.seg_enabled else None
        if feat is not None:
            lvl = max(0, min(63, lvl + feat))
        out[k, seg, :, :, i] = lvl
        if f.lf_delta_enabled:
            sh = lvl >> 5
            out[k, seg, 0, :, i] = max(0, min(63, lvl + (
                f.lf_ref_deltas[0] << sh)))
            for ref in range(1, 8):
                for mode in (0, 1):
                    out[k, seg, ref, mode, i] = max(0, min(63, lvl + (
                        f.lf_ref_deltas[ref] << sh) + (
                        f.lf_mode_deltas[mode] << sh)))
    return out


def limits(sharpness):
    """(limit, blimit, thresh) by level."""
    lvl = np.arange(64)
    shift = 2 if sharpness > 4 else 1 if sharpness > 0 else 0
    if sharpness > 0:
        lim = np.clip(lvl >> shift, 1, 9 - sharpness)
    else:
        lim = np.maximum(1, lvl >> shift)
    return lim, 2 * (lvl + 2) + lim, lvl >> 4


def deblock(planes, f, seq, seg_ids, lf_tx, tx_wh, lf_ids=None,
            lf_sets=((0, 0, 0, 0),), inter=None):
    """Filter `planes` (padded int arrays, the frame at their origin) in
    place. `seg_ids`: segment per mi; `lf_tx[p]`: tx size index per 4 x 4
    of plane p; `tx_wh`: (width, height) of each tx size; `lf_ids`, where
    the frame has per-block loop filter deltas: each mi's index into
    `lf_sets`, the sets of deltas; `inter`, of an inter frame, per mi:
    `ref` (the first reference, 0 intra), `mode` (the mode delta's
    index), `skip` (a skipped inter block, whose transform edges inside
    it are not filtered), `bw4` and `bh4` (its block's size). Returns the
    number of rows of samples each filter ran on ("y4", "y8", "y14",
    "uv4", "uv6")."""
    ran = {}
    if not (f.lf_level[0] or f.lf_level[1]):
        return ran
    lvl_tab = levels(f, lf_sets).reshape(-1, 4)
    if lf_ids is not None:
        seg_ids = lf_ids * 8 + seg_ids
    seg_ids = seg_ids * 16
    if inter is not None:
        seg_ids = seg_ids + inter.ref * 2 + inter.mode
    sh = seq.bit_depth - 8
    lut = tuple(v << sh for v in limits(f.lf_sharpness))
    txw = np.array([w for w, _ in tx_wh])
    txh = np.array([h for _, h in tx_wh])
    for p in range(seq.num_planes):
        if p and not f.lf_level[1 + p]:
            continue
        sx = seq.ssx if p else 0
        sy = seq.ssy if p else 0
        n4r = -(-f.height // (4 << sy))
        n4c = -(-f.width // (4 << sx))
        mi_r = (np.arange(n4r) << sy) | sy
        mi_c = (np.arange(n4c) << sx) | sx
        seg = seg_ids[np.ix_(mi_r, mi_c)]
        tx = lf_tx[p][:n4r, :n4c]
        allow = [None, None]
        if inter is not None:
            mi = np.ix_(mi_r, mi_c)
            skip = inter.skip[mi]
            pbw = np.maximum(4, (inter.bw4[mi] * 4) >> sx)
            pbh = np.maximum(4, (inter.bh4[mi] * 4) >> sy)
            allow = [~skip | (4 * np.arange(n4c)[None, :] % pbw == 0),
                     ~skip | (4 * np.arange(n4r)[:, None] % pbh == 0)]
        h, w = planes[p].shape
        work = np.zeros((h + 2 * PAD, w + 2 * PAD), np.int32)
        work[PAD:PAD + h, PAD:PAD + w] = planes[p]
        for pas in (0, 1):
            lvl = lvl_tab[seg, pas if p == 0 else p + 1]
            ok = allow[pas]
            if pas == 0:
                _edges(work, txw[tx], lvl, p == 0, lut, ran, sh, ok)
            else:
                _edges(work.T, txh[tx].T, lvl.T, p == 0, lut, ran, sh,
                       None if ok is None else ok.T)
        planes[p][...] = work[PAD:PAD + h, PAD:PAD + w]
    return ran


def _edges(V, across, lvl, luma, lut, ran, sh=0, allow=None):
    """Every edge between V's columns 4k - 1 and 4k (padded by PAD), the
    grid's transform size across the edge and level per 4 x 4, all at
    once: an edge of filter size s reads and writes only the s / 2
    samples on each side of it, inside the transforms that meet there, so
    the edges of a row touch disjoint samples and their order does not
    matter."""
    n4r, n4c = across.shape
    if n4c < 2:
        return
    cur, prev = across[:, 1:], across[:, :-1]
    x4 = 4 * np.arange(1, n4c)[None, :]
    size = np.minimum(np.minimum(cur, prev), 16 if luma else 8)
    lv = np.where(lvl[:, 1:] == 0, lvl[:, :-1], lvl[:, 1:])
    on = (x4 % cur == 0) & (lv > 0)
    if allow is not None:
        on &= allow[:, 1:]
    code = np.where(size == 8, 8 if luma else 6, size)
    lim, blim, thr = lut
    r4, k = np.nonzero(on)
    for at in range(0, len(r4), CHUNK):
        part = slice(at, at + CHUNK)
        rows = (PAD + 4 * r4[part, None] + np.arange(4)).ravel()
        xs = np.repeat(PAD + 4 * (k[part] + 1), 4)
        c = np.repeat(code[r4[part], k[part]], 4)
        s = np.repeat(size[r4[part], k[part]], 4)
        lv_k = np.repeat(lv[r4[part], k[part]], 4)
        win = V[rows[:, None], xs[:, None] + np.arange(-8, 8)]
        out = _filter(win, c, lim[lv_k], blim[lv_k], thr[lv_k], ran,
                      "y" if luma else "uv", sh)
        for n in (4, 8, 16):
            sel = s == n
            if sel.any():
                cols = np.arange(8 - n // 2, 8 + n // 2)
                V[rows[sel, None], xs[sel, None] - 8 + cols] = \
                    out[sel][:, cols]


def _filter(win, code, lim, blim, thr, ran, tag, sh=0):
    """The filter mask process and the narrow and wide filters (7.14.6)
    on rows of samples p7..p0 q0..q7 of depth 8 + sh (the limits already
    scaled); `ran` counts the rows each filter (`tag` + its taps)
    changed."""
    win = win.astype(np.int64)
    p = [win[:, 7 - j] for j in range(7)]
    q = [win[:, 8 + j] for j in range(7)]
    a = np.abs
    fm = (a(p[1] - p[0]) <= lim) & (a(q[1] - q[0]) <= lim) & \
        (a(p[0] - q[0]) * 2 + (a(p[1] - q[1]) >> 1) <= blim)
    c6 = code >= 6
    c8 = code >= 8
    fm &= ~c6 | ((a(p[2] - p[1]) <= lim) & (a(q[2] - q[1]) <= lim))
    fm &= ~c8 | ((a(p[3] - p[2]) <= lim) & (a(q[3] - q[2]) <= lim))
    one = 1 << sh
    flat = c6 & (a(p[1] - p[0]) <= one) & (a(q[1] - q[0]) <= one) & \
        (a(p[2] - p[0]) <= one) & (a(q[2] - q[0]) <= one)
    flat &= ~c8 | ((a(p[3] - p[0]) <= one) & (a(q[3] - q[0]) <= one))
    flat2 = (code == 16) & flat
    for j in (4, 5, 6):
        flat2 &= (a(p[j] - p[0]) <= one) & (a(q[j] - q[0]) <= one)
    out = win.copy()
    # narrow filter (7.14.6.3)
    nar = fm & ~flat
    if nar.any():
        hev = (a(p[1] - p[0]) > thr) | (a(q[1] - q[0]) > thr)
        mid = 128 << sh
        lo, hi = -mid, mid - 1
        ps1, ps0, qs0, qs1 = p[1] - mid, p[0] - mid, q[0] - mid, q[1] - mid
        f = np.where(hev, np.clip(ps1 - qs1, lo, hi), 0)
        f = np.clip(f + 3 * (qs0 - ps0), lo, hi)
        f1 = np.clip(f + 4, lo, hi) >> 3
        f2 = np.clip(f + 3, lo, hi) >> 3
        f = (f1 + 1) >> 1
        nh = nar & ~hev
        for at, sel, v in ((8, nar, qs0 - f1), (7, nar, ps0 + f2),
                           (9, nh, qs1 - f), (6, nh, ps1 + f)):
            out[:, at] = np.where(sel, np.clip(v, lo, hi) + mid,
                                  out[:, at])
        ran[tag + "4"] = ran.get(tag + "4", 0) + int(nar.sum())
    # wide filters (7.14.6.4): 14 taps, 8 taps (luma), 6 taps (chroma)
    for n, sel in ((16, fm & flat2), (8, fm & flat & ~flat2 & (code >= 8)),
                   (6, fm & flat & (code == 6))):
        if not sel.any():
            continue
        wt, rnd, sh = WIDE[n]
        half = wt.shape[1] // 2
        res = ((win[sel].astype(np.float64) @ wt).astype(np.int64) + rnd) >> sh
        rows = np.nonzero(sel)[0]
        out[rows[:, None], np.arange(8 - half, 8 + half)[None, :]] = res
        key = tag + str(14 if n == 16 else n)
        ran[key] = ran.get(key, 0) + int(sel.sum())
    return out
