"""AV1's motion vector prediction (the AV1 specification, sections 7.9,
7.10.2 and 7.10.4, as libaom and dav1d 1.5 compute it): the stack of
reference MVs of a block from its spatial neighbours, the temporal
candidates of the projected motion field and the extra search, sorted,
clamped and with the mode contexts they give; global motion's candidate;
the motion field a frame keeps for later frames and its projection into
the current frame; and the samples a locally warped block fits its model
to.

The functions take the frame decoder of data/av1_block.py: its per-4x4
lists `ref_frames` ((ref 0, ref 1), -1 for none, 0 intra), `mvs` (two
(row, col) MVs in 1/8 pixel), `is_inter`, `y_mode`, `mi_size`, `written`,
its tile bounds (`inside`), the frame header `f` and, where the frame
uses reference MVs, the projected field `tpl`. Intra block copy's DVs
are the case of an intra frame: an intrabc block refers to the intra
frame and has its DV as MV 0.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from . import av1_tables as T
from .av1_obu import IDENTITY, TRANSLATION, get_relative_dist

REF_CAT_LEVEL = 640
MAX_STACK = 8
MV_BORDER = 128                     # 16 pixels, in 1/8
REFMVS_LIMIT = (1 << 12) - 1
MAX_FRAME_DISTANCE = 31
NEARESTMV, NEARMV, GLOBALMV, NEWMV = 13, 14, 15, 16
NEAREST_NEARESTMV, NEAR_NEARMV, NEAREST_NEWMV, NEW_NEARESTMV = 17, 18, 19, 20
NEAR_NEWMV, NEW_NEARMV, GLOBAL_GLOBALMV, NEW_NEWMV = 21, 22, 23, 24
HAS_NEWMV = frozenset((NEWMV, NEW_NEWMV, NEAR_NEWMV, NEW_NEARMV,
                       NEAREST_NEWMV, NEW_NEARESTMV))
ZERO = (0, 0)


def lower_precision(f, mv):
    """lower_mv_precision: to the frame's MV precision."""
    if f.allow_high_precision_mv:
        return mv
    out = []
    for v in mv:
        if f.force_integer_mv:
            a = (abs(v) + 3) >> 3
            v = a << 3 if v > 0 else -(a << 3)
        elif v & 1:
            v += -1 if v > 0 else 1
        out.append(v)
    return tuple(out)


def _round2signed(x, n):
    return (x + (1 << (n - 1))) >> n if x >= 0 else \
        -((-x + (1 << (n - 1))) >> n)


def global_mv(d, b, ref, wh):
    """setup_global_mv: the MV global motion gives the block's centre."""
    f = d.f
    if ref <= 0 or f.gm_type[ref] == IDENTITY:
        return ZERO
    p = f.gm_params[ref]
    if f.gm_type[ref] == TRANSLATION:
        mv = (p[0] >> 13, p[1] >> 13)
    else:
        bw, bh = wh[b.size][0] * 4, wh[b.size][1] * 4
        x = b.c * 4 + bw // 2 - 1
        y = b.r * 4 + bh // 2 - 1
        xc = (p[2] - (1 << 16)) * x + p[3] * y + p[0]
        yc = p[4] * x + (p[5] - (1 << 16)) * y + p[1]
        if f.allow_high_precision_mv:
            mv = (_round2signed(yc, 13), _round2signed(xc, 13))
        else:
            mv = (_round2signed(yc, 14) * 2, _round2signed(xc, 14) * 2)
    return lower_precision(f, mv)


class _Stack:
    __slots__ = ("mvs", "weights", "new", "found", "refs", "gmv", "comp")

    def __init__(self, refs, gmv, comp):
        self.mvs, self.weights = [], []
        self.new = self.found = 0
        self.refs, self.gmv, self.comp = refs, gmv, comp

    def add(self, cand, weight):
        for i, v in enumerate(self.mvs):
            if v == cand:
                self.weights[i] += weight
                return
        if len(self.mvs) < MAX_STACK:
            self.mvs.append(cand)
            self.weights.append(weight)


def _candidate(d, st, row, col, weight, wh):
    """add_ref_mv_candidate: a neighbour with the block's reference(s)."""
    if not d.is_inter[row][col]:
        return
    rf = d.ref_frames[row][col]
    f = d.f
    mode = d.y_mode[row][col]
    cw, ch = wh[d.mi_size[row][col]]
    is_global = mode in (GLOBALMV, GLOBAL_GLOBALMV) and min(cw, ch) >= 2
    mvs = d.mvs[row][col]
    if not st.comp:
        for k in (0, 1):
            if rf[k] == st.refs[0]:
                if is_global and f.gm_type[st.refs[0]] > TRANSLATION:
                    mv = st.gmv[0]
                else:
                    mv = lower_precision(f, mvs[k])
                st.add((mv, ZERO), weight)
                st.new += mode in HAS_NEWMV
                st.found = 1
    elif rf == st.refs:
        pair = tuple(st.gmv[k] if is_global and
                     f.gm_type[st.refs[k]] > TRANSLATION else
                     lower_precision(f, mvs[k]) for k in (0, 1))
        st.add(pair, weight)
        st.new += mode in HAS_NEWMV
        st.found = 1


def _scan_row(d, b, st, delta_row, wh):
    bw4 = wh[b.size][0]
    end4 = min(bw4, d.mi_cols - b.c, 16)
    delta_col = 0
    if abs(delta_row) > 1:
        delta_row += b.r & 1
        delta_col = 1 - (b.c & 1)
    i = 0
    while i < end4:
        row, col = b.r + delta_row, b.c + delta_col + i
        if not d.inside(row, col):
            break
        n = min(bw4, wh[d.mi_size[row][col]][0])
        if abs(delta_row) > 1:
            n = max(2, n)
        if bw4 >= 16:
            n = max(4, n)
        _candidate(d, st, row, col, 2 * n, wh)
        i += n


def _scan_col(d, b, st, delta_col, wh):
    bh4 = wh[b.size][1]
    end4 = min(bh4, d.mi_rows - b.r, 16)
    delta_row = 0
    if abs(delta_col) > 1:
        delta_row = 1 - (b.r & 1)
        delta_col += b.c & 1
    i = 0
    while i < end4:
        row, col = b.r + delta_row + i, b.c + delta_col
        if not d.inside(row, col):
            break
        n = min(bh4, wh[d.mi_size[row][col]][1])
        if abs(delta_col) > 1:
            n = max(2, n)
        if bh4 >= 16:
            n = max(4, n)
        _candidate(d, st, row, col, 2 * n, wh)
        i += n


def _scan_point(d, b, st, delta_row, delta_col, wh):
    row, col = b.r + delta_row, b.c + delta_col
    if d.inside(row, col) and d.written[row][col]:
        _candidate(d, st, row, col, 4, wh)


def mv_projection(mv, num, den):
    """get_mv_projection: mv scaled by num / den frame distances."""
    den = min(den, MAX_FRAME_DISTANCE)
    num = max(-MAX_FRAME_DISTANCE, min(MAX_FRAME_DISTANCE, num))
    m = T.DIV_MULT[den]
    out = []
    for v in mv:
        p = v * num * m
        p = (p + 8192) >> 14 if p >= 0 else -((-p + 8192) >> 14)
        out.append(max(-(1 << 14) + 1, min((1 << 14) - 1, p)))
    return tuple(out)


def _temporal(d, b, st, delta_row, delta_col, first):
    """add_tpl_ref_mv: the projected field's MV at an 8 x 8 near the
    block, for the block's reference(s); at the block's own position it
    sets the zero-MV context (1 unless present and near global motion)."""
    row = b.r + delta_row if b.r & 1 else b.r + delta_row + 1
    col = b.c + delta_col if b.c & 1 else b.c + delta_col + 1
    if not d.inside(row, col):
        return 1 if first else None
    cand = d.tpl[row >> 1][col >> 1]
    if cand is None:
        return 1 if first else None
    mv, off = cand
    f = d.f
    got = []
    for ref in st.refs[:1 + st.comp]:
        cur = get_relative_dist(d.s, f.order_hint, f.order_hints[ref])
        got.append(lower_precision(f, mv_projection(mv, cur, off)))
    zero = None
    if first:
        zero = int(any(abs(g[k] - st.gmv[i][k]) >= 16
                       for i, g in enumerate(got) for k in (0, 1)))
    st.add((got[0], got[1] if st.comp else ZERO), 2)
    return zero


def _sort(st, start, end):
    w, m = st.weights, st.mvs
    while end > start:
        new_end = start
        for i in range(start + 1, end):
            if w[i - 1] < w[i]:
                w[i - 1], w[i] = w[i], w[i - 1]
                m[i - 1], m[i] = m[i], m[i - 1]
                new_end = i
        end = new_end


def _extra_search(d, b, st, wh):
    """The extra search of a stack with fewer than two entries: the
    neighbours' MVs of any reference (sign-corrected), then global
    motion."""
    f = d.f
    bw4, bh4 = wh[b.size]
    w4 = min(16, bw4, d.mi_cols - b.c)
    h4 = min(16, bh4, d.mi_rows - b.r)
    num4 = min(w4, h4)
    ids = [[], []]
    diffs = [[], []]
    for pas in (0, 1):
        if len(st.mvs) >= 2:
            break
        idx = 0
        while idx < num4 and len(st.mvs) < 2:
            row, col = (b.r - 1, b.c + idx) if pas == 0 else \
                (b.r + idx, b.c - 1)
            if not d.inside(row, col):
                break
            rf = d.ref_frames[row][col]
            mvs = d.mvs[row][col]
            for k in (0, 1):
                cr = rf[k]
                if cr <= 0:
                    continue
                mv = mvs[k]
                if st.comp:
                    for lst in (0, 1):
                        if cr == st.refs[lst] and len(ids[lst]) < 2:
                            ids[lst].append(mv)
                        elif len(diffs[lst]) < 2:
                            if f.sign_bias[cr] != f.sign_bias[st.refs[lst]]:
                                mv = (-mv[0], -mv[1])
                            diffs[lst].append(mv)
                else:
                    if f.sign_bias[cr] != f.sign_bias[st.refs[0]]:
                        mv = (-mv[0], -mv[1])
                    if all(v[0] != mv for v in st.mvs):
                        st.mvs.append((mv, ZERO))
                        st.weights.append(2)
            idx += wh[d.mi_size[row][col]][pas]
    if st.comp:
        comb = [[], []]
        for lst in (0, 1):
            c = ids[lst] + diffs[lst]
            comb[lst] = (c + [st.gmv[lst]] * 2)[:2]
        pairs = [(comb[0][0], comb[1][0]), (comb[0][1], comb[1][1])]
        if len(st.mvs) == 1:
            st.mvs.append(pairs[1] if pairs[0] == st.mvs[0] else pairs[0])
            st.weights.append(2)
        else:
            for p in pairs:
                st.mvs.append(p)
                st.weights.append(2)


def find_mv_stack(d, b, refs, wh):
    """find_mv_stack for the block's references `refs` (ref 1 -1 where
    single): SimpleNamespace(mvs (at least two entries; pairs of MVs),
    num (NumMvFound), weights, new_ctx, ref_ctx, zero_ctx, drl_ctx,
    gmv (the global MVs))."""
    f = d.f
    comp = int(refs[1] > 0)
    bw4, bh4 = wh[b.size]
    gmv = [global_mv(d, b, refs[0], wh),
           global_mv(d, b, refs[1], wh) if comp else ZERO]
    st = _Stack(refs, gmv, comp)
    _scan_row(d, b, st, -1, wh)
    above = st.found
    st.found = 0
    _scan_col(d, b, st, -1, wh)
    left = st.found
    st.found = 0
    if max(bw4, bh4) <= 16:
        _scan_point(d, b, st, -1, bw4, wh)
    above |= st.found
    close = above + left
    nearest, num_new = len(st.mvs), st.new
    for i in range(nearest):
        st.weights[i] += REF_CAT_LEVEL
    zero = 0
    if f.use_ref_frame_mvs:
        zero = _temporal_scan(d, b, st, wh)
    st.found = 0
    _scan_point(d, b, st, -1, -1, wh)
    above |= st.found
    st.found = 0
    _scan_row(d, b, st, -3, wh)
    above |= st.found
    st.found = 0
    _scan_col(d, b, st, -3, wh)
    left |= st.found
    st.found = 0
    if bh4 > 1:
        _scan_row(d, b, st, -5, wh)
    above |= st.found
    st.found = 0
    if bw4 > 1:
        _scan_col(d, b, st, -5, wh)
    left |= st.found
    total = above + left
    _sort(st, 0, nearest)
    _sort(st, nearest, len(st.mvs))
    if len(st.mvs) < 2:
        _extra_search(d, b, st, wh)
    num = len(st.mvs)
    drl = []
    for i in range(num):
        z = 0
        if i + 1 < num:
            w0, w1 = st.weights[i], st.weights[i + 1]
            if w0 >= REF_CAT_LEVEL:
                z = int(w1 < REF_CAT_LEVEL)
            else:
                z = 2
        drl.append(z)
    top = -(b.r * 32) - (MV_BORDER + bh4 * 32)
    bottom = (d.mi_rows - bh4 - b.r) * 32 + MV_BORDER + bh4 * 32
    left_e = -(b.c * 32) - (MV_BORDER + bw4 * 32)
    right = (d.mi_cols - bw4 - b.c) * 32 + MV_BORDER + bw4 * 32
    mvs = [tuple((max(top, min(bottom, mv[0])), max(left_e, min(right,
                                                                mv[1])))
                 for mv in pair) for pair in st.mvs]
    while len(mvs) < 2:
        mvs.append((gmv[0], ZERO))
    if close == 0:
        new_ctx, ref_ctx = min(total, 1), total
    elif close == 1:
        new_ctx, ref_ctx = 3 - min(num_new, 1), 2 + total
    else:
        new_ctx, ref_ctx = 5 - min(num_new, 1), 5
    return SimpleNamespace(mvs=mvs, num=num, weights=st.weights,
                           new_ctx=new_ctx, ref_ctx=ref_ctx, zero_ctx=zero,
                           drl_ctx=drl, gmv=gmv)


def _temporal_scan(d, b, st, wh):
    bw4, bh4 = wh[b.size]
    step_w = 4 if bw4 >= 16 else 2
    step_h = 4 if bh4 >= 16 else 2
    zero = 1
    for dr in range(0, min(bh4, 16), step_h):
        for dc in range(0, min(bw4, 16), step_w):
            z = _temporal(d, b, st, dr, dc, dr == 0 and dc == 0)
            if dr == 0 and dc == 0:
                zero = z
    if 2 <= bh4 < 16 and 2 <= bw4 < 16:
        vo, ho = max(2, bh4), max(2, bw4)
        for dr, dc in ((vo, -2), (vo, ho), (vo - 2, ho)):
            r, c = (b.r & 15) + dr, (b.c & 15) + dc
            if 0 <= r < 16 and 0 <= c < 16:
                _temporal(d, b, st, dr, dc, False)
    return zero


# ------------------------------------------------------ the motion field

def saved_mvs(d):
    """The motion field a frame keeps (the specification's MfRefFrames /
    MfMvs at each 8 x 8's bottom-right 4 x 4): (refs (h8, w8) int, mvs
    (h8, w8, 2) int) of MVs to references before the frame."""
    f = d.f
    h8, w8 = d.mi_rows >> 1, d.mi_cols >> 1
    refs = np.zeros((h8, w8), np.int64)
    mvs = np.zeros((h8, w8, 2), np.int64)
    if f.intra:
        return refs, mvs
    for y in range(h8):
        rr, rm = d.ref_frames[2 * y + 1], d.mvs[2 * y + 1]
        for x in range(w8):
            rf, mv = rr[2 * x + 1], rm[2 * x + 1]
            for k in (0, 1):
                r = rf[k]
                if r > 0 and get_relative_dist(
                        d.s, f.order_hints[r], f.order_hint) < 0 and \
                        abs(mv[k][0]) <= REFMVS_LIMIT and \
                        abs(mv[k][1]) <= REFMVS_LIMIT:
                    refs[y, x] = r
                    mvs[y, x] = mv[k]
    return refs, mvs


def motion_field(s, f):
    """motion_field_estimation: each 8 x 8's projected (MV, reference
    distance) or None, from LAST (unless it is GOLDEN's overlay), BWDREF,
    ALTREF2, ALTREF and LAST2, at most three of them projecting."""
    h8, w8 = f.mi_rows >> 1, f.mi_cols >> 1
    tpl = [[None] * w8 for _ in range(h8)]
    cur = f.order_hint

    def project(src, backward):
        slot = f.refs[f.ref_frame_idx[src - 1]]
        r = slot.frame
        if r.intra or r.mi_rows != f.mi_rows or r.mi_cols != f.mi_cols:
            return 0
        refs, mvs = slot.saved_mvs
        start = r.order_hint
        to_cur = get_relative_dist(s, start, cur)
        if backward:
            to_cur = -to_cur
        offs = [get_relative_dist(s, start, r.order_hints[k])
                for k in range(8)]
        for y, x in zip(*np.nonzero(refs)):
            off = offs[refs[y, x]]
            if not (0 < off <= MAX_FRAME_DISTANCE and
                    abs(to_cur) <= MAX_FRAME_DISTANCE):
                continue
            mv = (int(mvs[y, x, 0]), int(mvs[y, x, 1]))
            p = mv_projection(mv, to_cur, off)
            ro = p[0] >> 6 if p[0] >= 0 else -((-p[0]) >> 6)
            co = p[1] >> 6 if p[1] >= 0 else -((-p[1]) >> 6)
            row = y - ro if backward else y + ro
            col = x - co if backward else x + co
            if not (0 <= row < h8 and 0 <= col < w8):
                continue
            by, bx = (y >> 3) << 3, (x >> 3) << 3
            if not (by <= row < by + 8 and bx - 8 <= col < bx + 16):
                continue
            tpl[row][col] = (mv, off)
        return 1
    stamp = 2
    last = f.refs[f.ref_frame_idx[0]].frame
    if last.order_hints[7] != f.order_hints[4]:
        project(1, True)
    stamp -= 1
    for src in (5, 6):
        if get_relative_dist(s, f.order_hints[src], cur) > 0:
            stamp -= project(src, False)
    if get_relative_dist(s, f.order_hints[7], cur) > 0 and stamp >= 0:
        stamp -= project(7, False)
    if stamp >= 0:
        project(2, True)
    return tpl


# ------------------------------------------------- local warp's samples

def warp_samples(d, b, mv, wh):
    """find_warp_samples: [(y, x, y', x')] of the neighbours with the
    block's single reference, in 1/8 pixel at their centres and moved by
    their MVs, those whose MV is within the threshold of the block's (the
    first one found where none is)."""
    bw4, bh4 = wh[b.size]
    ref = b.ref_frame[0]
    thresh = max(16, min(112, max(bw4, bh4) * 4))
    valid, first, scanned = [], [], [0]

    def add(dr, dc):
        if scanned[0] >= 8:
            return
        row, col = b.r + dr, b.c + dc
        if not (d.inside(row, col) and d.written[row][col]):
            return
        rf = d.ref_frames[row][col]
        if rf[0] != ref or rf[1] != -1:
            return
        cw, ch = wh[d.mi_size[row][col]]
        cr, cc = row & ~(ch - 1), col & ~(cw - 1)
        mid_y = cr * 4 + ch * 2 - 1
        mid_x = cc * 4 + cw * 2 - 1
        cmv = d.mvs[row][col][0]
        cand = (mid_y * 8, mid_x * 8, mid_y * 8 + cmv[0], mid_x * 8 + cmv[1])
        scanned[0] += 1
        if abs(cmv[0] - mv[0]) + abs(cmv[1] - mv[1]) <= thresh:
            valid.append(cand)
        elif scanned[0] == 1:
            first.append(cand)
    top_left = top_right = 1
    if b.avail_u:
        sw = wh[d.mi_size[b.r - 1][b.c]][0]
        if bw4 <= sw:
            off = -(b.c & (sw - 1))
            if off < 0:
                top_left = 0
            if off + sw > bw4:
                top_right = 0
            add(-1, 0)
        else:
            i = 0
            while i < min(bw4, d.mi_cols - b.c):
                add(-1, i)
                i += wh[d.mi_size[b.r - 1][b.c + i]][0]
    if b.avail_l:
        sh = wh[d.mi_size[b.r][b.c - 1]][1]
        if bh4 <= sh:
            if -(b.r & (sh - 1)) < 0:
                top_left = 0
            add(0, -1)
        else:
            i = 0
            while i < min(bh4, d.mi_rows - b.r):
                add(i, -1)
                i += wh[d.mi_size[b.r + i][b.c - 1]][1]
    if top_left:
        add(-1, -1)
    if top_right and max(bw4, bh4) <= 16:
        add(-1, bw4)
    return valid or first


def read_mv(rd, ctx, pred, hp, integer):
    """read_mv: the predicted MV plus the coded difference (rows first)
    with the MV context `ctx`, at the frame's precision (`hp`:
    allow_high_precision_mv, `integer`: force_integer_mv)."""
    joint = rd.symbol(ctx.joint)
    row, col = pred
    if joint in (2, 3):
        row += _component(rd, ctx.comp[0], hp, integer)
    if joint in (1, 3):
        col += _component(rd, ctx.comp[1], hp, integer)
    return row, col


def _component(rd, c, hp, integer):
    sign = rd.symbol(c.sign)
    cls = rd.symbol(c.cls)
    if cls == 0:
        up = rd.symbol(c.class0)
        fr = 3 if integer else rd.symbol(c.class0_fr[up])
        h = rd.symbol(c.class0_hp) if hp else 1
        mag = ((up << 3) | (fr << 1) | h) + 1
    else:
        d = 0
        for i in range(cls):
            d |= rd.symbol(c.bits[i]) << i
        fr = 3 if integer else rd.symbol(c.fr)
        h = rd.symbol(c.hp) if hp else 1
        mag = (2 << (cls + 2)) + ((d << 3) | (fr << 1) | h) + 1
    return -mag if sign else mag
