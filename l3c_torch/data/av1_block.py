"""AV1's block layer for intra frames (the AV1 specification, sections
5.11 and 7): partitions, intra mode info (segment ids, skip, delta q /
lf, y and uv modes with angle deltas, CfL alphas, palettes with their
colour cache and colour-index maps, filter intra; intra block copy's
DVs, data/av1_intrabc.py), transform sizes (an intrabc block's transform
tree) and types, the coefficients and their dequantization (with the
quantizer matrices where the frame uses them), each transform block
predicted and reconstructed in decoding order.

The walk also reads what the in-loop filters need (CDEF indices,
restoration units, of the upscaled frame with superres; each block's
loop filter deltas) and keeps each plane's transform sizes for the
deblocking filter. `decode_frame(seq, frame, tiles, data, path)` returns
the planes deblocked (data/av1_loopfilter.py), CDEF-filtered
(data/av1_cdef.py), upscaled where the frame codes superres
(data/av1_superres.py) and restored (data/av1_restoration.py) as the
frame header asks, uint8 numpy arrays (uint16 at 10 and 12 bits)
cropped to the frame size, with film grain (data/av1_filmgrain.py) where
the header carries it. The symbol walk is plain Python and the same at
every depth but for palette colours; prediction and the transforms are
numpy (data/av1_recon.py), and so are the filters.
"""
from __future__ import annotations

import os
import time
from types import SimpleNamespace
from typing import List

import numpy as np

from . import av1_cdef, av1_filmgrain, av1_inter, av1_intrabc
from . import av1_loopfilter, av1_mvs
from . import av1_recon as R
from . import av1_restoration, av1_superres
from . import av1_tables as T
from .av1_mvs import (GLOBAL_GLOBALMV, GLOBALMV, NEAREST_NEARESTMV,
                      NEARESTMV, NEARMV, NEWMV, NEW_NEWMV, ZERO)
from .av1_obu import (PRIMARY_REF_NONE, RESTORE_NONE, RESTORE_SGRPROJ,
                      RESTORE_WIENER, SWITCHABLE, TRANSLATION, damaged,
                      get_relative_dist, qindex)
from .av1_symbol import SymbolReader, cdf_copy

# block sizes: (width, height) in 4-sample units
BLOCK_WH = ((1, 1), (1, 2), (2, 1), (2, 2), (2, 4), (4, 2), (4, 4), (4, 8),
            (8, 4), (8, 8), (8, 16), (16, 8), (16, 16), (16, 32), (32, 16),
            (32, 32), (1, 4), (4, 1), (2, 8), (8, 2), (4, 16), (16, 4))
BLOCK_BY_WH = {wh: i for i, wh in enumerate(BLOCK_WH)}
_BW4 = np.array([w for w, _ in BLOCK_WH], np.int64)
_BH4 = np.array([h for _, h in BLOCK_WH], np.int64)
BLOCK_4X4, BLOCK_8X8, BLOCK_32X32, BLOCK_64X64, BLOCK_128X128 = 0, 3, 9, 12, 15
# transform sizes: (width, height) in samples
TX_WH = ((4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (4, 8), (8, 4),
         (8, 16), (16, 8), (16, 32), (32, 16), (32, 64), (64, 32), (4, 16),
         (16, 4), (8, 32), (32, 8), (16, 64), (64, 16))
TX_BY_WH = {wh: i for i, wh in enumerate(TX_WH)}
TX_4X4, TX_16X32, TX_32X16, TX_32X32 = 0, 9, 10, 3
TX_16X64, TX_64X16 = 17, 18
_SQ = {4: 0, 8: 1, 16: 2, 32: 3, 64: 4}
TX_SQR = tuple(_SQ[min(w, h)] for w, h in TX_WH)
TX_SQR_UP = tuple(_SQ[max(w, h)] for w, h in TX_WH)
TX_ADJ = tuple(TX_BY_WH[(min(w, 32), min(h, 32))] for w, h in TX_WH)


def _split(tx):
    w, h = TX_WH[tx]
    if w == h:
        return TX_BY_WH[(max(4, w // 2), max(4, h // 2))]
    if w == 2 * h or h == 2 * w:
        m = min(w, h)
        return TX_BY_WH[(m, m)]
    return TX_BY_WH[(w // 2, h) if w > h else (w, h // 2)]


SPLIT_TX = tuple(_split(t) for t in range(19))
MAX_TX_RECT = tuple(TX_BY_WH[(min(4 * w, 64), min(4 * h, 64))]
                    for w, h in BLOCK_WH)


def _depth(tx):
    d = 0
    while tx != TX_4X4:
        tx = SPLIT_TX[tx]
        d += 1
    return d


MAX_TX_DEPTH = tuple(_depth(t) for t in MAX_TX_RECT)
PARTITION_NONE, PARTITION_HORZ, PARTITION_VERT, PARTITION_SPLIT = 0, 1, 2, 3
HORZ_A, HORZ_B, VERT_A, VERT_B, HORZ_4, VERT_4 = 4, 5, 6, 7, 8, 9
INTRA_MODE_CONTEXT = (0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0)
SIZE_GROUP = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 0, 0, 1, 1, 2,
              2)
# the sizes with wedges (Wedge_Bits 4): 8x8 .. 32x32, 8x32, 32x8
WEDGE_SIZES = frozenset((3, 4, 5, 6, 7, 8, 9, 18, 19))
COMPOUND_MODE_CTX = ((0, 1, 1, 1, 1), (1, 2, 3, 4, 4), (4, 4, 5, 6, 7))
SIMPLE, OBMC, LOCALWARP = 0, 1, 2
SEG_REF_FRAME, SEG_SKIP, SEG_GLOBALMV = 5, 6, 7
LAST, LAST2, LAST3, GOLDEN, BWDREF, ALTREF2, ALTREF = 1, 2, 3, 4, 5, 6, 7
II_MODE = (0, 1, 2, 9)              # II_DC, II_V, II_H, II_SMOOTH -> intra
_HAS_NEAR = frozenset((NEARMV, 18, 21, 22))     # NEAR_NEAR, NEAR_NEW, NEW_NEAR
# get_mode: each reference's single mode of a (compound) mode
_MODE_OF = {NEARESTMV: (NEARESTMV,), NEARMV: (NEARMV,), GLOBALMV: (GLOBALMV,),
            NEWMV: (NEWMV,), 17: (NEARESTMV, NEARESTMV), 18: (NEARMV, NEARMV),
            19: (NEARESTMV, NEWMV), 20: (NEWMV, NEARESTMV),
            21: (NEARMV, NEWMV), 22: (NEWMV, NEARMV),
            23: (GLOBALMV, GLOBALMV), 24: (NEWMV, NEWMV)}
# tx types
DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST = 0, 1, 2, 3
IDTX, V_DCT, H_DCT = 9, 10, 11
V_TYPES, H_TYPES = (10, 12, 14), (11, 13, 15)
INV_SET1 = (IDTX, DCT_DCT, V_DCT, H_DCT, ADST_ADST, ADST_DCT, DCT_ADST)
INV_SET2 = (IDTX, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST)
# the inter sets (intra block copy): all 16 types, 12, IDTX and DCT
INTER_INV = ((9, 10, 11, 12, 13, 14, 15, 0, 1, 2, 4, 5, 3, 6, 7, 8),
             (9, 10, 11, 0, 1, 2, 4, 5, 3, 6, 7, 8), (9, 0))
IN_SET_INTRA = ((DCT_DCT,), (DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, IDTX,
                             V_DCT, H_DCT),
                (DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, IDTX))
MODE_TO_TXFM = (DCT_DCT, ADST_DCT, DCT_ADST, DCT_DCT, ADST_ADST, ADST_DCT,
                DCT_ADST, DCT_ADST, ADST_DCT, ADST_ADST, ADST_DCT, DCT_ADST,
                ADST_ADST, DCT_DCT)
FILTER_TO_DIR = (0, 1, 2, 6, 0)
PALETTE_COLOR_CONTEXT = (-1, -1, 0, -1, -1, 4, 3, 2, 1)
TX_CLASS_2D, TX_CLASS_HORIZ, TX_CLASS_VERT = 0, 1, 2
SIG_REF_DIFF = (((0, 1), (1, 0), (1, 1), (0, 2), (2, 0)),
                ((0, 1), (1, 0), (0, 2), (0, 3), (0, 4)),
                ((0, 1), (1, 0), (2, 0), (3, 0), (4, 0)))
MAG_REF = (((0, 1), (1, 0), (1, 1)), ((0, 1), (1, 0), (0, 2)),
           ((0, 1), (1, 0), (2, 0)))
# Coeff_Base_Ctx_Offset by shape (w == h, w > h, w < h), [row][col]
LO_CTX = (((0, 1, 6, 6, 21), (1, 6, 6, 21, 21), (6, 6, 21, 21, 21),
           (6, 21, 21, 21, 21), (21, 21, 21, 21, 21)),
          ((0, 16, 6, 6, 21), (16, 16, 6, 21, 21), (16, 16, 21, 21, 21),
           (16, 16, 21, 21, 21), (16, 16, 21, 21, 21)),
          ((0, 11, 11, 11, 11), (11, 11, 11, 11, 11), (6, 6, 21, 21, 21),
           (6, 21, 21, 21, 21), (21, 21, 21, 21, 21)))


def _scan_default(w, h):
    out = []
    for d in range(w + h - 1):
        cells = [(r, d - r) for r in range(h) if 0 <= d - r < w]
        if w == h:
            if d % 2 == 0:
                cells.reverse()         # zig-zag: even diagonals upwards
        elif w > h:
            cells.reverse()             # wide: bottom-left to top-right
        out += [r * w + c for r, c in cells]
    return tuple(out)


SCANS = {}
for _t, (_w, _h) in enumerate(TX_WH):
    if _w <= 32 and _h <= 32:
        SCANS[_t] = (_scan_default(_w, _h), tuple(range(_w * _h)),
                     tuple(r * _w + c for c in range(_w) for r in range(_h)))


def _get_scan(tx, tx_type):
    if tx == TX_16X64:
        return SCANS[TX_16X32][0]
    if tx == TX_64X16:
        return SCANS[TX_32X16][0]
    if TX_SQR_UP[tx] == 4:
        return SCANS[TX_32X32][0]
    s = SCANS[tx]
    if tx_type == IDTX:
        return s[0]
    if tx_type in V_TYPES:
        return s[1]
    if tx_type in H_TYPES:
        return s[2]
    return s[0]


def _tx_class(t):
    if t in V_TYPES:
        return TX_CLASS_VERT
    if t in H_TYPES:
        return TX_CLASS_HORIZ
    return TX_CLASS_2D


class _Cdfs:
    """The frame's initial CDFs (the defaults, the coefficients' by
    base_q_idx), copied for a tile; `copy` gives a frame's CDFs to keep in
    a slot (the adaptation counters cleared, as dav1d keeps them) or to
    start a tile or a later frame from."""

    def __init__(self, base_q_idx: int):
        C = T.CDFS
        q = 0 if base_q_idx <= 20 else 1 if base_q_idx <= 60 else \
            2 if base_q_idx <= 120 else 3

        def get(name):
            shape, n, flat = C[name]
            return _nest(cdf_copy(flat, n), shape)

        def getq(name):
            return get(name)[q]

        self.kf_y = get("KF_Y_MODE")
        self.angle = get("ANGLE_DELTA")
        self.uv = [get("UV_MODE_CFL_NOT_ALLOWED"),
                   get("UV_MODE_CFL_ALLOWED")]
        self.partition = get("PARTITION")
        self.tx1 = get("INTRA_TX_SET1")
        self.tx2 = get("INTRA_TX_SET2")
        self.cfl_alpha = get("CFL_ALPHA")
        self.cfl_sign = get("CFL_SIGN")[0]
        self.tx_depth = get("TX_DEPTH")
        self.delta_q = get("DELTA_Q")[0]
        self.delta_lf = get("DELTA_LF")[0]
        self.delta_lf_multi = get("DELTA_LF_MULTI")
        self.filter_intra = get("FILTER_INTRA")
        self.filter_mode = get("FILTER_INTRA_MODE")[0]
        self.pal_size = [get("PALETTE_Y_SIZE"), get("PALETTE_UV_SIZE")]
        self.pal_color = [get("PALETTE_Y_COLOR"), get("PALETTE_UV_COLOR")]
        self.pal_y_mode = get("PALETTE_Y_MODE")
        self.pal_uv_mode = get("PALETTE_UV_MODE")
        self.segment = get("SEGMENT_ID")
        self.skip = get("SKIP")
        self.eob = [getq(f"EOB_PT_{n}") for n in
                    (16, 32, 64, 128, 256, 512, 1024)]
        self.base_eob = getq("COEFF_BASE_EOB")
        self.base = getq("COEFF_BASE")
        self.br = getq("COEFF_BR")
        self.dc_sign = getq("DC_SIGN")
        self.eob_extra = getq("EOB_EXTRA")
        self.txb_skip = getq("TXB_SKIP")
        self.lr_switch = get("RESTORE_SWITCHABLE")[0]
        self.lr_wiener = get("RESTORE_WIENER")[0]
        self.lr_sgr = get("RESTORE_SGRPROJ")[0]
        self.intrabc = get("INTRABC")[0]
        self.txfm_split = get("TXFM_SPLIT")
        self.inter_tx = [get(f"INTER_TX_SET{k}") for k in (1, 2, 3)]
        # the MV contexts: 0 for inter blocks, 1 (MV_INTRABC_CONTEXT)
        # for intra block copy
        self.mv = [SimpleNamespace(joint=get("MV_JOINT")[0], comp=[
            SimpleNamespace(
                cls=get("MV_CLASS")[0], class0=get("MV_CLASS0")[0],
                sign=get("MV_SIGN")[0], bits=get("MV_BITS"),
                class0_fr=get("MV_CLASS0_FR"), fr=get("MV_FR")[0],
                class0_hp=get("MV_CLASS0_HP")[0], hp=get("MV_HP")[0])
            for _ in (0, 1)]) for _ in (0, 1)]
        # inter frames
        self.y_mode = get("Y_MODE")
        self.is_inter = get("IS_INTER")
        self.skip_mode = get("SKIP_MODE")
        self.seg_pred = get("SEGMENT_PRED")
        self.comp_mode = get("COMP_MODE")
        self.comp_ref_type = get("COMP_REF_TYPE")
        self.uni_comp_ref = get("UNI_COMP_REF")
        self.comp_ref = get("COMP_REF")
        self.comp_bwd_ref = get("COMP_BWD_REF")
        self.single_ref = get("SINGLE_REF")
        self.new_mv = get("NEW_MV")
        self.zero_mv = get("ZERO_MV")
        self.ref_mv = get("REF_MV")
        self.drl = get("DRL")
        self.compound_mode = get("COMPOUND_MODE")
        self.interintra = get("INTERINTRA")
        self.interintra_mode = get("INTERINTRA_MODE")
        self.wedge_interintra = get("WEDGE_INTERINTRA")
        self.wedge_idx = get("WEDGE_IDX")
        self.compound_type = get("COMPOUND_TYPE")
        self.comp_group_idx = get("COMP_GROUP_IDX")
        self.compound_idx = get("COMPOUND_IDX")
        self.motion_mode = get("MOTION_MODE")
        self.obmc = get("OBMC")
        self.interp = get("SWITCHABLE_INTERP")

    def copy(self) -> "_Cdfs":
        out = object.__new__(_Cdfs)
        out.__dict__ = {k: _clone(v) for k, v in vars(self).items()}
        return out


def _clone(x):
    """A deep copy of CDF lists, each counter cleared."""
    if isinstance(x, SimpleNamespace):
        return SimpleNamespace(**{k: _clone(v) for k, v in vars(x).items()})
    if x and isinstance(x[0], int):
        return x[:-1] + [0]
    return [_clone(v) for v in x]


def _nest(lst, shape):
    for d in reversed(shape[1:]):
        lst = [lst[i:i + d] for i in range(0, len(lst), d)]
    return lst


class FrameDecoder:
    def __init__(self, seq: SimpleNamespace, f: SimpleNamespace, path: str):
        self.s, self.f, self.path = seq, f, path
        self.ssx, self.ssy = seq.ssx, seq.ssy
        self.bd = seq.bit_depth
        self.planes = seq.num_planes
        self.mi_rows, self.mi_cols = f.mi_rows, f.mi_cols
        pad_h = ((f.mi_rows * 4 + 127) // 128) * 128 + 64
        pad_w = ((f.mi_cols * 4 + 127) // 128) * 128 + 64
        self.frame = [np.zeros((pad_h, pad_w), np.int64)]
        if self.planes > 1:
            for _ in range(2):
                self.frame.append(np.zeros((pad_h >> self.ssy,
                                            pad_w >> self.ssx), np.int64))
        rows, cols = f.mi_rows + 32, f.mi_cols + 32
        # per 4x4 (mi) info of the decoded blocks
        self.mi_size = [[0] * cols for _ in range(rows)]
        self.y_mode = [[0] * cols for _ in range(rows)]
        self.uv_mode = [[0] * cols for _ in range(rows)]
        self.skips = [[0] * cols for _ in range(rows)]
        self.seg_ids = [[0] * cols for _ in range(rows)]
        # per-block loop filter deltas: each block's set of deltas as an
        # index into lf_sets (set 0: no deltas)
        self.lf_ids = [[0] * cols for _ in range(rows)] \
            if f.delta_lf_present else None
        self.lf_sets = {(0, 0, 0, 0): 0}
        self.tx_sizes = [[0] * cols for _ in range(rows)]
        self.pal_sizes = [[[0] * cols for _ in range(rows)] for _ in (0, 1)]
        self.pal_colors = [[[None] * cols for _ in range(rows)]
                           for _ in (0, 1)]
        # inter blocks (intra block copy's too: their reference is the
        # intra frame, their DV the first MV), what is decoded
        self.is_inter = [[0] * cols for _ in range(rows)]
        self.ref_frames = [[(0, -1)] * cols for _ in range(rows)]
        self.mvs = [[(ZERO, ZERO)] * cols for _ in range(rows)]
        self.written = [[0] * cols for _ in range(rows)]
        self.skip_modes = [[0] * cols for _ in range(rows)]
        self.comp_groups = [[0] * cols for _ in range(rows)]
        self.compound_idxs = [[1] * cols for _ in range(rows)]
        self.interps = [[(0, 0)] * cols for _ in range(rows)]
        self._setup_refs(seq, f)
        self.tx_types = {}
        self.sb4 = 32 if seq.sb128 else 16
        self.sb_size = BLOCK_128X128 if seq.sb128 else BLOCK_64X64
        # for the in-loop filters: each plane's tx size per 4 x 4, the
        # CDEF index per 64 x 64, the restoration units
        self.lf_tx = [np.zeros((p.shape[0] >> 2, p.shape[1] >> 2), np.int8)
                      for p in self.frame]
        self.cdef_idx = np.full(((rows >> 4) + 2, (cols >> 4) + 2), -1,
                                np.int64)
        self.lr = []
        for p in range(self.planes):
            if f.lr_type[p] == RESTORE_NONE:
                self.lr.append(None)
                continue
            sx = self.ssx if p else 0
            sy = self.ssy if p else 0
            size = f.lr_unit_size[p]
            n_r = av1_restoration.units(size, (f.height + sy) >> sy)
            n_c = av1_restoration.units(size,
                                        (f.upscaled_width + sx) >> sx)
            self.lr.append(SimpleNamespace(
                type=np.zeros((n_r, n_c), np.int64),
                wiener=np.zeros((n_r, n_c, 2, 3), np.int64),
                sgr=np.zeros((n_r, n_c, 3), np.int64)))

    def _setup_refs(self, seq, f):
        """What a frame takes from its slots: its initial CDFs (the
        primary reference frame's, else the defaults), the previous
        segment map, the projected motion field, the references' planes
        and scales, global motion's shear."""
        prf = f.primary_ref_frame
        prev = f.refs[f.ref_frame_idx[prf]] if prf != PRIMARY_REF_NONE \
            else None
        self.prev_cdfs = None if prev is None else prev.cdfs
        self.saved_cdfs = self._initial_cdfs()
        self.prev_seg = None
        if f.seg_enabled and prev is not None and \
                prev.frame.mi_rows == f.mi_rows and \
                prev.frame.mi_cols == f.mi_cols:
            self.prev_seg = prev.seg_map
        self.tpl = av1_mvs.motion_field(seq, f) if f.use_ref_frame_mvs \
            else None
        self.ref_slots = [None] * 8
        self.scales = [None] * 8
        self.gm_warp = [None] * 8
        if f.intra:
            return
        for ref in range(1, 8):
            slot = f.refs[f.ref_frame_idx[ref - 1]]
            planes_of(slot)
            self.ref_slots[ref] = slot
            self.scales[ref] = av1_inter.scale_of(
                slot.frame.upscaled_width, slot.frame.height, f.width,
                f.height)
            if f.gm_type[ref] > TRANSLATION:
                sh = av1_inter.setup_shear(f.gm_params[ref])
                if sh[0] and not f.force_integer_mv and \
                        self.scales[ref] == (1 << 14, 1 << 14):
                    self.gm_warp[ref] = sh

    def _initial_cdfs(self):
        if self.prev_cdfs is None:
            return _Cdfs(self.f.base_q_idx)
        return self.prev_cdfs.copy()

    # ------------------------------------------------------------- tiles
    def decode_tile(self, data, start, end, tile_row, tile_col):
        f = self.f
        self.r = SymbolReader(data, start, end, f.disable_cdf_update)
        self.cdf = self._initial_cdfs()
        self.row_start = f.mi_row_starts[tile_row]
        self.row_end = f.mi_row_starts[tile_row + 1]
        self.col_start = f.mi_col_starts[tile_col]
        self.col_end = f.mi_col_starts[tile_col + 1]
        self.current_q = f.base_q_idx
        self.delta_lf = [0, 0, 0, 0]
        self.lf_id = 0
        self.ref_wiener = [[list(T.WIENER_TAPS_MID) for _ in (0, 1)]
                           for _ in range(self.planes)]
        self.ref_sgr = [list(T.SGRPROJ_XQD_MID) for _ in range(self.planes)]
        n = self.mi_cols + 32
        self.above_level = [[0] * n for _ in range(3)]
        self.above_dc = [[0] * n for _ in range(3)]
        self.above_seg_pred = [0] * n
        for r in range(self.row_start, self.row_end, self.sb4):
            m = self.mi_rows + 32
            self.left_level = [[0] * m for _ in range(3)]
            self.left_dc = [[0] * m for _ in range(3)]
            self.left_seg_pred = [0] * m
            for c in range(self.col_start, self.col_end, self.sb4):
                self.read_deltas = f.delta_q_present
                self._clear_decoded(r, c)
                self._read_lr(r, c)
                self.decode_partition(r, c, self.sb_size)
        if self.r.max_bits() < -14:
            # the specification's bound on SymbolMaxBits, which dav1d
            # enforces as it ends a tile's superblock row
            raise damaged(self.path, "a tile reads past its end")
        if tile_row * f.tile_cols + tile_col == f.context_update_tile_id \
                and not f.disable_frame_end_update_cdf:
            self.saved_cdfs = self.cdf.copy()

    def _clear_decoded(self, r, c):
        sb4 = self.sb4
        self.decoded = []
        for p in range(self.planes):
            sx = self.ssx if p else 0
            sy = self.ssy if p else 0
            w4 = (self.col_end - c) >> sx
            h4 = (self.row_end - r) >> sy
            n_y, n_x = (sb4 >> sy) + 2, (sb4 >> sx) + 2
            g = [[0] * (n_x + 1) for _ in range(n_y + 1)]
            for y in range(-1, (sb4 >> sy) + 1):
                for x in range(-1, (sb4 >> sx) + 1):
                    if y < 0 and x < w4:
                        g[y + 1][x + 1] = 1
                    elif x < 0 and y < h4:
                        g[y + 1][x + 1] = 1
            g[(sb4 >> sy) + 1][0] = 0
            self.decoded.append(g)

    # ------------------------------------------------------- restoration
    def _read_lr(self, r, c):
        """read_lr: the restoration units whose top-left corner lies in
        the superblock at (r, c); with superres its columns are those of
        the upscaled frame."""
        f = self.f
        for p in range(self.planes):
            if f.lr_type[p] == RESTORE_NONE:
                continue
            sx = self.ssx if p else 0
            sy = self.ssy if p else 0
            size = f.lr_unit_size[p]
            n_r, n_c = self.lr[p].type.shape
            r0 = (r * (4 >> sy) + size - 1) // size
            r1 = min(n_r, ((r + self.sb4) * (4 >> sy) + size - 1) // size)
            num, den = (4 >> sx) * f.superres_denom, size * 8
            c0 = (c * num + den - 1) // den
            c1 = min(n_c, ((c + self.sb4) * num + den - 1) // den)
            for ur in range(r0, r1):
                for uc in range(c0, c1):
                    self._read_lr_unit(p, ur, uc)

    def _read_lr_unit(self, p, ur, uc):
        rd, ft, unit = self.r, self.f.lr_type[p], self.lr[p]
        if ft == RESTORE_WIENER:
            t = RESTORE_WIENER if rd.symbol(self.cdf.lr_wiener) else \
                RESTORE_NONE
        elif ft == RESTORE_SGRPROJ:
            t = RESTORE_SGRPROJ if rd.symbol(self.cdf.lr_sgr) else \
                RESTORE_NONE
        else:
            t = rd.symbol(self.cdf.lr_switch)
        unit.type[ur, uc] = t
        if t == RESTORE_WIENER:
            for ps in (0, 1):
                ref = self.ref_wiener[p][ps]
                for j in range(1 if p else 0, 3):
                    ref[j] = self._subexp(T.WIENER_TAPS_MIN[j],
                                          T.WIENER_TAPS_MAX[j] + 1,
                                          T.WIENER_TAPS_K[j], ref[j])
                    unit.wiener[ur, uc, ps, j] = ref[j]
        elif t == RESTORE_SGRPROJ:
            st = rd.literal(4)
            ref = self.ref_sgr[p]
            for i in (0, 1):
                lo, hi = T.SGRPROJ_XQD_MIN[i], T.SGRPROJ_XQD_MAX[i]
                if T.SGR_PARAMS[4 * st + i]:              # the radius
                    v = self._subexp(lo, hi + 1, 4, ref[i])
                elif i == 1:
                    v = max(lo, min(hi, 128 - ref[0]))
                else:
                    v = 0
                ref[i] = v
            unit.sgr[ur, uc] = (st, ref[0], ref[1])

    def _subexp(self, low, high, k, ref):
        """decode_signed_subexp_with_ref_bool."""
        rd = self.r
        mx, r = high - low, ref - low
        i = mk = 0
        while True:
            b2 = k + i - 1 if i else k
            a = 1 << b2
            if mx <= mk + 3 * a:
                v = rd.ns(mx - mk) + mk
                break
            if not rd.literal(1):
                v = rd.literal(b2) + mk
                break
            i += 1
            mk += a
        if (r << 1) <= mx:
            return _inverse_recenter(r, v) + low
        return mx - 1 - _inverse_recenter(mx - 1 - r, v) + low

    def inside(self, r, c):
        return self.col_start <= c < self.col_end and \
            self.row_start <= r < self.row_end

    # --------------------------------------------------------- partition
    def decode_partition(self, r, c, bsize):
        if r >= self.mi_rows or c >= self.mi_cols:
            return
        rd = self.r
        n4 = BLOCK_WH[bsize][0]
        half = n4 >> 1
        quarter = half >> 1
        has_rows = (r + half) < self.mi_rows
        has_cols = (c + half) < self.mi_cols
        if bsize < BLOCK_8X8:
            part = PARTITION_NONE
        else:
            bsl = n4.bit_length() - 1
            above = self.inside(r - 1, c) and \
                (BLOCK_WH[self.mi_size[r - 1][c]][0].bit_length() - 1) < bsl
            left = self.inside(r, c - 1) and \
                (BLOCK_WH[self.mi_size[r][c - 1]][1].bit_length() - 1) < bsl
            cdf = self.cdf.partition[bsl - 1][left * 2 + above]
            if has_rows and has_cols:
                part = rd.symbol(cdf)
            elif has_cols:
                ps = _psum(cdf, (PARTITION_VERT, PARTITION_SPLIT, HORZ_A,
                                 VERT_A, VERT_B) +
                           ((VERT_4,) if bsize != BLOCK_128X128 else ()))
                part = PARTITION_SPLIT if rd.symbol_fixed(
                    [ps, 0, 0]) else PARTITION_HORZ
            elif has_rows:
                ps = _psum(cdf, (PARTITION_HORZ, PARTITION_SPLIT, HORZ_A,
                                 HORZ_B, VERT_A) +
                           ((HORZ_4,) if bsize != BLOCK_128X128 else ()))
                part = PARTITION_SPLIT if rd.symbol_fixed(
                    [ps, 0, 0]) else PARTITION_VERT
            else:
                part = PARTITION_SPLIT
        if self.ssx and not self.ssy and part in (PARTITION_VERT, VERT_A,
                                                  VERT_B, VERT_4):
            # 4:2:2 chroma of a tall block has no block size (dav1d
            # refuses these partitions)
            raise damaged(self.path, "a vertical partition in 4:2:2")
        w, h = BLOCK_WH[bsize]
        sub = _subsize(part, w, h)
        split = BLOCK_BY_WH.get((max(1, w // 2), max(1, h // 2)))
        db = self.decode_block
        if part == PARTITION_NONE:
            db(r, c, sub)
        elif part == PARTITION_HORZ:
            db(r, c, sub)
            if has_rows:
                db(r + half, c, sub)
        elif part == PARTITION_VERT:
            db(r, c, sub)
            if has_cols:
                db(r, c + half, sub)
        elif part == PARTITION_SPLIT:
            self.decode_partition(r, c, sub)
            self.decode_partition(r, c + half, sub)
            self.decode_partition(r + half, c, sub)
            self.decode_partition(r + half, c + half, sub)
        elif part == HORZ_A:
            db(r, c, split)
            db(r, c + half, split)
            db(r + half, c, sub)
        elif part == HORZ_B:
            db(r, c, sub)
            db(r + half, c, split)
            db(r + half, c + half, split)
        elif part == VERT_A:
            db(r, c, split)
            db(r + half, c, split)
            db(r, c + half, sub)
        elif part == VERT_B:
            db(r, c, sub)
            db(r, c + half, split)
            db(r + half, c + half, split)
        elif part == HORZ_4:
            for k in range(4):
                if k < 3 or r + quarter * 3 < self.mi_rows:
                    db(r + quarter * k, c, sub)
        else:
            for k in range(4):
                if k < 3 or c + quarter * 3 < self.mi_cols:
                    db(r, c + quarter * k, sub)

    # ------------------------------------------------------------- block
    def decode_block(self, r, c, bsize):
        f, rd, cdf = self.f, self.r, self.cdf
        b = SimpleNamespace()
        b.r, b.c, b.size = r, c, bsize
        bw4, bh4 = BLOCK_WH[bsize]
        ssx, ssy = self.ssx, self.ssy
        if bh4 == 1 and ssy and (r & 1) == 0:
            b.has_chroma = 0
        elif bw4 == 1 and ssx and (c & 1) == 0:
            b.has_chroma = 0
        else:
            b.has_chroma = int(self.planes > 1)
        b.avail_u = self.inside(r - 1, c)
        b.avail_l = self.inside(r, c - 1)
        b.avail_uc, b.avail_lc = b.avail_u, b.avail_l
        if b.has_chroma:
            if ssy and bh4 == 1:
                b.avail_uc = self.inside(r - 2, c)
            if ssx and bw4 == 1:
                b.avail_lc = self.inside(r, c - 2)
        else:
            b.avail_uc = b.avail_lc = False
        b.pal_y = b.pal_uv = 0
        b.pal_colors = [None, None, None]
        b.ref_frame, b.mv = (0, -1), (ZERO, ZERO)
        b.skip_mode = b.motion_mode = b.interintra = 0
        b.comp_group_idx, b.compound_idx = 0, 1
        b.interp = (0, 0)
        if f.intra:
            self._intra_frame_mode_info(b)
        else:
            self._inter_frame_mode_info(b)
        self._palette_tokens(b)
        self._read_tx_size(b)
        if b.skip:
            self._reset_block_context(b)
        for y in range(bh4):
            ry = r + y
            for x in range(bw4):
                cx = c + x
                self.y_mode[ry][cx] = b.y_mode
                if b.has_chroma:
                    self.uv_mode[ry][cx] = b.uv_mode
                self.mi_size[ry][cx] = bsize
                self.skips[ry][cx] = b.skip
                self.seg_ids[ry][cx] = b.seg
                if not b.var_tx:
                    self.tx_sizes[ry][cx] = b.tx_size
                self.pal_sizes[0][ry][cx] = b.pal_y
                self.pal_sizes[1][ry][cx] = b.pal_uv
                self.pal_colors[0][ry][cx] = b.pal_colors[0]
                self.pal_colors[1][ry][cx] = b.pal_colors[1]
                self.is_inter[ry][cx] = b.is_inter
                self.ref_frames[ry][cx] = b.ref_frame
                self.mvs[ry][cx] = b.mv
                self.skip_modes[ry][cx] = b.skip_mode
                self.comp_groups[ry][cx] = b.comp_group_idx
                self.compound_idxs[ry][cx] = b.compound_idx
                self.interps[ry][cx] = b.interp
                self.written[ry][cx] = 1
        if self.lf_ids is not None:
            for ry in range(r, r + bh4):
                self.lf_ids[ry][c:c + bw4] = [self.lf_id] * bw4
        if b.is_inter and f.intra:
            self._intrabc_predict(b)
        elif b.is_inter:
            self._inter_predict(b)
        self._residual(b)

    def _intra_frame_mode_info(self, b):
        f, rd, cdf = self.f, self.r, self.cdf
        r, c = b.r, b.c
        b.seg = 0
        b.skip = 0
        if f.seg_id_pre_skip:
            b.seg = self._segment_id(b)
        if f.seg_id_pre_skip and f.seg_enabled and \
                f.seg_feature[b.seg][6] is not None:
            b.skip = 1
        else:
            ctx = (self.skips[r - 1][c] if b.avail_u else 0) + \
                (self.skips[r][c - 1] if b.avail_l else 0)
            b.skip = rd.symbol(cdf.skip[ctx])
        if not f.seg_id_pre_skip:
            b.seg = self._segment_id(b)
        b.lossless = f.lossless[b.seg]
        if not (b.skip or f.coded_lossless or not self.s.enable_cdef or
                f.allow_intrabc):
            self._read_cdef(b)
        self._delta_q_lf(b)
        self.read_deltas = 0
        b.is_inter = rd.symbol(cdf.intrabc) if f.allow_intrabc else 0
        if b.is_inter:
            self._intrabc_info(b)
        else:
            self._intra_info(b)

    # ------------------------------------------------------ inter frames
    def _seg_feat(self, b, j):
        f = self.f
        return f.seg_enabled and f.seg_feature[b.seg][j] is not None

    def _inter_frame_mode_info(self, b):
        """inter_frame_mode_info: the segment id (before or after skip,
        spatially or temporally predicted), skip mode, skip, CDEF and
        delta parameters, is_inter, then the intra or inter block's
        modes."""
        f, rd, cdf = self.f, self.r, self.cdf
        r, c = b.r, b.c
        bw4, bh4 = BLOCK_WH[b.size]
        b.skip = 0
        self._inter_segment_id(b, 1)
        if f.skip_mode_present and min(bw4, bh4) >= 2 and not (
                self._seg_feat(b, SEG_SKIP) or
                self._seg_feat(b, SEG_REF_FRAME) or
                self._seg_feat(b, SEG_GLOBALMV)):
            ctx = (self.skip_modes[r - 1][c] if b.avail_u else 0) + \
                (self.skip_modes[r][c - 1] if b.avail_l else 0)
            b.skip_mode = rd.symbol(cdf.skip_mode[ctx])
        if b.skip_mode:
            b.skip = 1
        elif f.seg_id_pre_skip and self._seg_feat(b, SEG_SKIP):
            b.skip = 1
        else:
            ctx = (self.skips[r - 1][c] if b.avail_u else 0) + \
                (self.skips[r][c - 1] if b.avail_l else 0)
            b.skip = rd.symbol(cdf.skip[ctx])
        if not f.seg_id_pre_skip:
            self._inter_segment_id(b, 0)
        b.lossless = f.lossless[b.seg]
        if not (b.skip or f.coded_lossless or not self.s.enable_cdef):
            self._read_cdef(b)
        self._delta_q_lf(b)
        self.read_deltas = 0
        au = self.ref_frames[r - 1][c] if b.avail_u else None
        al = self.ref_frames[r][c - 1] if b.avail_l else None
        b.nb = (au, al)
        if b.skip_mode:
            b.is_inter = 1
        elif self._seg_feat(b, SEG_REF_FRAME):
            b.is_inter = int(f.seg_feature[b.seg][SEG_REF_FRAME] != 0)
        elif self._seg_feat(b, SEG_GLOBALMV):
            b.is_inter = 1
        else:
            ai = au is not None and au[0] <= 0
            li = al is not None and al[0] <= 0
            if au is not None and al is not None:
                ctx = 3 if ai and li else int(ai or li)
            elif au is not None or al is not None:
                ctx = 2 * int(ai if au is not None else li)
            else:
                ctx = 0
            b.is_inter = rd.symbol(cdf.is_inter[ctx])
        if b.is_inter:
            self._inter_block_info(b)
        else:
            self._intra_info(b)

    def _inter_segment_id(self, b, pre_skip):
        f = self.f
        if not f.seg_enabled:
            b.seg = 0
            return
        bw4, bh4 = BLOCK_WH[b.size]
        if self.prev_seg is None:
            pred = 0
        else:
            pred = int(self.prev_seg[b.r:min(self.mi_rows, b.r + bh4),
                                     b.c:min(self.mi_cols, b.c + bw4)].min())
        if not f.seg_update_map:
            b.seg = pred
            return
        if pre_skip and not f.seg_id_pre_skip:
            b.seg = 0
            return
        if not pre_skip and b.skip:
            self._seg_pred_ctx(b, 0)
            b.seg = self._segment_id(b)
            return
        if f.seg_temporal_update:
            ctx = self.left_seg_pred[b.r] + self.above_seg_pred[b.c]
            flag = self.r.symbol(self.cdf.seg_pred[ctx])
            b.seg = pred if flag else self._segment_id(b)
            self._seg_pred_ctx(b, flag)
        else:
            b.seg = self._segment_id(b)

    def _seg_pred_ctx(self, b, flag):
        bw4, bh4 = BLOCK_WH[b.size]
        self.above_seg_pred[b.c:b.c + bw4] = [flag] * bw4
        self.left_seg_pred[b.r:b.r + bh4] = [flag] * bh4

    def _count_refs(self, b):
        n = [0] * 8
        for nb in b.nb:
            if nb is not None and nb[0] > 0:
                n[nb[0]] += 1
                if nb[1] > 0:
                    n[nb[1]] += 1
        return n

    def _read_ref_frames(self, b):
        """read_ref_frames: skip mode's pair, a segment's reference, or
        single / compound (uni- or bidirectional) references read with
        their neighbours' counts as contexts."""
        f, rd, cdf = self.f, self.r, self.cdf
        if b.skip_mode:
            return f.skip_mode_frame
        if self._seg_feat(b, SEG_REF_FRAME):
            return f.seg_feature[b.seg][SEG_REF_FRAME], -1
        if self._seg_feat(b, SEG_SKIP) or self._seg_feat(b, SEG_GLOBALMV):
            return LAST, -1
        bw4, bh4 = BLOCK_WH[b.size]
        n = self._count_refs(b)

        def cc(a, bb):
            return 0 if a < bb else 1 if a == bb else 2
        comp = 0
        if f.reference_select and min(bw4, bh4) >= 2:
            comp = rd.symbol(cdf.comp_mode[self._comp_mode_ctx(b)])
        if comp:
            if rd.symbol(cdf.comp_ref_type[self._comp_ref_type_ctx(b)]):
                ctx = cc(n[1] + n[2], n[3] + n[4])
                if not rd.symbol(cdf.comp_ref[ctx][0]):
                    r0 = LAST2 if rd.symbol(
                        cdf.comp_ref[cc(n[1], n[2])][1]) else LAST
                else:
                    r0 = GOLDEN if rd.symbol(
                        cdf.comp_ref[cc(n[3], n[4])][2]) else LAST3
                if not rd.symbol(cdf.comp_bwd_ref[cc(n[5] + n[6],
                                                     n[7])][0]):
                    r1 = ALTREF2 if rd.symbol(
                        cdf.comp_bwd_ref[cc(n[5], n[6])][1]) else BWDREF
                else:
                    r1 = ALTREF
                return r0, r1
            ctx = cc(n[1] + n[2] + n[3] + n[4], n[5] + n[6] + n[7])
            if rd.symbol(cdf.uni_comp_ref[ctx][0]):
                return BWDREF, ALTREF
            if rd.symbol(cdf.uni_comp_ref[cc(n[2], n[3] + n[4])][1]):
                if rd.symbol(cdf.uni_comp_ref[cc(n[3], n[4])][2]):
                    return LAST, GOLDEN
                return LAST, LAST3
            return LAST, LAST2
        if rd.symbol(cdf.single_ref[cc(n[1] + n[2] + n[3] + n[4],
                                       n[5] + n[6] + n[7])][0]):
            if not rd.symbol(cdf.single_ref[cc(n[5] + n[6], n[7])][1]):
                return (ALTREF2 if rd.symbol(cdf.single_ref[cc(
                    n[5], n[6])][5]) else BWDREF), -1
            return ALTREF, -1
        if rd.symbol(cdf.single_ref[cc(n[1] + n[2], n[3] + n[4])][2]):
            return (GOLDEN if rd.symbol(cdf.single_ref[cc(
                n[3], n[4])][4]) else LAST3), -1
        return (LAST2 if rd.symbol(cdf.single_ref[cc(n[1], n[2])][3])
                else LAST), -1

    def _comp_mode_ctx(self, b):
        au, al = b.nb

        def bwd(rf):
            return int(rf[0] >= BWDREF)
        if au is not None and al is not None:
            if au[1] <= 0 and al[1] <= 0:
                return bwd(au) ^ bwd(al)
            if au[1] <= 0:
                return 2 + int(bwd(au) or au[0] <= 0)
            if al[1] <= 0:
                return 2 + int(bwd(al) or al[0] <= 0)
            return 4
        e = au if au is not None else al
        if e is not None:
            return bwd(e) if e[1] <= 0 else 3
        return 1

    def _comp_ref_type_ctx(self, b):
        au, al = b.nb

        def uni(rf):
            return rf[1] > 0 and (rf[0] >= BWDREF) == (rf[1] >= BWDREF)

        def same(a, bb):
            return int((a[0] >= BWDREF) == (bb[0] >= BWDREF))
        if au is not None and al is not None:
            ai, li = au[0] <= 0, al[0] <= 0
            if ai and li:
                return 2
            if ai or li:
                e = al if ai else au
                return 2 if e[1] <= 0 else 1 + 2 * uni(e)
            asg, lsg = au[1] <= 0, al[1] <= 0
            if asg and lsg:
                return 1 + 2 * same(au, al)
            if asg or lsg:
                if not uni(al if asg else au):
                    return 1
                return 3 + same(au, al)
            ua, ul = uni(au), uni(al)
            if not ua and not ul:
                return 0
            if not ua or not ul:
                return 2
            return 3 + int((au[0] == BWDREF) == (al[0] == BWDREF))
        e = au if au is not None else al
        if e is not None:
            if e[0] <= 0 or e[1] <= 0:
                return 2
            return 4 * uni(e)
        return 2

    def _inter_block_info(self, b):
        """inter_block_mode_info: references, the MV stack, the mode, the
        dynamic reference list index, the MVs (read_mv for a new one),
        inter-intra, the motion mode (OBMC, local warp with its samples),
        the compound type and the interpolation filters."""
        f, s, rd, cdf = self.f, self.s, self.r, self.cdf
        bw4, bh4 = BLOCK_WH[b.size]
        b.y_mode = NEARESTMV
        b.uv_mode = R.DC_PRED
        b.angle_y = b.angle_uv = 0
        b.cfl_u = b.cfl_v = 0
        b.filter_intra = -1
        b.dv = (0, 0)
        b.ref_frame = self._read_ref_frames(b)
        comp = int(b.ref_frame[1] > 0)
        st = av1_mvs.find_mv_stack(self, b, b.ref_frame, BLOCK_WH)
        if b.skip_mode:
            b.y_mode = NEAREST_NEARESTMV
        elif self._seg_feat(b, SEG_SKIP) or self._seg_feat(b, SEG_GLOBALMV):
            b.y_mode = GLOBALMV
        elif comp:
            ctx = COMPOUND_MODE_CTX[st.ref_ctx >> 1][min(st.new_ctx, 4)]
            b.y_mode = NEAREST_NEARESTMV + rd.symbol(cdf.compound_mode[ctx])
        elif rd.symbol(cdf.new_mv[st.new_ctx]) == 0:
            b.y_mode = NEWMV
        elif rd.symbol(cdf.zero_mv[st.zero_ctx]) == 0:
            b.y_mode = GLOBALMV
        else:
            b.y_mode = NEARMV if rd.symbol(cdf.ref_mv[st.ref_ctx]) else \
                NEARESTMV
        ref_idx = 0
        if b.y_mode in (NEWMV, NEW_NEWMV):
            for idx in (0, 1):
                if st.num > idx + 1:
                    if not rd.symbol(cdf.drl[st.drl_ctx[idx]]):
                        ref_idx = idx
                        break
                    ref_idx = idx + 1
        elif b.y_mode in _HAS_NEAR:
            ref_idx = 1
            for idx in (1, 2):
                if st.num > idx + 1:
                    if not rd.symbol(cdf.drl[st.drl_ctx[idx]]):
                        ref_idx = idx
                        break
                    ref_idx = idx + 1
        mv = []
        for i in range(1 + comp):
            mode = _MODE_OF[b.y_mode][i]
            if mode == GLOBALMV:
                pred = st.gmv[i]
            else:
                pos = 0 if mode == NEARESTMV else ref_idx
                if mode == NEWMV and st.num <= 1:
                    pos = 0
                pred = st.mvs[pos][i]
            if mode == NEWMV:
                pred = av1_mvs.read_mv(rd, cdf.mv[0], pred,
                                       f.allow_high_precision_mv,
                                       f.force_integer_mv)
            mv.append(pred)
        b.mv = (mv[0], mv[1] if comp else ZERO)
        # inter-intra
        if not b.skip_mode and s.enable_interintra_compound and not comp \
                and BLOCK_8X8 <= b.size <= BLOCK_32X32:
            grp = SIZE_GROUP[b.size]
            b.interintra = rd.symbol(cdf.interintra[grp])
            if b.interintra:
                b.ii_mode = rd.symbol(cdf.interintra_mode[grp])
                b.ref_frame = (b.ref_frame[0], 0)
                b.wedge_ii = rd.symbol(cdf.wedge_interintra[b.size])
                if b.wedge_ii:
                    b.wedge_index = rd.symbol(cdf.wedge_idx[b.size])
                    b.wedge_sign = 0
        # motion mode
        b.motion_mode = SIMPLE
        if not b.skip_mode and f.is_motion_mode_switchable and \
                min(bw4, bh4) >= 2 and not (
                    not f.force_integer_mv and
                    b.y_mode in (GLOBALMV, GLOBAL_GLOBALMV) and
                    f.gm_type[b.ref_frame[0]] > TRANSLATION) and \
                not comp and b.ref_frame[1] != 0 and self._overlappable(b):
            b.samples = av1_mvs.warp_samples(self, b, b.mv[0], BLOCK_WH)
            if f.force_integer_mv or not b.samples or \
                    not f.allow_warped_motion or \
                    self.scales[b.ref_frame[0]] != (1 << 14, 1 << 14):
                b.motion_mode = OBMC if rd.symbol(cdf.obmc[b.size]) else \
                    SIMPLE
            else:
                b.motion_mode = rd.symbol(cdf.motion_mode[b.size])
        # compound type
        b.compound_type = av1_inter.COMPOUND_AVERAGE
        if b.skip_mode:
            pass
        elif comp:
            if s.enable_masked_compound:
                b.comp_group_idx = rd.symbol(cdf.comp_group_idx[
                    self._comp_group_ctx(b)])
            if b.comp_group_idx == 0:
                if s.enable_jnt_comp:
                    b.compound_idx = rd.symbol(cdf.compound_idx[
                        self._compound_idx_ctx(b)])
                    if not b.compound_idx:
                        b.compound_type = av1_inter.COMPOUND_DISTANCE
            elif b.size not in WEDGE_SIZES:
                b.compound_type = av1_inter.COMPOUND_DIFFWTD
            else:
                b.compound_type = rd.symbol(cdf.compound_type[b.size])
            if b.compound_type == av1_inter.COMPOUND_WEDGE:
                b.wedge_index = rd.symbol(cdf.wedge_idx[b.size])
                b.wedge_sign = rd.literal(1)
            elif b.compound_type == av1_inter.COMPOUND_DIFFWTD:
                b.mask_type = rd.literal(1)
        elif b.interintra:
            b.compound_type = av1_inter.COMPOUND_WEDGE if b.wedge_ii \
                else av1_inter.COMPOUND_INTRA
        # interpolation filters
        if f.interpolation_filter == SWITCHABLE:
            filt = [0, 0]
            for d in range(2 if s.enable_dual_filter else 1):
                if self._needs_interp(b):
                    filt[d] = rd.symbol(cdf.interp[self._interp_ctx(b, d)])
            if not s.enable_dual_filter:
                filt[1] = filt[0]
            b.interp = tuple(filt)
        else:
            b.interp = (f.interpolation_filter, f.interpolation_filter)

    def _overlappable(self, b):
        """has_overlappable_candidates: an inter block above or left."""
        bw4, bh4 = BLOCK_WH[b.size]
        if b.avail_u:
            for x4 in range(b.c, min(self.mi_cols, b.c + bw4), 2):
                x5 = min(x4 | 1, self.mi_cols - 1)
                if self.ref_frames[b.r - 1][x5][0] > 0:
                    return True
        if b.avail_l:
            for y4 in range(b.r, min(self.mi_rows, b.r + bh4), 2):
                y5 = min(y4 | 1, self.mi_rows - 1)
                if self.ref_frames[y5][b.c - 1][0] > 0:
                    return True
        return False

    def _comp_group_ctx(self, b):
        ctx = 0
        for nb, (rr, cc) in zip(b.nb, ((b.r - 1, b.c), (b.r, b.c - 1))):
            if nb is None:
                continue
            if nb[1] > 0:
                ctx += self.comp_groups[rr][cc]
            elif nb[0] == ALTREF:
                ctx += 3
        return min(5, ctx)

    def _compound_idx_ctx(self, b):
        f = self.f
        fwd = abs(get_relative_dist(self.s, f.order_hints[b.ref_frame[1]],
                                    f.order_hint))
        bck = abs(get_relative_dist(self.s, f.order_hint,
                                    f.order_hints[b.ref_frame[0]]))
        ctx = 3 * int(fwd == bck)
        for nb, (rr, cc) in zip(b.nb, ((b.r - 1, b.c), (b.r, b.c - 1))):
            if nb is None:
                continue
            if nb[1] > 0:
                ctx += self.compound_idxs[rr][cc]
            elif nb[0] == ALTREF:
                ctx += 1
        return ctx

    def _needs_interp(self, b):
        f = self.f
        bw4, bh4 = BLOCK_WH[b.size]
        large = min(bw4, bh4) >= 2
        if b.skip_mode or b.motion_mode == LOCALWARP:
            return False
        if large and b.y_mode == GLOBALMV:
            return f.gm_type[b.ref_frame[0]] == TRANSLATION
        if large and b.y_mode == GLOBAL_GLOBALMV:
            return f.gm_type[b.ref_frame[0]] == TRANSLATION or \
                f.gm_type[b.ref_frame[1]] == TRANSLATION
        return True

    def _interp_ctx(self, b, d):
        ctx = ((d & 1) * 2 + int(b.ref_frame[1] > 0)) * 4
        ref = b.ref_frame[0]
        types = []
        for nb, (rr, cc) in zip((b.nb[1], b.nb[0]),
                                ((b.r, b.c - 1), (b.r - 1, b.c))):
            t = 3
            if nb is not None and (nb[0] == ref or nb[1] == ref):
                t = self.interps[rr][cc][d]
            types.append(t)
        lt, at = types
        if lt == at:
            return ctx + lt
        if lt == 3:
            return ctx + at
        if at == 3:
            return ctx + lt
        return ctx + 3

    # ------------------------------------------------- inter prediction
    def _ref_pred(self, p, x, y, w, h, ref, mv, filt, comp, warp=None):
        """One reference's prediction of a plane block: warped where
        `warp` (parameters, shear) is given, else by its MV."""
        sx = self.ssx if p else 0
        sy = self.ssy if p else 0
        slot = self.ref_slots[ref]
        plane = slot.planes[p]
        wh = (slot.frame.upscaled_width, slot.frame.height)
        if warp is not None:
            return av1_inter.warp(plane, x, y, w, h, warp[0], warp[1], sx,
                                  sy, wh, self.bd, comp)
        return av1_inter.predict(plane, x, y, w, h, mv, sx, sy,
                                 self.scales[ref], wh, filt, self.bd, comp)

    def _warp_of(self, b, ref, w, h):
        """The warp an 8 x 8 or larger plane block takes: local warp's
        where its fit is valid, global motion's for a global mode."""
        if w < 8 or h < 8 or self.f.force_integer_mv:
            return None
        if b.motion_mode == LOCALWARP and b.local is not None:
            return b.local
        if b.y_mode in (GLOBALMV, GLOBAL_GLOBALMV) and \
                self.gm_warp[ref] is not None:
            return self.f.gm_params[ref], self.gm_warp[ref]
        return None

    def _inter_predict(self, b):
        """compute_prediction of an inter block: each plane predicted
        (a subsampled block's chroma from each of the blocks it covers,
        unless one is intra), then combined (compound average, distance
        weights, wedge or difference-weighted mask), blended with its
        intra prediction (inter-intra) and with its neighbours' (OBMC)."""
        bd = self.bd
        bw4, bh4 = BLOCK_WH[b.size]
        comp = b.ref_frame[1] > 0
        b.local = None
        if b.motion_mode == LOCALWARP:
            p = av1_inter.warp_estimate(b.samples, b.r, b.c, bw4, bh4,
                                        b.mv[0])
            if p is not None:
                sh = av1_inter.setup_shear(p)
                if sh[0]:
                    b.local = (p, sh)
        mask = None
        for p in range(1 + 2 * b.has_chroma):
            sx = self.ssx if p else 0
            sy = self.ssy if p else 0
            pw4, ph4 = BLOCK_WH[self._plane_bsize(b.size, p)]
            pw, ph = pw4 * 4, ph4 * 4
            bx, by = (b.c >> sx) * 4, (b.r >> sy) * 4
            cr, cc = (b.r >> sy) << sy, (b.c >> sx) << sx
            step_w, step_h = (bw4 * 4) >> sx, (bh4 * 4) >> sy
            if any(self.ref_frames[cr + y][cc + x][0] <= 0
                   for y in range(ph4 << sy) for x in range(pw4 << sx)):
                step_w, step_h, cr, cc = pw, ph, b.r, b.c
            if step_w < pw or step_h < ph:
                out = np.zeros((ph, pw), np.int64)
                for i, y in enumerate(range(0, ph, step_h)):
                    for j, x in enumerate(range(0, pw, step_w)):
                        rf = self.ref_frames[cr + i][cc + j]
                        out[y:y + step_h, x:x + step_w] = self._ref_pred(
                            p, bx + x, by + y, step_w, step_h, rf[0],
                            self.mvs[cr + i][cc + j][0],
                            self.interps[cr + i][cc + j], False)
            else:
                preds = [self._ref_pred(
                    p, bx, by, pw, ph, b.ref_frame[i], b.mv[i], b.interp,
                    comp, self._warp_of(b, b.ref_frame[i], pw, ph))
                    for i in range(1 + comp)]
                if comp:
                    out, mask = self._combine(b, p, preds, mask)
                else:
                    out = preds[0]
            if b.interintra:
                out = self._interintra(b, p, bx, by, pw, ph, out)
            if b.motion_mode == OBMC:
                out = self._obmc(b, p, bx, by, pw, ph, out)
            self.frame[p][by:by + ph, bx:bx + pw] = out

    def _combine(self, b, p, preds, mask):
        bd = self.bd
        sx = self.ssx if p else 0
        sy = self.ssy if p else 0
        _, _, post = av1_inter.rounding(bd, True)
        p0, p1 = preds
        t = b.compound_type
        pmax = (1 << bd) - 1
        if t in (av1_inter.COMPOUND_WEDGE, av1_inter.COMPOUND_DIFFWTD):
            if p == 0:
                bw4, bh4 = BLOCK_WH[b.size]
                if t == av1_inter.COMPOUND_WEDGE:
                    mask = av1_inter.wedge_mask(bw4 * 4, bh4 * 4,
                                                b.wedge_sign, b.wedge_index)
                else:
                    mask = av1_inter.diff_mask(p0, p1, b.mask_type, bd, post)
                m = mask
            else:
                m = av1_inter.subsample(mask, sx, sy)
            out = (m * p0 + (64 - m) * p1 + (1 << (5 + post))) >> (6 + post)
        elif t == av1_inter.COMPOUND_DISTANCE:
            fw, bw = av1_inter.distance_weights(self.s, self.f, b.ref_frame)
            out = (fw * p0 + bw * p1 + (1 << (3 + post))) >> (4 + post)
        else:
            out = (p0 + p1 + (1 << post)) >> (1 + post)
        return np.clip(out, 0, pmax), mask

    def _interintra(self, b, p, x, y, w, h, inter):
        """Inter-intra: the block's intra prediction (DC, V, H or smooth)
        blended in by the smooth mask of its mode or a wedge."""
        sx = self.ssx if p else 0
        sy = self.ssy if p else 0
        max_x = (self.mi_cols * 4) >> sx
        max_y = (self.mi_rows * 4) >> sy
        have_l = b.avail_l if p == 0 else b.avail_lc
        have_a = b.avail_u if p == 0 else b.avail_uc
        intra = self._predict(b, p, x, y, w, h, II_MODE[b.ii_mode], have_l,
                              have_a, False, False, max_x, max_y)
        if b.wedge_ii:
            bw4, bh4 = BLOCK_WH[b.size]
            m = av1_inter.wedge_mask(bw4 * 4, bh4 * 4, 0, b.wedge_index)
            m = av1_inter.subsample(m, sx, sy)
        else:
            m = av1_inter.ii_mask(b.ii_mode, w, h)
        return (inter * (64 - m) + intra * m + 32) >> 6

    def _obmc(self, b, p, x, y, w, h, cur):
        """OBMC as dav1d runs it: the above neighbours' predictions of
        the block's first rows (not for chroma blocks under 8 x 8 in
        sum of sides 16), then the left ones' of its first columns."""
        sx = self.ssx if p else 0
        sy = self.ssy if p else 0
        bw4, bh4 = BLOCK_WH[b.size]
        hm, vm = 4 >> sx, 4 >> sy
        cur = cur.copy()
        if b.avail_u and (p == 0 or bw4 * hm + bh4 * vm >= 16):
            n, xx = 0, 0
            while xx < bw4 and n < min(bw4.bit_length() - 1, 4):
                rr, cc = b.r - 1, b.c + xx + 1
                step = max(2, min(16, BLOCK_WH[self.mi_size[rr][cc]][0]))
                rf = self.ref_frames[rr][cc]
                if rf[0] > 0:
                    ow4, oh4 = min(step, bw4), min(bh4, 16) >> 1
                    nb = self._ref_pred(p, x + xx * hm, y, ow4 * hm,
                                        oh4 * vm, rf[0], self.mvs[rr][cc][0],
                                        self.interps[rr][cc], False)
                    seg = cur[:oh4 * vm, xx * hm:xx * hm + ow4 * hm]
                    cur[:oh4 * vm, xx * hm:xx * hm + ow4 * hm] = \
                        av1_inter.obmc_blend(seg, nb, True)
                    n += 1
                xx += step
        if b.avail_l:
            n, yy = 0, 0
            while yy < bh4 and n < min(bh4.bit_length() - 1, 4):
                rr, cc = b.r + yy + 1, b.c - 1
                step = max(2, min(16, BLOCK_WH[self.mi_size[rr][cc]][1]))
                rf = self.ref_frames[rr][cc]
                if rf[0] > 0:
                    ow4, oh4 = min(bw4, 16) >> 1, min(step, bh4)
                    nb = self._ref_pred(p, x, y + yy * vm, ow4 * hm,
                                        oh4 * vm, rf[0], self.mvs[rr][cc][0],
                                        self.interps[rr][cc], False)
                    seg = cur[yy * vm:yy * vm + oh4 * vm, :ow4 * hm]
                    cur[yy * vm:yy * vm + oh4 * vm, :ow4 * hm] = \
                        av1_inter.obmc_blend(seg, nb, False)
                    n += 1
                yy += step
        return cur

    def _intrabc_info(self, b):
        """An intra block copy block: its DV; DC_PRED for the neighbours'
        mode contexts, no palette, CfL or filter intra."""
        b.y_mode = b.uv_mode = R.DC_PRED
        b.angle_y = b.angle_uv = 0
        b.cfl_u = b.cfl_v = 0
        b.filter_intra = -1
        dv = av1_intrabc.read_dv(self.r, self.cdf, av1_intrabc.pred_dv(
            self, b, BLOCK_WH))
        b.dv = av1_intrabc.clip_dv(self, b, dv, BLOCK_WH)
        b.mv = (b.dv, ZERO)

    def _intrabc_predict(self, b):
        """compute_prediction of an intrabc block: each plane's block
        (a subsampled block's chroma whole, with its own DV) predicted
        from the frame before filtering through the bilinear filter at
        unit scale."""
        f = self.f
        for p in range(1 + 2 * b.has_chroma):
            sx = self.ssx if p else 0
            sy = self.ssy if p else 0
            pw4, ph4 = BLOCK_WH[self._plane_bsize(b.size, p)]
            x, y = (b.c >> sx) * 4, (b.r >> sy) * 4
            self.frame[p][y:y + 4 * ph4, x:x + 4 * pw4] = \
                av1_inter.predict(self.frame[p], x, y, 4 * pw4, 4 * ph4,
                                  b.dv, sx, sy, (1 << 14, 1 << 14),
                                  (f.width, f.height),
                                  (av1_inter.BILINEAR, av1_inter.BILINEAR),
                                  self.bd, False)

    def _intra_info(self, b):
        """intra_frame_mode_info's intra half (intra_block_mode_info in an
        inter frame, whose y mode's context is the block's size): the y
        mode and angle, the uv mode with CfL alphas and angle, palettes,
        filter intra."""
        rd, cdf, f = self.r, self.cdf, self.f
        r, c, bsize = b.r, b.c, b.size
        bw4, bh4 = BLOCK_WH[bsize]
        b.dv = (0, 0)
        if f.intra:
            above = self.y_mode[r - 1][c] if b.avail_u else 0
            left = self.y_mode[r][c - 1] if b.avail_l else 0
            b.y_mode = rd.symbol(cdf.kf_y[INTRA_MODE_CONTEXT[above]]
                                 [INTRA_MODE_CONTEXT[left]])
        else:
            b.y_mode = rd.symbol(cdf.y_mode[SIZE_GROUP[bsize]])
        b.angle_y = b.angle_uv = 0
        if bsize >= BLOCK_8X8 and 1 <= b.y_mode <= 8:
            b.angle_y = rd.symbol(cdf.angle[b.y_mode - 1]) - 3
        b.uv_mode = 0
        b.cfl_u = b.cfl_v = 0
        if b.has_chroma:
            if b.lossless and self._plane_bsize(bsize, 1) == BLOCK_4X4:
                cfl_allowed = 1
            elif not b.lossless and max(bw4, bh4) <= 8:
                cfl_allowed = 1
            else:
                cfl_allowed = 0
            b.uv_mode = rd.symbol(cdf.uv[cfl_allowed][b.y_mode])
            if b.uv_mode == R.UV_CFL:
                signs = rd.symbol(cdf.cfl_sign)
                su, sv = (signs + 1) // 3, (signs + 1) % 3
                if su:
                    a = rd.symbol(cdf.cfl_alpha[(su - 1) * 3 + sv]) + 1
                    b.cfl_u = -a if su == 1 else a
                if sv:
                    a = rd.symbol(cdf.cfl_alpha[(sv - 1) * 3 + su]) + 1
                    b.cfl_v = -a if sv == 1 else a
            if bsize >= BLOCK_8X8 and 1 <= b.uv_mode <= 8:
                b.angle_uv = rd.symbol(cdf.angle[b.uv_mode - 1]) - 3
        if bsize >= BLOCK_8X8 and bw4 <= 16 and bh4 <= 16 and \
                f.allow_screen_content_tools:
            self._palette_mode_info(b)
        b.filter_intra = -1
        if self.s.enable_filter_intra and b.y_mode == 0 and \
                b.pal_y == 0 and max(bw4, bh4) <= 8:
            if rd.symbol(cdf.filter_intra[bsize]):
                b.filter_intra = rd.symbol(cdf.filter_mode)

    def _plane_bsize(self, bsize, plane):
        w, h = BLOCK_WH[bsize]
        if plane:
            w, h = max(1, w >> self.ssx), max(1, h >> self.ssy)
        return BLOCK_BY_WH[(w, h)]

    def _segment_id(self, b):
        f = self.f
        if not f.seg_enabled:
            return 0
        r, c = b.r, b.c
        ul = self.seg_ids[r - 1][c - 1] if b.avail_u and b.avail_l else -1
        u = self.seg_ids[r - 1][c] if b.avail_u else -1
        lf = self.seg_ids[r][c - 1] if b.avail_l else -1
        if u == -1:
            pred = 0 if lf == -1 else lf
        elif lf == -1:
            pred = u
        else:
            pred = u if ul == u else lf
        if b.skip:
            return pred
        if ul < 0:
            ctx = 0
        elif ul == u and ul == lf:
            ctx = 2
        elif ul == u or ul == lf or u == lf:
            ctx = 1
        else:
            ctx = 0
        v = self.r.symbol(self.cdf.segment[ctx])
        mx = f.last_active_seg_id + 1
        v = _neg_deinterleave(v, pred, mx)
        return max(0, min(f.last_active_seg_id, v))

    def _read_cdef(self, b):
        """read_cdef: the 64 x 64's index, once, at its first non-skip
        block (each 64 x 64 a block of 128 covers)."""
        r64, c64 = b.r >> 4, b.c >> 4
        if self.cdef_idx[r64, c64] == -1:
            bw4, bh4 = BLOCK_WH[b.size]
            self.cdef_idx[r64:r64 + max(1, bh4 >> 4),
                          c64:c64 + max(1, bw4 >> 4)] = \
                self.r.literal(self.f.cdef_bits)

    def _delta_q_lf(self, b):
        f, rd = self.f, self.r
        if b.size == self.sb_size and b.skip:
            return
        if not self.read_deltas:
            return
        a = rd.symbol(self.cdf.delta_q)
        if a == 3:
            n = rd.literal(3) + 1
            a = rd.literal(n) + (1 << n) + 1
        if a:
            a = -a if rd.literal(1) else a
            self.current_q = max(1, min(255, self.current_q +
                                        (a << f.delta_q_res)))
        if f.delta_lf_present:
            # DeltaLF: one, or one a level with delta_lf_multi, kept
            # across the tile's blocks (the deblocking levels of this
            # block and those after it)
            cnt = (4 if self.planes > 1 else 2) if f.delta_lf_multi else 1
            for i in range(cnt):
                cd = self.cdf.delta_lf_multi[i] if f.delta_lf_multi else \
                    self.cdf.delta_lf
                a = rd.symbol(cd)
                if a == 3:
                    n = rd.literal(3) + 1
                    a = rd.literal(n) + (1 << n) + 1
                if a and rd.literal(1):
                    a = -a
                self.delta_lf[i] = max(-63, min(63, self.delta_lf[i] +
                                                (a << f.delta_lf_res)))
            self.lf_id = self.lf_sets.setdefault(tuple(self.delta_lf),
                                                 len(self.lf_sets))

    # ----------------------------------------------------------- palette
    def _palette_cache(self, b, plane):
        r, c = b.r, b.c
        above_n = self.pal_sizes[plane][r - 1][c] \
            if (r * 4) % 64 and b.avail_u else 0
        left_n = self.pal_sizes[plane][r][c - 1] if b.avail_l else 0
        ac = self.pal_colors[plane][r - 1][c] if above_n else ()
        lc = self.pal_colors[plane][r][c - 1] if left_n else ()
        ai = li = 0
        cache: List[int] = []
        while ai < above_n and li < left_n:
            a, lv = ac[ai], lc[li]
            if lv < a:
                if not cache or lv != cache[-1]:
                    cache.append(lv)
                li += 1
            else:
                if not cache or a != cache[-1]:
                    cache.append(a)
                ai += 1
                if lv == a:
                    li += 1
        for v in list(ac[ai:above_n]) + list(lc[li:left_n]):
            if not cache or v != cache[-1]:
                cache.append(v)
        return cache

    def _palette_mode_info(self, b):
        rd, cdf = self.r, self.cdf
        bw4, bh4 = BLOCK_WH[b.size]
        bctx = (bw4.bit_length() - 1) + (bh4.bit_length() - 1) - 2
        if b.y_mode == 0:
            ctx = int(b.avail_u and self.pal_sizes[0][b.r - 1][b.c] > 0) + \
                int(b.avail_l and self.pal_sizes[0][b.r][b.c - 1] > 0)
            if rd.symbol(cdf.pal_y_mode[bctx][ctx]):
                b.pal_y = rd.symbol(cdf.pal_size[0][bctx]) + 2
                b.pal_colors[0] = self._palette_colors(b, 0, b.pal_y)
        if b.has_chroma and b.uv_mode == 0:
            if rd.symbol(cdf.pal_uv_mode[int(b.pal_y > 0)]):
                b.pal_uv = rd.symbol(cdf.pal_size[1][bctx]) + 2
                n = b.pal_uv
                b.pal_colors[1] = self._palette_colors(b, 1, n)
                bd = self.bd
                if rd.literal(1):
                    bits = bd - 4 + rd.literal(2)
                    v = [rd.literal(bd)]
                    for _ in range(1, n):
                        d = rd.literal(bits)
                        if d and rd.literal(1):
                            d = -d
                        val = v[-1] + d
                        if val < 0:
                            val += 1 << bd
                        if val >= 1 << bd:
                            val -= 1 << bd
                        v.append(max(0, min((1 << bd) - 1, val)))
                else:
                    v = [rd.literal(bd) for _ in range(n)]
                b.pal_colors[2] = tuple(v)

    def _palette_colors(self, b, plane, n):
        rd, bd = self.r, self.bd
        cache = self._palette_cache(b, plane)
        colors = []
        for v in cache:
            if len(colors) >= n:
                break
            if rd.literal(1):
                colors.append(v)
        if len(colors) < n:
            colors.append(rd.literal(bd))
            if len(colors) < n:
                bits = bd - 3 + rd.literal(2)
                while len(colors) < n:
                    d = rd.literal(bits)
                    if plane == 0:
                        d += 1
                    v = max(0, min((1 << bd) - 1, colors[-1] + d))
                    colors.append(v)
                    rng = (1 << bd) - v - (1 if plane == 0 else 0)
                    bits = min(bits, (rng - 1).bit_length() if rng > 1
                               else 0)
        return tuple(sorted(colors))

    def _palette_tokens(self, b):
        bw4, bh4 = BLOCK_WH[b.size]
        b.color_map = [None, None]
        bh, bw = bh4 * 4, bw4 * 4
        on_h = min(bh, (self.mi_rows - b.r) * 4)
        on_w = min(bw, (self.mi_cols - b.c) * 4)
        if b.pal_y:
            b.color_map[0] = self._color_map(b.pal_y, bw, bh, on_w, on_h,
                                             self.cdf.pal_color[0])
        if b.pal_uv:
            bw, bh = bw >> self.ssx, bh >> self.ssy
            on_w, on_h = on_w >> self.ssx, on_h >> self.ssy
            if bw < 4:
                bw += 2
                on_w += 2
            if bh < 4:
                bh += 2
                on_h += 2
            b.color_map[1] = self._color_map(b.pal_uv, bw, bh, on_w, on_h,
                                             self.cdf.pal_color[1])

    def _color_map(self, n, bw, bh, on_w, on_h, cdfs):
        rd = self.r
        m = [[0] * bw for _ in range(bh)]
        m[0][0] = rd.ns(n)
        cd = cdfs[n - 2]
        for i in range(1, on_h + on_w - 1):
            for j in range(min(i, on_w - 1), max(0, i - on_h + 1) - 1, -1):
                r, c = i - j, j
                scores = [0] * 8
                order = list(range(8))
                if c > 0:
                    scores[m[r][c - 1]] += 2
                if r > 0 and c > 0:
                    scores[m[r - 1][c - 1]] += 1
                if r > 0:
                    scores[m[r - 1][c]] += 2
                for k in range(3):
                    best, bi = scores[k], k
                    for t in range(k + 1, n):
                        if scores[t] > best:
                            best, bi = scores[t], t
                    if bi != k:
                        bo = order[bi]
                        for t in range(bi, k, -1):
                            scores[t] = scores[t - 1]
                            order[t] = order[t - 1]
                        scores[k], order[k] = best, bo
                hsh = scores[0] + 2 * scores[1] + 2 * scores[2]
                ctx = PALETTE_COLOR_CONTEXT[hsh]
                m[r][c] = order[rd.symbol(cd[ctx])]
        for i in range(on_h):
            for j in range(on_w, bw):
                m[i][j] = m[i][on_w - 1]
        for i in range(on_h, bh):
            m[i] = list(m[on_h - 1])
        return np.array(m, np.int64)

    # ---------------------------------------------------------- tx size
    def _read_tx_size(self, b):
        """read_block_tx_size: an intrabc block's transform tree
        (txfm_split) where it has residual and the frame selects sizes;
        otherwise the one size, its depth read for an intra block."""
        f = self.f
        b.var_tx = 0
        if b.lossless:
            b.tx_size = TX_4X4
            return
        mx = MAX_TX_RECT[b.size]
        b.tx_size = mx
        if b.is_inter and not b.skip and f.tx_mode_select and \
                b.size > BLOCK_4X4:
            b.var_tx = 1
            bw4, bh4 = BLOCK_WH[b.size]
            tw4, th4 = TX_WH[mx][0] >> 2, TX_WH[mx][1] >> 2
            for row in range(b.r, b.r + bh4, th4):
                for col in range(b.c, b.c + bw4, tw4):
                    self._read_var_tx(b, row, col, mx, 0)
            return
        if b.size > BLOCK_4X4 and f.tx_mode_select and not b.is_inter:
            depth_max = MAX_TX_DEPTH[b.size]
            tw, th = TX_WH[mx]
            r, c = b.r, b.c
            if b.avail_u and self.is_inter[r - 1][c]:
                aw = BLOCK_WH[self.mi_size[r - 1][c]][0] * 4
            else:
                aw = TX_WH[self.tx_sizes[r - 1][c]][0] if b.avail_u else 0
            if b.avail_l and self.is_inter[r][c - 1]:
                lh = BLOCK_WH[self.mi_size[r][c - 1]][1] * 4
            else:
                lh = TX_WH[self.tx_sizes[r][c - 1]][1] if b.avail_l else 0
            ctx = int(aw >= tw) + int(lh >= th)
            d = self.r.symbol(self.cdf.tx_depth[depth_max - 1][ctx])
            for _ in range(d):
                b.tx_size = SPLIT_TX[b.tx_size]

    def _read_var_tx(self, b, row, col, tx, depth):
        """read_var_tx_size: split while txfm_split says so (twice at
        most), the leaves' sizes into InterTxSizes."""
        if row >= self.mi_rows or col >= self.mi_cols:
            return
        tw4, th4 = TX_WH[tx][0] >> 2, TX_WH[tx][1] >> 2
        split = 0
        if tx != TX_4X4 and depth < 2:
            bw4, bh4 = BLOCK_WH[b.size]
            above = self._above_tx_w(b, row, col) < TX_WH[tx][0]
            left = self._left_tx_h(b, row, col) < TX_WH[tx][1]
            mx = _SQ[min(64, 4 * max(bw4, bh4))]
            ctx = (TX_SQR_UP[tx] != mx) * 3 + (4 - mx) * 6 + above + left
            split = self.r.symbol(self.cdf.txfm_split[ctx])
        if split:
            sub = SPLIT_TX[tx]
            sw4, sh4 = TX_WH[sub][0] >> 2, TX_WH[sub][1] >> 2
            for i in range(0, th4, sh4):
                for j in range(0, tw4, sw4):
                    self._read_var_tx(b, row + i, col + j, sub, depth + 1)
            return
        for i in range(th4):
            rw = self.tx_sizes[row + i]
            for j in range(tw4):
                rw[col + j] = tx
        b.tx_size = tx

    def _above_tx_w(self, b, row, col):
        if row == b.r:
            if not b.avail_u:
                return 64
            if self.skips[row - 1][col] and self.is_inter[row - 1][col]:
                return BLOCK_WH[self.mi_size[row - 1][col]][0] * 4
        return TX_WH[self.tx_sizes[row - 1][col]][0]

    def _left_tx_h(self, b, row, col):
        if col == b.c:
            if not b.avail_l:
                return 64
            if self.skips[row][col - 1] and self.is_inter[row][col - 1]:
                return BLOCK_WH[self.mi_size[row][col - 1]][1] * 4
        return TX_WH[self.tx_sizes[row][col - 1]][1]

    def _reset_block_context(self, b):
        bw4, bh4 = BLOCK_WH[b.size]
        for p in range(1 + 2 * b.has_chroma):
            sx = self.ssx if p else 0
            sy = self.ssy if p else 0
            for i in range(b.c >> sx, ((b.c + bw4 - 1) >> sx) + 1):
                self.above_level[p][i] = 0
                self.above_dc[p][i] = 0
            for i in range(b.r >> sy, ((b.r + bh4 - 1) >> sy) + 1):
                self.left_level[p][i] = 0
                self.left_dc[p][i] = 0

    # ---------------------------------------------------------- residual
    def _residual(self, b):
        bw4, bh4 = BLOCK_WH[b.size]
        wchunks = max(1, bw4 >> 4)
        hchunks = max(1, bh4 >> 4)
        for cy in range(hchunks):
            for cx in range(wchunks):
                for p in range(1 + 2 * b.has_chroma):
                    if p == 0 and b.is_inter and not b.lossless:
                        self._transform_tree(b, cx, cy)
                        continue
                    if b.lossless:
                        tx = TX_4X4
                    elif p == 0:
                        tx = b.tx_size
                    else:
                        tx = self._uv_tx(b)
                    tw, th = TX_WH[tx]
                    sx = self.ssx if p else 0
                    sy = self.ssy if p else 0
                    pw4, ph4 = BLOCK_WH[self._plane_bsize(b.size, p)]
                    bx = (b.c >> sx) * 4
                    by = (b.r >> sy) * 4
                    for y in range(0, min(ph4, 16 >> sy), th >> 2):
                        for x in range(0, min(pw4, 16 >> sx), tw >> 2):
                            self._transform_block(
                                b, p, bx, by, tx, x + ((cx << 4) >> sx),
                                y + ((cy << 4) >> sy))

    def _transform_tree(self, b, cx, cy):
        """The luma transform blocks of an intrabc block's 64 x 64 chunk:
        each largest transform split down to its InterTxSizes."""
        bw4, bh4 = BLOCK_WH[b.size]
        tw, th = TX_WH[MAX_TX_RECT[b.size]]
        x0, y0 = (b.c + (cx << 4)) * 4, (b.r + (cy << 4)) * 4
        for y in range(y0, y0 + min(64, 4 * bh4), th):
            for x in range(x0, x0 + min(64, 4 * bw4), tw):
                self._tree(b, x, y, tw, th)

    def _tree(self, b, x, y, w, h):
        if x >= self.mi_cols * 4 or y >= self.mi_rows * 4:
            return
        tx = self.tx_sizes[y >> 2][x >> 2]
        if w <= TX_WH[tx][0] and h <= TX_WH[tx][1]:
            self._transform_block(b, 0, x, y, tx, 0, 0)
        elif w > h:
            self._tree(b, x, y, w // 2, h)
            self._tree(b, x + w // 2, y, w // 2, h)
        elif w < h:
            self._tree(b, x, y, w, h // 2)
            self._tree(b, x, y + h // 2, w, h // 2)
        else:
            for dy in (0, h // 2):
                for dx in (0, w // 2):
                    self._tree(b, x + dx, y + dy, w // 2, h // 2)

    def _uv_tx(self, b):
        uv = MAX_TX_RECT[self._plane_bsize(b.size, 1)]
        w, h = TX_WH[uv]
        if w == 64 or h == 64:
            if w == 16:
                return TX_16X32
            if h == 16:
                return TX_32X16
            return TX_32X32
        return uv

    def _transform_block(self, b, p, base_x, base_y, tx, x, y):
        sx = self.ssx if p else 0
        sy = self.ssy if p else 0
        sx0, sy0 = base_x + 4 * x, base_y + 4 * y
        max_x = (self.mi_cols * 4) >> sx
        max_y = (self.mi_rows * 4) >> sy
        if sx0 >= max_x or sy0 >= max_y:
            return
        tw, th = TX_WH[tx]
        row = (sy0 << sy) >> 2
        col = (sx0 << sx) >> 2
        mask = self.sb4 - 1
        sbr, sbc = (row & mask) >> sy, (col & mask) >> sx
        step_x, step_y = tw >> 2, th >> 2
        plane = self.frame[p]
        if b.is_inter:
            pass                        # predicted whole beforehand
        elif (p == 0 and b.pal_y) or (p and b.pal_uv):
            cm = b.color_map[0 if p == 0 else 1]
            pal = np.array(b.pal_colors[p], np.int64)
            plane[sy0:sy0 + th, sx0:sx0 + tw] = \
                pal[cm[4 * y:4 * y + th, 4 * x:4 * x + tw]]
        else:
            is_cfl = p and b.uv_mode == R.UV_CFL
            mode = b.y_mode if p == 0 else (0 if is_cfl else b.uv_mode)
            have_l = (b.avail_l if p == 0 else b.avail_lc) or x > 0
            have_a = (b.avail_u if p == 0 else b.avail_uc) or y > 0
            dec = self.decoded[p]
            have_ar = dec[sbr][sbc + step_x + 1]
            have_bl = dec[sbr + step_y + 1][sbc]
            pred = self._predict(b, p, sx0, sy0, tw, th, mode, have_l,
                                 have_a, have_ar, have_bl, max_x, max_y)
            if is_cfl:
                pred = self._cfl(b, p, sx0, sy0, tw, th, pred)
            plane[sy0:sy0 + th, sx0:sx0 + tw] = pred
        if p == 0:
            b.max_luma_w = sx0 + step_x * 4
            b.max_luma_h = sy0 + step_y * 4
        if not b.skip:
            eob = self._coeffs(b, p, sx0, sy0, tx)
            if eob > 0:
                self._reconstruct(b, p, sx0, sy0, tx)
        self.lf_tx[p][sy0 >> 2:(sy0 >> 2) + step_y,
                      sx0 >> 2:(sx0 >> 2) + step_x] = tx
        dec = self.decoded[p]
        for i in range(step_y):
            rowd = dec[sbr + i + 1]
            for j in range(step_x):
                rowd[sbc + j + 1] = 1

    def _predict(self, b, p, x, y, w, h, mode, have_l, have_a, have_ar,
                 have_bl, max_x, max_y):
        plane = self.frame[p]
        n = w + h
        above = np.empty(n + 1, np.int64)
        left = np.empty(n + 1, np.int64)
        if not have_a and have_l:
            above[1:] = plane[y, x - 1]
        elif not have_a:
            above[1:] = (1 << (self.bd - 1)) - 1
        else:
            lim = min(max_x - 1, x + (2 * w if have_ar else w) - 1)
            idx = np.minimum(np.arange(x, x + n), lim)
            above[1:] = plane[y - 1, idx]
        if not have_l and have_a:
            left[1:] = plane[y - 1, x]
        elif not have_l:
            left[1:] = (1 << (self.bd - 1)) + 1
        else:
            lim = min(max_y - 1, y + (2 * h if have_bl else h) - 1)
            idx = np.minimum(np.arange(y, y + n), lim)
            left[1:] = plane[idx, x - 1]
        if have_a and have_l:
            corner = plane[y - 1, x - 1]
        elif have_a:
            corner = plane[y - 1, x]
        elif have_l:
            corner = plane[y, x - 1]
        else:
            corner = 1 << (self.bd - 1)
        above[0] = left[0] = corner
        if p == 0 and b.filter_intra >= 0:
            return R.pred_filter_intra(above, left, w, h, b.filter_intra,
                                       bd=self.bd)
        if 1 <= mode <= 8:
            angle = R.MODE_TO_ANGLE[mode] + 3 * (b.angle_y if p == 0
                                                 else b.angle_uv)
            ftype = self._filter_type(b, p) if \
                self.s.enable_intra_edge_filter else 0
            return R.pred_directional(above, left, w, h, angle, have_a,
                                      have_l, ftype,
                                      self.s.enable_intra_edge_filter,
                                      max_x - x, max_y - y, bd=self.bd)
        if mode in (R.SMOOTH, R.SMOOTH_V, R.SMOOTH_H):
            return R.pred_smooth(above, left, w, h, mode)
        if mode == R.DC_PRED:
            return R.pred_dc(above, left, w, h, have_a, have_l, bd=self.bd)
        return R.pred_paeth(above, left, w, h)

    def _filter_type(self, b, p):
        def smooth(r, c):
            m = self.y_mode[r][c] if p == 0 else self.uv_mode[r][c]
            return m in (R.SMOOTH, R.SMOOTH_V, R.SMOOTH_H)
        a = lft = False
        if b.avail_u if p == 0 else b.avail_uc:
            r, c = b.r - 1, b.c
            if p:
                if self.ssx and not (b.c & 1):
                    c += 1
                if self.ssy and (b.r & 1):
                    r -= 1
            a = smooth(r, c)
        if b.avail_l if p == 0 else b.avail_lc:
            r, c = b.r, b.c - 1
            if p:
                if self.ssx and (b.c & 1):
                    c -= 1
                if self.ssy and not (b.r & 1):
                    r += 1
            lft = smooth(r, c)
        return int(a or lft)

    def _cfl(self, b, p, x, y, w, h, pred):
        sx, sy = self.ssx, self.ssy
        luma = self.frame[0]
        ys = np.minimum(np.arange(y, y + h), (b.max_luma_h >> sy) - 1) << sy
        xs = np.minimum(np.arange(x, x + w), (b.max_luma_w >> sx) - 1) << sx
        t = np.zeros((h, w), np.int64)
        for dy in range(sy + 1):
            for dx in range(sx + 1):
                t += luma[(ys + dy)[:, None], (xs + dx)[None, :]]
        lum = t << (3 - sx - sy)
        return R.cfl(pred, lum, b.cfl_u if p == 1 else b.cfl_v, bd=self.bd)

    # ------------------------------------------------------ coefficients
    def _coeffs(self, b, p, x, y, tx):
        rd, cdf = self.r, self.cdf
        x4, y4 = x >> 2, y >> 2
        tw, th = TX_WH[tx]
        w4, h4 = tw >> 2, th >> 2
        ctx_sz = (TX_SQR[tx] + TX_SQR_UP[tx] + 1) >> 1
        ptype = int(p > 0)
        sx = self.ssx if p else 0
        sy = self.ssy if p else 0
        max_x4 = self.mi_cols >> sx if p else self.mi_cols
        max_y4 = self.mi_rows >> sy if p else self.mi_rows
        al, ad = self.above_level[p], self.above_dc[p]
        ll, ld = self.left_level[p], self.left_dc[p]
        # all_zero context
        pb = self._plane_bsize(b.size, p)
        bw, bh = BLOCK_WH[pb][0] * 4, BLOCK_WH[pb][1] * 4
        if p == 0:
            top = 0
            for k in range(w4):
                if x4 + k < max_x4:
                    top = max(top, al[x4 + k])
            lft = 0
            for k in range(h4):
                if y4 + k < max_y4:
                    lft = max(lft, ll[y4 + k])
            top, lft = min(top, 255), min(lft, 255)
            if bw == tw and bh == th:
                ctx = 0
            elif top == 0 and lft == 0:
                ctx = 1
            elif top == 0 or lft == 0:
                ctx = 2 + int(max(top, lft) > 3)
            elif max(top, lft) <= 3:
                ctx = 4
            elif min(top, lft) <= 3:
                ctx = 5
            else:
                ctx = 6
        else:
            a = lf = 0
            for k in range(w4):
                if x4 + k < max_x4:
                    a |= al[x4 + k] | ad[x4 + k]
            for k in range(h4):
                if y4 + k < max_y4:
                    lf |= ll[y4 + k] | ld[y4 + k]
            ctx = 7 + int(a != 0) + int(lf != 0)
            if bw * bh > tw * th:
                ctx += 3
        all_zero = rd.symbol(cdf.txb_skip[ctx_sz][ctx])
        b.eob = 0
        if all_zero:
            if p == 0:
                for i in range(h4):
                    for j in range(w4):
                        self.tx_types[(y4 + i, x4 + j)] = DCT_DCT
            cul, dcc = 0, 0
        else:
            if p == 0:
                self._read_tx_type(b, tx, x4, y4)
            b.plane_tx_type = t_type = self._compute_tx_type(b, p, tx, x4,
                                                             y4)
            scan = _get_scan(tx, t_type)
            adj = TX_ADJ[tx]
            aw, ah = TX_WH[adj]
            bwl = aw.bit_length() - 1
            lw, lh = tw.bit_length() - 1, th.bit_length() - 1
            multisize = min(lw, 5) + min(lh, 5) - 4
            tcls = _tx_class(t_type)
            ectx = 0 if tcls == TX_CLASS_2D else 1
            eob_cdf = cdf.eob[multisize][ptype][ectx]
            eob_pt = rd.symbol(eob_cdf) + 1
            eob = eob_pt if eob_pt < 2 else (1 << (eob_pt - 2)) + 1
            if eob_pt >= 3:
                if rd.symbol(cdf.eob_extra[ctx_sz][ptype][eob_pt - 3]):
                    eob += 1 << (eob_pt - 3)
                for i in range(1, max(0, eob_pt - 2)):
                    if rd.literal(1):
                        eob += 1 << (max(0, eob_pt - 2) - 1 - i)
            n = aw * ah
            quant = [0] * n
            shape = 0 if tw == th else (1 if tw > th else 2)
            lo = LO_CTX[shape]
            offs = SIG_REF_DIFF[tcls]
            moffs = MAG_REF[tcls]
            base_cdf = cdf.base[ctx_sz][ptype]
            br_cdf = cdf.br[min(ctx_sz, 3)][ptype]
            area = ah << bwl
            for c in range(eob - 1, -1, -1):
                pos = scan[c]
                row, col = pos >> bwl, pos & (aw - 1)
                if c == eob - 1:
                    ec = 0 if c == 0 else 1 if c <= area // 8 else \
                        2 if c <= area // 4 else 3
                    level = rd.symbol(cdf.base_eob[ctx_sz][ptype][ec]) + 1
                else:
                    mag = 0
                    for dr, dc in offs:
                        rr, cc = row + dr, col + dc
                        if rr < ah and cc < aw:
                            v = quant[(rr << bwl) + cc]
                            mag += v if v < 3 else 3
                    cx = min((mag + 1) >> 1, 4)
                    if tcls == TX_CLASS_2D:
                        if pos == 0:
                            cx = 0
                        else:
                            cx += lo[min(row, 4)][min(col, 4)]
                    else:
                        idx = row if tcls == TX_CLASS_VERT else col
                        cx += (26, 31, 36)[min(idx, 2)]
                    level = rd.symbol(base_cdf[cx])
                if level > 2:
                    mag = 0
                    for dr, dc in moffs:
                        rr, cc = row + dr, col + dc
                        if rr < ah and cc < aw:
                            v = quant[(rr << bwl) + cc]
                            mag += v if v < 15 else 15
                    mag = min((mag + 1) >> 1, 6)
                    if pos == 0:
                        bc = mag
                    elif tcls == TX_CLASS_2D:
                        bc = mag + (7 if row < 2 and col < 2 else 14)
                    elif tcls == TX_CLASS_HORIZ:
                        bc = mag + (7 if col == 0 else 14)
                    else:
                        bc = mag + (7 if row == 0 else 14)
                    for _ in range(4):
                        k = rd.symbol(br_cdf[bc])
                        level += k
                        if k < 3:
                            break
                quant[pos] = level
            cul = 0
            dcc = 0
            for c in range(eob):
                pos = scan[c]
                v = quant[pos]
                if v == 0:
                    continue
                if c == 0:
                    ds = 0
                    for k in range(w4):
                        if x4 + k < max_x4:
                            s = ad[x4 + k]
                            ds += -1 if s == 1 else 1 if s == 2 else 0
                    for k in range(h4):
                        if y4 + k < max_y4:
                            s = ld[y4 + k]
                            ds += -1 if s == 1 else 1 if s == 2 else 0
                    sign = rd.symbol(cdf.dc_sign[ptype][
                        1 if ds < 0 else 2 if ds > 0 else 0])
                else:
                    sign = rd.literal(1)
                if v > 14:
                    # Golomb, its prefix cut at 32 zeros as dav1d cuts it
                    n = 0
                    while not rd.literal(1) and n < 32:
                        n += 1
                    xg = 1
                    for _ in range(n):
                        xg = (xg << 1) | rd.literal(1)
                    v = xg + 14
                if pos == 0:
                    dcc = 1 if sign else 2
                v &= 0xFFFFF
                cul += v
                quant[pos] = -v if sign else v
            cul = min(63, cul)
            b.quant = quant
            b.eob = eob
        for i in range(w4):
            al[x4 + i] = cul
            ad[x4 + i] = dcc
        for i in range(h4):
            ll[y4 + i] = cul
            ld[y4 + i] = dcc
        return b.eob

    def _tx_set(self, tx, inter=0):
        """get_tx_set: intra sets 1-2, inter sets 1-3, 0 DCT only."""
        if TX_SQR_UP[tx] > 3:
            return 0
        if inter:
            if self.f.reduced_tx_set or TX_SQR_UP[tx] == 3:
                return 3
            return 2 if TX_SQR[tx] == 2 else 1
        if TX_SQR_UP[tx] == 3:
            return 0
        if self.f.reduced_tx_set:
            return 2
        return 2 if TX_SQR[tx] == 2 else 1

    def _read_tx_type(self, b, tx, x4, y4):
        f = self.f
        st = self._tx_set(tx, b.is_inter)
        t_type = DCT_DCT
        q = qindex(f, b.seg, None) if f.seg_enabled else f.base_q_idx
        if st > 0 and q > 0 and b.is_inter:
            t_type = INTER_INV[st - 1][self.r.symbol(
                self.cdf.inter_tx[st - 1][TX_SQR[tx]])]
        elif st > 0 and q > 0:
            d = FILTER_TO_DIR[b.filter_intra] if b.filter_intra >= 0 \
                else b.y_mode
            if st == 1:
                t_type = INV_SET1[self.r.symbol(self.cdf.tx1[TX_SQR[tx]][d])]
            else:
                t_type = INV_SET2[self.r.symbol(self.cdf.tx2[TX_SQR[tx]][d])]
        tw, th = TX_WH[tx]
        for i in range(th >> 2):
            for j in range(tw >> 2):
                self.tx_types[(y4 + i, x4 + j)] = t_type

    def _compute_tx_type(self, b, p, tx, x4, y4):
        if b.lossless or TX_SQR_UP[tx] > 3:
            return DCT_DCT
        if p == 0:
            return self.tx_types[(y4, x4)]
        if b.is_inter:
            t_type = self.tx_types[(max(b.r, y4 << self.ssy),
                                    max(b.c, x4 << self.ssx))]
            st = self._tx_set(tx, 1)
            return t_type if st == 1 or t_type in INTER_INV[st - 1] \
                else DCT_DCT
        t_type = MODE_TO_TXFM[b.uv_mode]
        if t_type not in IN_SET_INTRA[self._tx_set(tx)]:
            return DCT_DCT
        return t_type

    def _reconstruct(self, b, p, x, y, tx):
        f, bd = self.f, self.bd
        tw, th = TX_WH[tx]
        plane = self.frame[p]
        pmax = (1 << bd) - 1
        if b.lossless:
            res = R.inverse_wht([4 * v for v in b.quant])
            blk = plane[y:y + 4, x:x + 4]
            plane[y:y + 4, x:x + 4] = np.clip(blk + np.array(res), 0, pmax)
            return
        q = qindex(f, b.seg, self.current_q)
        dc_table, ac_table = QLOOKUP[bd]
        dcq = dc_table[max(0, min(255, q + f.dq[p][0]))]
        acq = ac_table[max(0, min(255, q + f.dq[p][1]))]
        shift = 2 if TX_SQR_UP[tx] == 4 and tx not in (TX_16X64, TX_64X16) \
            else 1 if tx in (TX_32X32, TX_16X32, TX_32X16, TX_16X64,
                             TX_64X16) else 0
        aw, ah = TX_WH[TX_ADJ[tx]]
        qa = np.array(b.quant, np.int64).reshape(ah, aw)
        mul = np.full((ah, aw), acq, np.int64)
        mul[0, 0] = dcq
        level = (f.qm_y, f.qm_u, f.qm_v)[p]
        if level < 15 and b.plane_tx_type < IDTX:
            mul = (mul * qmatrix(level, p > 0, TX_ADJ[tx]) + 16) >> 5
        dq = ((np.abs(qa) * mul) & 0xFFFFFF) >> shift
        dq = np.where(qa < 0, -dq, dq)
        # dav1d's cf_max: the coefficients of (bd + 8)-bit storage
        dq = np.clip(dq, -(1 << (bd + 7)), (1 << (bd + 7)) - 1)
        coef = np.zeros((th, tw), np.int64)
        coef[:ah, :aw] = dq
        res = R.inverse_transform(coef, b.plane_tx_type, tx, tw, th, bd=bd)
        plane[y:y + th, x:x + tw] = np.clip(
            plane[y:y + th, x:x + tw] + res, 0, pmax)


# the DC / AC quantizer lookups by bit depth
QLOOKUP = {8: (T.DC_QLOOKUP, T.AC_QLOOKUP),
           10: (T.DC_QLOOKUP_10, T.AC_QLOOKUP_10),
           12: (T.DC_QLOOKUP_12, T.AC_QLOOKUP_12)}
# the quantizer matrices' offsets in a level's set (libaom's layout: the
# sizes up to 32 x 32 in transform-size order, each stored by columns)
QM_OFFSET = {}
_at = 0
for _t, (_w, _h) in enumerate(TX_WH):
    if TX_ADJ[_t] == _t:
        QM_OFFSET[_t] = _at
        _at += _w * _h
_QM = []


def qmatrix(level: int, chroma: bool, tx: int) -> np.ndarray:
    """The (h, w) dequantization weights of matrix `level` (0-14) for the
    plane type and the transform size `tx` (at most 32 x 32), in 1/32."""
    if not _QM:
        _QM.append(np.fromfile(os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "av1_qm.bin"), np.uint8).reshape(
                15, 2, _at).astype(np.int64))
    w, h = TX_WH[tx]
    at = QM_OFFSET[tx]
    return _QM[0][level, int(chroma), at:at + w * h].reshape(w, h).T


def _psum(cdf, parts):
    s = 0
    for k in parts:
        lo = 32768 if k == 0 else cdf[k - 1]
        s += lo - cdf[k]
    return s


def _subsize(part, w, h):
    if part == PARTITION_NONE:
        wh = (w, h)
    elif part in (PARTITION_HORZ, HORZ_A, HORZ_B):
        wh = (w, h // 2)
    elif part in (PARTITION_VERT, VERT_A, VERT_B):
        wh = (w // 2, h)
    elif part == PARTITION_SPLIT:
        wh = (max(1, w // 2), max(1, h // 2))
    elif part == HORZ_4:
        wh = (w, h // 4)
    else:
        wh = (w // 4, h)
    return BLOCK_BY_WH[wh]


def _inverse_recenter(r, v):
    if v > 2 * r:
        return v
    if v & 1:
        return r - ((v + 1) >> 1)
    return r + (v >> 1)


def _neg_deinterleave(diff, ref, mx):
    if not ref:
        return diff
    if ref >= mx - 1:
        return mx - diff - 1
    if 2 * ref < mx:
        if diff <= 2 * ref:
            return ref + ((diff + 1) >> 1) if diff & 1 else ref - (diff >> 1)
        return diff
    if diff <= 2 * (mx - ref - 1):
        return ref + ((diff + 1) >> 1) if diff & 1 else ref - (diff >> 1)
    return mx - (diff + 1)


def decode_walked(fr, path):
    """Decode a frame av1_obu.walk_av1 found (its namespace `fr`): its
    tiles through a FrameDecoder (`fr.decoder`, kept until the frame is
    filtered), and what a slot keeps of it for the frames that predict
    from it: its CDFs (`cdfs`), motion field (`saved_mvs`) and segment
    map (`seg_map`)."""
    d = walk_frame(fr.seq, fr.frame, fr.tiles, fr.data, path)
    fr.decoder = d
    fr.cdfs = d.saved_cdfs
    fr.saved_mvs = av1_mvs.saved_mvs(d)
    fr.seg_map = np.array(d.seg_ids, np.int64)[:d.mi_rows, :d.mi_cols]
    return d


def planes_of(fr):
    """A decoded frame's planes after the in-loop filters and superres
    (before film grain), filtered once."""
    if fr.planes is None:
        fr.planes = filter_frame(fr.decoder, fr.seq, fr.frame)
    return fr.planes


def walk_frame(seq, frame, tiles, data, path):
    """The frame's symbol walk: its FrameDecoder with every tile decoded
    (reconstructed, the in-loop filters not yet run)."""
    d = FrameDecoder(seq, frame, path)
    for tr, tc, start, end in tiles:
        d.decode_tile(data, start, end, tr, tc)
    return d


def decode_frame(seq, frame, tiles, data, path):
    """The frame's planes: the tiles' reconstruction, deblocked, CDEF,
    restored (each in-loop filter as the frame header sets it), cropped,
    with the film grain the header carries."""
    d = walk_frame(seq, frame, tiles, data, path)
    return add_grain(filter_frame(d, seq, frame), seq, frame)


def add_grain(planes, seq, frame):
    """The output planes: film grain synthesis where the frame has it."""
    if frame.grain is None:
        return planes
    return av1_filmgrain.apply_grain(planes, frame.grain, seq)


def filter_frame(d, seq, frame, stages=None, times=None):
    """Deblocking, then CDEF (keeping the deblocked planes loop
    restoration reads past its stripes), then the superres upscale of
    both, then loop restoration; the cropped planes. `stages`, a list,
    gets the planes after the first two (and the upscale, with
    superres); `times`, a dict, each stage's seconds."""
    times = {} if times is None else times
    planes = d.frame
    t0 = time.perf_counter()
    lf_ids = None if d.lf_ids is None else np.array(d.lf_ids, np.int64)
    inter = None
    if not frame.intra:
        ref = np.array([[rf[0] for rf in row] for row in d.ref_frames],
                       np.int64)
        mode = np.array(d.y_mode, np.int64)
        size = np.array(d.mi_size, np.int64)
        inter = SimpleNamespace(
            ref=np.maximum(ref, 0),
            mode=((mode >= NEARESTMV) & (mode != GLOBALMV) &
                  (mode != GLOBAL_GLOBALMV) & (ref > 0)).astype(np.int64),
            skip=np.array(d.skips, bool) & (ref > 0),
            bw4=_BW4[size], bh4=_BH4[size])
    av1_loopfilter.deblock(planes, frame, seq, np.array(d.seg_ids, np.int64),
                           d.lf_tx, TX_WH, lf_ids, list(d.lf_sets), inter)
    t1 = time.perf_counter()
    if stages is not None:
        stages.append([p.copy() for p in planes])
    if seq.enable_cdef and not (frame.coded_lossless or frame.allow_intrabc):
        planes, _ = av1_cdef.cdef(planes, frame, seq,
                                  np.array(d.skips, bool), d.cdef_idx,
                                  bd=seq.bit_depth)
    t2 = time.perf_counter()
    if stages is not None:
        stages.append([p.copy() for p in planes])
    pre = d.frame
    if frame.width != frame.upscaled_width:
        planes = av1_superres.upscale(planes, frame, seq)
        if any(frame.lr_type):
            pre = av1_superres.upscale(pre, frame, seq)
        if stages is not None:
            stages.append([p.copy() for p in planes])
    t3 = time.perf_counter()
    if any(frame.lr_type):
        planes = av1_restoration.restore(planes, pre, frame, seq, d.lr)
    times.update(deblock=t1 - t0, cdef=t2 - t1, superres=t3 - t2,
                 restoration=time.perf_counter() - t3)
    h, w = frame.height, frame.upscaled_width
    out = [planes[0][:h, :w]]
    if seq.num_planes > 1:
        ch, cw = (h + seq.ssy) >> seq.ssy, (w + seq.ssx) >> seq.ssx
        out += [planes[1][:ch, :cw], planes[2][:ch, :cw]]
    return [o.astype(np.uint8 if seq.bit_depth == 8 else np.uint16)
            for o in out]
