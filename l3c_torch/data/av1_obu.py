"""AV1's OBU syntax for AVIF's intra frames (the AV1 specification,
sections 5 and 6): OBU headers, the sequence header with its colour
config, and the uncompressed header of a key or intra-only frame, shown
or hidden, with its tile info, quantizer, segmentation, delta, loop
filter, CDEF and loop restoration parameters, then the tile groups' tile
sizes; and show_existing_frame headers.

`walk_av1(data, path, ctx)` follows a dav1d context through the data: it
reads every frame in it (dav1d decodes them all, shown or not), keeps
each in the reference slots its refresh_frame_flags name, and returns the
frames and the first one shown, by show_frame or by a later
show_existing_frame (a slot of this data or of data a grid's earlier
cell sent to the same context). `parse_av1(data, path)` returns the
sequence header, the frame header and the tiles of the frame shown. The
header keeps what the tools it names need: the quantizer matrix levels
(`using_qmatrix`, `qm_y`, `qm_u`, `qm_v`), `allow_intrabc` (which
switches the loop filter, CDEF and loop restoration off and reads no
per-block loop filter deltas), the film grain parameters (`frame.grain`,
None without grain; read for a hidden frame that is showable), superres
(`use_superres`, `superres_denom`; `width` is the coded FrameWidth,
`upscaled_width` the frame's), the per-block loop filter deltas'
`delta_lf_present`, `delta_lf_res` and `delta_lf_multi`, the segment
features (the reference features 5 and 7 act in an intra frame only
through `seg_id_pre_skip`), and what a slot keeps (`frame_id`,
`showable_frame`, `refresh`). An inter frame, which dav1d predicts from
its slots, is refused by name with "... is not decoded by the port yet";
a bitstream dav1d cannot parse is refused as damaged.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import List, Tuple

OBU_SEQUENCE_HEADER, OBU_TEMPORAL_DELIMITER, OBU_FRAME_HEADER = 1, 2, 3
OBU_TILE_GROUP, OBU_METADATA, OBU_FRAME = 4, 5, 6
OBU_REDUNDANT_FRAME_HEADER, OBU_PADDING = 7, 15
KEY_FRAME, INTRA_ONLY_FRAME = 0, 2
SELECT = 2
SUPERRES_NUM = 8
SEG_FEATURE_BITS = (8, 6, 6, 6, 6, 3, 0, 0)
SEG_FEATURE_SIGNED = (1, 1, 1, 1, 1, 0, 0, 0)
SEG_FEATURE_MAX = (255, 63, 63, 63, 63, 7, 0, 0)
# setup_past_independence's loop filter deltas (INTRA_FRAME, LAST, LAST2,
# LAST3, GOLDEN, BWDREF, ALTREF2, ALTREF)
LF_REF_DELTAS = (1, 0, 0, 0, -1, 0, -1, -1)
RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE = 0, 1, 2, 3
LR_TYPE = (RESTORE_NONE, RESTORE_SWITCHABLE, RESTORE_WIENER, RESTORE_SGRPROJ)


def damaged(path: str, what: str) -> ValueError:
    return ValueError(f"{path}: AVIF: the AV1 bitstream is damaged ({what});"
                      " dav1d refuses it, and so does Pillow")


def not_yet(path: str, what: str, tool: str) -> ValueError:
    return ValueError(f"{path}: AVIF with {what} is not decoded by the port "
                      f"yet ({tool})")


class Bits:
    """MSB-first bit reader over `data[pos:end]` (f(n), su, le, uvlc,
    leb128, ns)."""

    def __init__(self, data: bytes, pos: int, end: int, path: str):
        self.data, self.bit, self.end, self.path = data, pos * 8, end * 8, \
            path

    def f(self, n: int) -> int:
        if self.bit + n > self.end:
            raise damaged(self.path, "a header runs past its OBU")
        x = 0
        for _ in range(n):
            x = (x << 1) | ((self.data[self.bit >> 3] >> (7 - (self.bit & 7)))
                            & 1)
            self.bit += 1
        return x

    def su(self, n: int) -> int:
        v = self.f(n)
        return v - (1 << n) if v & (1 << (n - 1)) else v

    def uvlc(self) -> int:
        lz = 0
        while not self.f(1):
            lz += 1
            if lz >= 32:
                return (1 << 32) - 1
        return self.f(lz) + (1 << lz) - 1

    def ns(self, n: int) -> int:
        w = n.bit_length()
        m = (1 << w) - n
        v = self.f(w - 1)
        if v < m:
            return v
        return (v << 1) - m + self.f(1)

    def byte_alignment(self):
        self.bit = (self.bit + 7) & ~7

    @property
    def pos(self) -> int:
        return self.bit >> 3


def leb128(data: bytes, at: int, path: str) -> Tuple[int, int]:
    v = 0
    for i in range(8):
        if at + i >= len(data):
            raise damaged(path, "an OBU size runs past the data")
        b = data[at + i]
        v |= (b & 0x7F) << (7 * i)
        if not b & 0x80:
            return v, at + i + 1
    return v, at + 8


def obus(data: bytes, path: str):
    """(type, temporal_id, spatial_id, start, end) of each OBU; as dav1d
    without strict standard compliance (libavif's setting), a set
    forbidden bit is passed over."""
    at = 0
    while at < len(data):
        h = data[at]                    # the forbidden bit is not checked
        typ, ext, has_size = (h >> 3) & 15, (h >> 2) & 1, (h >> 1) & 1
        at += 1
        tid = sid = 0
        if ext:
            if at >= len(data):
                raise damaged(path, "an OBU header is cut")
            tid, sid = data[at] >> 5, (data[at] >> 3) & 3
            at += 1
        if has_size:
            size, at = leb128(data, at, path)
        else:
            size = len(data) - at
        if at + size > len(data):
            raise damaged(path, "an OBU runs past the data")
        yield typ, tid, sid, at, at + size
        at += size


def sequence_header(b: Bits) -> SimpleNamespace:
    s = SimpleNamespace()
    s.profile = b.f(3)
    if s.profile > 2:
        raise damaged(b.path, f"sequence profile {s.profile}")
    s.still_picture = b.f(1)
    s.reduced = b.f(1)
    if s.reduced and not s.still_picture:
        raise damaged(b.path, "a reduced still picture header that is not "
                              "a still picture")
    s.decoder_model_info = 0
    s.equal_picture_interval = 0
    s.op_idc = [0]
    s.decoder_model_present = [0]
    s.buffer_removal_time_length = 0
    s.frame_presentation_time_length = 0
    if s.reduced:
        s.seq_level_idx = [b.f(5)]
    else:
        timing = b.f(1)
        if timing:
            b.f(32)
            b.f(32)
            s.equal_picture_interval = b.f(1)
            if s.equal_picture_interval:
                b.uvlc()
            s.decoder_model_info = b.f(1)
            if s.decoder_model_info:
                buffer_delay_length = b.f(5) + 1
                b.f(32)
                s.buffer_removal_time_length = b.f(5) + 1
                s.frame_presentation_time_length = b.f(5) + 1
        delay_present = b.f(1)
        cnt = b.f(5) + 1
        s.op_idc, s.seq_level_idx, s.decoder_model_present = [], [], []
        for _ in range(cnt):
            s.op_idc.append(b.f(12))
            if s.op_idc[-1] and not (s.op_idc[-1] & 0xFF and
                                     s.op_idc[-1] & 0xF00):
                raise damaged(b.path, "an operating point names no "
                                      "temporal or no spatial layer")
            lvl = b.f(5)
            s.seq_level_idx.append(lvl)
            if lvl > 7:
                b.f(1)
            present = 0
            if s.decoder_model_info:
                present = b.f(1)
                if present:
                    b.f(buffer_delay_length)
                    b.f(buffer_delay_length)
                    b.f(1)
            s.decoder_model_present.append(present)
            if delay_present and b.f(1):
                b.f(4)
    wbits, hbits = b.f(4) + 1, b.f(4) + 1
    s.frame_width_bits, s.frame_height_bits = wbits, hbits
    s.max_width, s.max_height = b.f(wbits) + 1, b.f(hbits) + 1
    s.frame_id_numbers = 0 if s.reduced else b.f(1)
    if s.frame_id_numbers:
        s.delta_frame_id_length = b.f(4) + 2
        s.frame_id_length = b.f(3) + 1 + s.delta_frame_id_length
    s.sb128 = b.f(1)
    s.enable_filter_intra = b.f(1)
    s.enable_intra_edge_filter = b.f(1)
    s.order_hint_bits = 0
    s.enable_order_hint = 0
    if s.reduced:
        s.force_screen_content_tools = SELECT
        s.force_integer_mv = SELECT
    else:
        b.f(4)          # interintra, masked compound, warped, dual filter
        s.enable_order_hint = b.f(1)
        if s.enable_order_hint:
            b.f(2)      # jnt_comp, ref_frame_mvs
        s.force_screen_content_tools = SELECT if b.f(1) else b.f(1)
        if s.force_screen_content_tools > 0:
            s.force_integer_mv = SELECT if b.f(1) else b.f(1)
        else:
            s.force_integer_mv = SELECT
        if s.enable_order_hint:
            s.order_hint_bits = b.f(3) + 1
    s.enable_superres = b.f(1)
    s.enable_cdef = b.f(1)
    s.enable_restoration = b.f(1)
    # colour config
    high = b.f(1)
    if s.profile == 2 and high:
        s.bit_depth = 12 if b.f(1) else 10
    else:
        s.bit_depth = 10 if high else 8
    s.mono = 0 if s.profile == 1 else b.f(1)
    s.num_planes = 1 if s.mono else 3
    if b.f(1):
        s.cp, s.tc, s.mc = b.f(8), b.f(8), b.f(8)
    else:
        s.cp, s.tc, s.mc = 2, 2, 2
    s.csp = 0
    s.separate_uv_delta_q = 0
    if s.mono:
        s.full_range = b.f(1)
        s.ssx = s.ssy = 1
    elif s.cp == 1 and s.tc == 13 and s.mc == 0:
        s.full_range = 1
        s.ssx = s.ssy = 0
        s.separate_uv_delta_q = b.f(1)
    else:
        s.full_range = b.f(1)
        if s.profile == 0:
            s.ssx = s.ssy = 1
        elif s.profile == 1:
            s.ssx = s.ssy = 0
        elif s.bit_depth == 12:
            s.ssx = b.f(1)
            s.ssy = b.f(1) if s.ssx else 0
        else:
            s.ssx, s.ssy = 1, 0
        if s.ssx and s.ssy:
            s.csp = b.f(2)
        s.separate_uv_delta_q = b.f(1)
    s.film_grain_present = b.f(1)
    return s


def _tile_log2(blk: int, target: int) -> int:
    k = 0
    while (blk << k) < target:
        k += 1
    return k


def _tile_info(b: Bits, f: SimpleNamespace, sb128: int):
    sb_cols = (f.mi_cols + 31) >> 5 if sb128 else (f.mi_cols + 15) >> 4
    sb_rows = (f.mi_rows + 31) >> 5 if sb128 else (f.mi_rows + 15) >> 4
    sb_shift = 5 if sb128 else 4
    sb_size = sb_shift + 2
    max_w_sb = 4096 >> sb_size
    max_area_sb = (4096 * 2304) >> (2 * sb_size)
    min_log2_cols = _tile_log2(max_w_sb, sb_cols)
    max_log2_cols = _tile_log2(1, min(sb_cols, 64))
    max_log2_rows = _tile_log2(1, min(sb_rows, 64))
    min_log2_tiles = max(min_log2_cols,
                         _tile_log2(max_area_sb, sb_rows * sb_cols))
    cols, rows = [], []
    if b.f(1):
        f.tile_cols_log2 = min_log2_cols
        while f.tile_cols_log2 < max_log2_cols and b.f(1):
            f.tile_cols_log2 += 1
        w = (sb_cols + (1 << f.tile_cols_log2) - 1) >> f.tile_cols_log2
        cols = [s << sb_shift for s in range(0, sb_cols, w)]
        min_log2_rows = max(min_log2_tiles - f.tile_cols_log2, 0)
        f.tile_rows_log2 = min_log2_rows
        while f.tile_rows_log2 < max_log2_rows and b.f(1):
            f.tile_rows_log2 += 1
        h = (sb_rows + (1 << f.tile_rows_log2) - 1) >> f.tile_rows_log2
        rows = [s << sb_shift for s in range(0, sb_rows, h)]
    else:
        widest, start = 0, 0
        while start < sb_cols:
            cols.append(start << sb_shift)
            size = b.ns(min(sb_cols - start, max_w_sb)) + 1
            widest = max(widest, size)
            start += size
        f.tile_cols_log2 = _tile_log2(1, len(cols))
        area = (sb_rows * sb_cols) >> (min_log2_tiles + 1) \
            if min_log2_tiles > 0 else sb_rows * sb_cols
        max_h = max(area // widest, 1)
        start = 0
        while start < sb_rows:
            rows.append(start << sb_shift)
            start += b.ns(min(sb_rows - start, max_h)) + 1
        f.tile_rows_log2 = _tile_log2(1, len(rows))
    f.mi_col_starts = cols + [f.mi_cols]
    f.mi_row_starts = rows + [f.mi_rows]
    f.tile_cols, f.tile_rows = len(cols), len(rows)
    f.tile_size_bytes = 4
    if f.tile_cols_log2 or f.tile_rows_log2:
        b.f(f.tile_rows_log2 + f.tile_cols_log2)    # context_update_tile_id
        f.tile_size_bytes = b.f(2) + 1


def _cdef_strength(b: Bits):
    """(primary, secondary) strengths; a coded secondary 3 means 4."""
    pri, sec = b.f(4), b.f(2)
    return pri, sec + (sec == 3)


def _delta_q(b: Bits) -> int:
    return b.su(7) if b.f(1) else 0


def frame_header(b: Bits, s: SimpleNamespace) -> SimpleNamespace:
    """uncompressed_header() as dav1d reads it: a show_existing_frame
    header (`show_existing_frame` set, the slot `frame_to_show` and, with
    frame ids, `display_frame_id`; nothing else read), or an intra frame
    (a key frame or an intra-only frame), shown or hidden, with
    `error_resilient` and what a reference slot keeps of it (`frame_id`,
    `showable_frame`, the slots it refreshes, `refresh`, and its film
    grain). Of an inter frame only `frame_type` and `show_frame` are
    read: the port does not predict one, and whether dav1d can (its
    references are there) is the caller's to say."""
    f = SimpleNamespace(show_existing_frame=0, showable_frame=0,
                        frame_id=0)
    path = b.path
    if s.reduced:
        f.frame_type, f.show_frame = KEY_FRAME, 1
    else:
        f.show_existing_frame = b.f(1)
        if f.show_existing_frame:
            f.frame_to_show = b.f(3)
            if s.decoder_model_info and not s.equal_picture_interval:
                b.f(s.frame_presentation_time_length)
            f.display_frame_id = b.f(s.frame_id_length) \
                if s.frame_id_numbers else None
            return f
        f.frame_type = b.f(2)
        f.show_frame = b.f(1)
        if f.frame_type not in (KEY_FRAME, INTRA_ONLY_FRAME):
            return f
        if f.show_frame and s.decoder_model_info and \
                not s.equal_picture_interval:
            b.f(s.frame_presentation_time_length)
        f.showable_frame = 0 if f.show_frame else b.f(1)
    # a shown key frame is error resilient and refreshes every slot
    shown_key = f.frame_type == KEY_FRAME and f.show_frame
    f.error_resilient = 1 if shown_key else b.f(1)
    f.disable_cdf_update = b.f(1)
    if s.force_screen_content_tools == SELECT:
        f.allow_screen_content_tools = b.f(1)
    else:
        f.allow_screen_content_tools = s.force_screen_content_tools
    if f.allow_screen_content_tools and s.force_integer_mv == SELECT:
        b.f(1)                          # force_integer_mv: 1 in intra frames
    if s.frame_id_numbers:
        f.frame_id = b.f(s.frame_id_length)
    override = 0 if s.reduced else b.f(1)
    b.f(s.order_hint_bits)
    if s.decoder_model_info:
        if b.f(1):
            for i, idc in enumerate(s.op_idc):
                if s.decoder_model_present[i]:
                    if idc == 0 or ((idc >> 0) & 1 and (idc >> 8) & 1):
                        b.f(s.buffer_removal_time_length)
    f.refresh = 0xFF if shown_key else b.f(8)       # refresh_frame_flags
    if f.refresh != 0xFF and f.error_resilient and s.enable_order_hint:
        for _ in range(8):
            b.f(s.order_hint_bits)              # ref_order_hint
    if override:
        f.width = b.f(s.frame_width_bits) + 1
        f.height = b.f(s.frame_height_bits) + 1
    else:
        f.width, f.height = s.max_width, s.max_height
    # superres_params: the frame is coded at a width of 8 / SuperresDenom
    # (dav1d keeps it at least min(16, UpscaledWidth)) and upscaled after
    # CDEF (data/av1_superres.py)
    f.upscaled_width, f.superres_denom = f.width, SUPERRES_NUM
    f.use_superres = b.f(1) if s.enable_superres else 0
    if f.use_superres:
        f.superres_denom = b.f(3) + 9
        f.width = max((f.upscaled_width * SUPERRES_NUM +
                       (f.superres_denom >> 1)) // f.superres_denom,
                      min(16, f.upscaled_width))
    f.mi_cols = 2 * ((f.width + 7) >> 3)
    f.mi_rows = 2 * ((f.height + 7) >> 3)
    if b.f(1):                          # render size
        b.f(16)
        b.f(16)
    f.allow_intrabc = 0
    if f.allow_screen_content_tools and not f.use_superres:
        f.allow_intrabc = b.f(1)        # dav1d: not with superres coded
    if not (s.reduced or f.disable_cdf_update):
        b.f(1)                          # disable_frame_end_update_cdf
    _tile_info(b, f, s.sb128)
    # quantization_params
    f.base_q_idx = b.f(8)
    f.dq = [[_delta_q(b), 0, 0], [0, 0, 0], [0, 0, 0]]   # [plane][dc, ac]
    if s.num_planes > 1:
        diff_uv = b.f(1) if s.separate_uv_delta_q else 0
        udc, uac = _delta_q(b), _delta_q(b)
        vdc, vac = (_delta_q(b), _delta_q(b)) if diff_uv else (udc, uac)
        f.dq = [[f.dq[0][0], 0], [udc, uac], [vdc, vac]]
    else:
        f.dq = [[f.dq[0][0], 0], [0, 0], [0, 0]]
    f.using_qmatrix = b.f(1)
    f.qm_y = f.qm_u = f.qm_v = 15
    if f.using_qmatrix:
        f.qm_y, f.qm_u = b.f(4), b.f(4)
        f.qm_v = b.f(4) if s.separate_uv_delta_q else f.qm_u
    # segmentation_params
    f.seg_enabled = b.f(1)
    f.seg_feature = [[None] * 8 for _ in range(8)]
    if f.seg_enabled:
        for i in range(8):
            for j in range(8):
                if b.f(1):
                    bits, lim = SEG_FEATURE_BITS[j], SEG_FEATURE_MAX[j]
                    if SEG_FEATURE_SIGNED[j]:
                        v = max(-lim, min(lim, b.su(1 + bits)))
                    else:
                        v = min(lim, b.f(bits))
                    f.seg_feature[i][j] = v
    f.seg_id_pre_skip, f.last_active_seg_id = 0, 0
    for i in range(8):
        for j in range(8):
            if f.seg_feature[i][j] is not None:
                f.last_active_seg_id = i
                if j >= 5:
                    f.seg_id_pre_skip = 1
    # delta_q_params, delta_lf_params
    f.delta_q_present = b.f(1) if f.base_q_idx > 0 else 0
    f.delta_q_res = b.f(2) if f.delta_q_present else 0
    f.delta_lf_present = f.delta_lf_res = f.delta_lf_multi = 0
    if f.delta_q_present and not f.allow_intrabc:
        f.delta_lf_present = b.f(1)
        if f.delta_lf_present:
            f.delta_lf_res = b.f(2)
            f.delta_lf_multi = b.f(1)
    f.lossless = []
    for seg in range(8):
        q = qindex(f, seg, None)
        f.lossless.append(q == 0 and f.dq[0][0] == 0 and
                          f.dq[1] == [0, 0] and f.dq[2] == [0, 0])
    f.coded_lossless = all(f.lossless)
    # loop_filter_params, cdef_params, lr_params (all off when every
    # segment is lossless, but restoration with superres coded; all off
    # with intra block copy)
    f.lf_level = [0, 0, 0, 0]
    f.lf_sharpness = 0
    f.lf_delta_enabled = 0
    f.lf_ref_deltas = list(LF_REF_DELTAS)
    f.lf_mode_deltas = [0, 0]
    f.cdef_damping, f.cdef_bits = 3, 0
    f.cdef_y, f.cdef_uv = [(0, 0)], [(0, 0)]      # (primary, secondary)
    f.lr_type = [RESTORE_NONE] * 3
    f.lr_unit_size = [0, 0, 0]
    if not (f.coded_lossless or f.allow_intrabc):
        f.lf_level[:2] = [b.f(6), b.f(6)]
        if s.num_planes > 1 and (f.lf_level[0] or f.lf_level[1]):
            f.lf_level[2:] = [b.f(6), b.f(6)]
        f.lf_sharpness = b.f(3)
        f.lf_delta_enabled = b.f(1)
        if f.lf_delta_enabled and b.f(1):       # delta update
            for i in range(8):
                if b.f(1):
                    f.lf_ref_deltas[i] = b.su(7)
            for i in range(2):
                if b.f(1):
                    f.lf_mode_deltas[i] = b.su(7)
        if s.enable_cdef:
            f.cdef_damping = b.f(2) + 3
            f.cdef_bits = b.f(2)
            f.cdef_y, f.cdef_uv = [], []
            for _ in range(1 << f.cdef_bits):
                f.cdef_y.append(_cdef_strength(b))
                if s.num_planes > 1:
                    f.cdef_uv.append(_cdef_strength(b))
                else:
                    f.cdef_uv.append((0, 0))
    if s.enable_restoration and not f.allow_intrabc and (
            not f.coded_lossless or f.use_superres):
        f.lr_type = [LR_TYPE[b.f(2)] for _ in range(s.num_planes)] + \
            [RESTORE_NONE] * (3 - s.num_planes)
        if any(f.lr_type):
            shift = b.f(1)
            if s.sb128:
                shift += 1
            elif shift:
                shift += b.f(1)
            size = 64 << shift
            uv_shift = b.f(1) if s.ssx and s.ssy and any(
                f.lr_type[1:]) else 0
            f.lr_unit_size = [size, size >> uv_shift, size >> uv_shift]
    f.tx_mode_select = 0 if f.coded_lossless else b.f(1)
    f.reduced_tx_set = b.f(1)
    f.grain = None
    if s.film_grain_present and (f.show_frame or f.showable_frame) and \
            b.f(1):
        f.grain = _film_grain_params(b, s)
    return f


def _film_grain_params(b: Bits, s: SimpleNamespace) -> SimpleNamespace:
    """film_grain_params() after apply_grain of a shown intra frame (whose
    update_grain is implied): the points as (value, scaling) pairs, the
    AR coefficients less 128, the multipliers and offsets as coded."""
    g = SimpleNamespace(seed=b.f(16))
    g.y_points = _points(b, 14)
    g.chroma_from_luma = 0 if s.mono else b.f(1)
    g.cb_points, g.cr_points = [], []
    if not (s.mono or g.chroma_from_luma or
            (s.ssx and s.ssy and not g.y_points)):
        g.cb_points = _points(b, 10)
        g.cr_points = _points(b, 10)
        if s.ssx and s.ssy and bool(g.cb_points) != bool(g.cr_points):
            raise damaged(b.path, "film grain on one 4:2:0 chroma plane")
    g.scaling_shift = b.f(2) + 8
    g.ar_lag = b.f(2)
    n_luma = 2 * g.ar_lag * (g.ar_lag + 1)
    n_chroma = n_luma + (1 if g.y_points else 0)
    g.ar_y = [b.f(8) - 128 for _ in range(n_luma)] if g.y_points else []
    g.ar_cb = [b.f(8) - 128 for _ in range(n_chroma)] \
        if g.chroma_from_luma or g.cb_points else [0] * n_chroma
    g.ar_cr = [b.f(8) - 128 for _ in range(n_chroma)] \
        if g.chroma_from_luma or g.cr_points else [0] * n_chroma
    g.ar_shift = b.f(2) + 6
    g.grain_scale_shift = b.f(2)
    g.cb_mult = g.cb_luma_mult = g.cb_offset = 0
    g.cr_mult = g.cr_luma_mult = g.cr_offset = 0
    if g.cb_points:
        g.cb_mult, g.cb_luma_mult, g.cb_offset = b.f(8), b.f(8), b.f(9)
    if g.cr_points:
        g.cr_mult, g.cr_luma_mult, g.cr_offset = b.f(8), b.f(8), b.f(9)
    g.overlap = b.f(1)
    g.clip_restricted = b.f(1)
    return g


def _points(b: Bits, most: int):
    """A scaling function's points, (value, scaling) each; dav1d refuses
    more than `most` and values that do not increase."""
    n = b.f(4)
    if n > most:
        raise damaged(b.path, f"{n} film grain points")
    pts = [(b.f(8), b.f(8)) for _ in range(n)]
    if any(a[0] >= c[0] for a, c in zip(pts, pts[1:])):
        raise damaged(b.path, "film grain points do not increase")
    return pts


def qindex(f: SimpleNamespace, seg: int, current) -> int:
    """get_qindex: `current` is CurrentQIndex, or None to ignore the
    block's delta q."""
    data = f.seg_feature[seg][0] if f.seg_enabled else None
    if data is not None:
        q = (current if current is not None and f.delta_q_present
             else f.base_q_idx) + data
        return max(0, min(255, q))
    if current is not None and f.delta_q_present:
        return current
    return f.base_q_idx


def context(seq: SimpleNamespace = None) -> SimpleNamespace:
    """A dav1d context's state across the data sent to it: the sequence
    header it keeps (`seq`) and its 8 reference slots (`refs`, each None
    or the frame a refresh left there)."""
    return SimpleNamespace(seq=seq, refs=[None] * 8)


def walk_av1(data: bytes, path: str, ctx: SimpleNamespace):
    """The frames dav1d decodes from `data` through the context `ctx`, in
    order, and the one it shows. dav1d reads the data to its end: every
    frame in it is decoded (a damaged one fails the file, shown or not),
    and its picture is the first frame shown, by show_frame or by a frame
    header with show_existing_frame, which shows a slot (a frame of this
    data or of data sent earlier). Returns (frames, shown): each frame
    decoded as a namespace (`seq`, `frame`, `tiles` as (tile_row,
    tile_col, start, end) into its `data`, `planes` None until filtered).

    `ctx` is updated as dav1d updates it: a sequence header replaces the
    one kept, and one that differs empties the slots (and drops a frame
    whose tiles are still to come); a decoded frame fills the slots its
    refresh_frame_flags name; a key frame shown from a slot fills every
    slot. Refused as damaged where dav1d fails: a slot shown that is
    empty, or whose frame id is not display_frame_id; a frame OBU with
    show_existing_frame; a frame header OBU with no room for its trailing
    bit; a tile group with no frame header before it; an inter frame with
    every slot empty; data that shows nothing. A redundant frame header
    is read as a frame header where no frame waits for its tiles, as
    dav1d reads it. An inter frame that has references is refused by
    name."""
    frames, shown = [], None
    frame = fseq = None
    tiles: List[Tuple[int, int, int, int]] = []
    for typ, tid, sid, at, end in obus(data, path):
        if typ == OBU_SEQUENCE_HEADER:
            s = sequence_header(Bits(data, at, end, path))
            if ctx.seq is not None and vars(s) != vars(ctx.seq):
                ctx.refs = [None] * 8
                frame, tiles = None, []
            ctx.seq = s
            continue
        if typ not in (OBU_FRAME, OBU_FRAME_HEADER, OBU_TILE_GROUP,
                       OBU_REDUNDANT_FRAME_HEADER):
            continue            # dav1d skips the others, reserved types too
        if typ == OBU_REDUNDANT_FRAME_HEADER:
            if frame is not None:
                continue
            typ = OBU_FRAME_HEADER      # dav1d reads one as a frame header
        seq = ctx.seq
        if seq is None:
            raise damaged(path, "a frame comes before the sequence header")
        idc = seq.op_idc[0]
        if idc and not ((idc >> tid) & 1 and (idc >> (sid + 8)) & 1):
            continue
        if typ in (OBU_FRAME, OBU_FRAME_HEADER):
            if frame is not None:
                if typ == OBU_FRAME_HEADER:
                    continue
                break
            b = Bits(data, at, end, path)
            f = frame_header(b, seq)
            if f.show_existing_frame:
                if typ == OBU_FRAME:
                    raise damaged(path, "a frame OBU shows an existing frame")
                slot = _show_existing(b, f, ctx)
                shown = shown or slot
                continue
            if f.frame_type not in (KEY_FRAME, INTRA_ONLY_FRAME):
                if any(ctx.refs):
                    raise not_yet(path, "an inter frame",
                                  "dav1d's inter prediction")
                raise damaged(path, "an inter frame has no reference frame")
            frame, fseq = f, seq
            if typ == OBU_FRAME_HEADER:
                b.f(1)                  # trailing_one_bit, as dav1d checks
                continue
            b.byte_alignment()
            at = b.pos
        elif frame is None:
            raise damaged(path, "a tile group comes before its frame "
                                "header")
        tiles += _tile_group(data, at, end, frame, path)
        if len(tiles) == frame.tile_cols * frame.tile_rows:
            done = SimpleNamespace(seq=fseq, frame=frame, tiles=tiles,
                                   data=data, planes=None)
            frames.append(done)
            ctx.refs = [done if (frame.refresh >> i) & 1 else r
                        for i, r in enumerate(ctx.refs)]
            if frame.show_frame:
                shown = shown or done
            frame, tiles = None, []
    if frame is not None:
        raise damaged(path, "tiles are missing")
    if shown is None:
        raise damaged(path, "no frame is shown" if frames else "no frame")
    return frames, shown


def _show_existing(b: Bits, f: SimpleNamespace, ctx: SimpleNamespace):
    """The slot a show_existing_frame header shows, after dav1d's checks
    (the trailing bit, an empty slot, the frame id); a key frame so shown
    fills every slot (dav1d does not check showable_frame: libavif leaves
    strict_std_compliance off)."""
    b.f(1)                              # trailing_one_bit
    slot = ctx.refs[f.frame_to_show]
    if slot is None:
        raise damaged(b.path, f"show_existing_frame shows slot "
                              f"{f.frame_to_show}, which is empty")
    if f.display_frame_id is not None and \
            f.display_frame_id != slot.frame.frame_id:
        raise damaged(b.path, "show_existing_frame's display_frame_id is "
                              "not its slot's frame id")
    if slot.frame.frame_type == KEY_FRAME:
        ctx.refs = [slot] * 8
    return slot


def parse_av1(data: bytes, path: str, seq: SimpleNamespace = None):
    """(sequence header, frame header, tiles) of the frame `data` shows,
    decoded from it through a fresh context (`walk_av1`); tiles as
    (tile_row, tile_col, start, end) into `data`. `seq`, where given, is
    the sequence header a decoder kept from earlier data (a grid's cells
    go through one dav1d context); one in `data` takes its place."""
    _, shown = walk_av1(data, path, context(seq))
    return shown.seq, shown.frame, shown.tiles


def _tile_group(data: bytes, at: int, end: int, f: SimpleNamespace,
                path: str):
    n = f.tile_cols * f.tile_rows
    b = Bits(data, at, end, path)
    start, last = 0, n - 1
    if n > 1 and b.f(1):
        bits = f.tile_cols_log2 + f.tile_rows_log2
        start, last = b.f(bits), b.f(bits)
    b.byte_alignment()
    at = b.pos
    out = []
    for t in range(start, last + 1):
        if t == last:
            size = end - at
        else:
            if at + f.tile_size_bytes > end:
                raise damaged(path, "a tile size runs past its OBU")
            size = int.from_bytes(data[at:at + f.tile_size_bytes],
                                  "little") + 1
            at += f.tile_size_bytes
        if size <= 0 or at + size > end:
            raise damaged(path, "a tile runs past its OBU")
        out.append((t // f.tile_cols, t % f.tile_cols, at, at + size))
        at += size
    return out
