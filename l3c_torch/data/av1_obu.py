"""AV1's OBU syntax for AVIF (the AV1 specification, sections 5 and 6):
OBU headers, the sequence header with its colour config and operating
points, and the uncompressed header of a key, intra-only or inter frame,
shown or hidden, with its tile info, quantizer, segmentation, delta, loop
filter, CDEF and loop restoration parameters, then the tile groups' tile
sizes; and show_existing_frame headers.

`walk_av1(data, path, ctx, op, layer)` follows a dav1d context through
the data: it reads every frame in it (dav1d decodes them all, shown or
not) of the operating point `op`, keeps each in the reference slots its
refresh_frame_flags name, and returns the frames and the picture libavif
takes (`_picture`: the first frame shown, by show_frame or by a later
show_existing_frame of a slot of this data or of data sent earlier to
the same context; with spatial layers, the operating point's highest or
the layer `layer` names). `parse_av1(data, path)` returns the sequence
header, the frame header and the tiles of the frame shown. The header
keeps what the tools it names need: the quantizer matrix levels
(`using_qmatrix`, `qm_y`, `qm_u`, `qm_v`), `allow_intrabc` (which
switches the loop filter, CDEF and loop restoration off and reads no
per-block loop filter deltas), the film grain parameters (`frame.grain`,
None without grain; read for a hidden frame that is showable, loaded
from a reference without update_grain), superres (`use_superres`,
`superres_denom`; `width` is the coded FrameWidth, `upscaled_width` the
frame's), the per-block loop filter deltas' `delta_lf_present`,
`delta_lf_res` and `delta_lf_multi`, the segment features, an inter
frame's references, motion vector and motion mode settings, skip mode's
references and global motion, and what a slot keeps (`frame_id`,
`order_hint`, `showable_frame`, `refresh`, the loop filter deltas,
segment features and global motion a later frame loads). A bitstream
dav1d cannot parse, or an inter frame whose references dav1d cannot
use, is refused as damaged.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import List, Tuple

OBU_SEQUENCE_HEADER, OBU_TEMPORAL_DELIMITER, OBU_FRAME_HEADER = 1, 2, 3
OBU_TILE_GROUP, OBU_METADATA, OBU_FRAME = 4, 5, 6
OBU_REDUNDANT_FRAME_HEADER, OBU_PADDING = 7, 15
KEY_FRAME, INTER_FRAME, INTRA_ONLY_FRAME, SWITCH_FRAME = 0, 1, 2, 3
SELECT = 2
SWITCHABLE = 4
PRIMARY_REF_NONE = 7
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
    tools = jnt = 0
    if s.reduced:
        s.force_screen_content_tools = SELECT
        s.force_integer_mv = SELECT
    else:
        tools = b.f(4)  # interintra, masked compound, warped, dual filter
        s.enable_order_hint = b.f(1)
        if s.enable_order_hint:
            jnt = b.f(2)    # jnt_comp, ref_frame_mvs
        s.force_screen_content_tools = SELECT if b.f(1) else b.f(1)
        if s.force_screen_content_tools > 0:
            s.force_integer_mv = SELECT if b.f(1) else b.f(1)
        else:
            s.force_integer_mv = SELECT
        if s.enable_order_hint:
            s.order_hint_bits = b.f(3) + 1
    s.enable_interintra_compound = tools >> 3
    s.enable_masked_compound = (tools >> 2) & 1
    s.enable_warped_motion = (tools >> 1) & 1
    s.enable_dual_filter = tools & 1
    s.enable_jnt_comp, s.enable_ref_frame_mvs = jnt >> 1, jnt & 1
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
    f.context_update_tile_id = 0
    if f.tile_cols_log2 or f.tile_rows_log2:
        f.context_update_tile_id = b.f(f.tile_rows_log2 +
                                       f.tile_cols_log2)  # context_update
        f.tile_size_bytes = b.f(2) + 1


def _cdef_strength(b: Bits):
    """(primary, secondary) strengths; a coded secondary 3 means 4."""
    pri, sec = b.f(4), b.f(2)
    return pri, sec + (sec == 3)


def _delta_q(b: Bits) -> int:
    return b.su(7) if b.f(1) else 0


def frame_header(b: Bits, s: SimpleNamespace, refs=None, tid: int = 0,
                 sid: int = 0) -> SimpleNamespace:
    """uncompressed_header() as dav1d reads it: a show_existing_frame
    header (`show_existing_frame` set, the slot `frame_to_show` and, with
    frame ids, `display_frame_id`; nothing else read), or a frame, shown
    or hidden, with `error_resilient` and what a reference slot keeps of
    it (`frame_id`, `order_hint`, `showable_frame`, the slots it
    refreshes, `refresh`, its film grain, loop filter deltas, segment
    features and global motion). An inter frame reads its references
    from `refs`, the context's slots (each None or a decoded frame's
    namespace): `ref_frame_idx`, its size (found_ref copies a slot's), MV
    precision, interpolation filter, motion modes, `primary_ref_frame`
    (whose loop filter deltas, segment features and global motion it
    starts from), reference_select, skip mode's two references, warped
    motion and global motion; refused as damaged where dav1d refuses it
    (a slot missing, of another depth or layout, more than twice larger
    or 16 times smaller, a frame id that fails its delta). `tid` and
    `sid` are the OBU's temporal and spatial ids."""
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
        if f.show_frame and s.decoder_model_info and \
                not s.equal_picture_interval:
            b.f(s.frame_presentation_time_length)
        if f.show_frame:
            f.showable_frame = int(f.frame_type != KEY_FRAME)
        else:
            f.showable_frame = 0 if f.show_frame else b.f(1)
    f.intra = f.frame_type in (KEY_FRAME, INTRA_ONLY_FRAME)
    # a shown key frame is error resilient and refreshes every slot
    shown_key = f.frame_type == KEY_FRAME and f.show_frame
    if f.frame_type == SWITCH_FRAME:
        f.error_resilient = 1
    else:
        f.error_resilient = 1 if shown_key else b.f(1)
    f.disable_cdf_update = b.f(1)
    if s.force_screen_content_tools == SELECT:
        f.allow_screen_content_tools = b.f(1)
    else:
        f.allow_screen_content_tools = s.force_screen_content_tools
    f.force_integer_mv = 0
    if f.allow_screen_content_tools:
        if s.force_integer_mv == SELECT:
            f.force_integer_mv = b.f(1)     # force_integer_mv: 1 if intra
        else:
            f.force_integer_mv = s.force_integer_mv
    if f.intra:
        f.force_integer_mv = 1
    if s.frame_id_numbers:
        f.frame_id = b.f(s.frame_id_length)
    if f.frame_type == SWITCH_FRAME:
        override = 1
    else:
        override = 0 if s.reduced else b.f(1)
    f.order_hint = b.f(s.order_hint_bits)
    f.primary_ref_frame = PRIMARY_REF_NONE
    if not (f.intra or f.error_resilient):
        f.primary_ref_frame = b.f(3)            # primary_ref_frame
    if s.decoder_model_info:
        if b.f(1):
            for i, idc in enumerate(s.op_idc):
                if s.decoder_model_present[i]:
                    if idc == 0 or ((idc >> tid) & 1 and
                                    (idc >> (sid + 8)) & 1):
                        b.f(s.buffer_removal_time_length)
    if f.frame_type == SWITCH_FRAME:
        f.refresh = 0xFF
    else:
        f.refresh = 0xFF if shown_key else b.f(8)   # refresh_frame_flags
    if (not f.intra or f.refresh != 0xFF) and f.error_resilient and \
            s.enable_order_hint:
        for _ in range(8):
            b.f(s.order_hint_bits)              # ref_order_hint
    f.allow_intrabc = 0
    f.ref_frame_idx = [0] * 7
    f.allow_high_precision_mv = 0
    f.interpolation_filter = 0
    f.is_motion_mode_switchable = 0
    f.use_ref_frame_mvs = 0
    if f.intra:
        f.order_hints, f.sign_bias = [f.order_hint] + [0] * 7, [0] * 8
        _frame_size(b, s, f, override)
        if f.allow_screen_content_tools and not f.use_superres:
            f.allow_intrabc = b.f(1)    # dav1d: not with superres coded
    else:
        _inter_refs(b, s, f, refs or [None] * 8)
        if override and not f.error_resilient:
            _frame_size_with_refs(b, s, f, override)
        else:
            _frame_size(b, s, f, override)
        if not f.force_integer_mv:
            f.allow_high_precision_mv = b.f(1)  # allow_high_precision_mv
        if b.f(1):                              # is_filter_switchable
            f.interpolation_filter = SWITCHABLE
        else:
            f.interpolation_filter = b.f(2)     # interpolation_filter
        f.is_motion_mode_switchable = b.f(1)    # is_motion_mode_switchable
        if not f.error_resilient and s.enable_ref_frame_mvs:
            f.use_ref_frame_mvs = b.f(1)        # use_ref_frame_mvs
        _check_refs(b, s, f)
    if s.reduced or f.disable_cdf_update:
        f.disable_frame_end_update_cdf = 1
    else:
        f.disable_frame_end_update_cdf = b.f(1)  # disable_frame_end_update_cdf
    prev = f.refs[f.ref_frame_idx[f.primary_ref_frame]].frame \
        if f.primary_ref_frame != PRIMARY_REF_NONE else None
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
    # segmentation_params: an inter frame with a primary reference frame
    # may keep its segment map and features
    f.seg_enabled = b.f(1)
    f.seg_update_map, f.seg_temporal_update = 1, 0
    update_data = 1
    f.seg_feature = [[None] * 8 for _ in range(8)]
    if f.seg_enabled and prev is not None:
        f.seg_update_map = b.f(1)               # segmentation_update_map
        if f.seg_update_map:
            f.seg_temporal_update = b.f(1)      # segmentation_temporal_upd
        update_data = b.f(1)                    # segmentation_update_data
        if not update_data:
            f.seg_feature = [list(r) for r in prev.seg_feature]
    if f.seg_enabled and update_data:
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
    if prev is not None:
        f.lf_ref_deltas = list(prev.lf_ref_deltas)
        f.lf_mode_deltas = list(prev.lf_mode_deltas)
    f.cdef_damping, f.cdef_bits = 3, 0
    f.cdef_y, f.cdef_uv = [(0, 0)], [(0, 0)]      # (primary, secondary)
    f.lr_type = [RESTORE_NONE] * 3
    f.lr_unit_size = [0, 0, 0]
    if f.coded_lossless or f.allow_intrabc:
        f.lf_ref_deltas = list(LF_REF_DELTAS)
        f.lf_mode_deltas = [0, 0]
    else:
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
    f.reference_select = 0 if f.intra else b.f(1)   # reference_select
    _skip_mode_params(b, s, f)
    f.allow_warped_motion = 0
    if not (f.intra or f.error_resilient) and s.enable_warped_motion:
        f.allow_warped_motion = b.f(1)          # allow_warped_motion
    f.reduced_tx_set = b.f(1)
    _global_motion_params(b, f, prev)
    f.grain = None
    if s.film_grain_present and (f.show_frame or f.showable_frame) and \
            b.f(1):
        f.grain = _film_grain_params(b, s, f)
    return f


def _frame_size(b: Bits, s: SimpleNamespace, f: SimpleNamespace,
                override: int):
    """frame_size, superres_params and render_size."""
    if override:
        f.width = b.f(s.frame_width_bits) + 1
        f.height = b.f(s.frame_height_bits) + 1
    else:
        f.width, f.height = s.max_width, s.max_height
    _superres(b, s, f)
    if b.f(1):                          # render size
        f.render = (b.f(16) + 1, b.f(16) + 1)
    else:
        f.render = (f.upscaled_width, f.height)


def _superres(b: Bits, s: SimpleNamespace, f: SimpleNamespace):
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


def _frame_size_with_refs(b: Bits, s: SimpleNamespace, f: SimpleNamespace,
                          override: int):
    """frame_size_with_refs: the first reference whose found_ref is set
    gives the upscaled width, the height and the render size."""
    for i in range(7):
        if b.f(1):                              # found_ref
            r = f.refs[f.ref_frame_idx[i]].frame
            f.width, f.height = r.upscaled_width, r.height
            render = r.render
            _superres(b, s, f)
            f.render = render
            return
    _frame_size(b, s, f, override)


def get_relative_dist(s: SimpleNamespace, a: int, b: int) -> int:
    if not s.enable_order_hint:
        return 0
    diff = a - b
    m = 1 << (s.order_hint_bits - 1)
    return (diff & (m - 1)) - (diff & m)


def _inter_refs(b: Bits, s: SimpleNamespace, f: SimpleNamespace, refs):
    """ref_frame_idx, read or set by frame_refs_short_signaling, and each
    reference's delta_frame_id (checked as dav1d checks it)."""
    f.refs = list(refs)
    if not any(refs):
        raise damaged(b.path, "an inter frame has no reference frame")
    short = b.f(1) if s.enable_order_hint else 0  # frame_refs_short_sig
    if short:
        last, gold = b.f(3), b.f(3)             # last_frame_idx, gold
        if not all(refs):                       # dav1d reads every slot
            raise damaged(b.path, "an inter frame's short signaling meets "
                                  "an empty slot")
        f.ref_frame_idx = _set_frame_refs(s, f, refs, last, gold)
    for i in range(7):
        if not short:
            f.ref_frame_idx[i] = b.f(3)         # ref_frame_idx
        slot = refs[f.ref_frame_idx[i]]
        if slot is None:
            raise damaged(b.path, "an inter frame names an empty slot")
        if s.frame_id_numbers:
            delta = b.f(s.delta_frame_id_length) + 1   # delta_frame_id
            n = 1 << s.frame_id_length
            if slot.frame.frame_id != (f.frame_id + n - delta) % n:
                raise damaged(b.path, "a reference's frame id fails its "
                                      "delta_frame_id")
    f.order_hints = [f.order_hint] + [
        refs[f.ref_frame_idx[i]].frame.order_hint for i in range(7)]
    f.sign_bias = [0] + [int(get_relative_dist(s, h, f.order_hint) > 0)
                         for h in f.order_hints[1:]]


def _set_frame_refs(s: SimpleNamespace, f: SimpleNamespace, refs, last,
                    gold):
    """set_frame_refs: the other five references chosen by order hint."""
    idx = [-1] * 7
    idx[0], idx[3] = last, gold
    used = [0] * 8
    used[last] = used[gold] = 1
    cur = 1 << (s.order_hint_bits - 1)
    hints = [cur + get_relative_dist(s, r.frame.order_hint, f.order_hint)
             for r in refs]

    def pick(backward, latest):
        ref, best = -1, 0
        for i in range(8):
            h = hints[i]
            if used[i] or (h >= cur) != backward:
                continue
            if ref < 0 or (h >= best if latest else h < best):
                ref, best = i, h
        return ref
    for slot, backward, latest in ((6, 1, 1), (4, 1, 0), (5, 1, 0)):
        ref = pick(backward, latest)
        if ref >= 0:
            idx[slot] = ref
            used[ref] = 1
    for slot in (1, 2, 4, 5, 6):
        if idx[slot] < 0:
            ref = pick(0, 1)
            if ref >= 0:
                idx[slot] = ref
                used[ref] = 1
    ref, best = -1, 0
    for i in range(8):
        if ref < 0 or hints[i] < best:
            ref, best = i, hints[i]
    return [ref if i < 0 else i for i in idx]


def _check_refs(b: Bits, s: SimpleNamespace, f: SimpleNamespace):
    """dav1d's refusal of a reference it cannot predict from: of another
    depth or layout, or whose size is more than twice the frame's or
    below a sixteenth of it."""
    for i in range(7):
        slot = f.refs[f.ref_frame_idx[i]]
        r, rs = slot.frame, slot.seq
        if (rs.bit_depth, rs.mono, rs.ssx, rs.ssy) != \
                (s.bit_depth, s.mono, s.ssx, s.ssy):
            raise damaged(b.path, "a reference frame has another depth or "
                                  "layout")
        if 2 * f.width < r.upscaled_width or 2 * f.height < r.height or \
                f.width > 16 * r.upscaled_width or \
                f.height > 16 * r.height:
            raise damaged(b.path, "a reference frame's size is out of "
                                  "scale")


def _skip_mode_params(b: Bits, s: SimpleNamespace, f: SimpleNamespace):
    """skip_mode_present and SkipModeFrame: the nearest forward and
    backward references (or the two nearest forward ones)."""
    f.skip_mode_present, f.skip_mode_frame = 0, (0, 0)
    if f.intra or not f.reference_select or not s.enable_order_hint:
        return
    fwd = bwd = -1
    fwd_hint = bwd_hint = 0
    for i in range(7):
        h = f.order_hints[i + 1]
        d = get_relative_dist(s, h, f.order_hint)
        if d < 0:
            if fwd < 0 or get_relative_dist(s, h, fwd_hint) > 0:
                fwd, fwd_hint = i, h
        elif d > 0:
            if bwd < 0 or get_relative_dist(s, h, bwd_hint) < 0:
                bwd, bwd_hint = i, h
    if fwd < 0:
        return
    if bwd < 0:
        second, second_hint = -1, 0
        for i in range(7):
            h = f.order_hints[i + 1]
            if get_relative_dist(s, h, fwd_hint) < 0:
                if second < 0 or get_relative_dist(s, h, second_hint) > 0:
                    second, second_hint = i, h
        if second < 0:
            return
        bwd = second
    f.skip_mode_frame = (1 + min(fwd, bwd), 1 + max(fwd, bwd))
    f.skip_mode_present = b.f(1)                # skip_mode_present


IDENTITY, TRANSLATION, ROTZOOM, AFFINE = 0, 1, 2, 3
WARPEDMODEL_PREC_BITS = 16
DEFAULT_GM = (0, 0, 1 << 16, 0, 0, 1 << 16)


def _global_motion_params(b: Bits, f: SimpleNamespace, prev):
    """global_motion_params: each reference's type and parameters, coded
    against the primary reference frame's (the defaults without one)."""
    f.gm_type = [IDENTITY] * 8
    f.gm_params = [list(DEFAULT_GM) for _ in range(8)]
    if f.intra:
        return
    for ref in range(1, 8):
        typ = IDENTITY
        if b.f(1):                              # is_global
            if b.f(1):                          # is_rot_zoom
                typ = ROTZOOM
            else:
                typ = TRANSLATION if b.f(1) else AFFINE   # is_translation
        f.gm_type[ref] = typ
        p = f.gm_params[ref]
        pp = prev.gm_params[ref] if prev is not None and \
            not f.error_resilient else DEFAULT_GM
        if typ >= ROTZOOM:
            p[2] = _gm_param(b, f, typ, 2, pp)
            p[3] = _gm_param(b, f, typ, 3, pp)
            if typ == AFFINE:
                p[4] = _gm_param(b, f, typ, 4, pp)
                p[5] = _gm_param(b, f, typ, 5, pp)
            else:
                p[4], p[5] = -p[3], p[2]
        if typ >= TRANSLATION:
            p[0] = _gm_param(b, f, typ, 0, pp)
            p[1] = _gm_param(b, f, typ, 1, pp)


def _gm_param(b: Bits, f: SimpleNamespace, typ: int, idx: int, prev):
    """read_global_param: decode_signed_subexp_with_ref of the parameter
    at its precision."""
    abs_bits, prec_bits = 12, 15
    if idx < 2:
        if typ == TRANSLATION:
            hp = 1 - f.allow_high_precision_mv
            abs_bits, prec_bits = 9 - hp, 3 - hp
        else:
            abs_bits, prec_bits = 12, 6
    prec_diff = WARPEDMODEL_PREC_BITS - prec_bits
    rnd = (1 << WARPEDMODEL_PREC_BITS) if idx % 3 == 2 else 0
    sub = (1 << prec_bits) if idx % 3 == 2 else 0
    mx = 1 << abs_bits
    r = (prev[idx] >> prec_diff) - sub
    low, high = -mx, mx + 1
    n, ref = high - low, r - low
    # decode_subexp(n) with k = 3
    i = mk = 0
    while True:
        b2 = 3 + i - 1 if i else 3
        a = 1 << b2
        if n <= mk + 3 * a:
            v = b.ns(n - mk) + mk
            break
        if not b.f(1):                          # subexp_more_bits
            v = b.f(b2) + mk                    # subexp_bits
            break
        i += 1
        mk += a
    if (ref << 1) <= n:
        x = _inverse_recenter(ref, v)
    else:
        x = n - 1 - _inverse_recenter(n - 1 - ref, v)
    return ((x + low) << prec_diff) + rnd


def _inverse_recenter(r: int, v: int) -> int:
    if v > 2 * r:
        return v
    if v & 1:
        return r - ((v + 1) >> 1)
    return r + (v >> 1)


def _film_grain_params(b: Bits, s: SimpleNamespace,
                       f: SimpleNamespace) -> SimpleNamespace:
    """film_grain_params() after apply_grain: the points as (value,
    scaling) pairs, the AR coefficients less 128, the multipliers and
    offsets as coded; or, in an inter frame without update_grain, those
    of the reference film_grain_params_ref_idx names (one of the frame's
    references, as dav1d requires) with the new seed (None where that
    reference had none)."""
    g = SimpleNamespace(seed=b.f(16))
    if f.frame_type == INTER_FRAME and not b.f(1):      # update_grain
        idx = b.f(3)                            # film_grain_params_ref_idx
        if idx not in f.ref_frame_idx:
            raise damaged(b.path, "film grain is loaded from a slot that "
                                  "is not a reference")
        ref = f.refs[idx].frame.grain
        return None if ref is None else SimpleNamespace(
            **dict(vars(ref), seed=g.seed))
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


def walk_av1(data: bytes, path: str, ctx: SimpleNamespace, op: int = 0,
             layer=None):
    """The frames dav1d decodes from `data` through the context `ctx`, in
    order, and the one it shows. dav1d reads the data to its end: every
    frame in it is decoded (a damaged one fails the file, shown or not),
    and its picture is a frame shown, by show_frame or by a frame header
    with show_existing_frame, which shows a slot (a frame of this data or
    of data sent earlier). The operating point `op` (an item's a1op;
    dav1d takes 0 where the sequence has no such point) drops the OBUs of
    the layers it leaves out; the picture is then, as libavif's dav1d
    settings give it: with `layer` (an item's lsel) the first frame shown
    of that spatial layer; else, where the operating point has spatial
    layers, the last frame shown of its temporal unit up to the first of
    its highest layer (dav1d's cache of a picture until its temporal unit
    ends); else the first frame shown. Returns (frames, shown): each
    frame decoded as a namespace (`seq`, `frame`, `sid` its spatial id,
    `tiles` as (tile_row, tile_col, start, end) into its `data`,
    `planes` None until filtered; av1_block.decode_walked decodes it).

    `ctx` is updated as dav1d updates it: a sequence header replaces the
    one kept, and one that differs empties the slots (and drops a frame
    whose tiles are still to come); a decoded frame fills the slots its
    refresh_frame_flags name; a key frame shown from a slot fills every
    slot. Refused as damaged where dav1d fails: a slot shown that is
    empty, or whose frame id is not display_frame_id; a frame OBU with
    show_existing_frame; a frame header OBU with no room for its trailing
    bit; a tile group with no frame header before it; an inter frame
    whose references dav1d cannot use (frame_header); data that shows
    nothing. A redundant frame header is read as a frame header where no
    frame waits for its tiles, as dav1d reads it."""
    frames, pics, new_tu = [], [], False
    frame = fseq = None
    tiles: List[Tuple[int, int, int, int]] = []
    for typ, tid, sid, at, end in obus(data, path):
        if typ == OBU_TEMPORAL_DELIMITER:
            new_tu = True
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
        idc = seq.op_idc[op if op < len(seq.op_idc) else 0]
        if idc and not ((idc >> tid) & 1 and (idc >> (sid + 8)) & 1):
            continue
        if typ in (OBU_FRAME, OBU_FRAME_HEADER):
            if frame is not None:
                if typ == OBU_FRAME_HEADER:
                    continue
                break
            b = Bits(data, at, end, path)
            f = frame_header(b, seq, ctx.refs, tid, sid)
            if f.show_existing_frame:
                if typ == OBU_FRAME:
                    raise damaged(path, "a frame OBU shows an existing frame")
                slot = _show_existing(b, f, ctx)
                pics.append((slot, new_tu))
                new_tu = False
                continue
            frame, fseq, fsid = f, seq, sid
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
                                   data=data, planes=None, decoder=None,
                                   sid=fsid)
            frames.append(done)
            ctx.refs = [done if (frame.refresh >> i) & 1 else r
                        for i, r in enumerate(ctx.refs)]
            if frame.show_frame:
                pics.append((done, new_tu))
                new_tu = False
            frame, tiles = None, []
    if frame is not None:
        raise damaged(path, "tiles are missing")
    shown = _picture(pics, ctx.seq, op, layer)
    if shown is None:
        raise damaged(path, "no frame is shown" if frames else "no frame")
    return frames, shown


def _picture(pics, seq, op, layer):
    """The picture libavif takes of the frames shown (in order, each with
    whether a temporal delimiter came before it)."""
    if layer is not None:
        return next((p for p, _ in pics if p.sid == layer), None)
    idc = seq.op_idc[op if op < len(seq.op_idc) else 0] if seq else 0
    top = (idc >> 8).bit_length() - 1
    if top <= 0:
        return pics[0][0] if pics else None
    cache = None
    for p, tu in pics:
        if cache is not None and (cache.sid == top or tu):
            break
        cache = p
    return cache


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
