"""libavif's YUV to RGB conversion of 8-, 10- and 12-bit images to 8-bit
RGB, as Pillow's build runs it (libavif 1.3.0 with libyuv 1909 linked in).

With libyuv, libavif converts BT.601 (MC 5 / 6, and 2, unspecified)
and BT.709 (MC 1) in
full and limited range through libyuv's integer YuvConstants (I601,
JPEG, H709, F709): per sample `y1 = (y * 0x0101 * YG >> 16) + YB`, then
`clamp((y1 + UB*u') >> 6)` for blue, `(y1 - UG*u' - VG*v') >> 6` for
green and `(y1 + VR*v') >> 6` for red, with u' = u - 128 and v' = v -
128: libyuv's C rows, which the AVX2 rows it picks at run time match
over every input (tests/test_torch_port_avif.py). 4:2:0 and 4:2:2
chroma is upsampled first by libyuv's bilinear filter (libavif's
automatic choice): ScaleRowUp2_Linear across, ScaleRowUp2_Bilinear
between rows, the edges as its "Any" wrappers leave them. 4:0:0 goes
through libavif's own grey path: Y as it is in full range, in limited
range avifLimitedToFullY's integer rescaling of 16..235. The
identity matrix (MC 0, lossless RGB) goes through libavif's own path:
G = Y, B = U, R = V in full range. BT.2020 (MC 9) goes through libyuv's
2020 / V2020 constants; the chroma-derived matrix (MC 12) through
libyuv's BT.709 constants over BT.709 or unspecified primaries, BT.601's
over BT.470BG / BT.601 ones and BT.2020's over BT.2020 ones.

libyuv knows no other matrix, so libavif converts the rest itself
(`builtin`, reformat.c's avifImageYUV8ToRGB8Color and
avifImageYUVAnyToRGBAnySlow): FCC (4), SMPTE 240 (7), YCgCo in full range
(8), identity in limited range (0), MC 12 over other primaries (kr and kb
derived from them, H.273 equations 32-37) and unlisted values such as 15
(BT.601's kr and kb), in float32 with its own bilinear chroma weights
(9, 3, 3, 1 / 16, the nearest sample first). The ones libavif never
converts (`refused_matrix`) are refused as Pillow refuses them.

10- and 12-bit images (`to_rgb`'s `depth`), as found against libavif's
avifImageYUVToRGB: Pillow asks for RGB where the image has no alpha, and
libavif then downshifts the planes to 8 bits (v >> (depth - 8)) and
converts those as above wherever libyuv has the matrix; for RGBA it
converts 10-bit frames through libyuv's I010 / I210 / I410
AlphaToARGBMatrix rows (`_yuv16`: luma widened to 16 bits by
replication, chroma upsampled at full depth then truncated to 8 bits,
the alpha truncated) and 12-bit 4:2:0 through I012ToARGBMatrix (nearest
chroma, the alpha scaled by libavif), and downshifts 12-bit 4:2:2 and
4:4:4. Grey (RGBA grey through libyuv's I400 on the downshifted luma),
identity and the matrices libyuv lacks go through libavif's float32
path at full depth (`builtin`), which also takes YCgCo-Re (MC 16) at 10
bits in full range; a premultiplied image's colour is divided there for
identity too. Alpha that libyuv does not convert reaches 8 bits as
libavif scales it, (uint8)(0.5 + 255 a / (2^depth - 1)) (`alpha_8bit`).
"""
from __future__ import annotations

import numpy as np

# (YG, YB, UB, UG, VG, VR) of libyuv's constants
_I601 = (18997, -1160, 128, 25, 52, 102)
_JPEG = (16320, 32, 113, 22, 46, 90)
_H709 = (18997, -1160, 128, 14, 34, 115)
_F709 = (16320, 32, 119, 12, 30, 101)
_2020 = (19003, -1160, 128, 12, 42, 107)
_V2020 = (16320, 32, 120, 11, 37, 94)

# libavif's matrixCoefficientsTables (kr, kb) and avifColorPrimariesTables
# (rx, ry, gx, gy, bx, by, wx, wy), float literals
_KR_KB = {1: (0.2126, 0.0722), 4: (0.30, 0.11), 5: (0.299, 0.114),
          6: (0.299, 0.114), 7: (0.212, 0.087), 9: (0.2627, 0.0593)}
_BT709 = (0.64, 0.33, 0.30, 0.60, 0.15, 0.06, 0.3127, 0.3290)
_PRIMARIES = {
    1: _BT709, 4: (0.67, 0.33, 0.21, 0.71, 0.14, 0.08, 0.310, 0.316),
    5: (0.64, 0.33, 0.29, 0.60, 0.15, 0.06, 0.3127, 0.3290),
    6: (0.630, 0.340, 0.310, 0.595, 0.155, 0.070, 0.3127, 0.3290),
    7: (0.630, 0.340, 0.310, 0.595, 0.155, 0.070, 0.3127, 0.3290),
    8: (0.681, 0.319, 0.243, 0.692, 0.145, 0.049, 0.310, 0.316),
    9: (0.708, 0.292, 0.170, 0.797, 0.131, 0.046, 0.3127, 0.3290),
    10: (1.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.3333, 0.3333),
    11: (0.680, 0.320, 0.265, 0.690, 0.150, 0.060, 0.314, 0.351),
    12: (0.680, 0.320, 0.265, 0.690, 0.150, 0.060, 0.3127, 0.3290),
    22: (0.630, 0.340, 0.295, 0.605, 0.155, 0.077, 0.3127, 0.3290)}
F32 = np.float32


def _linear_up(s: np.ndarray, n: int) -> np.ndarray:
    """ScaleRowUp2_Linear_Any_C along the last axis, `n` outputs."""
    s = s.astype(np.int32)
    out = np.empty(s.shape[:-1] + (n,), np.int32)
    out[..., 0] = s[..., 0]
    work = (n - 1) & ~1
    if work > 0:
        a, b = s[..., :work // 2], s[..., 1:work // 2 + 1]
        out[..., 1:work + 1:2] = (3 * a + b + 2) >> 2
        out[..., 2:work + 2:2] = (a + 3 * b + 2) >> 2
    out[..., n - 1] = s[..., (n - 1) // 2]
    return out


def _bilinear_up(sa: np.ndarray, sb: np.ndarray, n: int):
    """Scale2RowUp_Bilinear_Any_C: two chroma rows -> two output rows."""
    sa, sb = sa.astype(np.int32), sb.astype(np.int32)
    da = np.empty(n, np.int32)
    db = np.empty(n, np.int32)
    da[0] = (3 * sa[0] + sb[0] + 2) >> 2
    db[0] = (sa[0] + 3 * sb[0] + 2) >> 2
    work = (n - 1) & ~1
    if work > 0:
        k = work // 2
        s0, s1, t0, t1 = sa[:k], sa[1:k + 1], sb[:k], sb[1:k + 1]
        da[1:work + 1:2] = (9 * s0 + 3 * s1 + 3 * t0 + t1 + 8) >> 4
        da[2:work + 2:2] = (3 * s0 + 9 * s1 + t0 + 3 * t1 + 8) >> 4
        db[1:work + 1:2] = (3 * s0 + s1 + 9 * t0 + 3 * t1 + 8) >> 4
        db[2:work + 2:2] = (s0 + 3 * s1 + 3 * t0 + 9 * t1 + 8) >> 4
    m = (n - 1) // 2
    da[n - 1] = (3 * sa[m] + sb[m] + 2) >> 2
    db[n - 1] = (sa[m] + 3 * sb[m] + 2) >> 2
    return da, db


def upsample_420(c: np.ndarray, h: int, w: int) -> np.ndarray:
    """I420ToARGBMatrixBilinear's chroma rows for an h x w image."""
    out = np.empty((h, w), np.int32)
    out[0] = _linear_up(c[0], w)
    y, src = 1, 0
    while y < h - 1:
        a, b = _bilinear_up(c[src], c[src + 1], w)
        out[y], out[y + 1] = a, b
        y += 2
        src += 1
    if not (h & 1):
        out[h - 1] = _linear_up(c[src], w)
    return out


def refused_matrix(mc: int, full_range: int, subsampled: bool,
                   depth: int = 8) -> bool:
    """The matrix coefficients libavif 1.3.0 converts to 8-bit RGB in no
    case (avifPrepareReformatState: reserved 3, the constant-luminance
    and ICtCp ones, YCgCo-Re but from 10-bit full range, YCgCo-Ro, YCgCo
    in limited range, values past its list; identity with subsampled
    chroma), grey images included."""
    if mc == 16:
        return depth != 10 or not full_range
    return mc == 3 or mc in (10, 11, 13, 14, 17) or mc >= 18 or (
        mc == 8 and not full_range) or (mc == 0 and subsampled)


def libyuv_constants(mc: int, cp: int, full_range: int):
    """The YuvConstants libavif hands libyuv (reformat_libyuv.c), None
    where libyuv has none and libavif converts itself."""
    if mc == 12:                        # chroma-derived: by the primaries
        mc = {1: 1, 2: 1, 5: 6, 6: 6, 9: 9}.get(cp, -1)
    if mc in (2, 5, 6):                 # unspecified: libavif takes BT.601
        return _JPEG if full_range else _I601
    if mc == 1:
        return _F709 if full_range else _H709
    if mc == 9:
        return _V2020 if full_range else _2020
    return None


def kr_kb(mc: int, cp: int):
    """avifCalcYUVCoefficients in float32: the table's kr and kb (BT.601's
    where the matrix is not listed), or for MC 12 kr and kb from the
    primaries (BT.709's where they are not listed), kg = 1 - kr - kb."""
    one = F32(1)
    if mc == 12:
        rx, ry, gx, gy, bx, by, wx, wy = (F32(v) for v in _PRIMARIES.get(
            cp, _BT709))
        rz, gz = one - (rx + ry), one - (gx + gy)
        bz, wz = one - (bx + by), one - (wx + wy)
        den = wy * (rx * (gy * bz - by * gz) + gx * (by * rz - ry * bz) +
                    bx * (ry * gz - gy * rz))
        kr = (ry * (wx * (gy * bz - by * gz) + wy * (bx * gz - gx * bz) +
                    wz * (gx * by - bx * gy))) / den
        kb = (by * (wx * (ry * gz - gy * rz) + wy * (gx * rz - rx * gz) +
                    wz * (rx * gy - gx * ry))) / den
    else:
        kr, kb = (F32(v) for v in _KR_KB.get(mc, (0.299, 0.114)))
    return kr, one - kr - kb, kb


def _builtin_chroma(t: np.ndarray, ssx: int, ssy: int, h: int, w: int):
    """avifImageYUVAnyToRGBAnySlow's chroma at each pixel: the nearest
    sample 9/16, its neighbours across and down 3/16 each, the diagonal
    1/16 (a neighbour past the edge, or down in 4:2:2, is the sample
    itself), summed in that order in float32."""
    i, j = np.arange(w), np.arange(h)
    ci, cj = i >> ssx, j >> ssy
    ai = np.where((i == 0) | ((i == w - 1) & (i % 2 == 1)), 0,
                  np.where(i % 2 == 1, 1, -1)) if ssx else 0 * i
    aj = np.where((j == 0) | ((j == h - 1) & (j % 2 == 1)) | (ssy == 0),
                  0, np.where(j % 2 == 1, 1, -1))
    r0, r1 = cj[:, None], (cj + aj)[:, None]
    c0, c1 = ci[None], (ci + ai)[None]
    return (t[r0, c0] * F32(9 / 16) + t[r0, c1] * F32(3 / 16) +
            t[r1, c0] * F32(3 / 16) + t[r1, c1] * F32(1 / 16))


def builtin(planes, ssx: int, ssy: int, mc: int, cp: int,
            full_range: int, alpha: np.ndarray = None,
            depth: int = 8) -> np.ndarray:
    """libavif's own YUV to 8-bit RGB in float32: unorm tables ((v -
    bias) / range at the planes' depth), chroma upsampled as
    `_builtin_chroma`, then identity (G = Y, B = Cb, R = Cr), YCgCo,
    YCgCo-Re (integers: Cg and Co the chroma's unorm values times 2^depth
    - 1, rounded half up, t = Y - (Cg >> 1), G = t + Cg, B = t - (Co >>
    1), R = B + Co, each clamped to 0..255) or kr / kb's matrix (grey: Y
    for all three), clamped to [0, 1], where `alpha` is given divided by
    it (a = alpha / (2^depth - 1): 0 where a is 0, min(c / a, 1) where a
    < 1), and stored as (uint8)(0.5 + 255 x)."""
    one, two = F32(1), F32(2)
    sh, top = depth - 8, (1 << depth) - 1
    ramp = np.arange(1 << depth, dtype=F32)
    if full_range:
        ty = ramp / F32(top)
        tuv = (ramp - F32(128 << sh)) / F32(top)
    else:
        ty = (ramp - F32(16 << sh)) / F32(219 << sh)
        tuv = (ramp - F32(128 << sh)) / F32(224 << sh)
    if mc == 0:                         # identity: chroma as luma
        tuv = ty
    y = ty[planes[0]]
    h, w = y.shape
    if len(planes) == 1:                # grey
        r = g = b = y
    else:
        if ssx or ssy:
            cb = _builtin_chroma(tuv[planes[1]], ssx, ssy, h, w)
            cr = _builtin_chroma(tuv[planes[2]], ssx, ssy, h, w)
        else:
            cb, cr = tuv[planes[1]], tuv[planes[2]]
        if mc == 0:
            r, g, b = cr, y, cb
        elif mc == 16:
            yy = planes[0].astype(np.int64)
            cg = np.floor(cb * F32(top) + F32(0.5)).astype(np.int64)
            co = np.floor(cr * F32(top) + F32(0.5)).astype(np.int64)
            t = yy - (cg >> 1)
            g = np.clip(t + cg, 0, 255)
            b = np.clip(t - (co >> 1), 0, 255)
            r = np.clip(b + co, 0, 255)
            r, g, b = (v.astype(F32) / F32(255) for v in (r, g, b))
        elif mc == 8:
            t = y - cb
            r, g, b = t + cr, y + cb, t - cr
        else:
            kr, kg, kb = kr_kb(mc, cp)
            r = y + (two * (one - kr)) * cr
            b = y + (two * (one - kb)) * cb
            g = y - ((two * ((kr * (one - kr) * cr) +
                             (kb * (one - kb) * cb))) / kg)
    rgb = np.clip(np.stack([r, g, b], -1), F32(0), one)
    if alpha is not None:
        a = (alpha.astype(F32) / F32(top))[..., None]
        part = np.minimum(np.divide(rgb, a, out=np.zeros_like(rgb),
                                    where=a > 0), one)
        rgb = np.where(a < one, part, rgb)
    return (F32(0.5) + rgb * F32(255)).astype(np.uint8)


def divides_alpha(ssx: int, ssy: int, mono: int, mc: int, cp: int,
                  full_range: int, depth: int = 8) -> bool:
    """Whether libavif converts Pillow's RGBA of a premultiplied image
    by avifImageYUVAnyToRGBAnySlow, dividing the colour by the alpha in
    float32 as it goes (`builtin`'s `alpha`), rather than converting and
    then running libyuv's ARGBUnattenuate (`avif.unpremultiply`): where
    neither libyuv nor a fast path of its own takes the image (chroma
    subsampled, YCgCo and YCgCo-Re, identity in limited range or above 8
    bits; grey only for the YCgCo ones)."""
    if mono:
        return mc in (8, 16)
    return libyuv_constants(mc, cp, full_range) is None and (
        bool(ssx or ssy) or mc in (8, 16) or
        (mc == 0 and (not full_range or depth > 8)))


def alpha_8bit(alpha: np.ndarray, depth: int, ssx: int, ssy: int,
               mono: int, mc: int, cp: int, full_range: int) -> np.ndarray:
    """The 8-bit alpha of Pillow's RGBA: as it is at 8 bits; truncated
    where libyuv converts it with the colour (10 bits, and 12-bit 4:4:4
    and 4:2:2, through libyuv's matrices); else libavif's scaling."""
    if depth == 8:
        return alpha
    if not mono and libyuv_constants(mc, cp, full_range) is not None and \
            (depth == 10 or not (ssx and ssy)):
        return (alpha >> (depth - 8)).astype(np.uint8)
    return (F32(0.5) + (alpha.astype(F32) / F32((1 << depth) - 1)) *
            F32(255)).astype(np.uint8)


def _yuv16(planes, depth: int, ssx: int, ssy: int, k,
           nearest: bool) -> np.ndarray:
    """libyuv's YuvPixel10 / YuvPixel12 rows (I010 / I210 / I410
    AlphaToARGBMatrix, I012ToARGBMatrix): luma widened to 16 bits by
    replicating its top bits, chroma upsampled at full depth (bilinear,
    or nearest for I012) and truncated to 8 bits, then the 8-bit
    formula."""
    y = planes[0].astype(np.int64)
    h, w = y.shape
    sh = depth - 8
    uv = []
    for p in planes[1:]:
        if nearest:
            c = np.repeat(np.repeat(p, 1 + ssy, 0), 1 + ssx, 1)[:h, :w]
        elif ssx and ssy:
            c = upsample_420(p, h, w)
        elif ssx:
            c = _linear_up(p, w)
        else:
            c = p
        uv.append(np.minimum(c.astype(np.int64) >> sh, 255) - 128)
    u, v = uv
    yg, yb, ub, ug, vg, vr = k
    y1 = ((((y << (16 - depth)) | (y >> (2 * depth - 16))) * yg) >> 16) + yb
    b = (y1 + ub * u) >> 6
    g = (y1 - ug * u - vg * v) >> 6
    r = (y1 + vr * v) >> 6
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _deep(planes, depth: int, ssx: int, ssy: int, mono: int, mc: int,
          full_range: int, path: str, cp: int, alpha: np.ndarray,
          prem: bool) -> np.ndarray:
    """10- and 12-bit planes to Pillow's 8-bit RGB (the module's
    docstring)."""
    sh = depth - 8
    if prem and divides_alpha(ssx, ssy, mono, mc, cp, full_range, depth):
        return builtin(planes[:1] if mono else planes, ssx, ssy, mc, cp,
                       full_range, alpha, depth)
    k = libyuv_constants((mc or 6) if mono else mc, cp, full_range)
    if mono:
        if alpha is not None and k is not None:
            return to_rgb([planes[0] >> sh], ssx, ssy, 1, mc, full_range,
                          path, cp, alpha >> sh)
        return builtin(planes[:1], ssx, ssy, mc, cp, full_range, None,
                       depth)
    if k is None:
        return builtin(planes, ssx, ssy, mc, cp, full_range, None, depth)
    if alpha is None or (depth == 12 and not (ssx and ssy)):
        return to_rgb([p >> sh for p in planes], ssx, ssy, 0, mc,
                      full_range, path, cp)
    return _yuv16(planes, depth, ssx, ssy, k, depth == 12)


def to_rgb(planes, ssx: int, ssy: int, mono: int, mc: int,
           full_range: int, path: str, cp: int = 2,
           alpha: np.ndarray = None, prem: bool = False,
           depth: int = 8) -> np.ndarray:
    """Pillow's RGB of 8-bit planes, or of 10- and 12-bit ones (`depth`).
    `alpha`, where the image has one: Pillow asks for RGBA, and libavif
    then converts grey through libyuv's I400ToARGBMatrix (identity as
    BT.601) where it has constants; `prem`: the colour is divided by it
    where `divides_alpha` says (elsewhere the caller runs
    `avif.unpremultiply` after, with `alpha_8bit`)."""
    y = planes[0].astype(np.int32)
    h, w = y.shape
    if refused_matrix(mc, full_range, not mono and (ssx or ssy), depth):
        raise ValueError(f"{path}: AVIF: matrix coefficients {mc} "
                         f"{'' if full_range else 'in limited range '}"
                         "(libavif refuses to convert them, and so does "
                         "Pillow)")
    if depth > 8:
        return _deep([p.astype(np.int64) for p in planes], depth, ssx, ssy,
                     mono, mc, full_range, path, cp, alpha, prem)
    if prem and divides_alpha(ssx, ssy, mono, mc, cp, full_range):
        return builtin(planes[:1] if mono else planes, ssx, ssy, mc, cp,
                       full_range, alpha)
    if mono:
        k = libyuv_constants(mc or 6, cp, full_range)
        if alpha is not None and k is not None:
            y = np.clip((((y * 0x0101 * k[0]) >> 16) + k[1]) >> 6, 0, 255)
        elif not full_range:
            y = ((np.clip(y, 16, 235) - 16) * 255 + 109) // 219
        return np.repeat(y.astype(np.uint8)[..., None], 3, -1)
    if mc == 0 and full_range:
        return np.stack([planes[2], planes[0], planes[1]], -1).astype(
            np.uint8)
    k = libyuv_constants(mc, cp, full_range)
    if k is None:
        return builtin(planes, ssx, ssy, mc, cp, full_range)
    if ssx and ssy:
        u = upsample_420(planes[1], h, w)
        v = upsample_420(planes[2], h, w)
    elif ssx:
        u = _linear_up(planes[1], w)
        v = _linear_up(planes[2], w)
    else:
        u = planes[1].astype(np.int32)
        v = planes[2].astype(np.int32)
    yg, yb, ub, ug, vg, vr = k
    y1 = ((y * 0x0101 * yg) >> 16) + yb
    u, v = u - 128, v - 128
    b = (y1 + ub * u) >> 6
    g = (y1 - ug * u - vg * v) >> 6
    r = (y1 + vr * v) >> 6
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)
