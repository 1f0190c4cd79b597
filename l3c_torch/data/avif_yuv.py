"""libavif's YUV to RGB conversion of 8-bit images, as Pillow's build
runs it (libavif 1.3.0 with libyuv 1909 linked in).

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
G = Y, B = U, R = V in full range. Other matrices, and identity in
limited range, are not decoded by the port yet; the ones libavif never
converts (`refused_matrix`) are refused as Pillow refuses them.
"""
from __future__ import annotations

import numpy as np

# (YG, YB, UB, UG, VG, VR) of libyuv's constants
_I601 = (18997, -1160, 128, 25, 52, 102)
_JPEG = (16320, 32, 113, 22, 46, 90)
_H709 = (18997, -1160, 128, 14, 34, 115)
_F709 = (16320, 32, 119, 12, 30, 101)


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


def refused_matrix(mc: int, full_range: int, subsampled: bool) -> bool:
    """The matrix coefficients libavif 1.3.0 converts to RGB in no case
    (avifPrepareReformatState: reserved 3, the constant-luminance and
    ICtCp ones, YCgCo-R at 8 bits, YCgCo in limited range, values past
    its list; identity with subsampled chroma), grey images included."""
    return mc == 3 or mc in (10, 11, 13, 14, 16, 17) or mc >= 18 or (
        mc == 8 and not full_range) or (mc == 0 and subsampled)


def to_rgb(planes, ssx: int, ssy: int, mono: int, mc: int,
           full_range: int, path: str) -> np.ndarray:
    y = planes[0].astype(np.int32)
    h, w = y.shape
    if refused_matrix(mc, full_range, not mono and (ssx or ssy)):
        raise ValueError(f"{path}: AVIF: matrix coefficients {mc} "
                         f"{'' if full_range else 'in limited range '}"
                         "(libavif refuses to convert them, and so does "
                         "Pillow)")
    if mono:
        if not full_range:
            y = ((np.clip(y, 16, 235) - 16) * 255 + 109) // 219
        return np.repeat(y.astype(np.uint8)[..., None], 3, -1)
    if mc == 0:
        if not full_range:
            raise ValueError(f"{path}: AVIF with the identity matrix "
                             "in limited range is not decoded by the port "
                             "yet (libavif's built-in conversion)")
        return np.stack([planes[2], planes[0], planes[1]], -1).astype(
            np.uint8)
    if mc in (2, 5, 6):                 # unspecified: libavif takes BT.601
        k = _JPEG if full_range else _I601
    elif mc == 1:
        k = _F709 if full_range else _H709
    else:
        raise ValueError(f"{path}: AVIF with matrix coefficients {mc} is not "
                         "decoded by the port yet (libavif's conversion)")
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
