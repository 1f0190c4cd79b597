"""CIE L*a*b* to sRGB as Pillow 12.1's convert("RGB") of a LAB image gives
it: ImageCms's LittleCMS 2.17 transform from its built-in Lab (v2) profile
to its built-in sRGB profile, perceptual intent, 8 bits in and out.

LittleCMS optimizes such a transform into a 33 x 33 x 33 grid of 16-bit
values sampled from its floating-point pipeline, then interpolates each
pixel tetrahedrally in fixed point. The grid here is computed as that
pipeline computes it (cmsPipelineEval16): the input over 65535 in float32;
the Lab v4 -> v2 -> v4 matrices; Lab -> XYZ against D50 (cmsLab2XYZ), over
1 + 32767 / 32768; the inverse of the sRGB colorant matrix (D65 and the
Rec. 709 primaries, Bradford-adapted to D50, all in double) times that
factor; the inverse sRGB curve (parametric type -4) in double; each stage
rounded to float32, the result to 16 bits. The interpolation is
TetrahedralInterp16 and the 16 -> 8 bit step FROM_16_TO_8. Held against
Pillow on all 2^24 inputs (tests/test_torch_port_tiff_codecs.py).

The input bytes are Pillow's LAB samples, as a CIELAB TIFF stores them (L,
then a and b as signed bytes); LittleCMS reads a and b offset by 128, so
their top bits are flipped on the way in.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

_N = 33                      # _cmsReasonableGridpointsByColorspace, 3 inputs
_D50 = (0.9642, 1.0, 0.8249)
_BRADFORD = ((0.8951, 0.2664, -0.1614), (-0.7502, 1.7135, 0.0367),
             (0.0389, -0.0685, 1.0296))
# sRGB's curve, parametric type 4: gamma, a, b, c, d
_SRGB = (2.4, 1 / 1.055, 0.055 / 1.055, 1 / 12.92, 0.04045)
_GRID: Optional[np.ndarray] = None


def _inv3(a) -> List[List[float]]:
    """_cmsMAT3inverse: cofactors over the determinant, in its order."""
    c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0]
    c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2
    return [[c0 / det, (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det,
             (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det],
            [c1 / det, (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det,
             (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det],
            [c2 / det, (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det,
             (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det]]


def _per(a, b) -> List[List[float]]:
    return [[a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j]
             for j in range(3)] for i in range(3)]


def _ev(a, v) -> List[float]:
    return [a[k][0] * v[0] + a[k][1] * v[1] + a[k][2] * v[2]
            for k in range(3)]


def _srgb_colorants() -> List[List[float]]:
    """cmsCreate_sRGBProfile's colorant matrix: RGB -> XYZ at D65 from the
    primaries (_cmsBuildRGB2XYZtransferMatrix), Bradford-adapted to D50."""
    xn, yn = 0.3127, 0.3290
    xr, yr, xg, yg, xb, yb = 0.64, 0.33, 0.30, 0.60, 0.15, 0.06
    coef = _ev(_inv3([[xr, xg, xb], [yr, yg, yb],
                      [1 - xr - yr, 1 - xg - yg, 1 - xb - yb]]),
               [xn / yn, 1.0, (1.0 - xn - yn) / yn])
    m = [[coef[0] * xr, coef[1] * xg, coef[2] * xb],
         [coef[0] * yr, coef[1] * yg, coef[2] * yb],
         [coef[0] * (1.0 - xr - yr), coef[1] * (1.0 - xg - yg),
          coef[2] * (1.0 - xb - yb)]]
    src = [(xn / yn) * 1.0, 1.0, ((1 - xn - yn) / yn) * 1.0]
    cs, cd = _ev(_BRADFORD, src), _ev(_BRADFORD, _D50)
    cone = [[cd[0] / cs[0], 0.0, 0.0], [0.0, cd[1] / cs[1], 0.0],
            [0.0, 0.0, cd[2] / cs[2]]]
    return _per(_per(_inv3(_BRADFORD), _per(cone, _BRADFORD)), m)


def pipeline16(lab16: np.ndarray) -> np.ndarray:
    """(N, 3) Lab v4 16-bit codes -> (N, 3) sRGB 16-bit, as LittleCMS's
    unoptimized pipeline evaluates them."""
    f32 = np.float32
    s = lab16.astype(f32) / f32(65535.0)
    s = (s.astype(np.float64) * (65280.0 / 65535.0)).astype(f32)
    s = (s.astype(np.float64) * (65535.0 / 65280.0)).astype(f32)
    s = s.astype(np.float64)
    y = (s[:, 0] * 100.0 + 16.0) / 116.0
    x = y + 0.002 * (s[:, 1] * 255.0 - 128.0)
    z = y - 0.005 * (s[:, 2] * 255.0 - 128.0)

    def f_1(t):
        return np.where(t <= 24.0 / 116.0, (108.0 / 841.0)
                        * (t - 16.0 / 116.0), t * t * t)

    adj = 1 + 32767.0 / 32768.0
    xyz = np.stack([f_1(x) * _D50[0] / adj, f_1(y) * _D50[1] / adj,
                    f_1(z) * _D50[2] / adj], -1).astype(f32)
    inv = [[v * adj for v in row] for row in _inv3(_srgb_colorants())]
    xyz = xyz.astype(np.float64)
    lin = np.stack([xyz[:, 0] * inv[i][0] + xyz[:, 1] * inv[i][1]
                    + xyz[:, 2] * inv[i][2] for i in range(3)], -1)
    lin = lin.astype(f32).astype(np.float64)
    g, a, b, c, d = _SRGB
    disc = (a * d + b) ** g
    with np.errstate(invalid="ignore"):
        v = np.where(lin >= disc, (np.power(np.maximum(lin, 0), 1.0 / g) - b)
                     / a, lin / c)
    v = v.astype(f32).astype(np.float64) * 65535.0 + 0.5
    return np.clip(np.floor(v), 0, 65535).astype(np.int64)


def _grid() -> np.ndarray:
    global _GRID
    if _GRID is None:
        q = np.floor(np.arange(_N) * 65535 / (_N - 1) + 0.5).astype(np.int64)
        nodes = np.stack(np.meshgrid(q, q, q, indexing="ij"), -1)
        _GRID = pipeline16(nodes.reshape(-1, 3)).reshape(_N, _N, _N, 3)
    return _GRID


def tetrahedral16(inp: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """LittleCMS's TetrahedralInterp16 of (N, 3) 16-bit inputs in an
    (n, n, n, 3) grid."""
    a = inp.astype(np.int64) * (lut.shape[0] - 1)
    f = a + (a + 0x7FFF) // 0xFFFF                  # _cmsToFixedDomain
    i0, r = f >> 16, f & 0xFFFF
    i1 = np.where(inp == 0xFFFF, i0, i0 + 1)
    rx, ry, rz = r.T

    def c(dx, dy, dz):
        return lut[np.where(dx, i1[:, 0], i0[:, 0]),
                   np.where(dy, i1[:, 1], i0[:, 1]),
                   np.where(dz, i1[:, 2], i0[:, 2])]

    c0 = c(0, 0, 0)
    X, Y, Z, XY, XZ, YZ, XYZ = ((1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0),
                                (1, 0, 1), (0, 1, 1), (1, 1, 1))
    O = (0, 0, 0)
    # the six tetrahedra: a mask and, for rx, ry, rz, the two corners
    # whose difference weighs it
    cases = (((rx >= ry) & (ry >= rz), (X, O), (XY, X), (XYZ, XY)),
             ((rx >= ry) & (ry < rz) & (rz >= rx), (XZ, Z), (XYZ, XZ),
              (Z, O)),
             ((rx >= ry) & (ry < rz) & (rz < rx), (X, O), (XYZ, XZ),
              (XZ, X)),
             ((rx < ry) & (rx >= rz), (XY, Y), (Y, O), (XYZ, XY)),
             ((rx < ry) & (rx < rz) & (ry >= rz), (XYZ, YZ), (Y, O),
              (YZ, Y)),
             ((rx < ry) & (rx < rz) & (ry < rz), (XYZ, YZ), (YZ, Z),
              (Z, O)))
    out = np.zeros_like(c0)
    for mask, (a1, b1), (a2, b2), (a3, b3) in cases:
        rest = ((c(*a1) - c(*b1)) * rx[:, None] + (c(*a2) - c(*b2))
                * ry[:, None] + (c(*a3) - c(*b3)) * rz[:, None] + 0x8001)
        out = np.where(mask[:, None], (c0 + ((rest + (rest >> 16)) >> 16))
                       & 0xFFFF, out)
    return out


def lab_to_rgb(lab: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 LAB samples (a and b signed) -> (..., 3) uint8 RGB."""
    shape = lab.shape
    v = lab.reshape(-1, 3).astype(np.int64) ^ np.array([0, 128, 128])
    v = v * 257                                          # 8 -> 16 bits
    o = tetrahedral16(v, _grid())
    rgb = ((o * 65281 + 8388608) >> 24) & 0xFF          # FROM_16_TO_8
    return rgb.astype(np.uint8).reshape(shape)
