"""scipy.ndimage's map_coordinates and gaussian_filter, bit for bit, at the
arguments data/synth.py calls them with.

Both run in float64 numpy and repeat the C code's arithmetic
(scipy/ndimage/src/ni_interpolation.c, ni_filters.c) step for step, so
that the results are scipy's to the last bit:

  - map_coordinates(input, [rows, cols], order=1, mode="wrap" | "reflect")
    on a 2-D input: each coordinate is first mapped into the input the way
    map_coordinate() maps it ("wrap" is scipy's legacy wrap, whose period
    is n - 1, not n; "reflect" is half-sample symmetric), then the two taps
    of each axis are read (a tap past an edge is mapped as the mode says),
    weighted by 1 - t and 1 - (1 - t), and the four products
    value * row weight * column weight summed from 0.0, the column index
    fastest. Order 1 needs no spline prefilter.
  - gaussian_filter(input, sigma) on a 2-D input, truncate 4.0,
    mode "reflect": the kernel exp(-0.5 / sigma^2 * x^2) over
    x = -r..r, r = int(4 sigma + 0.5), normalised by its sum; axis 0, then
    axis 1, each through correlate1d's symmetric loop (the centre tap
    first, then (left + right) * w from the outermost pair inwards).

Any other argument raises ValueError.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

MODES = ("wrap", "reflect")


def _map(c: np.ndarray, n: int, mode: str) -> np.ndarray:
    """ni_interpolation.c's map_coordinate: a coordinate outside
    [0, n - 1] mapped back in (float64 throughout, the integer casts
    truncating)."""
    c = c.copy()
    if n <= 1:
        c[(c < 0) | (c > n - 1)] = 0.0
        return c
    lo, hi = c < 0, c > n - 1
    x = c[lo]
    if mode == "wrap":
        sz = float(n - 1)
        c[lo] = x + sz * (np.trunc(-x / sz) + 1.0)
        y = c[hi]
        c[hi] = y - sz * np.trunc(y / sz)
        return c
    sz2 = float(2 * n)
    far = x < -sz2
    x[far] = sz2 * np.trunc(-x[far] / sz2) + x[far]
    c[lo] = np.where(x < -n, x + sz2,
                     np.where(x > -1e-15, 1e-15, -x) - 1.0)
    y = c[hi]
    y = y - sz2 * np.trunc(y / sz2)
    c[hi] = np.where(y >= n, sz2 - y - 1.0, y)
    return c


def _tap(i: np.ndarray, n: int, mode: str) -> np.ndarray:
    """The input index a filter tap past an edge reads."""
    if n <= 1:
        return np.zeros_like(i)
    if mode == "wrap":
        return np.where(i < 0, i + (n - 1), np.where(i >= n, i - (n - 1), i))
    return np.where(i < 0, -i - 1, np.where(i >= n, 2 * n - i - 1, i))


def map_coordinates(input: np.ndarray, coordinates: Sequence[np.ndarray],
                    order: int = 1, mode: str = "wrap") -> np.ndarray:
    """scipy.ndimage.map_coordinates(input, coordinates, order=1, mode=mode)
    for a 2-D float64 input and two coordinate arrays of one shape."""
    if order != 1 or mode not in MODES:
        raise ValueError(f"map_coordinates supports order=1 with mode "
                         f"{' or '.join(MODES)}, got order={order} "
                         f"mode={mode!r}")
    a = np.asarray(input)
    if a.ndim != 2 or a.dtype != np.float64 or len(coordinates) != 2:
        raise ValueError(f"map_coordinates takes a 2-D float64 input and two"
                         f" coordinate arrays, got {a.dtype} {a.shape} and "
                         f"{len(coordinates)}")
    rows, cols = (np.asarray(c, np.float64) for c in coordinates)
    if rows.shape != cols.shape:
        raise ValueError(f"coordinate arrays differ in shape: {rows.shape} "
                         f"and {cols.shape}")
    taps, weights = [], []
    for c, n in zip((rows, cols), a.shape):
        c = _map(c, n, mode)
        start = np.floor(c)
        t = c - start
        w0 = 1.0 - t
        i0 = start.astype(np.int64)
        taps.append((_tap(i0, n, mode), _tap(i0 + 1, n, mode)))
        weights.append((w0, 1.0 - w0))
    out = np.zeros(rows.shape, np.float64)
    for ry, wy in zip(*(taps[0], weights[0])):
        for rx, wx in zip(*(taps[1], weights[1])):
            out = out + a[ry, rx] * wy * wx
    return out


def _kernel(sigma: float) -> np.ndarray:
    """scipy's _gaussian_kernel1d at order 0, truncate 4.0."""
    radius = int(4.0 * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1)
    phi_x = np.exp(-0.5 / (sigma * sigma) * x ** 2)
    return phi_x / phi_x.sum()


def _correlate_axis(a: np.ndarray, w: np.ndarray, axis: int) -> np.ndarray:
    """correlate1d with a symmetric odd kernel along `axis`, mode
    "reflect" (the line extended half-sample symmetric)."""
    r = len(w) // 2
    a = np.moveaxis(a, axis, 0)
    n = a.shape[0]
    ext = np.pad(a, ((r, r),) + ((0, 0),) * (a.ndim - 1), mode="symmetric")
    out = ext[r:r + n] * w[r]
    for j in range(-r, 0):
        out = out + (ext[r + j:r + j + n] + ext[r - j:r - j + n]) * w[r + j]
    return np.moveaxis(out, 0, axis)


def gaussian_filter(input: np.ndarray, sigma: float, mode: str = "reflect",
                    truncate: float = 4.0) -> np.ndarray:
    """scipy.ndimage.gaussian_filter(input, sigma) of a 2-D float64 array
    with a scalar sigma > 0."""
    a = np.asarray(input)
    if mode != "reflect" or truncate != 4.0 or a.ndim != 2 \
            or a.dtype != np.float64 or not np.isscalar(sigma) \
            or not sigma > 0:
        raise ValueError(f"gaussian_filter supports a 2-D float64 input, a "
                         f"scalar sigma > 0, mode 'reflect' and truncate 4.0,"
                         f" got {a.dtype} {a.shape}, sigma={sigma!r}, "
                         f"mode={mode!r}, truncate={truncate}")
    w = _kernel(float(sigma))
    for axis in (0, 1):
        a = _correlate_axis(a, w, axis)
    return a
