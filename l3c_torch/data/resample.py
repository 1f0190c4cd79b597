"""Pillow's resampling (Image.resize) bit for bit, on torch integer tensors.

Pillow resizes 8-bit images in fixed point (libImaging/Resample.c): per
output pixel a window of input pixels and its filter weights, normalised
over the window (clipped at the borders) in float64 and rounded to 22-bit
integers; int32 sums with a rounding half; the horizontal pass first,
clipped to uint8, then the vertical one. An axis whose size does not
change is not resampled. The bicubic x2 pyramid of the RGB baselines
(models/layers.bicubic_downsample_x2) and the Lanczos downscales of data
prep both run through here.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

PREC = 22  # Pillow's PRECISION_BITS = 32 - 8 - 2


def _bicubic(t: float, a: float = -0.5) -> float:
    t = abs(t)
    if t < 1.0:
        return ((a + 2.0) * t - (a + 3.0)) * t * t + 1.0
    if t < 2.0:
        return (((t - 5.0) * t + 8.0) * t - 4.0) * a
    return 0.0


def _sinc(t: float) -> float:
    if t == 0.0:
        return 1.0
    t = t * math.pi
    return math.sin(t) / t


def _lanczos(t: float) -> float:
    return _sinc(t) * _sinc(t / 3) if -3.0 <= t < 3.0 else 0.0


# name -> (support, filter), as Resample.c's filter table
FILTERS = {"bicubic": (2.0, _bicubic), "lanczos": (3.0, _lanczos)}


@functools.lru_cache(maxsize=None)
def coeffs(in_size: int, out_size: int, name: str
           ) -> Tuple[np.ndarray, np.ndarray]:
    """Resample.c's precompute_coeffs and normalize_coeffs_8bpc for the
    whole extent: (out_size, taps) input indices and int32 coefficients,
    the taps past a window's end (clipped at a border) weighted 0. The
    window's weights are summed in order, as Pillow sums them."""
    support, fn = FILTERS[name]
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    support *= fscale
    ss = 1.0 / fscale
    taps = int(math.ceil(support)) * 2 + 1
    idx = np.zeros((out_size, taps), np.int64)
    k = np.zeros((out_size, taps), np.int32)
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(0, int(center - support + 0.5))     # C's truncation
        n = min(in_size, int(center + support + 0.5)) - xmin
        w = [fn((x + xmin - center + 0.5) * ss) for x in range(n)]
        ww = 0.0
        for v in w:
            ww += v
        for x, v in enumerate(w):
            v = v / ww if ww != 0.0 else v
            k[i, x] = int(v * (1 << PREC) + (0.5 if v >= 0 else -0.5))
        idx[i, :n] = np.arange(xmin, xmin + n)
        idx[i, n:] = xmin
    return idx, k


def resample_pass(x: torch.Tensor, axis: int, out_size: int,
                  name: str) -> torch.Tensor:
    """One pass along `axis`: int32 in, uint8-valued int32 out. |sum| <=
    255 * sum|k| + 2^21 < 2^31, so int32 is exact; the floor division is
    Pillow's arithmetic shift and clipping after it Pillow's clip8."""
    idx, k = coeffs(x.shape[axis], out_size, name)
    shape = [1] * x.dim()
    shape[axis] = out_size
    idx_t = torch.as_tensor(idx.T.copy(), device=x.device)   # (taps, out)
    k_t = torch.as_tensor(k.T.copy(), device=x.device)
    acc = torch.full((), 1 << (PREC - 1), dtype=torch.int32, device=x.device)
    for d in range(idx.shape[1]):
        acc = acc + k_t[d].view(shape) * x.index_select(axis, idx_t[d])
    return torch.clamp(torch.div(acc, 1 << PREC, rounding_mode="floor"),
                       0, 255)


def resize(img: np.ndarray, size: Tuple[int, int], name: str = "lanczos"
           ) -> np.ndarray:
    """Image.fromarray(img).resize(size, filter) of an (H, W) or (H, W, C)
    uint8 array; size is (width, height), as Pillow takes it."""
    w, h = size
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or w < 1 or h < 1:
        raise ValueError(f"resize takes (H, W[, C]) uint8 and a positive "
                         f"size, got {img.dtype} {img.shape} -> {size}")
    x = torch.from_numpy(np.ascontiguousarray(img).astype(np.int32))
    if w != img.shape[1]:
        x = resample_pass(x, 1, w, name)          # horizontal first
    if h != img.shape[0]:
        x = resample_pass(x, 0, h, name)
    return x.to(torch.uint8).numpy()
