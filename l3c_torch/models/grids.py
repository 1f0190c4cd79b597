"""Symbol/level grids shared by the quantizer, the loss and the codec.

THE single source of truth for the value<->symbol mapping: every level
table is derived from one elementary float32 expression
`s * bin_width + x_min` (one IEEE mul + one IEEE add), identical in numpy,
PyTorch and the JAX reference, so `levels[s] == to_bn(s)` bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch


def bin_width(x_min: float, x_max: float, L: int) -> float:
    """Spacing between adjacent levels, as a float32 value."""
    return float(np.float32(np.float32(x_max - x_min) / np.float32(L - 1)))


def levels(x_min: float, x_max: float, L: int) -> np.ndarray:
    """The L quantization levels as float32: levels[s] = s*bw + x_min."""
    bw = np.float32(bin_width(x_min, x_max, L))
    s = np.arange(L, dtype=np.float32)
    return (s * bw + np.float32(x_min)).astype(np.float32)


def to_sym(x: torch.Tensor, x_min: float, x_max: float, L: int
           ) -> torch.Tensor:
    """Values -> int64 symbol indices by uniform binning (round)."""
    bw = bin_width(x_min, x_max, L)
    x = torch.clamp(x, x_min, x_max)
    return torch.round((x - x_min) / bw).to(torch.int64)


def to_bn(S: torch.Tensor, x_min: float, x_max: float, L: int
          ) -> torch.Tensor:
    """Integer symbols -> float32 values; bit-identical to levels[S]."""
    bw = bin_width(x_min, x_max, L)
    return S.to(torch.float32) * bw + x_min


def targets_grid(x_min: float, x_max: float, L: int) -> np.ndarray:
    """The L+1 CDF evaluation points: bin edges t_l = x_min - bw/2 + l*bw."""
    bw = np.float32(bin_width(x_min, x_max, L))
    lo = np.float32(np.float32(x_min) - bw / np.float32(2))
    l = np.arange(L + 1, dtype=np.float32)
    return (l * bw + lo).astype(np.float32)
