"""Hard quantization of the bottleneck against fixed levels.

Inference half of the reference Quantizer (quantizer.py:50-90): the
nearest level by squared distance. The soft/straight-through half waits
for the training port.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class QuantOut(NamedTuple):
    bn_q: torch.Tensor   # hard value levels[syms], float32
    syms: torch.Tensor   # int64 symbol indices


def quantize(x: torch.Tensor, levels: torch.Tensor) -> QuantOut:
    """Quantize x (..., C) against `levels` (L,): nearest level, ties to
    the lower index (argmin returns the first minimum, as jnp.argmin)."""
    d = (x.unsqueeze(-1) - levels) ** 2
    syms = torch.argmin(d, dim=-1)
    return QuantOut(bn_q=levels_select(levels, syms), syms=syms)


def levels_select(levels: torch.Tensor, syms: torch.Tensor) -> torch.Tensor:
    """levels[syms]: copies the precomputed table values bit-exactly, so the
    value<->symbol contract (models/grids.py) holds on both codec sides."""
    return levels[syms]
