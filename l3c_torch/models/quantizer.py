"""Soft-to-hard quantization of the bottleneck with a straight-through
estimator (reference quantizer.py:50-90; `l3c_tpu/models/quantizer.py`).

Distances to L fixed levels; the hard value is the nearest level, the
soft value sum(levels * softmax(-sigma * d^2)). The training bottleneck
`bn` is soft + (hard - soft).detach(): forward hard (up to the rounding of
that sum), gradient soft.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class QuantOut(NamedTuple):
    bn: Optional[torch.Tensor]   # straight-through value, or None (hard only)
    bn_q: torch.Tensor           # hard value levels[syms], float32
    syms: torch.Tensor           # int64 symbol indices


def quantize(x: torch.Tensor, levels: torch.Tensor,
             sigma: Optional[float] = None) -> QuantOut:
    """Quantize x (..., C) against `levels` (L,): nearest level, ties to
    the lower index (argmin returns the first minimum, as jnp.argmin).
    With `sigma` also the straight-through value `bn`; without it (the
    inference paths, which never read it) `bn` is None."""
    d = (x.unsqueeze(-1) - levels) ** 2
    syms = torch.argmin(d, dim=-1)
    bn_q = levels_select(levels, syms)
    bn = None
    if sigma is not None:
        phi = torch.softmax(-sigma * d, dim=-1)
        x_soft = torch.sum(levels * phi, dim=-1)
        bn = x_soft + (bn_q - x_soft).detach()
    return QuantOut(bn=bn, bn_q=bn_q, syms=syms)


def levels_select(levels: torch.Tensor, syms: torch.Tensor) -> torch.Tensor:
    """levels[syms]: copies the precomputed table values bit-exactly, so the
    value<->symbol contract (models/grids.py) holds on both codec sides."""
    return levels[syms]
