"""Bits-per-subpixel from the network output (reference
multiscale_blueprint.py, the Losses container of multiscale_network.py).

- per-scale cost in nats = sum of DMLL NLL; the RGB scale targets the int
  image under the L=256 RGB mixture, coarser scales the bottlenecks under
  the L=q.L mixture (L3C) or the downsampled RGB images under the RGB
  mixture (the baselines)
- the coarsest non-recursive scale additionally pays a closed-form uniform
  prior, numel * ln(L)
- bpsp = nats / (ln 2 * num_subpixels), with the PRE-pad subpixel count
  when images were padded for the pyramid
- the training objective (loss_pc) sums every scale's cost, recursive ones
  included, without the uniform tail
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .config import MsConfig
from .models import dmll
from .models.network import Out


class MultiscaleLoss(NamedTuple):
    loss_pc: torch.Tensor             # training objective (bpsp)
    nonrecursive_bpsps: Tuple         # per-scale bpsp incl. uniform tail
    recursive_bpsps: Optional[Tuple] = None   # incl. recursive scales


def rgb_spec(cfg: MsConfig) -> dmll.DMLLSpec:
    return dmll.DMLLSpec(rgb_scale=True, x_min=0.0, x_max=255.0, L=256)


def bn_spec(cfg: MsConfig) -> dmll.DMLLSpec:
    """Mixture spec of the scales above 0: the bottlenecks', or the RGB
    spec for the baselines."""
    if cfg.rgb_bicubic_baseline:
        return rgb_spec(cfg)
    lo, hi = cfg.q.levels_range
    return dmll.DMLLSpec(rgb_scale=False, x_min=lo, x_max=hi, L=cfg.q.L)


def scale_costs_nats(cfg: MsConfig, out: Out) -> List[torch.Tensor]:
    """Per-scale total nats, fine->coarse, excluding the uniform tail."""
    spec0, spec_n = rgb_spec(cfg), bn_spec(cfg)
    costs = [dmll.bitcost(spec0, out.S[0].to(torch.float32), out.P[0])]
    for i in range(1, len(out.P)):
        # the baselines' targets are the downsampled images' pixels
        target = (out.S[i].to(torch.float32) if cfg.rgb_bicubic_baseline
                  else out.bn[i])
        costs.append(dmll.bitcost(spec_n, target, out.P[i]))
    return costs


def uniform_tail_nats(cfg: MsConfig, out: Out, index: int) -> float:
    """nats to store scale `index` under a uniform prior."""
    L = 256 if index == 0 or cfg.rgb_bicubic_baseline else cfg.q.L
    return float(int(np.prod(out.S[index].shape)) * np.log(L))


def compute_loss(cfg: MsConfig, out: Out,
                 num_subpixels_before_pad: Optional[int] = None,
                 auto_recursive_from: Optional[int] = None
                 ) -> MultiscaleLoss:
    """The loss of `out`. With auto_recursive_from = S (the config's scale
    count, when `out` holds recursed scales), nonrecursive_bpsps are the
    first S scales' costs plus the uniform tail of scale S's symbols, and
    recursive_bpsps every scale's plus the uniform tail of the last."""
    costs = scale_costs_nats(cfg, out)
    num_subpixels = int(np.prod(out.S[0].shape))
    if num_subpixels_before_pad:
        assert num_subpixels_before_pad <= num_subpixels
        num_subpixels = num_subpixels_before_pad
    conversion = float(np.log(2.0) * num_subpixels)
    costs_bpsp = [c / conversion for c in costs]
    last = len(out.S) - 1
    final_idx = last if auto_recursive_from is None else auto_recursive_from
    nonrecursive = tuple(costs_bpsp[:final_idx]) + (
        uniform_tail_nats(cfg, out, final_idx) / conversion,)
    recursive = None
    if auto_recursive_from is not None:
        recursive = tuple(costs_bpsp) + (
            uniform_tail_nats(cfg, out, last) / conversion,)
    return MultiscaleLoss(loss_pc=sum(costs_bpsp),
                          nonrecursive_bpsps=nonrecursive,
                          recursive_bpsps=recursive)


def total_bpsp(loss: MultiscaleLoss) -> torch.Tensor:
    """Reported eval bpsp: the non-recursive scales + the uniform tail."""
    return sum(loss.nonrecursive_bpsps)
