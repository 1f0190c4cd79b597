"""Discretized mixture-of-logistics likelihood (DMLL) — the probability core.

PixelCNN++-style mixture with NON-shared per-channel mixture weights
(reference criterion/logistic_mixture.py):

  p(x_c) = sum_k pi_ck * [ sigmoid(s'_ck (x_c - mu~_ck + b/2))
                          - sigmoid(s'_ck (x_c - mu~_ck - b/2)) ]

with open tails at x_min/x_max, log-scales clamped >= -7, and for the RGB
scale channel autoregression through sigmoid'd lambda coefficients:
  mu~_g = mu_g + lam_gr x_r ,  mu~_b = mu_b + lam_br x_r + lam_bg x_g .

Layout is NHWC(+K trailing), as in the JAX reference: the network output
`l` (N,H,W,Kp) has channel index kp = ((p * C) + c) * K + k with
p in {pi, mu, log_s[, lambda]}.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from . import grids

_NUM_PARAMS_RGB = 4    # pi, mu, sigma, lambda
_NUM_PARAMS_OTHER = 3  # pi, mu, sigma
LOG_SCALES_MIN = -7.0


@dataclasses.dataclass(frozen=True)
class DMLLSpec:
    """Static parameters of a discretized logistic mixture model."""
    rgb_scale: bool
    x_min: float = 0.0
    x_max: float = 255.0
    L: int = 256

    @property
    def num_params(self) -> int:
        return _NUM_PARAMS_RGB if self.rgb_scale else _NUM_PARAMS_OTHER

    @property
    def bin_width(self) -> float:
        return grids.bin_width(self.x_min, self.x_max, self.L)

    @property
    def x_lower_bound(self) -> float:
        return self.x_min + 0.001

    @property
    def x_upper_bound(self) -> float:
        return self.x_max - 0.001


def non_shared_get_Kp(K: int, C: int) -> int:
    """Channels the prob-classifier must emit."""
    if C == 3:
        return _NUM_PARAMS_RGB * C * K
    return _NUM_PARAMS_OTHER * C * K


def non_shared_get_K(Kp: int, C: int) -> int:
    """Inverse of non_shared_get_Kp."""
    if C == 3:
        return Kp // (_NUM_PARAMS_RGB * C)
    return Kp // (_NUM_PARAMS_OTHER * C)


def _reshape_l(spec: DMLLSpec, l: torch.Tensor, C: int) -> torch.Tensor:
    """(N,H,W,Kp) -> (N,H,W,P,C,K)."""
    N, H, W, Kp = l.shape
    K = non_shared_get_K(Kp, C)
    return l.reshape(N, H, W, spec.num_params, C, K)


def extract_params(spec: DMLLSpec, l: torch.Tensor, C: int,
                   x: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Split `l` into (logit_pis, means~, log_scales), each (N,H,W,C,K).
    For the RGB scale with `x` (N,H,W,C) given, the means are
    lambda-adjusted with the observed channels."""
    lr = _reshape_l(spec, l, C)
    logit_pis = lr[..., 0, :, :]
    means = lr[..., 1, :, :]
    log_scales = torch.clamp(lr[..., 2, :, :], min=LOG_SCALES_MIN)
    if spec.rgb_scale and x is not None:
        assert C == 3, "lambda coefficients only defined for RGB (C=3)"
        lam = torch.sigmoid(lr[..., 3, :, :])
        xk = x.unsqueeze(-1)
        means = torch.stack([
            means[..., 0, :],
            means[..., 1, :] + lam[..., 0, :] * xk[..., 0, :],
            means[..., 2, :] + lam[..., 1, :] * xk[..., 0, :]
            + lam[..., 2, :] * xk[..., 1, :],
        ], dim=-2)
    return logit_pis, means, log_scales


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # log(1 + e^x) without torch's threshold shortcut (jax.nn.softplus)
    return torch.logaddexp(x, torch.zeros_like(x))


def nll(spec: DMLLSpec, x: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """Per-element negative log-likelihood in nats, (N,H,W,C):
      - cdf_delta  = sig(s'(x-mu+b/2)) - sig(s'(x-mu-b/2))
      - x < x_min+eps  -> log cdf_plus          (open lower tail)
      - x > x_max-eps  -> log(1 - cdf_min)      (open upper tail)
      - else           -> log(max(cdf_delta, 1e-12))
    then logsumexp over K with log-softmax'd pis."""
    C = x.shape[-1]
    logit_pis, means, log_scales = extract_params(spec, l, C, x)
    xk = x.unsqueeze(-1)
    centered = xk - means
    inv_stdv = torch.exp(-log_scales)
    half_bin = spec.bin_width / 2.0
    plus_in = inv_stdv * (centered + half_bin)
    min_in = inv_stdv * (centered - half_bin)
    cdf_delta = torch.sigmoid(plus_in) - torch.sigmoid(min_in)
    log_cdf_plus = plus_in - _softplus(plus_in)
    log_one_minus_cdf_min = -_softplus(min_in)
    out_a = torch.log(torch.clamp(cdf_delta, min=1e-12))
    out_b = torch.where(xk > spec.x_upper_bound, log_one_minus_cdf_min, out_a)
    log_probs = torch.where(xk < spec.x_lower_bound, log_cdf_plus, out_b)
    log_weighted = log_probs + torch.log_softmax(logit_pis, dim=-1)
    return -torch.logsumexp(log_weighted, dim=-1)


def bitcost(spec: DMLLSpec, x: torch.Tensor, l: torch.Tensor
            ) -> torch.Tensor:
    """Total nats of a batch under the mixture model (0-dim tensor)."""
    return torch.sum(nll(spec, x, l))


def pack_coder_params(spec: DMLLSpec, l: torch.Tensor, C: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 Optional[torch.Tensor]]:
    """Float32 per-pixel coder inputs for the v7 float CDF rows:
      pi    (N,H,W,C,K) softmax'd mixture weights
      mu    (N,H,W,C,K) RAW means (lambda conditioning happens per channel
                        with the decoded channel values)
      inv_s (N,H,W,C,K) exp(-clamp(log_s, -7))
      lam   (N,H,W,3,K) sigmoid'd coefficients (g<-r, b<-r, b<-g) or None
    """
    lr = _reshape_l(spec, l, C).to(torch.float32)
    pi = torch.softmax(lr[..., 0, :, :], dim=-1)
    mu = lr[..., 1, :, :]
    inv_s = torch.exp(-torch.clamp(lr[..., 2, :, :], min=LOG_SCALES_MIN))
    lam = torch.sigmoid(lr[..., 3, :, :]) if spec.rgb_scale else None
    return pi, mu, inv_s, lam
