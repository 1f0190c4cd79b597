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

`nll` dispatches on the device: a CUDA tensor goes through the K6 kernels
(csrc/dmll.cu, forward and backward, as one autograd.Function), a CPU
tensor through `nll_plain`, differentiated by autograd.
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
    # torch.maximum, not clamp: half the gradient at an exact tie, as
    # jnp.maximum (and K6) pass it
    log_scales = torch.maximum(lr[..., 2, :, :], _const(LOG_SCALES_MIN, l))
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


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), v, dtype=like.dtype, device=like.device)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # log(1 + e^x) without torch's threshold shortcut (jax.nn.softplus)
    return torch.logaddexp(x, torch.zeros_like(x))


def nll(spec: DMLLSpec, x: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """Per-element negative log-likelihood in nats, (N,H,W,C), of the
    target x (N,H,W,C) under the mixture l (N,H,W,Kp); differentiable
    w.r.t. both. CUDA tensors run K6 (forward and backward), CPU tensors
    `nll_plain`."""
    if l.is_cuda:
        return _NllK6.apply(spec, x, l)
    return nll_plain(spec, x, l)


class _NllK6(torch.autograd.Function):
    """nll through the K6 kernels: l is read as the NCHW planes the
    classifier wrote (no copy when l is their NHWC view, as the training
    forward hands it), and grad_l comes back as the same view."""

    @staticmethod
    def forward(ctx, spec: DMLLSpec, x: torch.Tensor, l: torch.Tensor):
        from ..ops import kernels
        l_nchw = l.permute(0, 3, 1, 2).contiguous()
        x = x.contiguous()
        ctx.spec = spec
        ctx.save_for_backward(l_nchw, x)
        return kernels.dmll_nll(l_nchw, x, spec.rgb_scale,
                                *_k6_consts(spec))

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        from ..ops import kernels
        l_nchw, x = ctx.saved_tensors
        gl, gx = kernels.dmll_nll_grad(l_nchw, x, g.contiguous(),
                                       ctx.spec.rgb_scale,
                                       *_k6_consts(ctx.spec))
        return None, gx, gl.permute(0, 2, 3, 1)


def _k6_consts(spec: DMLLSpec) -> Tuple[float, float, float]:
    return spec.bin_width / 2.0, spec.x_lower_bound, spec.x_upper_bound


def nll_plain(spec: DMLLSpec, x: torch.Tensor, l: torch.Tensor
              ) -> torch.Tensor:
    """The plain PyTorch version of nll (per-element, nats, (N,H,W,C)):
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
    out_a = torch.log(torch.maximum(cdf_delta, _const(1e-12, cdf_delta)))
    out_b = torch.where(xk > spec.x_upper_bound, log_one_minus_cdf_min, out_a)
    log_probs = torch.where(xk < spec.x_lower_bound, log_cdf_plus, out_b)
    log_weighted = log_probs + torch.log_softmax(logit_pis, dim=-1)
    return -torch.logsumexp(log_weighted, dim=-1)


def bitcost(spec: DMLLSpec, x: torch.Tensor, l: torch.Tensor
            ) -> torch.Tensor:
    """Total nats of a batch under the mixture model (0-dim tensor)."""
    return torch.sum(nll(spec, x, l))


def mean_symbol_probs(spec: DMLLSpec, x: torch.Tensor, l: torch.Tensor
                      ) -> torch.Tensor:
    """The mean PREDICTED symbol distribution p_y, (L,): each grid
    symbol's discretized mixture probability averaged over every pixel and
    channel (x, NHWC, gives the observed channels for the lambda chain, as
    in nll). By linearity the mean of the bins' probabilities is the
    difference of the mean CDFs at the L - 1 interior edges, so one edge
    at a time reduces to a scalar and no (pixels, L) tensor is made; the
    open tails go to the edge symbols (CDF 0 below, 1 above)."""
    C = x.shape[-1]
    logit_pis, means, log_scales = extract_params(spec, l, C, x)
    pis = torch.softmax(logit_pis, dim=-1)
    inv_s = torch.exp(-log_scales)
    edges = (spec.x_min + spec.bin_width / 2.0 + spec.bin_width
             * torch.arange(spec.L - 1, dtype=torch.float32, device=l.device))
    m = torch.stack([torch.mean(torch.sum(
        pis * torch.sigmoid((t - means) * inv_s), dim=-1)) for t in edges])
    zero = torch.zeros(1, dtype=m.dtype, device=m.device)
    return torch.diff(torch.cat([zero, m, zero + 1]))


def sample(spec: DMLLSpec, l: torch.Tensor, C: int,
           generator: torch.Generator) -> torch.Tensor:
    """Draw x ~ p(.|l), (N,H,W,C) float, with `generator` (on l's
    device): the component by Gumbel-max, then an inverse-CDF logistic
    draw, uniforms in [1e-5, 1 - 1e-5); for RGB the selected components'
    lambda coefficients shift G and B by the clamped earlier channels, and
    every channel is clamped to [0, 255]."""
    lr = _reshape_l(spec, l, C)
    logit_pis = lr[..., 0, :, :]

    def uniform(shape):
        u = torch.rand(shape, generator=generator, dtype=l.dtype,
                       device=l.device)
        return 1e-5 + (1.0 - 2e-5) * u

    sel = torch.argmax(logit_pis - torch.log(-torch.log(
        uniform(logit_pis.shape))), dim=-1)                     # NHWC
    pick = lambda a, s: torch.gather(a, -1, s.unsqueeze(-1)).squeeze(-1)
    means = pick(lr[..., 1, :, :], sel)
    log_scales = torch.clamp(pick(lr[..., 2, :, :], sel),
                             min=LOG_SCALES_MIN)
    u = uniform(means.shape)
    x = means + torch.exp(log_scales) * (torch.log(u) - torch.log(1.0 - u))
    if spec.rgb_scale:
        assert C == 3
        lam = torch.sigmoid(lr[..., 3, :, :])        # slots (g_r, b_r, b_g)
        lam_gr = pick(lam[..., 0, :], sel[..., 1])
        lam_br = pick(lam[..., 1, :], sel[..., 2])
        lam_bg = pick(lam[..., 2, :], sel[..., 2])
        x0 = torch.clamp(x[..., 0], 0.0, 255.0)
        x1 = torch.clamp(x[..., 1] + lam_gr * x0, 0.0, 255.0)
        x2 = torch.clamp(x[..., 2] + lam_br * x0 + lam_bg * x1, 0.0, 255.0)
        x = torch.stack([x0, x1, x2], dim=-1)
    return x


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
