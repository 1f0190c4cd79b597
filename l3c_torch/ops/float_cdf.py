"""v7 float CDF rows of the two-level RGB coding stage.

Port of the table builders the two Pallas kernels of `tools/pallas_cdf.py`
stood in for (`tpu_coder.rgb_coarse_tables_packed` / `rgb_fine_tables_packed`,
`l3c_tpu/ops/tpu_coder.py:612-702`). For RGB symbols s = 16a + b, the
coarse row holds the mixture CDF at the 16 coarse edges t_{16a}; the fine
row holds the CDF at the 17 edges of the pixel's coarse bin, renormalized
to the bin's mass with tail absorption. Table spec (v7): for L entries
  Q(0) = 0, Q(l) = floor(clip(C(t_l), 0, 1) * (65536 - 2L)) + 2l.

These float rows are NOT the v8 file format (files use the exact-integer
evaluator of ops/int_coder.py). The codec builds them on the decoded
scale-0 parameters on request (TorchBitcoding.decode_batch(float_rows=True))
so the two kernels run on the real distribution they were written for.

`mixture_cdf_q` and `fine_cdf_q` dispatch: CUDA tensors launch the
hand-written kernels (kernels/csrc/float_cdf.cu), CPU tensors take the
plain versions below, which compute the same function in PyTorch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..models import dmll as dmll_mod
from . import kernels

FINE_BITS = 4
N_COARSE = 16    # 256 >> FINE_BITS
FINE = 1 << FINE_BITS


def edge_cdf(pi: torch.Tensor, mu: torch.Tensor, inv_s: torch.Tensor,
             t: torch.Tensor) -> torch.Tensor:
    """Mixture CDF at edge targets t (..., E); params (..., K). Fixed-order
    accumulation over k."""
    acc = None
    for k in range(pi.shape[-1]):
        z = (t - mu[..., k:k + 1]) * inv_s[..., k:k + 1]
        term = pi[..., k:k + 1] * torch.sigmoid(z)
        acc = term if acc is None else acc + term
    return acc


def mixture_cdf_q(pi: torch.Tensor, mu: torch.Tensor, inv_s: torch.Tensor,
                  t: torch.Tensor, L: int) -> torch.Tensor:
    """(P, K) params + (L,) edges -> (P, L) int32
    floor(clip(C(t_l), 0, 1) * (65536 - 2L)). Kernel K1 on CUDA."""
    if pi.is_cuda:
        return kernels.mixture_cdf_q(pi.contiguous(), mu.contiguous(),
                                     inv_s.contiguous(), t.contiguous(), L)
    return mixture_cdf_q_plain(pi, mu, inv_s, t, L)


def mixture_cdf_q_plain(pi, mu, inv_s, t, L):
    acc = edge_cdf(pi, mu, inv_s, t[None, :])
    M = float(65536 - 2 * L)
    return torch.floor(torch.clamp(acc, 0.0, 1.0) * M).to(torch.int32)


def fine_cdf_q(pi: torch.Tensor, mu: torch.Tensor, inv_s: torch.Tensor,
               a: torch.Tensor, bw: float, t0: float) -> torch.Tensor:
    """(P, K) params + (P,) coarse symbols (f32) -> (P, 16) int32
    conditional fine rows, pre-finish. Kernel K2 on CUDA."""
    if pi.is_cuda:
        return kernels.fine_cdf_q(pi.contiguous(), mu.contiguous(),
                                  inv_s.contiguous(), a.contiguous(), bw, t0)
    return fine_cdf_q_plain(pi, mu, inv_s, a, bw, t0)


def fine_cdf_q_plain(pi, mu, inv_s, a, bw, t0):
    k = torch.arange(FINE + 1, dtype=torch.float32, device=pi.device)
    base = a[:, None] * float(FINE)
    t = (base + k) * bw + t0                                  # (P, 17)
    acc = edge_cdf(pi, mu, inv_s, t)
    cond = _fine_conditional(acc[:, :FINE], acc[:, :1], acc[:, -1:],
                             a[:, None])
    M = float(65536 - 2 * FINE)
    return torch.floor(torch.clamp(cond, 0.0, 1.0) * M).to(torch.int32)


def _fine_conditional(c_e, c_lo, c_hi, a):
    """Conditional CDF of the fine edges given the coarse bin's edge values;
    the first bin opens at -inf (lo := 0), the last closes at +inf
    (hi := 1), so out-of-range mass lands in the edge fine symbols."""
    lo = torch.where(a == 0, 0.0, c_lo)
    hi = torch.where(a == N_COARSE - 1, 1.0, c_hi)
    denom = torch.clamp(hi - lo, min=1e-9)
    return (c_e - lo) / denom


def finish_rows(q: torch.Tensor) -> torch.Tensor:
    """v7 finish: Q(l) = q + 2l, column 0 pinned to 0 (int32 rows)."""
    l_idx = torch.arange(q.shape[-1], dtype=torch.int32, device=q.device)
    return torch.where(l_idx == 0, 0, q + 2 * l_idx).to(torch.int32)


def channel_params_packed(spec: dmll_mod.DMLLSpec, packed, c: int,
                          decoded: Optional[torch.Tensor]
                          ) -> Tuple[torch.Tensor, ...]:
    """(pi, mu~, inv_s), each (n, K), for channel c from
    dmll.pack_coder_params output, with the lambda chain applied on the
    decoded channel VALUES (N,H,W,3) float (only columns < c are read)."""
    pi, mu, inv_s, lam = packed
    mu_c = mu[..., c, :]
    if spec.rgb_scale and c > 0 and decoded is not None:
        if c == 1:
            mu_c = mu_c + lam[..., 0, :] * decoded[..., 0:1]
        else:
            mu_c = (mu_c + lam[..., 1, :] * decoded[..., 0:1]
                    + lam[..., 2, :] * decoded[..., 1:2])
    K = mu_c.shape[-1]
    n = mu_c.numel() // K
    return (pi[..., c, :].reshape(n, K).contiguous(),
            mu_c.reshape(n, K).contiguous(),
            inv_s[..., c, :].reshape(n, K).contiguous())


def _bw_t0(spec) -> Tuple[float, float]:
    bw = float(np.float32(spec.bin_width))
    t0 = float(np.float32(spec.x_min - spec.bin_width / 2.0))
    return bw, t0


def coarse_edge_targets(spec, device) -> torch.Tensor:
    """(16,) f32 coarse edge targets t_{16a} = (16a) * bw + t0."""
    bw, t0 = _bw_t0(spec)
    e = torch.arange(N_COARSE, dtype=torch.float32, device=device) * 16.0
    return e * bw + t0


def rgb_coarse_tables_packed(spec, packed, c: int, decoded) -> torch.Tensor:
    """(n, 16) int32 v7 coarse rows of channel c."""
    pi, mu, inv_s = channel_params_packed(spec, packed, c, decoded)
    q = mixture_cdf_q(pi, mu, inv_s, coarse_edge_targets(spec, pi.device),
                      N_COARSE)
    return finish_rows(q)


def rgb_fine_tables_packed(spec, packed, c: int, decoded,
                           a: torch.Tensor) -> torch.Tensor:
    """(n, 16) int32 v7 fine rows of channel c given coarse symbols a."""
    pi, mu, inv_s = channel_params_packed(spec, packed, c, decoded)
    bw, t0 = _bw_t0(spec)
    q = fine_cdf_q(pi, mu, inv_s, a.reshape(-1).to(torch.float32), bw, t0)
    return finish_rows(q)
