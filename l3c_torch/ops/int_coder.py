"""Exact-integer coding CDF in float32 — the format-v8 evaluator.

Port of `l3c_tpu/ops/int_coder.py`; every function keeps its name and
its arithmetic. Every value is an integer stored in float32 and every
product's exact result fits in 24 significand bits, so each operation is
exact on any IEEE platform: FMA contraction cannot change a result, and
adds of exact values are single correctly-rounded ops. The true
divisions (sigmoid reciprocal, fine conditional) are made exact with
floor-correction rounds that also cover a divide that is not correctly
rounded. Hence this module gives the SAME integers as the JAX evaluator
on the CPU, the TPU or the card, and a 2-edge encode lookup equals the
decode row entry bit for bit — the property v8 files rest on.

The one float stage is `pack_int_params` (softmax / exp / sigmoid of the
network output), which must run identically at encode and decode; the
file header's canary attests it (codec/bitcoding2.contract_canary).

Lane-major layout as in the reference: IntParams are (C, K', n) with the
pixel axis n minor; rows come out (L, n). On the card the codec does not
run these tensor functions: the rANS kernels evaluate the same
expressions in registers (kernels/csrc/int_cdf.cuh), as the JAX coder
programs do in-program. Here they are the plain versions the CPU path,
the tests and the header canary use.

Fixed-point formats (all stored in f32):
  z         Q10, saturated to +-16383 (|z| >= 16 saturates sigmoid)
  a_q       round(clip(inv_s * bin_w, 2^-8, 64) * 2^10)      <= 2^16
  sc_q      round(16 * a_hat * 2^10)  (RGB coarse edge step)  <= 2^20
  v_q       round(m_hat * a_hat * 2^10), |.| <= 2^24
  pi        Q12 (p_q <= 4096)
  sigmoid   Q12 out (0..4096), Q14 internal polynomial
  CDF c     Q14 (0..16384)
  table     integer in [0, 65536] per the +2l table spec
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models import dmll as dmll_mod

# ---- evaluator constants (FROZEN: part of the v8 bitstream format)
ZF = 10                      # z fraction bits
Z_SAT = 16 * 1024 - 1        # 16383
A_MIN, A_MAX = 1.0 / 256, 64.0
SIG_C = (16384, 16373, 8116, 2517, 419)   # e^-u poly, Q14, Horner
SIG_CB = (1507, 554, 75, 1)               # e^-(2^b), Q12
PI_Q = 4096                  # pi scale (Q12)
C_ONE = 16384                # CDF 1.0 (Q14)
V_CLAMP = float(1 << 24)

N_COARSE = 16
FINE = 16

_F = torch.float32


def _fdiv2(x: torch.Tensor, p: int) -> torch.Tensor:
    """floor(x / 2^p) — exact for integer-valued f32 x."""
    return torch.floor(x * (1.0 / (1 << p)))


def int_sigmoid(z: torch.Tensor) -> torch.Tensor:
    """sigmoid(z / 2^10) in Q12, exact-integer f32 in/out; monotone and
    exactly antisymmetric (s(z) + s(-z) == 4096)."""
    neg = z < 0
    za = torch.clamp(torch.abs(z), max=float(Z_SAT))
    i = _fdiv2(za, 10)                       # 0..15
    f = za - i * float(1 << 10)              # 0..1023
    # e^-f: Q14-internal Horner (f*p <= 2^24)
    p = torch.full_like(za, float(SIG_C[4]))
    for c in (SIG_C[3], SIG_C[2], SIG_C[1], SIG_C[0]):
        p = float(c) - _fdiv2(f * p, 10)
    e = _fdiv2(p, 2)                         # Q12
    # e^-i: conditional multiplies on the bits of i
    ib = i
    for b in range(4):
        half = _fdiv2(ib, 1)
        odd = ib - half * 2.0
        e = torch.where(odd > 0, _fdiv2(e * float(SIG_CB[b]), 12), e)
        ib = half
    # sp = floor(2^24 / (4096 + e)) with exact correction (the split d
    # keeps q*d products exact; two rounds cover +-2 of divide error)
    d = float(1 << 12) + e                   # 4096..8192
    num = torch.full_like(d, float(1 << 24))
    q = torch.floor(num / d)
    d_hi = _fdiv2(d, 6)
    d_lo = d - d_hi * float(1 << 6)
    for _ in range(2):
        r = (num - q * d_hi * float(1 << 6)) - q * d_lo
        q = q + (r >= d).to(_F) - (r < 0).to(_F)
    return torch.where(neg, float(1 << 12) - q, q)


def _sum_k(terms: torch.Tensor) -> torch.Tensor:
    acc = terms[0]
    for k in range(1, terms.shape[0]):
        acc = acc + terms[k]
    return torch.clamp(acc, 0.0, float(C_ONE))


def mixture_cdf_q14(p_q: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """CDF in Q14 from per-component z: p_q (K, n) Q12, z (K, E, n) Q10
    -> (E, n). Per-term products and partial sums stay exact, so the
    accumulation order does not matter."""
    return _sum_k(_fdiv2(p_q[:, None, :] * int_sigmoid(z), 10))


def quantize_edges(c_q14: torch.Tensor, l_idx: torch.Tensor, L: int
                   ) -> torch.Tensor:
    """Q(l) per the +2l table spec, exact-int f32 in [0, 65536]; c*M is
    split so every product stays within 24 significand bits."""
    M = 65536 - 2 * L
    m_hi, m_lo = M >> 7, M & 127
    q = (_fdiv2(c_q14 * float(m_hi), 7) + _fdiv2(c_q14 * float(m_lo), 14)
         + 2.0 * l_idx)
    q = torch.where(l_idx <= 0, 0.0, q)
    return torch.where(l_idx >= L, 65536.0, q)


def _floor_div(a: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Exact floor(a / d) for integer-valued f32, 0 <= a < 2^28 with <= 24
    significand bits, 1 <= d <= 2^14."""
    q = torch.floor(a / d)
    d_hi = _fdiv2(d, 7)
    d_lo = d - d_hi * float(1 << 7)
    for _ in range(2):
        r = (a - q * d_hi * float(1 << 7)) - q * d_lo
        q = q + (r >= d).to(_F) - (r < 0).to(_F)
    return q


# ------------------------------------------------------- packed params


class IntParams(NamedTuple):
    """Per-scale coder parameters as exact-integer f32 tensors, lane-major
    (C, K', n) with n = N*H*W minor and K' = topk or K. w is (3, K', n) for
    the RGB scale's lambda chain, else None."""
    p: torch.Tensor     # pi Q12
    a: torch.Tensor     # a_hat Q10        (fine/bn edge step)
    sc: torch.Tensor    # 16 * a_hat Q10   (RGB coarse edge step)
    v: torch.Tensor     # m_hat * a_hat Q10
    w: Optional[torch.Tensor]  # lam * a_hat Q10 (RGB) or None


def topk_rank(pi: torch.Tensor) -> torch.Tensor:
    """u8 descending rank of the mixture components along axis 1:
    rank_k = #components that beat k, ties to the lower index — the same
    selection as a stable descending top-k."""
    K = pi.shape[1]
    k_iota = torch.arange(K, dtype=pi.dtype, device=pi.device)[None, :, None]
    rank = torch.zeros_like(pi)
    for j in range(K):
        pj = pi[:, j:j + 1]
        rank = rank + torch.where(pi == pj, (j < k_iota).to(pi.dtype),
                                  (pj > pi).to(pi.dtype))
    return rank.to(torch.uint8)


def topk_index(rank: torch.Tensor, topk: int) -> torch.Tensor:
    """(C, topk, n) component index of each rank slot r < topk."""
    return torch.stack([(rank == r).to(torch.int32).argmax(dim=1)
                        for r in range(topk)], dim=1)


def _softmax_k(x: torch.Tensor) -> torch.Tensor:
    """Softmax over axis 1 written as jax.nn.softmax defines it:
    exp(x - max) / sum(exp(x - max))."""
    e = torch.exp(x - torch.amax(x, dim=1, keepdim=True))
    return e / torch.sum(e, dim=1, keepdim=True)


def pack_int_params(spec: dmll_mod.DMLLSpec, l: torch.Tensor, C: int,
                    topk: int = 0) -> IntParams:
    """Float mixture params `l` (N,H,W,Kp) -> IntParams. The single float
    stage of the v8 coder; the float-boundary definitions (softmax over K,
    LOG_SCALES_MIN clamp, sigmoid on the lambda slots) are
    dmll.pack_coder_params's. With topk, the components are selected on
    the raw pi LOGITS first (softmax is monotone per pixel) and the
    transcendentals run on the topk selected ones only."""
    return pack_int_params_nchw(spec, l.permute(0, 3, 1, 2), C, topk)


def pack_int_params_nchw(spec: dmll_mod.DMLLSpec, l: torch.Tensor, C: int,
                         topk: int = 0) -> IntParams:
    """pack_int_params on the classifier's output where the convolution
    wrote it, (N,Kp,H,W): channel (i C + c) K + k of parameter group i is
    already pixel-minor per plane, so no NHWC copy is made."""
    N, Kp, H, W = l.shape
    K = dmll_mod.non_shared_get_K(Kp, C)
    lr = l.reshape(N, spec.num_params, C, K, H * W)

    def tp(i):
        # parameter group i (pi logits, mu, log-scales, lambda): (C, K, n)
        return lr[:, i].to(_F).permute(1, 2, 0, 3).reshape(C, K, N * H * W)

    if topk and K > topk:
        pl = tp(0)
        idx = topk_index(topk_rank(pl), topk)      # (C, topk, n)

        def sel(x, ix=idx):
            # gathers copy the selected value itself, bit-exactly
            return torch.gather(x, 1, ix)

        pi = _softmax_k(sel(pl))
        mu = sel(tp(1))
        inv_s = torch.exp(-torch.clamp(sel(tp(2)),
                                       min=dmll_mod.LOG_SCALES_MIN))
        lam = None
        if spec.rgb_scale:
            # lam slot j conditions TARGET channel (1, 2, 2): each slot
            # follows its target channel's component selection
            lam = torch.sigmoid(sel(tp(3), idx[[1, 2, 2]]))
    else:
        pi = _softmax_k(tp(0))
        mu = tp(1)
        inv_s = torch.exp(-torch.clamp(tp(2), min=dmll_mod.LOG_SCALES_MIN))
        lam = torch.sigmoid(tp(3)) if spec.rgb_scale else None
    bw = float(np.float32(spec.bin_width))
    t0 = float(np.float32(spec.x_min - spec.bin_width / 2.0))
    a_hat = torch.clamp(inv_s * bw, A_MIN, A_MAX)
    # a true division on every device: the divisor is a tensor, because
    # by a Python scalar PyTorch divides on the CPU but multiplies with the
    # reciprocal on the card, which rounds otherwise in a quarter of the
    # values. The JAX package's header canary attests the division (its
    # constant inputs are folded), so the canaries agree only with it
    m_hat = (mu - t0) / torch.full((), bw, dtype=_F, device=mu.device)
    p_q = torch.round(pi * float(PI_Q))
    a_q = torch.round(a_hat * float(1 << ZF))
    sc_q = torch.round(a_hat * float(16 << ZF))
    v_q = torch.clamp(torch.round(m_hat * a_hat * float(1 << ZF)),
                      -V_CLAMP, V_CLAMP)
    w_q = None
    if lam is not None:
        # w slot j = lam_j * a_hat(target channel j), so that
        # v'_q = v_q + w_q * sym matches z = e * a_q(target) - v'_q
        tgt = torch.stack([a_hat[1], a_hat[2], a_hat[2]], dim=0)
        w_q = torch.round(lam * tgt * float(1 << ZF))
    return IntParams(p=p_q, a=a_q, sc=sc_q, v=v_q, w=w_q)


def apply_lambda_chain(v: torch.Tensor, c: int,
                       w_slots: Tuple[torch.Tensor, ...],
                       dec_syms: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """v' = clip(v + sum_j w_j * sym_j) for RGB channel c — THE single
    expression of the lambda chain. v, w_slots (K', n); dec_syms are the
    already-known channel symbols (exact ints 0..255), each (n,)."""
    if c == 1:
        v = v + w_slots[0] * dec_syms[0].to(_F)[None, :]
    elif c == 2:
        v = (v + w_slots[1] * dec_syms[0].to(_F)[None, :]
             + w_slots[2] * dec_syms[1].to(_F)[None, :])
    else:
        return v
    return torch.clamp(v, -V_CLAMP, V_CLAMP)


def channel_int_params(ip: IntParams, c: int,
                       dec_syms: Optional[Tuple[torch.Tensor, ...]] = None
                       ) -> Tuple[torch.Tensor, ...]:
    """(K', n) params for channel c, with the RGB lambda chain applied on
    the known channel SYMBOLS."""
    p, a, sc, v = ip.p[c], ip.a[c], ip.sc[c], ip.v[c]
    if ip.w is not None and c > 0 and dec_syms is not None:
        v = apply_lambda_chain(v, c, (ip.w[0], ip.w[1], ip.w[2]),
                               tuple(s.reshape(-1) for s in dec_syms))
    return p, a, sc, v


def _iota(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=_F, device=like.device)


def _edges2(e: torch.Tensor) -> torch.Tensor:
    """Edge spec -> (E, 1) or (E, n) f32."""
    return e if e.dim() == 2 else e[:, None]


def _cdf_one(p_q: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """CDF Q14 at ONE edge: p_q (K, n), z (K, n) clipped -> (n,). The same
    exact-integer function as mixture_cdf_q14."""
    return _sum_k(_fdiv2(p_q * int_sigmoid(z), 10))


def _clip_z(z: torch.Tensor) -> torch.Tensor:
    return torch.clamp(z, -float(Z_SAT), float(Z_SAT))


# ------------------------------------------------------ bn-scale tables


def bn_cdf_at_edges(p, a, v, e) -> torch.Tensor:
    """CDF Q14 at integer edge indices e ((E,) or (E, n)); params (K, n).
    Returns (E, n)."""
    z = _edges2(e)[None] * a[:, None, :] - v[:, None, :]
    return mixture_cdf_q14(p, _clip_z(z))


def bn_rows(ip: IntParams, C: int, L: int) -> torch.Tensor:
    """(L, C*n) int32 decode rows (u16 values) for a bottleneck scale."""
    outs = []
    iota = _iota(L, ip.p)
    for c in range(C):
        p, a, _, v = channel_int_params(ip, c)
        cd = bn_cdf_at_edges(p, a, v, iota)
        outs.append(quantize_edges(cd, iota[:, None], L))
    return torch.cat(outs, dim=1).to(torch.int32)


def bn_lookup(ip: IntParams, syms: torch.Tensor, C: int, L: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(start, freq) int32 for known symbols syms (C, n): evaluates ONLY
    edges s and s+1 per symbol (the 2-edge encode path)."""
    starts, freqs = [], []
    for c in range(C):
        p, a, _, v = channel_int_params(ip, c)
        s = syms[c].to(_F)
        qs = [quantize_edges(_cdf_one(p, _clip_z(e[None, :] * a - v)), e, L)
              for e in (s, s + 1.0)]
        starts.append(qs[0])
        freqs.append(qs[1] - qs[0])
    return (torch.stack(starts).to(torch.int32),
            torch.stack(freqs).to(torch.int32))


# ----------------------------------------------- RGB two-level tables


def _coarse_cdf(p, a_sc, v, e_coarse) -> torch.Tensor:
    """CDF Q14 at coarse edges e in COARSE units: z = e * sc_q - v."""
    z = _edges2(e_coarse)[None] * a_sc[:, None, :] - v[:, None, :]
    return mixture_cdf_q14(p, _clip_z(z))


def rgb_coarse_rows(ip: IntParams, c: int,
                    dec_syms: Optional[Tuple[torch.Tensor, ...]]
                    ) -> torch.Tensor:
    """(16, n) int32 coarse rows for RGB channel c."""
    p, a, sc, v = channel_int_params(ip, c, dec_syms)
    iota = _iota(N_COARSE, p)
    cd = _coarse_cdf(p, sc, v, iota)
    return quantize_edges(cd, iota[:, None], N_COARSE).to(torch.int32)


def rgb_coarse_lookup(ip: IntParams, c: int,
                      dec_syms: Optional[Tuple[torch.Tensor, ...]],
                      a_sym: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(start, freq) int32 for known coarse symbols a_sym (n,)."""
    p, a, sc, v = channel_int_params(ip, c, dec_syms)
    af = a_sym.reshape(-1).to(_F)
    qs = [quantize_edges(_cdf_one(p, _clip_z(e[None, :] * sc - v)), e,
                         N_COARSE) for e in (af, af + 1.0)]
    return qs[0].to(torch.int32), (qs[1] - qs[0]).to(torch.int32)


def _cond_bounds(af, c_lo, c_hi):
    """Tail-absorbed conditional bounds (lo, denominator) — THE single
    expression shared by the decode rows and the encode lookups."""
    lo = torch.where(af == 0, 0.0, c_lo)
    hi = torch.where(af == N_COARSE - 1, float(C_ONE), c_hi)
    return lo, torch.clamp(hi - lo, min=1.0)


def _cond_norm(c_e, lo, d) -> torch.Tensor:
    """Conditional renormalization floor((c_e - lo) * C_ONE / d), exact."""
    num = torch.clamp(c_e - lo, min=0.0) * float(C_ONE)
    return torch.clamp(_floor_div(num, d), 0.0, float(C_ONE))


def _fine_cond_q14(p, a, sc, v, a_sym, e_fine) -> torch.Tensor:
    """Conditional CDF Q14 at fine edges e_fine given coarse symbols a_sym
    (n,); z_b = z_a + b * a_q. Tail absorption: the first/last coarse bin
    open toward -inf/+inf. Returns (E, n)."""
    af = a_sym.to(_F)[None, :]                              # (1, n)
    z_a = af * sc - v                                       # (K, n)
    b_off = _edges2(e_fine)[None] * a[:, None, :]           # (K, E, n)
    c_e = mixture_cdf_q14(p, _clip_z(z_a[:, None, :] + b_off))
    c_lo = mixture_cdf_q14(p, _clip_z(z_a)[:, None, :])
    c_hi = mixture_cdf_q14(p, _clip_z(z_a + float(FINE) * a)[:, None, :])
    lo, d = _cond_bounds(af, c_lo, c_hi)
    return _cond_norm(c_e, lo, d)


def rgb_fine_rows(ip: IntParams, c: int,
                  dec_syms: Optional[Tuple[torch.Tensor, ...]],
                  a_sym: torch.Tensor) -> torch.Tensor:
    """(16, n) int32 fine rows conditional on coarse symbols."""
    p, a, sc, v = channel_int_params(ip, c, dec_syms)
    iota = _iota(FINE, p)
    cond = _fine_cond_q14(p, a, sc, v, a_sym.reshape(-1), iota)
    return quantize_edges(cond, iota[:, None], FINE).to(torch.int32)


def rgb_fine_lookup(ip: IntParams, c: int,
                    dec_syms: Optional[Tuple[torch.Tensor, ...]],
                    a_sym: torch.Tensor, b_sym: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(start, freq) int32 for known (coarse, fine) symbol pairs."""
    p, a, sc, v = channel_int_params(ip, c, dec_syms)
    af = a_sym.reshape(-1).to(_F)
    bf = b_sym.reshape(-1).to(_F)
    z_a = af[None, :] * sc - v
    c_lo = _cdf_one(p, _clip_z(z_a))
    c_hi = _cdf_one(p, _clip_z(z_a + float(FINE) * a))
    lo, d = _cond_bounds(af, c_lo, c_hi)
    qs = []
    for e in (bf, bf + 1.0):
        c_e = _cdf_one(p, _clip_z(z_a + e[None, :] * a))
        qs.append(quantize_edges(_cond_norm(c_e, lo, d), e, FINE))
    return qs[0].to(torch.int32), (qs[1] - qs[0]).to(torch.int32)
