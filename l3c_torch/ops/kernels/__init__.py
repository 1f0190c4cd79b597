"""Launchers of the hand-written CUDA kernels (csrc/*.cu).

Each launcher checks device, dtype, shape and contiguity, allocates its
outputs with torch.empty, launches on PyTorch's current stream, raises if
the launch was refused, and adds one to its entry of `launches`. Nothing
here runs at import: the libraries are built at first launch
(build.py). The dispatching wrappers that CPU tensors route to the plain
versions are `float_cdf.mixture_cdf_q` / `fine_cdf_q`, the channel-level
coders of `gpu_coder` (`encode_*` / `decode_*`), the codec's
`bitcoding2.pack_int` and the mixture loss `models/dmll.nll`.

| kernel         | source             | replaces (TPU)                        |
| mixture_cdf_q  | csrc/float_cdf.cu  | tools/pallas_cdf.py:48 (Pallas)       |
|                | + csrc/ptx.cuh     | a tile of 64 pixels a block through   |
|                |                    | shared memory (cp.async), 4 edges a   |
|                |                    | thread, one int4 store each; the      |
|                |                    | special-function unit's sigmoid       |
| fine_cdf_q     | csrc/float_cdf.cu  | tools/pallas_cdf.py:120 (Pallas)      |
|                | + csrc/ptx.cuh     | a tile of 128 pixels, a pixel's 17    |
|                |                    | edges a thread, rows staged in shared |
|                |                    | memory and stored flat as int4; expf  |
|                |                    | and a refined reciprocal              |
| rans_encode    | csrc/rans.cu       | l3c_tpu/ops/tpu_coder.py:305 (scan)   |
|                |                    | + codec/bitcoding2.py:320/:417 lookups|
| rans_decode    | csrc/rans.cu       | l3c_tpu/ops/tpu_coder.py:481 (scan)   |
|                |                    | + codec/bitcoding2.py:344/:361 rows   |
| pack_int       | csrc/pack.cu       | l3c_tpu/ops/int_coder.py:259 (XLA, in |
|                |                    | get_P, codec/bitcoding2.py:279)       |
| dmll_nll       | csrc/dmll.cu       | l3c_tpu/models/dmll.py:126 (XLA, in   |
| dmll_nll_grad  | + csrc/ptx.cuh     | the train step, train/trainer.py:113) |
|                |                    | with its VJP; a tile of 32 pixels a   |
|                |                    | block through shared memory           |
|                |                    | (cp.async), two lanes a (pixel,       |
|                |                    | channel), sums over k by shuffles;    |
|                |                    | 8 channels a block, a launch a group  |

Every kernel takes the sizes the JAX package takes. Its fast variant
covers K <= 10 components (and K1's L <= 32 edges, the coder's L <= 33
symbols); beyond them the same launcher runs the source's generic variant,
never the plain version (K3/K4's: the RGB baselines' unit 0 at L = 256 and
every model with K' > 10; csrc/rans.cu says how they are built). What
caps remain: K <= MAX_K = 255
in K3-K6 (the JAX package ranks components as u8,
l3c_tpu/ops/int_coder.py:216) and L <= MAX_L = 256 in K3/K4 (u8 symbols;
the v8 evaluator's edge products stay exact below 2^24 only for edges
<= 256). K1/K2 take any K and L.
"""
from __future__ import annotations

import collections
from typing import Optional, Tuple

import numpy as np
import torch

from . import build

KERNELS = ("mixture_cdf_q", "fine_cdf_q", "rans_encode", "rans_decode",
           "pack_int", "dmll_nll", "dmll_nll_grad")

# kernel name -> launches since the last reset (read by chip_smoke.py to
# show the codec path went through each kernel)
launches: collections.Counter = collections.Counter()


def reset_launches() -> None:
    launches.clear()


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int):
    if not t.is_cuda:
        raise ValueError(f"{name}: kernel input must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {t.shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")


def _launch(lib: str, fn: str, kernel: str, *args) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    rc = build.call(lib, fn, *args, stream)
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed (cudaError {rc})")
    launches[kernel] += 1


MAX_K = 255         # components of K3-K6: kMaxKGeneric of the csrc sources
MAX_L = 256         # symbols of K3/K4: kMaxL of csrc/rans.cu


def _float_cdf_args(kernel: str, pi, mu, inv_s) -> Tuple[int, int]:
    """Check a float_cdf kernel's (P, K) parameters; (P, K)."""
    for x, n in ((pi, "pi"), (mu, "mu"), (inv_s, "inv_s")):
        _check(x, n, torch.float32, 2)
    P, K = pi.shape
    if mu.shape != (P, K) or inv_s.shape != (P, K):
        raise ValueError(f"{kernel}: shape mismatch")
    if K < 1:
        raise ValueError(f"{kernel}: K={K}")
    return P, K


def mixture_cdf_q(pi: torch.Tensor, mu: torch.Tensor, inv_s: torch.Tensor,
                  t: torch.Tensor, L: int) -> torch.Tensor:
    """(P, K) f32 params, (L,) f32 edges -> (P, L) int32
    floor(clip(sum_k pi sigmoid((t-mu) inv_s), 0, 1) * (65536 - 2L)),
    within one step of the plain version (the kernel's sigmoid is the
    special-function unit's). Any K >= 1 and L >= 1."""
    P, K = _float_cdf_args("mixture_cdf_q", pi, mu, inv_s)
    _check(t, "t", torch.float32, 1)
    if t.shape != (L,) or L < 1:
        raise ValueError(f"mixture_cdf_q: t {tuple(t.shape)}, L={L}")
    out = torch.empty((P, L), dtype=torch.int32, device=pi.device)
    if P:
        _launch("float_cdf", "l3c_mixture_cdf_q", "mixture_cdf_q",
                pi.data_ptr(), mu.data_ptr(), inv_s.data_ptr(),
                t.data_ptr(), out.data_ptr(),
                P, K, L, float(65536 - 2 * L))
    return out


def fine_cdf_q(pi: torch.Tensor, mu: torch.Tensor, inv_s: torch.Tensor,
               a: torch.Tensor, bw: float, t0: float) -> torch.Tensor:
    """(P, K) f32 params + (P,) f32 coarse symbols -> (P, 16) int32
    conditional fine rows of the 16 x 16 RGB split (pre +2l finish)."""
    fine, n_coarse = 16, 16
    P, K = _float_cdf_args("fine_cdf_q", pi, mu, inv_s)
    _check(a, "a", torch.float32, 1)
    if a.shape != (P,):
        raise ValueError("fine_cdf_q: shape mismatch")
    out = torch.empty((P, fine), dtype=torch.int32, device=pi.device)
    if P:
        _launch("float_cdf", "l3c_fine_cdf_q", "fine_cdf_q",
                pi.data_ptr(), mu.data_ptr(), inv_s.data_ptr(),
                a.data_ptr(), out.data_ptr(),
                P, K, float(bw), float(t0), n_coarse,
                float(65536 - 2 * fine))
    return out


def pack_int(l: torch.Tensor, C: int, topk: int, lam: bool, bw: float,
             t0: float) -> Tuple[Optional[torch.Tensor], ...]:
    """The classifier's output l (N, Kp, H, W) f32 NCHW, Kp = (4 if lam
    else 3) C K -> the IntParams fields (p, a, sc, v, w): exact-integer
    f32 (C, K', N H W) each, w (3, K', N H W) with lam (the RGB scale, C =
    3) else None. K' = topk where 0 < topk < K (the top-k components by pi
    logit), else K. bw, t0: the spec's bin width and lowest edge. Takes
    1 <= K <= MAX_K (255)."""
    _check(l, "l", torch.float32, 4)
    N, Kp, H, W = l.shape
    groups = 4 if lam else 3
    K = Kp // (groups * C)
    if K * groups * C != Kp or not 1 <= K <= MAX_K or (lam and C != 3):
        raise ValueError(f"pack_int: {Kp} planes are not {groups} groups "
                         f"of C={C} channels with 1..{MAX_K} components")
    if N * H * W < 1 or topk < 0:
        raise ValueError(f"pack_int: shape {tuple(l.shape)}, topk {topk}")
    KS = topk if 0 < topk < K else K
    n = N * H * W
    p, a, sc, v = (torch.empty((C, KS, n), dtype=torch.float32,
                               device=l.device) for _ in range(4))
    w = torch.empty((3, KS, n), dtype=torch.float32,
                    device=l.device) if lam else None
    _launch("pack", "l3c_pack_int", "pack_int", l.data_ptr(), p.data_ptr(),
            a.data_ptr(), sc.data_ptr(), v.data_ptr(),
            w.data_ptr() if lam else None, N, H * W, C, K, KS, int(lam),
            float(np.float32(bw)), float(np.float32(t0)))
    return p, a, sc, v, w


DEC_MODES = {"uniform": 0, "bn": 1, "rgb_coarse": 2, "rgb_fine": 3}
ENC_MODES = {"uniform": 0, "bn": 1, "rgb": 2}


def _int_params(ip, mode: str) -> Tuple[list, int, int]:
    """Pointers of the IntParams fields (p, a, sc, v, and w for RGB), K'
    and N; the uniform mode takes none (null pointers, K' = N = 0)."""
    if mode == "uniform":
        return [None] * 5, 0, 0
    if ip is None:
        raise ValueError(f"mode {mode} needs IntParams")
    _check(ip[0], "p", torch.float32, 3)
    C, K, N = ip[0].shape
    if not 1 <= K <= MAX_K:
        raise ValueError(f"K'={K}: the kernels take 1..{MAX_K} components")
    fields = list(zip(("p", "a", "sc", "v", "w"), ip, (C, C, C, C, 3)))
    fields = fields if mode.startswith("rgb") else fields[:4]
    for name, x, rows in fields:
        _check(x, name, torch.float32, 3)
        if x.shape != (rows, K, N):
            raise ValueError(f"IntParams {name}: shape {tuple(x.shape)}, "
                             f"expected {(rows, K, N)}")
    ptrs = [x.data_ptr() for _, x, _ in fields]
    return ptrs + [None] * (5 - len(ptrs)), K, N


def _groups(lanes: int, n: int, T: int) -> int:
    ns_c = -(-n // T)
    if n < 1 or T < 1 or lanes % ns_c:
        raise ValueError(f"{lanes} lanes are not whole channels of "
                         f"{ns_c} streams (n={n}, T={T})")
    return lanes // ns_c


def rans_decode(mode: str, words: torch.Tensor, n: int, T: int, L: int,
                ip=None, F: int = 1, c: int = 0,
                dec: Optional[torch.Tensor] = None,
                asym: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode rANS streams with the coding CDF built inside the kernel.

    words (lanes, W >= 2) int32 u16 values in decode order; streams of T
    symbols over groups of n pixels. mode: "uniform" (closed-form row),
    "bn" (IntParams ip, group g = pixels g % F of channel
    g / F), "rgb_coarse" / "rgb_fine" (channel c of RGB IntParams, F
    groups; dec (>= c, N) u8 the decoded channel symbols for the lambda
    chain, asym (N,) u8 the coarse symbols for fine). ip is (p, a, sc, v,
    w) lane-major (C, K', N) f32 with N = F n. Returns (groups, n) u8.
    Takes K' <= MAX_K (255) and 2 <= L <= MAX_L (256)."""
    _check(words, "words", torch.int32, 2)
    lanes, W = words.shape
    G = _groups(lanes, n, T)
    ptrs, K, N = _int_params(ip, mode)
    if W < 2 or not 2 <= L <= MAX_L:
        raise ValueError(f"rans_decode: W={W}, L={L} out of range")
    if mode != "uniform" and N != F * n:
        raise ValueError(f"IntParams hold {N} pixels, not F*n = {F * n}")
    if mode == "bn" and G != ip[0].shape[0] * F:
        raise ValueError(f"{G} groups != {ip[0].shape[0]} channels x {F}")
    dec_ptr = asym_ptr = None
    if mode.startswith("rgb"):
        if G != F or not 0 <= c < 3:
            raise ValueError(f"RGB decode: {G} groups, F={F}, c={c}")
        if c:
            _check(dec, "dec", torch.uint8, 2)
            if dec.shape[0] < c or dec.shape[1] != N:
                raise ValueError(f"dec: shape {tuple(dec.shape)}")
            dec_ptr = dec.data_ptr()
        if mode == "rgb_fine":
            _check(asym, "asym", torch.uint8, 1)
            if asym.shape != (N,):
                raise ValueError(f"asym: shape {tuple(asym.shape)}")
            asym_ptr = asym.data_ptr()
    elif mode not in DEC_MODES:
        raise ValueError(f"unknown decode mode {mode!r}")
    syms = torch.empty((G, n), dtype=torch.uint8, device=words.device)
    if lanes:
        _launch("rans", "l3c_rans_decode", "rans_decode", *ptrs, dec_ptr,
                asym_ptr, words.data_ptr(), syms.data_ptr(),
                DEC_MODES[mode], K, N, n, T, W, lanes, F, c, L)
    return syms


def rans_encode(mode: str, syms: torch.Tensor, n: int, T: int, L: int,
                ip=None, F: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """rANS-encode symbols with each symbol's (start, freq) computed
    inside the kernel from its two CDF edges.

    syms (C, N) u8 symbol planes, N = F n, streams of T symbols over
    groups of n pixels. mode: "uniform" (C groups, F = 1), "bn" (IntParams
    ip, C F groups), "rgb" (syms the image's three channel planes; 6 F
    groups: the coarse symbols of channels 0..2, then the fine ones).
    Returns (words (lanes, T+2) int32 u16 values in decode order, unwritten
    past each length; lengths (lanes,) int32). Takes K' <= MAX_K (255)
    and 2 <= L <= MAX_L (256)."""
    _check(syms, "syms", torch.uint8, 2)
    if mode not in ENC_MODES:
        raise ValueError(f"unknown encode mode {mode!r}")
    ptrs, K, N = _int_params(ip, mode)
    C, Ns = syms.shape
    if Ns != F * n or (mode != "uniform" and N != Ns):
        raise ValueError(f"syms hold {Ns} pixels; F*n = {F * n}, "
                         f"IntParams {N}")
    if mode == "bn" and ip[0].shape[0] != C:
        raise ValueError(f"{C} symbol planes, {ip[0].shape[0]} channels")
    if mode == "rgb" and C != 3:
        raise ValueError(f"RGB encode takes 3 planes, got {C}")
    if not 2 <= L <= MAX_L:
        raise ValueError(f"rans_encode: L={L} out of range")
    groups = (6 if mode == "rgb" else C) * F
    lanes = groups * -(-n // T)
    words = torch.empty((lanes, T + 2), dtype=torch.int32,
                        device=syms.device)
    lengths = torch.empty((lanes,), dtype=torch.int32, device=syms.device)
    if lanes:
        _launch("rans", "l3c_rans_encode", "rans_encode", *ptrs,
                syms.data_ptr(), words.data_ptr(), lengths.data_ptr(),
                ENC_MODES[mode], K, N if mode != "uniform" else Ns, n, T,
                lanes, F, L)
    return words, lengths


def _dmll_args(kernel: str, l: torch.Tensor, x: torch.Tensor, lam: bool
               ) -> Tuple[int, int, int, int]:
    """Check K6's inputs; (N, HW, C, K)."""
    _check(l, "l", torch.float32, 4)
    _check(x, "x", torch.float32, 4)
    N, Kp, H, W = l.shape
    C = x.shape[3]
    groups = 4 if lam else 3
    K = Kp // (groups * C)
    if x.shape[:3] != (N, H, W) or (lam and C != 3):
        raise ValueError(f"{kernel}: l {tuple(l.shape)} and x "
                         f"{tuple(x.shape)} do not match")
    if K * groups * C != Kp or not 1 <= K <= MAX_K or N * H * W < 1:
        raise ValueError(f"{kernel}: {Kp} planes are not {groups} groups "
                         f"of C={C} channels with 1..{MAX_K} components")
    return N, H * W, C, K


def _dmll_consts(half_bin: float, lower: float, upper: float):
    return tuple(float(np.float32(v)) for v in (half_bin, lower, upper))


def dmll_nll(l: torch.Tensor, x: torch.Tensor, lam: bool, half_bin: float,
             lower: float, upper: float) -> torch.Tensor:
    """K6 forward: the classifier's output l (N, Kp, H, W) f32 NCHW and the
    target x (N, H, W, C) f32 -> per-element mixture NLL (N, H, W, C).
    lam: the RGB scale's lambda groups (C = 3); half_bin, lower, upper:
    half the spec's bin width and its open-tail thresholds. Takes any
    C >= 1 (a launch a group of 8 channels) and 1 <= K <= MAX_K (255)
    components."""
    N, HW, C, K = _dmll_args("dmll_nll", l, x, lam)
    out = torch.empty(x.shape, dtype=torch.float32, device=l.device)
    _launch("dmll", "l3c_dmll_nll", "dmll_nll", l.data_ptr(), x.data_ptr(),
            out.data_ptr(), N, HW, C, K, int(lam),
            *_dmll_consts(half_bin, lower, upper))
    return out


def dmll_nll_grad(l: torch.Tensor, x: torch.Tensor, g: torch.Tensor,
                  lam: bool, half_bin: float, lower: float, upper: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6 backward: l, x as dmll_nll takes them and g (N, H, W, C) the
    gradient of its output -> (grad_l in l's layout, grad_x)."""
    N, HW, C, K = _dmll_args("dmll_nll_grad", l, x, lam)
    _check(g, "g", torch.float32, 4)
    if g.shape != x.shape:
        raise ValueError(f"dmll_nll_grad: g {tuple(g.shape)} is not "
                         f"x's {tuple(x.shape)}")
    gl = torch.empty_like(l)
    gx = torch.empty_like(x)
    _launch("dmll", "l3c_dmll_nll_grad", "dmll_nll_grad", l.data_ptr(),
            x.data_ptr(), g.data_ptr(), gl.data_ptr(), gx.data_ptr(), N, HW,
            C, K, int(lam), *_dmll_consts(half_bin, lower, upper))
    return gl, gx
