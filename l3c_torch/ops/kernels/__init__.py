"""Launchers of the hand-written CUDA kernels (csrc/*.cu).

Each launcher checks device, dtype, shape and contiguity, allocates its
outputs with torch.empty, launches on PyTorch's current stream, raises if
the launch was refused, and adds one to its entry of `launches`. Nothing
here runs at import: the libraries are built at first launch
(build.py). The dispatching wrappers that CPU tensors route to the plain
versions are `float_cdf.mixture_cdf_q` / `fine_cdf_q` and
`gpu_coder.rans_encode` / `rans_decode`.

| kernel         | source             | replaces (TPU)                        |
| mixture_cdf_q  | csrc/float_cdf.cu  | tools/pallas_cdf.py:48 (Pallas)       |
| fine_cdf_q     | csrc/float_cdf.cu  | tools/pallas_cdf.py:120 (Pallas)      |
| rans_encode    | csrc/rans.cu       | l3c_tpu/ops/tpu_coder.py:305 (scan)   |
| rans_decode    | csrc/rans.cu       | l3c_tpu/ops/tpu_coder.py:481 (scan)   |
"""
from __future__ import annotations

import collections
from typing import Tuple

import torch

from . import build

KERNELS = ("mixture_cdf_q", "fine_cdf_q", "rans_encode", "rans_decode")

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


def mixture_cdf_q(pi: torch.Tensor, mu: torch.Tensor, inv_s: torch.Tensor,
                  t: torch.Tensor, L: int) -> torch.Tensor:
    """(P, K) f32 params, (L,) f32 edges -> (P, L) int32
    floor(clip(sum_k pi sigmoid((t-mu) inv_s), 0, 1) * (65536 - 2L))."""
    for x, n in ((pi, "pi"), (mu, "mu"), (inv_s, "inv_s")):
        _check(x, n, torch.float32, 2)
    _check(t, "t", torch.float32, 1)
    P, K = pi.shape
    if mu.shape != (P, K) or inv_s.shape != (P, K) or t.shape != (L,):
        raise ValueError("mixture_cdf_q: shape mismatch")
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
    for x, n in ((pi, "pi"), (mu, "mu"), (inv_s, "inv_s")):
        _check(x, n, torch.float32, 2)
    _check(a, "a", torch.float32, 1)
    P, K = pi.shape
    if mu.shape != (P, K) or inv_s.shape != (P, K) or a.shape != (P,):
        raise ValueError("fine_cdf_q: shape mismatch")
    out = torch.empty((P, fine), dtype=torch.int32, device=pi.device)
    if P:
        _launch("float_cdf", "l3c_fine_cdf_q", "fine_cdf_q",
                pi.data_ptr(), mu.data_ptr(), inv_s.data_ptr(),
                a.data_ptr(), out.data_ptr(),
                P, K, float(bw), float(t0), n_coarse,
                float(65536 - 2 * fine))
    return out


def rans_encode(start: torch.Tensor, freq: torch.Tensor, mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(NS, T) int32 start/freq + (NS, T) bool mask -> (words (NS, T+2)
    int32 u16 values in decode order, unwritten past each length; lengths
    (NS,) int32)."""
    _check(start, "start", torch.int32, 2)
    _check(freq, "freq", torch.int32, 2)
    _check(mask, "mask", torch.bool, 2)
    ns, T = start.shape
    if freq.shape != (ns, T) or mask.shape != (ns, T):
        raise ValueError("rans_encode: shape mismatch")
    words = torch.empty((ns, T + 2), dtype=torch.int32, device=start.device)
    lengths = torch.empty((ns,), dtype=torch.int32, device=start.device)
    if ns:
        _launch("rans", "l3c_rans_encode", "rans_encode",
                start.data_ptr(), freq.data_ptr(), mask.data_ptr(),
                words.data_ptr(), lengths.data_ptr(), ns, T)
    return words, lengths


def rans_decode(rows: torch.Tensor, words: torch.Tensor, mask: torch.Tensor
                ) -> torch.Tensor:
    """(L, NS, T) int32 rows, (NS, W) int32 words, (NS, T) bool mask ->
    (NS, T) int32 symbols."""
    _check(rows, "rows", torch.int32, 3)
    _check(words, "words", torch.int32, 2)
    _check(mask, "mask", torch.bool, 2)
    L, ns, T = rows.shape
    W = words.shape[1]
    if words.shape[0] != ns or mask.shape != (ns, T) or W < 2:
        raise ValueError("rans_decode: shape mismatch")
    syms = torch.empty((ns, T), dtype=torch.int32, device=rows.device)
    if ns:
        _launch("rans", "l3c_rans_decode", "rans_decode",
                rows.data_ptr(), words.data_ptr(), mask.data_ptr(),
                syms.data_ptr(), ns, T, W, L)
    return syms
