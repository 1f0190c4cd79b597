"""ctypes binding and on-demand build of the host C++ rANS backend.

Port of `l3c_tpu/ops/coder.py`. `csrc/l3c_coder.cpp` is a byte-for-byte
copy of the JAX package's source: the format-v1 streams and the `.medl`
files are defined by its CDF evaluator (its header comment), so the two
packages code the same bytes from the same inputs.

The library is built with g++ at first use into the kernels' build
directory (`ops/kernels/_build/`, listed in .gitignore), named by a hash
of the source and the flags; a failed build raises with the compiler's
log, nothing falls back. Flags: -O3 without fast math and with
-ffp-contract=off (encode and decode must evaluate every CDF bit for bit
alike), -march=native (the evaluator spec makes the AVX2 and scalar builds
bit-identical, and the v1 header's evaluator-variant byte refuses any
other variant), and -fno-gnu-unique: this library exports the same C
symbols as the JAX package's, and a process that loads both (the parity
tests) must keep each library's symbols its own.

L3C_CODER_FORCE_SCALAR=1 selects the scalar build, which must give the
vectorised build's streams bit for bit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from .kernels.build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "l3c_coder.cpp")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-ffp-contract=off",
             "-fno-unsafe-math-optimizations", "-march=native",
             "-fno-gnu-unique")
_BUILD_LOCK = threading.Lock()
_libs = {}

# Chunked sub-streams per channel (independent rANS streams, each ~8
# bytes of flush overhead); the format lets a host code them in parallel.
DEFAULT_CHUNKS = 4


def lib_path(force_scalar: bool) -> str:
    """The build's file: libl3c_coder[_scalar]_<hash of source + flags>."""
    flags = GXX_FLAGS + (("-DL3C_FORCE_SCALAR",) if force_scalar else ())
    h = hashlib.sha256(" ".join(flags).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    tag = "_scalar" if force_scalar else ""
    return os.path.join(BUILD_DIR,
                        f"libl3c_coder{tag}_{h.hexdigest()[:16]}.so")


def _build(out: str, force_scalar: bool) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", *GXX_FLAGS, *(["-DL3C_FORCE_SCALAR"] if force_scalar
                                else []), "-o", tmp, _SRC]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {_SRC} "
                           f"(rc {proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)        # atomic: other processes never see half


def get_lib() -> ctypes.CDLL:
    force_scalar = os.environ.get("L3C_CODER_FORCE_SCALAR", "0") == "1"
    if force_scalar in _libs:
        return _libs[force_scalar]
    with _BUILD_LOCK:
        if force_scalar in _libs:
            return _libs[force_scalar]
        path = lib_path(force_scalar)
        if not os.path.isfile(path):
            _build(path, force_scalar)
        lib = ctypes.CDLL(path)
        c_i64 = ctypes.c_longlong
        c_int, c_float = ctypes.c_int, ctypes.c_float
        ptr = lambda dt: np.ctypeslib.ndpointer(dt, flags="C_CONTIGUOUS")
        c_f32p, c_i32p, c_u8p = ptr(np.float32), ptr(np.int32), ptr(np.uint8)
        c_i64p, c_u32p, c_i8p = ptr(np.int64), ptr(np.uint32), ptr(np.int8)
        sigs = {
            "l3c_encode_mixture": (c_i64, [
                c_f32p, c_f32p, c_f32p, ctypes.c_void_p, c_i32p, c_int,
                c_int, c_i64, c_int, c_float, c_float, c_int, c_u8p, c_i64,
                c_i64p]),
            "l3c_decode_mixture": (c_int, [
                c_f32p, c_f32p, c_f32p, ctypes.c_void_p, c_u8p, c_i64p,
                c_int, c_int, c_i64, c_int, c_float, c_float, c_int,
                c_i32p]),
            "l3c_encode_uniform": (c_i64, [
                c_i32p, c_i64, c_int, c_int, c_u8p, c_i64, c_i64p]),
            "l3c_decode_uniform": (c_int, [
                c_u8p, c_i64p, c_i64, c_int, c_int, c_i32p]),
            "l3c_encode_table": (c_i64, [
                c_i32p, c_i64, c_u32p, c_int, c_int, c_u8p, c_i64, c_i64p]),
            "l3c_decode_table": (c_int, [
                c_u8p, c_i64p, c_i64, c_u32p, c_int, c_int, c_i32p]),
            "l3c_med_residuals": (None, [c_u8p, c_int, c_int, c_int,
                                         c_i32p]),
            "l3c_med_reconstruct": (None, [c_i32p, c_int, c_int, c_int,
                                           c_u8p]),
            "l3c_encode_table_ctx": (c_i64, [
                c_i32p, c_i32p, c_i64, c_u32p, c_int, c_int, c_int, c_u8p,
                c_i64, c_i64p]),
            "l3c_medctx_decode": (c_int, [
                c_u8p, c_i64p, c_int, c_int, c_int, c_u32p, c_int, c_int,
                c_int, c_u8p]),
            "l3c_medctx_contexts": (None, [c_u8p, c_int, c_int, c_int,
                                           c_int, c_i32p]),
            "l3c_medctx_decode_v3": (c_int, [
                c_u8p, c_i64p, c_int, c_int, c_int, c_u32p, c_int, c_int,
                c_int, c_i8p, c_u8p]),
            "l3c_coder_version": (c_int, []),
            "l3c_eval_variant": (c_int, []),
        }
        for name, (restype, argtypes) in sigs.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _libs[force_scalar] = lib
        return lib


def eval_variant() -> int:
    """CDF evaluator variant of the loaded backend (the v1 header byte)."""
    return int(get_lib().l3c_eval_variant())


def _lam_ptr(lam: Optional[np.ndarray]):
    """(pointer or None, the array it points into, kept alive by the
    caller)."""
    if lam is None:
        return None, None
    lam = np.ascontiguousarray(lam, np.float32)
    return lam.ctypes.data_as(ctypes.c_void_p), lam


def _check(name: str, r: int) -> None:
    if r != 0:
        raise RuntimeError(f"{name} failed: {r}")


class MixtureCoder:
    """Codes one scale's channels under a discretized logistic mixture.

    Parameters are (C, HW, K) float32 arrays (pi softmaxed, mu raw, inv_s
    = exp(-clamped log_s)) and `lam`, (3, HW, K) sigmoid'd lambda
    coefficients for an RGB scale, or None: models.dmll.pack_coder_params'
    outputs after the (1,H,W,C,K) -> (C,HW,K) transpose. The backend
    applies the RGB lambda chain itself from the decoded symbols."""

    def __init__(self, L: int, x_min: float, x_max: float,
                 n_chunks: int = DEFAULT_CHUNKS):
        self.L = L
        self.x_min = float(x_min)
        self.bin_w = float(
            np.float32(np.float32(x_max - x_min) / np.float32(L - 1)))
        self.n_chunks = n_chunks

    def encode(self, pi: np.ndarray, mu: np.ndarray, inv_s: np.ndarray,
               lam: Optional[np.ndarray], syms: np.ndarray
               ) -> Tuple[bytes, np.ndarray]:
        """Returns (stream bytes, chunk_lens[C * n_chunks])."""
        C, HW, K = pi.shape
        if syms.shape != (C, HW) or syms.dtype != np.int32:
            raise ValueError(f"syms must be int32 {(C, HW)}, got "
                             f"{syms.dtype} {syms.shape}")
        out = np.empty(C * (HW + 2 * self.n_chunks) * 4 + 64, np.uint8)
        chunk_lens = np.zeros(C * self.n_chunks, np.int64)
        lam_ptr, _keep = _lam_ptr(lam)
        n = get_lib().l3c_encode_mixture(
            np.ascontiguousarray(pi), np.ascontiguousarray(mu),
            np.ascontiguousarray(inv_s), lam_ptr,
            np.ascontiguousarray(syms), C, K, HW, self.L, self.x_min,
            self.bin_w, self.n_chunks, out, out.size, chunk_lens)
        if n < 0:
            raise RuntimeError(f"l3c_encode_mixture failed: {n}")
        return out[:n].tobytes(), chunk_lens

    def decode(self, pi: np.ndarray, mu: np.ndarray, inv_s: np.ndarray,
               lam: Optional[np.ndarray], data: bytes,
               chunk_lens: Sequence[int]) -> np.ndarray:
        """Returns syms (C, HW) int32."""
        C, HW, K = pi.shape
        chunk_lens = np.asarray(chunk_lens, np.int64)
        if chunk_lens.size != C * self.n_chunks:
            raise ValueError(f"{chunk_lens.size} chunk lengths for {C} "
                             f"channels of {self.n_chunks} chunks")
        syms = np.zeros((C, HW), np.int32)
        buf = np.frombuffer(data, np.uint8).copy()       # aligned, owned
        lam_ptr, _keep = _lam_ptr(lam)
        _check("l3c_decode_mixture", get_lib().l3c_decode_mixture(
            np.ascontiguousarray(pi), np.ascontiguousarray(mu),
            np.ascontiguousarray(inv_s), lam_ptr, buf, chunk_lens, C, K, HW,
            self.L, self.x_min, self.bin_w, self.n_chunks, syms))
        return syms


class TableCoder:
    """Static-cumulative-table rANS coder: one shared (L+1) uint32 table
    for every symbol of a call (cum[0] = 0, cum[L] = 65536). The entropy
    backend of the classical MED baseline's v1 (eval.classic)."""

    def __init__(self, cum: np.ndarray, n_chunks: int = DEFAULT_CHUNKS):
        cum = np.ascontiguousarray(cum, np.uint32)
        if not (cum.ndim == 1 and cum[0] == 0 and cum[-1] == 65536
                and (np.diff(cum.astype(np.int64)) >= 0).all()):
            raise ValueError("cum must rise from 0 to 65536")
        self.cum = cum
        self.L = cum.size - 1
        self.n_chunks = n_chunks

    def encode(self, syms: np.ndarray) -> Tuple[bytes, np.ndarray]:
        syms = np.ascontiguousarray(syms.reshape(-1).astype(np.int32))
        out = np.empty(syms.size * 4 + 8 * self.n_chunks + 64, np.uint8)
        chunk_lens = np.zeros(self.n_chunks, np.int64)
        n = get_lib().l3c_encode_table(syms, syms.size, self.cum, self.L,
                                       self.n_chunks, out, out.size,
                                       chunk_lens)
        if n < 0:
            raise RuntimeError(f"l3c_encode_table failed: {n}")
        return out[:n].tobytes(), chunk_lens

    def decode(self, data: bytes, chunk_lens: Sequence[int],
               n: int) -> np.ndarray:
        chunk_lens = np.asarray(chunk_lens, np.int64)
        syms = np.zeros(n, np.int32)
        buf = np.frombuffer(data, np.uint8).copy()
        _check("l3c_decode_table", get_lib().l3c_decode_table(
            buf, chunk_lens, n, self.cum, self.L, self.n_chunks, syms))
        return syms


class UniformCoder:
    """Uniform-prior coder for the coarsest scale (closed-form CDF)."""

    def __init__(self, L: int, n_chunks: int = DEFAULT_CHUNKS):
        self.L = L
        self.n_chunks = n_chunks

    def encode(self, syms: np.ndarray) -> Tuple[bytes, np.ndarray]:
        syms = np.ascontiguousarray(syms.reshape(-1).astype(np.int32))
        out = np.empty(syms.size * 4 + 8 * self.n_chunks + 64, np.uint8)
        chunk_lens = np.zeros(self.n_chunks, np.int64)
        n = get_lib().l3c_encode_uniform(syms, syms.size, self.L,
                                         self.n_chunks, out, out.size,
                                         chunk_lens)
        if n < 0:
            raise RuntimeError(f"l3c_encode_uniform failed: {n}")
        return out[:n].tobytes(), chunk_lens

    def decode(self, data: bytes, chunk_lens: Sequence[int],
               n: int) -> np.ndarray:
        chunk_lens = np.asarray(chunk_lens, np.int64)
        syms = np.zeros(n, np.int32)
        buf = np.frombuffer(data, np.uint8).copy()
        _check("l3c_decode_uniform", get_lib().l3c_decode_uniform(
            buf, chunk_lens, n, self.L, self.n_chunks, syms))
        return syms


# ------------------------------------------- the MED baseline's helpers


def med_residuals(img: np.ndarray) -> np.ndarray:
    """uint8 HWC image -> (C, H*W) int32 mod-256 MED residuals."""
    h, w, c = img.shape
    res = np.zeros((c, h * w), np.int32)
    get_lib().l3c_med_residuals(np.ascontiguousarray(img), h, w, c, res)
    return res


def med_reconstruct(res: np.ndarray, h: int, w: int) -> np.ndarray:
    """(C, H*W) int32 residuals -> uint8 HWC image (the inverse scan)."""
    c = res.shape[0]
    img = np.zeros((h, w, c), np.uint8)
    get_lib().l3c_med_reconstruct(np.ascontiguousarray(res, np.int32), h,
                                  w, c, img)
    return img


def med_contexts(img: np.ndarray, n_ctx: int) -> np.ndarray:
    """uint8 HWC image -> (C, H*W) int32 gradient-activity contexts
    (encode side; decode recomputes them from its reconstruction)."""
    h, w, c = img.shape
    ctx = np.zeros((c, h * w), np.int32)
    get_lib().l3c_medctx_contexts(np.ascontiguousarray(img), h, w, c, n_ctx,
                                  ctx)
    return ctx


def encode_table_ctx(syms: np.ndarray, ctx: np.ndarray, cums: np.ndarray,
                     n_chunks: int = DEFAULT_CHUNKS
                     ) -> Tuple[bytes, np.ndarray]:
    """Per-symbol context-table rANS encode. cums: (n_ctx, L+1) u32."""
    n_ctx, L1 = cums.shape
    syms = np.ascontiguousarray(syms.reshape(-1).astype(np.int32))
    ctx = np.ascontiguousarray(ctx.reshape(-1).astype(np.int32))
    if ctx.size != syms.size:
        raise ValueError(f"{ctx.size} contexts for {syms.size} symbols")
    out = np.empty(syms.size * 4 + 8 * n_chunks + 64, np.uint8)
    chunk_lens = np.zeros(n_chunks, np.int64)
    n = get_lib().l3c_encode_table_ctx(
        syms, ctx, syms.size, np.ascontiguousarray(cums, np.uint32), n_ctx,
        L1 - 1, n_chunks, out, out.size, chunk_lens)
    if n < 0:
        raise RuntimeError(f"l3c_encode_table_ctx failed: {n}")
    return out[:n].tobytes(), chunk_lens


def medctx_decode(data: bytes, chunk_lens: np.ndarray, h: int, w: int,
                  c: int, cums: np.ndarray, n_chunks: int) -> np.ndarray:
    """Fused context decode and MED reconstruction (.medl v2).
    cums: (C, n_ctx, L+1) u32; chunk_lens: (C, n_chunks)."""
    _, n_ctx, L1 = cums.shape
    img = np.zeros((h, w, c), np.uint8)
    buf = np.frombuffer(data, np.uint8).copy()
    _check("l3c_medctx_decode", get_lib().l3c_medctx_decode(
        buf, np.ascontiguousarray(chunk_lens.reshape(-1), np.int64), h, w,
        c, np.ascontiguousarray(cums, np.uint32), n_ctx, L1 - 1, n_chunks,
        img))
    return img


def medctx_decode_v3(data: bytes, chunk_lens: np.ndarray, h: int, w: int,
                     c: int, cums: np.ndarray, alphas: np.ndarray,
                     n_chunks: int) -> np.ndarray:
    """Fused context decode, MED and inter-channel-corrected
    reconstruction (.medl v3). alphas: (C*(C-1)/2,) int8, channel-major
    [a10, a20, a21, ...]."""
    _, n_ctx, L1 = cums.shape
    img = np.zeros((h, w, c), np.uint8)
    buf = np.frombuffer(data, np.uint8).copy()
    _check("l3c_medctx_decode_v3", get_lib().l3c_medctx_decode_v3(
        buf, np.ascontiguousarray(chunk_lens.reshape(-1), np.int64), h, w,
        c, np.ascontiguousarray(cums, np.uint32), n_ctx, L1 - 1, n_chunks,
        np.ascontiguousarray(alphas, np.int8), img))
    return img
