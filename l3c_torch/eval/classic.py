"""Classical lossless baseline: MED predictor + context rANS (.medl).

Port of `l3c_tpu/eval/classic.py` on the port's host backend
(ops/coder.py, the same C++ source), so its files are the JAX package's
byte for byte. A stronger classical anchor than PNG, modelled on JPEG-LS /
LOCO-I (Weinberger, Seroussi, Sapiro, IEEE TIP 2000):

- the median-edge-detector predictor,
- 8 contexts from quantized causal gradient activity
  |b-c| + |c-a| (thresholds 1, 3, 7, ... — doubling bands),
- per-(channel, context) two-sided-geometric residual model, fitted
  per image and quantized to TWO BYTES per context (so the model
  header is 48 bytes, not kilobytes of histograms),
- the host rANS backend; decode interleaves entropy decoding with MED
  reconstruction in C++ exactly like a JPEG-LS decoder (contexts depend
  on reconstructed neighbors).

It is a real codec with a bit-exact round-trip, not an entropy
estimate: the bar a learned model must clear to claim it models images
at all. Host work only; no device is touched.

File format (.medl):
  v3 (context + inter-channel correction, default):
    magic u16 = 0x4D45, version u8 = 3
    H u32, W u32, C u8, n_chunks u8, n_ctx u8
    C*(C-1)/2 x int8 alpha   (chained inter-channel correction,
                              channel-major [a10, a20, a21, ...])
    per (channel, ctx): theta u8, p0 u8      (TSGD params)
    per channel: n_chunks x u32 chunk byte lengths
    streams (channel-major)
  v2 (context, kept as ablation): v3 without the alpha block.
  v1 (static histogram, kept as ablation):
    magic, version=1, H, W, C, n_chunks, per-channel 255 x u32
    interior cumulative points, then per-channel lens + streams.

v3's inter-channel model: channel ch's MED prediction is corrected by
floor((resc_j * a_chj + 32) / 64) for every previously-coded channel
j, where resc_j is j's CENTERED mod-256 residual in [-128, 127] and
a_chj an int8 fitted per image by greedy least squares (RGB planes
share most of their edge structure, so one residual plane linearly
predicts the next). Contexts are untouched; decode
(ops/csrc/l3c_coder.cpp l3c_medctx_decode_v3) reproduces the exact
integer correction from its own reconstruction.
"""
from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

from ..data import images
from ..ops import coder as coder_mod

_MAGIC = 0x4D45
_N_CHUNKS = 4
N_CTX = 8


def _quantize_hist(counts: np.ndarray, total_bits: int = 16) -> np.ndarray:
    """(256,) counts -> (257,) uint32 cumulative with sum 2^16 and
    every OCCURRING symbol at freq >= 1."""
    total = 1 << total_bits
    n = counts.sum()
    assert n > 0
    f = np.floor(counts.astype(np.float64) * total / n).astype(np.int64)
    f[(counts > 0) & (f == 0)] = 1
    # absorb the rounding deficit/surplus in the largest bucket; it can
    # absorb any deficit (<= 256) since it holds >= total/256 mass
    diff = total - f.sum()
    k = int(np.argmax(f))
    assert f[k] + diff >= 1, "histogram quantization underflow"
    f[k] += diff
    cum = np.zeros(257, np.uint32)
    cum[1:] = np.cumsum(f).astype(np.uint32)
    assert cum[-1] == total
    return cum


# ------------------------- two-sided geometric residual model (v2)


def _fit_tsgd(res: np.ndarray) -> Tuple[int, int]:
    """Mod-256 residuals -> (theta_idx, p0_idx) uint8 TSGD parameters.

    e = centered residual in [-128, 127]; P(e=0) = p0 and
    P(|e|=k) proportional to theta^(k-1) for k >= 1 (geometric ML fit
    theta = (m-1)/m from the mean nonzero magnitude — LOCO-I's TSGD
    family, Golomb-parameter estimation done parametrically)."""
    e = ((res.astype(np.int64) + 128) & 255) - 128
    n = e.size
    p0 = (e == 0).sum() / n
    p0_idx = int(np.clip(round(p0 * 256.0 - 0.5), 0, 255))
    mag = np.abs(e[e != 0])
    if mag.size == 0:
        return 0, p0_idx
    m = float(mag.mean())
    theta = max(0.0, (m - 1.0) / m)
    return int(np.clip(round(theta * 256.0), 0, 255)), p0_idx


def _tsgd_cum(theta_idx: int, p0_idx: int) -> np.ndarray:
    """TSGD params -> (257,) uint32 cumulative table, sum 65536, ALL
    256 symbols freq >= 1 (decode never knows which residuals occur).

    Deterministic: theta and the power sequence are exact IEEE float64
    values produced by correctly-rounded ops, and encode/decode both
    build tables through this one function."""
    theta = theta_idx / 256.0
    p0 = (p0_idx + 0.5) / 256.0
    pw = np.ones(128, np.float64)
    if theta > 0.0:
        pw[1:] = np.cumprod(np.full(127, theta))
    else:
        pw[1:] = 0.0
    # e = -128..-1 uses pw[|e|-1]; e = 1..127 uses pw[e-1]
    p = np.zeros(256, np.float64)          # indexed by r = e mod 256
    neg_e = np.arange(-128, 0)
    p[neg_e & 255] = pw[np.abs(neg_e) - 1]
    pos_e = np.arange(1, 128)
    p[pos_e] = pw[pos_e - 1]
    z = p.sum()
    p *= (1.0 - p0) / z
    p[0] = p0
    f = np.maximum(1, np.floor(p * 65536.0).astype(np.int64))
    k = int(np.argmax(f))
    f[k] += 65536 - f.sum()
    assert f[k] >= 1
    cum = np.zeros(257, np.uint32)
    cum[1:] = np.cumsum(f).astype(np.uint32)
    assert cum[-1] == 65536
    return cum


def _med_pred_plane(x: np.ndarray) -> np.ndarray:
    """uint8 (H, W) -> int32 MED predictions (same boundary rules as
    ops/csrc/l3c_coder.cpp l3c_med_residuals)."""
    x = x.astype(np.int32)
    a = np.empty_like(x); a[:, 1:] = x[:, :-1]; a[:, 0] = -1
    b = np.empty_like(x); b[1:] = x[:-1]; b[0] = -1
    c = np.empty_like(x); c[1:, 1:] = x[:-1, :-1]; c[0] = -1; c[:, 0] = -1
    mx = np.maximum(a, b)
    mn = np.minimum(a, b)
    pred = np.where(c >= mx, mn, np.where(c <= mn, mx, a + b - c))
    pred[0, 1:] = a[0, 1:]
    pred[1:, 0] = b[1:, 0]
    pred[0, 0] = 128
    return pred


def encode(img: np.ndarray, version: int = 3) -> bytes:
    """uint8 HWC image -> .medl v3 (context + inter-channel) bytes.

    version=2 drops the inter-channel correction (ablation / the
    round-4 anchor)."""
    if img.dtype != np.uint8 or img.ndim != 3 or version not in (2, 3):
        raise ValueError(f"expected a uint8 HWC image and version 2 or 3, "
                         f"got {img.dtype} {img.shape}, version {version}")
    h, w, c = img.shape
    ctx = coder_mod.med_contexts(img, N_CTX)             # (C, H*W)
    parts: List[bytes] = [struct.pack("<HBIIBBB", _MAGIC, version, h, w,
                                      c, _N_CHUNKS, N_CTX)]
    res = np.zeros((c, h * w), np.int32)
    resc: List[np.ndarray] = []    # centered residuals, int32 planes
    alphas: List[int] = []
    for chn in range(c):
        plane = img[:, :, chn]
        pred = _med_pred_plane(plane)
        r_signed = plane.astype(np.int32) - pred
        for pr in (resc if version == 3 else ()):
            # greedy least-squares fit of this prev channel's residual
            # against what remains of ours; the applied correction is
            # the same exact integer expression decode uses
            denom = float((pr * pr).sum()) or 1.0
            a_q = int(np.clip(round(float((r_signed * pr).sum())
                                    / denom * 64.0), -127, 127))
            alphas.append(a_q)
            corr = (pr * a_q + 32) >> 6
            pred = pred + corr
            r_signed = r_signed - corr
        r = (plane.astype(np.int32) - pred) & 255
        res[chn] = r.reshape(-1)
        resc.append(((r + 128) & 255) - 128)
    if version == 3:
        parts.append(np.asarray(alphas, np.int8).tobytes())
    cums_all = []
    for chn in range(c):
        cums = np.zeros((N_CTX, 257), np.uint32)
        for k in range(N_CTX):
            r_k = res[chn][ctx[chn] == k]
            t_idx, p_idx = _fit_tsgd(r_k) if r_k.size else (0, 128)
            parts.append(struct.pack("<BB", t_idx, p_idx))
            cums[k] = _tsgd_cum(t_idx, p_idx)
        cums_all.append(cums)
    for chn in range(c):
        data, lens = coder_mod.encode_table_ctx(res[chn], ctx[chn],
                                                cums_all[chn], _N_CHUNKS)
        parts.append(np.asarray(lens, np.uint32).tobytes())
        parts.append(data)
    return b"".join(parts)


def decode(blob: bytes) -> np.ndarray:
    """.medl byte string (v1, v2, or v3) -> uint8 HWC image."""
    magic, ver = struct.unpack_from("<HB", blob)
    if magic != _MAGIC or ver not in (1, 2, 3):
        raise ValueError(f"not a .medl v1-v3 file (magic {magic:#06x}, "
                         f"version {ver})")
    if ver == 1:
        return _decode_v1(blob)
    _, _, h, w, c, n_chunks, n_ctx = struct.unpack_from("<HBIIBBB", blob)
    off = struct.calcsize("<HBIIBBB")
    alphas = np.zeros(c * (c - 1) // 2, np.int8)
    if ver == 3:
        alphas = np.frombuffer(blob, np.int8, alphas.size, off)
        off += alphas.size
    cums = np.zeros((c, n_ctx, 257), np.uint32)
    for chn in range(c):
        for k in range(n_ctx):
            t_idx, p_idx = struct.unpack_from("<BB", blob, off)
            off += 2
            cums[chn, k] = _tsgd_cum(t_idx, p_idx)
    lens = np.zeros((c, n_chunks), np.int64)
    datas = []
    for chn in range(c):
        ln = np.frombuffer(blob, np.uint32, n_chunks, off)
        off += n_chunks * 4
        lens[chn] = ln
        nb = int(ln.sum())
        datas.append(blob[off: off + nb])
        off += nb
    if ver == 3:
        return coder_mod.medctx_decode_v3(b"".join(datas), lens, h, w,
                                          c, cums, alphas, n_chunks)
    return coder_mod.medctx_decode(b"".join(datas), lens, h, w, c,
                                   cums, n_chunks)


# ------------------------------- v1: static global histogram (ablation)


def encode_static(img: np.ndarray) -> bytes:
    """v1: one static residual histogram per channel (no contexts)."""
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"expected a uint8 HWC image, got {img.dtype} "
                         f"{img.shape}")
    h, w, c = img.shape
    res = coder_mod.med_residuals(img)
    parts: List[bytes] = [struct.pack("<HBIIBB", _MAGIC, 1, h, w, c,
                                      _N_CHUNKS)]
    streams: List[Tuple[bytes, np.ndarray]] = []
    for ch in range(c):
        counts = np.bincount(res[ch], minlength=256)
        cum = _quantize_hist(counts)
        parts.append(cum[1:256].astype(np.uint32).tobytes())
        streams.append(coder_mod.TableCoder(cum, _N_CHUNKS)
                       .encode(res[ch]))
    for data, lens in streams:
        parts.append(np.asarray(lens, np.uint32).tobytes())
        parts.append(data)
    return b"".join(parts)


def _decode_v1(blob: bytes) -> np.ndarray:
    _, _, h, w, c, n_chunks = struct.unpack_from("<HBIIBB", blob)
    off = struct.calcsize("<HBIIBB")
    cums = []
    for _ in range(c):
        interior = np.frombuffer(blob, np.uint32, 255, off)
        off += 255 * 4
        cum = np.zeros(257, np.uint32)
        cum[1:256] = interior
        cum[256] = 65536
        cums.append(cum)
    res = np.zeros((c, h * w), np.int32)
    for ch in range(c):
        lens = np.frombuffer(blob, np.uint32, n_chunks, off)
        off += n_chunks * 4
        n_bytes = int(lens.sum())
        res[ch] = coder_mod.TableCoder(cums[ch], n_chunks).decode(
            blob[off: off + n_bytes], lens.astype(np.int64), h * w)
        off += n_bytes
    return coder_mod.med_reconstruct(res, h, w)


def bpsp(img: np.ndarray) -> float:
    """Actual-file bits per subpixel of the MED-context baseline."""
    return len(encode(img)) * 8.0 / img.size


# ------------------------------------------------ the optimized-PNG column

_PNG_FRAME = 8 + 25 + 12        # signature, IHDR and IEND chunks
_PNG_CHUNK = 12                 # length, type and CRC of each IDAT


def png_size(img: np.ndarray) -> int:
    """Bytes of the PNG Pillow writes for `img` with optimize=True
    (Image.fromarray(img).save(f, "PNG", optimize=True)), computed the way
    Pillow's ZipEncode.c writes it:
    - each row filtered by the one of None, Up, Sub, Average and Paeth
      (tried in that order, a later one taken only if strictly better)
      whose filtered bytes v have the least sum of min(v, 256 - v);
    - the rows deflated at level 9, window 15, memLevel 9, Z_FILTERED;
    - the stream cut into IDAT chunks of max(65536, 4 W) bytes.
    Deflate's output is zlib's: the sizes equal Pillow's where both use
    one zlib (zlib.ZLIB_RUNTIME_VERSION names it)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"png_size takes (H, W[, C]) uint8, got "
                         f"{img.dtype} {img.shape}")
    rows = images.png_filter_rows(img, images.PNG_FILTERS_OPTIMIZE)
    n = len(images.png_deflate(rows, 9))
    block = images.png_idat_block(img.shape[1])
    return _PNG_FRAME + n + _PNG_CHUNK * -(-n // block)
