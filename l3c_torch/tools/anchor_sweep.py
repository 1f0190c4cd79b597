"""Entropy-estimate sweep for hardening the classical MED anchor.

Port of `tools/anchor_sweep.py` onto the port's classical codec
(`l3c_torch/eval/classic.py`: _fit_tsgd, _tsgd_cum, encode) and its
image loader (`l3c_torch/data/images.load_image_uint8`, no Pillow); it
prints the JAX script's lines for the same files.

Measures (on the held-out val tiles) the expected actual-file bpsp of
candidate context-model upgrades to eval/classic.py, WITHOUT writing
C++ first: per-(channel, context) two-sided-geometric codelengths are
computed from the same quantized TSGD tables the real codec would
build (_tsgd_cum), plus exact header accounting. The v2 estimate is
validated against the real v2 files to confirm the estimator tracks
the codec (rANS overhead is ~0.1% and identical across variants).

Variants:
  act8      current codec (v2): |b-c|+|c-a| activity, 8 contexts
  act16     finer activity thresholds, 16 contexts
  loco      JPEG-LS/LOCO-I 3-gradient signed contexts (9x9x9,
            sign-merged -> 365), per-occupied-context params + bitmap
  loco+ic   loco + inter-channel residual correction
            (pred_ch += round(alpha * res_prev_ch), alpha per image)

Usage: python -m l3c_torch.tools.anchor_sweep [val_dir] [--limit N]
"""
import os
import sys

import numpy as np

from ..data.images import load_image_uint8
from ..eval import classic


def med_pred_plane(x):
    """uint8 (H, W) -> int32 MED predictions (same boundary rules as
    ops/csrc/l3c_coder.cpp:l3c_med_residuals)."""
    x = x.astype(np.int32)
    h, w = x.shape
    a = np.empty_like(x); a[:, 1:] = x[:, :-1]; a[:, 0] = -1
    b = np.empty_like(x); b[1:] = x[:-1]; b[0] = -1
    c = np.empty_like(x); c[1:, 1:] = x[:-1, :-1]; c[0] = -1; c[:, 0] = -1
    mx = np.maximum(a, b); mn = np.minimum(a, b)
    pred = np.where(c >= mx, mn, np.where(c <= mn, mx, a + b - c))
    pred[0, 1:] = a[0, 1:]
    pred[1:, 0] = b[1:, 0]
    pred[0, 0] = 128
    return pred


def act_ctx_plane(x, n_ctx, fine=False):
    """Activity contexts: doubling thresholds (codec v2) or the finer
    16-band grid."""
    x = x.astype(np.int32)
    a = np.empty_like(x); a[:, 1:] = x[:, :-1]
    b = np.empty_like(x); b[1:] = x[:-1]
    c = np.empty_like(x); c[1:, 1:] = x[:-1, :-1]
    act = np.abs(b - c) + np.abs(c - a)
    if fine:
        ths = [1, 2, 3, 5, 7, 11, 15, 23, 31, 47, 63, 95, 127, 191, 255]
        ths = ths[:n_ctx - 1]
    else:
        ths, t = [], 1
        for _ in range(n_ctx - 1):
            ths.append(t); t = 2 * t + 1
    ctx = np.zeros_like(x)
    for t in ths:
        ctx += (act >= t)
    ctx[0] = 0
    ctx[:, 0] = 0
    return ctx


def loco_ctx_plane(x):
    """LOCO-I signed 3-gradient contexts: g1=d-b, g2=b-c, g3=c-a each
    quantized to 9 bands (0, +-[1,2], +-[3,6], +-[7,20], +-[21,)), then
    sign-merged: if the first nonzero g is negative, flip all signs and
    set flip=1 (residual is negated when coding). Returns (ctx, flip),
    ctx in [0, 365)."""
    x = x.astype(np.int32)
    h, w = x.shape
    a = np.empty_like(x); a[:, 1:] = x[:, :-1]; a[:, 0] = 0
    b = np.empty_like(x); b[1:] = x[:-1]; b[0] = 0
    c = np.empty_like(x); c[1:, 1:] = x[:-1, :-1]; c[0] = 0; c[:, 0] = 0
    d = np.empty_like(x); d[1:, :-1] = x[:-1, 1:]; d[0] = 0
    d[1:, -1] = b[1:, -1]  # j=W-1: d falls back to b -> g1=0

    def q(g):
        s = np.sign(g)
        m = np.abs(g)
        band = (m >= 1).astype(np.int32) + (m >= 3) + (m >= 7) + (m >= 21)
        return s * band  # in [-4, 4]

    g1, g2, g3 = q(d - b), q(b - c), q(c - a)
    first = np.where(g1 != 0, g1, np.where(g2 != 0, g2, g3))
    flip = first < 0
    sg = np.where(flip, -1, 1)
    g1, g2, g3 = g1 * sg, g2 * sg, g3 * sg
    ctx = (g1 + 4) * 81 + (g2 + 4) * 9 + (g3 + 4)
    # merged index: canonical contexts have first nonzero g > 0; map
    # the 9^3=729 raw ids to 365 canonical ids by rank among canonicals
    ctx[0] = 364  # first row/col: g's are computed from zeros; keep as-is
    ctx[:, 0] = 364
    flip[0] = False
    flip[:, 0] = False
    return ctx, flip


def tsgd_bits(res_flat):
    """Codelength (bits) of residuals under the per-context quantized
    TSGD actually used by the codec, + 16 header bits."""
    if res_flat.size == 0:
        return 0.0
    t_idx, p_idx = classic._fit_tsgd(res_flat)
    cum = classic._tsgd_cum(t_idx, p_idx).astype(np.int64)
    f = np.diff(cum)
    bits = -np.log2(f[res_flat] / 65536.0)
    return float(bits.sum()) + 16.0


def est_act(img, n_ctx, fine):
    total = 0.0
    for ch in range(img.shape[2]):
        plane = img[:, :, ch]
        res = ((plane.astype(np.int32) - med_pred_plane(plane)) & 255)
        ctx = act_ctx_plane(plane, n_ctx, fine)
        for k in range(n_ctx):
            total += tsgd_bits(res[ctx == k].ravel())
    return total / img.size


def est_loco(img, inter_channel=False):
    total = 0.0
    h, w, C = img.shape
    prev_res = None
    for ch in range(C):
        plane = img[:, :, ch]
        pred = med_pred_plane(plane)
        if inter_channel and prev_res is not None:
            # signed residual of the previous channel, centered
            pr = ((prev_res + 128) & 255) - 128
            # fit alpha on the true residual (pre-mod): r ~ alpha*pr
            r_signed = plane.astype(np.int32) - pred
            denom = float((pr * pr).sum()) or 1.0
            alpha = float((r_signed * pr).sum()) / denom
            alpha_q = int(np.clip(round(alpha * 64), -127, 127))
            pred = pred + np.round(pr * (alpha_q / 64.0)).astype(np.int32)
            total += 8  # alpha byte
        res = (plane.astype(np.int32) - pred) & 255
        prev_res = res
        ctx, flip = loco_ctx_plane(plane)
        res_c = np.where(flip, (-res) & 255, res)
        used = np.unique(ctx)
        total += 729 / 8 * 8  # occupancy bitmap bits (729 raw ids)
        for k in used:
            total += tsgd_bits(res_c[ctx == k].ravel())
    return total / img.size


def main():
    val_dir = sys.argv[1] if len(sys.argv) > 1 else "demo_data/real/val"
    limit = None
    if "--limit" in sys.argv:
        limit = int(sys.argv[sys.argv.index("--limit") + 1])
    files = sorted(os.listdir(val_dir))
    if limit:
        rng = np.random.RandomState(0)
        files = list(rng.permutation(files)[:limit])
    sums = {}
    n_sub = 0
    for i, f in enumerate(files):
        img = load_image_uint8(os.path.join(val_dir, f))
        n_sub += img.size
        sums.setdefault("v2_real", 0.0)
        sums["v2_real"] += len(classic.encode(img)) * 8.0
        sums.setdefault("act8_est", 0.0)
        sums["act8_est"] += est_act(img, 8, False) * img.size
        sums.setdefault("act16_est", 0.0)
        sums["act16_est"] += est_act(img, 16, True) * img.size
        sums.setdefault("loco_est", 0.0)
        sums["loco_est"] += est_loco(img) * img.size
        sums.setdefault("loco_ic_est", 0.0)
        sums["loco_ic_est"] += est_loco(img, True) * img.size
        if (i + 1) % 20 == 0:
            print(f"  .. {i + 1}/{len(files)}", flush=True)
    for k, v in sums.items():
        print(f"{k:14s} {v / n_sub:.4f} bpsp")


if __name__ == "__main__":
    main()
