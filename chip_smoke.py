#!/usr/bin/env python3
"""Drive the l3c_torch codec path on one NVIDIA card and check it.

    python3 chip_smoke.py      # exits 0 only if every phase holds

Phases (each raises on failure; none carries on after another failed):
  1. device   card name / power limit; build the four CUDA kernels
  2. forward  load the r5b checkpoint (flax msgpack, read without msgpack)
              at full cr.cf width; theory bpsp of 8 images of 512x512 (the
              bench.py image recipe); GPU vs CPU bpsp on a 64x64 crop
  3. codec    the main path with every kernel launch count set to 0:
              TorchBitcoding.encode_batch (fbatch 8, balanced, topk 4) ->
              v8 files -> decode_batch, which also builds the scale-0 v7
              float rows; asserts bit-exact, prints file vs theory bpsp
              and enc/dec times
  4. kernels  each kernel against its plain PyTorch version on the card at
              the main path's shapes and inputs: exact for the rANS scans,
              <= 1 step (coarse) / <= 2 steps on well-conditioned rows
              (fine) for the float rows; times by CUDA events
  5. profile  device time by op and by kernel over one more encode+decode
              round (torch.profiler), and the device's busy share
  6. report   one JSON line of kernel records, the card line, then
              {"ok": true, "device": {...}} as the last line

Exits non-zero, printing no result, without CUDA or without the repo.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from l3c_torch import blueprint
from l3c_torch.codec.bitcoding2 import (TorchBitcoding, canary_inputs,
                                        canary_leaves, contract_canary,
                                        fbatch_for)
from l3c_torch.config import MsConfig
from l3c_torch.device import numerics_guard
from l3c_torch.models import layers
from l3c_torch.models.network import MultiscaleNetwork
from l3c_torch.models.weights import load_network_weights
from l3c_torch.ops import float_cdf, gpu_coder, int_coder, kernels
from l3c_torch.ops.kernels import build

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "models_zoo",
                    "0820_0345 cr oi_offline r@0819_0307 r5b", "ckpts",
                    "ckpt_0000246250.ckpt")
SZ, B = 512, 8                       # bench.py's serving shape
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
FP32_OPS_PER_S = 67e12               # non-tensor float32 peak

KERNEL_INFO = {
    "mixture_cdf_q": ("l3c_torch/ops/kernels/csrc/float_cdf.cu",
                      "tools/pallas_cdf.py:48"),
    "fine_cdf_q": ("l3c_torch/ops/kernels/csrc/float_cdf.cu",
                   "tools/pallas_cdf.py:120"),
    "rans_encode": ("l3c_torch/ops/kernels/csrc/rans.cu",
                    "l3c_tpu/ops/tpu_coder.py:305"),
    "rans_decode": ("l3c_torch/ops/kernels/csrc/rans.cu",
                    "l3c_tpu/ops/tpu_coder.py:481"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of fn() over `reps` runs, by CUDA events."""
    fn()                                              # warm-up
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def bound(bytes_moved: float, ops: float):
    """(ms, 'bytes'|'operations'): the larger of bytes over HBM rate and
    operations over the float32 peak."""
    t_b = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_o = ops / FP32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def bench_images():
    """bench.py's recipe: gradient base + noise, seed 0, the first draw
    being bench.py's single warm-up image."""
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:SZ, 0:SZ]
    base = np.stack([yy % 256, xx % 256, (yy + xx) % 256], -1)
    draw = lambda: np.clip(base + rng.randint(-8, 8, base.shape), 0,
                           255).astype(np.uint8)[None]
    draw()
    return [draw() for _ in range(B)]


def phase_device():
    card = card_line()
    log(f"[device] {card} | torch.cuda: {torch.cuda.get_device_name(0)}"
        f" | torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    build.build()
    log(f"[device] built {list(build.SOURCES)} in "
        f"{time.perf_counter() - t0:.2f} s (nvcc in parallel)")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[device]   {name}: {line.strip()}")
    return card


def phase_forward(cfg, net, imgs, card):
    dev = next(net.parameters()).device
    with torch.inference_mode():
        x = torch.from_numpy(np.concatenate(imgs)).to(dev).float()
        t0 = time.perf_counter()
        out = net(x)
        bpsp = float(blueprint.total_bpsp(blueprint.compute_loss(cfg, out)))
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        del out
        crop = np.ascontiguousarray(imgs[0][:, :64, :64])
        b_gpu = float(blueprint.total_bpsp(blueprint.compute_loss(
            cfg, net(torch.from_numpy(crop).to(dev).float()))))
        net_cpu = MultiscaleNetwork(cfg)
        net_cpu.load_state_dict({k: v.cpu()
                                 for k, v in net.state_dict().items()})
        b_cpu = float(blueprint.total_bpsp(blueprint.compute_loss(
            cfg, net_cpu(torch.from_numpy(crop).float()))))
    rel = abs(b_gpu - b_cpu) / b_cpu
    log(f"[forward] r5b theory bpsp {bpsp:.6f} on {B}x{SZ}x{SZ} "
        f"(forward+loss {fwd_s * 1e3:.1f} ms) | 64x64 crop GPU {b_gpu:.7f} "
        f"CPU {b_cpu:.7f} rel {rel:.2e} | {card}")
    if not (math.isfinite(bpsp) and 0 < bpsp < 16):
        raise RuntimeError(f"theory bpsp {bpsp} out of range")
    if rel > 1e-4:
        raise RuntimeError(f"GPU/CPU bpsp disagree: rel {rel:.2e} > 1e-4")
    return bpsp


def phase_codec(bc, imgs, theory_bpsp, card):
    """The main path, launch-counted; then two more timed rounds."""
    enc_ms, dec_ms = [], []
    with tempfile.TemporaryDirectory(prefix="l3c_smoke_") as d:
        warm = [os.path.join(d, f"warm{b}.l3c") for b in range(B)]
        bc.encode_batch(imgs, warm)        # cuDNN / allocator warm-up
        bc.decode_batch(warm)
        for r in range(3):
            paths = [os.path.join(d, f"r{r}_{b}.l3c") for b in range(B)]
            if r == 0:
                kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bpsps = bc.encode_batch(imgs, paths)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            outs = bc.decode_batch(paths, float_rows=(r == 0))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if r == 0:
                counts = dict(kernels.launches)
            for im, o in zip(imgs, outs):
                if not np.array_equal(o, im):
                    raise RuntimeError("round trip is NOT bit-exact")
            enc_ms.append((t1 - t0) * 1e3)
            dec_ms.append((t2 - t1) * 1e3)
    missing = [k for k in kernels.KERNELS if not counts.get(k)]
    if missing:
        raise RuntimeError(f"main path never launched {missing}: {counts}")
    file_bpsp = float(np.mean(bpsps))
    mp = B * SZ * SZ / 1e6
    e, dd = statistics.median(enc_ms), statistics.median(dec_ms)
    log(f"[codec] bit-exact {B}x{SZ}x{SZ} fbatch {fbatch_for(B)} balanced "
        f"topk {bc.coder_topk} | file bpsp {file_bpsp:.6f} vs theory "
        f"{theory_bpsp:.6f} (+{100 * (file_bpsp / theory_bpsp - 1):.2f}%) |"
        f" enc {e:.1f} ms ({mp / e * 1e3:.3f} MP/s) dec {dd:.1f} ms "
        f"({mp / dd * 1e3:.3f} MP/s) enc+dec {mp / (e + dd) * 1e3:.3f} MP/s"
        f" | rounds enc {[round(t, 1) for t in enc_ms]} dec "
        f"{[round(t, 1) for t in dec_ms]} | {card}")
    log(f"[codec] main-path launches {counts}")
    # whether files written here decode on a CPU build (and the JAX
    # package): the canary attests the float pack stage rounds alike
    cpu = contract_canary(bc._rgb, bc._bn, bc.cfg.q.C, bc.cfg.prob.K,
                          bc.coder_topk, torch.device("cpu"))
    card_c = bc.canary(bc.coder_topk)
    log(f"[codec] canary topk {bc.coder_topk}: card {card_c:#010x} cpu "
        f"{cpu:#010x} ({'equal' if cpu == card_c else 'DIFFERENT'})")
    # where card and CPU part ways on the canary's inputs: the float pack
    # stage (entries differing per IntParams field), and the integer
    # rows/lookups evaluated on the card from the CPU's IntParams (which
    # the exact-integer design says must be identical)
    l_rgb, l_bn, t_rgb, t_bn = canary_inputs(bc._bn, bc.cfg.q.C,
                                             bc.cfg.prob.K)
    ips = {}
    with torch.inference_mode():
        for name, spec, l, C in (("rgb", bc._rgb, l_rgb, 3),
                                 ("bn", bc._bn, l_bn, bc.cfg.q.C)):
            ips[name] = [int_coder.pack_int_params(
                spec, torch.from_numpy(l).to(d), C, bc.coder_topk)
                for d in (bc.device, torch.device("cpu"))]
            diffs = {f: (int((a.cpu() != b).sum()), a.numel())
                     for f, a, b in zip(ips[name][0]._fields, *ips[name])
                     if a is not None}
            log(f"[codec] pack_int_params card vs cpu, {name} canary "
                "inputs: " + ", ".join(f"{f} {n}/{m}"
                                       for f, (n, m) in diffs.items()))
        to_card = lambda ip: int_coder.IntParams(
            *[None if x is None else x.to(bc.device) for x in ip])
        t_r, t_b = torch.from_numpy(t_rgb), torch.from_numpy(t_bn)
        on_cpu = canary_leaves(ips["rgb"][1], ips["bn"][1], t_r, t_b,
                               bc._bn.L)
        on_card = canary_leaves(to_card(ips["rgb"][1]),
                                to_card(ips["bn"][1]), t_r.to(bc.device),
                                t_b.to(bc.device), bc._bn.L)
    n_bad = sum(int((a.cpu() != b).sum()) for (a, _), (b, _)
                in zip(on_card, on_cpu))
    log(f"[codec] integer rows/lookups from the same IntParams, card vs "
        f"cpu: {n_bad} of {sum(b.numel() for b, _ in on_cpu)} differ")
    if n_bad:
        raise RuntimeError("exact-integer evaluator differs on the card")
    if not (0 < file_bpsp < 2 * theory_bpsp + 1):
        raise RuntimeError(f"file bpsp {file_bpsp} implausible")
    return counts, e + dd


def _scale0_params(bc, imgs):
    """IntParams of scale 0 and the uint8 batch, as encode computes them."""
    x = torch.from_numpy(np.concatenate(imgs)).to(bc.device)
    with torch.inference_mode():
        per_scale = bc.net.enc_forward(layers.sub_rgb_mean(x.float()))
        dec_F, bn = None, per_scale[-1].bn_q
        for scale in reversed(range(bc.cfg.num_scales)):
            ip, dec_F, _ = bc._get_P_int(scale, bc.coder_topk, bn, dec_F)
            if scale:
                bn = per_scale[scale - 1].bn_q
    return ip, x


def phase_kernels(bc, imgs, counts):
    recs = []

    def record(name, err, ms, plain_ms, b):
        src, repl = KERNEL_INFO[name]
        recs.append(dict(name=name, route="cuda", source=src, replaces=repl,
                         launches=counts[name], max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
                         library_ms=None))
        log(f"[kernels] {name}: max|diff| {err} | {ms * 1e3:.1f} us/launch"
            f" | plain {plain_ms * 1e3:.1f} us | bound {b[0] * 1e3:.1f} us"
            f" ({b[1]}) | main-path launches {counts[name]}")

    # ---- K1 / K2 on the decoded scale-0 params (the main path's inputs)
    fr = bc.last_float_rows
    spec = bc._rgb
    bw, t0 = float_cdf._bw_t0(spec)
    err1 = err2 = 0
    for c in range(3):
        pi, mu, inv_s = float_cdf.channel_params_packed(
            spec, fr["packed"], c, fr["decoded"])
        t = float_cdf.coarse_edge_targets(spec, pi.device)
        a = (fr["decoded"][..., c].reshape(-1) / 16.0).floor()
        k1 = float_cdf.mixture_cdf_q(pi, mu, inv_s, t, 16)
        p1 = float_cdf.mixture_cdf_q_plain(pi, mu, inv_s, t, 16)
        err1 = max(err1, int((k1 - p1).abs().max()))
        k2 = float_cdf.fine_cdf_q(pi, mu, inv_s, a, bw, t0)
        p2 = float_cdf.fine_cdf_q_plain(pi, mu, inv_s, a, bw, t0)
        tt = (a[:, None] * 16.0 + torch.arange(17.0, device=a.device)) \
            * bw + t0
        cv = float_cdf.edge_cdf(pi, mu, inv_s, tt)
        good = (cv[:, -1] - cv[:, 0]) > 1e-2
        err2 = max(err2, int((k2 - p2)[good].abs().max()))
        for q in (k1, k2):
            rows = float_cdf.finish_rows(q)
            top = torch.full((rows.shape[0], 1), 65536, device=rows.device)
            if not (torch.diff(torch.cat([rows, top], 1), dim=1) >= 1).all():
                raise RuntimeError("float rows not strictly increasing")
        # the main path's rows are these kernels' rows
        if not torch.equal(fr["rows"][c][0], float_cdf.finish_rows(k1)):
            raise RuntimeError("main-path coarse rows differ from K1")
    if err1 > 1 or err2 > 2:
        raise RuntimeError(f"float rows off: K1 {err1} K2 {err2} steps")
    P, K = pi.shape
    log(f"[kernels] float rows: P={P} K={K}, 3 channels, good fine rows "
        f"{int(good.sum())}/{P} (channel 2)")
    record("mixture_cdf_q", err1,
           cuda_ms(lambda: float_cdf.mixture_cdf_q(pi, mu, inv_s, t, 16)),
           cuda_ms(lambda: float_cdf.mixture_cdf_q_plain(pi, mu, inv_s, t,
                                                         16)),
           # f32 params in; rows (u16 values) out at 2 bytes
           bound(3 * P * K * 4 + 16 * 4 + P * 16 * 2, P * 16 * K * 8))
    record("fine_cdf_q", err2,
           cuda_ms(lambda: float_cdf.fine_cdf_q(pi, mu, inv_s, a, bw, t0)),
           cuda_ms(lambda: float_cdf.fine_cdf_q_plain(pi, mu, inv_s, a, bw,
                                                      t0)),
           # coarse symbols (< 16) in at 1 byte, rows out at 2 bytes
           bound(3 * P * K * 4 + P + P * 16 * 2,
                 P * 17 * K * 8 + P * 16 * 4))
    bc.last_float_rows = None
    del fr, pi, mu, inv_s

    # ---- K3 / K4 on the scale-0 unit's real (start, freq) and rows
    ip, x = _scale0_params(bc, imgs)
    F, h, w, _ = x.shape
    n = h * w
    T = gpu_coder.t_policy(n, bc.coder_profile)
    with torch.inference_mode():
        start, freq = bc.rgb_lookups(ip, x)
        lay6 = gpu_coder.layout_for(n, 6 * F, T)
        st = gpu_coder._to_streams(start, lay6).contiguous()
        fq = gpu_coder._to_streams(freq, lay6).contiguous()
        m6 = gpu_coder._mask_for(lay6, st.device)
        wk, lk = gpu_coder.rans_encode(st, fq, m6)
        wp, lp = gpu_coder.rans_encode_plain(st, fq, m6)
        # the kernel leaves slots past a stream's length unwritten
        used = torch.arange(T + 2, device=lk.device)[None, :] < lk[:, None]
        if not (torch.equal(lk, lp) and torch.equal(wk[used], wp[used])):
            raise RuntimeError("rans_encode kernel != plain")
        ns = st.shape[0]
        active = int(m6.sum())
        # bytes at the width of the values: start, freq and the emitted
        # words are u16 (2 bytes), the mask 1 byte, lengths u16; only the
        # words each stream emits are written
        record("rans_encode", 0,
               cuda_ms(lambda: gpu_coder.rans_encode(st, fq, m6)),
               cuda_ms(lambda: gpu_coder.rans_encode_plain(st, fq, m6), 3),
               bound(ns * T * (2 + 2 + 1) + int(lk.sum()) * 2 + ns * 2,
                     active * 12))
        # channel 0 coarse streams: the first F*ns_c lanes of the 6F stack
        lay = gpu_coder.layout_for(n, F, T)
        rows = int_coder.rgb_coarse_rows(ip, 0, ())
        rl = torch.nn.functional.pad(rows.reshape(16, F, n), (0, lay.pad)) \
            .reshape(16, lay.lanes, T).contiguous()
        cols = int(lk[:lay.lanes].max())
        wd = wk[:lay.lanes, :cols].contiguous()
        mk = gpu_coder._mask_for(lay, rl.device)
        sk = gpu_coder.rans_decode(rl, wd, mk)
        sp = gpu_coder.rans_decode_plain(rl, wd, mk)
        if not torch.equal(sk, sp):
            raise RuntimeError("rans_decode kernel != plain")
        a0 = (x[..., 0].to(torch.int64) >> 4).reshape(-1)
        if not torch.equal(gpu_coder._from_streams(sk, lay).reshape(-1)
                           .to(torch.int64), a0):
            raise RuntimeError("rans_decode did not recover the symbols")
        record("rans_decode", 0,
               cuda_ms(lambda: gpu_coder.rans_decode(rl, wd, mk)),
               cuda_ms(lambda: gpu_coder.rans_decode_plain(rl, wd, mk), 3),
               # rows u16 (2 bytes), each stream's own words u16, mask
               # and symbols (< 16) 1 byte each
               bound(16 * lay.lanes * T * 2 + int(lk[:lay.lanes].sum()) * 2
                     + lay.lanes * T * 2, lay.lanes * T * (16 * 3 + 10)))
        log(f"[kernels] rans shapes: encode NS={ns} T={T}; decode L=16 "
            f"NS={lay.lanes} T={T} W={cols}")
    return recs


def phase_profile(bc, imgs, round_ms):
    """Device time by op and kernel over one encode+decode round
    (torch.profiler); busy share against the unprofiled round's wall time
    `round_ms` (profiling itself slows the host side many times over)."""
    from torch.profiler import ProfilerActivity, profile
    with tempfile.TemporaryDirectory(prefix="l3c_prof_") as d:
        paths = [os.path.join(d, f"p{b}.l3c") for b in range(B)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            bc.encode_batch(imgs, paths)
            bc.decode_batch(paths)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ev = [e for e in prof.key_averages()
          if getattr(e, "self_device_time_total", 0) > 0]
    # kernels are device-type events; host ops carry their kernels' time
    # again as self device time, so sum only the former
    kern = [e for e in ev if str(e.device_type).endswith("CUDA")]
    ops = [e for e in ev if not str(e.device_type).endswith("CUDA")]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    log(f"[profile] enc+dec round: device busy {busy:.1f} ms in "
        f"{sum(e.count for e in kern)} kernel launches = "
        f"{100 * busy / round_ms:.1f}% of the unprofiled round's "
        f"{round_ms:.1f} ms wall (profiled wall {wall:.1f} ms)")
    for title, group in (("op", ops), ("kernel", kern)):
        group.sort(key=lambda e: -e.self_device_time_total)
        for e in group[:12]:
            log(f"[profile] {title:6s} {e.self_device_time_total / 1e3:9.2f}"
                f" ms {e.count:6d}x  {e.key[:80]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    numerics_guard()
    card = phase_device()
    cfg = MsConfig()
    net = MultiscaleNetwork(cfg)
    step = load_network_weights(net, CKPT)
    net = net.cuda().eval()
    n_params = sum(p.numel() for p in net.parameters())
    log(f"[forward] r5b @ step {step}: {n_params}"
        f" params, cr.cf (S=3 Cf=64 8+8 blocks q.C=5 q.L=25 K=10)")
    imgs = bench_images()
    theory = phase_forward(cfg, net, imgs, card)
    bc = TorchBitcoding(cfg, net, device="cuda", coder_profile="balanced",
                        coder_topk=4)
    counts, round_ms = phase_codec(bc, imgs, theory, card)
    recs = phase_kernels(bc, imgs, counts)
    phase_profile(bc, imgs, round_ms)
    log(f"[done] {time.perf_counter() - t_start:.1f} s total")
    print(json.dumps({"kernels": recs}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
