#!/usr/bin/env python3
"""Profile K3/K4 (l3c_torch/ops/kernels/csrc/rans.cu) on the card against
another rans.cu, at the shapes PERF.md records for the generic variants
and at the serving round's tiled ones.

    python3 profile_rans.py --baseline OTHER/rans.cu [--out OUT.json]

It builds this tree's rans.cu and the baseline (e.g. an earlier commit's
rans.cu unpacked beside the tree), then for each case codes seeded inputs
through the channel-level wrappers (ops/gpu_coder) with either library:
  - unit 0 of the RGB baselines (uniform, L = 256): cr_rgb's 24 groups of
    64^2 symbols at T = 1024 (balanced and size alike), cr_rgb_shared's 24
    groups of 256^2 at balanced (T = 1024) and at size (T = 8192);
  - chip_smoke.py phase limits' coder cases, 2 x 64^2 pixels a channel at
    T = 256: bn K' = 12 (L = 25) and 16 (L = 40), bn K' = 4 at L = 40,
    uniform L = 40, RGB K' = 12 and 16 (IntParams packed from seeded
    logits, as phase limits packs them);
  - the serving round's tiled RGB launches (K' = 4, 8 x 512^2, T = 2048,
    balanced): the stacked encode and channel 0's coarse and fine decode;
  - the same scale-0 launches at the size profile (T = 16384, top-k 0)
    with K' = 10 (the tiles) and K' = 12 (the generic variants).
It holds this tree's words, lengths and symbols to the baseline's bit for
bit (and the symbols to the coded ones), and prints and writes each
source's time in the order this, baseline, baseline, this: CUDA events
around one call (chip_smoke.cuda_ms, as chip_smoke.py's records take it,
the wrappers' host time included) and device time a call, 20 queued
behind a sleeping kernel (chip_smoke.queued_ms), each with T and the time
a step. A source whose comparison call took over SLOW_MS is not timed
(a one-thread-a-stream generic walk took ~1 s a launch there). Exits 2
without a card, 1 if any output differs.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile

import torch

from chip_smoke import card_line, coder_bound, cuda_ms, queued_ms
from l3c_torch import blueprint
from l3c_torch.config import MsConfig
from l3c_torch.models import dmll
from l3c_torch.ops import gpu_coder as gc, int_coder
from l3c_torch.ops.kernels import build
from profile_k6 import nvcc

LIMIT_N, LIMIT_SIDE, LIMIT_T = 2, 64, 256     # chip_smoke's phase limits
SLOW_MS = 100.0


@contextlib.contextmanager
def using(lib):
    """The coder wrappers launch `lib`'s kernels."""
    orig = build.library
    build.library = lambda name: lib if name == "rans" else orig(name)
    try:
        yield
    finally:
        build.library = orig


def used(w, ln):
    return w[torch.arange(w.shape[1], device=w.device)[None] < ln[:, None]]


def int_params(rgb: bool, K: int, L: int, N: int, side: int, topk: int,
               seed: int):
    """IntParams (C, K', N side^2) packed by the plain pack from seeded
    logits (phase limits' recipe)."""
    spec = (blueprint.rgb_spec(MsConfig()) if rgb else
            dmll.DMLLSpec(False, -1.0, 1.0, L))
    C = 3 if rgb else 5
    gen = torch.Generator(device="cuda").manual_seed(seed)
    l = torch.randn((N, spec.num_params * C * K, side, side), generator=gen,
                    device="cuda") * 2.0
    return int_coder.pack_int_params_nchw(spec, l, C, topk)


def cases(gen):
    """(label, T, bound, run, truth): run() codes with the current library
    (an encode: (words, lengths); a decode: [symbols], which must equal
    `truth`; None for an encode). Nothing in run() waits for the card."""
    out = []

    def uniform(label, groups, n, T, L):
        syms = torch.randint(0, L, (groups * n,), generator=gen,
                             device="cuda")
        lay = gc.layout_for(n, groups, T)

        def enc():
            return gc.encode_uniform(syms, L, lay)

        w, ln = gc.encode_uniform(syms, L, lay)
        words = w[:, :int(ln.max())].contiguous()

        n_w = int(ln.sum())
        out.append((f"K3 {label} NS={lay.lanes}", T,
                    coder_bound("enc uniform", None, syms.numel(),
                                n_w + ln.numel()), enc, None))
        out.append((f"K4 {label} NS={lay.lanes}", T,
                    coder_bound("dec uniform", None, syms.numel(), n_w,
                                L=L),
                    lambda: [gc.decode_uniform(words, L, lay)],
                    syms.reshape(groups, n)))

    def bn(label, ip, L, T):
        C, _, N = ip.p.shape
        syms = torch.randint(0, L, (C, N), generator=gen, device="cuda")
        lay = gc.layout_for(N, C, T)

        def enc():
            return gc.encode_bn(ip, syms, L, lay)

        w, ln = gc.encode_bn(ip, syms, L, lay)
        words = w[:, :int(ln.max())].contiguous()

        n_w = int(ln.sum())
        out.append((f"K3 {label} NS={lay.lanes}", T,
                    coder_bound("enc bn", ip, syms.numel(), n_w + ln.numel(),
                                L=L), enc, None))
        out.append((f"K4 {label} NS={lay.lanes}", T,
                    coder_bound("dec bn", ip, syms.numel(), n_w, L=L),
                    lambda: [gc.decode_bn(ip, words, L, lay)], syms))

    def rgb(label, ip, F, T):
        N = ip.p.shape[2]
        n = N // F
        img = torch.randint(0, 256, (3, N), generator=gen, device="cuda")
        lay6, lay = gc.layout_for(n, 6 * F, T), gc.layout_for(n, F, T)

        def enc():
            return gc.encode_rgb(ip, img, lay6)

        w6, l6 = gc.encode_rgb(ip, img, lay6)
        ns, half = F * lay.ns_c, lay6.lanes // 2
        cut = lambda r0: w6[r0:r0 + ns, :int(l6[r0:r0 + ns].max())
                            ].contiguous()
        wc, wf = cut(0), cut(half)
        planes = img.to(torch.uint8)
        a_true = (planes[0] >> 4).contiguous()
        out.append((f"K3 {label} NS={lay6.lanes}", T,
                    coder_bound("enc rgb", ip, N, int(l6.sum())), enc, None))
        out.append((f"K4 {label} coarse c=0 NS={lay.lanes}", T,
                    coder_bound("dec rgb_coarse", ip, N,
                                int(l6[:ns].sum())),
                    lambda: [gc.decode_rgb_coarse(ip, 0, planes, wc, lay)],
                    a_true))
        out.append((f"K4 {label} fine c=0 NS={lay.lanes}", T,
                    coder_bound("dec rgb_fine", ip, N,
                                int(l6[half:half + ns].sum())),
                    lambda: [gc.decode_rgb_fine(ip, 0, planes, a_true, wf,
                                                lay)], planes[0] & 15))

    # unit 0 of the RGB baselines: 3 channels x 8 images of the x8 / x2
    # downsampled 512^2 images
    uniform("unit 0 cr_rgb L=256", 24, 64 * 64, 1024, 256)
    uniform("unit 0 cr_rgb_shared balanced L=256", 24, 256 * 256, 1024, 256)
    uniform("unit 0 cr_rgb_shared size L=256", 24, 256 * 256, 8192, 256)
    # phase limits
    for K, L in ((12, 25), (16, 40)):
        bn(f"limits bn K'={K} L={L}",
           int_params(False, K, L, LIMIT_N, LIMIT_SIDE, 0, K), L, LIMIT_T)
    bn("limits bn K'=4 L=40",
       int_params(False, 10, 40, LIMIT_N, LIMIT_SIDE, 4, 40), 40, LIMIT_T)
    uniform("limits uniform L=40", 5, LIMIT_N * LIMIT_SIDE ** 2, LIMIT_T, 40)
    for K in (12, 16):
        rgb(f"limits RGB K'={K}",
            int_params(True, K, 16, LIMIT_N, LIMIT_SIDE, 0, K + 1), 1,
            LIMIT_T)
    # the serving round's scale-0 launches (tiled, K' = 4)
    rgb("serving RGB K'=4", int_params(True, 10, 16, 8, 512, 4, 7), 8, 2048)
    # ... and at the size profile, K' = 10 (tiled) and 12 (generic)
    for K in (10, 12):
        rgb(f"size RGB K'={K}", int_params(True, K, 16, 8, 512, 0, K), 8,
            16384)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True,
                    help="another rans.cu to build, time and compare with")
    ap.add_argument("--out", default=os.path.join(build.BUILD_DIR,
                                                  "rans_profile.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_rans: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(f"{card} | torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    todo = {"this": open(os.path.join(build.CSRC, "rans.cu")).read(),
            "baseline": open(args.baseline).read()}
    tmp = tempfile.mkdtemp(prefix="rans_profile_")
    libs = {}
    for name, text in todo.items():
        path = os.path.join(tmp, f"rans_{name}.cu")
        open(path, "w").write(text)
        so = os.path.join(tmp, f"librans_{name}.so")
        nvcc(path, so)
        libs[name] = build._bind("rans", so)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, equal = [], []
    with torch.inference_mode():
        for label, T, (b_ms, b_by), run, truth in cases(gen):
            got, once = {}, {}
            for name in ("this", "baseline"):
                t0, t1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                with using(libs[name]):
                    t0.record()
                    got[name] = run()
                    t1.record()
                torch.cuda.synchronize()
                once[name] = t0.elapsed_time(t1)
            order = [n for n in ("this", "baseline", "baseline", "this")
                     if once[n] <= SLOW_MS]
            if truth is None:       # lengths and the words each stream uses
                got = {k: [w[1], used(*w)] for k, w in got.items()}
            same = all(torch.equal(a, b) for a, b in zip(*got.values()))
            if truth is not None and not torch.equal(
                    got["this"][0].reshape(truth.shape).long(), truth.long()):
                raise RuntimeError(f"{label}: symbols not recovered")
            del got
            equal.append(dict(case=label, same=same))
            for i, name in enumerate(order):
                with using(libs[name]):
                    ms = cuda_ms(run)
                    dev = queued_ms(run)
                rows.append(dict(case=label, source=name, pass_=i // 2,
                                 event_ms=ms, device_ms=dev, T=T,
                                 ns_a_step=dev / T * 1e6, bound_ms=b_ms,
                                 bound_by=b_by, card=card))
                print(f"{label} T={T} {name:8s} event {ms:.4f} ms device "
                      f"{dev:.4f} ms ({dev / T * 1e6:.1f} ns a step) | "
                      f"bound {b_ms:.4f} ({b_by}) | equal to the baseline: "
                      f"{same}", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "rows": rows, "equal_to_baseline": equal},
                  f, indent=1)
    shutil.rmtree(tmp)
    return 0 if all(e["same"] for e in equal) else 1


if __name__ == "__main__":
    sys.exit(main())
