#!/usr/bin/env python3
"""Profile K6 (l3c_torch/ops/kernels/csrc/dmll.cu) on the card at
training's six launch shapes, against another dmll.cu.

    python3 profile_k6.py --baseline OTHER/dmll.cu [--out OUT.json]

It builds three sources: this tree's dmll.cu; `math`, a copy whose tile
load is replaced by zeros in shared memory (the kernel without reading its
planes); and the baseline (e.g. an earlier commit's dmll.cu unpacked
beside the tree). For each shape (batch 16 at full cr.cf width: scale 0 l
(16, 120, 128, 128) with lambda, scales 1 and 2 (16, 150, 64, 64) and
(16, 150, 32, 32), seeded inputs spread as a trained classifier's are),
forward and backward, it holds this tree's outputs to the baseline's bit
for bit, and prints and writes for each source, in the order this, math,
baseline, baseline, math, this:
  - event_ms: CUDA events around one call, the wrapper's host time
    included (chip_smoke.cuda_ms, as chip_smoke.py's records take it);
  - device_ms: device time a launch, 20 queued behind a sleeping kernel
    with L2 flushed between them (chip_smoke.queued_ms);
  - copy_ms: a kernel that only streams the launch's bytes (inputs read
    once, outputs written once, 16 bytes a thread), timed as device_ms;
  - the bound (chip_smoke.k6_bound) and the registers a thread (ptxas).
Exits 2 without a card.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import torch

from chip_smoke import card_line, cuda_ms, k6_bound, queued_ms
from l3c_torch.models import dmll
from l3c_torch.ops import kernels
from l3c_torch.ops.kernels import build

SHAPES = (("scale 0", True, 3, 128), ("scale 1", False, 5, 64),
          ("scale 2", False, 5, 32))          # (label, lambda, C, H = W)
N, K = 16, 10
# the rewrite that makes `math` of this tree's dmll.cu
TILE_LOAD = "  load_tile(tile, A.l + base, Kp, HW, n_px, vec);\n"
ZERO_TILE = ("  for (int i = threadIdx.x; i < Kp * kTile; i += blockDim.x)\n"
             "    tile[i] = 0.0f;\n")
STREAM_CU = r"""
#include <cuda_runtime.h>
// reads n_in float4 once and writes n_out float4 once
__global__ void stream_bytes(const float4* __restrict__ a, long long n_in,
                             float4* __restrict__ o, long long n_out) {
  const long long n = n_in > n_out ? n_in : n_out;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n;
       i += 256LL * gridDim.x) {
    float4 v = i < n_in ? a[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < n_out) o[i] = v;
  }
}
extern "C" int l3c_stream(const void* a, long long n_in, void* o,
                          long long n_out, void* stream) {
  stream_bytes<<<132 * 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(a), n_in, static_cast<float4*>(o), n_out);
  return static_cast<int>(cudaGetLastError());
}
"""


def nvcc(src: str, out: str) -> str:
    """Build src into out with the port's flags; returns ptxas's report."""
    res = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS,
                          f"-I{build.CSRC}", "-o", out, src],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {src}:\n{res.stdout}{res.stderr}")
    return res.stdout + res.stderr


def registers(report: str, grad: bool, lam: bool) -> int:
    """Registers a thread of dmll_kernel<grad, lam> in ptxas's report."""
    tag, name = f"ILb{int(grad)}ELb{int(lam)}EE", None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name and tag in name:
            return int(m.group(1))
    raise RuntimeError(f"no ptxas line for dmll_kernel<{grad}, {lam}>")


@contextlib.contextmanager
def using(lib):
    """kernels.dmll_nll / dmll_nll_grad launch `lib`'s kernels."""
    orig = build.library
    build.library = lambda name: lib if name == "dmll" else orig(name)
    try:
        yield
    finally:
        build.library = orig


def inputs(lam: bool, C: int, H: int, gen: torch.Generator):
    """l (N, Kp, H, W) NCHW, x (N, H, W, C) on the spec's grid with both
    tails, g; parameters spread as a trained classifier's are."""
    groups = 4 if lam else 3
    l = torch.randn((N, groups, C, K, H, H), generator=gen,
                    device="cuda") * 2
    if lam:
        l[:, 1] = l[:, 1] * 40 + 128
        x = torch.randint(0, 256, (N, H, H, C), generator=gen,
                          device="cuda").float()
    else:
        l[:, 1] *= 0.4
        lv = torch.linspace(-1.0, 1.0, 25, device="cuda")
        x = lv[torch.randint(0, 25, (N, H, H, C), generator=gen,
                             device="cuda")]
    l[:, 2] = l[:, 2] - 1.0
    g = torch.rand((N, H, H, C), generator=gen, device="cuda")
    return l.reshape(N, groups * C * K, H, H).contiguous(), x, g


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True,
                    help="another dmll.cu to build, time and compare with")
    ap.add_argument("--out", default=os.path.join(build.BUILD_DIR,
                                                  "k6_profile.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_k6: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(f"{card} | torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    src = open(os.path.join(build.CSRC, "dmll.cu")).read()
    if TILE_LOAD not in src:
        raise RuntimeError(f"dmll.cu no longer contains {TILE_LOAD!r}")
    todo = {"this": src, "math": src.replace(TILE_LOAD, ZERO_TILE),
            "baseline": open(args.baseline).read()}
    tmp = tempfile.mkdtemp(prefix="k6_profile_")
    libs, reports = {}, {}
    for name, text in todo.items():
        path = os.path.join(tmp, f"dmll_{name}.cu")
        open(path, "w").write(text)
        so = os.path.join(tmp, f"libdmll_{name}.so")
        reports[name] = nvcc(path, so)
        libs[name] = build._bind("dmll", so)
    stream_src = os.path.join(tmp, "stream.cu")
    open(stream_src, "w").write(STREAM_CU)
    nvcc(stream_src, os.path.join(tmp, "libstream.so"))
    slib = ctypes.CDLL(os.path.join(tmp, "libstream.so"))
    slib.l3c_stream.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                ctypes.c_void_p, ctypes.c_longlong,
                                ctypes.c_void_p]
    flush_buf = torch.empty(32 * 2 ** 20, device="cuda")      # 128 MB
    flush = lambda: torch.sum(flush_buf)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, equal = [], []
    order = list(libs) + list(reversed(list(libs)))
    for label, lam, C, H in SHAPES:
        l, x, g = inputs(lam, C, H, gen)
        spec = dmll.DMLLSpec(True) if lam else dmll.DMLLSpec(False, -1.0,
                                                              1.0, 25)
        consts = (spec.bin_width / 2.0, spec.x_lower_bound,
                  spec.x_upper_bound)
        for grad in (False, True):
            kind = f"{label} {'bwd' if grad else 'fwd'}"
            b_ms, b_by = k6_bound(l, x, spec, grad)
            n_in = (l.numel() + x.numel() * (2 if grad else 1)) // 4
            n_out = (x.numel() + (l.numel() if grad else 0)) // 4
            src_buf = torch.empty(n_in * 4, device="cuda")
            dst_buf = torch.empty(n_out * 4, device="cuda")
            copy = queued_ms(lambda: slib.l3c_stream(
                src_buf.data_ptr(), n_in, dst_buf.data_ptr(), n_out,
                torch.cuda.current_stream().cuda_stream), flush=flush)
            fn = ((lambda: kernels.dmll_nll_grad(l, x, g, lam, *consts))
                  if grad else (lambda: (kernels.dmll_nll(l, x, lam,
                                                          *consts),)))
            got = {}
            for name in ("this", "baseline"):
                with using(libs[name]):
                    got[name] = fn()
            same = all(torch.equal(a, b) for a, b in zip(*got.values()))
            del got
            print(f"{kind}: this tree's outputs equal the baseline's bit "
                  f"for bit: {same}", flush=True)
            equal.append(dict(shape=label, grad=grad, same=same))
            for run, name in enumerate(order):
                with using(libs[name]):
                    row = dict(shape=label, grad=grad, source=name,
                               pass_=run // len(libs), event_ms=cuda_ms(fn),
                               device_ms=queued_ms(fn, flush=flush),
                               copy_ms=copy, bound_ms=b_ms, bound_by=b_by,
                               regs=registers(reports[name], grad, lam),
                               card=card)
                rows.append(row)
                print(f"{kind} {name:8s} event {row['event_ms']:.4f} device "
                      f"{row['device_ms']:.4f} copy {copy:.4f} bound "
                      f"{b_ms:.4f} ({b_by}) | {row['regs']} regs",
                      flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "rows": rows, "equal_to_baseline": equal},
                  f, indent=1)
    shutil.rmtree(tmp)
    return 0 if all(e["same"] for e in equal) else 1


if __name__ == "__main__":
    sys.exit(main())
