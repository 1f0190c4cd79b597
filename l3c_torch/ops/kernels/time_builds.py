"""Time the two ways to build the kernels of csrc/ on the card machine.

    python3 -m l3c_torch.ops.kernels.time_builds

Both start from an empty build directory and compile the same two sources
with the same nvcc flags:
  nvcc   what the port uses (build.py): one `nvcc` per source, in
         parallel, plain C interface, bound with ctypes;
  load   torch.utils.cpp_extension.load: the same sources plus one small
         binding file that includes <torch/extension.h> (it binds
         rans_encode, with TORCH_CHECKs), built by ninja.
Each route then launches rans_encode once on the same small input and the
outputs are compared. Prints the card line, one line per route, and a JSON
line {"nvcc_s": ..., "load_s": ... or null, "load_error": ...}.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

from . import build

BINDING = r"""
#include <torch/extension.h>
#include <c10/cuda/CUDAStream.h>

extern "C" int l3c_rans_encode(const void* start, const void* freq,
                               const void* mask, void* words, void* lengths,
                               int ns, int T, void* stream);

std::vector<torch::Tensor> rans_encode(torch::Tensor start,
                                       torch::Tensor freq,
                                       torch::Tensor mask) {
  TORCH_CHECK(start.is_cuda() && freq.is_cuda() && mask.is_cuda());
  TORCH_CHECK(start.scalar_type() == torch::kInt32 &&
              freq.scalar_type() == torch::kInt32 &&
              mask.scalar_type() == torch::kBool);
  TORCH_CHECK(start.dim() == 2 && freq.sizes() == start.sizes() &&
              mask.sizes() == start.sizes());
  TORCH_CHECK(start.is_contiguous() && freq.is_contiguous() &&
              mask.is_contiguous());
  const int ns = start.size(0), T = start.size(1);
  auto words = torch::empty({ns, T + 2}, start.options());
  auto lengths = torch::empty({ns}, start.options());
  const int rc = l3c_rans_encode(
      start.data_ptr(), freq.data_ptr(), mask.data_ptr(), words.data_ptr(),
      lengths.data_ptr(), ns, T, c10::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(rc == 0, "rans_encode launch failed: cudaError ", rc);
  return {words, lengths};
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("rans_encode", &rans_encode);
}
"""


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def _inputs(ns: int = 256, T: int = 512):
    g = torch.Generator().manual_seed(0)
    freq = torch.randint(1, 4096, (ns, T), generator=g, dtype=torch.int32)
    start = torch.randint(0, 65536 - 4096, (ns, T), generator=g,
                          dtype=torch.int32)
    mask = torch.ones((ns, T), dtype=torch.bool)
    return [x.cuda() for x in (start, freq, mask)]


def _used(words, lengths):
    keep = (torch.arange(words.shape[1], device=words.device)[None, :]
            < lengths[:, None])
    return words[keep], lengths


def time_nvcc(inputs):
    """Fresh build through build.py; returns (seconds, rans_encode out)."""
    shutil.rmtree(build.BUILD_DIR, ignore_errors=True)
    build._libs.clear()
    t0 = time.perf_counter()
    build.build()
    secs = time.perf_counter() - t0
    from . import rans_encode
    return secs, _used(*rans_encode(*inputs))


def time_load(inputs):
    """Fresh build through cpp_extension.load; returns (seconds, out)."""
    from torch.utils.cpp_extension import load
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    work = tempfile.mkdtemp(prefix="load_", dir=build.BUILD_DIR)
    binding = os.path.join(work, "binding.cpp")
    with open(binding, "w") as f:
        f.write(BINDING)
    out_dir = os.path.join(work, "ext")
    os.makedirs(out_dir)
    # load sets the C++ standard and the shared-library flags itself
    flags = [f for f in build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC", "-std=c++17")]
    t0 = time.perf_counter()
    ext = load(name="l3c_kernels_timed", build_directory=out_dir,
               sources=[binding] + [os.path.join(build.CSRC, f"{n}.cu")
                                    for n in build.SOURCES],
               extra_cflags=["-O3"], extra_cuda_cflags=flags, verbose=False)
    secs = time.perf_counter() - t0
    return secs, _used(*ext.rans_encode(*inputs))


def main() -> int:
    if not torch.cuda.is_available():
        print("time_builds: no CUDA device", file=sys.stderr)
        return 2
    card = _card_line()
    print(card, flush=True)
    inputs = _inputs()
    nvcc_s, ref = time_nvcc(inputs)
    print(f"[nvcc] {nvcc_s:.2f} s for {list(build.SOURCES)} | {card}",
          flush=True)
    res = {"card": card, "nvcc_s": nvcc_s, "load_s": None,
           "load_error": None}
    try:
        load_s, got = time_load(inputs)
    except Exception as e:          # reported, not hidden: the JSON says so
        res["load_error"] = f"{type(e).__name__}: {e}"[:2000]
        print(f"[load] failed: {res['load_error']}", flush=True)
    else:
        res["load_s"] = load_s
        same = all(torch.equal(a, b) for a, b in zip(got, ref))
        print(f"[load] {load_s:.2f} s for binding.cpp + "
              f"{list(build.SOURCES)}; rans_encode equal to the nvcc "
              f"build's: {same} | {card}", flush=True)
        if not same:
            raise RuntimeError("the two builds disagree")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
