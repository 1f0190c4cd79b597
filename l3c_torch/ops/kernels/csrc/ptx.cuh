// The PTX instructions float_cdf.cu and dmll.cu use directly, one device
// function each: asynchronous copies from global into shared memory
// (cp.async) and the special-function unit's approximate 2^x and 1/x.
// They are kept apart from the kernels so that a build for the host (the
// CPU tests of both files) can put plain copies and libm calls in their
// place: every function below has the same meaning there, the copies
// being complete on return.
#pragma once
#include <cstdint>

namespace ptx {

// 16 bytes global -> shared, both 16-byte aligned; .cg: through L2 only,
// the data is read once
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// 4 bytes global -> shared: ragged ends and misaligned runs
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// wait until every copy this thread has started has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 2^x, at most 2 ulp off, denormals flushed (MUFU.EX2)
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 1/x, at most 1 ulp off, denormals flushed (MUFU.RCP)
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace ptx
