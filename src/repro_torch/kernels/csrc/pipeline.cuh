// Device helpers shared by the port's GEMM-style kernels (qmatmul.cu,
// sparse_matmul.cu): the 16-byte cp.async that feeds their shared-memory
// rings, and the recursive-halving warp reduction their small-M paths use.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Copy 16 bytes from global `src` to shared `dst` asynchronously, or write
// 16 zero bytes when `valid` is false (src is then not read).  Both 16-byte
// aligned; completion through cp.async.commit_group / wait_group.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

// One step of a recursive-halving reduction across the lanes that differ
// in `mask`: of v[0, 2 HALF) a lane keeps the half its bit selects, adds
// its partner's copy of that half, and leaves the sums in v[0, HALF).
// Steps with masks 16, 8, ..., 1 and HALF = N / 2, N / 4, ... leave lane l
// holding the warp's sum of element l in v[0]; the order of the additions
// is fixed, so the result's bits are too.
template <int HALF, typename T, int N>
__device__ __forceinline__ void halve(T (&v)[N], int lane, int mask) {
  const bool upper = lane & mask;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const T send = upper ? v[i] : v[i + HALF];
    const T keep = upper ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}
