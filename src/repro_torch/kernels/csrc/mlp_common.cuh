// Device functions shared by the port's Dense-stack kernels (fused_mlp.cu,
// grouped_mlp.cu): one f32 or quantized Dense layer over a tile of
// activations held in the block's shared memory.
//
// Layer kinds (repro.core.layers._quantized_matvec semantics):
//   REAL        f32 dot (FMA) + bias
//   INT8 (SINT) quantize -> int8 x int8 products accumulated in int32 ->
//               f32(acc) * scale, then + bias
//   INT16/INT32 (INT/DINT) the same integer grid, emulated in f32
//
// Numerics follow the plain version bit for bit on SINT:
//   * quantize with __fdiv_rn(h, x_scale) (IEEE division, never the
//     reciprocal), rintf (round half to even), clip to +-qmax;
//   * accumulate int8 products in int32;
//   * requantize as __fadd_rn(__fmul_rn((float)acc, scale), bias) so nvcc
//     cannot contract the pair into an FMA;
//   * REAL and emulated dots use f32 FMA (compared within tolerance); no TF32.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define ROWS_PER_THREAD 4

enum Mode { MODE_REAL = 0, MODE_INT8 = 1, MODE_INT16 = 2, MODE_INT32 = 3 };

// Activation ids: repro_torch/kernels/fused_mlp.py::ACT_IDS (the
// grouped kernel maps its own ids onto these).
enum Act {
  ACT_LINEAR = 0, ACT_RELU = 1, ACT_SIGMOID = 2, ACT_TANH = 3, ACT_ELU = 4,
  ACT_LEAKY_RELU = 5, ACT_SWISH = 6, ACT_BINARY_STEP = 7
};

__device__ __forceinline__ float activate(float y, int act) {
  switch (act) {
    case ACT_RELU: return fmaxf(y, 0.0f);
    case ACT_SIGMOID: return 1.0f / (1.0f + expf(-y));
    case ACT_TANH: return tanhf(y);
    case ACT_ELU: return y > 0.0f ? y : expm1f(y);
    case ACT_LEAKY_RELU: return y > 0.0f ? y : 0.01f * y;
    case ACT_SWISH: return y * (1.0f / (1.0f + expf(-y)));
    case ACT_BINARY_STEP: return y >= 0.0f ? 1.0f : 0.0f;
    default: return y;
  }
}

// The activation as the functor dense_tile applies.
struct ActFn {
  int act;
  __device__ __forceinline__ float operator()(float y) const {
    return activate(y, act);
  }
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(int16_t v) { return (float)v; }
__device__ __forceinline__ float to_float(int32_t v) { return __int2float_rn(v); }

// Two forms of the K loop.  With kBatchLoads, K_UNROLL weight loads are
// issued into registers before their first use, so their latencies overlap,
// and the rest of K runs one step at a time; without it the loop is a plain
// `#pragma unroll 8`.  Measured on the H100 (PERF.md, Findings): nvcc turned
// the plain loop into load-use pairs in grouped_mlp_kernel (each L2 latency
// exposed; ~199 us per four-head launch, ~62 us batched) but overlapped the
// loads itself in fused_mlp_kernel, which the batched form slows by 8-23%;
// each kernel takes the faster form.  nvcc's schedule is fragile here: an
// unroll pragma on the batched form's remainder loop cost the grouped
// kernel ~2.7x, so the two forms stay written out as measured.  Both sum in
// ascending k, so the numerics are the same.
#define K_UNROLL 8

// acc[j] += sum_k a[row j][k] * w[k][n], f32 FMA in ascending k, for one
// output column n.
template <bool kBatchLoads, typename T>
__device__ __forceinline__ void dot_f32(const T* __restrict__ w, int k_dim,
                                        int n_dim, int n, const float* cur,
                                        const int* row_off,
                                        float acc[ROWS_PER_THREAD]) {
  if constexpr (kBatchLoads) {
    int k = 0;
    for (; k + K_UNROLL <= k_dim; k += K_UNROLL) {
      float wv[K_UNROLL];
#pragma unroll
      for (int u = 0; u < K_UNROLL; ++u)
        wv[u] = to_float(w[(size_t)(k + u) * n_dim + n]);
#pragma unroll
      for (int u = 0; u < K_UNROLL; ++u)
#pragma unroll
        for (int j = 0; j < ROWS_PER_THREAD; ++j)
          acc[j] = fmaf(cur[row_off[j] + k + u], wv[u], acc[j]);
    }
    for (; k < k_dim; ++k) {
      const float wv = to_float(w[(size_t)k * n_dim + n]);
#pragma unroll
      for (int j = 0; j < ROWS_PER_THREAD; ++j)
        acc[j] = fmaf(cur[row_off[j] + k], wv, acc[j]);
    }
  } else {
#pragma unroll 8
    for (int k = 0; k < k_dim; ++k) {
      const float wv = to_float(w[(size_t)k * n_dim + n]);
#pragma unroll
      for (int j = 0; j < ROWS_PER_THREAD; ++j)
        acc[j] = fmaf(cur[row_off[j] + k], wv, acc[j]);
    }
  }
}

// The same over int8 weights and the int32 activation codes the quantize
// pass stored: int8 x int8 products accumulated in int32, which is exact.
template <bool kBatchLoads>
__device__ __forceinline__ void dot_int8(const int8_t* __restrict__ w,
                                         int k_dim, int n_dim, int n,
                                         const int* codes, const int* row_off,
                                         int acc[ROWS_PER_THREAD]) {
  if constexpr (kBatchLoads) {
    int k = 0;
    for (; k + K_UNROLL <= k_dim; k += K_UNROLL) {
      int wv[K_UNROLL];
#pragma unroll
      for (int u = 0; u < K_UNROLL; ++u)
        wv[u] = w[(size_t)(k + u) * n_dim + n];
#pragma unroll
      for (int u = 0; u < K_UNROLL; ++u)
#pragma unroll
        for (int j = 0; j < ROWS_PER_THREAD; ++j)
          acc[j] += codes[row_off[j] + k + u] * wv[u];
    }
    for (; k < k_dim; ++k) {
      const int wv = w[(size_t)k * n_dim + n];
#pragma unroll
      for (int j = 0; j < ROWS_PER_THREAD; ++j)
        acc[j] += codes[row_off[j] + k] * wv;
    }
  } else {
#pragma unroll 8
    for (int k = 0; k < k_dim; ++k) {
      const int wv = w[(size_t)k * n_dim + n];
#pragma unroll
      for (int j = 0; j < ROWS_PER_THREAD; ++j)
        acc[j] += codes[row_off[j] + k] * wv;
    }
  }
}

// One Dense layer over the block's tile: `cur` (block_m rows of `k_dim`
// lanes, row stride `ld`) -> `nxt` (block_m rows of `n_dim` lanes) =
// act(x @ w + bias), or its quantized form.  A quantized layer first
// requantizes `cur` in place (SINT codes stored once as int32 in the same
// words, so the dot reads integers; INT/DINT codes stay f32, as int32's
// rail is not f32-representable), so `cur` is consumed.  Every thread of the
// block calls it with block-uniform arguments; it ends without a barrier.
// kBatchLoads selects the K loop's form (see dot_f32).
template <bool kBatchLoads, typename ActOp>
__device__ __forceinline__ void dense_tile(
    float* cur, float* nxt, int block_m, int ld, const void* w,
    const float* __restrict__ scale, const float* __restrict__ bias,
    float x_scale, int k_dim, int n_dim, int mode, float qmax, ActOp act) {
  if (mode != MODE_REAL) {
    for (int i = threadIdx.x; i < block_m * k_dim; i += blockDim.x) {
      const int r = i / k_dim, c = i - r * k_dim;
      const float t = fminf(
          fmaxf(rintf(__fdiv_rn(cur[r * ld + c], x_scale)), -qmax), qmax);
      if (mode == MODE_INT8)
        reinterpret_cast<int*>(cur)[r * ld + c] = __float2int_rn(t);
      else
        cur[r * ld + c] = t;
    }
    __syncthreads();
  }
  // Work item = (output column n, group of ROWS_PER_THREAD rows): a warp
  // reads consecutive columns of one weight row (coalesced) and the same
  // activation (a shared-memory broadcast); each weight is loaded once for
  // ROWS_PER_THREAD rows.
  const int groups = (block_m + ROWS_PER_THREAD - 1) / ROWS_PER_THREAD;
  for (int item = threadIdx.x; item < groups * n_dim; item += blockDim.x) {
    const int n = item % n_dim;
    const int r0 = (item / n_dim) * ROWS_PER_THREAD;
    // Rows past the tile's end (block_m not a multiple of ROWS_PER_THREAD)
    // read the last row and are never stored.
    int row_off[ROWS_PER_THREAD];
#pragma unroll
    for (int j = 0; j < ROWS_PER_THREAD; ++j)
      row_off[j] = min(r0 + j, block_m - 1) * ld;
    float y[ROWS_PER_THREAD];
    if (mode == MODE_INT8) {
      int acc[ROWS_PER_THREAD] = {};
      dot_int8<kBatchLoads>((const int8_t*)w, k_dim, n_dim, n,
               reinterpret_cast<const int*>(cur), row_off, acc);
#pragma unroll
      for (int j = 0; j < ROWS_PER_THREAD; ++j)
        // Requantize as two separately rounded ops: never an FMA.
        y[j] = __fadd_rn(__fmul_rn(__int2float_rn(acc[j]), scale[n]),
                         bias[n]);
    } else {
      // f32 FMA dot: REAL and emulated INT/DINT are compared within
      // tolerance (summation order differs from any library's).
      float acc[ROWS_PER_THREAD] = {};
      if (mode == MODE_REAL)
        dot_f32<kBatchLoads>((const float*)w, k_dim, n_dim, n, cur, row_off,
                             acc);
      else if (mode == MODE_INT16)
        dot_f32<kBatchLoads>((const int16_t*)w, k_dim, n_dim, n, cur,
                             row_off, acc);
      else
        dot_f32<kBatchLoads>((const int32_t*)w, k_dim, n_dim, n, cur,
                             row_off, acc);
#pragma unroll
      for (int j = 0; j < ROWS_PER_THREAD; ++j)
        y[j] = mode == MODE_REAL
                   ? __fadd_rn(acc[j], bias[n])
                   : __fadd_rn(__fmul_rn(acc[j], scale[n]), bias[n]);
    }
#pragma unroll
    for (int j = 0; j < ROWS_PER_THREAD; ++j)
      if (r0 + j < block_m) nxt[(r0 + j) * ld + n] = act(y[j]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
