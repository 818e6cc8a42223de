// Device functions shared by the port's Dense-stack kernels (fused_mlp.cu,
// grouped_mlp.cu), which replace the Pallas TPU kernels
// src/repro/kernels/fused_mlp.py::fused_mlp and ::grouped_fused_mlp.  A
// block owns a tile of rows of the batch and runs every layer over them.
// Two paths, picked at plan time (kernels/fused_mlp.py::path):
//
//   * int8_mma — every layer SINT.  The input tile is quantized while it is
//     staged (16-byte loads) and lives in shared memory as int8 codes; each
//     layer is int8 x int8 -> int32 on the tensor cores (mma.sync
//     m16n8k32), its B fragments read from a K-major, zero-padded int8
//     copy of the weight made at plan time; the epilogue requantizes the
//     accumulators in registers straight into the next layer's codes, and
//     only the last layer writes f32.  The fused kernel's BLOCK_M = 8 rows
//     fill the upper half of the m16 tile (the lower half is zero
//     registers), the grouped kernel's 16 rows all of it.  wgmma is not
//     the tool at these heights: the products' op bound (~0.03 us for the
//     §7 classifier at M = 1024) is far under the byte bound (~0.5 us), so
//     8-row tiles that put a block on every SM matter more than 64-row
//     warpgroup products.
//   * f32_tile — any layer REAL, INT16 or INT32 (emulated on the integer
//     grid in f32).  Two f32 activation tiles in shared memory and
//     CUDA-core dots (f32 FMA, no TF32; int8 layers of a mixed stack dot
//     their codes in int32), one thread per output column and
//     ROWS_PER_THREAD rows.
//
// Layer kinds (repro.core.layers._quantized_matvec semantics):
//   REAL        f32 dot (FMA) + bias
//   INT8 (SINT) quantize -> int8 x int8 products accumulated in int32 ->
//               f32(acc) * scale, then + bias
//   INT16/INT32 (INT/DINT) the same integer grid, emulated in f32
//
// Numerics follow the plain version bit for bit on SINT, on both paths:
//   * quantize as rintf (round half to even) of the IEEE quotient
//     h / x_scale (__fdiv_rn; `quantize` below finds the same code from the
//     reciprocal's product wherever that is provably equal), clip to +-qmax;
//   * accumulate int8 products in int32 (exact in any order, so the tensor
//     cores' order changes no bit);
//   * requantize as __fadd_rn(__fmul_rn((float)acc, scale), bias) so nvcc
//     cannot contract the pair into an FMA;
//   * REAL and emulated dots use f32 FMA (compared within tolerance); no TF32.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define WARPS (THREADS / 32)
// Rows per block (fused_mlp.py::BLOCK_M); the grouped int8_mma kernel
// takes 16 (grouped_mlp.cu::GROUPED_ROWS).
#define BLOCK_M 8
#define ROWS_PER_THREAD 2  // f32_tile: rows per work item

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

// The same for the int8 epilogues, which inline it at every column: relu
// and linear inline, the rest through one out-of-line copy of the switch,
// so that the kernel's code stays small (the full switch inlined at each
// site made the int8 kernels' code much larger and slower on the H100).
__device__ __noinline__ float activate_call(float y, int act) {
  return activate(y, act);
}

__device__ __forceinline__ float activate_epi(float y, int act) {
  if (act == ACT_RELU) return fmaxf(y, 0.0f);
  if (act == ACT_LINEAR) return y;
  return activate_call(y, act);
}

// The activation as the functor dense_tile applies.
struct ActFn {
  int act;
  __device__ __forceinline__ float operator()(float y) const {
    return activate(y, act);
  }
};

// A layer's input quantize: its activation scale, that scale's correctly
// rounded reciprocal and its clip rail.
struct Quant {
  float scale, inv, qmax;
};

// The reciprocal is kept only where the error bound below holds (a normal
// 1 / scale); anywhere else it is NaN, which sends every quantize to the
// division.
__device__ __forceinline__ Quant make_quant(float scale, float qmax) {
  const float inv = __frcp_rn(scale);
  const bool normal = inv >= 0x1p-125f && inv <= 0x1p125f;
  return {scale, normal ? inv : __int_as_float(0x7fffffff), qmax};
}

// The quantize of the plain version, clip(rint(h / scale), +-qmax), with
// h / scale the IEEE quotient, bit for bit, mostly without the division:
// a = RN(h * RN(1 / scale)) lies within 2.5 ulp of RN(h / scale), and rint
// turns over only at half-integers, so when `a` is farther than 8 ulp
// (|a| * 2^-20) from every half-integer, rint(a) is the exact code; the
// rare `a` within that margin (and every non-finite one) takes __fdiv_rn.
// A zero needs neither (rint(±0 / scale) = ±0).  The division at every
// quantize was a large part of the int8 kernels' time on the H100, and its
// fast-path check sends zero dividends (ReLU outputs, pad lanes) to its
// slow path.
__device__ __forceinline__ float quantize(float h, const Quant& q) {
  if (h == 0.0f) return h;
  const float a = __fmul_rn(h, q.inv);
  const float edge = __fsub_rn(0.5f, fabsf(__fsub_rn(a, rintf(a))));
  const float t = edge > fabsf(a) * 0x1p-20f ? a : __fdiv_rn(h, q.scale);
  return fminf(fmaxf(rintf(t), -q.qmax), q.qmax);
}

// The requantize of an int8 layer's accumulator: two separately rounded
// ops, never an FMA.
__device__ __forceinline__ float requantize(int acc, float scale,
                                            float bias) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
}

// ---------------------------------------------------------------------------
// Staging: rows [0, rows) of a block's input (row stride x_ld floats, true
// lanes [0, k)), read once with streaming 16-byte loads where the rows are
// 16-byte aligned; each thread issues STAGE_BATCH loads before it uses the
// first, so their device-memory latencies overlap.  Rows past the ragged M
// edge and lanes past k are zeros.  `emit(r, c, v)` takes lanes c..c+3 of
// row r.
// ---------------------------------------------------------------------------

#define STAGE_BATCH 4

template <int ROWS, typename Emit>
__device__ __forceinline__ void stage_rows(const float* __restrict__ x,
                                           int rows, int x_ld, int k,
                                           int lanes, Emit emit) {
  const bool vec = (x_ld & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int quads = lanes >> 2, items = ROWS * quads;
  for (int i0 = threadIdx.x; i0 < items; i0 += STAGE_BATCH * blockDim.x) {
    float v[STAGE_BATCH][4];
#pragma unroll
    for (int u = 0; u < STAGE_BATCH; ++u) {
      const int i = i0 + u * blockDim.x;
      const int r = i / quads, c = (i - r * quads) * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) v[u][j] = 0.0f;
      if (i < items && r < rows && c < k) {
        const float* src = x + (size_t)r * x_ld + c;
        if (vec) {
          // c < k <= x_ld and x_ld % 4 == 0: the four lanes lie in the row.
          const float4 f = __ldcs(reinterpret_cast<const float4*>(src));
          v[u][0] = f.x;
          v[u][1] = c + 1 < k ? f.y : 0.0f;
          v[u][2] = c + 2 < k ? f.z : 0.0f;
          v[u][3] = c + 3 < k ? f.w : 0.0f;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            v[u][j] = c + j < k ? __ldcs(src + j) : 0.0f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < STAGE_BATCH; ++u) {
      const int i = i0 + u * blockDim.x;
      const int r = i / quads, c = (i - r * quads) * 4;
      if (i < items) emit(r, c, v[u]);
    }
  }
}

// Stage into an f32 tile of BLOCK_M rows (row stride ld floats), lanes
// [0, k).
__device__ __forceinline__ void stage_f32(const float* __restrict__ x,
                                          int rows, int x_ld, int k,
                                          float* tile, int ld) {
  stage_rows<BLOCK_M>(x, rows, x_ld, k, (k + 3) & ~3,
                      [&](int r, int c, const float (&v)[4]) {
#pragma unroll
                        for (int j = 0; j < 4; ++j)
                          if (c + j < k) tile[r * ld + c + j] = v[j];
                      });
}

// Stage into int8 codes of ROWS rows (row stride cld bytes, a multiple of
// 16), quantized on the way in, lanes [0, round32(k)): one 32-bit word of
// four codes per thread and quad.
template <int ROWS>
__device__ __forceinline__ void stage_codes(const float* __restrict__ x,
                                            int rows, int x_ld, int k,
                                            const Quant& q, int8_t* codes,
                                            int cld) {
  stage_rows<ROWS>(x, rows, x_ld, k, (k + 31) & ~31,
                   [&](int r, int c, const float (&v)[4]) {
                     uint32_t word = 0;
#pragma unroll
                     for (int j = 0; j < 4; ++j)
                       word |= (uint32_t)(__float2int_rn(
                                   quantize(v[j], q)) & 0xff)
                               << (8 * j);
                     *reinterpret_cast<uint32_t*>(codes + r * cld + c) =
                         word;
                   });
}

// ---------------------------------------------------------------------------
// int8_mma path: the stack as a table of steps, and one layer on the tensor
// cores.
// ---------------------------------------------------------------------------

// One int8 layer as the int8_mma kernels run it, gathered into shared
// memory at block start: the layer loop then waits on no descriptor, meta
// or constant-cache load (a descriptor indexed by the runtime layer number
// cost a dependent constant-cache miss per layer).
struct Step {
  const int8_t* wt;       // K-major weights in global memory, row stride wt_ld
  const float* scale;     // (n,) combined x_scale * w_scale
  const float* bias;      // (n,)
  Quant quant;            // the quantize of this layer's input
  int wt_ld, k, n;
  int act;                // the kernel's own activation id
  int skip;               // grouped: a position past the group's last layer
};

// d += A (16 x 32 int8, row) * B (32 x 8 int8, col), int32.  A's rows 8-15
// (a1, a3) are zeros when the block has BLOCK_M = 8 rows.
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg32(const int8_t* p) {
  return __ldg(reinterpret_cast<const uint32_t*>(p));
}

// A tile's epilogue constants for a thread's two columns, loaded with its
// B fragments so that both arrive together.
struct EpiCols {
  float scale[2], bias[2];
};

// Warp `w` owns output tiles (8 columns each) w, w + WARPS, ...; it takes
// TILES of them at a time and loads the B fragments of STEPS k-steps (32
// deep) of each, and their epilogue constants, before their products, so
// their latencies overlap; one A fragment serves all TILES.  The block's
// ROWS (8 or 16) rows are the m16 tile's upper half or all of it.
template <int ROWS, int TILES, int STEPS, typename Epi>
__device__ __forceinline__ void mma_tiles(const int8_t* codes, int cld,
                                          const Step& v, int ks, int nt,
                                          const Epi& epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tg = lane & 3;
  const int8_t* a = codes + gr * cld + tg * 4;
  for (int t0 = warp; t0 < nt; t0 += TILES * WARPS) {
    int acc[TILES][4];
    EpiCols ep[TILES];
#pragma unroll
    for (int i = 0; i < TILES; ++i) {
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0;
      if (t0 + i * WARPS < nt)
        ep[i] = epi.load(v, (t0 + i * WARPS) * 8 + tg * 2);
    }
    for (int s0 = 0; s0 < ks; s0 += STEPS) {
      uint32_t bf[TILES][STEPS][2];
#pragma unroll
      for (int i = 0; i < TILES; ++i) {
        const int8_t* b =
            v.wt + (size_t)((t0 + i * WARPS) * 8 + gr) * v.wt_ld + tg * 4;
#pragma unroll
        for (int j = 0; j < STEPS; ++j)
          if (t0 + i * WARPS < nt && s0 + j < ks) {
            bf[i][j][0] = ldg32(b + (s0 + j) * 32);
            bf[i][j][1] = ldg32(b + (s0 + j) * 32 + 16);
          }
      }
#pragma unroll
      for (int j = 0; j < STEPS; ++j)
        if (s0 + j < ks) {
          const int8_t* aj = a + (s0 + j) * 32;
          const uint32_t a0 = ld32(aj), a2 = ld32(aj + 16);
          const uint32_t a1 = ROWS == 16 ? ld32(aj + 8 * cld) : 0u;
          const uint32_t a3 = ROWS == 16 ? ld32(aj + 8 * cld + 16) : 0u;
#pragma unroll
          for (int i = 0; i < TILES; ++i)
            if (t0 + i * WARPS < nt)
              mma_s8(acc[i], a0, a1, a2, a3, bf[i][j][0], bf[i][j][1]);
        }
    }
#pragma unroll
    for (int i = 0; i < TILES; ++i)
      if (t0 + i * WARPS < nt) {
        const int c = (t0 + i * WARPS) * 8 + tg * 2;
        epi(gr, c, acc[i][0], acc[i][1], ep[i]);
        if (ROWS == 16) epi(gr + 8, c, acc[i][2], acc[i][3], ep[i]);
      }
  }
}

// One int8 layer `step` over the block's code tile: `codes` (ROWS rows,
// stride cld; lanes past k are never read against a nonzero weight) times
// the layer's K-major weights ((round8(n), wt_ld) int8, zero-padded to
// round32(k) deep and round8(n) wide).  `epi.load(v, c)` fetches the
// constants of columns c and c + 1, and `epi(r, c, acc_c, acc_c+1, cols)`
// gets row r's int32 sums for them (c even, < round8(n)).  A deep layer
// keeps 16 k-steps of B fragments in flight, a shallow one (K <= 64) two of
// four tiles (eight spill), so each layer waits about one L2 round trip per
// pass.  Ends without a barrier.
template <int ROWS, typename Epi>
__device__ __forceinline__ void mma_layer(const int8_t* codes, int cld,
                                          const Step& step, const Epi& epi) {
  // A register copy: read through a reference into shared memory, the
  // step's fields would be loaded again after every epilogue store.
  const Step v = step;
  const int ks = (v.k + 31) >> 5, nt = (v.n + 7) >> 3;
  if (ks > 2)
    mma_tiles<ROWS, 1, 16>(codes, cld, v, ks, nt, epi);
  else
    mma_tiles<ROWS, 4, 2>(codes, cld, v, ks, nt, epi);
}

// The requantize constants of columns c and c + 1 (zero past n).
__device__ __forceinline__ EpiCols load_cols(const Step& v, int n, int c) {
  EpiCols p;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    p.scale[j] = c + j < n ? __ldg(v.scale + c + j) : 0.0f;
    p.bias[j] = c + j < n ? __ldg(v.bias + c + j) : 0.0f;
  }
  return p;
}

// Epilogue into the next int8 layer's codes: requantize, activate, then the
// next layer's quantize, in registers; two codes per 16-bit store.  Pad
// columns (>= n) get code 0.
struct CodesEpi {
  int act, n;
  Quant quant;          // the next layer's
  int8_t* codes;        // the next layer's tile, stride cld
  int cld;
  __device__ __forceinline__ EpiCols load(const Step& v, int c) const {
    return load_cols(v, n, c);
  }
  __device__ __forceinline__ void operator()(int r, int c, int a0, int a1,
                                             const EpiCols& p) const {
    uint32_t pair = 0;
    const int acc[2] = {a0, a1};
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (c + j < n) {
        const float h =
            activate_epi(requantize(acc[j], p.scale[j], p.bias[j]), act);
        pair |= (uint32_t)(__float2int_rn(quantize(h, quant)) & 0xff)
                << (8 * j);
      }
    *reinterpret_cast<uint16_t*>(codes + r * cld + c) = (uint16_t)pair;
  }
};

// Epilogue of a stack's last layer: requantize and activate into f32, real
// rows (< rows) and columns (< n) only; `out` has row stride ld.
struct F32Epi {
  int act, n;
  float* out;
  int ld, rows;
  __device__ __forceinline__ EpiCols load(const Step& v, int c) const {
    return load_cols(v, n, c);
  }
  __device__ __forceinline__ void operator()(int r, int c, int a0, int a1,
                                             const EpiCols& p) const {
    if (r >= rows) return;
    const int acc[2] = {a0, a1};
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (c + j < n)
        out[(size_t)r * ld + c + j] =
            activate_epi(requantize(acc[j], p.scale[j], p.bias[j]), act);
  }
};

// ---------------------------------------------------------------------------
// f32_tile path: CUDA-core dots over an f32 tile.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(int16_t v) { return (float)v; }
__device__ __forceinline__ float to_float(int32_t v) { return __int2float_rn(v); }

// Two forms of the K loop.  With kBatchLoads, K_UNROLL weight loads are
// issued into registers before their first use, so their latencies overlap,
// and the rest of K runs one step at a time; without it the loop is a plain
// `#pragma unroll 8`.  Measured on the H100 (PERF.md, Findings):
// nvcc turned the plain loop into load-use pairs in grouped_mlp_kernel (each
// L2 latency exposed; ~199 us per four-head launch, ~62 us batched) but
// overlapped the loads itself in fused_mlp_kernel, which the batched form
// slowed by 8-23%; each kernel takes the faster form.  nvcc's schedule is
// fragile here: an unroll pragma on the batched form's remainder loop cost
// the grouped kernel ~2.7x, so the two forms stay written out as measured.
// Both sum in ascending k, so the numerics are the same.
#define K_UNROLL 8

// acc[j] += sum_k a[row j][k] * w[k][n], f32 FMA in ascending k, for one
// output column n; w has row stride w_ld.
template <bool kBatchLoads, typename T>
__device__ __forceinline__ void dot_f32(const T* __restrict__ w, int k_dim,
                                        int w_ld, int n, const float* cur,
                                        const int* row_off,
                                        float acc[ROWS_PER_THREAD]) {
  if constexpr (kBatchLoads) {
    int k = 0;
    for (; k + K_UNROLL <= k_dim; k += K_UNROLL) {
      float wv[K_UNROLL];
#pragma unroll
      for (int u = 0; u < K_UNROLL; ++u)
        wv[u] = to_float(w[(size_t)(k + u) * w_ld + n]);
#pragma unroll
      for (int u = 0; u < K_UNROLL; ++u)
#pragma unroll
        for (int j = 0; j < ROWS_PER_THREAD; ++j)
          acc[j] = fmaf(cur[row_off[j] + k + u], wv[u], acc[j]);
    }
    for (; k < k_dim; ++k) {
      const float wv = to_float(w[(size_t)k * w_ld + n]);
#pragma unroll
      for (int j = 0; j < ROWS_PER_THREAD; ++j)
        acc[j] = fmaf(cur[row_off[j] + k], wv, acc[j]);
    }
  } else {
#pragma unroll 8
    for (int k = 0; k < k_dim; ++k) {
      const float wv = to_float(w[(size_t)k * w_ld + n]);
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
                                         int k_dim, int w_ld, int n,
                                         const int* codes, const int* row_off,
                                         int acc[ROWS_PER_THREAD]) {
  if constexpr (kBatchLoads) {
    int k = 0;
    for (; k + K_UNROLL <= k_dim; k += K_UNROLL) {
      int wv[K_UNROLL];
#pragma unroll
      for (int u = 0; u < K_UNROLL; ++u)
        wv[u] = w[(size_t)(k + u) * w_ld + n];
#pragma unroll
      for (int u = 0; u < K_UNROLL; ++u)
#pragma unroll
        for (int j = 0; j < ROWS_PER_THREAD; ++j)
          acc[j] += codes[row_off[j] + k + u] * wv[u];
    }
    for (; k < k_dim; ++k) {
      const int wv = w[(size_t)k * w_ld + n];
#pragma unroll
      for (int j = 0; j < ROWS_PER_THREAD; ++j)
        acc[j] += codes[row_off[j] + k] * wv;
    }
  } else {
#pragma unroll 8
    for (int k = 0; k < k_dim; ++k) {
      const int wv = w[(size_t)k * w_ld + n];
#pragma unroll
      for (int j = 0; j < ROWS_PER_THREAD; ++j)
        acc[j] += codes[row_off[j] + k] * wv;
    }
  }
}

// One Dense layer over the block's f32 tile: `cur` (BLOCK_M rows of
// `k_dim` lanes, row stride `ld`) -> `nxt` (BLOCK_M rows of `n_dim` lanes)
// = act(x @ w + bias), or its quantized form; `w` is (k_dim, n_dim) with
// row stride w_ld.  A quantized layer first requantizes `cur` in place
// (SINT codes stored once as int32 in the same words, so the dot reads
// integers; INT/DINT codes stay f32, as int32's rail is not
// f32-representable), so `cur` is consumed.  Every thread of the block
// calls it with block-uniform arguments; it ends without a barrier.
// kBatchLoads selects the K loop's form (see dot_f32).
template <bool kBatchLoads, typename ActOp>
__device__ __forceinline__ void dense_tile(
    float* cur, float* nxt, int ld, const void* w, int w_ld,
    const float* __restrict__ scale, const float* __restrict__ bias,
    float x_scale, int k_dim, int n_dim, int mode, float qmax, ActOp act) {
  if (mode != MODE_REAL) {
    const Quant q = make_quant(x_scale, qmax);
    for (int i = threadIdx.x; i < BLOCK_M * k_dim; i += blockDim.x) {
      const int r = i / k_dim, c = i - r * k_dim;
      const float t = quantize(cur[r * ld + c], q);
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
  constexpr int groups = BLOCK_M / ROWS_PER_THREAD;
  for (int item = threadIdx.x; item < groups * n_dim; item += blockDim.x) {
    const int n = item % n_dim;
    const int r0 = (item / n_dim) * ROWS_PER_THREAD;
    int row_off[ROWS_PER_THREAD];
#pragma unroll
    for (int j = 0; j < ROWS_PER_THREAD; ++j) row_off[j] = (r0 + j) * ld;
    float y[ROWS_PER_THREAD];
    if (mode == MODE_INT8) {
      int acc[ROWS_PER_THREAD] = {};
      dot_int8<kBatchLoads>((const int8_t*)w, k_dim, w_ld, n,
                            reinterpret_cast<const int*>(cur), row_off, acc);
#pragma unroll
      for (int j = 0; j < ROWS_PER_THREAD; ++j)
        y[j] = requantize(acc[j], scale[n], bias[n]);
    } else {
      // f32 FMA dot: REAL and emulated INT/DINT are compared within
      // tolerance (summation order differs from any library's).
      float acc[ROWS_PER_THREAD] = {};
      if (mode == MODE_REAL)
        dot_f32<kBatchLoads>((const float*)w, k_dim, w_ld, n, cur, row_off,
                             acc);
      else if (mode == MODE_INT16)
        dot_f32<kBatchLoads>((const int16_t*)w, k_dim, w_ld, n, cur,
                             row_off, acc);
      else
        dot_f32<kBatchLoads>((const int32_t*)w, k_dim, w_ld, n, cur,
                             row_off, acc);
#pragma unroll
      for (int j = 0; j < ROWS_PER_THREAD; ++j)
        y[j] = mode == MODE_REAL
                   ? __fadd_rn(acc[j], bias[n])
                   : __fadd_rn(__fmul_rn(acc[j], scale[n]), bias[n]);
    }
#pragma unroll
    for (int j = 0; j < ROWS_PER_THREAD; ++j)
      nxt[(r0 + j) * ld + n] = act(y[j]);
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

// Dynamic shared memory above 48 KB needs an opt-in per kernel; the largest
// size opted in so far is remembered by the caller's `opted_in`.
template <typename Kernel>
inline cudaError_t opt_in_smem(Kernel kernel, int smem, int& opted_in) {
  if (smem <= opted_in) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) opted_in = smem;
  return err;
}
