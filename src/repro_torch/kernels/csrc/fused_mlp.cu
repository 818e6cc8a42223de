// Hopper kernel: a whole Dense stack (the §7 detector) in ONE launch.
//
// Replaces src/repro/kernels/fused_mlp.py::fused_mlp, the Pallas TPU kernel
// behind repro.kernels.ops.fused_forward.  It computes what that kernel
// computes, not its blocks: the TPU version walks a sequential K grid and
// carries layer 0's sum in VMEM scratch; here one thread block owns a tile of
// `block_m` rows and runs every layer of the stack in a loop, keeping the
// activation tile of the current and the next layer in dynamic shared memory
// (2 x block_m x widest-layer f32).  Weights stay in global memory, where the
// whole stack (28 KB SINT / 113 KB REAL for the classifier) sits in L2 after
// the first blocks touch it.
//
// Layer kinds (repro.core.layers._quantized_matvec semantics):
//   REAL        f32 dot (FMA) + bias
//   INT8 (SINT) quantize -> int8 x int8 products accumulated in int32 ->
//               f32(acc) * scale, then + bias
//   INT16/INT32 (INT/DINT) the same integer grid, emulated in f32
//
// What bounds it on the card: bytes.  At M = 1024 the SINT classifier moves
// ~1.68 MB (input 1.64 MB, weights 28 KB, output 8 KB), ~0.5 us at
// 3.35 TB/s, and the autoencoder ~3.3 MB (~1.0 us); its ~58 M int8 operations
// are ~0.03 us at the int8 peak.  Both bounds sit far under the launch
// overhead, so this first version keeps the design simple: one launch, no
// inter-layer traffic to device memory, coalesced weight reads shared by
// ROWS_PER_THREAD rows per thread.  Tensor-core (wgmma/TMA) versions are
// later work.
//
// Numerics follow the reference bit for bit on SINT:
//   * quantize with __fdiv_rn(h, x_scale) (IEEE division, never the
//     reciprocal), rintf (round half to even), clip to +-qmax;
//   * accumulate int8 products in int32;
//   * requantize as __fadd_rn(__fmul_rn((float)acc, scale), bias) so nvcc
//     cannot contract the pair into an FMA;
//   * REAL and emulated dots use f32 FMA (compared within tolerance); no TF32.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LAYERS 8
#define THREADS 256
#define ROWS_PER_THREAD 4

enum Mode { MODE_REAL = 0, MODE_INT8 = 1, MODE_INT16 = 2, MODE_INT32 = 3 };

// Activation ids: repro_torch/kernels/fused_mlp.py::ACT_IDS.
enum Act {
  ACT_LINEAR = 0, ACT_RELU = 1, ACT_SIGMOID = 2, ACT_TANH = 3, ACT_ELU = 4,
  ACT_LEAKY_RELU = 5, ACT_SWISH = 6, ACT_BINARY_STEP = 7
};

// One layer.  Mirrored field for field by fused_mlp.py::_LayerDesc.
struct LayerDesc {
  const void* w;        // (k, n) row-major: f32, int8, int16 or int32
  const float* scale;   // (n,) combined x_scale * w_scale (quantized only)
  const float* bias;    // (n,)
  float x_scale;        // activation scale (quantized only)
  int k;
  int n;
  int mode;
  int act;
  float qmax;           // symmetric clip rail, as f32 (quantized only)
};

// The stack, passed to the kernel by value.  Mirrored by _MlpDesc.
struct MlpDesc {
  int n_layers;
  LayerDesc layers[MAX_LAYERS];
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

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(int16_t v) { return (float)v; }
__device__ __forceinline__ float to_float(int32_t v) { return __int2float_rn(v); }

// acc[j] += sum_k a[row j][k] * w[k][n], f32 FMA, for one output column n.
// The unrolled loop keeps several weight loads in flight at once.
template <typename T>
__device__ __forceinline__ void dot_f32(const T* __restrict__ w, int k_dim,
                                        int n_dim, int n, const float* cur,
                                        const int* row_off,
                                        float acc[ROWS_PER_THREAD]) {
#pragma unroll 8
  for (int k = 0; k < k_dim; ++k) {
    const float wv = to_float(w[(size_t)k * n_dim + n]);
#pragma unroll
    for (int j = 0; j < ROWS_PER_THREAD; ++j)
      acc[j] = fmaf(cur[row_off[j] + k], wv, acc[j]);
  }
}

// The same over int8 weights and the int32 activation codes the quantize
// pass stored: int8 x int8 products accumulated in int32, which is exact.
__device__ __forceinline__ void dot_int8(const int8_t* __restrict__ w,
                                         int k_dim, int n_dim, int n,
                                         const int* codes, const int* row_off,
                                         int acc[ROWS_PER_THREAD]) {
#pragma unroll 8
  for (int k = 0; k < k_dim; ++k) {
    const int wv = w[(size_t)k * n_dim + n];
#pragma unroll
    for (int j = 0; j < ROWS_PER_THREAD; ++j)
      acc[j] += codes[row_off[j] + k] * wv;
  }
}

// grid.x = ceil(m / block_m); dynamic shared memory = 2 * block_m * ld * 4 B.
__global__ void __launch_bounds__(THREADS)
fused_mlp_kernel(const float* __restrict__ x, float* __restrict__ out, int m,
                 int block_m, int ld, const MlpDesc desc) {
  extern __shared__ float smem[];
  float* cur = smem;                  // block_m x ld: this layer's input
  float* nxt = smem + block_m * ld;   // block_m x ld: its output
  const int row0 = blockIdx.x * block_m;
  const int rows = min(block_m, m - row0);

  // Stage the input tile.  Rows past the ragged M edge are zeros: they run
  // through the stack like real rows (finite values) and are never stored.
  const int k0 = desc.layers[0].k;
  for (int i = threadIdx.x; i < block_m * k0; i += blockDim.x) {
    const int r = i / k0, c = i - r * k0;
    cur[r * ld + c] = r < rows ? x[(size_t)(row0 + r) * k0 + c] : 0.0f;
  }
  __syncthreads();

  const int groups = (block_m + ROWS_PER_THREAD - 1) / ROWS_PER_THREAD;
  for (int l = 0; l < desc.n_layers; ++l) {
    const LayerDesc L = desc.layers[l];
    if (L.mode != MODE_REAL) {
      // In-kernel (re)quantization of the activation tile, in place:
      // IEEE division by x_scale, half-even rounding, symmetric clip.  SINT
      // codes are stored once as int32 (in the same shared words) so the
      // dot reads integers; INT/DINT codes stay f32 (int32's rail is not
      // f32-representable).
      for (int i = threadIdx.x; i < block_m * L.k; i += blockDim.x) {
        const int r = i / L.k, c = i - r * L.k;
        const float t = fminf(
            fmaxf(rintf(__fdiv_rn(cur[r * ld + c], L.x_scale)), -L.qmax),
            L.qmax);
        if (L.mode == MODE_INT8)
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
    for (int item = threadIdx.x; item < groups * L.n; item += blockDim.x) {
      const int n = item % L.n;
      const int r0 = (item / L.n) * ROWS_PER_THREAD;
      // Rows past the tile's end (block_m not a multiple of
      // ROWS_PER_THREAD) read the last row and are never stored.
      int row_off[ROWS_PER_THREAD];
#pragma unroll
      for (int j = 0; j < ROWS_PER_THREAD; ++j)
        row_off[j] = min(r0 + j, block_m - 1) * ld;
      float y[ROWS_PER_THREAD];
      if (L.mode == MODE_INT8) {
        int acc[ROWS_PER_THREAD] = {};
        dot_int8((const int8_t*)L.w, L.k, L.n, n,
                 reinterpret_cast<const int*>(cur), row_off, acc);
#pragma unroll
        for (int j = 0; j < ROWS_PER_THREAD; ++j)
          // Requantize as two separately rounded ops: never an FMA.
          y[j] = __fadd_rn(__fmul_rn(__int2float_rn(acc[j]), L.scale[n]),
                           L.bias[n]);
      } else {
        // f32 FMA dot: REAL and emulated INT/DINT are compared within
        // tolerance (summation order differs from any library's).
        float acc[ROWS_PER_THREAD] = {};
        if (L.mode == MODE_REAL)
          dot_f32((const float*)L.w, L.k, L.n, n, cur, row_off, acc);
        else if (L.mode == MODE_INT16)
          dot_f32((const int16_t*)L.w, L.k, L.n, n, cur, row_off, acc);
        else
          dot_f32((const int32_t*)L.w, L.k, L.n, n, cur, row_off, acc);
#pragma unroll
        for (int j = 0; j < ROWS_PER_THREAD; ++j)
          y[j] = L.mode == MODE_REAL
                     ? __fadd_rn(acc[j], L.bias[n])
                     : __fadd_rn(__fmul_rn(acc[j], L.scale[n]), L.bias[n]);
      }
#pragma unroll
      for (int j = 0; j < ROWS_PER_THREAD; ++j)
        if (r0 + j < block_m) nxt[(r0 + j) * ld + n] = activate(y[j], L.act);
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }

  // Store the real rows of the last layer's tile.
  const int n_out = desc.layers[desc.n_layers - 1].n;
  for (int i = threadIdx.x; i < rows * n_out; i += blockDim.x) {
    const int r = i / n_out, c = i - r * n_out;
    out[(size_t)(row0 + r) * n_out + c] = cur[r * ld + c];
  }
}

// Launches the kernel on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted).  `desc` points at an MlpDesc in host memory; it is
// copied into the launch's parameters.
extern "C" int fused_mlp_launch(const void* x, void* out, int m, int block_m,
                                int ld, const void* desc, void* stream) {
  // Above 48 KB a block may use dynamic shared memory only after opting in;
  // the opt-in is remembered, so it costs one runtime call per new maximum.
  static int opted_in = 48 * 1024;
  const int smem = 2 * block_m * ld * (int)sizeof(float);
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = smem;
  }
  const dim3 grid((m + block_m - 1) / block_m);
  fused_mlp_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, m, block_m, ld,
      *(const MlpDesc*)desc);
  return (int)cudaGetLastError();
}
