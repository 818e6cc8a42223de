// Hopper kernel: a whole Dense stack (the §7 detector) in ONE launch.
//
// Replaces src/repro/kernels/fused_mlp.py::fused_mlp, the Pallas TPU kernel
// behind repro.kernels.ops.fused_forward.  It computes what that kernel
// computes, not its blocks: the TPU version walks a sequential K grid and
// carries layer 0's sum in VMEM scratch; here one 256-thread block owns
// BLOCK_M = 8 rows (128 blocks at M = 1024, a block on nearly every SM) and
// runs every layer of the stack in a loop, its activations in shared
// memory.  Weights stay in global memory, where the whole stack (28 KB SINT
// / 113 KB REAL for the classifier) sits in L2 after the first blocks touch
// it.
//
// What bounds it on the card: bytes.  At M = 1024 the SINT classifier moves
// ~1.68 MB (input 1.64 MB, weights 28 KB, output 8 KB), ~0.5 us at
// 3.35 TB/s, and the autoencoder ~3.3 MB (~1.0 us); its ~58 M int8
// operations are ~0.03 us at the int8 peak.  So the design reads the input
// once, with 16-byte loads, and keeps everything after it on chip.  With a
// block per SM, what is left is each block's chain: the input's round trip
// to device memory and its quantize, then per layer one L2 round trip for
// its fragments, its products, its epilogue and a barrier.  Measured on
// the H100 (PERF.md, Findings), each of those epilogue-heavy steps is bound by
// its instructions more than by memory, so the int8 path keeps them few:
// the descriptor is read once into a step table in shared memory, the
// quantize mostly multiplies by a reciprocal (mlp_common.cuh::quantize,
// bit-equal to the IEEE division) and the rare activations are one
// out-of-line call.
//
// Two kernels, one per path (kernels/fused_mlp.py::path, chosen at plan
// time; mlp_common.cuh has the layer math and the numerics):
//   * fused_mlp_kernel_int8_mma (every layer SINT): the input is quantized
//     as it is staged and lives in shared memory as int8 codes (2 x 8 rows
//     x (round32(widest K) + 16) B, beside the 448 B step table); each
//     layer runs mma.sync m16n8k32 int8 products with B fragments loaded
//     from the plan-time K-major int8 copy (LayerDesc::wt), and its
//     epilogue requantizes in registers straight into the next layer's
//     codes: no f32 tile and no separate requantize pass between layers.
//     The last layer writes its real rows and columns to `out` from
//     registers.
//   * fused_mlp_kernel_f32_tile (any REAL / INT16 / INT32 layer): two f32
//     tiles (2 x 8 rows x widest lanes x 4 B) and CUDA-core dots, on the
//     same grid and the same 16-byte staging; a thread owns one output
//     column of two rows, so every thread of the block has work (four rows
//     a thread left half of them idle on the §7 stacks' 64-wide layers).

#include "mlp_common.cuh"

#define MAX_LAYERS 8

// One layer.  Mirrored field for field by fused_mlp.py::_LayerDesc.
struct LayerDesc {
  const void* w;        // (k, n) row-major: f32, int8, int16 or int32
  const int8_t* wt;     // int8_mma: (round8(n), round32(k)) K-major copy
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

// grid.x = ceil(m / BLOCK_M); dynamic shared memory = 2 * BLOCK_M * cld B
// of codes; the step table is static.
__global__ void __launch_bounds__(THREADS, 2)
fused_mlp_kernel_int8_mma(const float* __restrict__ x, float* __restrict__ out,
                          int m, int cld,
                          const __grid_constant__ MlpDesc desc) {
  extern __shared__ __align__(16) int8_t smem8[];
  __shared__ Step steps[MAX_LAYERS];
  int8_t* cur = smem8;                    // this layer's input codes
  int8_t* nxt = smem8 + BLOCK_M * cld;    // the next layer's
  const int row0 = blockIdx.x * BLOCK_M;
  const int rows = min(BLOCK_M, m - row0);
  const int n_layers = desc.n_layers;
  const int k0 = desc.layers[0].k;

  if (threadIdx.x < n_layers) {
    const LayerDesc& L = desc.layers[threadIdx.x];
    steps[threadIdx.x] = Step{L.wt, L.scale, L.bias,
                              make_quant(L.x_scale, L.qmax),
                              (L.k + 31) & ~31, L.k, L.n, L.act, 0};
  }
  stage_codes<BLOCK_M>(
      x + (size_t)row0 * k0, rows, k0, k0,
      make_quant(desc.layers[0].x_scale, desc.layers[0].qmax), cur, cld);
  __syncthreads();

  for (int l = 0; l + 1 < n_layers; ++l) {
    const Step& S = steps[l];
    const Step& N = steps[l + 1];
    mma_layer<BLOCK_M>(cur, cld, S,
                       CodesEpi{S.act, S.n, N.quant, nxt, cld});
    __syncthreads();
    int8_t* t = cur;
    cur = nxt;
    nxt = t;
  }
  const Step& S = steps[n_layers - 1];
  mma_layer<BLOCK_M>(cur, cld, S,
                     F32Epi{S.act, S.n, out + (size_t)row0 * S.n, S.n, rows});
}

// grid.x = ceil(m / BLOCK_M); dynamic shared memory =
// 2 * BLOCK_M * ld * 4 B.
__global__ void __launch_bounds__(THREADS)
fused_mlp_kernel_f32_tile(const float* __restrict__ x, float* __restrict__ out,
                     int m, int ld,
                     const __grid_constant__ MlpDesc desc) {
  extern __shared__ __align__(16) float smem[];
  float* cur = smem;                  // BLOCK_M x ld: this layer's input
  float* nxt = smem + BLOCK_M * ld;   // BLOCK_M x ld: its output
  const int row0 = blockIdx.x * BLOCK_M;
  const int rows = min(BLOCK_M, m - row0);
  const int k0 = desc.layers[0].k;

  // Rows past the ragged M edge are zeros: they run through the stack like
  // real rows (finite values) and are never stored.
  stage_f32(x + (size_t)row0 * k0, rows, k0, k0, cur, ld);
  __syncthreads();

  for (int l = 0; l < desc.n_layers; ++l) {
    const LayerDesc& L = desc.layers[l];
    dense_tile<false>(cur, nxt, ld, L.w, L.n, L.scale, L.bias, L.x_scale,
                      L.k, L.n, L.mode, L.qmax, ActFn{L.act});
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

// Launches the path's kernel (int8_mma = 1, f32_tile = 0) on `stream` and
// returns cudaGetLastError() (0 when the launch was accepted).  `ld` is the
// code tile's row stride in bytes (int8_mma) or the f32 tile's in floats.
// `desc` points at an MlpDesc in host memory; it is copied into the
// launch's parameters.
extern "C" int fused_mlp_launch(const void* x, void* out, int m, int int8_mma,
                                int ld, const void* desc, void* stream) {
  static int opted_int8 = 48 * 1024, opted_f32 = 48 * 1024;
  const MlpDesc& d = *(const MlpDesc*)desc;
  cudaError_t err;
  if (int8_mma) {
    const dim3 grid((m + BLOCK_M - 1) / BLOCK_M);
    const int smem = 2 * BLOCK_M * ld;
    err = opt_in_smem(fused_mlp_kernel_int8_mma, smem, opted_int8);
    if (err != cudaSuccess) return (int)err;
    fused_mlp_kernel_int8_mma<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)x, (float*)out, m, ld, d);
  } else {
    const dim3 grid((m + BLOCK_M - 1) / BLOCK_M);
    const int smem = 2 * BLOCK_M * ld * (int)sizeof(float);
    err = opt_in_smem(fused_mlp_kernel_f32_tile, smem, opted_f32);
    if (err != cudaSuccess) return (int)err;
    fused_mlp_kernel_f32_tile<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)x, (float*)out, m, ld, d);
  }
  return (int)cudaGetLastError();
}
