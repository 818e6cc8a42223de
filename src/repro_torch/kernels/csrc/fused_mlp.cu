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
// The layer math, the activations and their numerics (bit for bit against the plain version
// on SINT: IEEE division, half-even rounding, int32 accumulation, unfused
// requantize; f32 FMA dots, no TF32) live in mlp_common.cuh, shared with
// grouped_mlp.cu.
//
// What bounds it on the card: bytes.  At M = 1024 the SINT classifier moves
// ~1.68 MB (input 1.64 MB, weights 28 KB, output 8 KB), ~0.5 us at
// 3.35 TB/s, and the autoencoder ~3.3 MB (~1.0 us); its ~58 M int8 operations
// are ~0.03 us at the int8 peak.  Both bounds sit far under the launch
// overhead, so this first version keeps the design simple: one launch, no
// inter-layer traffic to device memory, coalesced weight reads shared by
// ROWS_PER_THREAD rows per thread.  Tensor-core (wgmma/TMA) versions are
// later work.

#include "mlp_common.cuh"

#define MAX_LAYERS 8

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

  for (int l = 0; l < desc.n_layers; ++l) {
    const LayerDesc L = desc.layers[l];
    dense_tile<false>(cur, nxt, block_m, ld, L.w, L.scale, L.bias,
                      L.x_scale, L.k, L.n, L.mode, L.qmax, ActFn{L.act});
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
