// Hopper kernel: a whole heterogeneous detector fleet in ONE launch.
//
// Replaces src/repro/kernels/fused_mlp.py::grouped_fused_mlp (body
// _grouped_kernel), the Pallas TPU kernel behind
// repro.kernels.ops.grouped_apply.  It computes what that kernel computes,
// with a layout of its own: grid = (ceil(M / block_m), G), so blockIdx.y is
// the group and a block owns `block_m` rows of one group.  The block reads
// its group's row of the `meta` table ([kind, n_out, act_id x L, skip x L])
// from global memory, where the TPU kernel kept an SMEM scalar table, and
// runs the group's whole stack over the packed arenas: position l's weights
// for group g are the slab `w + g * K_l * N_l` of one (G, K_l, N_l) arena,
// its scale/bias rows `+ g * N_l`, its activation scale `x_scale[g]`.
// Activations of the current and the next position live in dynamic shared
// memory (2 x block_m x widest union width f32: 51,200 B for the four-head
// §7 fleet, whose last position is 400 wide).
//
// Per position, block-uniform branches on the group's meta row:
//   * skip (a group shallower than the fleet): pass the tile through,
//     zero-padded or cut to N_l; no product;
//   * otherwise the layer math of mlp_common.cuh (REAL / INT8 / emulated
//     INT16-INT32, shared with fused_mlp.cu), then the group's activation;
//     a softmax (legal only as a group's final layer) is masked to the
//     group's true n_out lanes: row max, expf(z - max), row sum, divide.
// Epilogue per group: kind 0 (logits) writes lanes [0, n_out) of the final
// tile and zeros up to n_pay; kind 1 (score) writes
// sum_{lane < n_out} (h - tgt)^2 / n_out to lane 0 and zeros to the rest.
// Pad lanes of a group's tile (beyond its true width) hold act(0) and meet
// zero weight rows at the next position, so they never reach a true lane;
// the forecast group's last reading (lanes 398-399 of the 400-wide window)
// meets zero rows the same way.  Skip slots keep x_scale = 1, so the
// quantize of a skipped slot never divides by 0.
//
// Numerics: as fused_mlp.cu (mlp_common.cuh): SINT logits bit-equal to the
// plain version (ref.grouped_mlp_ref); score lanes are reductions summed in
// another order than torch.mean, so they agree to ~1e-6 relative.
//
// What bounds it on the card: bytes.  For the four-head SINT fleet at
// M = 1024 rows per group it must read x (each group's true input lanes,
// 6.55 MB), the target lanes the score epilogues use (autoencoder 400,
// margin 16, forecaster 2; the classifier's none: 1.71 MB) and the arenas
// (~0.24 MB), and write the payload (4 x 1024 x 2 f32, 32 KB): ~8.5 MB,
// ~2.55 us at 3.35 TB/s.  Its ~0.45 G int8 operations (union widths) take
// ~0.23 us at the int8 peak.
// This first version is far above that bound: CUDA-core dots, one thread per
// output column and ROWS_PER_THREAD rows, every group computing at the union
// widths.  Tensor cores (wgmma/TMA), reading the window/tail target from x
// instead of a full-width tgt operand, and true-width products are later
// work.

#include <math_constants.h>

#include "mlp_common.cuh"

#define MAX_POSITIONS 8

// Activation ids: repro_torch/kernels/fused_mlp.py::GROUPED_ACT_IDS, the
// activation names in sorted order (as the reference's table).
enum GroupedAct {
  GACT_BINARY_STEP = 0, GACT_ELU = 1, GACT_LEAKY_RELU = 2, GACT_LINEAR = 3,
  GACT_RELU = 4, GACT_SIGMOID = 5, GACT_SOFTMAX = 6, GACT_SWISH = 7,
  GACT_TANH = 8
};

enum Kind { KIND_LOGITS = 0, KIND_SCORE = 1 };

// The element-wise activation a grouped id selects (mlp_common.cuh's Act);
// softmax runs as linear here and is normalized by a row pass afterwards.
__device__ __forceinline__ int element_act(int gact) {
  switch (gact) {
    case GACT_BINARY_STEP: return ACT_BINARY_STEP;
    case GACT_ELU: return ACT_ELU;
    case GACT_LEAKY_RELU: return ACT_LEAKY_RELU;
    case GACT_RELU: return ACT_RELU;
    case GACT_SIGMOID: return ACT_SIGMOID;
    case GACT_SWISH: return ACT_SWISH;
    case GACT_TANH: return ACT_TANH;
    default: return ACT_LINEAR;
  }
}

// One layer position of the packed fleet.  Mirrored field for field by
// fused_mlp.py::_PositionDesc.
struct PositionDesc {
  const void* w;          // (G, k, n) arena: f32, int8, int16 or int32
  const float* scale;     // (G, n) combined x_scale * w_scale (0 if real)
  const float* bias;      // (G, n)
  const float* x_scale;   // (G,) activation scales (1 on real/skip slots)
  int k;                  // union input width
  int n;                  // union output width
  int mode;
  float qmax;             // symmetric clip rail, as f32 (quantized only)
};

// The fleet, passed to the kernel by value.  Mirrored by _GroupedDesc.
struct GroupedDesc {
  int n_layers;
  int n_pay;              // payload lanes per row
  const int* meta;        // (G, 2 + 2 * n_layers) int32
  PositionDesc pos[MAX_POSITIONS];
};

__device__ __forceinline__ size_t mode_bytes(int mode) {
  return mode == MODE_INT8 ? 1 : mode == MODE_INT16 ? 2 : 4;
}

// Softmax over lanes [0, n_valid) of each row of the tile, in place, and
// zeros in lanes [n_valid, n_dim): one warp per row.
__device__ __forceinline__ void masked_softmax(float* t, int block_m, int ld,
                                               int n_dim, int n_valid) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < block_m; r += blockDim.x >> 5) {
    float* row = t + r * ld;
    float mx = -CUDART_INF_F;
    for (int c = lane; c < n_valid; c += 32) mx = fmaxf(mx, row[c]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int c = lane; c < n_valid; c += 32) {
      const float e = expf(__fsub_rn(row[c], mx));
      row[c] = e;
      sum = __fadd_rn(sum, e);
    }
    sum = warp_sum(sum);
    for (int c = lane; c < n_dim; c += 32)
      row[c] = c < n_valid ? __fdiv_rn(row[c], sum) : 0.0f;
  }
}

// grid = (ceil(m / block_m), G); dynamic shared memory = 2 * block_m * ld * 4 B.
// x: (G, m, k0); tgt: (G, m, n_last); out: (G, m, n_pay); all f32.
__global__ void __launch_bounds__(THREADS)
grouped_mlp_kernel(const float* __restrict__ x, const float* __restrict__ tgt,
                   float* __restrict__ out, int m, int block_m, int ld,
                   const GroupedDesc desc) {
  extern __shared__ float smem[];
  float* cur = smem;                  // block_m x ld: this position's input
  float* nxt = smem + block_m * ld;   // block_m x ld: its output
  const int g = blockIdx.y;
  const int row0 = blockIdx.x * block_m;
  const int rows = min(block_m, m - row0);
  const int n_layers = desc.n_layers;
  const int* meta = desc.meta + (size_t)g * (2 + 2 * n_layers);
  const int kind = meta[0];
  const int n_out = meta[1];

  // Stage the group's input tile.  Rows past the ragged M edge are zeros:
  // they run through the stack like real rows and are never stored.
  const int k0 = desc.pos[0].k;
  const float* xg = x + ((size_t)g * m + row0) * k0;
  for (int i = threadIdx.x; i < block_m * k0; i += blockDim.x) {
    const int r = i / k0, c = i - r * k0;
    cur[r * ld + c] = r < rows ? xg[(size_t)r * k0 + c] : 0.0f;
  }
  __syncthreads();

  for (int l = 0; l < n_layers; ++l) {
    const PositionDesc P = desc.pos[l];
    if (meta[2 + n_layers + l]) {
      // Skip: carry the finished group's activations (its true payload sits
      // in the leading lanes; the union width never cuts it).
      for (int i = threadIdx.x; i < block_m * P.n; i += blockDim.x) {
        const int r = i / P.n, c = i - r * P.n;
        nxt[r * ld + c] = c < P.k ? cur[r * ld + c] : 0.0f;
      }
    } else {
      const int gact = meta[2 + l];
      const size_t slab = (size_t)g * P.k * P.n;
      dense_tile<true>(cur, nxt, block_m, ld,
                       (const char*)P.w + slab * mode_bytes(P.mode),
                       P.scale + (size_t)g * P.n, P.bias + (size_t)g * P.n,
                       P.x_scale[g], P.k, P.n, P.mode, P.qmax,
                       ActFn{element_act(gact)});
      if (gact == GACT_SOFTMAX) {
        __syncthreads();
        masked_softmax(nxt, block_m, ld, P.n, n_out);
      }
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }

  // Head epilogue: the group's payload rows.
  const int n_pay = desc.n_pay;
  float* og = out + ((size_t)g * m + row0) * n_pay;
  if (kind == KIND_LOGITS) {
    for (int i = threadIdx.x; i < rows * n_pay; i += blockDim.x) {
      const int r = i / n_pay, c = i - r * n_pay;
      og[(size_t)r * n_pay + c] = c < n_out ? cur[r * ld + c] : 0.0f;
    }
  } else {
    // Masked mean squared error against the target row: one warp per row.
    const int n_last = desc.pos[n_layers - 1].n;
    const float* tg = tgt + ((size_t)g * m + row0) * n_last;
    const int lane = threadIdx.x & 31;
    for (int r = threadIdx.x >> 5; r < rows; r += blockDim.x >> 5) {
      float s = 0.0f;
      for (int c = lane; c < n_out; c += 32) {
        const float d = __fsub_rn(cur[r * ld + c], tg[(size_t)r * n_last + c]);
        s = __fadd_rn(s, __fmul_rn(d, d));
      }
      s = warp_sum(s);
      for (int c = lane; c < n_pay; c += 32)
        og[(size_t)r * n_pay + c] = c == 0 ? __fdiv_rn(s, (float)n_out) : 0.0f;
    }
  }
}

// Launches the kernel on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted).  `desc` points at a GroupedDesc in host memory; it is
// copied into the launch's parameters.
extern "C" int grouped_mlp_launch(const void* x, const void* tgt, void* out,
                                  int m, int n_groups, int block_m, int ld,
                                  const void* desc, void* stream) {
  // Above 48 KB a block may use dynamic shared memory only after opting in;
  // the opt-in is remembered, so it costs one runtime call per new maximum.
  static int opted_in = 48 * 1024;
  const int smem = 2 * block_m * ld * (int)sizeof(float);
  if (smem > opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        grouped_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    opted_in = smem;
  }
  const dim3 grid((m + block_m - 1) / block_m, n_groups);
  grouped_mlp_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)tgt, (float*)out, m, block_m, ld,
      *(const GroupedDesc*)desc);
  return (int)cudaGetLastError();
}
