// Hopper kernel: a whole heterogeneous detector fleet in ONE launch.
//
// Replaces src/repro/kernels/fused_mlp.py::grouped_fused_mlp (body
// _grouped_kernel), the Pallas TPU kernel behind
// repro.kernels.ops.grouped_apply.  It computes what that kernel computes,
// with a layout of its own: grid = (row tiles, G), so blockIdx.y is the
// group and a block owns one tile of rows of one group.  The block reads
// its group's row of the `meta` table ([kind, n_out, act_id x L, skip x L,
// k x L, n x L]) from global memory, where the TPU kernel kept an SMEM
// scalar table, and runs the group's whole stack over the packed arenas:
// position l's weights for group g are the slab `g` of one (G, K_l, N_l)
// arena, its scale/bias rows `+ g * N_l`, its activation scale
// `x_scale[g]`.
//
// Every product runs at the group's TRUE widths (the meta row's k and n per
// position), padded only to the tensor cores' granule (32 deep, 8 wide) on
// the int8 path: the classifier, margin and forecast groups no longer run
// the autoencoder's 64 x 400 last position over zero-padded arenas.
//
// Two kernels, one per path (kernels/fused_mlp.py::path; the layer math and
// its numerics are mlp_common.cuh's, shared with fused_mlp.cu):
//   * grouped_mlp_kernel_int8_mma (every position int8): 16-row tiles (the
//     whole m16 tile: 256 blocks for the four-head fleet at M = 1024, two
//     per SM, one wave).  The block gathers its group's steps (meta
//     entries, slab pointers, activation scales) into shared memory, has a
//     score group's target rows prefetched into L2, quantizes its input
//     lanes as they are staged (16-byte loads) into int8 codes, runs each
//     position as mma.sync m16n8k32 with B from the plan-time K-major copy
//     of the arena ((G, round8(N_l), round32(K_l)), PositionDesc::wt), and
//     requantizes in registers into the next position's codes; a group's
//     last layer writes f32 into a tile for the epilogue.  Shared memory:
//     2 x 16 x (round32(widest K) + 16) B of codes, 16 x widest n_out x 4 B
//     of f32 (39,424 B for the §7 fleet) and the 448 B step table.
//   * grouped_mlp_kernel_f32_tile (REAL / INT16 / INT32 positions): 8-row
//     tiles, two f32 tiles (2 x 8 x widest union width x 4 B) and CUDA-core
//     dots over the true widths.
//
// Per position, block-uniform branches on the group's meta row:
//   * skip (a group shallower than the fleet): nothing; its payload stays
//     where its last layer left it;
//   * otherwise the group's layer and activation; a softmax (legal only as
//     a group's final layer) is masked to the group's true n_out lanes: row
//     max, expf(z - max), row sum, divide.
// Epilogue per group: kind 0 (logits) writes lanes [0, n_out) of the final
// tile and zeros up to n_pay; kind 1 (score) writes
// sum_{lane < n_out} (h - tgt)^2 / n_out to lane 0 and zeros to the rest,
// reading only the n_out target lanes of its `tgt` row.
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
// ~2.55 us at 3.35 TB/s.  Its true-width int8 products (~0.28 G operations;
// ~0.45 G at the union widths of the earlier kernel) take ~0.14 us at the
// int8 peak.  With every block resident at once, what is left above the
// byte bound is each block's chain: its input's device-memory round trip,
// the quantize of 16 x 400 lanes, then one L2 round trip and a barrier per
// position.

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
  const int8_t* wt;       // int8_mma: (G, round8(n), round32(k)) K-major
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
  const int* meta;        // (G, 2 + 4 * n_layers) int32
  PositionDesc pos[MAX_POSITIONS];
};

__device__ __forceinline__ size_t mode_bytes(int mode) {
  return mode == MODE_INT8 ? 1 : mode == MODE_INT16 ? 2 : 4;
}

// A group's view of its meta row.
struct GroupMeta {
  const int* row;
  int n_layers;
  __device__ __forceinline__ int kind() const { return row[0]; }
  __device__ __forceinline__ int n_out() const { return row[1]; }
  __device__ __forceinline__ int act(int l) const { return row[2 + l]; }
  __device__ __forceinline__ bool skip(int l) const {
    return row[2 + n_layers + l] != 0;
  }
  __device__ __forceinline__ int k(int l) const {
    return row[2 + 2 * n_layers + l];
  }
  __device__ __forceinline__ int n(int l) const {
    return row[2 + 3 * n_layers + l];
  }
};

// Softmax over lanes [0, n_valid) of each of the tile's `rows` rows, in
// place, and zeros in lanes [n_valid, n_dim): one warp per row.
__device__ __forceinline__ void masked_softmax(float* t, int ld, int n_dim,
                                               int n_valid, int rows) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += blockDim.x >> 5) {
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

// Head epilogue: the group's payload rows from its final f32 tile `fin`
// (row stride ld).
__device__ __forceinline__ void head_epilogue(
    int kind, int n_out, const float* fin, int ld, const float* tg,
    int n_last, float* og, int n_pay, int rows) {
  if (kind == KIND_LOGITS) {
    for (int i = threadIdx.x; i < rows * n_pay; i += blockDim.x) {
      const int r = i / n_pay, c = i - r * n_pay;
      og[(size_t)r * n_pay + c] = c < n_out ? fin[r * ld + c] : 0.0f;
    }
  } else {
    // Masked mean squared error against the target row: one warp per row.
    const int lane = threadIdx.x & 31;
    for (int r = threadIdx.x >> 5; r < rows; r += blockDim.x >> 5) {
      float s = 0.0f;
      for (int c = lane; c < n_out; c += 32) {
        const float d = __fsub_rn(fin[r * ld + c], tg[(size_t)r * n_last + c]);
        s = __fadd_rn(s, __fmul_rn(d, d));
      }
      s = warp_sum(s);
      for (int c = lane; c < n_pay; c += 32)
        og[(size_t)r * n_pay + c] = c == 0 ? __fdiv_rn(s, (float)n_out) : 0.0f;
    }
  }
}

// Rows per block of the int8 path: the whole m16 tile (256 blocks for the
// four-head fleet at M = 1024, two per SM; fused_mlp.py::GROUPED_ROWS).
#define GROUPED_ROWS 16

// grid = (ceil(m / GROUPED_ROWS), G); dynamic shared memory =
// 2 * GROUPED_ROWS * cld + GROUPED_ROWS * fld * 4 B; the step table is
// static.  x: (G, m, k0); tgt: (G, m, n_last); out: (G, m, n_pay); all f32.
__global__ void __launch_bounds__(THREADS, 2)
grouped_mlp_kernel_int8_mma(const float* __restrict__ x,
                            const float* __restrict__ tgt,
                            float* __restrict__ out, int m, int cld, int fld,
                            const __grid_constant__ GroupedDesc desc) {
  extern __shared__ __align__(16) int8_t smem8[];
  // The group's meta row, position descriptors and activation scales,
  // gathered by one thread per position: the layer loop then waits on no
  // global or constant-cache load for them.
  __shared__ Step steps[MAX_POSITIONS];
  int8_t* cur = smem8;                        // this position's input codes
  int8_t* nxt = smem8 + GROUPED_ROWS * cld;   // the next position's
  float* fin = reinterpret_cast<float*>(smem8 + 2 * GROUPED_ROWS * cld);
  const int g = blockIdx.y;
  const int row0 = blockIdx.x * GROUPED_ROWS;
  const int rows = min(GROUPED_ROWS, m - row0);
  const int n_layers = desc.n_layers;
  const GroupMeta meta{desc.meta + (size_t)g * (2 + 4 * n_layers), n_layers};

  if (threadIdx.x < n_layers) {
    const int l = threadIdx.x;
    const PositionDesc& P = desc.pos[l];
    const int wt_ld = (P.k + 31) & ~31;
    steps[l] = Step{P.wt + (size_t)g * ((P.n + 7) & ~7) * wt_ld,
                    P.scale + (size_t)g * P.n, P.bias + (size_t)g * P.n,
                    make_quant(P.x_scale[g], P.qmax), wt_ld, meta.k(l),
                    meta.n(l), meta.act(l), meta.skip(l)};
  }
  const int kind = meta.kind(), n_out = meta.n_out();
  const int n_last = desc.pos[n_layers - 1].n;
  const float* tg = tgt + ((size_t)g * m + row0) * n_last;
  if (kind == KIND_SCORE) {
    // The epilogue's target lanes into L2 now, not at the end: one
    // 128-byte line per thread and step.
    const int lines = (n_out + 31) >> 5;
    for (int i = threadIdx.x; i < rows * lines; i += blockDim.x) {
      const int r = i / lines, c = (i - r * lines) * 32;
      asm volatile("prefetch.global.L2 [%0];" ::"l"(tg + (size_t)r * n_last +
                                                     c));
    }
  }
  __syncthreads();
  const int k0u = desc.pos[0].k;
  stage_codes<GROUPED_ROWS>(x + ((size_t)g * m + row0) * k0u, rows, k0u,
                            steps[0].k, steps[0].quant, cur, cld);
  __syncthreads();

  for (int l = 0; l < n_layers; ++l) {
    const Step& S = steps[l];
    if (S.skip) continue;   // block-uniform: the group has ended
    const int act = element_act(S.act);
    if (l + 1 == n_layers || steps[l + 1].skip) {
      mma_layer<GROUPED_ROWS>(cur, cld, S,
                              F32Epi{act, S.n, fin, fld, GROUPED_ROWS});
      if (S.act == GACT_SOFTMAX) {
        __syncthreads();
        masked_softmax(fin, fld, S.n, n_out, GROUPED_ROWS);
      }
    } else {
      const Step& N = steps[l + 1];
      mma_layer<GROUPED_ROWS>(cur, cld, S,
                              CodesEpi{act, S.n, N.quant, nxt, cld});
    }
    __syncthreads();
    int8_t* t = cur;
    cur = nxt;
    nxt = t;
  }

  head_epilogue(kind, n_out, fin, fld, tg, n_last,
                out + ((size_t)g * m + row0) * desc.n_pay, desc.n_pay, rows);
}

// grid = (ceil(m / BLOCK_M), G); dynamic shared memory =
// 2 * BLOCK_M * ld * 4 B.
__global__ void __launch_bounds__(THREADS)
grouped_mlp_kernel_f32_tile(const float* __restrict__ x,
                       const float* __restrict__ tgt, float* __restrict__ out,
                       int m, int ld,
                       const __grid_constant__ GroupedDesc desc) {
  extern __shared__ __align__(16) float smem[];
  float* cur = smem;                  // BLOCK_M x ld: this position's input
  float* nxt = smem + BLOCK_M * ld;   // BLOCK_M x ld: its output
  const int g = blockIdx.y;
  const int row0 = blockIdx.x * BLOCK_M;
  const int rows = min(BLOCK_M, m - row0);
  const int n_layers = desc.n_layers;
  const GroupMeta meta{desc.meta + (size_t)g * (2 + 4 * n_layers), n_layers};

  // Rows past the ragged M edge are zeros: they run through the stack like
  // real rows and are never stored.
  const int k0u = desc.pos[0].k;
  stage_f32(x + ((size_t)g * m + row0) * k0u, rows, k0u, meta.k(0), cur, ld);
  __syncthreads();

  for (int l = 0; l < n_layers; ++l) {
    if (meta.skip(l)) continue;   // block-uniform: the group has ended
    const PositionDesc& P = desc.pos[l];
    const int gact = meta.act(l);
    const size_t slab = (size_t)g * P.k * P.n;
    dense_tile<true>(cur, nxt, ld,
                     (const char*)P.w + slab * mode_bytes(P.mode), P.n,
                     P.scale + (size_t)g * P.n, P.bias + (size_t)g * P.n,
                     P.x_scale[g], meta.k(l), meta.n(l), P.mode, P.qmax,
                     ActFn{element_act(gact)});
    if (gact == GACT_SOFTMAX) {
      __syncthreads();
      masked_softmax(nxt, ld, meta.n(l), meta.n_out(), BLOCK_M);
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }

  const int n_last = desc.pos[n_layers - 1].n;
  head_epilogue(meta.kind(), meta.n_out(), cur, ld,
                tgt + ((size_t)g * m + row0) * n_last, n_last,
                out + ((size_t)g * m + row0) * desc.n_pay, desc.n_pay, rows);
}

// Launches the path's kernel (int8_mma = 1, f32_tile = 0) on `stream` and
// returns cudaGetLastError() (0 when the launch was accepted).  int8_mma:
// `ld` is the code tiles' row stride in bytes and `fld` the f32 tile's in
// floats; f32_tile: `ld` is the f32 tiles' row stride in floats.  `desc`
// points at a GroupedDesc in host memory; it is copied into the launch's
// parameters.
extern "C" int grouped_mlp_launch(const void* x, const void* tgt, void* out,
                                  int m, int n_groups, int int8_mma, int ld,
                                  int fld, const void* desc, void* stream) {
  static int opted_int8 = 48 * 1024, opted_f32 = 48 * 1024;
  const GroupedDesc& d = *(const GroupedDesc*)desc;
  cudaError_t err;
  if (int8_mma) {
    const dim3 grid((m + GROUPED_ROWS - 1) / GROUPED_ROWS, n_groups);
    const int smem =
        2 * GROUPED_ROWS * ld + GROUPED_ROWS * fld * (int)sizeof(float);
    err = opt_in_smem(grouped_mlp_kernel_int8_mma, smem, opted_int8);
    if (err != cudaSuccess) return (int)err;
    grouped_mlp_kernel_int8_mma<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)tgt, (float*)out, m, ld, fld, d);
  } else {
    const dim3 grid((m + BLOCK_M - 1) / BLOCK_M, n_groups);
    const int smem = 2 * BLOCK_M * ld * (int)sizeof(float);
    err = opt_in_smem(grouped_mlp_kernel_f32_tile, smem, opted_f32);
    if (err != cudaSuccess) return (int)err;
    grouped_mlp_kernel_f32_tile<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)tgt, (float*)out, m, ld, d);
  }
  return (int)cudaGetLastError();
}
