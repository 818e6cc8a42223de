// Hopper kernel: block-sparse f32 matmul, out = x @ W, visiting only the
// nonzero (BK, BN) tiles of W — the §6.2 "operation skip" made structural.
//
// Replaces src/repro/kernels/sparse_matmul.py::sparse_matmul, the Pallas TPU
// kernel behind repro.kernels.ops.sparse_dense.  The TPU version walks ONE
// sequential grid over the nonzero tiles, sorted by output column; a `first`
// flag zero-initialises each output tile's run, and the wrapper masks the
// columns no tile reached.  Here every thread block owns a slice of one
// output block-column and walks that column's run of tiles (built once at
// plan time by core/prune.py::BlockSparseWeight: tiles sorted by column,
// their block rows and per-column offsets).  A block-column pruned whole has
// an empty run, and its blocks write exact zeros: no masking pass.
//
// What bounds it on the card, at the §6.2 layer (K 896, N 512, half of the
// (128, 128) blocks): at M = 8 the bytes (~1 MB, 0.29 us at 3.35 TB/s) —
// in practice the latency of a few dependent loads, so the design is about
// how many SMs take part; at M = 1024 the f32 operations (0.47 GFLOP, 7 us
// at 67 TFLOP/s).  f32 IEEE on the CUDA cores throughout: no TF32 (the
// reference's contract, the ROADMAP's Hopper numerics rule).
//
// Two paths, one launch per call; the wrapper (sparse_matmul.py::plan)
// picks the path from M, and the launcher derives the grid from it:
//
// * small M (M <= 32): `sparse_matmul_kernel_small`.  A block owns a
//   4-column slice of a block-column (128 blocks at N 512) and MT = 8 rows
//   of x.  x's rows arrive in shared memory by cp.async while each of the
//   256 threads loads its first run rows (SMALL_PREFETCH of them, one
//   float4 each) into registers, so the two latencies overlap.  Thread t
//   takes run rows t, t + 256, ... (tile by tile, row by row) and keeps an
//   8 x 4 partial sum.  The 256 partial sums of each output are combined
//   in a fixed order — a recursive-halving butterfly over the lane bits
//   (31 shuffles), then the 8 warps in warp order through shared memory —
//   with no atomics: two calls give the same bits.
// * large M: `sparse_matmul_kernel_large`, a register-blocked SGEMM tile:
//   64 rows x a 64-column slice of a block-column per block, 4 x 4
//   outputs per thread, read as float4 from shared memory (4 x float4 of x
//   along K, 4 x float4 of W along N: 64 FMAs per 8 loads).  The tiles
//   arrive KC = 32 rows at a time through a 4-stage cp.async (16 B) ring,
//   three stages ahead; rows past M are zero-filled.  A block walks one
//   piece of its column's run, from the plan-time work list
//   (BlockSparseWeight.col_pieces: runs cut into near-equal pieces), so a
//   column with a long run does not set the kernel's time.  A run cut
//   into pieces leaves each piece's partial tile in a scratch buffer; the
//   column's last block to finish (an atomic count per output tile, reset
//   by that block) adds them in piece order.  Tiles are visited in run
//   order and K in order within each, and pieces summed in order, so the
//   result does not depend on which block finishes last.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pipeline.cuh"

#define THREADS 256
#define SMALL_COLS 4       // columns per block, small path
#define SMALL_ROWS 8       // rows of x per block, small path (MT)
#define SMALL_PREFETCH 4   // run rows per thread loaded before x lands
#define LARGE_COLS 64      // columns per block, large path
#define LARGE_ROWS 64      // rows of x per block, large path
#define KC 32              // K rows per pipeline stage, large path
#define LARGE_STAGES 4     // stages in the large path's ring
#define LARGE_SMEM \
  (LARGE_STAGES * (LARGE_ROWS * (KC + 4) + KC * LARGE_COLS) * 4)

// ---------------------------------------------------------------------------
// Small M.
// ---------------------------------------------------------------------------

template <int BK, int BN>
__global__ void __launch_bounds__(THREADS)
sparse_matmul_kernel_small(const float* __restrict__ x,
                           const float* __restrict__ values,  // (nnz, BK, BN)
                           const int* __restrict__ rows,      // (nnz,) block row
                           const int* __restrict__ offsets,   // (n_cols + 1,)
                           float* __restrict__ out, int m, int k, int n) {
  extern __shared__ float4 xs4[];                 // (SMALL_ROWS, k / 4)
  __shared__ float red[THREADS / 32][32];
  const float* xs = reinterpret_cast<const float*>(xs4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col = blockIdx.x * SMALL_COLS;        // first output column
  const int cb = col / BN, c0 = col % BN;
  const int m0 = blockIdx.y * SMALL_ROWS;

  // x's rows arrive by cp.async while the first weights load to registers.
  const int k4 = k / 4;
  for (int e = tid; e < SMALL_ROWS * k4; e += THREADS) {
    const int r = e / k4;
    const bool ok = m0 + r < m;
    cp_async16(&xs4[e], x + (size_t)(ok ? m0 + r : 0) * k + 4 * (e - r * k4),
               ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);

  const int start = offsets[cb];
  const int run_rows = (offsets[cb + 1] - start) * BK;
  float4 w4[SMALL_PREFETCH];
  int kk[SMALL_PREFETCH];
#pragma unroll
  for (int u = 0; u < SMALL_PREFETCH; ++u) {
    const int j = tid + THREADS * u, t = start + j / BK, r = j % BK;
    if (j < run_rows) {
      w4[u] = *reinterpret_cast<const float4*>(
          values + ((size_t)t * BK + r) * BN + c0);
      kk[u] = rows[t] * BK + r;
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  float acc[SMALL_ROWS * 4];                // [row][column]
#pragma unroll
  for (int a = 0; a < SMALL_ROWS * 4; ++a) acc[a] = 0.0f;
  auto fma_row = [&](const float4& w, int kr) {
#pragma unroll
    for (int i = 0; i < SMALL_ROWS; ++i) {
      const float xv = xs[i * k + kr];
      acc[4 * i + 0] = fmaf(xv, w.x, acc[4 * i + 0]);
      acc[4 * i + 1] = fmaf(xv, w.y, acc[4 * i + 1]);
      acc[4 * i + 2] = fmaf(xv, w.z, acc[4 * i + 2]);
      acc[4 * i + 3] = fmaf(xv, w.w, acc[4 * i + 3]);
    }
  };
#pragma unroll
  for (int u = 0; u < SMALL_PREFETCH; ++u)
    if (tid + THREADS * u < run_rows) fma_row(w4[u], kk[u]);
  for (int j = tid + THREADS * SMALL_PREFETCH; j < run_rows; j += THREADS) {
    const int t = start + j / BK, r = j % BK;
    fma_row(*reinterpret_cast<const float4*>(
                values + ((size_t)t * BK + r) * BN + c0),
            rows[t] * BK + r);
  }

  // Recursive halving over the lane bits: at each step a lane keeps the
  // half of its live sums that its bit selects and sends the other half to
  // its partner.  acc[a] holds output (row a / 4, column a % 4); afterwards
  // lane l holds output a = l.  Then the 8 warps, in order.
  halve<16>(acc, lane, 16);
  halve<8>(acc, lane, 8);
  halve<4>(acc, lane, 4);
  halve<2>(acc, lane, 2);
  halve<1>(acc, lane, 1);
  red[warp][lane] = acc[0];
  __syncthreads();
  if (tid < 32) {
    float sum = red[0][tid];
#pragma unroll
    for (int w = 1; w < THREADS / 32; ++w) sum += red[w][tid];
    const int row = m0 + tid / 4;
    if (row < m) out[(size_t)row * n + col + tid % 4] = sum;
  }
}

// ---------------------------------------------------------------------------
// Large M.
// ---------------------------------------------------------------------------

template <int BK, int BN>
__global__ void __launch_bounds__(THREADS)
sparse_matmul_kernel_large(const float* __restrict__ x,
                           const float* __restrict__ values,
                           const int* __restrict__ rows,
                           const int* __restrict__ pieces,  // (P, 5)
                           float* __restrict__ partial,
                           int* __restrict__ counters,
                           float* __restrict__ out, int m, int k, int n) {
  // A ring of LARGE_STAGES stages of x (+4 floats per row: rows 4 apart
  // land 16 banks apart, and float4 reads stay aligned) and of W.
  extern __shared__ float4 ring[];
  typedef float XStage[LARGE_ROWS][KC + 4];
  typedef float WStage[KC][LARGE_COLS];
  XStage* xs = reinterpret_cast<XStage*>(ring);
  WStage* ws = reinterpret_cast<WStage*>(xs + LARGE_STAGES);
  constexpr int SLICES = BN / LARGE_COLS;   // column slices per block-column
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int piece = blockIdx.x / SLICES, slice = blockIdx.x % SLICES;
  const int cb = pieces[5 * piece], start = pieces[5 * piece + 1];
  const int first = pieces[5 * piece + 3], count = pieces[5 * piece + 4];
  const int c0 = slice * LARGE_COLS, col = cb * BN + c0;
  const int m0 = blockIdx.y * LARGE_ROWS;
  const int steps = (pieces[5 * piece + 2] - start) * (BK / KC);

  auto load = [&](int s, int buf) {
    const int t = start + s / (BK / KC), kc = (s % (BK / KC)) * KC;
    const int k0 = rows[t] * BK + kc;
#pragma unroll
    for (int i = 0; i < 2; ++i) {         // x: 64 rows x 32 floats
      const int e = tid + THREADS * i, r = e / 8, q = e % 8;
      const bool ok = m0 + r < m;
      cp_async16(&xs[buf][r][4 * q],
                 x + (size_t)(ok ? m0 + r : 0) * k + k0 + 4 * q, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {         // W: 32 rows x 64 floats
      const int e = tid + THREADS * i, r = e / 16, q = e % 16;
      cp_async16(&ws[buf][r][4 * q],
                 values + ((size_t)t * BK + kc + r) * BN + c0 + 4 * q, true);
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;

#pragma unroll
  for (int s = 0; s < LARGE_STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int s = 0; s < steps; ++s) {
    const int buf = s % LARGE_STAGES;
    asm volatile("cp.async.wait_group %0;\n" ::"n"(LARGE_STAGES - 2));
    __syncthreads();     // stage s has landed; stage s - 1 is consumed
    if (s + LARGE_STAGES - 1 < steps)
      load(s + LARGE_STAGES - 1, (s + LARGE_STAGES - 1) % LARGE_STAGES);
    asm volatile("cp.async.commit_group;\n" ::);
#pragma unroll
    for (int kk = 0; kk < KC; kk += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(&xs[buf][4 * ty + i][kk]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(&ws[buf][kk + j][4 * tx]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][0] = fmaf(av[j], b[j].x, acc[i][0]);
          acc[i][1] = fmaf(av[j], b[j].y, acc[i][1]);
          acc[i][2] = fmaf(av[j], b[j].z, acc[i][2]);
          acc[i][3] = fmaf(av[j], b[j].w, acc[i][3]);
        }
      }
    }
  }

  float4 sum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    sum[i] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  if (count > 1) {
    // A split run: leave this piece's partial tile in `partial`; the
    // column's last block to finish adds the pieces' tiles in piece order
    // (the same bits whichever block is last) and resets the counter.
    auto tile = [&](int p) {
      return partial +
             ((size_t)(p * gridDim.y + blockIdx.y) * SLICES + slice) *
                 (LARGE_ROWS * LARGE_COLS) + (4 * ty) * LARGE_COLS + 4 * tx;
    };
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(tile(piece) + i * LARGE_COLS) = sum[i];
    __threadfence();
    __syncthreads();
    __shared__ bool last;
    if (tid == 0) {
      int* counter =
          counters + ((size_t)cb * SLICES + slice) * gridDim.y + blockIdx.y;
      last = atomicAdd(counter, 1) == count - 1;
      if (last) *counter = 0;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sum[i] = __ldcg(reinterpret_cast<const float4*>(tile(first) +
                                                      i * LARGE_COLS));
      for (int p = first + 1; p < first + count; ++p) {
        const float4 v = __ldcg(
            reinterpret_cast<const float4*>(tile(p) + i * LARGE_COLS));
        sum[i].x += v.x; sum[i].y += v.y; sum[i].z += v.z; sum[i].w += v.w;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + 4 * ty + i;
    if (row < m)
      *reinterpret_cast<float4*>(out + (size_t)row * n + col + 4 * tx) =
          sum[i];
  }
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

template <int BK, int BN>
static int launch(bool large, dim3 grid, const float* x, const float* values,
                  const int* rows, const int* offsets, const int* pieces,
                  float* partial, int* counters, float* out, int m, int k,
                  int n, cudaStream_t s) {
  if (large) {
    static bool configured = false;
    if (!configured) {
      const cudaError_t err = cudaFuncSetAttribute(
          sparse_matmul_kernel_large<BK, BN>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, LARGE_SMEM);
      if (err != cudaSuccess) return (int)err;
      configured = true;
    }
    sparse_matmul_kernel_large<BK, BN><<<grid, THREADS, LARGE_SMEM, s>>>(
        x, values, rows, pieces, partial, counters, out, m, k, n);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)SMALL_ROWS * k * sizeof(float);
  static size_t allowed = 48 * 1024;     // the default dynamic limit
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        sparse_matmul_kernel_small<BK, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  sparse_matmul_kernel_small<BK, BN><<<grid, THREADS, smem, s>>>(
      x, values, rows, offsets, out, m, k, n);
  return (int)cudaGetLastError();
}

// Launches one kernel on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted), or cudaErrorInvalidValue for a block shape without
// an instantiation or a layout the path cannot take.  Small path (`large`
// 0): n / SMALL_COLS column slices x ceil(m / SMALL_ROWS) row tiles.  Large
// path: `n_pieces` x (bn / LARGE_COLS) blocks across (a piece of the work
// list BlockSparseWeight.col_pieces times a column slice) x ceil(m /
// LARGE_ROWS) row tiles; `partial` holds n_pieces x bn floats per
// LARGE_ROWS rows, and `counters` (n / LARGE_COLS) x ceil(m / LARGE_ROWS)
// ints, all 0 (the kernel leaves them 0).  `n` must be a multiple of `bn`,
// `k` of 4, `x` 16-byte aligned, and every tile's rows must lie inside `k`
// (BlockSparseWeight and the wrapper check these).
extern "C" int sparse_matmul_launch(const void* x, const void* values,
                                    const void* rows, const void* offsets,
                                    const void* pieces, void* partial,
                                    void* counters, void* out, int m, int k,
                                    int n, int bk, int bn, int large,
                                    int n_pieces, void* stream) {
  const int cols = large ? LARGE_COLS : SMALL_COLS;
  const int tile_rows = large ? LARGE_ROWS : SMALL_ROWS;
  if (bn % cols != 0 || k % 4 != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(large ? n_pieces * (bn / cols) : n / cols,
                  (m + tile_rows - 1) / tile_rows);
  const cudaStream_t s = (cudaStream_t)stream;
  const float* xp = (const float*)x;
  const float* vp = (const float*)values;
  const int* rp = (const int*)rows;
  const int* op = (const int*)offsets;
  const int* pp = (const int*)pieces;
  float* wp = (float*)partial;
  int* cp = (int*)counters;
  float* outp = (float*)out;
  if (bk == 128 && bn == 128)
    return launch<128, 128>(large, grid, xp, vp, rp, op, pp, wp, cp, outp, m,
                            k, n, s);
  if (bk == 64 && bn == 64)
    return launch<64, 64>(large, grid, xp, vp, rp, op, pp, wp, cp, outp, m, k,
                          n, s);
  return (int)cudaErrorInvalidValue;
}
