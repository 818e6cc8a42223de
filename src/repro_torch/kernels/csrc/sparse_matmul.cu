// Hopper kernel: block-sparse f32 matmul, out = x @ W, visiting only the
// nonzero (BK, BN) tiles of W — the §6.2 "operation skip" made structural.
//
// Replaces src/repro/kernels/sparse_matmul.py::sparse_matmul, the Pallas TPU
// kernel behind repro.kernels.ops.sparse_dense.  The TPU version walks ONE
// sequential grid over the nonzero tiles, sorted by output column; a `first`
// flag zero-initialises each output tile's run, and the wrapper masks the
// columns no tile reached (their output block was never written).  Here the
// runs are parallel: one thread block per (output block-column, BM-row
// M tile) walks its column's run of tiles (built once at plan time by
// core/prune.py::BlockSparseWeight: tiles sorted by column, their block rows
// and per-column offsets), accumulates in registers and writes its output
// tile once.  A block-column pruned whole has an empty run, and its blocks
// write exact zeros: no masking pass, and no uninitialised output exists.
//
// Per tile, the K depth is staged through shared memory KC rows at a time:
// a BM x KC slice of x and a KC x BN slice of the tile.  Thread (tx, ty) of
// 32 x 8 owns rows ty + 8i (i < BM/8) and columns tx + 32j (j < BN/32):
// a warp reads one x value (broadcast) and 32 consecutive weights.
//
// What bounds it on the card: at the §6.2 layer (K 896, N 512) the bytes
// are x, the nonzero tiles and out (M = 8: ~1.8 MB at density 1, ~0.5 us at
// 3.35 TB/s); at M = 1024 the f32 operations, 2 M K N density (0.94 GFLOP at
// density 1, ~14 us at 67 TFLOP/s).  This first version uses plain f32 FMAs
// on the CUDA cores: f32 IEEE, no TF32 (the reference's contract).
// cp.async/TMA staging and a persistent schedule are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define BM 32
#define KC 32
#define THREADS 256   // 32 x 8

template <int BK, int BN>
__global__ void __launch_bounds__(THREADS)
sparse_matmul_kernel(const float* __restrict__ x,
                     const float* __restrict__ values,  // (nnz, BK, BN)
                     const int* __restrict__ rows,      // (nnz,) block rows
                     const int* __restrict__ offsets,   // (n_cols + 1,)
                     float* __restrict__ out, int m, int k, int n) {
  constexpr int TM = BM / 8, TN = BN / 32;
  __shared__ float xs[BM][KC + 1];
  __shared__ float ws[KC][BN];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int col_block = blockIdx.x, row0 = blockIdx.y * BM;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  const int run_end = offsets[col_block + 1];
  for (int t = offsets[col_block]; t < run_end; ++t) {
    const int k0 = rows[t] * BK;
    const float* tile = values + (size_t)t * BK * BN;
    for (int kc = 0; kc < BK; kc += KC) {
      for (int e = threadIdx.x; e < BM * KC; e += THREADS) {
        const int r = e / KC, c = e % KC;
        xs[r][c] = row0 + r < m ? x[(size_t)(row0 + r) * k + k0 + kc + c]
                                : 0.0f;
      }
      for (int e = threadIdx.x; e < KC * BN; e += THREADS) {
        const int r = e / BN, c = e % BN;
        ws[r][c] = tile[(size_t)(kc + r) * BN + c];
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < KC; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = xs[ty + 8 * i][kk];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + 32 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + 8 * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j)
      out[(size_t)r * n + col_block * BN + tx + 32 * j] = acc[i][j];
  }
}

// Launches the kernel on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted), or cudaErrorInvalidValue for a block shape without
// an instantiation.  `n` must be a multiple of `bn` and every tile's rows
// must lie inside `k` (BlockSparseWeight checks both when it is built).
extern "C" int sparse_matmul_launch(const void* x, const void* values,
                                    const void* rows, const void* offsets,
                                    void* out, int m, int k, int n, int bk,
                                    int bn, void* stream) {
  const dim3 grid(n / bn, (m + BM - 1) / BM);
  const cudaStream_t s = (cudaStream_t)stream;
  const float* xp = (const float*)x;
  const float* vp = (const float*)values;
  const int* rp = (const int*)rows;
  const int* op = (const int*)offsets;
  float* outp = (float*)out;
  if (bk == 128 && bn == 128) {
    sparse_matmul_kernel<128, 128><<<grid, THREADS, 0, s>>>(xp, vp, rp, op,
                                                           outp, m, k, n);
  } else if (bk == 64 && bn == 64) {
    sparse_matmul_kernel<64, 64><<<grid, THREADS, 0, s>>>(xp, vp, rp, op,
                                                         outp, m, k, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
