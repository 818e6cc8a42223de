// Hopper kernel: int8 x int8 -> int32 GEMM with the fused dequantization
// epilogue, out = f32(xq @ wq) * scale + bias.
//
// Replaces src/repro/kernels/qmatmul.py::qmatmul, the Pallas TPU kernel
// behind repro.kernels.ops.quantized_matmul.  The TPU version walks a
// sequential K grid, carrying an int32 accumulator in VMEM scratch and
// applying the epilogue on the last K step.  Here each thread block owns a
// BM x BN output tile, loops over K in BK-deep shared-memory tiles of xq and
// wq (zero-filled past the ragged edges), keeps a 2 x 2 int32 accumulator
// per thread in registers and applies the epilogue once at the end.
//
// What bounds it on the card: bytes.  The per-layer fleet step's widest
// call, (M, K, N) = (1024, 400, 64), reads 410 KB of xq and 25.6 KB of wq
// and writes 262 KB of f32 output, ~0.7 MB or ~0.2 us at 3.35 TB/s; its
// 52 M int8 operations take ~0.03 us at the int8 peak.  This first version
// uses plain int multiply-adds; wgmma/TMA versions are later work.
//
// Numerics: int32 accumulation is exact; the epilogue is
// __fadd_rn(__fmul_rn((float)acc, scale), bias), two separately rounded f32
// operations that nvcc cannot contract into an FMA.

#include <cuda_runtime.h>
#include <stdint.h>

#define BM 32
#define BN 32
#define BK 32
#define THREADS 256   // 16 x 16 threads, 2 x 2 outputs each

__global__ void __launch_bounds__(THREADS)
qmatmul_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
               const float* __restrict__ scale,
               const float* __restrict__ bias, float* __restrict__ out,
               int m, int n, int k) {
  // +4 bytes of padding per row keeps the column reads of xs off one bank.
  __shared__ int8_t xs[BM][BK + 4];
  __shared__ int8_t ws[BK][BN + 4];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  int acc[2][2] = {{0, 0}, {0, 0}};

  for (int kt = 0; kt < k; kt += BK) {
    for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      xs[r][c] = (row0 + r < m && kt + c < k)
                     ? xq[(size_t)(row0 + r) * k + kt + c] : (int8_t)0;
    }
    for (int i = threadIdx.x; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      ws[r][c] = (kt + r < k && col0 + c < n)
                     ? wq[(size_t)(kt + r) * n + col0 + c] : (int8_t)0;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const int a0 = xs[ty * 2][kk], a1 = xs[ty * 2 + 1][kk];
      const int b0 = ws[kk][tx * 2], b1 = ws[kk][tx * 2 + 1];
      acc[0][0] += a0 * b0;
      acc[0][1] += a0 * b1;
      acc[1][0] += a1 * b0;
      acc[1][1] += a1 * b1;
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + ty * 2 + i;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = col0 + tx * 2 + j;
      if (r < m && c < n) {
        float y = __fmul_rn(__int2float_rn(acc[i][j]), scale[c]);
        if (bias != nullptr) y = __fadd_rn(y, bias[c]);
        out[(size_t)r * n + c] = y;
      }
    }
  }
}

// Launches the kernel on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted).  `bias` may be null.
extern "C" int qmatmul_launch(const void* xq, const void* wq,
                              const void* scale, const void* bias, void* out,
                              int m, int n, int k, void* stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  qmatmul_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)xq, (const int8_t*)wq, (const float*)scale,
      (const float*)bias, (float*)out, m, n, k);
  return (int)cudaGetLastError();
}
