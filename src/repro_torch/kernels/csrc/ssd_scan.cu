// Hopper kernel: the Mamba-2 SSD (state-space duality) chunked scan.
//
//   S_t = exp(dt_t A_h) S_{t-1} + dt_t (x_t ⊗ B_t),   y_t = C_t · S_t
//
// Replaces src/repro/kernels/ssd_scan.py::ssd_scan, the Pallas TPU kernel
// behind repro.kernels.ops.ssd.  The TPU version runs a (heads, chunks) grid
// with the chunk axis sequential, carrying the (P, N) state in VMEM scratch;
// its wrapper repeats the B/C groups to heads and maps over the batch.  Here
// ONE launch covers the batch: one thread block per (head, batch row) loops
// over the chunks in order and carries the state in shared memory, and B/C
// are read by group index h / (H / G) — nothing is repeated to heads.
// Per chunk of L = 128 steps (rows past T are loaded as zeros, and dt = 0
// contributes nothing, so a ragged last chunk needs no padding):
//   s        = cumsum(dt A)                    warp 0, shuffle scan
//   y        = exp(s) · (C Sᵀ)                 inter-chunk readout
//   y       += (exp(s_t - s_τ) ∘ C Bᵀ ∘ dt_τ)_{τ<=t} x      intra-chunk
//   S        = exp(s_L) S + (x ∘ w)ᵀ B,  w_τ = exp(s_L - s_τ) dt_τ
// The L x L product is formed one 32-row query block at a time in shared
// memory (state 32 KB + C 64 KB + B 64 KB + x 32 KB + one 16 KB row block
// = 211 KB at P = 64, N = 128, within the 227 KB a block may have, where the
// whole L x L tile would not fit), and only its causal part: row block rb
// multiplies against the first 32 (rb + 1) keys, 62.5% of the full product.
// The mask is applied before the exponent (τ > t is written as 0, never
// exp'd), as the reference's where(mask, ·, -inf) gives exact zeros.
//
// What bounds it on the card: the f32 operations.  At the serve runs'
// prefill (B 8, T 1024, H 32, P 64, N 128) the causal chunked algorithm does
// ~14 GFLOP per layer (~0.21 ms at 67 TFLOP/s; no readout of the zero state
// in the first chunk, no state update after the last) and moves ~143 MB
// (~43 us at 3.35 TB/s).  This first version runs f32 FMAs on the CUDA
// cores from shared memory (IEEE f32, no TF32, expf and not __expf); one
// 256-thread block per SM (the shared memory), so B H = 256 blocks take two
// waves.
// Tensor-core (wgmma) chunk products and splitting long single sequences
// over more blocks are later work.
//
// Numerics: ops the reference rounds separately (dt * A, exp(s_L) * S + U,
// the scalings) are written with __fmul_rn/__fadd_rn so nvcc cannot
// contract them; the dot products accumulate with fmaf.  The cumsum's
// addition order differs from jnp.cumsum's: the result is held to the
// reference's own tolerance (rtol 2e-4, atol 2e-5).

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int L = 128;       // chunk length
#define THREADS 256

template <int P, int N>
struct SsdSmem {
  static constexpr int kFloats =
      N * P + L * (N + 1) + N * (L + 1) + L * P + 32 * (L + 1) + 4 * L;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

template <int P, int N>
__global__ void __launch_bounds__(THREADS, 1)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ c, float* __restrict__ y, int T,
                int H, int G) {
  constexpr int PJ = P / 16;   // y and state columns per thread
  constexpr int NI = N / 16;   // state rows per thread
  constexpr int YI = L / 16;   // y rows per thread
  constexpr int RB = L / 32;   // query row blocks per chunk
  extern __shared__ float smem[];
  float* St = smem;                   // [N][P]     carried state, transposed
  float* Cs = St + N * P;             // [L][N + 1] C of the chunk
  float* Bt = Cs + L * (N + 1);       // [N][L + 1] B of the chunk, transposed
  float* Xs = Bt + N * (L + 1);       // [L][P]     x of the chunk
  float* Mb = Xs + L * P;             // [32][L + 1] a row block of L x L
  float* sv = Mb + 32 * (L + 1);      // [L] cumulative log-decay s
  float* dtv = sv + L;                // [L] dt
  float* esv = dtv + L;               // [L] exp(s_t)
  float* wv = esv + L;                // [L] exp(s_L - s_t) dt_t

  const int h = blockIdx.x, bi = blockIdx.y, tid = threadIdx.x;
  const int g = h / (H / G);
  const float a_h = a[h];
  // y mapping: rows ty + 16 i, columns tx + 16 j (the state update uses
  // the same split for its rows n and columns p).  CB mapping: rows
  // cy + 8 i of a row block, keys cx + 32 j.
  const int ty = tid / 16, tx = tid % 16;
  const int cy = tid / 32, cx = tid % 32;

  for (int e = tid; e < N * P; e += THREADS) St[e] = 0.0f;

  for (int t0 = 0; t0 < T; t0 += L) {
    __syncthreads();   // the previous chunk's readers are done
    for (int e = tid; e < L; e += THREADS) {
      const int t = t0 + e;
      dtv[e] = t < T ? dt[((size_t)bi * T + t) * H + h] : 0.0f;
    }
    for (int e = tid; e < L * P; e += THREADS) {
      const int r = e / P, p = e % P, t = t0 + r;
      Xs[e] = t < T ? x[(((size_t)bi * T + t) * H + h) * P + p] : 0.0f;
    }
    for (int e = tid; e < L * N; e += THREADS) {
      const int r = e / N, n = e % N, t = t0 + r;
      const size_t src = (((size_t)bi * T + t) * G + g) * N + n;
      Bt[n * (L + 1) + r] = t < T ? b[src] : 0.0f;
      Cs[r * (N + 1) + n] = t < T ? c[src] : 0.0f;
    }
    __syncthreads();

    // -- cumulative log-decay: lane l owns steps 4l .. 4l + 3.
    if (tid < 32) {
      float v[4], run = 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        run = __fadd_rn(run, __fmul_rn(dtv[4 * tid + q], a_h));
        v[q] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl = __fadd_rn(incl, o);
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) sv[4 * tid + q] = __fadd_rn(excl, v[q]);
      __syncwarp();
      const float s_end = sv[L - 1];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int t = 4 * tid + q;
        esv[t] = expf(sv[t]);
        wv[t] = __fmul_rn(expf(__fsub_rn(s_end, sv[t])), dtv[t]);
      }
    }
    __syncthreads();
    const float s_last = sv[L - 1];

    // -- inter-chunk: y = exp(s) (C Sᵀ); zero while the state is.
    float acc[YI][PJ];
#pragma unroll
    for (int i = 0; i < YI; ++i)
#pragma unroll
      for (int j = 0; j < PJ; ++j) acc[i][j] = 0.0f;
    if (t0 > 0) {
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[YI], sn[PJ];
#pragma unroll
        for (int i = 0; i < YI; ++i) cv[i] = Cs[(ty + 16 * i) * (N + 1) + n];
#pragma unroll
        for (int j = 0; j < PJ; ++j) sn[j] = St[n * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < YI; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j)
            acc[i][j] = fmaf(cv[i], sn[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < YI; ++i) {
        const float e = esv[ty + 16 * i];
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] = __fmul_rn(e, acc[i][j]);
      }
    }

    // -- intra-chunk, one 32-row query block at a time (causal keys only).
#pragma unroll
    for (int rb = 0; rb < RB; ++rb) {
      float cb[4][RB];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < RB; ++j) cb[i][j] = 0.0f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cq[4], bk[RB];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cq[i] = Cs[(32 * rb + cy + 8 * i) * (N + 1) + n];
#pragma unroll
        for (int j = 0; j < RB; ++j)
          if (j <= rb) bk[j] = Bt[n * (L + 1) + cx + 32 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < RB; ++j)
            if (j <= rb) cb[i][j] = fmaf(cq[i], bk[j], cb[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = 32 * rb + cy + 8 * i;
        const float sq = sv[q];
#pragma unroll
        for (int j = 0; j < RB; ++j) {
          if (j > rb) continue;
          const int tau = cx + 32 * j;
          Mb[(cy + 8 * i) * (L + 1) + tau] =
              tau <= q ? __fmul_rn(__fmul_rn(expf(__fsub_rn(sq, sv[tau])),
                                             cb[i][j]),
                                   dtv[tau])
                       : 0.0f;
        }
      }
      __syncthreads();
      for (int tau = 0; tau < 32 * (rb + 1); ++tau) {
        float xv[PJ];
#pragma unroll
        for (int j = 0; j < PJ; ++j) xv[j] = Xs[tau * P + tx + 16 * j];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float mv = Mb[(ty + 16 * e) * (L + 1) + tau];
#pragma unroll
          for (int j = 0; j < PJ; ++j)
            acc[2 * rb + e][j] = fmaf(mv, xv[j], acc[2 * rb + e][j]);
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < YI; ++i) {
      const int t = t0 + ty + 16 * i;
      if (t >= T) continue;
#pragma unroll
      for (int j = 0; j < PJ; ++j)
        y[(((size_t)bi * T + t) * H + h) * P + tx + 16 * j] = acc[i][j];
    }

    // -- state update (not needed after the last chunk).
    if (t0 + L >= T) break;
    float upd[NI][PJ];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < PJ; ++j) upd[i][j] = 0.0f;
#pragma unroll 4
    for (int tau = 0; tau < L; ++tau) {
      const float w = wv[tau];
      float xw[PJ], bv[NI];
#pragma unroll
      for (int j = 0; j < PJ; ++j)
        xw[j] = __fmul_rn(Xs[tau * P + tx + 16 * j], w);
#pragma unroll
      for (int i = 0; i < NI; ++i) bv[i] = Bt[(ty + 16 * i) * (L + 1) + tau];
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) upd[i][j] = fmaf(bv[i], xw[j], upd[i][j]);
    }
    const float decay = expf(s_last);
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < PJ; ++j) {
        float* s = &St[(ty + 16 * i) * P + tx + 16 * j];
        *s = __fadd_rn(__fmul_rn(decay, *s), upd[i][j]);
      }
  }
}

template <int P, int N>
static int launch(const float* x, const float* dt, const float* a,
                  const float* b, const float* c, float* y, int B, int T,
                  int H, int G, cudaStream_t stream) {
  const size_t bytes = SsdSmem<P, N>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<P, N><<<dim3(H, B), THREADS, bytes, stream>>>(
      x, dt, a, b, c, y, T, H, G);
  return (int)cudaGetLastError();
}

// Launches the kernel on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted), or cudaErrorInvalidValue for a (P, N) without an
// instantiation.  x (B, T, H, P), dt (B, T, H), a (H,), b/c (B, T, G, N),
// y (B, T, H, P), all contiguous f32; H must divide by G (the wrapper checks).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a,
                               const void* b, const void* c, void* y, int B,
                               int T, int H, int G, int P, int N,
                               void* stream) {
  const float *xp = (const float*)x, *dtp = (const float*)dt,
              *ap = (const float*)a, *bp = (const float*)b,
              *cp = (const float*)c;
  float* yp = (float*)y;
  const cudaStream_t s = (cudaStream_t)stream;
#define SSD_CASE(PP, NN)                                                   \
  if (P == PP && N == NN)                                                  \
    return launch<PP, NN>(xp, dtp, ap, bp, cp, yp, B, T, H, G, s);
  SSD_CASE(64, 128)
  SSD_CASE(64, 64)
  SSD_CASE(32, 128)
  SSD_CASE(32, 32)
#undef SSD_CASE
  return (int)cudaErrorInvalidValue;
}
