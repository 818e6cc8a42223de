// Hopper kernel: the Mamba-2 SSD (state-space duality) chunked scan.
//
//   S_t = exp(dt_t A_h) S_{t-1} + dt_t (x_t ⊗ B_t),   y_t = C_t · S_t
//
// Replaces src/repro/kernels/ssd_scan.py::ssd_scan, the Pallas TPU kernel
// behind repro.kernels.ops.ssd.  The TPU version runs a (heads, chunks) grid
// with the chunk axis sequential, carrying the (P, N) state in VMEM scratch;
// its wrapper repeats the B/C groups to heads and maps over the batch.  Here
// ONE launch covers the batch: one 512-thread block per (head, batch row,
// 64-column slice of P) loops over the chunks in order and carries its rows
// of the state in shared memory, and B/C are read by group index h / (H / G)
// — nothing is repeated to heads.
// The block also writes the final state S_T, (B, H, P, N) f32, the layout of
// the decode cache's ssm arena, so the prefill needs no second pass for it.
//
// Per chunk of L = 64 steps (rows past T load as zeros with dt = 0, which
// contribute nothing, so a ragged last chunk needs no padding and the state
// after it is exactly S_T):
//   s        = cumsum(dt A)                    warp 0, shuffle scan
//   y        = exp(s) · (C Sᵀ)                 inter-chunk readout
//   y       += (exp(s_t - s_τ) ∘ C Bᵀ ∘ dt_τ)_{τ<=t} x      intra-chunk
//   S        = exp(s_L) S + (x ∘ w)ᵀ B,  w_τ = exp(s_L - s_τ) dt_τ
// in three phases split by two barriers:
//   1. C Bᵀ over the causal 16 x 16 strips (10 warps) and C Sᵀ (one 16 x 16
//      strip of y per warp) — neither needs s — while warp 0 also runs the
//      scan;
//   2. the masked decay built on the C Bᵀ accumulators in registers and
//      stored as the L x L matrix M (masked before the exponent: τ > t is
//      written as 0, never exp'd), y scaled by exp(s), and the state update
//      (one 16 x 32 strip of S per warp) written in place;
//   3. y += M x over the causal keys only, stored.
//
// What bounds it on the card: the operations.  At the serve runs' prefill
// (B 8, T 1024, H 32, P 64, N 128) the chunked algorithm at L = 64 does
// ~11.6 GFLOP per layer; every product runs on the tensor cores as
// mma.sync m16n8k8 in 3xTF32 (below), three products each, so the bound is
// 3 x 11.6 GFLOP at 495 TFLOP/s, ~0.070 ms; the bytes (~152 MB with the
// state out, f32 inputs) take ~0.045 ms.  The design against the bottlenecks
// of the CUDA-core version:
//   * tensor cores: each f32 operand v is split into hi = tf32(v) and
//     lo = tf32(v - hi), and a b = a_lo b_hi + a_hi b_lo + a_hi b_hi is
//     accumulated in f32 (CUTLASS's fast-accurate f32 mode): ~21 bits of
//     each operand, held to the reference's f32 tolerance.  Plain TF32
//     (three digits) would not be.  bf16 inputs are tf32 numbers already:
//     their lo is 0, and the products with it are skipped (C Bᵀ then takes
//     one pass, the other three products two).
//   * occupancy: 16 warps per SM (one block of 512 threads, 219 KB of
//     shared memory at P 64, N 128), every warp with tensor-core work in
//     every phase;
//   * overlap: chunk k+1's x, B, C and dt are in flight (cp.async, 16 bytes
//     a thread for x/B/C) while chunk k computes — two stages in shared
//     memory — and C Bᵀ runs beside the scan;
//   * fragment loads: row strides padded so that every mma operand load is
//     free of bank conflicts but the state update's B reads (two-way in
//     f32).
//
// Inputs x, B and C are read where they lie: views with a batch and a row
// stride (the conv output's channels, unsliced), f32 or bf16, converted to
// f32 exactly when a fragment is loaded.  dt is (B, T, H) contiguous f32.
//
// Numerics: ops the reference rounds separately (dt * A, exp(s_L) * S + U,
// the scalings) are written with __fmul_rn/__fadd_rn so nvcc cannot
// contract them; expf, not __expf.  Because every float op after the
// conversion is explicit, a call on bf16 inputs gives the bits of the same
// call on their f32 copies.  The cumsum's and the products' summation
// orders differ from the reference's: the result is held to the reference's
// own tolerance (rtol 2e-4, atol 2e-5).
//
// Head dims past 64 (Jamba's P 128): the grid's third axis splits P into
// slices of the instantiated tile width (64).  Column p of y and row p of the
// state depend on column p of x alone (with the shared B, C and dt), so each
// slice is exactly the P-64 computation on x[..., p0:p0 + 64]; a slice block
// recomputes the scan and C Bᵀ, which are small beside its (L, P) products,
// and shared memory stays the (64, N) instantiation's (219 KB in f32 at
// N 128; a whole P = N = 128 block would need 291 KB, over the 227 KB a block
// may have).  x's and y's head stride and the state's row count are the
// whole P (`PH`), the tile's column offset blockIdx.z * 64.
//
// Left for later: wgmma (tf32 wants K-major operands), TMA, and splitting a
// single long sequence over more blocks (B x H x P / 64 blocks only).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pipeline.cuh"

constexpr int L = 64;          // the kernel's chunk length
constexpr int WARPS = 16;
constexpr int THREADS = 32 * WARPS;
constexpr int CB_STRIPS = (L / 16) * (L / 16 + 1) / 2;   // causal 16 x 16

// Shared-memory layout for input type T.  Row strides (in elements) keep
// the fragment loads conflict-free: a row-indexed operand read (row g, col
// t) wants a stride of 4 words mod 32, a k-indexed one (row t, col g) 8.
template <typename T, int P, int N>
struct Smem {
  static constexpr int XS = P + 8;                           // x rows
  static constexpr int BS = N + (sizeof(T) == 4 ? 4 : 8);    // B and C rows
  static constexpr int SS = N + 4;                           // state rows
  static constexpr int MS = L + 4;                           // M rows
  static constexpr size_t kStage =
      (size_t)L * (XS + 2 * BS) * sizeof(T) + L * sizeof(float);
  static constexpr size_t kBytes =
      2 * kStage + sizeof(float) * ((size_t)P * SS + L * MS + 3 * L);
  static_assert(kStage % 16 == 0, "stages must stay 16-byte aligned");
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 4-byte copy (dt: one value per step, H apart in global memory).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

// ---- 3xTF32 mma.sync m16n8k8 ----------------------------------------------

struct FragA { uint32_t hi[4], lo[4]; };
struct FragB { uint32_t hi[2], lo[2]; };

// hi = v rounded to the nearest tf32 (ties away from zero) by an integer
// add and mask, lo = v - hi (exact in f32; the mma reads the tf32 part of
// it).  Three instructions where cvt.rna.tf32.f32 costs several more, and
// the product's error stays within the reference's f32 tolerance.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(v, __uint_as_float(hi)));
}

// An operand is EXACT when its values are tf32 numbers already (bf16
// inputs, whose 8 mantissa bits fit tf32's 10): its lo part is 0, so the
// split and the products with lo are skipped.  They would add exact zeros,
// so skipping them leaves every bit of the result as it was.
template <bool EXACT>
__device__ __forceinline__ void split_to(float v, uint32_t& hi, uint32_t& lo) {
  if (EXACT)
    hi = __float_as_uint(v);
  else
    split(v, hi, lo);
}

// A fragment of a 16 x 8 tile whose element (row, col) is at(row, col):
// lane (g, t) = (lane / 4, lane % 4) holds (g, t), (g+8, t), (g, t+4),
// (g+8, t+4).
template <bool EXACT, typename F>
__device__ __forceinline__ FragA load_a(F at, int g, int t) {
  FragA f;
  split_to<EXACT>(at(g, t), f.hi[0], f.lo[0]);
  split_to<EXACT>(at(g + 8, t), f.hi[1], f.lo[1]);
  split_to<EXACT>(at(g, t + 4), f.hi[2], f.lo[2]);
  split_to<EXACT>(at(g + 8, t + 4), f.hi[3], f.lo[3]);
  return f;
}

// B fragment of an 8 x 8 tile, element (k, n) at at(k, n): (t, g), (t+4, g).
template <bool EXACT, typename F>
__device__ __forceinline__ FragB load_b(F at, int g, int t) {
  FragB f;
  split_to<EXACT>(at(t, g), f.hi[0], f.lo[0]);
  split_to<EXACT>(at(t + 4, g), f.hi[1], f.lo[1]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b: the two small cross terms first (those with an EXACT operand's
// zero lo skipped), then hi · hi.
template <bool EXACT_A, bool EXACT_B>
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  if (!EXACT_A) mma_tf32(d, a.lo, b.hi);
  if (!EXACT_B) mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// ---- the kernel -------------------------------------------------------------

template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS, 1)
ssd_scan_kernel(const T* __restrict__ x, long long x_sb, long long x_st,
                const float* __restrict__ dt, const float* __restrict__ a,
                const T* __restrict__ b, long long b_sb, long long b_st,
                const T* __restrict__ c, long long c_sb, long long c_st,
                float* __restrict__ y, float* __restrict__ state, int T_len,
                int H, int G, int PH) {
  using S_ = Smem<T, P, N>;
  constexpr bool IN = sizeof(T) == 2;   // x, B and C exact in tf32 (bf16)
  constexpr int XS = S_::XS, BS = S_::BS, SS = S_::SS, MS = S_::MS;
  constexpr int PG = P / 16;                 // 16-column groups of y
  constexpr int NY = (L / 16) * PG;          // y strips (16 x 16)
  constexpr int NG = N / 32;                 // 32-column groups of S
  constexpr int NS = PG * NG;                // state strips (16 x 32)
  constexpr int XV = P * (int)sizeof(T) / 16;    // 16-byte pieces per row
  constexpr int BV = N * (int)sizeof(T) / 16;
  constexpr int EV = 16 / (int)sizeof(T);        // elements per piece
  static_assert(NY <= WARPS && NS <= WARPS && CB_STRIPS <= WARPS,
                "one strip per warp per phase");
  extern __shared__ __align__(16) unsigned char smem[];
  float* St = (float*)(smem + 2 * S_::kStage);   // [P][SS] carried state
  float* Mb = St + P * SS;                       // [L][MS] masked C Bᵀ
  float* sv = Mb + L * MS;                       // [L] cumulative log-decay
  float* esv = sv + L;                           // [L] exp(s_t)
  float* wv = esv + L;                           // [L] exp(s_L - s_t) dt_t

  // Head h, batch row bi, columns [p0, p0 + P) of the head's PH.
  const int h = blockIdx.x, bi = blockIdx.y, p0 = blockIdx.z * P;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g8 = lane / 4, t4 = lane % 4;
  const int grp = h / (H / G);
  const float a_h = a[h];
  const T* xb = x + bi * x_sb + (long long)h * PH + p0;
  const T* bb = b + bi * b_sb + grp * N;
  const T* cb_ = c + bi * c_sb + grp * N;
  const float* dtb = dt + (size_t)bi * T_len * H + h;

  // Warp roles.  y strip (yi, yj): rows 16 yi, columns 16 yj.  C Bᵀ strip
  // (ci, cj), cj <= ci, on the last CB_STRIPS warps (warp 0 runs the scan).
  // State strip (si, sj): rows p 16 si, columns n 32 sj.
  const bool has_y = warp < NY;
  const int yi = warp / PG, yj = warp % PG;
  const int cw = warp - (WARPS - CB_STRIPS);
  const bool has_cb = cw >= 0;
  int ci = 0;
  while (has_cb && (ci + 1) * (ci + 2) / 2 <= cw) ++ci;
  const int cj = cw - ci * (ci + 1) / 2;
  const bool has_s = warp < NS;
  const int si = warp / NG, sj = warp % NG;

  auto stage = [&](int k) { return smem + (k & 1) * S_::kStage; };
  auto load_chunk = [&](int k) {
    T* Xs = (T*)stage(k);
    T* Bs = Xs + L * XS;
    T* Cs = Bs + L * BS;
    float* dts = (float*)(Cs + L * BS);
    const int t0 = k * L;
    for (int e = tid; e < L * XV; e += THREADS) {
      const int r = e / XV, v = e % XV, t = t0 + r;
      cp_async16(Xs + r * XS + v * EV, xb + (t < T_len ? t : 0) * x_st + v * EV,
                 t < T_len);
    }
    for (int e = tid; e < L * BV; e += THREADS) {
      const int r = e / BV, v = e % BV, t = t0 + r;
      const long long tt = t < T_len ? t : 0;
      cp_async16(Bs + r * BS + v * EV, bb + tt * b_st + v * EV, t < T_len);
      cp_async16(Cs + r * BS + v * EV, cb_ + tt * c_st + v * EV, t < T_len);
    }
    for (int e = tid; e < L; e += THREADS) {
      const int t = t0 + e;
      cp_async4(dts + e, dtb + (size_t)(t < T_len ? t : 0) * H, t < T_len);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  for (int e = tid; e < P * SS; e += THREADS) St[e] = 0.0f;
  const int n_chunks = (T_len + L - 1) / L;
  load_chunk(0);

  for (int k = 0; k < n_chunks; ++k) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();   // chunk k has landed; chunk k-1's readers are done
    if (k + 1 < n_chunks) load_chunk(k + 1);
    const T* Xs = (const T*)stage(k);
    const T* Bs = Xs + L * XS;
    const T* Cs = Bs + L * BS;
    const float* dts = (const float*)(Cs + L * BS);

    // -- phase 1: the scan; C Sᵀ (zero while the state is); C Bᵀ.
    if (warp == 0) {
      const float v0 = __fmul_rn(dts[2 * lane], a_h);
      const float v1 = __fmul_rn(dts[2 * lane + 1], a_h);
      const float pair = __fadd_rn(v0, v1);
      float incl = pair;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl = __fadd_rn(incl, o);
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.0f;
      const float s0 = __fadd_rn(excl, v0), s1 = __fadd_rn(excl, pair);
      const float s_end = __shfl_sync(0xffffffffu, s1, 31);
      sv[2 * lane] = s0;
      sv[2 * lane + 1] = s1;
      esv[2 * lane] = expf(s0);
      esv[2 * lane + 1] = expf(s1);
      wv[2 * lane] = __fmul_rn(expf(__fsub_rn(s_end, s0)), dts[2 * lane]);
      wv[2 * lane + 1] =
          __fmul_rn(expf(__fsub_rn(s_end, s1)), dts[2 * lane + 1]);
    }
    float yacc[2][4] = {};
    if (has_y && k > 0) {
#pragma unroll 4
      for (int kk = 0; kk < N; kk += 8) {
        const FragA fa = load_a<IN>(
            [&](int r, int q) { return to_f32(Cs[(16 * yi + r) * BS + kk + q]); },
            g8, t4);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const FragB fb = load_b<false>(
              [&](int r, int q) {
                return St[(16 * yj + 8 * nt + q) * SS + kk + r];
              },
              g8, t4);
          mma3<IN, false>(yacc[nt], fa, fb);
        }
      }
    }
    float cbacc[2][4] = {};
    if (has_cb) {
#pragma unroll 4
      for (int kk = 0; kk < N; kk += 8) {
        const FragA fa = load_a<IN>(
            [&](int r, int q) { return to_f32(Cs[(16 * ci + r) * BS + kk + q]); },
            g8, t4);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const FragB fb = load_b<IN>(
              [&](int r, int q) {
                return to_f32(Bs[(16 * cj + 8 * nt + q) * BS + kk + r]);
              },
              g8, t4);
          mma3<IN, IN>(cbacc[nt], fa, fb);
        }
      }
    }
    __syncthreads();   // s, exp(s) and w are in shared memory

    // -- phase 2: y = exp(s) (C Sᵀ); M; the state update in place (every
    // reader of the old state finished in phase 1).
    if (has_y && k > 0) {
      const float e0 = esv[16 * yi + g8], e1 = esv[16 * yi + g8 + 8];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        yacc[nt][0] = __fmul_rn(e0, yacc[nt][0]);
        yacc[nt][1] = __fmul_rn(e0, yacc[nt][1]);
        yacc[nt][2] = __fmul_rn(e1, yacc[nt][2]);
        yacc[nt][3] = __fmul_rn(e1, yacc[nt][3]);
      }
    }
    if (has_cb) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int q = 16 * ci + g8 + 8 * half;
          const int tau = 16 * cj + 8 * nt + 2 * t4;
          const float sq = sv[q];
          float m[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            m[e] = tau + e <= q
                       ? __fmul_rn(__fmul_rn(expf(__fsub_rn(sq, sv[tau + e])),
                                             cbacc[nt][2 * half + e]),
                                   dts[tau + e])
                       : 0.0f;
          *(float2*)&Mb[q * MS + tau] = make_float2(m[0], m[1]);
        }
    }
    if (has_s) {
      float up[4][4] = {};
#pragma unroll 2
      for (int kk = 0; kk < L; kk += 8) {
        const FragA fa = load_a<false>(
            [&](int r, int q) {
              return __fmul_rn(to_f32(Xs[(kk + q) * XS + 16 * si + r]),
                               wv[kk + q]);
            },
            g8, t4);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const FragB fb = load_b<IN>(
              [&](int r, int q) {
                return to_f32(Bs[(kk + r) * BS + 32 * sj + 8 * nt + q]);
              },
              g8, t4);
          mma3<false, IN>(up[nt], fa, fb);
        }
      }
      const float decay = expf(sv[L - 1]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float2* s = (float2*)&St[(16 * si + g8 + 8 * half) * SS + 32 * sj +
                                   8 * nt + 2 * t4];
          float2 v = *s;
          v.x = __fadd_rn(__fmul_rn(decay, v.x), up[nt][2 * half]);
          v.y = __fadd_rn(__fmul_rn(decay, v.y), up[nt][2 * half + 1]);
          *s = v;
        }
    }
    __syncthreads();   // M is in shared memory

    // -- phase 3: y += M x over the causal keys; store.
    if (has_y) {
      for (int kk = 0; kk < 16 * (yi + 1); kk += 8) {
        const FragA fa = load_a<false>(
            [&](int r, int q) { return Mb[(16 * yi + r) * MS + kk + q]; }, g8,
            t4);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const FragB fb = load_b<IN>(
              [&](int r, int q) {
                return to_f32(Xs[(kk + r) * XS + 16 * yj + 8 * nt + q]);
              },
              g8, t4);
          mma3<false, IN>(yacc[nt], fa, fb);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = k * L + 16 * yi + g8 + 8 * half;
        if (t >= T_len) continue;
        float* row = y + (((size_t)bi * T_len + t) * H + h) * PH + p0 +
                     16 * yj + 2 * t4;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          *(float2*)(row + 8 * nt) =
              make_float2(yacc[nt][2 * half], yacc[nt][2 * half + 1]);
      }
    }
  }

  if (state != nullptr) {
    __syncthreads();   // the last state update is done
    float* out = state + (((size_t)bi * H + h) * PH + p0) * N;
    for (int e = tid; e < P * N / 4; e += THREADS) {
      const int p = e / (N / 4), n = 4 * (e % (N / 4));
      *(float4*)(out + p * N + n) = *(const float4*)(St + p * SS + n);
    }
  }
}

template <typename T, int P, int N>
static int launch(const void* x, long long x_sb, long long x_st,
                  const float* dt, const float* a, const void* b,
                  long long b_sb, long long b_st, const void* c,
                  long long c_sb, long long c_st, float* y, float* state,
                  int B, int T_len, int H, int G, int PH,
                  cudaStream_t stream) {
  const size_t bytes = Smem<T, P, N>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<T, P, N><<<dim3(H, B, PH / P), THREADS, bytes, stream>>>(
      (const T*)x, x_sb, x_st, dt, a, (const T*)b, b_sb, b_st, (const T*)c,
      c_sb, c_st, y, state, T_len, H, G, PH);
  return (int)cudaGetLastError();
}

// Launches the kernel on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted), or cudaErrorInvalidValue for a (P, N) without an
// instantiation (P 128 runs the P-64 instantiation on two column slices).
// x (B, T, H, P) and b/c (B, T, G, N) in f32 (bf16 == 0) or
// bf16 (bf16 == 1), each with element strides `*_sb` (batch) and `*_st`
// (step) and its last two dimensions packed, every row 16-byte aligned;
// dt (B, T, H) and a (H,) contiguous f32; y (B, T, H, P) contiguous f32;
// state (B, H, P, N) contiguous f32, or null for no state.  H must divide
// by G (the wrapper checks).
extern "C" int ssd_scan_launch(const void* x, long long x_sb, long long x_st,
                               const void* dt, const void* a, const void* b,
                               long long b_sb, long long b_st, const void* c,
                               long long c_sb, long long c_st, void* y,
                               void* state, int bf16, int B, int T, int H,
                               int G, int P, int N, void* stream) {
  const float *dtp = (const float*)dt, *ap = (const float*)a;
  float *yp = (float*)y, *sp = (float*)state;
  const cudaStream_t s = (cudaStream_t)stream;
// SSD_CASE(type, P, N, tile): (P, N) runs the (tile, N) instantiation on
// P / tile column slices of each head.
#define SSD_CASE(TT, PP, NN, TILE)                                           \
  if (P == PP && N == NN)                                                    \
    return launch<TT, TILE, NN>(x, x_sb, x_st, dtp, ap, b, b_sb, b_st, c,    \
                                c_sb, c_st, yp, sp, B, T, H, G, P, s);
#define SSD_SHAPES(TT)                                                       \
  SSD_CASE(TT, 64, 128, 64)                                                  \
  SSD_CASE(TT, 128, 128, 64)                                                 \
  SSD_CASE(TT, 64, 64, 64)                                                   \
  SSD_CASE(TT, 32, 128, 32)                                                  \
  SSD_CASE(TT, 32, 32, 32)
  if (bf16) {
    SSD_SHAPES(__nv_bfloat16)
  } else {
    SSD_SHAPES(float)
  }
#undef SSD_SHAPES
#undef SSD_CASE
  return (int)cudaErrorInvalidValue;
}
