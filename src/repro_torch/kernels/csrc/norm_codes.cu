// Hopper kernel: an RMSNorm row that feeds a SINT projection, written out as
// the projection's int8 input codes.
//
// Replaces no TPU kernel: the reference leaves these passes to XLA, which
// fuses the norm and the quantize into one loop over each row.  Run eagerly
// they are 11 to 15 launches a row, each writing a full-size f32 or bf16
// intermediate that only the next one reads, and the codes at the end that
// only qmatmul reads.  Two sites of the Mamba-2 full-sequence mixer
// (models/mamba2.py) take this kernel: the block's pre-norm feeding in_proj,
// and the gated norm feeding out_proj.  Per row of width W, one block:
//
//   u = x                                              (the pre-norm)
//   u = T(y + d_skip[c / headdim] * f32(xs))           (GATED: y f32,
//   u = T(u * T(silu(z)))                               then the gate)
//   n = T(u * rsqrt(sum(u^2) * (1 / W) + eps) * g)
//   codes = int8(clamp(rint(n / x_scale), -127, 127))
//
// T is the working type (bf16 or f32) and each T(...) is the rounding one of
// the eager chain's casts makes.  Every multiply, add and divide is rounded
// on its own (__fmul_rn, __fadd_rn, __fdiv_rn: nothing contracts into an
// FMA), silu is z / (1 + expf(-z)) as PyTorch computes it, rint rounds half
// to even as torch.round does, and x_scale is read from device memory.  Only
// the order of the row's sum of squares differs from torch.mean's.
//
// What bounds it on the card: bytes.  At the mamba2-370m docs prefill (M =
// 65,536 rows) the gated site reads y (f32), xs and z (bf16) and writes the
// codes: 1.21 GB, 0.36 ms at 3.35 TB/s; the pre-norm site reads the bf16
// residual and writes the codes, 0.20 GB.  The design keeps every row on chip
// between its two passes: a block reads the row once, keeps u in shared
// memory (each thread reads back only what it wrote, laid out so that a warp
// touches 32 consecutive words), reduces the sum of squares in registers,
// warp shuffles and one shared-memory step, then writes eight codes a thread
// at a time.  Loads are 16 bytes a thread where the widths, the strides and
// the pointers allow it (the VEC instance), element-wise otherwise.  xs and
// z are read where they lie, as views with a row stride (the conv output's
// and in_proj output's channels).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int CHUNK = 8;            // consecutive columns a thread takes
constexpr int MAX_THREADS = 1024;
constexpr int DEFAULT_SMEM = 48 * 1024;
constexpr float QMAX = 127.f;

struct Args {
  const void* x;
  long long x_stride;
  const void* xs;
  long long xs_stride;
  const float* d_skip;
  int headdim;
  const void* z;
  long long z_stride;
  const float* g;
  const float* x_scale;
  float eps;
  float inv_width;
  int8_t* out;
  int width;
};

template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The CHUNK values at p as f32.  VEC: 16-byte loads (p 16-byte aligned, a
// whole chunk in range); otherwise the first `count` element by element and
// zeros after them.
template <bool VEC>
__device__ __forceinline__ void load(const float* p, int count,
                                     float (&v)[CHUNK]) {
  if (VEC) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < CHUNK; ++e) v[e] = e < count ? p[e] : 0.f;
  }
}

template <bool VEC>
__device__ __forceinline__ void load(const __nv_bfloat16* p, int count,
                                     float (&v)[CHUNK]) {
  if (VEC) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // element 2i in the low half
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int e = 0; e < CHUNK; ++e)
      v[e] = e < count ? __bfloat162float(p[e]) : 0.f;
  }
}

// One block per row.  Thread t takes the chunks starting at columns
// (t + k * blockDim.x) * CHUNK, k = 0, 1, ...; value e of its k-th chunk sits
// at row[(k * CHUNK + e) * blockDim.x + t].
template <typename T, bool GATED, bool VEC>
__global__ void norm_codes_kernel(Args a) {
  using In = typename std::conditional<GATED, float, T>::type;
  extern __shared__ float row[];
  __shared__ float warp_sums[MAX_THREADS / 32];
  __shared__ float inv_rms;
  const long long r = blockIdx.x;
  const int w = a.width, t = threadIdx.x, nt = blockDim.x;
  const In* x = static_cast<const In*>(a.x) + r * a.x_stride;

  float sq = 0.f;
  for (int k = 0, c0 = t * CHUNK; c0 < w; ++k, c0 += nt * CHUNK) {
    const int count = min(CHUNK, w - c0);
    float u[CHUNK];
    load<VEC>(x + c0, count, u);
    if (GATED) {
      const T* xs = static_cast<const T*>(a.xs) + r * a.xs_stride;
      const T* z = static_cast<const T*>(a.z) + r * a.z_stride;
      float v[CHUNK], zv[CHUNK];
      load<VEC>(xs + c0, count, v);
      load<VEC>(z + c0, count, zv);
#pragma unroll
      for (int e = 0; e < CHUNK; ++e) {
        const float d = __ldg(a.d_skip + min(c0 + e, w - 1) / a.headdim);
        const float s =
            round_to<T>(__fdiv_rn(zv[e], __fadd_rn(1.f, expf(-zv[e]))));
        u[e] = round_to<T>(__fmul_rn(
            round_to<T>(__fadd_rn(u[e], __fmul_rn(d, v[e]))), s));
      }
    }
#pragma unroll
    for (int e = 0; e < CHUNK; ++e) {
      if (e < count) {
        row[(k * CHUNK + e) * nt + t] = u[e];
        sq = __fadd_rn(sq, __fmul_rn(u[e], u[e]));
      }
    }
  }

  const int warp = t / 32, lane = t % 32;
#pragma unroll
  for (int o = 16; o; o >>= 1)
    sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, o));
  if (lane == 0) warp_sums[warp] = sq;
  __syncthreads();
  if (warp == 0) {
    float s = lane < nt / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int o = 16; o; o >>= 1)
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    if (lane == 0)
      inv_rms = rsqrtf(__fadd_rn(__fmul_rn(s, a.inv_width), a.eps));
  }
  __syncthreads();

  const float inv = inv_rms, x_scale = __ldg(a.x_scale);
  int8_t* out = a.out + r * w;
  for (int k = 0, c0 = t * CHUNK; c0 < w; ++k, c0 += nt * CHUNK) {
    const int count = min(CHUNK, w - c0);
    float gv[CHUNK];
    load<VEC>(a.g + c0, count, gv);
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < CHUNK; ++e) {
      const float u = e < count ? row[(k * CHUNK + e) * nt + t] : 0.f;
      const float n = round_to<T>(__fmul_rn(__fmul_rn(u, inv), gv[e]));
      const float q = fminf(fmaxf(rintf(__fdiv_rn(n, x_scale)), -QMAX), QMAX);
      packed[e / 4] |= (uint32_t)(uint8_t)(int8_t)(int)q << (8 * (e % 4));
    }
    if (VEC) {
      *reinterpret_cast<uint2*>(out + c0) = make_uint2(packed[0], packed[1]);
    } else {
#pragma unroll
      for (int e = 0; e < CHUNK; ++e)
        if (e < count) out[c0 + e] = (int8_t)(packed[e / 4] >> (8 * (e % 4)));
    }
  }
}

template <typename T, bool GATED, bool VEC>
int run(const Args& a, int m, cudaStream_t s) {
  const int chunks = (a.width + CHUNK - 1) / CHUNK;
  const int wanted = (chunks + 31) / 32 * 32;
  const int threads = wanted < MAX_THREADS ? wanted : MAX_THREADS;
  const int iters = (chunks + threads - 1) / threads;
  const size_t smem = (size_t)iters * CHUNK * threads * sizeof(float);
  auto kernel = norm_codes_kernel<T, GATED, VEC>;
  if (smem > DEFAULT_SMEM) {   // past 227 KB this refuses, and so do we
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<m, threads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int pick(const Args& a, int m, bool gated, bool vec, cudaStream_t s) {
  if (gated)
    return vec ? run<T, true, true>(a, m, s) : run<T, true, false>(a, m, s);
  return vec ? run<T, false, true>(a, m, s) : run<T, false, false>(a, m, s);
}

bool aligned16(const void* p) { return p == nullptr || (uintptr_t)p % 16 == 0; }

}  // namespace

// x (M, W) rows with element row stride x_stride: f32 y when gated,
// otherwise the working type (bf16 when bf16 == 1, else f32).  Gated
// (gated == 1): xs and z (M, W) rows in the working type, strides xs_stride
// and z_stride, and d_skip (W / headdim,) f32.  g (W,) f32; x_scale one f32
// value; out (M, W) int8, contiguous.  Every row's columns are packed (unit
// stride).
extern "C" int norm_codes_launch(const void* x, long long x_stride,
                                 const void* xs, long long xs_stride,
                                 const void* d_skip, int headdim,
                                 const void* z, long long z_stride,
                                 const void* g, const void* x_scale,
                                 float eps, void* out, int m, int width,
                                 int bf16, int gated, void* stream) {
  if (m <= 0 || width <= 0) return 0;
  if (gated && headdim <= 0) return (int)cudaErrorInvalidValue;
  const Args a{x, x_stride, gated ? xs : nullptr, xs_stride,
               (const float*)d_skip, headdim, gated ? z : nullptr, z_stride,
               (const float*)g, (const float*)x_scale, eps,
               1.f / (float)width, (int8_t*)out, width};
  const size_t t_size = bf16 ? 2 : 4;
  const size_t x_size = gated ? 4 : t_size;
  const bool vec = width % CHUNK == 0 && aligned16(x) && aligned16(a.xs) &&
                   aligned16(a.z) && aligned16(g) && aligned16(out) &&
                   (x_stride * x_size) % 16 == 0 &&
                   (!gated || ((xs_stride * t_size) % 16 == 0 &&
                               (z_stride * t_size) % 16 == 0));
  const cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? pick<__nv_bfloat16>(a, m, gated, vec, s)
              : pick<float>(a, m, gated, vec, s);
}
