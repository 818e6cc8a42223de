// Hopper kernel: int8 x int8 -> int32 GEMM with the fused dequantization
// epilogue, out = f32(xq @ wq) * scale + bias.
//
// Replaces src/repro/kernels/qmatmul.py::qmatmul, the Pallas TPU kernel
// behind repro.kernels.ops.quantized_matmul.  The TPU version walks a
// sequential K grid, carrying an int32 accumulator in VMEM scratch and
// applying the epilogue on the last K step.  Here one launch per call takes
// one of two paths, picked by the wrapper from M (qmatmul.py::path):
//
// * M >= 64: `qmatmul_kernel_tc`, int8 tensor cores through
//   wgmma.mma_async m64n128k32.s32.s8.s8.  A block owns a 128 x 128 output
//   tile; two warpgroups own 64 rows each.  K runs in 128-deep steps
//   through a 3-stage shared-memory ring filled by cp.async (16 B,
//   zero-filled past the ragged M/K/N edges).  The epilogue
//   __fadd_rn(__fmul_rn(__int2float_rn(acc), scale[c]), bias[c]) is applied
//   straight from the accumulator registers, with float2 stores.
//   What bounds it: at the mamba2-370m prefill in_proj (8192, 1024, 4384)
//   writing the f32 output (143.7 MB, 47 us at 3.35 TB/s); at out_proj
//   (8192, 2048, 1024) the int8 operations (34.4 GOP, 17 us at 1,979
//   TOP/s).
//   The layout trap: 8-bit wgmma reads both operands K-major, and wq
//   (K, N) is row-major.  Choice (b): each (128 K x 128 N) weight tile is
//   staged as it lies and transposed in shared memory with byte permutes
//   (__byte_perm, a 16 x 4 byte block per thread) into the K-major,
//   128-byte-swizzled layout wgmma reads, once per M tile out of L2.  It
//   keeps the wrapper's contract on the weight every caller holds — no
//   second, K-major copy of each SINT weight (316 MB for mamba2-370m) to
//   build, keep beside `qw` and keep out of the exported params — at the
//   cost of shared-memory traffic: per K step a block moves 16 KB through
//   the transpose beside the 32 KB that wgmma reads.  cp.async rather than
//   TMA: the weight tile passes through registers for the transpose
//   anyway, and no tensor-map descriptor has to be built per call.  Not
//   done yet: TMA, a warp-specialised producer, a persistent schedule and
//   overlapping one K step's transpose with the previous step's wgmma
//   (each step waits for its wgmma before the next transpose).
// * M < 64 (decode, M = 8): `qmatmul_kernel_stream`, weight streaming.
//   What bounds it: reading the weight once (4.49 MB and 2.10 MB for
//   mamba2-370m's in_proj and out_proj, 1.3 and 0.6 us) — in practice the
//   latency of getting it requested, so the design puts every block's
//   whole share in flight before it computes.  A block owns 32 columns and
//   8 rows of xq (137 blocks at N 4384, two per SM); K runs in 512-row
//   chunks through a 4-stage cp.async ring (16-byte copies: in_proj's two
//   chunks and three of out_proj's four are requested at once).  Its 256
//   threads split K into 32 groups of 4 rows (lane bits 3-4 and the warp)
//   and the columns into 8 groups of 4 (lane bits 0-2): a thread reads 4
//   words of the chunk from shared memory, transposes the 4 x 4 bytes with
//   __byte_perm and multiplies with __dp4a.  The 32 partial sums of each
//   output are combined in the same launch: a recursive-halving butterfly
//   over lane bits 4 and 3 (24 shuffles), then the 8 warps in order
//   through shared memory.
//
// Numerics: int32 accumulation is exact whatever the order (|acc| < 2^31
// for K < 2^17 at int8), so every path equals the plain version bit for
// bit; the epilogue is two separately rounded f32 operations that nvcc
// cannot contract into an FMA.
//
// Each kernel has a vector instance (16-byte loads; K and N multiples of
// 16 and 16-byte-aligned operands) and a byte-wise instance for the rest
// (the fleet's N = 2 layer, an unaligned view).

#include <cuda_runtime.h>
#include <stdint.h>

#include "pipeline.cuh"

// Stage the 16 bytes at src + offset into shared memory at dst, of which
// the first `count` are in range (the rest, or all when count <= 0, are
// zero).  VEC: one cp.async, which needs count <= 0 or >= 16 and 16-byte
// alignment; otherwise byte loads and one 16-byte store.
template <bool VEC>
__device__ __forceinline__ void stage16(uint8_t* dst, const int8_t* src,
                                        size_t offset, int count) {
  if (VEC) {
    cp_async16(dst, count > 0 ? src + offset : src, count > 0);
  } else {
    uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
    for (int b = 0; b < 16; ++b)
      if (b < count) v[b / 4] |= (uint32_t)(uint8_t)src[offset + b]
                                 << (8 * (b % 4));
    *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

__device__ __forceinline__ float dequant(int acc, const float* scale,
                                         const float* bias, int c) {
  float y = __fmul_rn(__int2float_rn(acc), scale[c]);
  if (bias != nullptr) y = __fadd_rn(y, bias[c]);
  return y;
}

// Four little-endian words r0..r3 (rows) of four bytes (columns) -> four
// words o0..o3, o_j = column j's bytes of rows 0..3.
__device__ __forceinline__ void transpose4x4(uint32_t r0, uint32_t r1,
                                             uint32_t r2, uint32_t r3,
                                             uint32_t& o0, uint32_t& o1,
                                             uint32_t& o2, uint32_t& o3) {
  const uint32_t lo01 = __byte_perm(r0, r1, 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
  const uint32_t hi01 = __byte_perm(r0, r1, 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
  const uint32_t lo23 = __byte_perm(r2, r3, 0x5140);
  const uint32_t hi23 = __byte_perm(r2, r3, 0x7362);
  o0 = __byte_perm(lo01, lo23, 0x5410);
  o1 = __byte_perm(lo01, lo23, 0x7632);
  o2 = __byte_perm(hi01, hi23, 0x5410);
  o3 = __byte_perm(hi01, hi23, 0x7632);
}

// ---------------------------------------------------------------------------
// M >= 64: int8 wgmma.
// ---------------------------------------------------------------------------

#define TC_BM 128
#define TC_BN 128
#define TC_BK 128                          // bytes of K per step: one
                                           // 128-byte swizzle row
#define TC_STAGES 3
#define TC_THREADS 256                     // two warpgroups
#define TC_TILE (TC_BM * TC_BK)            // 16 KB, every tile
#define TC_SMEM ((2 * TC_STAGES + 1) * TC_TILE + 1024)

// Shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1,024 bytes apart (SBO), the
// leading offset unused.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1)              // scale-d: D += A B
      : "memory");
}

// Stage K step `k0` of the A tile (rows m0.., K-major, swizzled as wgmma
// reads it) and of the raw weight tile (rows k0.., 128 bytes of N each, as
// it lies).  Elements past m, k or n are zero.
template <bool VEC>
__device__ __forceinline__ void tc_load(uint8_t* a, uint8_t* braw,
                                        const int8_t* __restrict__ xq,
                                        const int8_t* __restrict__ wq, int m,
                                        int n, int k, int m0, int n0, int k0,
                                        int tid) {
#pragma unroll
  for (int i = 0; i < TC_TILE / 16 / TC_THREADS; ++i) {
    const int e = tid + TC_THREADS * i, r = e >> 3, c = e & 7;
    const int row = m0 + r, kk = k0 + 16 * c;
    stage16<VEC>(a + r * TC_BK + ((c ^ (r & 7)) << 4), xq,
                 (size_t)row * k + kk, row < m ? k - kk : 0);
  }
#pragma unroll
  for (int i = 0; i < TC_TILE / 16 / TC_THREADS; ++i) {
    const int e = tid + TC_THREADS * i, r = e >> 3, c = e & 7;
    const int kr = k0 + r, nn = n0 + 16 * c;
    stage16<VEC>(braw + r * TC_BN + 16 * c, wq, (size_t)kr * n + nn,
                 kr < k ? n - nn : 0);
  }
}

// Raw (128 K x 128 N) weight tile -> K-major, 128-byte-swizzled (N rows of
// 128 K bytes).  Warp w takes K rows 16w..16w+15, lane l the columns
// 4l..4l+3: 16 conflict-free word reads, 32 byte permutes, 4 16-byte
// writes.  A lane writes its four columns starting at (l >> 1) & 3, so the
// 8 lanes of each write phase hit 8 different 16-byte bank groups.
__device__ __forceinline__ void tc_transpose(const uint8_t* braw,
                                             uint8_t* bt, int tid) {
  const int w = tid >> 5, l = tid & 31;
  uint32_t r[16];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    r[i] = *reinterpret_cast<const uint32_t*>(braw + (16 * w + i) * TC_BN +
                                              4 * l);
  uint32_t o[4][4];                        // [column j][K word q]
#pragma unroll
  for (int q = 0; q < 4; ++q)
    transpose4x4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3],
                 o[0][q], o[1][q], o[2][q], o[3][q]);
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int j = (jj + (l >> 1)) & 3, col = 4 * l + j;
    uint4 v;
    v.x = j == 0 ? o[0][0] : j == 1 ? o[1][0] : j == 2 ? o[2][0] : o[3][0];
    v.y = j == 0 ? o[0][1] : j == 1 ? o[1][1] : j == 2 ? o[2][1] : o[3][1];
    v.z = j == 0 ? o[0][2] : j == 1 ? o[1][2] : j == 2 ? o[2][2] : o[3][2];
    v.w = j == 0 ? o[0][3] : j == 1 ? o[1][3] : j == 2 ? o[2][3] : o[3][3];
    *reinterpret_cast<uint4*>(bt + col * TC_BK + ((w ^ (col & 7)) << 4)) = v;
  }
}

// Two blocks per SM (<= 128 registers a thread, 2 x 114 KB of shared
// memory): one block's transposes, waits and epilogue overlap the other's
// wgmma.
template <bool VEC>
__global__ void __launch_bounds__(TC_THREADS, 2)
qmatmul_kernel_tc(const int8_t* __restrict__ xq,
                  const int8_t* __restrict__ wq,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias, float* __restrict__ out,
                  int m, int n, int k) {
  extern __shared__ uint8_t smem_raw[];
  // The swizzle is applied to address bits 4-9: tiles start 1 KB-aligned.
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  uint8_t* base = smem_raw + ((1024 - (raw & 1023)) & 1023);
  uint8_t* a_ring = base;                               // [STAGES][TILE]
  uint8_t* b_ring = base + TC_STAGES * TC_TILE;         // [STAGES][TILE]
  uint8_t* bt = base + 2 * TC_STAGES * TC_TILE;         // [TILE]
  const int tid = threadIdx.x, wg = tid >> 7;
  const int n0 = blockIdx.x * TC_BN, m0 = blockIdx.y * TC_BM;
  const int steps = (k + TC_BK - 1) / TC_BK;

  int d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;

#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < steps)
      tc_load<VEC>(a_ring + s * TC_TILE, b_ring + s * TC_TILE, xq, wq, m, n,
                   k, m0, n0, s * TC_BK, tid);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int s = 0; s < steps; ++s) {
    const int stage = s % TC_STAGES;
    asm volatile("cp.async.wait_group %0;\n" ::"n"(TC_STAGES - 2));
    // Step s's tiles have landed, and every warpgroup's wgmma of step s-1
    // has finished with its A stage and with bt.
    __syncthreads();
    const int next = s + TC_STAGES - 1;
    if (next < steps)
      tc_load<VEC>(a_ring + (next % TC_STAGES) * TC_TILE,
                   b_ring + (next % TC_STAGES) * TC_TILE, xq, wq, m, n, k,
                   m0, n0, next * TC_BK, tid);
    asm volatile("cp.async.commit_group;\n" ::);
    tc_transpose(b_ring + stage * TC_TILE, bt, tid);
    // Make this thread's shared-memory writes (the transpose's stores and
    // its landed cp.async copies) visible to wgmma's async proxy.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    const uint32_t a_addr = (uint32_t)__cvta_generic_to_shared(
        a_ring + stage * TC_TILE + wg * 64 * TC_BK);
    const uint32_t b_addr = (uint32_t)__cvta_generic_to_shared(bt);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < TC_BK / 32; ++kk)
      wgmma_m64n128k32(d, smem_desc(a_addr + 32 * kk),
                       smem_desc(b_addr + 32 * kk));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
  }

  // Accumulator layout of m64nNk32: register i of thread (warp wi, lane l)
  // of the warpgroup holds row 16 wi + l / 4 + 8 ((i / 2) % 2), column
  // 8 (i / 4) + 2 (l % 4) + i % 2.
  const int wi = (tid >> 5) & 3, l = tid & 31;
  const int row_base = m0 + wg * 64 + wi * 16 + l / 4;
#pragma unroll
  for (int q = 0; q < TC_BN / 8; ++q) {
    const int col = n0 + 8 * q + 2 * (l % 4);
    if (col >= n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_base + 8 * h;
      if (row >= m) continue;
      const int i = 4 * q + 2 * h;
      float* dst = out + (size_t)row * n + col;
      if (VEC) {        // n % 16 == 0: col + 1 < n, and 8-byte aligned
        *reinterpret_cast<float2*>(dst) =
            make_float2(dequant(d[i], scale, bias, col),
                        dequant(d[i + 1], scale, bias, col + 1));
      } else {
        dst[0] = dequant(d[i], scale, bias, col);
        if (col + 1 < n) dst[1] = dequant(d[i + 1], scale, bias, col + 1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// M < 64: weight streaming.
// ---------------------------------------------------------------------------

#define ST_COLS 32                           // output columns per block
#define ST_ROWS 8                            // rows of xq per block
#define ST_THREADS 256
#define ST_KCH 512                           // K rows per chunk
#define ST_STAGES 4                          // chunks in the ring
#define ST_WBYTES (ST_KCH * ST_COLS)         // 16 KB of weight per chunk
#define ST_XBYTES (ST_ROWS * ST_KCH)         // 4 KB of xq per chunk
#define ST_SMEM (ST_STAGES * (ST_WBYTES + ST_XBYTES))

// Row r of a weight chunk is stored at slot r with its place in its group
// of four rows rotated by r / 4: the four rows, four apart, that a warp
// reads at once then lie in four different 32-byte bank groups.
__device__ __forceinline__ int st_slot(int r) {
  return (r & ~3) | ((r + (r >> 2)) & 3);
}

// Stage chunk `k0` of the weight (ST_KCH rows of ST_COLS bytes, as it
// lies) and of xq (ST_ROWS rows of ST_KCH bytes).  Elements past m, k or n
// are zero.
template <bool VEC>
__device__ __forceinline__ void st_load(uint8_t* w_s, uint8_t* x_s,
                                        const int8_t* __restrict__ xq,
                                        const int8_t* __restrict__ wq, int m,
                                        int n, int k, int m0, int n0, int k0,
                                        int tid) {
#pragma unroll
  for (int i = 0; i < ST_WBYTES / 16 / ST_THREADS; ++i) {
    const int e = tid + ST_THREADS * i, r = e >> 1, c = e & 1;
    const int kr = k0 + r, nn = n0 + 16 * c;
    stage16<VEC>(w_s + st_slot(r) * ST_COLS + 16 * c, wq,
                 (size_t)kr * n + nn, kr < k ? n - nn : 0);
  }
  // ST_XBYTES / 16 == ST_THREADS: one 16-byte piece of xq per thread.
  const int r = tid / (ST_KCH / 16), c = tid % (ST_KCH / 16);
  const int row = m0 + r, kk = k0 + 16 * c;
  stage16<VEC>(x_s + r * ST_KCH + 16 * c, xq, (size_t)row * k + kk,
               row < m ? k - kk : 0);
}

template <bool VEC>
__global__ void __launch_bounds__(ST_THREADS)
qmatmul_kernel_stream(const int8_t* __restrict__ xq,
                      const int8_t* __restrict__ wq,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias,
                      float* __restrict__ out, int m, int n, int k) {
  extern __shared__ __align__(16) uint8_t st_smem[];
  __shared__ int red[ST_THREADS / 32][8][32];
  uint8_t* w_ring = st_smem;                            // [STAGES][WBYTES]
  uint8_t* x_ring = st_smem + ST_STAGES * ST_WBYTES;    // [STAGES][XBYTES]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // Lane bits 0-2 pick 4 of the block's 32 columns, lane bits 3-4 and the
  // warp one of 32 groups of 4 K rows: rows 4 (group + 32 s) + {0..3} of
  // each chunk, s < 4.
  const int cg = lane & 7, group = (lane >> 3) + 4 * warp;
  const int n0 = blockIdx.x * ST_COLS, m0 = blockIdx.y * ST_ROWS;
  const int chunks = (k + ST_KCH - 1) / ST_KCH;

  int acc[ST_ROWS * 4];                    // [row][column]
#pragma unroll
  for (int a = 0; a < ST_ROWS * 4; ++a) acc[a] = 0;

#pragma unroll
  for (int s = 0; s < ST_STAGES - 1; ++s) {
    if (s < chunks)
      st_load<VEC>(w_ring + s * ST_WBYTES, x_ring + s * ST_XBYTES, xq, wq, m,
                   n, k, m0, n0, s * ST_KCH, tid);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int c = 0; c < chunks; ++c) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(ST_STAGES - 2));
    __syncthreads();     // chunk c has landed; chunk c - 1 is consumed
    const int next = c + ST_STAGES - 1;
    if (next < chunks)
      st_load<VEC>(w_ring + (next % ST_STAGES) * ST_WBYTES,
                   x_ring + (next % ST_STAGES) * ST_XBYTES, xq, wq, m, n, k,
                   m0, n0, next * ST_KCH, tid);
    asm volatile("cp.async.commit_group;\n" ::);
    const uint8_t* w_s = w_ring + (c % ST_STAGES) * ST_WBYTES;
    const uint8_t* x_s = x_ring + (c % ST_STAGES) * ST_XBYTES;
#pragma unroll
    for (int s = 0; s < ST_KCH / 128; ++s) {
      const int r4 = 4 * (group + 32 * s);
      uint32_t wr[4], wc[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        wr[r] = *reinterpret_cast<const uint32_t*>(
            w_s + st_slot(r4 + r) * ST_COLS + 4 * cg);
      transpose4x4(wr[0], wr[1], wr[2], wr[3], wc[0], wc[1], wc[2], wc[3]);
#pragma unroll
      for (int i = 0; i < ST_ROWS; ++i) {
        const int xw = *reinterpret_cast<const int*>(x_s + i * ST_KCH + r4);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[4 * i + j] = __dp4a(xw, (int)wc[j], acc[4 * i + j]);
      }
    }
  }

  // Sum the 32 groups: recursive halving over lane bits 4 and 3 (the 4
  // groups of a warp), then the 8 warps in order through shared memory.
  // Afterwards lane l holds acc[a], a < 8, for rows 2 ((l >> 3) & 1) +
  // 4 ((l >> 4) & 1) + a / 4 and columns 4 (l & 7) + a % 4.
  halve<16>(acc, lane, 16);
  halve<8>(acc, lane, 8);
#pragma unroll
  for (int i = 0; i < 8; ++i) red[warp][i][lane] = acc[i];
  __syncthreads();
  if (warp != 0) return;
  int sum[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    sum[i] = red[0][i][lane];
#pragma unroll
    for (int w = 1; w < ST_THREADS / 32; ++w) sum[i] += red[w][i][lane];
  }
  const int row0 = m0 + 2 * ((lane >> 3) & 1) + 4 * ((lane >> 4) & 1);
  const int col = n0 + 4 * cg;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + h;
    if (row >= m) continue;
    float* dst = out + (size_t)row * n + col;
    if (VEC) {          // n % 16 == 0: all 4 columns in range, 16-byte aligned
      if (col < n)
        *reinterpret_cast<float4*>(dst) =
            make_float4(dequant(sum[4 * h], scale, bias, col),
                        dequant(sum[4 * h + 1], scale, bias, col + 1),
                        dequant(sum[4 * h + 2], scale, bias, col + 2),
                        dequant(sum[4 * h + 3], scale, bias, col + 3));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < n) dst[j] = dequant(sum[4 * h + j], scale, bias, col + j);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

static bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

typedef void (*Kernel)(const int8_t*, const int8_t*, const float*,
                       const float*, float*, int, int, int);

// Lifts the kernel's dynamic shared-memory limit and asks for the largest
// shared-memory carveout (two tensor-core blocks need 228 KB of an SM)
// once, then launches.
template <Kernel K, int THREADS, int SMEM, int COLS, int ROWS>
static int launch(const int8_t* xq, const int8_t* wq, const float* scale,
                  const float* bias, float* out, int m, int n, int k,
                  cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        K, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          K, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((n + COLS - 1) / COLS, (m + ROWS - 1) / ROWS);
  K<<<grid, THREADS, SMEM, s>>>(xq, wq, scale, bias, out, m, n, k);
  return (int)cudaGetLastError();
}

// Launches one kernel on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted).  `tensor_cores` picks the path (qmatmul.py::path:
// M >= 64); `bias` may be null.
extern "C" int qmatmul_launch(const void* xq, const void* wq,
                              const void* scale, const void* bias, void* out,
                              int m, int n, int k, int tensor_cores,
                              void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int8_t* xp = (const int8_t*)xq;
  const int8_t* wp = (const int8_t*)wq;
  const float* sp = (const float*)scale;
  const float* bp = (const float*)bias;
  float* op = (float*)out;
  const bool vec = k % 16 == 0 && n % 16 == 0 && aligned16(xq) &&
                   aligned16(wq) && aligned16(out);
  if (tensor_cores)
    return vec ? launch<qmatmul_kernel_tc<true>, TC_THREADS, TC_SMEM, TC_BN,
                        TC_BM>(xp, wp, sp, bp, op, m, n, k, s)
               : launch<qmatmul_kernel_tc<false>, TC_THREADS, TC_SMEM, TC_BN,
                        TC_BM>(xp, wp, sp, bp, op, m, n, k, s);
  return vec ? launch<qmatmul_kernel_stream<true>, ST_THREADS, ST_SMEM,
                      ST_COLS, ST_ROWS>(xp, wp, sp, bp, op, m, n, k, s)
             : launch<qmatmul_kernel_stream<false>, ST_THREADS, ST_SMEM,
                      ST_COLS, ST_ROWS>(xp, wp, sp, bp, op, m, n, k, s);
}
