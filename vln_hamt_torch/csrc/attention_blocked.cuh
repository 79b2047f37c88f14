// Helpers shared by the key-blocked attention kernels (attention_blocked.cu,
// the forward, and attention_blocked_bwd.cu, the backward): the padded head
// width, the twice-rounded score, the staging of rows of any head width and
// any alignment into shared memory (16-byte cp.async with a source size,
// or element loads), and the warp-level tensor-core pieces (ldmatrix,
// mma.sync m16n8k16 bf16 -> fp32, the hi / lo split of fp32 operands).
// Every kernel that stages with them runs kTileThreads threads.
#pragma once

#include "attention_common.cuh"

namespace hamt {
namespace blocked {

constexpr int kTileThreads = 128;  // 4 warps, every key-blocked kernel

// The padded head width of the fp32 products and of the backward: the
// next of 16, 32, 64 and 128 at or above Dh, or 0 past 128.
__host__ __device__ constexpr int padded_width(int Dh) {
  return Dh <= 16 ? 16 : Dh <= 32 ? 32 : Dh <= 64 ? 64 : Dh <= 128 ? 128 : 0;
}

// score * scale + mask with two roundings, as torch and XLA compute it:
// the compiler would otherwise fuse them into one FMA, and next to -10000,
// where the fp32 step is 2^-10, a score rounded once can land one step
// from the plain version's and move its p by a thousandth.
__device__ __forceinline__ float scaled_score(float s, float scale, float m) {
  return __fadd_rn(__fmul_rn(s, scale), m);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4(float4& acc, float a, float4 b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

// ------------------------------------------------------------ staging
// 16-byte copy global -> shared of the first `bytes` (0..16) bytes, the
// rest zero-filled; with 0 bytes nothing is read. Both addresses 16-byte
// aligned.
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes)
               : "memory");
}

// Rows [0, n) of a (ROWS, Dh) tile of T -- row stride `ld` elements, unit
// stride on Dh -- into shared memory rows of W elements at pitch P, zero
// in columns [Dh, W) and rows [n, ROWS). With `async` every row start is
// 16-byte aligned and the rows go by cp.async (the caller commits); else
// by element loads. W * sizeof(T) is a multiple of 16.
template <typename T, int W, int P, int ROWS>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, long long ld, int n, int Dh,
                                           bool async) {
  if (async) {
    constexpr int E = 16 / sizeof(T);  // elements per chunk
    constexpr int C = W / E;           // chunks per row
    constexpr int RP = kTileThreads / C;   // rows per pass
    const int c = threadIdx.x % C, r0 = threadIdx.x / C;
    if (r0 >= RP) return;
    const int left = (Dh - c * E) * (int)sizeof(T);
    const int bytes = left < 0 ? 0 : left > 16 ? 16 : left;
    for (int r = r0; r < ROWS; r += RP) {
      const bool live = r < n && bytes > 0;
      cp_async16_zfill(dst + r * P + c * E, live ? src + r * ld + c * E : src, live ? bytes : 0);
    }
  } else {
    constexpr int RP = kTileThreads / W;
    const int d = threadIdx.x % W, r0 = threadIdx.x / W;
    if (r0 >= RP) return;
    const T zero = from_float<T>(0.f);
    for (int r = r0; r < ROWS; r += RP) dst[r * P + d] = r < n && d < Dh ? src[r * ld + d] : zero;
  }
}

// Entries [0, n) of a row of N fp32 values (stride `ld`), zero past n, by
// 4-byte cp.async (the caller commits).
template <int N>
__device__ __forceinline__ void stage_mask(float* dst, const float* src, long long ld, int n) {
  for (int j = threadIdx.x; j < N; j += kTileThreads)
    cp_async4_zfill(dst + j, j < n ? src + j * ld : src, j < n ? 4 : 0);
}

// ------------------------------------------------ tensor-core pieces
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a b for one m16n8k16 tile, bf16 inputs, fp32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// The hi and lo bf16 parts of two fp32 values, packed as an mma operand
// (the first value in the low half): hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x0), h1 = __float2bfloat16_rn(x1);
  hi = pack_bf16(h0, h1);
  lo = pack_bf16(__float2bfloat16_rn(x0 - __bfloat162float(h0)),
                 __float2bfloat16_rn(x1 - __bfloat162float(h1)));
}

}  // namespace blocked
}  // namespace hamt
