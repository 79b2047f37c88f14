// Helpers shared by the attention forward (attention.cu) and backward
// (attention_bwd.cu) kernels: the counter-hash dropout of the TPU kernel,
// bf16 <-> fp32 conversion, warp reductions, and the 16-byte tile staging
// of register-tiled kernels (cp.async for fp32, widened uint4 for bf16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace hamt {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ uint32_t splitmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// Per-(batch, head) key of the dropout hash; element (row, col) of the
// (Lq, Lk) probability matrix is kept iff
// splitmix32(key ^ splitmix32(row * Lk + col)) >= thresh.
__device__ __forceinline__ uint32_t dropout_key(uint32_t seed, int b, int h) {
  return seed + (uint32_t)b * 0x9E3779B1u + (uint32_t)h * 0x85EBCA77u;
}

__device__ __forceinline__ bool dropout_keep(uint32_t key, int row, int col,
                                             int Lk, uint32_t thresh) {
  const uint32_t idx = (uint32_t)row * (uint32_t)Lk + (uint32_t)col;
  return splitmix32(key ^ splitmix32(idx)) >= thresh;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Max and sum over each group of N consecutive lanes (N a power of two
// up to 32); the whole warp must take part.
template <int N>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = N / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int N>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = N / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ------------------------------------------------------- tile staging
// 16-byte asynchronous copy global -> shared, bypassing L1 (.cg). Both
// addresses must be 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies rows [0, n) of a (rows, DH) tile -- row stride `ld` elements,
// unit stride along DH, every row 16-byte aligned -- into shared memory
// as fp32 with a row pitch of `pitch` floats (a multiple of 4), and
// zero-fills rows [n, n_pad). All NT threads of the block take part. fp32
// rows go by cp.async (the caller commits and waits); bf16 rows by uint4
// loads widened in registers (exact: bf16 is the top half of an fp32).
template <typename T, int DH, int NT>
__device__ __forceinline__ void stage_rows(float* dst, int pitch, const T* src,
                                           long long ld, int n, int n_pad) {
  constexpr unsigned kElems = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr unsigned kChunks = DH / kElems;    // chunks per row, a power of two
  static_assert(DH % 8 == 0 && (kChunks & (kChunks - 1)) == 0, "DH: 8, 16, 32, ...");
  for (unsigned i = threadIdx.x; i < (unsigned)n * kChunks; i += NT) {
    const unsigned r = i / kChunks, c = i % kChunks;
    const T* s = src + r * ld + c * kElems;
    float* d = dst + r * pitch + c * kElems;
    if constexpr (sizeof(T) == 4) {
      cp_async16(d, s);
    } else {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(s));
      reinterpret_cast<float4*>(d)[0] =
          make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xFFFF0000u),
                      __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xFFFF0000u));
      reinterpret_cast<float4*>(d)[1] =
          make_float4(__uint_as_float(w.z << 16), __uint_as_float(w.z & 0xFFFF0000u),
                      __uint_as_float(w.w << 16), __uint_as_float(w.w & 0xFFFF0000u));
    }
  }
  constexpr unsigned kQuads = DH / 4;
  for (unsigned i = threadIdx.x; i < (unsigned)(n_pad - n) * kQuads; i += NT) {
    const unsigned r = n + i / kQuads, c = i % kQuads;
    *reinterpret_cast<float4*>(dst + r * pitch + c * 4) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

}  // namespace hamt
