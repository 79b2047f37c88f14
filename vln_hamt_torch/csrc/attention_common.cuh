// Helpers shared by the attention forward (attention.cu) and backward
// (attention_bwd.cu) kernels: the counter-hash dropout of the TPU kernel,
// bf16 <-> fp32 conversion and warp reductions.
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

}  // namespace hamt
