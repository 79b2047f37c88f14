// Helpers shared by the key-blocked attention kernels (attention_blocked.cu,
// the forward, and attention_blocked_bwd.cu, the backward): the tiling,
// the staging of rows of any head width and any alignment, and the
// score tile.
//
// Tiling. A CTA of 128 threads works on a block of kBQ = 32 query rows
// against a block of key_block(DP) keys. DP is the head width padded to
// the next of 16, 32, 64 and 128: rows are staged in shared memory as
// fp32 with zeros in columns [Dh, DP), so a head width of 12, 48 or 80
// runs through the instantiation of 16, 64 or 128 with no copy in the
// wrapper, and the zero columns add nothing to any product. Three
// thread-to-data maps share the CTA, each the one the whole-row kernels
// use (attention.cu, attention_bwd.cu):
// * scores: 8 lanes share a row, each thread holds 2 rows x BK / 8
//   columns (column tx + 8c);
// * rows x d: each thread holds RO = DP / 16 rows x 4 contiguous d;
// * keys x d (the backward's dK and dV): each thread holds KPT keys x 4
//   contiguous d.
// In the first two maps warp w owns query rows 8w .. 8w + 7, so what one
// map writes for its rows the other reads after a __syncwarp.
#pragma once

#include "attention_common.cuh"

namespace hamt {
namespace blocked {

constexpr int kBQ = 32;          // query rows per block
constexpr int kLanes = 8;        // threads that share one score row
constexpr int kRows = 2;         // score rows per thread
constexpr int kBlockThreads = kBQ / kRows * kLanes;  // 128

// The padded head width: the next instantiated width at or above Dh, or 0
// past 128.
__host__ __device__ constexpr int padded_width(int Dh) {
  return Dh <= 16 ? 16 : Dh <= 32 ? 32 : Dh <= 64 ? 64 : Dh <= 128 ? 128 : 0;
}

// Keys per block: 64, or 32 at DP 128, which keeps every kernel's shared
// memory under 80 KB and the backward's dK and dV tiles at 64 registers.
__host__ __device__ constexpr int key_block(int DP) { return DP == 128 ? 32 : 64; }

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

// Copies rows [0, n) of a (rows, Dh) tile -- row stride `ld` elements,
// unit stride along Dh, any alignment -- into shared memory as fp32 rows
// of DP floats at pitch `pitch`, zero in columns [Dh, DP) and in rows
// [n, rows). Neighbouring threads read neighbouring elements of a row.
template <typename T, int DP>
__device__ __forceinline__ void stage_any(float* dst, int pitch, const T* src, long long ld,
                                          int n, int rows, int Dh) {
  for (int i = threadIdx.x; i < rows * DP; i += kBlockThreads) {
    const int r = i / DP, d = i % DP;
    dst[r * pitch + d] = r < n && d < Dh ? to_float(src[r * ld + d]) : 0.f;
  }
}

// s[r][c] = sum over d, in order, of A[r][d] * B[8c][d] for the thread's
// 2 rows of A (from `ar`) and its CPT columns (rows of B from `br`, 8
// rows apart), both of pitch DP + 4 floats: the 8 rows a warp's lanes
// read at once fall into distinct banks.
template <int DP, int CPT>
__device__ __forceinline__ void tile_scores(float (&s)[kRows][CPT], const float* ar,
                                            const float* br) {
  constexpr int KP = DP + 4;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) s[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DP; d += 4) {
    float4 a[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) a[r] = ld4(ar + r * KP + d);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const float4 bv = ld4(br + c * kLanes * KP + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        s[r][c] = fmaf(a[r].x, bv.x, s[r][c]);
        s[r][c] = fmaf(a[r].y, bv.y, s[r][c]);
        s[r][c] = fmaf(a[r].z, bv.z, s[r][c]);
        s[r][c] = fmaf(a[r].w, bv.w, s[r][c]);
      }
    }
  }
}

// o[r] += sum over keys j < n4 (a multiple of 4), in order, of
// P[r][j] * X[j][4 td .. 4 td + 3] for the thread's RO rows of P (from
// `pr`, pitch pp) and X's columns (from `xc`, pitch xp).
template <int RO>
__device__ __forceinline__ void rows_times_keys(float4 (&o)[RO], const float* pr, int pp,
                                                const float* xc, int xp, int n4) {
#pragma unroll 2
  for (int j = 0; j < n4; j += 4) {
    const float4 x0 = ld4(xc + (j + 0) * xp);
    const float4 x1 = ld4(xc + (j + 1) * xp);
    const float4 x2 = ld4(xc + (j + 2) * xp);
    const float4 x3 = ld4(xc + (j + 3) * xp);
#pragma unroll
    for (int r = 0; r < RO; ++r) {
      const float4 pj = ld4(pr + r * pp + j);
      fma4(o[r], pj.x, x0);
      fma4(o[r], pj.y, x1);
      fma4(o[r], pj.z, x2);
      fma4(o[r], pj.w, x3);
    }
  }
}

}  // namespace blocked
}  // namespace hamt
