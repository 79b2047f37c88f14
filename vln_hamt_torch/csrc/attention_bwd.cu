// Fused masked attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel vln_hamt_tpu/ops/attention.py:_attn_bwd_kernel
// (pallas_call at :257, reached through the custom VJP of
// _fused_attention_core). For one (batch, head) pair, with the forward
// out = dropout(softmax(q k^T * scale + m)) v and its cotangent g:
//
//     p   = softmax(q k^T * scale + m)          recomputed, not stored
//     pd  = keep ? p / (1 - rate) : 0           the forward's dropped p
//     dp  = keep ? (g v^T) / (1 - rate) : 0
//     ds  = p * (dp - rowsum(dp * p))
//     dv  = pd^T g,   dq = ds k * scale,   dk = ds^T q * scale
//     dm[b, :] = sum over heads and query rows of ds    (fp32)
//
// The keep mask is the forward's counter hash (attention_common.cuh) at
// (global query row) * Lk + col, so the backward drops exactly the
// elements the forward dropped.
//
// What bounds it on an H100. At HAMT's lengths (Lq, Lk <= 65 at R2R
// width, <= 250 for RxR text) one call reads q, k, v, g and the mask and
// writes dq, dk, dv (and dm) once: about 0.004 ms over HBM at the
// training batch of 8, below the 10 * B * H * Lq * Lk * Dh fp32 FLOPs
// (five Lq x Lk x Dh products) on the CUDA cores at 67 TFLOP/s. As in the
// forward (attention.cu), what decides the time is how fast each SM feeds
// its CUDA cores: every product below reads float4 register tiles from
// shared memory, several FMAs per loaded operand, where a loop that reads
// both operands of every FMA from shared memory runs at an eighth of the
// FMA rate.
//
// The design:
// * Grid over (query block, batch * head), 128 threads, the forward's
//   grid: nqb = ceil(Lq / 32) blocks per pair, the rows shared out evenly
//   (ceil(Lq / nqb) each: 22, 22 and 21 of 65), so that no block of a
//   cluster (below) waits on a fuller one. Each CTA stages the pair's
//   whole K and V and its Q and G blocks as fp32 rows of pitch Dh + 4
//   with 16-byte copies (cp.async for fp32, widened uint4 loads for bf16;
//   g is fp32). K and V are zero-padded to the tier's key count lkp, rows
//   of the Q and G blocks past the block's rows are zero. G and V go
//   first: their copy is waited for while Q and K are still in flight.
// * dP = G V^T, then S = Q K^T, in the same register tile: a thread holds
//   2 rows x MAXC columns (column tx + 8c of its 8-lane group; MAXC = 5,
//   9 or 32 by tier of Lk). dP is parked in the ds buffer in shared
//   memory; each thread reads back only what it wrote. Only one
//   MAXC-wide array is live, so the Lk <= 256 tier needs no spills.
// * The softmax is the forward's, straight-line over all MAXC columns
//   (columns past Lk read -inf), one reciprocal per row. Then, per
//   element, the keep mask gives pd and the dropped dp; rs =
//   rowsum(dp * p) by shuffles among the row's 8 lanes; ds = p (dp - rs).
//   pd and ds go to two (32, lkp + 4) buffers, pd over V, which no warp
//   reads once dP is done. Rows past the block's get pd = ds = 0.
// * dQ = ds K * scale from the forward's O = P V tile with K in V's
//   place: RO rows x 4 contiguous d a thread, per 4 keys RO float4s of
//   ds and 4 float4s of K (16 * RO FMAs). Each warp owns the same 8
//   query rows as in the scores, so ds passes between them with a
//   __syncwarp. Rows past Lq are not written.
// * dV = pd^T G_blk, then dK = ds^T Q_blk, over the block's rows in row
//   order: a thread holds 8 keys x 4 d (32 accumulators), per row two
//   float4s of pd or ds and one of G or Q for 32 FMAs. When dm is wanted,
//   the column sums of ds over the block's rows go to a (nqb, B, H, Lk)
//   scratch.
// * The sum over query blocks runs in a fixed order, with no atomics.
//   With one block (Lq <= 32) dk and dv are stored directly. Otherwise a
//   pair's nqb CTAs are launched as one thread-block cluster (nqb <= 8,
//   Lq <= 256): each parks its dV tile over K and its dK tile over V,
//   and after a cluster barrier each CTA sums a slice of the keys over
//   the cluster's shared memory (distributed shared memory) in rank
//   order, scales dk and stores both in the input type. Past 8 blocks
//   the CTAs write fp32 partials to a (nqb, B * H, Lk, Dh) scratch for
//   each of dk and dv, and attention_bwd_reduce_kernel sums them in the
//   same order. dm's partials are summed by attention_bwd_dm_kernel over
//   blocks, then heads, in order, so dm is deterministic; a caller whose
//   mask takes no gradient passes null scratch and dm, and the column
//   sums and that pass are skipped. One call issues 1 kernel (2 for
//   Lq > 256), plus 1 with dm.
// * Head widths 16, 32, 64 and 128, each with the forward's three column
//   tiers (Lk <= 40, <= 72, <= 256); Lq is free. Shared memory is
//   (2 lkp + 64) (Dh + 4) + lkp + 32 (lkp + 4) floats, pd lying over V
//   (layout below): 66,592 bytes at Lk 65, Dh 64, and 190,976 bytes at
//   Lk 256, Dh 64, under the 232,448 a block may have, so every length up
//   to 256 runs at Dh <= 64. At Dh 128 it fits
//   up to Lk 160; longer keys raise in the wrapper, which checks
//   hamt_attention_bwd_smem_bytes.
// * No tensor cores and no TMA, as in the forward: the main path computes
//   in fp32 with TF32 off for parity with the CPU, which a TF32 mma/wgmma
//   would break, and rows are 16-byte-aligned strided rows that cp.async
//   covers without tensor maps.
//
// q, k, v, g and the outputs dq, dk, dv are addressed through (batch,
// head, row) strides with a unit stride on Dh, so the layer's (B, L, H, Dh)
// projections and gradients need no transpose copies. Pointers and
// strides must be multiples of 16 bytes (the wrapper checks). q, k, v are
// fp32 or bf16 and dq, dk, dv have their type; the mask, g and dm are
// fp32.
//
// Plain C interface (bound with ctypes): hamt_attention_bwd enqueues the
// kernels on the caller's stream, does not synchronise, and returns the
// first cudaError_t.

#include <cooperative_groups.h>

#include "attention_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace hamt;

// the forward's tiling (attention.cu)
constexpr int kBQ = 32;          // most query rows per CTA
constexpr int kLanesPerRow = 8;  // threads that share one score row
constexpr int kRowsPerThread = 2;
constexpr int kThreadsBwd = kBQ / kRowsPerThread * kLanesPerRow;  // 128
constexpr int kWarpRows = 32 / kLanesPerRow * kRowsPerThread;     // 8 rows per warp
constexpr int kColsSmall = 5, kColsMid = 9, kColsLarge = 32;
constexpr int kMaxLk = kLanesPerRow * kColsLarge;
constexpr int kKeys = 8;        // keys per thread in the dV and dK passes
constexpr int kMaxCluster = 8;  // the portable thread-block cluster size
constexpr int kReduceThreads = 256;

__host__ __device__ constexpr int padded_keys(int Lk) {
  return Lk <= kLanesPerRow * kColsSmall ? kLanesPerRow * kColsSmall
         : Lk <= kLanesPerRow * kColsMid ? kLanesPerRow * kColsMid
                                         : (Lk + kLanesPerRow - 1) / kLanesPerRow * kLanesPerRow;
}

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const float* m;
  const float* g;
  void* dq;
  void* dk;
  void* dv;
  float* dk_part;  // (nqb, B * H, Lk, Dh) fp32 partials when nqb > kMaxCluster
  float* dv_part;
  float* dm_part;  // (nqb, B, H, Lk) fp32 column sums of ds, or null: no dm
  int H, BH, Lq, Lk, Dh;
  int nqb, bq;  // query blocks per pair and rows per block: ceil(Lq / nqb) <= kBQ
  int cluster;  // 1 < nqb <= kMaxCluster: a pair's CTAs form one cluster
  // element strides (batch, head, row) of q, k, v, g, dq, dk, dv and
  // (batch, col) of m
  long long qs[3], ks[3], vs[3], gs[3], dqs[3], dks[3], dvs[3], ms[2];
  float scale;
  uint32_t seed;
  uint32_t thresh;
  float inv_keep;
  int dropout;
};

// Shared memory, in floats, every region 16-byte aligned: K and V (lkp
// rows of pitch Dh + 4 each), the mask (lkp), the Q and G blocks (kBQ
// rows of pitch Dh + 4 each), pd and ds (kBQ rows of pitch lkp + 4 each).
// pd lies over V, which no thread reads once dP is computed, wherever it
// fits there (every head width but 16). lkp is padded_keys(Lk), a
// multiple of 8; K and V rows [Lk, lkp) are zero.
struct Layout {
  int lkp, kp, pp;
  size_t k_off, v_off, m_off, q_off, g_off, pd_off, ds_off, floats;
};

__host__ __device__ inline Layout layout(int Lk, int Dh) {
  Layout L;
  L.lkp = padded_keys(Lk);
  L.kp = Dh + 4;
  L.pp = L.lkp + 4;  // 2 * pp = 8 or 24 mod 32: a warp's stores hit distinct banks
  L.k_off = 0;
  L.v_off = (size_t)L.lkp * L.kp;
  L.m_off = L.v_off + (size_t)L.lkp * L.kp;
  L.q_off = L.m_off + L.lkp;
  L.g_off = L.q_off + (size_t)kBQ * L.kp;
  size_t end = L.g_off + (size_t)kBQ * L.kp;
  const size_t tile = (size_t)kBQ * L.pp;
  const bool pd_over_v = tile <= (size_t)L.lkp * L.kp;
  L.pd_off = pd_over_v ? L.v_off : end;
  if (!pd_over_v) end += tile;
  L.ds_off = end;
  L.floats = end + tile;
  return L;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v) {
  // round to nearest even, as torch's .to(); element d at the lower address
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 w;
  w.x = *reinterpret_cast<const unsigned*>(&lo);
  w.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = w;
}

__device__ __forceinline__ float4 scaled(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

__device__ __forceinline__ void add4(float4& acc, float4 b) {
  acc.x += b.x;
  acc.y += b.y;
  acc.z += b.z;
  acc.w += b.w;
}

// acc += a * b, elementwise over b
__device__ __forceinline__ void fma4(float4& acc, float a, float4 b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

// s[r][c] = sum over d, in order, of A[r][d] * B[8 c][d] for the thread's
// 2 rows of A (from `ar`) and its nc columns (rows of B from `br`, 8 rows
// apart), both of pitch DH + 4 floats. Only the large tier has nc < MAXC.
template <int DH, int MAXC>
__device__ __forceinline__ void tile_products(float (&s)[kRowsPerThread][MAXC],
                                              const float* ar, const float* br, int nc) {
  constexpr int KP = DH + 4;
  constexpr bool kBounded = MAXC == kColsLarge;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
    for (int c = 0; c < MAXC; ++c) s[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; d += 4) {
    float4 a[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) a[r] = ld4(ar + r * KP + d);
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (kBounded && c >= nc) break;
      const float4 bv = ld4(br + c * kLanesPerRow * KP + d);
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        s[r][c] = fmaf(a[r].x, bv.x, s[r][c]);
        s[r][c] = fmaf(a[r].y, bv.y, s[r][c]);
        s[r][c] = fmaf(a[r].z, bv.z, s[r][c]);
        s[r][c] = fmaf(a[r].w, bv.w, s[r][c]);
      }
    }
  }
}

// Where a CTA's dV and dK tiles go: straight to the outputs (the pair
// has one query block), to the CTA's shared memory for the cluster's sum
// (up to kMaxCluster blocks), or to fp32 partials in global scratch for
// attention_bwd_reduce_kernel (more blocks).
enum { kDirect, kCluster, kScratch };

// acc[i] = sum over the block's nq rows, in row order, of P[r][j + i] *
// X[r][4 td .. 4 td + 3] for the thread's kKeys keys: pc = P + j (pd or
// ds, pitch pp), xc = X + 4 td (G or Q, pitch DH + 4). Per row two float4s
// of P and one of X feed 32 FMAs.
template <int DH>
__device__ __forceinline__ void key_products(float4 (&acc)[kKeys], const float* pc, int pp,
                                             const float* xc, int nq) {
  constexpr int KP = DH + 4;
#pragma unroll
  for (int i = 0; i < kKeys; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int r = 0; r < nq; ++r) {
    const float4 a0 = ld4(pc + r * pp);
    const float4 a1 = ld4(pc + r * pp + 4);
    const float4 x = ld4(xc + r * KP);
    fma4(acc[0], a0.x, x);
    fma4(acc[1], a0.y, x);
    fma4(acc[2], a0.z, x);
    fma4(acc[3], a0.w, x);
    fma4(acc[4], a1.x, x);
    fma4(acc[5], a1.y, x);
    fma4(acc[6], a1.z, x);
    fma4(acc[7], a1.w, x);
  }
}

// Stores key rows j + i < Lk of the thread's tile by `mode`: out (the
// output row j of the thread's 4 d, row stride out_ld) scaled by s, in
// the output type; part (the block's fp32 partial at row j, pitch DH);
// or tile (the CTA's shared memory at row j, pitch DH + 4).
template <typename T, int DH>
__device__ __forceinline__ void store_keys(const float4 (&acc)[kKeys], int j, int Lk, float s,
                                           int mode, T* out, long long out_ld, float* part,
                                           float* tile) {
#pragma unroll
  for (int i = 0; i < kKeys; ++i) {
    if (j + i >= Lk) break;
    if (mode == kDirect) {
      st4(out + (j + i) * out_ld, scaled(acc[i], s));
    } else if (mode == kCluster) {
      st4(tile + (j + i) * (DH + 4), acc[i]);
    } else {
      st4(part + (size_t)(j + i) * DH, acc[i]);
    }
  }
}

template <typename T, int DH, int MAXC>
__global__ void __launch_bounds__(kThreadsBwd, MAXC == kColsSmall ? 4 : MAXC == kColsMid ? 2 : 1)
    attention_bwd_kernel(BwdParams p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int KP = DH + 4;
  constexpr int DG = DH / 4;  // float4 groups along Dh
  constexpr bool kBounded = MAXC == kColsLarge;
  const int Lk = p.Lk;
  const Layout L = layout(Lk, DH);
  const int PP = L.pp;
  float* ks = smem + L.k_off;
  float* vs = smem + L.v_off;
  float* ms = smem + L.m_off;
  float* qs = smem + L.q_off;
  float* gs = smem + L.g_off;
  float* pds = smem + L.pd_off;  // over V where it fits: written after the barrier past dP
  float* dss = smem + L.ds_off;  // dp, then the dropped dp, then ds

  const int bh = blockIdx.x / p.nqb;
  const int qb = blockIdx.x - bh * p.nqb;
  const int q0 = qb * p.bq;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int nq = max(0, min(p.bq, p.Lq - q0));  // rows of this block inside Lq

  // ---- staging: G block and V (group 0), Q block and K (group 1), the mask
  stage_rows<float, DH, kThreadsBwd>(gs, KP, p.g + b * p.gs[0] + h * p.gs[1] + q0 * p.gs[2],
                                     p.gs[2], nq, kBQ);
  stage_rows<T, DH, kThreadsBwd>(
      vs, KP, static_cast<const T*>(p.v) + b * p.vs[0] + h * p.vs[1], p.vs[2], Lk, L.lkp);
  cp_async_commit();
  stage_rows<T, DH, kThreadsBwd>(
      qs, KP, static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[1] + q0 * p.qs[2], p.qs[2],
      nq, kBQ);
  stage_rows<T, DH, kThreadsBwd>(
      ks, KP, static_cast<const T*>(p.k) + b * p.ks[0] + h * p.ks[1], p.ks[2], Lk, L.lkp);
  cp_async_commit();
  for (int j = threadIdx.x; j < Lk; j += kThreadsBwd) ms[j] = p.m[b * p.ms[0] + j * p.ms[1]];
  cp_async_wait<1>();
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const bool active = warp * kWarpRows < nq;  // the warp owns block rows 8 * warp .. + 7
  const int tx = threadIdx.x & (kLanesPerRow - 1);
  const int r0 = (threadIdx.x / kLanesPerRow) * kRowsPerThread;  // first score row
  const int nc = L.lkp / kLanesPerRow;  // score columns per thread: tx + 8 c
  float s[kRowsPerThread][MAXC];

  // ---- dP = G V^T, parked in the ds buffer
  if (active) {
    tile_products<DH, MAXC>(s, gs + r0 * KP, vs + tx * KP, nc);
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
      for (int c = 0; c < MAXC; ++c)
        if (!kBounded || c < nc) dss[(r0 + r) * PP + tx + c * kLanesPerRow] = s[r][c];
  }

  cp_async_wait<0>();
  __syncthreads();  // Q and K have landed, and no warp reads V any more

  if (active) {
    // ---- S = Q K^T in the same registers
    tile_products<DH, MAXC>(s, qs + r0 * KP, ks + tx * KP, nc);

    // ---- the forward's softmax, then the VJP through the keep mask
    const uint32_t key = dropout_key(p.seed, b, h);
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        const int j = tx + c * kLanesPerRow;
        s[r][c] = j < Lk ? s[r][c] * p.scale + ms[min(j, Lk - 1)] : -INFINITY;
        mx = fmaxf(mx, s[r][c]);
      }
      mx = group_max<kLanesPerRow>(mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        s[r][c] = expf(s[r][c] - mx);
        sum += s[r][c];
      }
      const float inv = 1.f / group_sum<kLanesPerRow>(sum);
#pragma unroll
      for (int c = 0; c < MAXC; ++c) s[r][c] *= inv;  // p

      const int row = r0 + r;
      const bool live = row < nq;
      float* pdr = pds + row * PP + tx;
      float* dsr = dss + row * PP + tx;
      float rs = 0.f;
      if (p.dropout) {
#pragma unroll
        for (int c = 0; c < MAXC; ++c) {
          if (kBounded && c >= nc) break;
          const bool keep = dropout_keep(key, q0 + row, tx + c * kLanesPerRow, Lk, p.thresh);
          const float pd = keep ? s[r][c] * p.inv_keep : 0.f;
          const float dp = keep ? dsr[c * kLanesPerRow] * p.inv_keep : 0.f;
          rs = fmaf(dp, s[r][c], rs);
          pdr[c * kLanesPerRow] = live ? pd : 0.f;
          dsr[c * kLanesPerRow] = dp;
        }
      } else {
#pragma unroll
        for (int c = 0; c < MAXC; ++c) {
          if (kBounded && c >= nc) break;
          rs = fmaf(dsr[c * kLanesPerRow], s[r][c], rs);
          pdr[c * kLanesPerRow] = live ? s[r][c] : 0.f;
        }
      }
      rs = group_sum<kLanesPerRow>(rs);
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        if (kBounded && c >= nc) break;
        dsr[c * kLanesPerRow] = live ? s[r][c] * (dsr[c * kLanesPerRow] - rs) : 0.f;
      }
    }
    __syncwarp();  // this warp reads back only its own 8 ds rows

    // ---- dQ = ds K * scale: RO rows x 4 contiguous d per thread, summed over keys in order
    constexpr int RO = kBQ * DG / kThreadsBwd;
    static_assert(RO >= 1 && RO * (kThreadsBwd / DG) == kBQ, "rows per thread");
    const int td = threadIdx.x % DG;
    const int ro0 = (threadIdx.x / DG) * RO;
    float4 o[RO];
#pragma unroll
    for (int r = 0; r < RO; ++r) o[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    const float* sr = dss + ro0 * PP;
    const float* kc = ks + td * 4;
    const int lk4 = (Lk + 3) & ~3;  // ds columns and K rows [Lk, lk4) are zero
#pragma unroll 2
    for (int j = 0; j < lk4; j += 4) {
      const float4 k0 = ld4(kc + (j + 0) * KP);
      const float4 k1 = ld4(kc + (j + 1) * KP);
      const float4 k2 = ld4(kc + (j + 2) * KP);
      const float4 k3 = ld4(kc + (j + 3) * KP);
#pragma unroll
      for (int r = 0; r < RO; ++r) {
        const float4 d4 = ld4(sr + r * PP + j);
        fma4(o[r], d4.x, k0);
        fma4(o[r], d4.y, k1);
        fma4(o[r], d4.z, k2);
        fma4(o[r], d4.w, k3);
      }
    }
    T* dqb = static_cast<T*>(p.dq) + b * p.dqs[0] + h * p.dqs[1] + td * 4;
#pragma unroll
    for (int r = 0; r < RO; ++r)
      if (ro0 + r < nq) st4(dqb + (q0 + ro0 + r) * p.dqs[2], scaled(o[r], p.scale));
  }
  __syncthreads();  // every warp's pd and ds rows are in place, and no warp reads K any more

  // ---- dV = pd^T G_blk, then dK = ds^T Q_blk: kKeys keys x 4 d per
  // thread, summed over the block's rows in order
  constexpr int KG = kThreadsBwd / DG;  // key groups per pass
  const int td = threadIdx.x % DG;
  const int j0 = kKeys * (threadIdx.x / DG);
  const int mode = p.nqb == 1 ? kDirect : p.cluster ? kCluster : kScratch;
  const size_t part_row = ((size_t)qb * p.BH + bh) * Lk;  // row (qb, b, h, 0) of a partial
  T* dvb = static_cast<T*>(p.dv) + b * p.dvs[0] + h * p.dvs[1];
  T* dkb = static_cast<T*>(p.dk) + b * p.dks[0] + h * p.dks[1];
  float4 acc[kKeys];
  for (int j = j0; j < Lk; j += kKeys * KG) {
    key_products<DH>(acc, pds + j, PP, gs + td * 4, nq);
    store_keys<T, DH>(acc, j, Lk, 1.f, mode, dvb + td * 4, p.dvs[2],
                      p.dv_part + part_row * DH + td * 4, ks + td * 4);
  }
  __syncthreads();  // pd, over V, is read no more: the cluster's dK tile takes its place
  for (int j = j0; j < Lk; j += kKeys * KG) {
    key_products<DH>(acc, dss + j, PP, qs + td * 4, nq);
    store_keys<T, DH>(acc, j, Lk, p.scale, mode, dkb + td * 4, p.dks[2],
                      p.dk_part + part_row * DH + td * 4, vs + td * 4);
    if (p.dm_part != nullptr && td == 0) {  // the block's column sums of ds
      float4 c0 = make_float4(0.f, 0.f, 0.f, 0.f), c1 = c0;
      for (int r = 0; r < nq; ++r) {
        add4(c0, ld4(dss + r * PP + j));
        add4(c1, ld4(dss + r * PP + j + 4));
      }
      const float sums[kKeys] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int i = 0; i < kKeys; ++i)
        if (j + i < Lk) p.dm_part[part_row + j + i] = sums[i];
    }
  }

  if (mode == kCluster) {
    // ---- the pair's sum over its query blocks: the cluster's CTAs, in
    // rank order (rank = qb), each CTA for its slice of the keys
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every CTA's dV tile (over K) and dK tile (over V) is in place
    const int per = (Lk + p.nqb - 1) / p.nqb;
    const int k0 = qb * per;
    const int n = (min(Lk, k0 + per) - k0) * DG;
    for (int i = threadIdx.x; i < n; i += kThreadsBwd) {
      const int j = k0 + i / DG;
      const int d = (i % DG) * 4;
      float4 sv = make_float4(0.f, 0.f, 0.f, 0.f), sk = sv;
      for (int r = 0; r < p.nqb; ++r) {
        add4(sv, ld4(cluster.map_shared_rank(ks, r) + j * KP + d));
        add4(sk, ld4(cluster.map_shared_rank(vs, r) + j * KP + d));
      }
      st4(dvb + j * p.dvs[2] + d, sv);
      st4(dkb + j * p.dks[2] + d, scaled(sk, p.scale));
    }
    cluster.sync();  // no CTA leaves while another reads its shared memory
  }
}

// dk and dv from their (nqb, B * H, Lk, Dh) fp32 partials: summed over the
// query blocks in block order, dk scaled, stored in the input type through
// the outputs' strides. One thread per 4 contiguous d.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads) attention_bwd_reduce_kernel(BwdParams p) {
  const int dg = p.Dh / 4;
  const long long i = (long long)blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= (long long)p.BH * p.Lk * dg) return;
  const int td = (int)(i % dg);
  const long long row = i / dg;  // bh * Lk + j
  const int j = (int)(row % p.Lk);
  const int bh = (int)(row / p.Lk);
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const size_t plane = (size_t)p.BH * p.Lk * p.Dh;
  const float* pk = p.dk_part + row * p.Dh + td * 4;
  const float* pv = p.dv_part + row * p.Dh + td * 4;
  float4 sk = ld4(pk), sv = ld4(pv);
  for (int qb = 1; qb < p.nqb; ++qb) {
    add4(sk, ld4(pk + qb * plane));
    add4(sv, ld4(pv + qb * plane));
  }
  st4(static_cast<T*>(p.dk) + b * p.dks[0] + h * p.dks[1] + j * p.dks[2] + td * 4,
      scaled(sk, p.scale));
  st4(static_cast<T*>(p.dv) + b * p.dvs[0] + h * p.dvs[1] + j * p.dvs[2] + td * 4, sv);
}

// dm[b, j] = sum over query blocks, then heads, in order, of
// dm_part[qb, b, h, j]; dm is (B, Lk) contiguous fp32.
__global__ void attention_bwd_dm_kernel(const float* dm_part, float* dm, int B, int H, int Lk,
                                        int nqb) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * Lk) return;
  const int b = i / Lk;
  const int j = i - b * Lk;
  float acc = 0.f;
  for (int qb = 0; qb < nqb; ++qb) {
    const float* src = dm_part + ((size_t)qb * B + b) * H * Lk + j;
    for (int h = 0; h < H; ++h) acc += src[(size_t)h * Lk];
  }
  dm[i] = acc;
}

template <typename T, int DH, int MAXC>
cudaError_t launch_tile(const BwdParams& p, long long ctas, cudaStream_t stream) {
  const size_t bytes = layout(p.Lk, DH).floats * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(attention_bwd_kernel<T, DH, MAXC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return err;
  }
  if (!p.cluster) {
    attention_bwd_kernel<T, DH, MAXC><<<(unsigned)ctas, kThreadsBwd, bytes, stream>>>(p);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ctas);
  cfg.blockDim = dim3(kThreadsBwd);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.nqb;  // a pair's query blocks, consecutive in blockIdx.x
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, attention_bwd_kernel<T, DH, MAXC>, p);
}

template <typename T, int DH>
cudaError_t launch_cols(const BwdParams& p, long long ctas, cudaStream_t stream) {
  if (p.Lk <= kLanesPerRow * kColsSmall) return launch_tile<T, DH, kColsSmall>(p, ctas, stream);
  if (p.Lk <= kLanesPerRow * kColsMid) return launch_tile<T, DH, kColsMid>(p, ctas, stream);
  return launch_tile<T, DH, kColsLarge>(p, ctas, stream);
}

template <typename T>
cudaError_t launch_bwd(const BwdParams& p, float* dm, cudaStream_t stream) {
  const long long ctas = (long long)p.BH * p.nqb;
  if (p.Lk > kMaxLk || ctas > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  const bool scratch = p.nqb > kMaxCluster;
  if (scratch && (p.dk_part == nullptr || p.dv_part == nullptr)) return cudaErrorInvalidValue;
  if ((p.dm_part == nullptr) != (dm == nullptr)) return cudaErrorInvalidValue;
  cudaError_t err;
  switch (p.Dh) {
    case 16: err = launch_cols<T, 16>(p, ctas, stream); break;
    case 32: err = launch_cols<T, 32>(p, ctas, stream); break;
    case 64: err = launch_cols<T, 64>(p, ctas, stream); break;
    case 128: err = launch_cols<T, 128>(p, ctas, stream); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  if (scratch) {
    const long long n = (long long)p.BH * p.Lk * (p.Dh / 4);
    attention_bwd_reduce_kernel<T>
        <<<(unsigned)((n + kReduceThreads - 1) / kReduceThreads), kReduceThreads, 0, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (dm == nullptr) return cudaSuccess;
  const int B = p.BH / p.H, n = B * p.Lk, threads = 256;
  attention_bwd_dm_kernel<<<(n + threads - 1) / threads, threads, 0, stream>>>(
      p.dm_part, dm, B, p.H, p.Lk, p.nqb);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Query blocks (CTAs per (batch, head)) of a call over Lq rows: the
// depth of its dm scratch, and of its dk / dv scratch when it needs one.
int hamt_attention_bwd_query_blocks(int Lq) { return (Lq + kBQ - 1) / kBQ; }

// Whether a call over Lq rows sums its dk / dv partials through global
// scratch (more query blocks than a cluster holds, Lq > 256) rather than
// in the cluster's shared memory.
int hamt_attention_bwd_needs_scratch(int Lq) {
  return hamt_attention_bwd_query_blocks(Lq) > kMaxCluster;
}

// Bytes of dynamic shared memory one CTA of the backward needs (the
// wrapper checks it against the card's 227 KB per-block limit).
long long hamt_attention_bwd_smem_bytes(int Lk, int Dh) {
  return (long long)(layout(Lk, Dh).floats * sizeof(float));
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dq, dk, dv share it).
// strides: 23 element strides, in this order: q, k, v, g, dq, dk, dv
// (batch, head, row each) and m (batch, col); Dh is contiguous and one
// of 16, 32, 64, 128; Lk <= 256; every pointer and stride of q, k, v, g,
// dq, dk, dv a multiple of 16 bytes. With nqb =
// hamt_attention_bwd_query_blocks(Lq): dk_part and dv_part are
// (nqb, B * H, Lk, Dh) contiguous fp32 scratch where
// hamt_attention_bwd_needs_scratch(Lq), else null; dm_part, a
// (nqb, B, H, Lk) contiguous fp32 scratch, and dm, the (B, Lk) contiguous
// fp32 output, are both null when the mask's cotangent is not wanted.
// Returns a cudaError_t.
int hamt_attention_bwd(const void* q, const void* k, const void* v, const float* m,
                       const float* g, void* dq, void* dk, void* dv, float* dk_part,
                       float* dv_part, float* dm_part, float* dm, int dtype, int B, int H,
                       int Lq, int Lk, int Dh, const long long* strides, float scale,
                       unsigned int seed, unsigned int thresh, float inv_keep, int dropout,
                       void* stream) {
  BwdParams p;
  p.q = q; p.k = k; p.v = v; p.m = m; p.g = g;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.dk_part = dk_part; p.dv_part = dv_part; p.dm_part = dm_part;
  p.H = H; p.BH = B * H; p.Lq = Lq; p.Lk = Lk; p.Dh = Dh;
  p.nqb = hamt_attention_bwd_query_blocks(Lq);
  p.bq = (Lq + p.nqb - 1) / p.nqb;
  p.cluster = p.nqb > 1 && p.nqb <= kMaxCluster;
  long long* dst[7] = {p.qs, p.ks, p.vs, p.gs, p.dqs, p.dks, p.dvs};
  for (int t = 0; t < 7; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  p.ms[0] = strides[21];
  p.ms[1] = strides[22];
  p.scale = scale; p.seed = seed; p.thresh = thresh;
  p.inv_keep = inv_keep; p.dropout = dropout;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_bwd<float>(p, dm, s);
  if (dtype == 1) return (int)launch_bwd<__nv_bfloat16>(p, dm, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
