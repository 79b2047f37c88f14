// Key-blocked fused masked attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel vln_hamt_tpu/ops/attention.py:_attn_bwd_kernel
// (pallas_call at :257, reached through the custom VJP of
// _fused_attention_core) for the shapes the whole-row backward
// (attention_bwd.cu) does not take: more than 256 keys, a head width other
// than 16, 32, 64 and 128, or a key row whose tiles do not fit one block's
// shared memory (Dh 128 past 160 keys). With attention_bwd.cu the port
// takes every shape the Pallas kernel takes up to Dh 128. For one (batch,
// head) pair, with the forward out = dropout(softmax(q k^T * scale + m)) v
// and its fp32 cotangent g:
//
//     p   = softmax(q k^T * scale + m)          recomputed, not stored
//     pd  = keep ? p / (1 - rate) : 0           the forward's dropped p
//     dpd = keep ? (g v^T) / (1 - rate) : 0
//     ds  = p * (dpd - D),  D = rowsum(dpd * p)
//     dv  = pd^T g,   dq = ds k * scale,   dk = ds^T q * scale
//     dm[b, :] = sum over heads and query rows of ds    (fp32)
//
// with the forward's keep mask at (global row) * Lk + (global column),
// columns past Lk at -inf (p = 0) and score * scale + mask rounded twice
// (scaled_score).
//
// What bounds it on an H100. Per pair it reads q, k, v (input type), g
// and the mask, writes dq, dk, dv (input type) and dm, and does 10 Lq Lk
// Dh FLOPs (five products). In fp32 (TF32 off, as the port runs) they run
// on the CUDA cores at 67 TFLOP/s, operations-bound: the time is set by
// how many FMAs each shared-memory load feeds. In bf16 the same FLOPs on
// the tensor cores take less than the bytes; what the kernel reaches is
// set by its extra products (the statistics pass, the split operands
// below), the exponentials, and the fp32 dq partials that pass through
// memory.
//
// Structure: three kernels, plus one with dm.
// * The statistics pass, grid over (query block, batch * head): Q and G
//   stay while the K and V blocks pass; per key block S = Q K^T and
//   dP = G V^T, and per row the running max m, the running sum l of
//   e = exp(s - m) (kept and dropped e alike: dropout acts on the
//   normalised p) and the running sum of e * dpd, rescaled as the max
//   moves. It stores m, 1 / l and D (fp32, (3, B * H, Lq)): not the
//   log-sum-exp, which at a row whose keys all read -10000 rounds to the
//   fp32 step there (about 1e-3) and would move p by as much; s - m is
//   exact. The forward is not asked to save them: the shapes this kernel
//   takes include Dh 128 with 161-192 keys, whose forward runs in the
//   whole-row kernel, which keeps no row statistics, and the saved tensors
//   of _FusedAttention, so every path's memory, stay as they are. In
//   bf16 it also writes G split into three bf16 parts (below) to a
//   scratch.
// * The key-block kernel, grid over (key block, batch * head): K and V
//   stay while the query blocks pass; per query block S, dP, p, pd, dpd
//   and ds, then dV += pd^T G and dK += ds^T Q in registers, dm's column
//   sums of ds, and the key block's partial of dQ, ds K, into an fp32
//   (key blocks, B * H, Lq, DP) scratch.
// * The dq pass sums the partials over the key blocks in order, scales
//   and stores dq in the input type; the dm pass sums the key-block
//   kernel's column sums over heads in order. No atomics: every sum runs
//   in a fixed order, so the result is deterministic.
//
// Staging. K, V and the mask of a key block (statistics pass) and Q, G and
// the row statistics of a query block (key-block kernel) go through a ring
// of two stages in shared memory by cp.async, issued right after the
// block's barrier so the copies run while the products run:
// * q, k and v by 16-byte copies with a source size (zeros past Dh and
//   past the block's rows) where the wrapper finds all three on the
//   16-byte rule of ops/attention.py:_misalignment, else by element loads
//   (ops/attention.py:blocked_staging, the staging flag); fp32 g always
//   by 16-byte copies (ops/attention.py:_kernel_cotangent hands it over
//   with 16-byte aligned rows), and bf16 G's three tiles from the scratch
//   likewise; the mask and the statistics by 4-byte copies.
// * Each kernel waits for its own copies of block j and passes one
//   barrier, which also proves every warp done with block j - 1, whose
//   stage the copies of block j + 1 then overwrite. The key-block kernels
//   have one more barrier per block, where pd and ds (fp32) or dS (bf16)
//   move between warps (below); the fp32 one stages Q and G once, after
//   the products that read them.
//
// bf16: mma.sync.m16n8k16 bf16 -> fp32 on the tensor cores. Q, K and V
// stay bf16 in shared memory, rows padded to DP = 16, 32, 64 or 128 at a
// pitch of DP + 8 elements (the 8 rows an ldmatrix phase reads fall into
// 8 distinct 16-byte bank groups). g, p and ds are fp32, so every product
// but Q K^T has an fp32 operand, split into three bf16 parts, hi =
// bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid) (split3: each
// difference exact in fp32, lo exact in bf16, so hi + mid + lo = x):
//   S = Q K^T 1 mma; dP = G V^T, dK += dS^T Q and dQ_part = dS K 3 each,
//   every term exact (q, k, v are bf16); dV += Pd^T G 6, both operands
//   split, the terms down to 2^-18 (hi hi; hi mid, mid hi; hi lo, lo hi,
//   mid mid), the rest below 2^-26.
// So the sums are fp32 sums of exact products, as in the plain version,
// and a bf16 output rounds as the plain version's does but where the two
// fp32 sums straddle a rounding point: the bar of 2^-8 of the largest
// value (chip_smoke.py:BWD_RTOL) fails on any such flip among the values
// within a factor 2 of the largest. Two parts each (2 mma for dP, dK and
// dQ, 3 for dV) err by about 2^-17 and flipped 1e3 roundings a tensor; one
// fell there (phase 21, dk at 257 x 257, Dh 128). PERF.md, Findings, and
// tests/test_torch_attention_bwd_split.py record both. dm, fp32, takes
// the fp32 ds's column sums. G is split once, in the statistics pass,
// which stages it anyway: it writes the three parts to a (3, B * H, Lq,
// DP) bf16 scratch, which the key-block kernel copies as tiles
// (splitting there, once per key block, cost 9 % of its time). Both
// kernels take exp as ex2.approx (__expf).
// * Statistics pass: warp w owns query rows 16 w .. 16 w + 15 of a
//   64-row block; Q's A fragments stay in registers, G's three parts come
//   by ldmatrix from the tiles the split wrote; K and V are B operands by
//   ldmatrix, two n-tiles of 8 keys per load. The accumulator
//   gives the thread rows g and g + 8, columns 8 n + 2 t, + 1 (lane =
//   4 g + t): the row statistics reduce over a quad.
// * Key-block kernel: the scores are computed transposed, S^T = K Q^T and
//   dP^T = V G^T, each warp owning a key group of 16 keys as the mma's
//   rows, so a key's mask and a column's statistics are what a thread
//   reads: warp w keys 16 w .. 16 w + 15 of a 64-key block, or at DP 128
//   warps 2 w' and 2 w' + 1 keys 16 w' .. of a 32-key block, each of the
//   pair accumulating dK and dV over half of d (one warp's would take 128
//   registers; the pair computes its S^T and dP^T twice). Then Pd^T is,
//   n-tile pair by n-tile pair, already the A fragment of dV (as the
//   forward's P is of P V): it stays in
//   registers, split in three there, with G as the B operand by
//   ldmatrix.trans. dm's column sums are the rows' sums of the fp32 dS^T,
//   before it is split, over the query blocks in order and then over the
//   quad. dS^T's three parts go to shared memory (keys x queries), which
//   frees its fp32 registers before dV and dK: the key group's warps read
//   its rows back by ldmatrix as dK's A fragments (Q the B operand), and
//   after a barrier every warp reads them by ldmatrix.trans as the A
//   fragments of dQ_part = dS K for its query rows and d n-tiles. BQ = 16
//   query rows a block (32 at DP 32); at DP 64 the registers are held to
//   168, 3 CTAs an SM (kKeyBf16Ctas).
//
// fp32: FMAs on the CUDA cores (TF32 stays off: a 3xTF32 split errs by
// about 2^-21 of sum |q_d k_d|, which near -10000, where the fp32 step is
// 2^-10, moves a fully masked lane past the bar). Rows fp32 at pitch DP +
// 4, 64-row query blocks at DP 64 (32 at the other widths) and 64-key
// blocks (32 at DP 128), register tiles in every product:
// * scores (both kernels): lane = 8 y + x of warp w holds rows
//   (BQ / 4) w + y + 4 r and columns x + 8 c; per 4 d it reads BQ / 16
//   float4 of Q (G) and BK / 8 of K (V) for as many products each.
// * keys x d (dV, dK): a thread holds KPT consecutive keys x 8 d (4 u ..
//   4 u + 3 and DP / 2 + 4 u ..), and per query row reads KPT values of
//   pd and ds and two float4 of G and of Q for 2 * 8 KPT FMAs.
// * rows x d (dQ_part): a thread holds RO rows x the same 8 d, and per 4
//   keys reads RO float4 of ds and eight of K for 32 RO FMAs.
// pd and ds pass from the first map to the others through shared memory
// (queries x keys, pitch BK + 8), with a barrier.
//
// Plain C interface (bound with ctypes): hamt_attention_bwd_blocked
// enqueues the kernels on the caller's stream, does not synchronise, and
// returns the first cudaError_t.

#include "attention_blocked.cuh"

namespace {

using namespace hamt;
using namespace hamt::blocked;

constexpr int kReduceThreads = 256;
constexpr int kStages = 2;
// ops/attention.py:blocked_staging's flag: q, k and v by 16-byte copies
constexpr int kAsyncQKV = 1;

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const float* m;
  const float* g;
  void* dq;
  void* dk;
  void* dv;
  float* dq_part;  // (nkb, B * H, Lq, DP) fp32
  float* stats;    // (3, B * H, Lq) fp32: each row's max, 1 / sum and D
  uint32_t* gsplit;  // bf16: (3, B * H, Lq, DP) bf16 G hi, mid and lo (pairs), or null
  float* dm_part;  // (B * H, Lk) fp32 column sums of ds, or null: no dm
  int H, BH, Lq, Lk, Dh, DP, nkb, staging;
  // element strides (batch, head, row) of q, k, v, g, dq, dk, dv and
  // (batch, col) of m
  long long qs[3], ks[3], vs[3], gs[3], dqs[3], dks[3], dvs[3], ms[2];
  float scale;
  uint32_t seed;
  uint32_t thresh;
  float inv_keep;  // 1 / (1 - rate); 1 without dropout
  int dropout;
};

// Keys of a key block at padded width DP, both types: 64, or 32 at DP 128.
__host__ __device__ constexpr int key_block(int DP) { return DP == 128 ? 32 : 64; }

// Query rows of a statistics-pass block and of a key-block kernel's
// query block, and keys of a key block, by type and padded width. The
// bf16 key-block kernel takes 16 query rows (32 at DP 32): the scores'
// registers are what it trades for 3 CTAs an SM at DP 64 (at 36 x 301
// keys the kernel ran 11 % faster at 32 rows than at 64; 16 rows, 1.5 %
// faster again over phase 21's launches; PERF.md, Findings). fp32 takes 64
// at DP 64 only: at 16 and 32 the tiles of 64 rows pass 48 KB, and the
// --tiny ViT's 5 x 5 backward took 35 % longer; at 128 the registers.
template <typename T, int DP>
struct Blocks {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int BQ_STATS = kBf16 || DP == 64 ? 64 : 32;
  static constexpr int BQ = kBf16 ? (DP == 32 ? 32 : 16) : (DP == 64 ? 64 : 32);
  static constexpr int BK = key_block(DP);
};

// Where a CTA of the statistics pass works, its (batch, head) pair and
// query block, and of the key-block kernel, its pair and key block.
struct Block {
  int bh, b, h, r0, n;
};

__device__ __forceinline__ Block block_of(const BwdParams& p, int rows, int extent) {
  const int per = (extent + rows - 1) / rows;
  const int bh = blockIdx.x / per;
  const int r0 = (blockIdx.x - bh * per) * rows;
  return {bh, bh / p.H, bh % p.H, r0, min(rows, extent - r0)};
}

template <typename T>
__device__ __forceinline__ const T* pair_base(const void* base, const long long (&s)[3],
                                              const Block& blk) {
  return static_cast<const T*>(base) + blk.b * s[0] + blk.h * s[1];
}

// The row statistics of query rows [r0, r0 + n) into dst[3][BQ] (zero
// past n), by 4-byte cp.async.
template <int BQ>
__device__ __forceinline__ void stage_stats(float* dst, const BwdParams& p, int bh, int r0,
                                            int n) {
  const size_t plane = (size_t)p.BH * p.Lq;
  const float* src = p.stats + (size_t)bh * p.Lq + r0;
  for (int i = threadIdx.x; i < 3 * BQ; i += kTileThreads) {
    const int t = i / BQ, r = i - t * BQ;
    cp_async4_zfill(dst + i, r < n ? src + t * plane + r : src, r < n ? 4 : 0);
  }
}

// ===================================================== bf16 kernels
// Two fp32 values as three bf16 parts each, packed as mma operands (the
// first value in the low half): hi = bf16(x), mid = bf16(x - hi), lo =
// bf16(x - hi - mid). Each difference is exact in fp32 and lo is exact in
// bf16, so hi + mid + lo = x: a product with an exact bf16 operand (q, k,
// v) is exact term by term.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x0), h1 = __float2bfloat16_rn(x1);
  const float r0 = x0 - __bfloat162float(h0), r1 = x1 - __bfloat162float(h1);
  const __nv_bfloat16 m0 = __float2bfloat16_rn(r0), m1 = __float2bfloat16_rn(r1);
  hi = pack_bf16(h0, h1);
  mid = pack_bf16(m0, m1);
  lo = pack_bf16(__float2bfloat16_rn(r0 - __bfloat162float(m0)),
                 __float2bfloat16_rn(r1 - __bfloat162float(m1)));
}

// G's (ROWS x DP) fp32 tile in `raw`, by 16-byte chunks, split into hi,
// mid and lo parts: into the tiles part[0..2] (pitch KP) and, for rows
// below n, into the scratch planes scratch + t * plane (row pitch DP), 8
// bytes a store.
template <int DP, int KP, int ROWS>
__device__ __forceinline__ void split_g(__nv_bfloat16* const (&part)[3], const float* raw,
                                        uint32_t* scratch, size_t plane, int n) {
  constexpr int C = DP / 4, RP = kTileThreads / C;
  const int c = threadIdx.x % C;
  for (int r = threadIdx.x / C; r < ROWS; r += RP) {
    const float4 x = ld4(raw + r * DP + 4 * c);
    uint2 w[3];
    split3(x.x, x.y, w[0].x, w[1].x, w[2].x);
    split3(x.z, x.w, w[0].y, w[1].y, w[2].y);
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      *reinterpret_cast<uint2*>(part[t] + r * KP + 4 * c) = w[t];
      if (r < n) *reinterpret_cast<uint2*>(scratch + t * plane + (r * DP + 4 * c) / 2) = w[t];
    }
  }
}

// Shared memory of the bf16 statistics pass, in bf16 elements: the Q tile
// and G's hi, mid and lo tiles (64 rows of pitch DP + 8 each), then the
// ring's stages, each K and V (64 rows) and the mask (64 floats as 128
// elements). G's fp32 rows land in the second stage, which block 1's
// copies take only after the first barrier.
template <int DP>
struct StatsBf16 {
  static constexpr int BQ = 64, BK = 64, KP = DP + 8;
  static constexpr int Q = 0, G = BQ * KP, RING = 4 * BQ * KP;  // G: hi, mid, lo
  static constexpr int STAGE = 2 * BK * KP + 2 * BK, RAW = RING + STAGE;
  static constexpr int BYTES = (RING + kStages * STAGE) * 2;
  static_assert(STAGE >= 2 * BQ * DP, "G's fp32 rows fit a stage");
};

template <int DP>
__global__ void __launch_bounds__(kTileThreads) stats_bf16_kernel(BwdParams p) {
  using Lay = StatsBf16<DP>;
  typedef __nv_bfloat16 T;
  constexpr int BK = Lay::BK, KP = Lay::KP, KSTEPS = DP / 16, NTK = BK / 8;
  extern __shared__ float4 smem4[];
  T* smem = reinterpret_cast<T*>(smem4);
  const Block blk = block_of(p, Lay::BQ, p.Lq);
  const int Lk = p.Lk, nkb = (Lk + BK - 1) / BK;
  const T* kg = pair_base<T>(p.k, p.ks, blk);
  const T* vg = pair_base<T>(p.v, p.vs, blk);
  const float* mg = p.m + blk.b * p.ms[0];
  const bool async16 = p.staging & kAsyncQKV;

  auto stage_block = [&](int kb) {
    const int k0 = kb * BK, nk = min(BK, Lk - k0);
    T* st = smem + Lay::RING + (kb & 1) * Lay::STAGE;
    stage_tile<T, DP, KP, BK>(st, kg + k0 * p.ks[2], p.ks[2], nk, p.Dh, async16);
    stage_tile<T, DP, KP, BK>(st + BK * KP, vg + k0 * p.vs[2], p.vs[2], nk, p.Dh, async16);
    stage_mask<BK>(reinterpret_cast<float*>(st + 2 * BK * KP), mg + k0 * p.ms[1], p.ms[1], nk);
    cp_async_commit();
  };
  stage_tile<T, DP, KP, Lay::BQ>(smem + Lay::Q,
                                 pair_base<T>(p.q, p.qs, blk) + blk.r0 * p.qs[2], p.qs[2],
                                 blk.n, p.Dh, async16);
  float* raw = reinterpret_cast<float*>(smem + Lay::RAW);
  stage_tile<float, DP, DP, Lay::BQ>(raw, pair_base<float>(p.g, p.gs, blk) + blk.r0 * p.gs[2],
                                     p.gs[2], blk.n, p.Dh, true);
  stage_block(0);
  // G split once, here: into the tiles whose A fragments dP takes, and
  // into the scratch the key-block kernel copies (rows inside Lq, zeros
  // past Dh), after a barrier, so that no thread's split depends on which
  // thread copied the chunk
  T* const gt[3] = {smem + Lay::G, smem + Lay::G + Lay::BQ * KP, smem + Lay::G + 2 * Lay::BQ * KP};
  cp_async_wait<0>();
  __syncthreads();  // G's fp32 rows (and block 0) landed everywhere
  split_g<DP, KP, Lay::BQ>(gt, raw, p.gsplit + ((size_t)blk.bh * p.Lq + blk.r0) * DP / 2,
                           (size_t)p.BH * p.Lq * DP / 2, blk.n);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool live = warp * 16 < blk.n;
  const int row0 = blk.r0 + warp * 16 + g;  // global rows row0 and row0 + 8
  const uint32_t key = dropout_key(p.seed, blk.b, blk.h);
  const int a_at = (warp * 16 + (lane & 15)) * KP + ((lane >> 4) << 3);  // A fragments
  uint32_t qf[KSTEPS][4];
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f}, arow[2] = {0.f, 0.f};

  for (int kb = 0; kb < nkb; ++kb) {
    cp_async_wait<0>();
    __syncthreads();  // block kb landed everywhere; every warp is done with block kb - 1
    if (kb + 1 < nkb) stage_block(kb + 1);
    if (!live) continue;
    if (kb == 0) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) ldsm_x4(qf[ks], smem + Lay::Q + a_at + ks * 16);
    }
    const int k0 = kb * BK, nk = min(BK, Lk - k0);
    const T* ks_ = smem + Lay::RING + (kb & 1) * Lay::STAGE;
    const T* vs_ = ks_ + BK * KP;
    const float* ms_ = reinterpret_cast<const float*>(ks_ + 2 * BK * KP);

    float s[NTK][4], dp[NTK][4];
#pragma unroll
    for (int n = 0; n < NTK; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      uint32_t gf[3][4];  // G's hi, mid and lo A fragments
#pragma unroll
      for (int u = 0; u < 3; ++u) ldsm_x4(gf[u], gt[u] + a_at + ks * 16);
#pragma unroll
      for (int np = 0; np < NTK / 2; ++np) {
        const int off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * KP + ks * 16 +
                        (((lane >> 3) & 1) << 3);
        uint32_t b[4];
        ldsm_x4(b, ks_ + off);
        mma_bf16(s[2 * np], qf[ks], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[ks], b[2], b[3]);
        ldsm_x4(b, vs_ + off);
#pragma unroll
        for (int u = 0; u < 3; ++u) {
          mma_bf16(dp[2 * np], gf[u], b[0], b[1]);
          mma_bf16(dp[2 * np + 1], gf[u], b[2], b[3]);
        }
      }
    }

    float bm[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NTK; ++n) {
      const int c = n * 8 + 2 * t;
      const float2 mc = *reinterpret_cast<const float2*>(ms_ + c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = c + (i & 1);
        s[n][i] = col < nk ? scaled_score(s[n][i], p.scale, (i & 1) ? mc.y : mc.x) : -INFINITY;
        bm[i >> 1] = fmaxf(bm[i >> 1], s[n][i]);
      }
    }
    float a[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(mrow[r], group_max<4>(bm[r]));
      // __expf, ex2.approx(x log2 e): within about 2^-22 + |x| 2^-24 of
      // exp, far inside the bf16 bars, without expf's range reduction (the
      // exponentials took 15 % of the key-block kernel's time, PERF.md,
      // Findings). The fp32 kernels keep expf
      a[r] = __expf(mrow[r] - mn);  // 0 at the first block
      mrow[r] = mn;
    }
    if (p.dropout) {  // one branch around all the keep bits: straight code without dropout
#pragma unroll
      for (int n = 0; n < NTK; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dp[n][i] = dropout_keep(key, row0 + 8 * (i >> 1), k0 + n * 8 + 2 * t + (i & 1), Lk,
                                  p.thresh)
                         ? dp[n][i] * p.inv_keep
                         : 0.f;
    }
    float sum[2] = {0.f, 0.f}, acc[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NTK; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = __expf(s[n][i] - mrow[i >> 1]);  // 0 past Lk, where dP is 0 too
        sum[i >> 1] += e;  // every e: the normaliser is the undropped sum
        acc[i >> 1] = fmaf(e, dp[n][i], acc[i >> 1]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lrow[r] = lrow[r] * a[r] + sum[r];
      arow[r] = arow[r] * a[r] + acc[r];
    }
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = group_sum<4>(lrow[r]), d = group_sum<4>(arow[r]);
    const int row = row0 + 8 * r;
    if (t == 0 && row < p.Lq) {
      const size_t plane = (size_t)p.BH * p.Lq, at = (size_t)blk.bh * p.Lq + row;
      p.stats[at] = mrow[r];
      p.stats[plane + at] = 1.f / l;
      p.stats[2 * plane + at] = d / l;
    }
  }
}

// Shared memory of the bf16 key-block kernel, in bf16 elements: K and V
// (64 rows of pitch KP = DP + 8); the ring's stages, each the Q block and
// G's hi, mid and lo tiles (BQ rows each) and the statistics (3 BQ
// floats); dS^T's hi, mid and lo parts (64 keys x BQ queries, pitch BQ +
// 8 each).
template <int DP>
struct KeyBf16 {
  // warps sharing a key group, each accumulating dK and dV over its part
  // of d: 2 at DP 128, where one warp's would take 128 registers
  static constexpr int WPK = DP == 128 ? 2 : 1;
  static constexpr int BK = Blocks<__nv_bfloat16, DP>::BK, BQ = Blocks<__nv_bfloat16, DP>::BQ;
  static constexpr int KP = DP + 8, SP = BQ + 8;
  static constexpr int K = 0, V = K + BK * KP, RING = V + BK * KP;
  static constexpr int G = BQ * KP, ST = 4 * BQ * KP;  // within a stage: Q, G's parts, stats
  static constexpr int STAGE = ST + 6 * BQ;
  static constexpr int DSA = RING + kStages * STAGE;  // dS^T's three parts
  static constexpr int BYTES = (DSA + 3 * BK * SP) * 2;
  static_assert(BK == 16 * 4 / WPK, "a key group of 16 per WPK warps");
};

// CTAs per SM the bf16 key-block kernel's registers are held to: 3 at DP
// 64 (168 registers; 2 CTAs of up to 255 ran 8-10 % slower over phase
// 21's launches, PERF.md, Findings), 2 elsewhere (ptxas's own choice
// spilled at DP 16).
template <int DP>
constexpr int kKeyBf16Ctas = DP == 64 ? 3 : 2;

template <int DP>
__global__ void __launch_bounds__(kTileThreads, kKeyBf16Ctas<DP>) key_bf16_kernel(BwdParams p) {
  using Lay = KeyBf16<DP>;
  typedef __nv_bfloat16 T;
  constexpr int BK = Lay::BK, BQ = Lay::BQ, KP = Lay::KP, SP = Lay::SP, WPK = Lay::WPK;
  constexpr int KSTEPS = DP / 16, NTQ = BQ / 8, NTD = DP / 8, NTDW = NTD / WPK;
  // dQ_part: warp w < DQW takes query rows 16 (w % MT) .. + 15 and d
  // n-tiles [NTW (w / MT), NTW (w / MT + 1)), two at least
  constexpr int MT = BQ / 16, NTW = NTD * MT / 4 < 2 ? 2 : NTD * MT / 4, DQW = NTD * MT / NTW;
  static_assert(NTW % 2 == 0 && DQW <= 4, "dQ n-tiles per warp");
  extern __shared__ float4 smem4[];
  T* smem = reinterpret_cast<T*>(smem4);
  T* const dsp = smem + Lay::DSA;  // dS^T's parts, BK * SP apart
  const Block blk = block_of(p, BK, p.Lk);
  const int Lq = p.Lq, Lk = p.Lk, nqb = (Lq + BQ - 1) / BQ, k0 = blk.r0, nk = blk.n;
  const int kb = k0 / BK;
  const bool async16 = p.staging & kAsyncQKV;
  const T* qg = pair_base<T>(p.q, p.qs, blk);
  const size_t gplane = (size_t)p.BH * Lq * DP;  // bf16 elements
  const T* gsplit = reinterpret_cast<const T*>(p.gsplit) + (size_t)blk.bh * Lq * DP;

  stage_tile<T, DP, KP, BK>(smem + Lay::K, pair_base<T>(p.k, p.ks, blk) + k0 * p.ks[2], p.ks[2],
                            nk, p.Dh, async16);
  stage_tile<T, DP, KP, BK>(smem + Lay::V, pair_base<T>(p.v, p.vs, blk) + k0 * p.vs[2], p.vs[2],
                            nk, p.Dh, async16);
  auto stage_block = [&](int j) {
    const int q0 = j * BQ, nq = min(BQ, Lq - q0);
    T* st = smem + Lay::RING + (j & 1) * Lay::STAGE;
    stage_tile<T, DP, KP, BQ>(st, qg + q0 * p.qs[2], p.qs[2], nq, p.Dh, async16);
    // G's split rows: DP elements, 16-byte aligned, zero past Dh already
#pragma unroll
    for (int u = 0; u < 3; ++u)
      stage_tile<T, DP, KP, BQ>(st + Lay::G + u * BQ * KP, gsplit + u * gplane + q0 * DP, DP,
                                nq, DP, true);
    stage_stats<BQ>(reinterpret_cast<float*>(st + Lay::ST), p, blk.bh, q0, nq);
    cp_async_commit();
  };
  stage_block(0);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kg = warp / WPK, dpart = warp % WPK;  // key group, part of d
  const int d0 = dpart * (DP / WPK);
  const int kr = kg * 16 + g;  // the thread's keys kr and kr + 8 of the block
  const uint32_t key = dropout_key(p.seed, blk.b, blk.h);
  float mk[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    mk[r] = kr + 8 * r < nk ? p.m[blk.b * p.ms[0] + (k0 + kr + 8 * r) * p.ms[1]] : 0.f;
  float dk[NTDW][4], dv[NTDW][4], dmc[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NTDW; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;
  const int a_off = (kg * 16 + (lane & 15)) * KP + ((lane >> 4) << 3);  // K, V as A
  const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * KP + (((lane >> 3) & 1) << 3);
  const int t_off = (lane & 15) * KP + ((lane >> 4) << 3);  // B by ldmatrix.trans

  for (int j = 0; j < nqb; ++j) {
    cp_async_wait<0>();
    __syncthreads();  // block j landed everywhere; every warp is done with block j - 1
    if (j + 1 < nqb) stage_block(j + 1);
    const int q0 = j * BQ, nq = min(BQ, Lq - q0);
    const T* qs = smem + Lay::RING + (j & 1) * Lay::STAGE;
    const T* gs = qs + Lay::G;  // G's parts, BQ * KP apart
    const float* st = reinterpret_cast<const float*>(qs + Lay::ST);

    // S^T = K Q^T and dP^T = V (G hi + G mid + G lo)^T for the warp's 16 keys
    float s[NTQ][4], dp[NTQ][4];
#pragma unroll
    for (int n = 0; n < NTQ; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, smem + Lay::K + a_off + ks * 16);
      ldsm_x4(va, smem + Lay::V + a_off + ks * 16);
#pragma unroll
      for (int np = 0; np < NTQ / 2; ++np) {
        const int off = np * 16 * KP + b_off + ks * 16;
        uint32_t b[4];
        ldsm_x4(b, qs + off);
        mma_bf16(s[2 * np], ka, b[0], b[1]);
        mma_bf16(s[2 * np + 1], ka, b[2], b[3]);
#pragma unroll
        for (int u = 0; u < 3; ++u) {
          ldsm_x4(b, gs + u * BQ * KP + off);
          mma_bf16(dp[2 * np], va, b[0], b[1]);
          mma_bf16(dp[2 * np + 1], va, b[2], b[3]);
        }
      }
    }

    // p, and in place: s <- pd, dp <- ds (fp32); element (n, i) is key
    // kr + 8 (i >> 1), query column 8 n + 2 t + (i & 1)
#pragma unroll
    for (int n = 0; n < NTQ; ++n) {
      const int c = n * 8 + 2 * t;
      const float2 mx = *reinterpret_cast<const float2*>(st + c);
      const float2 inv = *reinterpret_cast<const float2*>(st + BQ + c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool valid = kr + 8 * (i >> 1) < nk && c + (i & 1) < nq;
        s[n][i] = valid ? __expf(scaled_score(s[n][i], p.scale, mk[i >> 1]) -
                               ((i & 1) ? mx.y : mx.x)) *
                              ((i & 1) ? inv.y : inv.x)
                        : 0.f;
      }
    }
    if (p.dropout) {  // one branch around all the keep bits: straight code without dropout
#pragma unroll
      for (int n = 0; n < NTQ; ++n) {
        const int c = n * 8 + 2 * t;
        const float2 dsum = *reinterpret_cast<const float2*>(st + 2 * BQ + c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool keep = dropout_keep(key, q0 + c + (i & 1), k0 + kr + 8 * (i >> 1), Lk,
                                         p.thresh);
          const float dpd = keep ? dp[n][i] * p.inv_keep : 0.f;
          dp[n][i] = s[n][i] * (dpd - ((i & 1) ? dsum.y : dsum.x));
          s[n][i] = keep ? s[n][i] * p.inv_keep : 0.f;
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < NTQ; ++n) {
        const float2 dsum = *reinterpret_cast<const float2*>(st + 2 * BQ + n * 8 + 2 * t);
#pragma unroll
        for (int i = 0; i < 4; ++i) dp[n][i] = s[n][i] * (dp[n][i] - ((i & 1) ? dsum.y : dsum.x));
      }
    }
#pragma unroll
    for (int n = 0; n < NTQ; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) dmc[i >> 1] += dp[n][i];

    // dS^T's hi, mid and lo parts to shared memory, keys x queries: the
    // key group's warps read its rows back as dK's A fragments, every warp
    // all rows for dQ after the barrier; the fp32 ds dies here. A key
    // group's warps hold the same ds: each writes its share of the k-steps
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      if (kk % WPK != dpart) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = 2 * kk + (i >> 1), e = 2 * (i & 1);
        uint32_t w[3];
        split3(dp[n][e], dp[n][e + 1], w[0], w[1], w[2]);
        const int at = (kr + 8 * (i & 1)) * SP + kk * 16 + 2 * t + 8 * (i >> 1);
#pragma unroll
        for (int u = 0; u < 3; ++u) *reinterpret_cast<uint32_t*>(dsp + u * BK * SP + at) = w[u];
      }
    }
    if constexpr (WPK == 1) {
      __syncwarp();
    } else {  // the key group's warps, named barrier 1 + kg
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + kg), "n"(32 * WPK) : "memory");
    }

    // dV += Pd^T G with Pd and G in three parts each, the six products
    // down to 2^-18 (hi hi; hi mid, mid hi; hi lo, lo hi, mid mid); k-step
    // kk over queries 16 kk .. 16 kk + 15, whose Pd^T A fragment is
    // n-tiles 2 kk and 2 kk + 1 of the scores' accumulator
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pf[3][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = 2 * kk + (i >> 1), e = 2 * (i & 1);
        split3(s[n][e], s[n][e + 1], pf[0][i], pf[1][i], pf[2][i]);
      }
#pragma unroll
      for (int np = 0; np < NTDW / 2; ++np) {
        uint32_t gf[3][4];
#pragma unroll
        for (int u = 0; u < 3; ++u)
          ldsm_x4_trans(gf[u], gs + u * BQ * KP + kk * 16 * KP + t_off + d0 + np * 16);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float (&acc)[4] = dv[2 * np + h];
          mma_bf16(acc, pf[0], gf[0][2 * h], gf[0][2 * h + 1]);
          mma_bf16(acc, pf[0], gf[1][2 * h], gf[1][2 * h + 1]);
          mma_bf16(acc, pf[1], gf[0][2 * h], gf[0][2 * h + 1]);
          mma_bf16(acc, pf[0], gf[2][2 * h], gf[2][2 * h + 1]);
          mma_bf16(acc, pf[2], gf[0][2 * h], gf[0][2 * h + 1]);
          mma_bf16(acc, pf[1], gf[1][2 * h], gf[1][2 * h + 1]);
        }
      }
    }
    // dK += dS^T Q with dS in three parts (exact terms), after Pd died:
    // the warp's own rows of dS^T's parts as A fragments
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t df[3][4];
#pragma unroll
      for (int u = 0; u < 3; ++u)
        ldsm_x4(df[u], dsp + u * BK * SP + (kg * 16 + (lane & 15)) * SP + kk * 16 +
                           ((lane >> 4) << 3));
#pragma unroll
      for (int np = 0; np < NTDW / 2; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, qs + kk * 16 * KP + t_off + d0 + np * 16);
#pragma unroll
        for (int u = 0; u < 3; ++u) {
          mma_bf16(dk[2 * np], df[u], b[0], b[1]);
          mma_bf16(dk[2 * np + 1], df[u], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // dS^T everywhere

    // the key block's partial of dQ = (dS hi + dS mid + dS lo) K
    // (unscaled, exact terms) for query rows m0 .. m0 + 15 and d n-tiles
    // [n0, n0 + NTW)
    if (warp < DQW) {
      const int m0 = 16 * (warp % MT), n0 = NTW * (warp / MT);
      float o[NTW][4];
#pragma unroll
      for (int n = 0; n < NTW; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll 1  // unrolled, its loads hoisted past the 168 registers of DP 64
      for (int kk = 0; kk < BK / 16; ++kk) {
        const int a_at = (kk * 16 + ((lane >> 4) << 3) + (lane & 7)) * SP + m0 +
                         (((lane >> 3) & 1) << 3);
        uint32_t af[3][4];
#pragma unroll
        for (int u = 0; u < 3; ++u) ldsm_x4_trans(af[u], dsp + u * BK * SP + a_at);
#pragma unroll
        for (int np = 0; np < NTW / 2; ++np) {
          uint32_t b[4];
          ldsm_x4_trans(b, smem + Lay::K + kk * 16 * KP + t_off + n0 * 8 + np * 16);
#pragma unroll
          for (int u = 0; u < 3; ++u) {
            mma_bf16(o[2 * np], af[u], b[0], b[1]);
            mma_bf16(o[2 * np + 1], af[u], b[2], b[3]);
          }
        }
      }
      float* part = p.dq_part + ((size_t)kb * p.BH + blk.bh) * Lq * DP;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + g + 8 * r;
        if (row >= nq) continue;
        float* dst = part + (size_t)(q0 + row) * DP + n0 * 8 + 2 * t;
#pragma unroll
        for (int n = 0; n < NTW; ++n)
          *reinterpret_cast<float2*>(dst + n * 8) = make_float2(o[n][2 * r], o[n][2 * r + 1]);
      }
    }
  }

  T* dvb = static_cast<T*>(p.dv) + blk.b * p.dvs[0] + blk.h * p.dvs[1];
  T* dkb = static_cast<T*>(p.dk) + blk.b * p.dks[0] + blk.h * p.dks[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kl = kr + 8 * r;
    const float dm = group_sum<4>(dmc[r]);
    if (kl >= nk) continue;
    const int j = k0 + kl;
    if (p.dm_part != nullptr && t == 0 && dpart == 0) p.dm_part[(size_t)blk.bh * Lk + j] = dm;
#pragma unroll
    for (int n = 0; n < NTDW; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = d0 + n * 8 + 2 * t + e;
        if (d < p.Dh) {
          dvb[j * p.dvs[2] + d] = __float2bfloat16(dv[n][2 * r + e]);  // nearest even, as torch
          dkb[j * p.dks[2] + d] = __float2bfloat16(dk[n][2 * r + e] * p.scale);
        }
      }
  }
}

// ===================================================== fp32 kernels
// The scores map of both fp32 kernels: lane 8 y + x of warp w holds query
// rows (BQ / 4) w + y + 4 r (r < BQ / 16) and key columns x + 8 c (c <
// BK / 8). acc[r][c] = sum over d, in order, of A[row][d] B[col][d] for
// the A rows from `ar` (first row of the thread, rows 4 apart) and the B
// rows from `br` (first column, rows 8 apart), both of pitch KP: the rows a
// warp's lanes read at once are consecutive, in distinct banks.
template <int DP, int SR, int CPT>
__device__ __forceinline__ void score_tile(float (&acc)[SR][CPT], const float* ar,
                                           const float* br) {
  constexpr int KP = DP + 4;
#pragma unroll
  for (int r = 0; r < SR; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;
#pragma unroll (DP == 128 ? 2 : 4)  // 4 spills 12 bytes of the DP 128 statistics pass
  for (int d = 0; d < DP; d += 4) {
    float4 a[SR];
#pragma unroll
    for (int r = 0; r < SR; ++r) a[r] = ld4(ar + 4 * r * KP + d);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const float4 b = ld4(br + 8 * c * KP + d);
#pragma unroll
      for (int r = 0; r < SR; ++r) {
        acc[r][c] = fmaf(a[r].x, b.x, acc[r][c]);
        acc[r][c] = fmaf(a[r].y, b.y, acc[r][c]);
        acc[r][c] = fmaf(a[r].z, b.z, acc[r][c]);
        acc[r][c] = fmaf(a[r].w, b.w, acc[r][c]);
      }
    }
  }
}

// Shared memory of the fp32 statistics pass, in floats: the Q and G
// blocks (BQ rows of pitch DP + 4), then the ring's stages, each K and V
// (BK rows) and the mask.
template <int DP>
struct StatsF32 {
  static constexpr int BQ = Blocks<float, DP>::BQ_STATS, BK = Blocks<float, DP>::BK;
  static constexpr int KP = DP + 4;
  static constexpr int Q = 0, G = BQ * KP, RING = 2 * BQ * KP, STAGE = 2 * BK * KP + BK;
  static constexpr int BYTES = (RING + kStages * STAGE) * 4;
};

template <int DP>
__global__ void __launch_bounds__(kTileThreads) stats_f32_kernel(BwdParams p) {
  using Lay = StatsF32<DP>;
  constexpr int BQ = Lay::BQ, BK = Lay::BK, KP = Lay::KP, SR = BQ / 16, CPT = BK / 8;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Block blk = block_of(p, BQ, p.Lq);
  const int Lk = p.Lk, nkb = (Lk + BK - 1) / BK;
  const float* kg = pair_base<float>(p.k, p.ks, blk);
  const float* vg = pair_base<float>(p.v, p.vs, blk);
  const float* mg = p.m + blk.b * p.ms[0];
  const bool async16 = p.staging & kAsyncQKV;

  auto stage_block = [&](int kb) {
    const int k0 = kb * BK, nk = min(BK, Lk - k0);
    float* st = smem + Lay::RING + (kb & 1) * Lay::STAGE;
    stage_tile<float, DP, KP, BK>(st, kg + k0 * p.ks[2], p.ks[2], nk, p.Dh, async16);
    stage_tile<float, DP, KP, BK>(st + BK * KP, vg + k0 * p.vs[2], p.vs[2], nk, p.Dh, async16);
    stage_mask<BK>(st + 2 * BK * KP, mg + k0 * p.ms[1], p.ms[1], nk);
    cp_async_commit();
  };
  stage_tile<float, DP, KP, BQ>(smem + Lay::Q,
                                pair_base<float>(p.q, p.qs, blk) + blk.r0 * p.qs[2], p.qs[2],
                                blk.n, p.Dh, async16);
  stage_tile<float, DP, KP, BQ>(smem + Lay::G,
                                pair_base<float>(p.g, p.gs, blk) + blk.r0 * p.gs[2], p.gs[2],
                                blk.n, p.Dh, true);
  stage_block(0);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tx = lane & 7;                      // columns tx + 8 c
  const int sr = warp * (BQ / 4) + (lane >> 3);  // rows sr + 4 r
  const bool live = warp * (BQ / 4) < blk.n;
  const uint32_t key = dropout_key(p.seed, blk.b, blk.h);
  float mrow[SR], lrow[SR], arow[SR];  // running max (shared by the row's lanes), lane's sums
#pragma unroll
  for (int r = 0; r < SR; ++r) {
    mrow[r] = -INFINITY;
    lrow[r] = arow[r] = 0.f;
  }

  for (int kb = 0; kb < nkb; ++kb) {
    cp_async_wait<0>();
    __syncthreads();  // block kb landed everywhere; every warp is done with block kb - 1
    if (kb + 1 < nkb) stage_block(kb + 1);
    if (!live) continue;
    const int k0 = kb * BK, nk = min(BK, Lk - k0);
    const float* ks_ = smem + Lay::RING + (kb & 1) * Lay::STAGE;
    const float* vs_ = ks_ + BK * KP;
    const float* ms_ = ks_ + 2 * BK * KP;
    float s[SR][CPT], dp[SR][CPT];
    score_tile<DP, SR, CPT>(s, smem + Lay::Q + sr * KP, ks_ + tx * KP);
    score_tile<DP, SR, CPT>(dp, smem + Lay::G + sr * KP, vs_ + tx * KP);
    float mk[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) mk[c] = ms_[tx + 8 * c];
#pragma unroll
    for (int r = 0; r < SR; ++r) {
      float bm = -INFINITY;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        s[r][c] = tx + 8 * c < nk ? scaled_score(s[r][c], p.scale, mk[c]) : -INFINITY;
        bm = fmaxf(bm, s[r][c]);
      }
      const float mn = fmaxf(mrow[r], group_max<8>(bm));
      const float a = expf(mrow[r] - mn);  // 0 at the first block
      if (p.dropout) {
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          if (!dropout_keep(key, blk.r0 + sr + 4 * r, k0 + tx + 8 * c, Lk, p.thresh))
            dp[r][c] = 0.f;
      }
      float sum = 0.f, acc = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float e = expf(s[r][c] - mn);  // 0 past Lk, where dP is 0 too
        sum += e;
        acc = fmaf(e, dp[r][c] * p.inv_keep, acc);
      }
      lrow[r] = lrow[r] * a + sum;
      arow[r] = arow[r] * a + acc;
      mrow[r] = mn;
    }
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < SR; ++r) {
    const float l = group_sum<8>(lrow[r]), d = group_sum<8>(arow[r]);
    const int row = blk.r0 + sr + 4 * r;
    if (tx == 0 && row < p.Lq) {
      const size_t plane = (size_t)p.BH * p.Lq, at = (size_t)blk.bh * p.Lq + row;
      p.stats[at] = mrow[r];
      p.stats[plane + at] = 1.f / l;
      p.stats[2 * plane + at] = d / l;
    }
  }
}

// KPT floats from src into v (KPT of 1, 2 or 4, src aligned to them).
template <int KPT>
__device__ __forceinline__ void ld_vec(float (&v)[KPT], const float* src) {
  if constexpr (KPT == 4) {
    const float4 x = ld4(src);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else if constexpr (KPT == 2) {
    const float2 x = *reinterpret_cast<const float2*>(src);
    v[0] = x.x, v[1] = x.y;
  } else {
    v[0] = *src;
  }
}

// Shared memory of the fp32 key-block kernel, in floats: K and V (BK rows
// of pitch KP = DP + 4) and the mask; the Q and G blocks (BQ rows) and the
// statistics (3 BQ); pd and ds (BQ queries x BK keys, pitch BK + 8).
template <int DP>
struct KeyF32 {
  static constexpr int BQ = Blocks<float, DP>::BQ, BK = Blocks<float, DP>::BK;
  static constexpr int KP = DP + 4, PP = BK + 8;
  static constexpr int K = 0, V = BK * KP, M = 2 * BK * KP, Q = M + BK, G = Q + BQ * KP;
  static constexpr int ST = G + BQ * KP, PD = ST + 3 * BQ, DS = PD + BQ * PP;
  static constexpr int BYTES = (DS + BQ * PP) * 4;
};

template <int DP>
__global__ void __launch_bounds__(kTileThreads) key_f32_kernel(BwdParams p) {
  using Lay = KeyF32<DP>;
  constexpr int BQ = Lay::BQ, BK = Lay::BK, KP = Lay::KP, PP = Lay::PP;
  constexpr int SR = BQ / 16, CPT = BK / 8;  // the scores map
  constexpr int TG = DP / 8;                 // threads per 8 d
  constexpr int KPT = BK * TG / kTileThreads;  // keys x d: keys per thread
  // rows x d: warp w holds rows (BQ / 4) w .. as the scores map does,
  // RSTEP = 32 / TG at once, where they fill the warp; at DP 16 and 32
  // rows (DP / 8 lanes a row) the CTA holds them once, row = thread / TG
  constexpr bool kWarpRows = BQ * TG >= kTileThreads;
  constexpr int RSTEP = kWarpRows ? 32 / TG : kTileThreads / TG;
  constexpr int RO = kWarpRows ? BQ / 4 / RSTEP : 1;
  static_assert(KPT >= 1 && KPT <= 4 && RO >= 1, "thread maps");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* pds = smem + Lay::PD;
  float* dss = smem + Lay::DS;
  const Block blk = block_of(p, BK, p.Lk);
  const int Lq = p.Lq, Lk = p.Lk, nqb = (Lq + BQ - 1) / BQ, k0 = blk.r0, nk = blk.n;
  const int kb = k0 / BK;
  const bool async16 = p.staging & kAsyncQKV;
  const float* qg = pair_base<float>(p.q, p.qs, blk);
  const float* gg = pair_base<float>(p.g, p.gs, blk);

  stage_tile<float, DP, KP, BK>(smem + Lay::K, pair_base<float>(p.k, p.ks, blk) + k0 * p.ks[2],
                                p.ks[2], nk, p.Dh, async16);
  stage_tile<float, DP, KP, BK>(smem + Lay::V, pair_base<float>(p.v, p.vs, blk) + k0 * p.vs[2],
                                p.vs[2], nk, p.Dh, async16);
  stage_mask<BK>(smem + Lay::M, p.m + blk.b * p.ms[0] + k0 * p.ms[1], p.ms[1], nk);
  auto stage_block = [&](int j) {
    const int q0 = j * BQ, nq = min(BQ, Lq - q0);
    stage_tile<float, DP, KP, BQ>(smem + Lay::Q, qg + q0 * p.qs[2], p.qs[2], nq, p.Dh, async16);
    stage_tile<float, DP, KP, BQ>(smem + Lay::G, gg + q0 * p.gs[2], p.gs[2], nq, p.Dh, true);
    stage_stats<BQ>(smem + Lay::ST, p, blk.bh, q0, nq);
    cp_async_commit();
  };
  stage_block(0);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tx = lane & 7, sr = warp * (BQ / 4) + (lane >> 3);  // scores map
  const int tu = lane % TG;                                     // d 4 tu and DP / 2 + 4 tu
  const int kg0 = (threadIdx.x / TG) * KPT;                      // keys x d: keys kg0 ..
  const int orow = kWarpRows ? warp * (BQ / 4) + lane / TG : threadIdx.x / TG;  // + RSTEP r
  const uint32_t key = dropout_key(p.seed, blk.b, blk.h);
  float4 dk[KPT][2], dv[KPT][2];
  float dmc[KPT];
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    dk[i][0] = dk[i][1] = dv[i][0] = dv[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);
    dmc[i] = 0.f;
  }

  for (int j = 0; j < nqb; ++j) {
    const int q0 = j * BQ, nq = min(BQ, Lq - q0);
    // the scores map gives warp w rows (BQ / 4) w .. (BQ / 4) (w + 1) - 1:
    // a warp with none inside Lq skips them (nothing reads its rows of pd
    // and ds)
    const bool live = warp * (BQ / 4) < nq;
    cp_async_wait<0>();
    __syncthreads();  // block j's tiles everywhere; dQ of block j - 1 read ds
    if (live) {
      float s[SR][CPT], dp[SR][CPT];
      score_tile<DP, SR, CPT>(s, smem + Lay::Q + sr * KP, smem + Lay::K + tx * KP);
      score_tile<DP, SR, CPT>(dp, smem + Lay::G + sr * KP, smem + Lay::V + tx * KP);
      const float* st = smem + Lay::ST;
      float mk[CPT];  // the mask at the thread's columns, the same for its rows
#pragma unroll
      for (int c = 0; c < CPT; ++c) mk[c] = smem[Lay::M + tx + 8 * c];
#pragma unroll
      for (int r = 0; r < SR; ++r) {
        const int row = sr + 4 * r;
        const float mx = st[row], inv = st[BQ + row], dsum = st[2 * BQ + row];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int col = tx + 8 * c;
          const float pv = row < nq && col < nk
                               ? expf(scaled_score(s[r][c], p.scale, mk[c]) - mx) * inv
                               : 0.f;
          const bool keep = !p.dropout || dropout_keep(key, q0 + row, k0 + col, Lk, p.thresh);
          const float dpd = keep ? dp[r][c] * p.inv_keep : 0.f;
          pds[row * PP + col] = keep ? pv * p.inv_keep : 0.f;
          dss[row * PP + col] = pv * (dpd - dsum);
        }
      }
    }
    __syncthreads();  // pd and ds everywhere

    // dV += pd^T G, dK += ds^T Q over the block's rows in order, and dm's
    // column sums of ds
    for (int r = 0; r < nq; ++r) {
      float pv[KPT], dsv[KPT];
      ld_vec<KPT>(pv, pds + r * PP + kg0);
      ld_vec<KPT>(dsv, dss + r * PP + kg0);
      const float* gr = smem + Lay::G + r * KP + 4 * tu;
      const float* qr = smem + Lay::Q + r * KP + 4 * tu;
      const float4 g0 = ld4(gr), g1 = ld4(gr + DP / 2), x0 = ld4(qr), x1 = ld4(qr + DP / 2);
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        fma4(dv[i][0], pv[i], g0);
        fma4(dv[i][1], pv[i], g1);
        fma4(dk[i][0], dsv[i], x0);
        fma4(dk[i][1], dsv[i], x1);
        dmc[i] += dsv[i];
      }
    }
    __syncthreads();  // every warp is done with Q, G and the statistics of block j
    if (j + 1 < nqb) stage_block(j + 1);

    // the key block's partial of dQ = ds K (unscaled); ds and K are zero
    // in columns and rows [nk, nk4)
    if (orow < nq) {
      float4 o[RO][2];
#pragma unroll
      for (int r = 0; r < RO; ++r) o[r][0] = o[r][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      const int nk4 = (nk + 3) & ~3;
      const float* kc = smem + Lay::K + 4 * tu;
      const float* dr = dss + orow * PP;
#pragma unroll 2
      for (int c = 0; c < nk4; c += 4) {
        float4 x[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x[i][0] = ld4(kc + (c + i) * KP);
          x[i][1] = ld4(kc + (c + i) * KP + DP / 2);
        }
#pragma unroll
        for (int r = 0; r < RO; ++r) {
          const float4 w4 = ld4(dr + RSTEP * r * PP + c);
          const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            fma4(o[r][0], w[i], x[i][0]);
            fma4(o[r][1], w[i], x[i][1]);
          }
        }
      }
      float* part = p.dq_part + ((size_t)kb * p.BH + blk.bh) * Lq * DP + 4 * tu;
#pragma unroll
      for (int r = 0; r < RO; ++r) {
        const int row = orow + RSTEP * r;
        if (row >= nq) continue;
        float* dst = part + (size_t)(q0 + row) * DP;
        *reinterpret_cast<float4*>(dst) = o[r][0];
        *reinterpret_cast<float4*>(dst + DP / 2) = o[r][1];
      }
    }
  }

  float* dvb = static_cast<float*>(p.dv) + blk.b * p.dvs[0] + blk.h * p.dvs[1];
  float* dkb = static_cast<float*>(p.dk) + blk.b * p.dks[0] + blk.h * p.dks[1];
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int kl = kg0 + i;
    if (kl >= nk) break;
    const int jk = k0 + kl;
    if (p.dm_part != nullptr && tu == 0) p.dm_part[(size_t)blk.bh * Lk + jk] = dmc[i];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float dvv[4] = {dv[i][h].x, dv[i][h].y, dv[i][h].z, dv[i][h].w};
      const float dkv[4] = {dk[i][h].x, dk[i][h].y, dk[i][h].z, dk[i][h].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = h * (DP / 2) + 4 * tu + e;
        if (d < p.Dh) {
          dvb[jk * p.dvs[2] + d] = dvv[e];
          dkb[jk * p.dks[2] + d] = dkv[e] * p.scale;
        }
      }
    }
  }
}

// ===================================================== the sum passes
// dq from its (nkb, B * H, Lq, DP) fp32 partials: summed over the key
// blocks in order, scaled, stored in the input type. One thread per 4
// consecutive d of a row (float4 loads of each partial).
template <typename T>
__global__ void __launch_bounds__(kReduceThreads) dq_sum_kernel(BwdParams p) {
  const int quads = (p.Dh + 3) / 4;
  const long long i = (long long)blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= (long long)p.BH * p.Lq * quads) return;
  const int c = (int)(i % quads);
  const long long rowi = i / quads;  // bh * Lq + row
  const int row = (int)(rowi % p.Lq);
  const int bh = (int)(rowi / p.Lq);
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const size_t plane = (size_t)p.BH * p.Lq * p.DP;
  const float* src = p.dq_part + rowi * p.DP + 4 * c;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int kb = 0; kb < p.nkb; ++kb) {
    const float4 x = ld4(src + kb * plane);
    acc.x += x.x, acc.y += x.y, acc.z += x.z, acc.w += x.w;
  }
  const float vals[4] = {acc.x, acc.y, acc.z, acc.w};
  T* dst = static_cast<T*>(p.dq) + b * p.dqs[0] + h * p.dqs[1] + row * p.dqs[2] + 4 * c;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (4 * c + e < p.Dh) dst[e] = from_float<T>(vals[e] * p.scale);
}

// dm[b, j] = sum over heads, in order, of dm_part[b, h, j]; dm is (B, Lk)
// contiguous fp32.
__global__ void dm_sum_kernel(const float* dm_part, float* dm, int B, int H, int Lk) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * Lk) return;
  const int b = i / Lk;
  const int j = i - b * Lk;
  const float* src = dm_part + (size_t)b * H * Lk + j;
  float acc = 0.f;
  for (int h = 0; h < H; ++h) acc += src[(size_t)h * Lk];
  dm[i] = acc;
}

// ============================================================ launch
// The two tile kernels of a (dtype, padded width), their shared memory
// in bytes and the rows each CTA takes.
struct Choice {
  void (*stats)(BwdParams);
  void (*keys)(BwdParams);
  int stats_bytes, key_bytes, stats_rows, key_rows;
};

template <int DP>
Choice bf16_choice() {
  return {stats_bf16_kernel<DP>, key_bf16_kernel<DP>, StatsBf16<DP>::BYTES,
          KeyBf16<DP>::BYTES, StatsBf16<DP>::BQ, KeyBf16<DP>::BK};
}

template <int DP>
Choice f32_choice() {
  return {stats_f32_kernel<DP>, key_f32_kernel<DP>, StatsF32<DP>::BYTES, KeyF32<DP>::BYTES,
          StatsF32<DP>::BQ, KeyF32<DP>::BK};
}

template <int DP>
Choice choice(int dtype) {
  return dtype == 0 ? f32_choice<DP>() : bf16_choice<DP>();
}

Choice choose(int dtype, int Dh) {
  if (Dh < 1 || Dh > 128 || (dtype != 0 && dtype != 1)) return {};
  switch (padded_width(Dh)) {
    case 16: return choice<16>(dtype);
    case 32: return choice<32>(dtype);
    case 64: return choice<64>(dtype);
    default: return choice<128>(dtype);
  }
}

cudaError_t launch(void (*kernel)(BwdParams), int bytes, long long ctas, const BwdParams& p,
                   cudaStream_t stream) {
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(unsigned)ctas, kTileThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_sums(const BwdParams& p, float* dm, cudaStream_t stream) {
  const long long n = (long long)p.BH * p.Lq * ((p.Dh + 3) / 4);
  dq_sum_kernel<T>
      <<<(unsigned)((n + kReduceThreads - 1) / kReduceThreads), kReduceThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || dm == nullptr) return err;
  const int B = p.BH / p.H, nd = B * p.Lk;
  dm_sum_kernel<<<(nd + kReduceThreads - 1) / kReduceThreads, kReduceThreads, 0, stream>>>(
      p.dm_part, dm, B, p.H, p.Lk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The padded head width DP of a call at head width Dh (0 past 128): the
// innermost extent of its dq scratch.
int hamt_attention_blocked_width(int Dh) { return padded_width(Dh); }

// Key blocks of a call over Lk keys at head width Dh: the depth of its dq
// scratch.
int hamt_attention_bwd_blocked_key_blocks(int Lk, int Dh) {
  const int bk = key_block(padded_width(Dh));
  return (Lk + bk - 1) / bk;
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dq, dk, dv share it).
// strides: 23 element strides, in this order: q, k, v, g, dq, dk, dv
// (batch, head, row each) and m (batch, col); Dh is contiguous and 1 <= Dh
// <= 128; g's base and batch, head and row strides are multiples of 16
// bytes. staging: 1 where those of q, k and v all are too (16-byte
// cp.async), else 0 (element loads, which take any alignment of the
// type). Scratch, contiguous: dq_part (nkb, B * H, Lq, DP) fp32 with
// nkb = hamt_attention_bwd_blocked_key_blocks(Lk, Dh) and DP =
// hamt_attention_blocked_width(Dh) (16-byte aligned), stats (3, B * H, Lq)
// fp32, gsplit (3, B * H, Lq, DP) bf16 (16-byte aligned) in bf16 and null
// in fp32, and dm_part (B * H, Lk) fp32, which with dm, the (B, Lk)
// contiguous fp32 output, is null when the mask's cotangent is not
// wanted. Returns a cudaError_t.
int hamt_attention_bwd_blocked(const void* q, const void* k, const void* v, const float* m,
                               const float* g, void* dq, void* dk, void* dv, float* dq_part,
                               float* stats, void* gsplit, float* dm_part, float* dm, int dtype,
                               int B, int H, int Lq, int Lk, int Dh, const long long* strides,
                               float scale, unsigned int seed, unsigned int thresh,
                               float inv_keep, int dropout, int staging, void* stream) {
  BwdParams p;
  p.q = q; p.k = k; p.v = v; p.m = m; p.g = g;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.dq_part = dq_part; p.stats = stats; p.dm_part = dm_part;
  p.gsplit = static_cast<uint32_t*>(gsplit);
  p.H = H; p.BH = B * H; p.Lq = Lq; p.Lk = Lk; p.Dh = Dh;
  p.DP = padded_width(Dh);
  p.nkb = hamt_attention_bwd_blocked_key_blocks(Lk, Dh);
  p.staging = staging;
  long long* dst[7] = {p.qs, p.ks, p.vs, p.gs, p.dqs, p.dks, p.dvs};
  for (int t = 0; t < 7; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  p.ms[0] = strides[21];
  p.ms[1] = strides[22];
  p.scale = scale; p.seed = seed; p.thresh = thresh;
  p.inv_keep = inv_keep; p.dropout = dropout;
  const Choice c = choose(dtype, Dh);
  const long long stats_ctas = (long long)p.BH * ((Lq + c.stats_rows - 1) / c.stats_rows);
  const long long key_ctas = (long long)p.BH * p.nkb;
  if (c.stats == nullptr || Lq < 1 || Lk < 1 || stats_ctas > 0x7FFFFFFFLL ||
      key_ctas > 0x7FFFFFFFLL || (dm_part == nullptr) != (dm == nullptr) ||
      (dtype == 1 && gsplit == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch(c.stats, c.stats_bytes, stats_ctas, p, s);
  if (err == cudaSuccess) err = launch(c.keys, c.key_bytes, key_ctas, p, s);
  if (err == cudaSuccess)
    err = dtype == 0 ? launch_sums<float>(p, dm, s) : launch_sums<__nv_bfloat16>(p, dm, s);
  return (int)err;
}

// The dynamic shared memory per CTA in bytes of the statistics pass
// (kernel 0) or the key-block kernel (1) for (dtype, Dh) into *bytes, and
// the CTAs of it an SM of the current device holds at once (by shared
// memory and registers); -1 for what it does not take.
int hamt_attention_bwd_blocked_occupancy(int dtype, int Dh, int kernel, long long* bytes) {
  const Choice c = choose(dtype, Dh);
  if (c.stats == nullptr || (kernel != 0 && kernel != 1)) return -1;
  void (*fn)(BwdParams) = kernel == 0 ? c.stats : c.keys;
  const int nbytes = kernel == 0 ? c.stats_bytes : c.key_bytes;
  *bytes = nbytes;
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, nbytes) !=
      cudaSuccess)
    return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kTileThreads, nbytes) != cudaSuccess)
    return -1;
  return n;
}

}  // extern "C"
