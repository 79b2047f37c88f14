// Key-blocked fused masked attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel vln_hamt_tpu/ops/attention.py:_attn_kernel
// (pallas_call at :215, in _fused_attention_core) for the shapes the
// whole-row kernel (attention.cu) does not take: more than 256 keys, a
// head width other than 16, 32, 64 and 128, or a key row whose K and V do
// not fit one block's shared memory (Dh 128 past 192 keys). It takes any
// Lq, any Lk >= 1 and any Dh <= 128, so with attention.cu the port runs
// every shape the JAX package runs up to Dh 128. It computes what
// attention.cu computes,
//
//     out = dropout(softmax(q k^T * scale + m)) v        (fp32 output)
//
// with the same counter-hash keep mask at (global row) * Lk + (global
// column), Lk the full key count, so the mask stays bit-identical to
// vln_hamt_tpu/ops/attention.py:_dropout_keep_mask. score * scale + mask
// is rounded twice (scaled_score), as the plain version computes it.
//
// What bounds it on an H100. Per (batch, head) pair it reads q, k, v and
// the mask and writes the fp32 output once, and does 4 Lq Lk Dh FLOPs. In
// fp32 (TF32 off, as the port runs) they run on the CUDA cores at 67
// TFLOP/s: at the ViT's 301 and 577 tokens, Dh 64, that is 12-23 times
// the bytes' time at 3.35 TB/s, so the fp32 kernel is operations-bound and
// its time is set by how many FMAs each shared-memory load feeds. In bf16
// the same FLOPs on the tensor cores (989 TFLOP/s) take less than the
// bytes, so the bound is the bytes; what the kernel can reach is set by
// the exponentials and the score arithmetic around the products, which
// run on the CUDA cores in fp32 in both types.
//
// The Pallas body widens q, k and v to fp32 and both its products have
// fp32 results. A bf16 x bf16 product is exact in fp32, so the tensor
// cores' bf16 products with fp32 accumulation compute the same Q K^T up
// to the order of the sums. P is fp32 and is not rounded once to bf16:
// see "P V in bf16" below.
//
// Grid: (query block of 64 rows, batch * head), 128 threads (4 warps);
// warp w owns query rows 16w .. 16w + 15 of the block throughout, and a
// warp whose rows all lie past Lq (the ragged last block) stages but
// computes nothing. The CTA walks the keys in blocks of BK: 64, or 32 in
// fp32 at Dh 128.
//
// Staging ring. K, V and the mask of a key block go to one of two ring
// stages in shared memory; the Q block goes once to its own tile.
// * Where the wrapper finds q, k and v all on the 16-byte rule of
//   ops/attention.py:_misalignment (base and every batch, head and row
//   stride multiples of 16 bytes: every layer view at Dh 16/32/64/128 in
//   both types, and Dh 48 or 80 in bf16 or any multiple of 4 in fp32),
//   rows of all three go by 16-byte cp.async with a source size, which
//   zero-fills the bytes past Dh and whole rows past the block's keys
//   (ops/attention.py:blocked_staging, one flag for the three).
//   The mask goes by 4-byte cp.async in either case.
// * Other layouts -- the bf16 Dh 12 heads of `--tiny`, 24 bytes apart --
//   go by element loads with zeros past Dh and Lk.
// * Each thread keeps one 16-byte chunk (or one element) of a row and
//   walks rows, so staging does no per-element division.
// * One barrier per key block: at the top of block j every thread waits
//   for its own copies of block j, then __syncthreads makes all of them
//   visible and proves every warp has finished block j - 1, whose stage
//   the copies of block j + 1, issued right after the barrier, overwrite.
//   Those copies run while block j's products run.
//
// Online softmax, in both types. Per key block and row: the block's max
// over the row's lanes, the new running max m' = max(m, m_b), the factor
// a = exp(m - m') (0 at the first block), e = exp(s - m'). The running
// sum l = l a + sum(e) counts every e, kept or dropped: dropout acts on
// the normalised p, so the sum over which p is normalised is the
// undropped one. Only the accumulation into O skips the dropped e, whose
// keep bit comes from its global (row, column), applied in one branch
// taken only with dropout on, so the path without it is straight code
// (per-element branches there cost small shapes a microsecond a call).
// O is scaled by a per block and at the end by (1 / (1 - rate)) / l.
// Columns past Lk read -inf, not -10000: their e is 0, so a row whose
// real keys all read -10000 stays a softmax over the real keys. Every key
// block holds a real key, so the running max is finite after the first
// block.
//
// bf16: mma.sync.m16n8k16 bf16 -> fp32 on the tensor cores. Q, K and V
// stay bf16 in shared memory, rows padded to DP = Dh rounded up to a
// multiple of 16 (Dh 12 runs 16, 48 runs 48, 80 runs 80) at a pitch of
// DP + 8 elements, which puts the 8 rows an ldmatrix phase reads in 8
// distinct 16-byte bank groups. Fragment maps, per warp, lane = 4 g + t:
// * A = Q (16 rows x 16 d per k-step), loaded once into registers by
//   ldmatrix.x4 (lane l addresses row l % 16, d 8 (l / 16)).
// * S = Q K^T: 8 n-tiles of 8 keys; B from K rows by ldmatrix.x4, two
//   n-tiles per load (key 8 (l / 16) + l % 8, d 8 ((l / 8) % 2)). The
//   accumulator gives the thread rows g and g + 8, columns 8 n + 2 t and
//   8 n + 2 t + 1: the row statistics reduce over the 4 lanes of a quad.
// * P V: the score accumulators of n-tiles 2 k and 2 k + 1 are, element
//   for element, the A fragment of k-step k (keys 16 k .. 16 k + 15), so
//   P stays in registers; B from V by ldmatrix.x4.trans (key l % 16, d
//   8 (l / 16)), two d n-tiles per load. O: DP / 8 n-tiles, 4 floats each.
// P V in bf16. Each e (fp32, in [0, 1]) is split into hi = bf16(e) and
// lo = bf16(e - hi) (the difference is exact in fp32), and O takes
// hi V + lo V, two mma per tile. |e - hi - lo| <= 2^-9 |e - hi| <= 2^-18 e,
// so the error this adds to an output is at most 2^-18 max|v|, and of
// random sign, about 2^-18 |v| sqrt(sum p^2) -- far inside the bar of
// 1e-5 (chip_smoke.py:TOL) -- where one rounding of P to bf16 adds up to
// 2^-9 |v| (tests/test_torch_attention_split.py records both against the
// Pallas kernel). The tensor cores round each k-step's sum into the fp32
// accumulator: about 2^-23 of |O| per step, 2 Lk / 16 steps.
//
// fp32: FMAs on the CUDA cores (TF32 stays off, as resolve_device and
// chip_smoke.py set it: a 3xTF32 split errs by about 2^-21 of
// sum |q_d k_d|, which near -10000, where the fp32 step is 2^-10, moves a
// fully masked lane by far more than the 1e-5 bar). Rows are fp32 in
// shared memory, padded to DP = 16, 32, 64 or 128 at a pitch of DP + 4
// floats: a power of two, since the outputs map below spreads a row over
// DP / 8 lanes, which must divide the warp (Dh 80 runs 128 columns in
// fp32). Two register tiles:
// * scores: lane = 8 y + x of warp w holds rows 16 w + y + 4 r (r < 4) and
//   columns x + 8 c (c < BK / 8): per 4 d it reads 4 float4 of Q and
//   BK / 8 of K for 16 BK / 8 FMAs, and the 4 Q rows and the 8 K rows a
//   warp reads at once are consecutive rows, at a pitch that puts each
//   set in distinct banks. The mask of its columns is read once a block
//   for all 4 rows. The row statistics reduce over 8 lanes.
// * outputs: lane = (DP / 8) o + u holds rows 16 w + o + (256 / DP) r
//   (r < DP / 16) and d 4 u .. 4 u + 3 and DP / 2 + 4 u .. + 3: per 4 keys
//   it reads DP / 16 float4 of e and 8 of V for DP / 2 * 4 FMAs.
// e passes from the first map to the second through shared memory (pitch
// BK + 8), with the row's factor a: the scores map holds 8 keys of a row
// per thread and the outputs map all BK, so no register path exists. Both
// maps give warp w the same 16 rows, so a __syncwarp orders them.
//
// Shared memory per CTA (the dynamic allocation) and CTAs per SM, by
// shared memory alone (228 KB an SM, 1 KB of it reserved per CTA, at most
// 16 CTAs of 128 threads) and on an H100 80GB HBM3 with registers too
// (hamt_attention_fwd_blocked_occupancy; chip_smoke.py phase 21 prints
// it). ptxas gives 80-203 registers a thread and no spills.
//   bf16 DP:   16      32      48      64      80      96     112     128
//   bytes:   15872   26112   36352   46592   56832   67072   77312   87552
//   by smem:    13       8       6       4       4       3       2       2
//   H100:        6       5       4       4       3       2       2       2
//   fp32 DP:   16      32      64     128 (BK 32)
//   bytes:   45056   65536  106496  112384
//   by smem:     5       3       2       2
//   H100:        4       3       2       2
//
// O is stored element by element into the (B, Lq, H, Dh) layout for d <
// Dh and rows inside Lq.
//
// Plain C interface (bound with ctypes): hamt_attention_fwd_blocked
// returns the cudaError_t of the launch; the launch goes on the caller's
// stream and does not synchronise.

#include "attention_blocked.cuh"

namespace {

using namespace hamt;
using namespace hamt::blocked;

constexpr int kFwdThreads = 128;  // 4 warps
constexpr int kBQ64 = 64;      // query rows per CTA
constexpr int kStages = 2;     // the K / V / mask ring
// the staging flag (ops/attention.py:blocked_staging). The Q tile tests `p.staging & kAsync`
// itself: reusing the K/V ring's bool cost an fp32 instantiation 12 bytes of spills
constexpr int kAsync = 1;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* m;
  float* out;
  int H, Lq, Lk, Dh, nqb, staging;
  // element strides: (batch, head, row) of q, k, v and out, (batch, col) of m
  long long qs[3], ks[3], vs[3], os[3], ms[2];
  float scale;
  uint32_t seed;
  uint32_t thresh;
  float inv_keep;  // 1 / (1 - rate); 1 without dropout
  int dropout;
};

// Staging (stage_tile, stage_mask) and the warp-level tensor-core pieces
// (ldmatrix, mma_bf16, split2) are in attention_blocked.cuh.

// Where a CTA works: its (batch, head) pair and query block.
struct Block {
  int b, h, q0, nq;
};

__device__ __forceinline__ Block block_of(const Params& p) {
  const int bh = blockIdx.x / p.nqb;
  const int q0 = (blockIdx.x - bh * p.nqb) * kBQ64;
  return {bh / p.H, bh % p.H, q0, min(kBQ64, p.Lq - q0)};
}

// ------------------------------------------------------- bf16 kernel
// Shared memory of the bf16 kernel, in elements: the Q tile, then the
// ring's stages, each K and V (BK rows of pitch DP + 8) and the mask (BK
// floats, stored as 2 BK elements).
template <int DP>
struct Bf16Tile {
  static constexpr int BK = 64, KP = DP + 8;
  static constexpr int Q = 0, STAGE = 2 * BK * KP + 2 * BK, RING = Q + kBQ64 * KP;
  static constexpr int ELEMS = RING + kStages * STAGE;
  static constexpr int BYTES = ELEMS * 2;
};

template <int DP>
__global__ void __launch_bounds__(kFwdThreads) fwd_bf16_kernel(Params p) {
  using Lay = Bf16Tile<DP>;
  constexpr int BK = Lay::BK, KP = Lay::KP, KSTEPS = DP / 16, NTD = DP / 8, NTK = BK / 8;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem4);
  const Block blk = block_of(p);
  const int Lk = p.Lk, nkb = (Lk + BK - 1) / BK;
  typedef __nv_bfloat16 T;
  const T* kg = static_cast<const T*>(p.k) + blk.b * p.ks[0] + blk.h * p.ks[1];
  const T* vg = static_cast<const T*>(p.v) + blk.b * p.vs[0] + blk.h * p.vs[1];
  const float* mg = p.m + blk.b * p.ms[0];
  const bool async16 = p.staging & kAsync;

  auto stage_block = [&](int kb) {
    const int k0 = kb * BK, nk = min(BK, Lk - k0);
    T* st = smem + Lay::RING + (kb & 1) * Lay::STAGE;
    stage_tile<T, DP, KP, BK>(st, kg + k0 * p.ks[2], p.ks[2], nk, p.Dh, async16);
    stage_tile<T, DP, KP, BK>(st + BK * KP, vg + k0 * p.vs[2], p.vs[2], nk, p.Dh, async16);
    stage_mask<BK>(reinterpret_cast<float*>(st + 2 * BK * KP), mg + k0 * p.ms[1], p.ms[1], nk);
    cp_async_commit();
  };
  stage_tile<T, DP, KP, kBQ64>(
      smem + Lay::Q,
      static_cast<const T*>(p.q) + blk.b * p.qs[0] + blk.h * p.qs[1] + blk.q0 * p.qs[2],
      p.qs[2], blk.nq, p.Dh, p.staging & kAsync);
  stage_block(0);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const bool live = warp * 16 < blk.nq;
  const int row0 = blk.q0 + warp * 16 + g;  // global rows row0 and row0 + 8
  const uint32_t key = dropout_key(p.seed, blk.b, blk.h);
  uint32_t qf[KSTEPS][4];
  float o[NTD][4];
#pragma unroll
  for (int n = 0; n < NTD; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};  // lrow: the lane's part

  for (int kb = 0; kb < nkb; ++kb) {
    cp_async_wait<0>();
    __syncthreads();  // block kb landed everywhere; every warp is done with block kb - 1
    if (kb + 1 < nkb) stage_block(kb + 1);
    if (!live) continue;
    if (kb == 0) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
        ldsm_x4(qf[ks], smem + Lay::Q + (warp * 16 + (lane & 15)) * KP + ks * 16 +
                            ((lane >> 4) << 3));
    }
    const int k0 = kb * BK, nk = min(BK, Lk - k0);
    const T* ks_ = smem + Lay::RING + (kb & 1) * Lay::STAGE;
    const T* vs_ = ks_ + BK * KP;
    const float* ms_ = reinterpret_cast<const float*>(ks_ + 2 * BK * KP);

    float s[NTK][4];
#pragma unroll
    for (int n = 0; n < NTK; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
      for (int np = 0; np < NTK / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, ks_ + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * KP + ks * 16 +
                       (((lane >> 3) & 1) << 3));
        mma_bf16(s[2 * np], qf[ks], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[ks], b[2], b[3]);
      }

    // scale and mask, the block's row max over the quad
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
      a[r] = expf(mrow[r] - mn);  // 0 at the first block
      mrow[r] = mn;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NTK; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[n][i] = expf(s[n][i] - mrow[i >> 1]);
        sum[i >> 1] += s[n][i];  // every e: the normaliser is the undropped sum
      }
    if (p.dropout) {  // one branch around all the keep bits: straight code without dropout
#pragma unroll
      for (int n = 0; n < NTK; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (!dropout_keep(key, row0 + 8 * (i >> 1), k0 + n * 8 + 2 * t + (i & 1), Lk,
                            p.thresh))
            s[n][i] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) lrow[r] = lrow[r] * a[r] + sum[r];
#pragma unroll
    for (int n = 0; n < NTD; ++n) {
      o[n][0] *= a[0];
      o[n][1] *= a[0];
      o[n][2] *= a[1];
      o[n][3] *= a[1];
    }

    // O += (hi + lo) V, k-step kk over keys 16 kk .. 16 kk + 15
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split2(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split2(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int np = 0; np < NTD / 2; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, vs_ + (kk * 16 + (lane & 15)) * KP + np * 16 + ((lane >> 4) << 3));
        mma_bf16(o[2 * np], ph, b[0], b[1]);
        mma_bf16(o[2 * np], pl, b[0], b[1]);
        mma_bf16(o[2 * np + 1], ph, b[2], b[3]);
        mma_bf16(o[2 * np + 1], pl, b[2], b[3]);
      }
    }
  }
  if (!live) return;

  float f[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) f[r] = p.inv_keep / group_sum<4>(lrow[r]);
  float* ob = p.out + blk.b * p.os[0] + blk.h * p.os[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r;
    if (row >= blk.nq) continue;
    float* dst = ob + (blk.q0 + row) * p.os[2];
#pragma unroll
    for (int n = 0; n < NTD; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int d = n * 8 + 2 * t + i;
        if (d < p.Dh) dst[d] = o[n][2 * r + i] * f[r];
      }
  }
}

// ------------------------------------------------------- fp32 kernel
// Shared memory of the fp32 kernel, in floats, every region 16-byte
// aligned: the Q tile (64 rows of pitch DP + 4), the ring's stages (K and
// V, BK rows of pitch DP + 4 each, and the mask), the block's e (64 rows
// of pitch BK + 8), and per row the factor a and, at the end, the sum.
template <int DP>
struct F32Tile {
  static constexpr int BK = DP == 128 ? 32 : 64, KP = DP + 4, PP = BK + 8;
  static constexpr int CPT = BK / 8;   // score columns per thread
  static constexpr int TG = DP / 8;    // threads per output row
  static constexpr int NG = 32 / TG;   // output rows a warp holds at once
  static constexpr int RO = 16 / NG;   // output rows per thread
  static constexpr int Q = 0, RING = Q + kBQ64 * KP, STAGE = 2 * BK * KP + BK;
  static constexpr int P = RING + kStages * STAGE, A = P + kBQ64 * PP, L = A + kBQ64;
  static constexpr int FLOATS = L + kBQ64;
  static constexpr int BYTES = FLOATS * 4;
};

template <int DP>
__global__ void __launch_bounds__(kFwdThreads) fwd_fp32_kernel(Params p) {
  using Lay = F32Tile<DP>;
  constexpr int BK = Lay::BK, KP = Lay::KP, PP = Lay::PP, CPT = Lay::CPT;
  constexpr int TG = Lay::TG, NG = Lay::NG, RO = Lay::RO;
  static_assert(TG * NG == 32 && RO * NG == 16, "output map");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ps = smem + Lay::P;
  float* alpha = smem + Lay::A;
  float* lsum = smem + Lay::L;
  const Block blk = block_of(p);
  const int Lk = p.Lk, nkb = (Lk + BK - 1) / BK;
  const float* kg = static_cast<const float*>(p.k) + blk.b * p.ks[0] + blk.h * p.ks[1];
  const float* vg = static_cast<const float*>(p.v) + blk.b * p.vs[0] + blk.h * p.vs[1];
  const float* mg = p.m + blk.b * p.ms[0];
  const bool async16 = p.staging & kAsync;

  auto stage_block = [&](int kb) {
    const int k0 = kb * BK, nk = min(BK, Lk - k0);
    float* st = smem + Lay::RING + (kb & 1) * Lay::STAGE;
    stage_tile<float, DP, KP, BK>(st, kg + k0 * p.ks[2], p.ks[2], nk, p.Dh, async16);
    stage_tile<float, DP, KP, BK>(st + BK * KP, vg + k0 * p.vs[2], p.vs[2], nk, p.Dh, async16);
    stage_mask<BK>(st + 2 * BK * KP, mg + k0 * p.ms[1], p.ms[1], nk);
    cp_async_commit();
  };
  stage_tile<float, DP, KP, kBQ64>(
      smem + Lay::Q,
      static_cast<const float*>(p.q) + blk.b * p.qs[0] + blk.h * p.qs[1] + blk.q0 * p.qs[2],
      p.qs[2], blk.nq, p.Dh, p.staging & kAsync);
  stage_block(0);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool live = warp * 16 < blk.nq;
  const int tx = lane & 7;                   // scores: columns tx + 8 c
  const int sr = warp * 16 + (lane >> 3);    // scores: rows sr + 4 r
  const int tu = lane % TG;                  // outputs: d 4 tu and DP / 2 + 4 tu
  const int orow = warp * 16 + lane / TG;    // outputs: rows orow + NG r
  const uint32_t key = dropout_key(p.seed, blk.b, blk.h);
  float mrow[4], lrow[4];  // running max (shared by the row's lanes), lane's sum
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    mrow[r] = -INFINITY;
    lrow[r] = 0.f;
  }
  float4 o[RO][2];
#pragma unroll
  for (int r = 0; r < RO; ++r) o[r][0] = o[r][1] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int kb = 0; kb < nkb; ++kb) {
    cp_async_wait<0>();
    __syncthreads();  // block kb landed everywhere; every warp is done with block kb - 1
    if (kb + 1 < nkb) stage_block(kb + 1);
    if (!live) continue;
    const int k0 = kb * BK, nk = min(BK, Lk - k0);
    const float* ks_ = smem + Lay::RING + (kb & 1) * Lay::STAGE;
    const float* vs_ = ks_ + BK * KP;
    const float* ms_ = ks_ + 2 * BK * KP;

    float s[4][CPT];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) s[r][c] = 0.f;
    const float* qr = smem + Lay::Q + sr * KP;
    const float* kr = ks_ + tx * KP;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 a[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = ld4(qr + 4 * r * KP + d);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float4 b = ld4(kr + 8 * c * KP + d);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          s[r][c] = fmaf(a[r].x, b.x, s[r][c]);
          s[r][c] = fmaf(a[r].y, b.y, s[r][c]);
          s[r][c] = fmaf(a[r].z, b.z, s[r][c]);
          s[r][c] = fmaf(a[r].w, b.w, s[r][c]);
        }
      }
    }

    float mk[CPT];  // the mask at the thread's columns, the same for its 4 rows
#pragma unroll
    for (int c = 0; c < CPT; ++c) mk[c] = ms_[tx + 8 * c];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float bm = -INFINITY;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        s[r][c] = tx + 8 * c < nk ? scaled_score(s[r][c], p.scale, mk[c]) : -INFINITY;
        bm = fmaxf(bm, s[r][c]);
      }
      const float mn = fmaxf(mrow[r], group_max<8>(bm));
      const float a = expf(mrow[r] - mn);  // 0 at the first block
      const int row = sr + 4 * r;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        s[r][c] = expf(s[r][c] - mn);
        sum += s[r][c];  // every e: the normaliser is the undropped sum
      }
      if (p.dropout) {  // one branch around all the keep bits: straight code without dropout
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          if (!dropout_keep(key, blk.q0 + row, k0 + tx + 8 * c, Lk, p.thresh)) s[r][c] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) ps[row * PP + tx + 8 * c] = s[r][c];
      lrow[r] = lrow[r] * a + sum;
      mrow[r] = mn;
      if (tx == 0) alpha[row] = a;
    }
    __syncwarp();  // the warp reads back only its own 16 rows

#pragma unroll
    for (int r = 0; r < RO; ++r) {
      const float a = alpha[orow + NG * r];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        o[r][h] = make_float4(o[r][h].x * a, o[r][h].y * a, o[r][h].z * a, o[r][h].w * a);
    }
    // e and V are zero in columns and rows [nk, nk4)
    const int nk4 = (nk + 3) & ~3;
    const float* vc = vs_ + 4 * tu;
    const float* pr = ps + orow * PP;
#pragma unroll 2
    for (int j = 0; j < nk4; j += 4) {
      float4 x[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i][0] = ld4(vc + (j + i) * KP);
        x[i][1] = ld4(vc + (j + i) * KP + DP / 2);
      }
#pragma unroll
      for (int r = 0; r < RO; ++r) {
        const float4 pj = ld4(pr + NG * r * PP + j);
        const float w[4] = {pj.x, pj.y, pj.z, pj.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) fma4(o[r][h], w[i], x[i][h]);
      }
    }
  }
  if (!live) return;

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float l = group_sum<8>(lrow[r]);
    if (tx == 0) lsum[sr + 4 * r] = l;
  }
  __syncwarp();
  float* ob = p.out + blk.b * p.os[0] + blk.h * p.os[1];
#pragma unroll
  for (int r = 0; r < RO; ++r) {
    const int row = orow + NG * r;
    if (row >= blk.nq) continue;
    const float f = p.inv_keep / lsum[row];
    float* dst = ob + (blk.q0 + row) * p.os[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d0 = h * (DP / 2) + 4 * tu;
      const float vals[4] = {o[r][h].x * f, o[r][h].y * f, o[r][h].z * f, o[r][h].w * f};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (d0 + e < p.Dh) dst[d0 + e] = vals[e];
    }
  }
}

// ------------------------------------------------------------- launch
template <typename Kernel>
cudaError_t launch_kernel(Kernel kernel, int bytes, const Params& p, long long ctas,
                          cudaStream_t stream) {
  if (bytes > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(unsigned)ctas, kFwdThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

// The kernel, its shared memory in bytes, for a dtype (0 fp32, 1 bf16)
// and head width, or a null kernel past 128.
struct Choice {
  void (*kernel)(Params);
  int bytes;
};

template <int DP>
Choice bf16_choice() {
  return {fwd_bf16_kernel<DP>, Bf16Tile<DP>::BYTES};
}

template <int DP>
Choice fp32_choice() {
  return {fwd_fp32_kernel<DP>, F32Tile<DP>::BYTES};
}

Choice choose(int dtype, int Dh) {
  if (Dh < 1 || Dh > 128) return {nullptr, 0};
  if (dtype == 0) {
    switch (padded_width(Dh)) {
      case 16: return fp32_choice<16>();
      case 32: return fp32_choice<32>();
      case 64: return fp32_choice<64>();
      default: return fp32_choice<128>();
    }
  }
  if (dtype != 1) return {nullptr, 0};
  switch ((Dh + 15) / 16) {
    case 1: return bf16_choice<16>();
    case 2: return bf16_choice<32>();
    case 3: return bf16_choice<48>();
    case 4: return bf16_choice<64>();
    case 5: return bf16_choice<80>();
    case 6: return bf16_choice<96>();
    case 7: return bf16_choice<112>();
    default: return bf16_choice<128>();
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v share it). strides: 14
// element strides, in this order: q, k, v, out (batch, head, row each) and
// m (batch, col); Dh is contiguous, 1 <= Dh <= 128, Lk >= 1. staging: 1
// where the bases and the batch, head and row strides of q, k and v are
// all multiples of 16 bytes (16-byte cp.async), 0 for element loads,
// which take any alignment of the type. Returns a cudaError_t.
int hamt_attention_fwd_blocked(const void* q, const void* k, const void* v, const float* m,
                               float* out, int dtype, int B, int H, int Lq, int Lk, int Dh,
                               const long long* strides, float scale, unsigned int seed,
                               unsigned int thresh, float inv_keep, int dropout, int staging,
                               void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.m = m; p.out = out;
  p.H = H; p.Lq = Lq; p.Lk = Lk; p.Dh = Dh; p.nqb = (Lq + kBQ64 - 1) / kBQ64;
  p.staging = staging;
  long long* dst[4] = {p.qs, p.ks, p.vs, p.os};
  for (int t = 0; t < 4; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  p.ms[0] = strides[12];
  p.ms[1] = strides[13];
  p.scale = scale; p.seed = seed; p.thresh = thresh;
  p.inv_keep = inv_keep; p.dropout = dropout;
  const Choice c = choose(dtype, Dh);
  const long long ctas = (long long)B * H * p.nqb;
  if (c.kernel == nullptr || Lk < 1 || ctas > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  return (int)launch_kernel(c.kernel, c.bytes, p, ctas, static_cast<cudaStream_t>(stream));
}

// The kernel's dynamic shared memory per CTA for (dtype, Dh) into
// *bytes, and the CTAs of it an SM of the current device holds at once
// (by shared memory and registers); -1 for a pair it does not take.
int hamt_attention_fwd_blocked_occupancy(int dtype, int Dh, long long* bytes) {
  const Choice c = choose(dtype, Dh);
  if (c.kernel == nullptr) return -1;
  *bytes = c.bytes;
  if (cudaFuncSetAttribute(c.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, c.bytes) !=
      cudaSuccess)
    return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, c.kernel, kFwdThreads, c.bytes) !=
      cudaSuccess)
    return -1;
  return n;
}

}  // extern "C"
