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
// and its cotangent g:
//
//     p   = softmax(q k^T * scale + m)          recomputed, not stored
//     pd  = keep ? p / (1 - rate) : 0           the forward's dropped p
//     dp  = keep ? (g v^T) / (1 - rate) : 0
//     ds  = p * (dp - D),  D = rowsum(dp * p)
//     dv  = pd^T g,   dq = ds k * scale,   dk = ds^T q * scale
//     dm[b, :] = sum over heads and query rows of ds    (fp32)
//
// with the forward's keep mask at (global row) * Lk + (global column).
//
// What bounds it on an H100: as the forward (attention_blocked.cu), the
// products on the CUDA cores in fp32. It runs 7 of them where the whole-
// row kernel runs 5 (below), and moves an fp32 partial of dq per key
// block through memory.
//
// The design. The row statistics (each row's max, softmax sum and D) are
// recomputed here, in a pass over the key blocks, rather than saved by
// the forward: the shapes this kernel takes include Dh 128 with 161-192
// keys, whose forward runs in the whole-row kernel, which keeps no row
// statistics, and a recompute leaves _FusedAttention's saved tensors and
// the memory of every other path as they were. It costs two of the seven
// products. Three kernels, plus one with dm:
// * attention_bwd_blocked_stats_kernel, grid over (query block of 32 rows, batch
//   * head): the Q and G blocks stay in shared memory while the K and V
//   blocks pass (64 keys, 32 at Dh 128). Per key block S = Q K^T and dP =
//   G V^T; the running max m, the running sum l of e = exp(s - m) and the
//   running sum a of e * dpd (dpd the dropped, rescaled dP; dropped and
//   kept e alike in l, as the forward normalises) are rescaled as the max
//   moves. It stores m, 1 / l and D = a / l, fp32 (3, B * H, Lq): not
//   the log-sum-exp m + log(l), which at a row whose keys all read
//   -10000 rounds to the fp32 step there (about 1e-3) and would move p by
//   as much; s - m is exact, as in the forward.
// * attention_bwd_blocked_kernel, grid over (key block, batch * head): the
//   K and V blocks stay in shared memory while the query blocks pass; per
//   query block S, dP, p = exp(s - m) / l, pd, dpd and ds as above, then
//   dV += pd^T G and dK += ds^T Q in registers (KPT keys x 4 d a thread,
//   summed over the query rows in order) and the block's column sums of ds
//   for dm; and the key block's partial of dQ, ds K, into an fp32 (key
//   blocks, B * H, Lq, DP) scratch. Columns past Lk have p = 0, as the
//   forward's -inf gives them. dK (scaled) and dV are stored at the end,
//   element by element in the input type for d < Dh.
// * attention_bwd_blocked_dq_kernel sums the dQ partials over the key blocks in
//   order, scales, and stores dq in the input type.
// * attention_bwd_blocked_head_sum_kernel, with dm: dm[b, j] is the sum over heads,
//   in order, of the key-block kernel's column sums. Every sum runs in a
//   fixed order, with no atomics, so the result is deterministic.
//
// Plain C interface (bound with ctypes): hamt_attention_bwd_blocked
// enqueues the kernels on the caller's stream, does not synchronise, and
// returns the first cudaError_t.

#include "attention_blocked.cuh"

namespace {

using namespace hamt;
using namespace hamt::blocked;

constexpr int kReduceThreads = 256;

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
  float* dm_part;  // (B * H, Lk) fp32 column sums of ds, or null: no dm
  int H, BH, Lq, Lk, Dh, DP, nqb, nkb;
  // element strides (batch, head, row) of q, k, v, g, dq, dk, dv and
  // (batch, col) of m
  long long qs[3], ks[3], vs[3], gs[3], dqs[3], dks[3], dvs[3], ms[2];
  float scale;
  uint32_t seed;
  uint32_t thresh;
  float inv_keep;  // 1 / (1 - rate); 1 without dropout
  int dropout;
};

__device__ __forceinline__ void store_row(float* dst, const float4& v, int d0, int Dh) {
  const float vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (d0 + e < Dh) dst[e] = vals[e];
}

__device__ __forceinline__ void store_row(__nv_bfloat16* dst, const float4& v, int d0, int Dh) {
  const float vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (d0 + e < Dh) dst[e] = __float2bfloat16(vals[e]);  // round to nearest even, as torch
}

// Shared memory of the statistics pass, in floats: the Q and G blocks (32
// rows of pitch DP + 4), the K and V blocks (BK rows), the block's mask.
template <int DP>
struct StatsLayout {
  static constexpr int BK = key_block(DP), KP = DP + 4;
  static constexpr int Q = 0, G = Q + kBQ * KP, K = G + kBQ * KP, V = K + BK * KP;
  static constexpr int M = V + BK * KP, FLOATS = M + BK;
};

template <typename T, int DP>
__global__ void __launch_bounds__(kBlockThreads) attention_bwd_blocked_stats_kernel(BwdParams p) {
  using Lay = StatsLayout<DP>;
  constexpr int BK = Lay::BK, KP = Lay::KP, CPT = BK / kLanes;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem + Lay::Q;
  float* gs = smem + Lay::G;
  float* ks = smem + Lay::K;
  float* vs = smem + Lay::V;
  float* ms = smem + Lay::M;

  const int bh = blockIdx.x / p.nqb;
  const int q0 = (blockIdx.x - bh * p.nqb) * kBQ;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int nq = min(kBQ, p.Lq - q0);
  const int Lk = p.Lk;
  const T* kg = static_cast<const T*>(p.k) + b * p.ks[0] + h * p.ks[1];
  const T* vg = static_cast<const T*>(p.v) + b * p.vs[0] + h * p.vs[1];
  stage_any<T, DP>(qs, KP, static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[1] + q0 * p.qs[2],
                   p.qs[2], nq, kBQ, p.Dh);
  stage_any<float, DP>(gs, KP, p.g + b * p.gs[0] + h * p.gs[1] + q0 * p.gs[2], p.gs[2], nq, kBQ,
                       p.Dh);

  const int tx = threadIdx.x & (kLanes - 1);
  const int r0 = (threadIdx.x / kLanes) * kRows;
  const uint32_t key = dropout_key(p.seed, b, h);
  float mrow[kRows], lrow[kRows], arow[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    mrow[r] = -INFINITY;
    lrow[r] = 0.f;
    arow[r] = 0.f;
  }

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    const int nk = min(BK, Lk - k0);
    __syncthreads();
    stage_any<T, DP>(ks, KP, kg + k0 * p.ks[2], p.ks[2], nk, BK, p.Dh);
    stage_any<T, DP>(vs, KP, vg + k0 * p.vs[2], p.vs[2], nk, BK, p.Dh);
    for (int j = threadIdx.x; j < BK; j += kBlockThreads)
      ms[j] = j < nk ? p.m[b * p.ms[0] + (k0 + j) * p.ms[1]] : 0.f;
    __syncthreads();

    float s[kRows][CPT], dp[kRows][CPT];
    tile_scores<DP, CPT>(s, qs + r0 * KP, ks + tx * KP);
    tile_scores<DP, CPT>(dp, gs + r0 * KP, vs + tx * KP);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float bm = -INFINITY;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = tx + c * kLanes;
        s[r][c] = j < nk ? scaled_score(s[r][c], p.scale, ms[j]) : -INFINITY;
        bm = fmaxf(bm, s[r][c]);
      }
      const float mn = fmaxf(mrow[r], group_max<kLanes>(bm));
      const float a = expf(mrow[r] - mn);
      const int row = q0 + r0 + r;
      float sl = 0.f, sa = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float e = expf(s[r][c] - mn);  // 0 past Lk, where V's rows and dP are 0 too
        float dpd = dp[r][c];
        if (p.dropout)
          dpd = dropout_keep(key, row, k0 + tx + c * kLanes, Lk, p.thresh) ? dpd * p.inv_keep
                                                                            : 0.f;
        sl += e;
        sa = fmaf(e, dpd, sa);
      }
      lrow[r] = lrow[r] * a + sl;
      arow[r] = arow[r] * a + sa;
      mrow[r] = mn;
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float l = group_sum<kLanes>(lrow[r]);
    const float a = group_sum<kLanes>(arow[r]);
    const int row = r0 + r;
    if (tx == 0 && row < nq) {
      const size_t plane = (size_t)p.BH * p.Lq, at = (size_t)bh * p.Lq + q0 + row;
      p.stats[at] = mrow[r];
      p.stats[plane + at] = 1.f / l;
      p.stats[2 * plane + at] = a / l;
    }
  }
}

// Shared memory of the key-block kernel, in floats: the K and V blocks (BK
// rows of pitch DP + 4), the block's mask (BK), the Q and G blocks (32
// rows), the rows' max, 1 / sum and D (32 each), pd and ds (32 rows of
// pitch BK + 4).
template <int DP>
struct KeyLayout {
  static constexpr int BK = key_block(DP), KP = DP + 4, PP = BK + 4;
  static constexpr int K = 0, V = K + BK * KP, M = V + BK * KP, Q = M + BK, G = Q + kBQ * KP;
  static constexpr int ST = G + kBQ * KP, PD = ST + 3 * kBQ, DS = PD + kBQ * PP;
  static constexpr int FLOATS = DS + kBQ * PP;
};

template <typename T, int DP>
__global__ void __launch_bounds__(kBlockThreads) attention_bwd_blocked_kernel(BwdParams p) {
  using Lay = KeyLayout<DP>;
  constexpr int BK = Lay::BK, KP = Lay::KP, PP = Lay::PP, CPT = BK / kLanes;
  constexpr int DG = DP / 4, RO = kBQ * DG / kBlockThreads, KPT = BK * DG / kBlockThreads;
  static_assert(RO >= 1 && KPT >= 1 && KPT * (kBlockThreads / DG) == BK, "keys per thread");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ks = smem + Lay::K;
  float* vs = smem + Lay::V;
  float* ms = smem + Lay::M;
  float* qs = smem + Lay::Q;
  float* gs = smem + Lay::G;
  float* st = smem + Lay::ST;  // the rows' max, 1 / sum and D, 32 each
  float* pds = smem + Lay::PD;
  float* dss = smem + Lay::DS;

  const int bh = blockIdx.x / p.nkb;
  const int kb = blockIdx.x - bh * p.nkb;
  const int k0 = kb * BK;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int Lk = p.Lk, Lq = p.Lq;
  const int nk = min(BK, Lk - k0);
  stage_any<T, DP>(ks, KP, static_cast<const T*>(p.k) + b * p.ks[0] + h * p.ks[1] + k0 * p.ks[2],
                   p.ks[2], nk, BK, p.Dh);
  stage_any<T, DP>(vs, KP, static_cast<const T*>(p.v) + b * p.vs[0] + h * p.vs[1] + k0 * p.vs[2],
                   p.vs[2], nk, BK, p.Dh);
  for (int j = threadIdx.x; j < BK; j += kBlockThreads)
    ms[j] = j < nk ? p.m[b * p.ms[0] + (k0 + j) * p.ms[1]] : 0.f;
  const T* qg = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[1];
  const float* gg = p.g + b * p.gs[0] + h * p.gs[1];

  const int tx = threadIdx.x & (kLanes - 1);
  const int r0 = (threadIdx.x / kLanes) * kRows;  // first score row
  const int td = threadIdx.x % DG;
  const int ro0 = (threadIdx.x / DG) * RO;   // first dQ row
  const int j0 = (threadIdx.x / DG) * KPT;   // first dK / dV key
  const uint32_t key = dropout_key(p.seed, b, h);
  const bool want_dm = p.dm_part != nullptr;
  float4 dk[KPT], dv[KPT];
  float dmc[KPT];
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    dk[i] = dv[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    dmc[i] = 0.f;
  }

  for (int q0 = 0; q0 < Lq; q0 += kBQ) {
    const int nq = min(kBQ, Lq - q0);
    __syncthreads();  // the last query block's tiles are read
    stage_any<T, DP>(qs, KP, qg + q0 * p.qs[2], p.qs[2], nq, kBQ, p.Dh);
    stage_any<float, DP>(gs, KP, gg + q0 * p.gs[2], p.gs[2], nq, kBQ, p.Dh);
    for (int i = threadIdx.x; i < 3 * kBQ; i += kBlockThreads) {
      const int t = i / kBQ, r = i % kBQ;
      st[i] = r < nq ? p.stats[((size_t)t * p.BH + bh) * Lq + q0 + r] : 0.f;
    }
    __syncthreads();

    float s[kRows][CPT], dp[kRows][CPT];
    tile_scores<DP, CPT>(s, qs + r0 * KP, ks + tx * KP);
    tile_scores<DP, CPT>(dp, gs + r0 * KP, vs + tx * KP);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = r0 + r;
      const bool live = row < nq;
      const float mx = st[row], inv = st[kBQ + row], dsum = st[2 * kBQ + row];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = tx + c * kLanes;
        const float pv =
            live && j < nk ? expf(scaled_score(s[r][c], p.scale, ms[j]) - mx) * inv : 0.f;
        const bool keep = !p.dropout || dropout_keep(key, q0 + row, k0 + j, Lk, p.thresh);
        const float pd = keep ? pv * p.inv_keep : 0.f;
        const float dpd = keep ? dp[r][c] * p.inv_keep : 0.f;
        pds[row * PP + j] = pd;
        dss[row * PP + j] = pv * (dpd - dsum);
      }
    }
    __syncthreads();  // the key map below reads every row

    // the key block's partial of dQ = ds K (unscaled), rows inside Lq
    float4 o[RO];
#pragma unroll
    for (int r = 0; r < RO; ++r) o[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    rows_times_keys<RO>(o, dss + ro0 * PP, PP, ks + td * 4, KP, (nk + 3) & ~3);
    float* part = p.dq_part + ((size_t)kb * p.BH + bh) * Lq * DP + td * 4;
#pragma unroll
    for (int r = 0; r < RO; ++r)
      if (ro0 + r < nq) *reinterpret_cast<float4*>(part + (size_t)(q0 + ro0 + r) * DP) = o[r];

    // dV += pd^T G, dK += ds^T Q, over the block's rows in order
    for (int r = 0; r < nq; ++r) {
      const float4 xg = ld4(gs + r * KP + td * 4);
      const float4 xq = ld4(qs + r * KP + td * 4);
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        const float ds = dss[r * PP + j0 + i];
        fma4(dv[i], pds[r * PP + j0 + i], xg);
        fma4(dk[i], ds, xq);
        dmc[i] += ds;
      }
    }
  }

  T* dvb = static_cast<T*>(p.dv) + b * p.dvs[0] + h * p.dvs[1];
  T* dkb = static_cast<T*>(p.dk) + b * p.dks[0] + h * p.dks[1];
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    if (j0 + i >= nk) break;
    const int j = k0 + j0 + i;
    const float4 kv = make_float4(dk[i].x * p.scale, dk[i].y * p.scale, dk[i].z * p.scale,
                                  dk[i].w * p.scale);
    store_row(dvb + j * p.dvs[2] + td * 4, dv[i], td * 4, p.Dh);
    store_row(dkb + j * p.dks[2] + td * 4, kv, td * 4, p.Dh);
    if (want_dm && td == 0) p.dm_part[(size_t)bh * Lk + j] = dmc[i];
  }
}

// dq from its (nkb, B * H, Lq, DP) fp32 partials: summed over the key
// blocks in order, scaled, stored in the input type. One thread per
// element of dq.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads) attention_bwd_blocked_dq_kernel(BwdParams p) {
  const long long i = (long long)blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= (long long)p.BH * p.Lq * p.Dh) return;
  const int d = (int)(i % p.Dh);
  const long long rowi = i / p.Dh;  // bh * Lq + row
  const int row = (int)(rowi % p.Lq);
  const int bh = (int)(rowi / p.Lq);
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const size_t plane = (size_t)p.BH * p.Lq * p.DP;
  const float* src = p.dq_part + rowi * p.DP + d;
  float acc = 0.f;
  for (int kb = 0; kb < p.nkb; ++kb) acc += src[kb * plane];
  static_cast<T*>(p.dq)[b * p.dqs[0] + h * p.dqs[1] + row * p.dqs[2] + d] =
      from_float<T>(acc * p.scale);
}

// dm[b, j] = sum over heads, in order, of dm_part[b, h, j]; dm is (B, Lk)
// contiguous fp32.
__global__ void attention_bwd_blocked_head_sum_kernel(const float* dm_part, float* dm, int B, int H,
                                              int Lk) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * Lk) return;
  const int b = i / Lk;
  const int j = i - b * Lk;
  const float* src = dm_part + (size_t)b * H * Lk + j;
  float acc = 0.f;
  for (int h = 0; h < H; ++h) acc += src[(size_t)h * Lk];
  dm[i] = acc;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int DP>
cudaError_t launch_width(const BwdParams& p, cudaStream_t stream) {
  const size_t stats = StatsLayout<DP>::FLOATS * sizeof(float);
  const size_t keys = KeyLayout<DP>::FLOATS * sizeof(float);
  cudaError_t err = allow_smem(attention_bwd_blocked_stats_kernel<T, DP>, stats);
  if (err != cudaSuccess) return err;
  err = allow_smem(attention_bwd_blocked_kernel<T, DP>, keys);
  if (err != cudaSuccess) return err;
  attention_bwd_blocked_stats_kernel<T, DP>
      <<<(unsigned)((long long)p.BH * p.nqb), kBlockThreads, stats, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_blocked_kernel<T, DP>
      <<<(unsigned)((long long)p.BH * p.nkb), kBlockThreads, keys, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const BwdParams& p, float* dm, cudaStream_t stream) {
  if (p.Lk < 1 || p.Lq < 1 || (long long)p.BH * p.nqb > 0x7FFFFFFFLL ||
      (long long)p.BH * p.nkb > 0x7FFFFFFFLL)
    return cudaErrorInvalidValue;
  if ((p.dm_part == nullptr) != (dm == nullptr)) return cudaErrorInvalidValue;
  cudaError_t err;
  switch (p.DP) {
    case 16: err = launch_width<T, 16>(p, stream); break;
    case 32: err = launch_width<T, 32>(p, stream); break;
    case 64: err = launch_width<T, 64>(p, stream); break;
    case 128: err = launch_width<T, 128>(p, stream); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const long long n = (long long)p.BH * p.Lq * p.Dh;
  attention_bwd_blocked_dq_kernel<T>
      <<<(unsigned)((n + kReduceThreads - 1) / kReduceThreads), kReduceThreads, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || dm == nullptr) return err;
  const int B = p.BH / p.H, nd = B * p.Lk;
  attention_bwd_blocked_head_sum_kernel<<<(nd + kReduceThreads - 1) / kReduceThreads,
                                          kReduceThreads, 0, stream>>>(p.dm_part, dm, B, p.H,
                                                                       p.Lk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The padded head width DP of a call at head width Dh (0 past 128): the
// innermost extent of its dq scratch.
int hamt_attention_blocked_width(int Dh) { return padded_width(Dh); }

// Key blocks of a call over Lk keys at head width Dh: the depth of its
// dq scratch.
int hamt_attention_bwd_blocked_key_blocks(int Lk, int Dh) {
  const int bk = key_block(padded_width(Dh));
  return (Lk + bk - 1) / bk;
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dq, dk, dv share it).
// strides: 23 element strides, in this order: q, k, v, g, dq, dk, dv
// (batch, head, row each) and m (batch, col); Dh is contiguous and 1 <= Dh
// <= 128; the pointers need only their type's alignment. Scratch, all
// contiguous fp32: dq_part (nkb, B * H, Lq, DP) with nkb =
// hamt_attention_bwd_blocked_key_blocks(Lk, Dh) and DP =
// hamt_attention_blocked_width(Dh) (16-byte aligned), stats (3, B * H,
// Lq), and dm_part (B * H, Lk), which with dm, the (B, Lk) contiguous fp32
// output, is null when the mask's cotangent is not wanted. Returns a
// cudaError_t.
int hamt_attention_bwd_blocked(const void* q, const void* k, const void* v, const float* m,
                               const float* g, void* dq, void* dk, void* dv, float* dq_part,
                               float* stats, float* dm_part, float* dm, int dtype,
                               int B, int H, int Lq, int Lk, int Dh, const long long* strides,
                               float scale, unsigned int seed, unsigned int thresh,
                               float inv_keep, int dropout, void* stream) {
  BwdParams p;
  p.q = q; p.k = k; p.v = v; p.m = m; p.g = g;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.dq_part = dq_part; p.stats = stats; p.dm_part = dm_part;
  p.H = H; p.BH = B * H; p.Lq = Lq; p.Lk = Lk; p.Dh = Dh;
  p.DP = padded_width(Dh);
  p.nqb = (Lq + kBQ - 1) / kBQ;
  p.nkb = hamt_attention_bwd_blocked_key_blocks(Lk, Dh);
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
