// Key-blocked fused masked attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel vln_hamt_tpu/ops/attention.py:_attn_kernel
// (pallas_call at :215, in _fused_attention_core) for the shapes the
// whole-row kernel (attention.cu) does not take: more than 256 keys, a
// head width other than 16, 32, 64 and 128, or a key row whose K and V do
// not fit one block's shared memory (Dh 128 past 192 keys). The Pallas
// kernel blocks one whole (batch, head) pair for any Lq, Lk and Dh; this
// kernel takes any Lq, any Lk >= 1 and any Dh <= 128, so with attention.cu
// the port runs every shape the JAX package runs up to Dh 128. It
// computes what attention.cu computes,
//
//     out = dropout(softmax(q k^T * scale + m)) v        (all fp32)
//
// with the same counter-hash keep mask at (global row) * Lk + (global
// column), Lk the full key count, so the mask stays bit-identical to
// vln_hamt_tpu/ops/attention.py:_dropout_keep_mask.
//
// What bounds it on an H100. Per (batch, head) pair it reads q, k, v and
// the mask and writes the fp32 output once (bytes), and does 4 Lq Lk Dh
// FLOPs on the CUDA cores in fp32 (TF32 off, as the port runs): at the
// ViT's 301 and 577 tokens, Dh 64, that is 12-23 times the bytes' time at
// 3.35 TB/s against 67 TFLOP/s, so it is operations-bound, and what
// decides its time is, as in attention.cu, how fast each SM feeds its
// CUDA cores from shared memory: every product reads float4 register
// tiles, several FMAs per loaded operand.
//
// The design (attention_blocked.cuh has the tiling):
// * Grid over (query block of 32 rows, batch * head), 128 threads. The
//   CTA stages its Q block once, then walks the keys in blocks of 64 (32
//   at Dh 128): K and V of the block, with the mask, go to shared memory
//   as fp32 rows padded to DP, by element loads that take any alignment
//   and any head width (zero past Dh and past Lk).
// * Online softmax. Per key block the scores S = Q K^T (2 rows x 8 or 4
//   columns a thread), then per row the block's max m_b over the row's 8
//   lanes, the new running max m' = max(m, m_b), the factor a = exp(m -
//   m'), and e = exp(s - m'). The running sum l = l a + sum(e) counts
//   every e, kept or dropped: dropout acts on the normalised p, so the
//   sum over which p is normalised is the undropped one. Only the
//   accumulation into O skips the dropped e. O lives in registers (RO
//   rows x 4 d a thread), is scaled by a, and takes e V over the block.
//   At the end O is scaled by 1 / (1 - rate) and by 1 / l.
// * Columns past Lk (in the last key block) read -inf, not -10000: their
//   e is 0, so a row whose real keys all read -10000 stays a softmax over
//   the real keys, as in attention.cu. Every key block holds at least one
//   real key, so the running max is finite after the first block.
// * O is stored element by element into the (B, Lq, H, Dh) layout for d <
//   Dh and rows inside Lq.
// * No tensor cores, TMA or cp.async, as in attention.cu: fp32 for parity
//   with the CPU, and a first kernel that is right. Its time beside the
//   whole-row kernel's at 197 keys is in PERF.md.
//
// Plain C interface (bound with ctypes): hamt_attention_fwd_blocked
// returns the cudaError_t of the launch; the launch goes on the caller's
// stream and does not synchronise.

#include "attention_blocked.cuh"

namespace {

using namespace hamt;
using namespace hamt::blocked;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* m;
  float* out;
  int H, Lq, Lk, Dh, nqb;
  // element strides: (batch, head, row) of q, k, v and out, (batch, col) of m
  long long qs[3], ks[3], vs[3], os[3], ms[2];
  float scale;
  uint32_t seed;
  uint32_t thresh;
  float inv_keep;  // 1 / (1 - rate); 1 without dropout
  int dropout;
};

// Shared memory, in floats, every region 16-byte aligned: the Q block
// (32 rows of pitch DP + 4), K and V blocks (BK rows of pitch DP + 4), the
// block's e (32 rows of pitch BK + 4), its mask (BK), and per row the
// rescale factor and, at the end, the sum.
template <int DP>
struct Layout {
  static constexpr int BK = key_block(DP), KP = DP + 4, PP = BK + 4;
  static constexpr int Q = 0, K = Q + kBQ * KP, V = K + BK * KP, P = V + BK * KP;
  static constexpr int M = P + kBQ * PP, A = M + BK, L = A + kBQ, FLOATS = L + kBQ;
};

template <typename T, int DP>
__global__ void __launch_bounds__(kBlockThreads) attention_fwd_blocked_kernel(Params p) {
  using Lay = Layout<DP>;
  constexpr int BK = Lay::BK, KP = Lay::KP, PP = Lay::PP, CPT = BK / kLanes;
  constexpr int DG = DP / 4, RO = kBQ * DG / kBlockThreads;
  static_assert(RO >= 1 && kBlockThreads % DG == 0, "rows per thread");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem + Lay::Q;
  float* ks = smem + Lay::K;
  float* vs = smem + Lay::V;
  float* ps = smem + Lay::P;
  float* ms = smem + Lay::M;
  float* alpha = smem + Lay::A;
  float* lsum = smem + Lay::L;

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

  const int tx = threadIdx.x & (kLanes - 1);
  const int r0 = (threadIdx.x / kLanes) * kRows;  // first score row
  const int td = threadIdx.x % DG;
  const int ro0 = (threadIdx.x / DG) * RO;  // first output row
  const uint32_t key = dropout_key(p.seed, b, h);
  float mrow[kRows], lrow[kRows];  // running max (shared by the row's lanes), lane's sum
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    mrow[r] = -INFINITY;
    lrow[r] = 0.f;
  }
  float4 o[RO];
#pragma unroll
  for (int r = 0; r < RO; ++r) o[r] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    const int nk = min(BK, Lk - k0);
    __syncthreads();  // the last block's e and V are read
    stage_any<T, DP>(ks, KP, kg + k0 * p.ks[2], p.ks[2], nk, BK, p.Dh);
    stage_any<T, DP>(vs, KP, vg + k0 * p.vs[2], p.vs[2], nk, BK, p.Dh);
    for (int j = threadIdx.x; j < BK; j += kBlockThreads)
      ms[j] = j < nk ? p.m[b * p.ms[0] + (k0 + j) * p.ms[1]] : 0.f;
    __syncthreads();

    float s[kRows][CPT];
    tile_scores<DP, CPT>(s, qs + r0 * KP, ks + tx * KP);
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
      const float a = expf(mrow[r] - mn);  // 0 at the first block
      const int row = q0 + r0 + r;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = tx + c * kLanes;
        float e = expf(s[r][c] - mn);
        sum += e;  // every e: the normaliser is the undropped sum
        if (p.dropout && !dropout_keep(key, row, k0 + j, Lk, p.thresh)) e = 0.f;
        ps[(r0 + r) * PP + j] = e;
      }
      lrow[r] = lrow[r] * a + sum;
      mrow[r] = mn;
      if (tx == 0) alpha[r0 + r] = a;
    }
    __syncwarp();  // the warp reads back only its own 8 rows

#pragma unroll
    for (int r = 0; r < RO; ++r) {
      const float a = alpha[ro0 + r];
      o[r] = make_float4(o[r].x * a, o[r].y * a, o[r].z * a, o[r].w * a);
    }
    // e and V are zero in columns and rows [nk, nk4)
    rows_times_keys<RO>(o, ps + ro0 * PP, PP, vs + td * 4, KP, (nk + 3) & ~3);
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float l = group_sum<kLanes>(lrow[r]);
    if (tx == 0) lsum[r0 + r] = l;
  }
  __syncwarp();
  float* ob = p.out + b * p.os[0] + h * p.os[1];
#pragma unroll
  for (int r = 0; r < RO; ++r) {
    const int row = ro0 + r;
    if (row >= nq) continue;
    const float f = p.inv_keep / lsum[row];
    const float vals[4] = {o[r].x * f, o[r].y * f, o[r].z * f, o[r].w * f};
    float* dst = ob + (q0 + row) * p.os[2];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (td * 4 + e < p.Dh) dst[td * 4 + e] = vals[e];
  }
}

template <typename T, int DP>
cudaError_t launch_width(const Params& p, long long ctas, cudaStream_t stream) {
  const size_t bytes = Layout<DP>::FLOATS * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(attention_fwd_blocked_kernel<T, DP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return err;
  }
  attention_fwd_blocked_kernel<T, DP><<<(unsigned)ctas, kBlockThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const long long ctas = (long long)B * p.H * p.nqb;
  if (p.Lk < 1 || ctas > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  switch (padded_width(p.Dh)) {
    case 16: return launch_width<T, 16>(p, ctas, stream);
    case 32: return launch_width<T, 32>(p, ctas, stream);
    case 64: return launch_width<T, 64>(p, ctas, stream);
    case 128: return launch_width<T, 128>(p, ctas, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v share it). strides: 14
// element strides, in this order: q, k, v, out (batch, head, row each) and
// m (batch, col); Dh is contiguous, 1 <= Dh <= 128, Lk >= 1, and the
// pointers need only their type's alignment. Returns a cudaError_t.
int hamt_attention_fwd_blocked(const void* q, const void* k, const void* v, const float* m,
                               float* out, int dtype, int B, int H, int Lq, int Lk, int Dh,
                               const long long* strides, float scale, unsigned int seed,
                               unsigned int thresh, float inv_keep, int dropout,
                               void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.m = m; p.out = out;
  p.H = H; p.Lq = Lq; p.Lk = Lk; p.Dh = Dh; p.nqb = (Lq + kBQ - 1) / kBQ;
  long long* dst[4] = {p.qs, p.ks, p.vs, p.os};
  for (int t = 0; t < 4; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  p.ms[0] = strides[12];
  p.ms[1] = strides[13];
  p.scale = scale; p.seed = seed; p.thresh = thresh;
  p.inv_keep = inv_keep; p.dropout = dropout;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(p, B, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
