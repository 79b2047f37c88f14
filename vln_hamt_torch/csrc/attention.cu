// Fused masked attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel vln_hamt_tpu/ops/attention.py:_attn_kernel
// (pallas_call at :215, in _fused_attention_core). For one (batch, head)
// pair it computes
//
//     out = dropout(softmax(q k^T * scale + m)) v        (all fp32)
//
// with the same counter-hash dropout as the TPU kernel, so the keep mask
// is bit-identical to vln_hamt_tpu/ops/attention.py:_dropout_keep_mask:
//     key  = seed + b * 0x9E3779B1 + h * 0x85EBCA77          (uint32)
//     bits = splitmix32(key ^ splitmix32(row * Lk + col))
//     keep = bits >= thresh,  kept values scaled by 1 / (1 - rate).
//
// What bounds it on an H100. HAMT's sequences are short (Lq, Lk <= 67 at
// R2R width, <= 250 for RxR text), so a launch moves q, k, v, the (B, Lk)
// mask and the fp32 output through HBM once: 0.0070 ms at 3.35 TB/s for
// the batch-32 mix of the serving path, above the 0.0053 ms that
// 4 * B * H * Lq * Lk * Dh fp32 FLOPs take on the CUDA cores at 67 TFLOP/s.
// Both floors are low, so what decides the time is how fast each SM
// feeds its CUDA cores. An fp32 FMA needs its two operands in registers;
// an SM serves about one shared-memory wavefront (128 bytes) per clock
// but can issue four warp FMAs. A loop that reads both operands of every
// FMA from shared memory runs at an eighth of the FMA rate.
//
// The design:
// * Grid over (query block of kBQ = 32 rows, batch * head), 128 threads.
//   Each CTA stages the pair's whole K and V and its Q block into shared
//   memory as fp32 with 16-byte copies (cp.async for fp32, widened uint4
//   loads for bf16); V's copy overlaps the scores. Lk <= 256 fits whole
//   (164 KB at Lk 250, Dh 64), so no online softmax is needed.
// * Scores S = Q K^T from register tiles: a thread holds 2 rows x MAXC
//   columns (column tx + 8c of its 8-lane group; MAXC = 5, 9 or 32 by
//   tier of Lk, the two small tiers with K and V zero-padded to 8 * MAXC
//   rows so their column loops carry no bound) and accumulates over Dh
//   from float4 reads of Q and K rows padded to Dh + 4 floats, so the 8
//   K rows a warp reads at once fall into distinct banks. Per 4 steps of
//   Dh a warp issues 2 + nc float4 loads (about one wavefront each: Q is
//   broadcast, K covers 128 bytes) for 8 * nc FMAs per row pair: at
//   nc = 9 about 0.15 wavefronts per warp FMA, against 2 in a loop that
//   reads both operands per FMA.
// * Softmax in registers: the scale and mask, then max and sum by
//   shuffles among the 8 lanes of a row, expf, one reciprocal of the sum
//   per row, the dropout hash per element at (global row) * Lk + col. It
//   is straight-line code over all MAXC columns: guarded per column, each
//   expf and each IEEE division compiles to its own serial block and the
//   softmax took longer than both products. Columns past Lk read -inf
//   and get no weight, so a row whose keys all read -10000 stays a
//   softmax over the real keys only. P goes to shared memory over the
//   dead Q block.
// * O = P V from register tiles: a thread holds RO rows x 4 contiguous d
//   and per 4 keys reads RO float4s of P and 4 float4s of V (16 * RO
//   FMAs). Each warp owns the same 8 query rows in both products, so P
//   passes between them with a __syncwarp, and a warp whose rows all lie
//   past Lq (the ragged last block) skips both. O is stored with float4
//   stores into the (B, Lq, H, Dh) layout; rows past Lq are not written.
// * Head widths 16, 32, 64 and 128 are instantiated, each with the three
//   column tiers: Lk <= 40, <= 72 (every R2R shape falls in these two)
//   and <= 256.
// * No tensor cores and no TMA. The main path computes in fp32 with TF32
//   off for parity with the CPU; a TF32 mma/wgmma would break the 1e-5
//   tolerance against the plain version and the card-against-CPU gates,
//   bf16 compute is a separate model option, and a 3xTF32 split is left
//   for later. Rows are 256 bytes at arbitrary 16-byte-aligned strides,
//   which cp.async covers without tensor maps.
//
// q, k, v and out are addressed through (batch, head, row) strides with
// a unit stride on Dh, so the attention layer hands over its (B, L, H, Dh)
// projections without transpose copies. Pointers and strides must be
// multiples of 16 bytes (the wrapper checks). Inputs are fp32 or bf16.
//
// Plain C interface (bound with ctypes): hamt_attention_fwd returns the
// cudaError_t of the launch; the launch goes on the caller's stream and
// does not synchronise.

#include "attention_common.cuh"

namespace {

using namespace hamt;

constexpr int kBQ = 32;          // query rows per CTA
constexpr int kLanesPerRow = 8;  // threads that share one score row
constexpr int kRowsPerThread = 2;
constexpr int kThreadsFwd = kBQ / kRowsPerThread * kLanesPerRow;  // 128
constexpr int kWarpRows = 32 / kLanesPerRow * kRowsPerThread;     // 8 rows per warp
// Score columns per thread (MAXC) by tier of Lk: 5 for Lk <= 40, 9 for
// Lk <= 72, 32 for Lk <= 256. The two small tiers pad K and V to their
// full 8 * MAXC rows, so their column loops need no bound.
constexpr int kColsSmall = 5, kColsMid = 9, kColsLarge = 32;
constexpr int kMaxLk = kLanesPerRow * kColsLarge;

__host__ __device__ constexpr int padded_keys(int Lk) {
  return Lk <= kLanesPerRow * kColsSmall ? kLanesPerRow * kColsSmall
         : Lk <= kLanesPerRow * kColsMid ? kLanesPerRow * kColsMid
                                         : (Lk + kLanesPerRow - 1) / kLanesPerRow * kLanesPerRow;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* m;
  float* out;
  int H, Lq, Lk, nqb;
  long long qsb, qsh, qsl;
  long long ksb, ksh, ksl;
  long long vsb, vsh, vsl;
  long long msb, msl;
  long long osb, osh, osl;
  float scale;
  uint32_t seed;
  uint32_t thresh;
  float inv_keep;
  int dropout;
};

// Shared memory, in floats, every region 16-byte aligned: K (lkp rows of
// pitch Dh + 4), V (lkp rows of pitch Dh), the mask (lkp), and the Q
// block (kBQ rows of pitch Dh + 4), which P (kBQ rows of pitch lkp + 4)
// overwrites once the scores are in registers. lkp is padded_keys(Lk), a
// multiple of 8; K and V rows [Lk, lkp) are zero.
struct Layout {
  int lkp, kp, pp;
  size_t k_off, v_off, m_off, qp_off, floats;
};

__host__ __device__ inline Layout layout(int Lk, int Dh) {
  Layout L;
  L.lkp = padded_keys(Lk);
  L.kp = Dh + 4;
  L.pp = L.lkp + 4;  // 2 * pp = 8 or 24 mod 32: a warp's P stores hit distinct banks
  L.k_off = 0;
  L.v_off = (size_t)L.lkp * L.kp;
  L.m_off = L.v_off + (size_t)L.lkp * Dh;
  L.qp_off = L.m_off + L.lkp;
  const size_t q = (size_t)kBQ * L.kp, p = (size_t)kBQ * L.pp;
  L.floats = L.qp_off + (q > p ? q : p);
  return L;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename T, int DH, int MAXC>
__global__ void __launch_bounds__(kThreadsFwd, MAXC < kColsLarge ? 4 : 1)
    attention_fwd_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int KP = DH + 4;
  const int Lk = p.Lk;
  const Layout L = layout(Lk, DH);
  const int PP = L.pp;
  float* ks = smem + L.k_off;
  float* vs = smem + L.v_off;
  float* ms = smem + L.m_off;
  float* qs = smem + L.qp_off;  // the Q block, then P
  float* ps = qs;

  const int bh = blockIdx.x / p.nqb;
  const int q0 = (blockIdx.x - bh * p.nqb) * kBQ;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int nq = min(kBQ, p.Lq - q0);  // rows of this block inside Lq

  // ---- staging: Q block and K (group 0), V (group 1), the mask
  stage_rows<T, DH, kThreadsFwd>(
      qs, KP, static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh + q0 * p.qsl, p.qsl, nq, kBQ);
  stage_rows<T, DH, kThreadsFwd>(
      ks, KP, static_cast<const T*>(p.k) + b * p.ksb + h * p.ksh, p.ksl, Lk, L.lkp);
  cp_async_commit();
  stage_rows<T, DH, kThreadsFwd>(
      vs, DH, static_cast<const T*>(p.v) + b * p.vsb + h * p.vsh, p.vsl, Lk, L.lkp);
  cp_async_commit();
  for (int j = threadIdx.x; j < Lk; j += kThreadsFwd) ms[j] = p.m[b * p.msb + j * p.msl];
  cp_async_wait<1>();
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const bool active = warp * kWarpRows < nq;  // the warp owns block rows 8 * warp .. + 7
  const int tx = threadIdx.x & (kLanesPerRow - 1);
  const int r0 = (threadIdx.x / kLanesPerRow) * kRowsPerThread;  // first score row
  const int nc = L.lkp / kLanesPerRow;  // score columns per thread: tx + 8 c
  constexpr bool kBounded = MAXC == kColsLarge;  // only the large tier has nc < MAXC
  float s[kRowsPerThread][MAXC];

  if (active) {
    // ---- S = Q K^T: 2 rows x nc columns per thread, summed over d in order
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
      for (int c = 0; c < MAXC; ++c) s[r][c] = 0.f;
    const float* qr = qs + r0 * KP;
    const float* kr = ks + tx * KP;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 a[kRowsPerThread];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) a[r] = ld4(qr + r * KP + d);
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        if (kBounded && c >= nc) break;
        const float4 kv = ld4(kr + c * kLanesPerRow * KP + d);
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
          s[r][c] = fmaf(a[r].x, kv.x, s[r][c]);
          s[r][c] = fmaf(a[r].y, kv.y, s[r][c]);
          s[r][c] = fmaf(a[r].z, kv.z, s[r][c]);
          s[r][c] = fmaf(a[r].w, kv.w, s[r][c]);
        }
      }
    }

    // ---- softmax over each row's 8 lanes, then dropout. Straight-line
    // over all MAXC columns (columns past Lk read -inf and come out 0),
    // so a row's exponentials interleave; one reciprocal per row.
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
      for (int c = 0; c < MAXC; ++c) s[r][c] *= inv;
      if (p.dropout) {
        const int row = q0 + r0 + r;
#pragma unroll
        for (int c = 0; c < MAXC; ++c)
          s[r][c] = dropout_keep(key, row, tx + c * kLanesPerRow, Lk, p.thresh)
                        ? s[r][c] * p.inv_keep
                        : 0.f;
      }
    }
  }

  cp_async_wait<0>();
  __syncthreads();  // V has landed, and no warp reads the Q block any more

  if (active) {
    // P over the Q block; columns [Lk, lkp) hold zeros
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
      for (int c = 0; c < MAXC; ++c)
        if (!kBounded || c < nc) ps[(r0 + r) * PP + tx + c * kLanesPerRow] = s[r][c];
    __syncwarp();  // this warp reads back only its own 8 rows

    // ---- O = P V: RO rows x 4 contiguous d per thread, summed over keys in order
    constexpr int DG = DH / 4;
    constexpr int RO = kBQ * DG / kThreadsFwd;
    static_assert(RO >= 1 && RO * (kThreadsFwd / DG) == kBQ, "rows per thread");
    const int td = threadIdx.x % DG;
    const int ro0 = (threadIdx.x / DG) * RO;
    float4 o[RO];
#pragma unroll
    for (int r = 0; r < RO; ++r) o[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    const float* pr = ps + ro0 * PP;
    const float* vc = vs + td * 4;
    const int lk4 = (Lk + 3) & ~3;
#pragma unroll 2
    for (int j = 0; j < lk4; j += 4) {
      const float4 v0 = ld4(vc + (j + 0) * DH);
      const float4 v1 = ld4(vc + (j + 1) * DH);
      const float4 v2 = ld4(vc + (j + 2) * DH);
      const float4 v3 = ld4(vc + (j + 3) * DH);
#pragma unroll
      for (int r = 0; r < RO; ++r) {
        const float4 pj = ld4(pr + r * PP + j);
        o[r].x = fmaf(pj.x, v0.x, o[r].x);
        o[r].y = fmaf(pj.x, v0.y, o[r].y);
        o[r].z = fmaf(pj.x, v0.z, o[r].z);
        o[r].w = fmaf(pj.x, v0.w, o[r].w);
        o[r].x = fmaf(pj.y, v1.x, o[r].x);
        o[r].y = fmaf(pj.y, v1.y, o[r].y);
        o[r].z = fmaf(pj.y, v1.z, o[r].z);
        o[r].w = fmaf(pj.y, v1.w, o[r].w);
        o[r].x = fmaf(pj.z, v2.x, o[r].x);
        o[r].y = fmaf(pj.z, v2.y, o[r].y);
        o[r].z = fmaf(pj.z, v2.z, o[r].z);
        o[r].w = fmaf(pj.z, v2.w, o[r].w);
        o[r].x = fmaf(pj.w, v3.x, o[r].x);
        o[r].y = fmaf(pj.w, v3.y, o[r].y);
        o[r].z = fmaf(pj.w, v3.z, o[r].z);
        o[r].w = fmaf(pj.w, v3.w, o[r].w);
      }
    }
    float* ob = p.out + b * p.osb + h * p.osh + td * 4;
#pragma unroll
    for (int r = 0; r < RO; ++r)
      if (ro0 + r < nq) *reinterpret_cast<float4*>(ob + (q0 + ro0 + r) * p.osl) = o[r];
  }
}

template <typename T, int DH, int MAXC>
cudaError_t launch_tile(const Params& p, long long ctas, cudaStream_t stream) {
  const size_t bytes = layout(p.Lk, DH).floats * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel<T, DH, MAXC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return err;
  }
  attention_fwd_kernel<T, DH, MAXC><<<(unsigned)ctas, kThreadsFwd, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_cols(const Params& p, long long ctas, cudaStream_t stream) {
  if (p.Lk <= kLanesPerRow * kColsSmall) return launch_tile<T, DH, kColsSmall>(p, ctas, stream);
  if (p.Lk <= kLanesPerRow * kColsMid) return launch_tile<T, DH, kColsMid>(p, ctas, stream);
  return launch_tile<T, DH, kColsLarge>(p, ctas, stream);
}

template <typename T>
cudaError_t launch(const Params& p, int B, int Dh, cudaStream_t stream) {
  const long long ctas = (long long)B * p.H * p.nqb;
  if (p.Lk > kMaxLk || ctas > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  switch (Dh) {
    case 16: return launch_cols<T, 16>(p, ctas, stream);
    case 32: return launch_cols<T, 32>(p, ctas, stream);
    case 64: return launch_cols<T, 64>(p, ctas, stream);
    case 128: return launch_cols<T, 128>(p, ctas, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA needs (the wrapper checks it
// against the card's 227 KB per-block limit before launching).
long long hamt_attention_smem_bytes(int Lk, int Dh) {
  return (long long)(layout(Lk, Dh).floats * sizeof(float));
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v share it). Strides are in
// elements; Dh is contiguous and one of 16, 32, 64, 128; Lk <= 256; every
// pointer and stride a multiple of 16 bytes. Returns a cudaError_t.
int hamt_attention_fwd(const void* q, const void* k, const void* v,
                       const float* m, float* out, int dtype, int B, int H,
                       int Lq, int Lk, int Dh, long long qsb, long long qsh,
                       long long qsl, long long ksb, long long ksh,
                       long long ksl, long long vsb, long long vsh,
                       long long vsl, long long msb, long long msl,
                       long long osb, long long osh, long long osl,
                       float scale, unsigned int seed, unsigned int thresh,
                       float inv_keep, int dropout, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.m = m; p.out = out;
  p.H = H; p.Lq = Lq; p.Lk = Lk; p.nqb = (Lq + kBQ - 1) / kBQ;
  p.qsb = qsb; p.qsh = qsh; p.qsl = qsl;
  p.ksb = ksb; p.ksh = ksh; p.ksl = ksl;
  p.vsb = vsb; p.vsh = vsh; p.vsl = vsl;
  p.msb = msb; p.msl = msl;
  p.osb = osb; p.osh = osh; p.osl = osl;
  p.scale = scale; p.seed = seed; p.thresh = thresh;
  p.inv_keep = inv_keep; p.dropout = dropout;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(p, B, Dh, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, B, Dh, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
