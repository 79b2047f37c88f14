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
// The keep mask is the forward's counter hash (attention_common.cuh), so
// the backward drops exactly the elements the forward dropped.
//
// What bounds it on an H100: at HAMT's lengths (Lq, Lk <= 65 at R2R
// width) one launch reads q, k, v, g and the mask and writes dq, dk, dv
// and dm once -- a few MB at batch 32, a floor of a few microseconds over
// HBM -- beside 10 * B * H * Lq * Lk * Dh fp32 FLOPs (five Lq x Lk x Dh
// products), which bound the fp32 launches of the main path. The design
// keeps the (Lq, Lk) matrices out of HBM: one CTA per (b, h) stages q, g,
// k and v in shared memory as fp32 (rows padded to Dh + 1 floats, so
// lanes that stride over rows hit different banks) and works in two
// phases with no atomics:
//   1. warps walk query rows: scores, softmax, g v^T, the keep mask and
//      ds, each lane owning a stride of columns; the dropped p and ds
//      rows stay in shared memory and the warp writes its dq row;
//   2. after a barrier, warps walk key rows: dv and dk rows over the
//      stored p and ds columns, and the column sum of ds, the head's
//      part of dm, into a (B, H, Lk) fp32 scratch.
// A second small kernel sums the scratch over heads in head order, so dm
// is deterministic (the TPU kernel carries that sum across its
// sequential head grid axis; blocks on Hopper run in no order). A caller
// whose mask takes no gradient passes null scratch and dm: the column
// sums and the second kernel are then skipped.
//
// Shared memory at Lq = Lk = 65, Dh = 64 is 105,820 bytes per CTA (two
// CTAs per SM); the wrapper checks hamt_attention_bwd_smem_bytes against
// the 227 KB per-block limit, which a self-attention over more than 114
// tokens exceeds (RxR's 250-token text needs 779,000 bytes): such lengths
// need a tiled design. At batch 8 the main path launches 96 CTAs on 132
// SMs.
//
// q, k, v, g and the outputs dq, dk, dv are addressed through (batch,
// head, row) strides with a unit stride on Dh, so the layer's (B, L, H, Dh)
// projections and gradients need no transpose copies. q, k, v are fp32 or
// bf16 and dq, dk, dv have their type; the mask, g and dm are fp32.
//
// Plain C interface (bound with ctypes): hamt_attention_bwd enqueues the
// kernels on the caller's stream, does not synchronise, and returns the
// first cudaError_t.

#include "attention_common.cuh"

namespace {

using namespace hamt;

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const float* m;
  const float* g;
  void* dq;
  void* dk;
  void* dv;
  float* dm_heads;  // (B, H, Lk) contiguous, or null: no dm
  int H, Lq, Lk, Dh;
  // element strides (batch, head, row) of q, k, v, g, dq, dk, dv and
  // (batch, col) of m
  long long qs[3], ks[3], vs[3], gs[3], dqs[3], dks[3], dvs[3], ms[2];
  float scale;
  uint32_t seed;
  uint32_t thresh;
  float inv_keep;
  int dropout;
};

// Row pitch of the (Lq, Lk) p and ds tiles: odd, so the lanes of phase 2
// that walk query rows of one column hit different banks.
__host__ __device__ inline int pitch(int Lk) { return Lk | 1; }

// Shared memory, in floats: q and g (Lq x (Dh + 1) each), k and v
// (Lk x (Dh + 1) each), dropped p and ds (Lq x pitch each), the mask
// (Lk), one p row and one dp row per warp (2 x kWarps x Lk).
__host__ __device__ inline size_t bwd_smem_floats(int Lq, int Lk, int Dh) {
  const size_t ld = (size_t)Dh + 1;
  return 2 * (size_t)Lq * ld + 2 * (size_t)Lk * ld + 2 * (size_t)Lq * pitch(Lk) +
         Lk + 2 * (size_t)kWarps * Lk;
}

template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, long long row_stride,
                                      int rows, int Dh) {
  const int ld = Dh + 1;
  for (int i = threadIdx.x; i < rows * Dh; i += kThreads) {
    const int r = i / Dh;
    const int d = i - r * Dh;
    dst[r * ld + d] = to_float(src[r * row_stride + d]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) attention_bwd_kernel(BwdParams p) {
  extern __shared__ float smem[];
  const int Lq = p.Lq, Lk = p.Lk, Dh = p.Dh, ld = Dh + 1, lp = pitch(Lk);
  float* qs = smem;
  float* gs = qs + (size_t)Lq * ld;
  float* ks = gs + (size_t)Lq * ld;
  float* vs = ks + (size_t)Lk * ld;
  float* pds = vs + (size_t)Lk * ld;    // dropped p, (Lq, lp)
  float* dss = pds + (size_t)Lq * lp;   // ds, (Lq, lp)
  float* msk = dss + (size_t)Lq * lp;   // mask, (Lk)
  float* prow = msk + Lk;               // per warp: p row, then dp row
  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x - b * p.H;

  stage(qs, static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[1], p.qs[2], Lq, Dh);
  stage(ks, static_cast<const T*>(p.k) + b * p.ks[0] + h * p.ks[1], p.ks[2], Lk, Dh);
  stage(vs, static_cast<const T*>(p.v) + b * p.vs[0] + h * p.vs[1], p.vs[2], Lk, Dh);
  stage(gs, p.g + b * p.gs[0] + h * p.gs[1], p.gs[2], Lq, Dh);
  for (int j = threadIdx.x; j < Lk; j += kThreads) msk[j] = p.m[b * p.ms[0] + j * p.ms[1]];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* pw = prow + (size_t)warp * 2 * Lk;  // softmax p of the row
  float* dw = pw + Lk;                       // dp of the row
  const uint32_t key = dropout_key(p.seed, b, h);

  // ---- phase 1: query rows -> dropped p, ds, dq
  T* dqb = static_cast<T*>(p.dq) + b * p.dqs[0] + h * p.dqs[1];
  for (int r = warp; r < Lq; r += kWarps) {
    const float* qr = qs + r * ld;
    const float* gr = gs + r * ld;
    // scores, as the forward computes them
    float mx = -INFINITY;
    for (int j = lane; j < Lk; j += 32) {
      const float* kr = ks + j * ld;
      float s = 0.f;
      for (int d = 0; d < Dh; ++d) s = fmaf(qr[d], kr[d], s);
      s = s * p.scale + msk[j];
      pw[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < Lk; j += 32) {
      const float e = expf(pw[j] - mx);
      pw[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    // p, dp through the keep mask, and rowsum(dp * p)
    float rs = 0.f;
    for (int j = lane; j < Lk; j += 32) {
      const float pj = pw[j] / sum;
      const float* vr = vs + j * ld;
      float dpj = 0.f;
      for (int d = 0; d < Dh; ++d) dpj = fmaf(gr[d], vr[d], dpj);
      float pdj = pj;
      if (p.dropout) {
        const bool keep = dropout_keep(key, r, j, Lk, p.thresh);
        pdj = keep ? pj * p.inv_keep : 0.f;
        dpj = keep ? dpj * p.inv_keep : 0.f;
      }
      pw[j] = pj;
      dw[j] = dpj;
      pds[r * lp + j] = pdj;
      rs = fmaf(dpj, pj, rs);
    }
    rs = warp_sum(rs);
    for (int j = lane; j < Lk; j += 32) dss[r * lp + j] = pw[j] * (dw[j] - rs);
    __syncwarp();
    // dq row: lanes stride over Dh, the ds row is broadcast
    const float* sr = dss + r * lp;
    T* dqr = dqb + r * p.dqs[2];
    for (int d = lane; d < Dh; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < Lk; ++j) acc = fmaf(sr[j], ks[j * ld + d], acc);
      dqr[d] = from_float<T>(acc * p.scale);
    }
    __syncwarp();  // pw / dw are rewritten for the next row
  }
  __syncthreads();

  // ---- phase 2: key rows -> dv, dk, the head's dm row
  T* dkb = static_cast<T*>(p.dk) + b * p.dks[0] + h * p.dks[1];
  T* dvb = static_cast<T*>(p.dv) + b * p.dvs[0] + h * p.dvs[1];
  float* dmh = p.dm_heads ? p.dm_heads + ((size_t)b * p.H + h) * Lk : nullptr;
  for (int j = warp; j < Lk; j += kWarps) {
    T* dkr = dkb + j * p.dks[2];
    T* dvr = dvb + j * p.dvs[2];
    for (int d = lane; d < Dh; d += 32) {
      float acc_v = 0.f, acc_k = 0.f;
      for (int r = 0; r < Lq; ++r) {
        acc_v = fmaf(pds[r * lp + j], gs[r * ld + d], acc_v);
        acc_k = fmaf(dss[r * lp + j], qs[r * ld + d], acc_k);
      }
      dvr[d] = from_float<T>(acc_v);
      dkr[d] = from_float<T>(acc_k * p.scale);
    }
    if (dmh) {  // uniform over the block
      float part = 0.f;
      for (int r = lane; r < Lq; r += 32) part += dss[r * lp + j];
      part = warp_sum(part);
      if (lane == 0) dmh[j] = part;
    }
  }
}

// dm[b, j] = sum over h, in order, of dm_heads[b, h, j]; dm is (B, Lk)
// contiguous fp32.
__global__ void attention_bwd_dm_kernel(const float* dm_heads, float* dm, int B, int H,
                                        int Lk) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * Lk) return;
  const int b = i / Lk;
  const int j = i - b * Lk;
  const float* src = dm_heads + (size_t)b * H * Lk + j;
  float acc = 0.f;
  for (int h = 0; h < H; ++h) acc += src[(size_t)h * Lk];
  dm[i] = acc;
}

template <typename T>
cudaError_t launch_bwd(const BwdParams& p, int B, float* dm, cudaStream_t stream) {
  const size_t bytes = bwd_smem_floats(p.Lq, p.Lk, p.Dh) * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        attention_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  attention_bwd_kernel<T><<<B * p.H, kThreads, bytes, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || dm == nullptr) return err;
  const int n = B * p.Lk, threads = 256;
  attention_bwd_dm_kernel<<<(n + threads - 1) / threads, threads, 0, stream>>>(
      p.dm_heads, dm, B, p.H, p.Lk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA of the backward needs.
long long hamt_attention_bwd_smem_bytes(int Lq, int Lk, int Dh) {
  return (long long)(bwd_smem_floats(Lq, Lk, Dh) * sizeof(float));
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dq, dk, dv share it).
// strides: 23 element strides, in this order: q, k, v, g, dq, dk, dv
// (batch, head, row each) and m (batch, col). dm_heads is a (B, H, Lk)
// fp32 scratch and dm the (B, Lk) fp32 output, both contiguous, or both
// null when the mask's cotangent is not wanted.
// Returns a cudaError_t.
int hamt_attention_bwd(const void* q, const void* k, const void* v, const float* m,
                       const float* g, void* dq, void* dk, void* dv, float* dm_heads,
                       float* dm, int dtype, int B, int H, int Lq, int Lk, int Dh,
                       const long long* strides, float scale, unsigned int seed,
                       unsigned int thresh, float inv_keep, int dropout, void* stream) {
  BwdParams p;
  p.q = q; p.k = k; p.v = v; p.m = m; p.g = g;
  p.dq = dq; p.dk = dk; p.dv = dv; p.dm_heads = dm_heads;
  p.H = H; p.Lq = Lq; p.Lk = Lk; p.Dh = Dh;
  long long* dst[7] = {p.qs, p.ks, p.vs, p.gs, p.dqs, p.dks, p.dvs};
  for (int t = 0; t < 7; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  p.ms[0] = strides[21];
  p.ms[1] = strides[22];
  p.scale = scale; p.seed = seed; p.thresh = thresh;
  p.inv_keep = inv_keep; p.dropout = dropout;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_bwd<float>(p, B, dm, s);
  if (dtype == 1) return (int)launch_bwd<__nv_bfloat16>(p, B, dm, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
