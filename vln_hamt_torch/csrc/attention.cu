// Fused masked attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel vln_hamt_tpu/ops/attention.py:_attn_kernel
// (pallas_call at :215). For one (batch, head) pair it computes
//
//     out = dropout(softmax(q k^T * scale + m)) v        (all fp32)
//
// with the same counter-hash dropout as the TPU kernel, so the keep mask
// is bit-identical to vln_hamt_tpu/ops/attention.py:_dropout_keep_mask:
//     key  = seed + b * 0x9E3779B1 + h * 0x85EBCA77          (uint32)
//     bits = splitmix32(key ^ splitmix32(row * Lk + col))
//     keep = bits >= thresh,  kept values scaled by 1 / (1 - rate).
//
// What bounds it on an H100: HAMT's sequences are short (Lq, Lk <= 67
// at R2R width, <= 250 for RxR text), so each launch moves q, k, v, the
// (B, Lk) mask and the fp32 output once through HBM -- a few MB at batch
// 32, a floor of a few microseconds -- beside 4 * B * H * Lq * Lk * Dh
// fp32 CUDA-core FLOPs. The design keeps the whole (Lq, Lk) score matrix
// out of HBM: one CTA per (b, h) stages K and V in shared memory as fp32
// and each warp walks query rows. For a row the lanes stride over keys
// for the scores (K rows padded to Dh + 1 floats so the 32 lanes hit 32
// different banks), reduce max and sum with warp shuffles, apply the
// dropout hash per (row, col), then stride over Dh for p . v.
//
// q, k, v and out are addressed through (batch, head, row) strides with
// a unit stride on Dh, so the attention layer hands over its (B, L, H, Dh)
// projections without transpose copies. Inputs are fp32 or bf16.
//
// Plain C interface (bound with ctypes): hamt_attention_fwd returns the
// cudaError_t of the launch; the launch goes on the caller's stream and
// does not synchronise.

#include "attention_common.cuh"

namespace {

using namespace hamt;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* m;
  float* out;
  int H, Lq, Lk, Dh;
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

// Shared memory, in floats: K (Lk x (Dh + 1)), V (Lk x Dh), mask (Lk),
// one query row per warp (kWarps x Dh), one probability row per warp
// (kWarps x Lk).
__host__ __device__ inline size_t smem_floats(int Lk, int Dh) {
  return (size_t)Lk * (Dh + 1) + (size_t)Lk * Dh + Lk +
         (size_t)kWarps * Dh + (size_t)kWarps * Lk;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) attention_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  const int Lk = p.Lk, Dh = p.Dh, kstride = Dh + 1;
  float* ks = smem;
  float* vs = ks + (size_t)Lk * kstride;
  float* ms = vs + (size_t)Lk * Dh;
  float* qs = ms + Lk;
  float* ps = qs + kWarps * Dh;

  const int b = blockIdx.x / p.H;
  const int h = blockIdx.x - b * p.H;
  const T* qb = static_cast<const T*>(p.q) + b * p.qsb + h * p.qsh;
  const T* kb = static_cast<const T*>(p.k) + b * p.ksb + h * p.ksh;
  const T* vb = static_cast<const T*>(p.v) + b * p.vsb + h * p.vsh;
  float* ob = p.out + b * p.osb + h * p.osh;

  for (int i = threadIdx.x; i < Lk * Dh; i += kThreads) {
    const int j = i / Dh;
    const int d = i - j * Dh;
    ks[j * kstride + d] = to_float(kb[j * p.ksl + d]);
    vs[j * Dh + d] = to_float(vb[j * p.vsl + d]);
  }
  for (int j = threadIdx.x; j < Lk; j += kThreads) ms[j] = p.m[b * p.msb + j * p.msl];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* qw = qs + warp * Dh;
  float* pw = ps + warp * Lk;
  const uint32_t key = dropout_key(p.seed, b, h);

  for (int r = warp; r < p.Lq; r += kWarps) {
    const T* qrow = qb + r * p.qsl;
    for (int d = lane; d < Dh; d += 32) qw[d] = to_float(qrow[d]);
    __syncwarp();

    // scores; each lane keeps its own columns in pw
    float mx = -INFINITY;
    for (int j = lane; j < Lk; j += 32) {
      const float* kr = ks + j * kstride;
      float s = 0.f;
      for (int d = 0; d < Dh; ++d) s = fmaf(qw[d], kr[d], s);
      s = s * p.scale + ms[j];
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
    for (int j = lane; j < Lk; j += 32) {
      float pj = pw[j] / sum;
      if (p.dropout) pj = dropout_keep(key, r, j, Lk, p.thresh) ? pj * p.inv_keep : 0.f;
      pw[j] = pj;
    }
    __syncwarp();

    float* orow = ob + r * p.osl;
    for (int d = lane; d < Dh; d += 32) {
      float acc = 0.f;
      for (int j = 0; j < Lk; ++j) acc = fmaf(pw[j], vs[j * Dh + d], acc);
      orow[d] = acc;
    }
    __syncwarp();  // qw / pw are rewritten for the next row
  }
}

template <typename T>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const size_t bytes = smem_floats(p.Lk, p.Dh) * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        attention_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return err;
  }
  attention_fwd_kernel<T><<<B * p.H, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA needs (the wrapper checks it
// against the card's 227 KB per-block limit before launching).
long long hamt_attention_smem_bytes(int Lk, int Dh) {
  return (long long)(smem_floats(Lk, Dh) * sizeof(float));
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v share it). Strides are in
// elements; Dh is contiguous. Returns a cudaError_t.
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
  p.H = H; p.Lq = Lq; p.Lk = Lk; p.Dh = Dh;
  p.qsb = qsb; p.qsh = qsh; p.qsl = qsl;
  p.ksb = ksb; p.ksh = ksh; p.ksl = ksl;
  p.vsb = vsb; p.vsh = vsh; p.vsl = vsl;
  p.msb = msb; p.msl = msl;
  p.osb = osb; p.osh = osh; p.osl = osl;
  p.scale = scale; p.seed = seed; p.thresh = thresh;
  p.inv_keep = inv_keep; p.dropout = dropout;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(p, B, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
