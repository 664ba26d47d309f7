// Single-query cross attention over the cached audio keys/values: the
// attention core of cross_block_decode (olmoasr_tpu/ops/attention.py,
// _cross_block_kernel, non-transposed keys, one query row per cache row).
//
// For batch row b and head h, with q already projected (fp32, bias added):
//   logit[t] = (q_h * dh^-0.5) . k[b, t, h] * ks[b, t]
//   w        = softmax_t(logit)            (fp32)
//   attn_h   = sum_t w[t] * vs[b, t] * v[b, t, h]
// K/V are bf16, fp32 or int8 with per-position fp32 scales (ones when the
// cache is not quantized). q stays unquantized: the TPU kernel's int8 q.K
// product (q quantized per head) is a matrix-unit rate device, and the port
// keeps the exact product of its fp32 path.
//
// What bounds it: every decode step reads the whole cross cache of every
// layer, B * T * D * 2 elements per layer (small.en, B = 64, T = 1500,
// D = 768, bf16: 295 MB per layer). FLOPs are 2 per element read. The design
// spreads that read over the whole card and keeps many loads in flight:
//   * one block per (T-chunk of 128 keys, head, batch row) -- 9216 blocks at
//     that size -- writing a partial (max, sum, weighted values) triple that
//     a second launch combines (flash-decoding style);
//   * every load is 16 bytes: a key's head slice (64 features) is read by
//     dh*sizeof/16 neighbouring lanes (8 for bf16), so a warp covers several
//     keys per load, and each thread issues kCaUnroll loads before it uses any.
#include "common.cuh"

namespace olm {

constexpr int kCaThreads = 128;
constexpr int kCaChunk = 128;
constexpr int kCaUnroll = 4;  // loads a thread issues before using them

__device__ __forceinline__ float block_reduce(float v, float* scratch, bool is_max) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = is_max ? warp_max(v) : warp_sum(v);
  __syncthreads();  // scratch may still be read by a previous reduction
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = scratch[0];
  for (int i = 1; i < kCaThreads / 32; ++i) r = is_max ? fmaxf(r, scratch[i]) : r + scratch[i];
  return r;
}

// 16 bytes of KV elements, widened to fp32.
template <typename KV, int V>
__device__ __forceinline__ void widen(const uint4& raw, float (&out)[V]) {
  const KV* e = reinterpret_cast<const KV*>(&raw);
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = to_f(e[i]);
}

template <typename KV>
__global__ void __launch_bounds__(kCaThreads)
    cross_attn_partial_kernel(const float* __restrict__ q, const KV* __restrict__ k,
                              const KV* __restrict__ v, const float* __restrict__ ks,
                              const float* __restrict__ vs, float* __restrict__ m_part,
                              float* __restrict__ l_part, float* __restrict__ acc_part, int T,
                              int D, int H, int nchunks, float qscale) {
  constexpr int V = 16 / sizeof(KV);  // elements per 16-byte load
  __shared__ float sp[kCaChunk];
  __shared__ float sacc[kCaThreads * V];  // (key group, feature) partial sums
  __shared__ float scratch[kCaThreads / 32];

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int dh = D / H;
  const int lpk = dh / V;  // lanes per key: a power of two dividing 32 (checked)
  const int tid = threadIdx.x, sub = tid % lpk, kg = tid / lpk;
  const int groups = kCaThreads / lpk;  // keys in flight per block-wide load
  const int t0 = c * kCaChunk;
  const int n = min(kCaChunk, T - t0);
  const size_t row0 = static_cast<size_t>(b) * T + t0;  // first (b, t) row of the chunk
  const size_t col = static_cast<size_t>(h) * dh + sub * V;  // this thread's features

  float qv[V];
#pragma unroll
  for (int i = 0; i < V; ++i) qv[i] = q[static_cast<size_t>(b) * D + col + i] * qscale;

  // logits: lpk lanes per key, a shuffle tree sums their partial dots
  for (int base = 0; base < n; base += groups * kCaUnroll) {
    uint4 raw[kCaUnroll];
#pragma unroll
    for (int u = 0; u < kCaUnroll; ++u) {
      const int j = base + u * groups + kg;
      raw[u] = j < n ? *reinterpret_cast<const uint4*>(k + (row0 + j) * D + col)
                     : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kCaUnroll; ++u) {
      float e[V];
      widen<KV, V>(raw[u], e);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) s += qv[i] * e[i];
      for (int o = lpk / 2; o > 0; o >>= 1) s += __shfl_xor_sync(kFullMask, s, o);
      const int j = base + u * groups + kg;
      if (j < n && sub == 0) sp[j] = s * ks[row0 + j];
    }
  }
  __syncthreads();

  float mx = -INFINITY;
  for (int j = tid; j < n; j += kCaThreads) mx = fmaxf(mx, sp[j]);
  mx = block_reduce(mx, scratch, true);
  float lsum = 0.f;
  for (int j = tid; j < n; j += kCaThreads) {
    const float e = expf(sp[j] - mx);
    lsum += e;
    sp[j] = e * vs[row0 + j];  // the per-key value scale folds into the weight
  }
  lsum = block_reduce(lsum, scratch, false);  // its barriers also publish sp

  // weighted values: the same lane layout, each thread V features of its keys
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  for (int base = 0; base < n; base += groups * kCaUnroll) {
    uint4 raw[kCaUnroll];
    float w[kCaUnroll];
#pragma unroll
    for (int u = 0; u < kCaUnroll; ++u) {
      const int j = base + u * groups + kg;
      const bool in = j < n;
      raw[u] = in ? *reinterpret_cast<const uint4*>(v + (row0 + j) * D + col)
                  : make_uint4(0, 0, 0, 0);
      w[u] = in ? sp[j] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kCaUnroll; ++u) {
      float e[V];
      widen<KV, V>(raw[u], e);
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] += w[u] * e[i];
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) sacc[kg * dh + sub * V + i] = acc[i];
  __syncthreads();
  const size_t part = (static_cast<size_t>(b) * H + h) * nchunks + c;
  if (tid < dh) {
    float s = 0.f;
    for (int g = 0; g < groups; ++g) s += sacc[g * dh + tid];
    acc_part[part * dh + tid] = s;
  }
  if (tid == 0) {
    m_part[part] = mx;
    l_part[part] = lsum;
  }
}

template <typename T>
__global__ void cross_attn_combine_kernel(const float* __restrict__ m_part,
                                          const float* __restrict__ l_part,
                                          const float* __restrict__ acc_part, T* __restrict__ out,
                                          int D, int H, int nchunks) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int dh = D / H;
  const size_t p0 = (static_cast<size_t>(b) * H + h) * nchunks;
  float mx = -INFINITY;
  for (int c = 0; c < nchunks; ++c) mx = fmaxf(mx, m_part[p0 + c]);
  float l = 0.f, a = 0.f;
  for (int c = 0; c < nchunks; ++c) {
    const float w = expf(m_part[p0 + c] - mx);
    l += l_part[p0 + c] * w;
    a += acc_part[(p0 + c) * dh + d] * w;
  }
  out[static_cast<size_t>(b) * D + h * dh + d] = from_f<T>(a / l);
}

template <typename KV>
int launch_partial(dim3 grid, cudaStream_t s, const float* q, const void* k, const void* v,
                   const float* ks, const float* vs, float* m_part, float* l_part,
                   float* acc_part, int T, int D, int H, int nchunks, float qscale) {
  constexpr int V = 16 / sizeof(KV);
  const int dh = D / H;
  // 16-byte loads along each head, lanes of one key inside one warp
  if (dh < V || dh % V != 0 || 32 % (dh / V) != 0) return cudaErrorInvalidValue;
  cross_attn_partial_kernel<KV><<<grid, kCaThreads, 0, s>>>(
      q, static_cast<const KV*>(k), static_cast<const KV*>(v), ks, vs, m_part, l_part, acc_part,
      T, D, H, nchunks, qscale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace olm

// Scratch: m_part and l_part hold B*H*nchunks floats, acc_part B*H*nchunks*dh,
// with nchunks = ceil(T / 128) (olm_cross_attention_chunks). K and V rows
// must be 16-byte aligned.
extern "C" int olm_cross_attention_chunks(int T) { return (T + olm::kCaChunk - 1) / olm::kCaChunk; }

extern "C" int olm_cross_attention(const float* q, const void* k, const void* v, const float* ks,
                                   const float* vs, float* m_part, float* l_part,
                                   float* acc_part, void* out, int B, int T, int D, int H,
                                   int kv_dtype, int out_dtype, float qscale, void* stream) {
  using namespace olm;
  if (B <= 0 || T <= 0 || H <= 0 || D % H != 0) return cudaErrorInvalidValue;
  const int dh = D / H;
  if (dh > kCaThreads) return cudaErrorInvalidValue;
  const int nchunks = olm_cross_attention_chunks(T);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(nchunks, H, B);
  int err;
  if (kv_dtype == kBF16)
    err = launch_partial<__nv_bfloat16>(grid, s, q, k, v, ks, vs, m_part, l_part, acc_part, T, D, H, nchunks, qscale);
  else if (kv_dtype == kF32)
    err = launch_partial<float>(grid, s, q, k, v, ks, vs, m_part, l_part, acc_part, T, D, H, nchunks, qscale);
  else if (kv_dtype == kI8)
    err = launch_partial<int8_t>(grid, s, q, k, v, ks, vs, m_part, l_part, acc_part, T, D, H, nchunks, qscale);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  const dim3 grid2(H, B);
  if (out_dtype == kBF16)
    cross_attn_combine_kernel<__nv_bfloat16><<<grid2, dh, 0, s>>>(
        m_part, l_part, acc_part, static_cast<__nv_bfloat16*>(out), D, H, nchunks);
  else if (out_dtype == kF32)
    cross_attn_combine_kernel<float><<<grid2, dh, 0, s>>>(m_part, l_part, acc_part,
                                                          static_cast<float*>(out), D, H, nchunks);
  else
    return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}
