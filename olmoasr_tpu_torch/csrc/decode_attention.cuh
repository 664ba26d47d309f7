// Single-query attention over cached keys/values, split over positions: the
// shared core of the decode-step cross attention (cross_attention.cu) and
// self attention (self_attention.cu).
//
// For query row b and head h, over the first T keys of kv row b / kv_group:
//   logit[t] = (q_h * qscale) . k[t, h] * ks[t]
//   w        = softmax_t(logit)            (fp32)
//   out_h    = sum_t w[t] * vs[t] * v[t, h]
// with per-position fp32 scales ks/vs (null: ones), and optionally one more
// key/value per row (this step's own k_new/v_new in self attention) folded
// into the softmax by the combine launch.
//
// What bounds it: the K/V read, 2 * T * D elements per kv row. FLOPs are 2
// per element read. The design spreads that read over the whole card and
// keeps many loads in flight:
//   * one block per (T-chunk of 128 keys, head, query row) writes a partial
//     (max, sum, weighted values) triple; a second launch combines them
//     (flash-decoding style);
//   * every load is 16 bytes: a key's head slice is read by dh*sizeof/16
//     neighbouring lanes (8 for bf16 at dh = 64), so a warp covers several
//     keys per load, and each thread issues kCaUnroll loads before it uses
//     any;
//   * the kv_group query rows that share a kv row are neighbours in the
//     grid's fastest dimension, so their blocks run together and all but the
//     first read the chunk from L2: device memory sees each kv row once.
//
// Everything here has internal linkage: each .cu that includes it gets its
// own instantiations.
#pragma once

#include "common.cuh"

namespace olm {
namespace {

constexpr int kCaThreads = 128;
constexpr int kCaChunk = 128;
constexpr int kCaUnroll = 4;  // loads a thread issues before using them

struct DecodeAttnArgs {
  const void* q;        // (rows, D) query rows, row stride q_stride elements
  long long q_stride;
  const void* k;        // kv row r, key t at (r * row_keys + t) * D
  const void* v;
  const float* ks;      // (kv rows, row_keys) per-position scales, or null
  const float* vs;
  float* m_part;        // (rows, H, nchunks)
  float* l_part;
  float* acc_part;      // (rows, H, nchunks, dh)
  int T;                // keys attended per row
  int row_keys;         // keys stored per kv row (>= T)
  int D, H, nchunks, kv_group;
  float qscale;
};

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

// grid (nchunks * kv_group, H, kv rows)
template <typename KV, typename Q>
__global__ void __launch_bounds__(kCaThreads) attn_partial_kernel(const DecodeAttnArgs p) {
  constexpr int V = 16 / sizeof(KV);  // elements per 16-byte load
  __shared__ float sp[kCaChunk];
  __shared__ float sacc[kCaThreads * V];  // (key group, feature) partial sums
  __shared__ float scratch[kCaThreads / 32];

  const int G = p.kv_group;
  const int c = blockIdx.x / G, h = blockIdx.y, kvb = blockIdx.z;
  const int b = kvb * G + blockIdx.x % G;  // query row
  const int D = p.D, dh = D / p.H;
  const int lpk = dh / V;  // lanes per key: a power of two dividing 32 (checked)
  const int tid = threadIdx.x, sub = tid % lpk, kg = tid / lpk;
  const int groups = kCaThreads / lpk;  // keys in flight per block-wide load
  const int t0 = c * kCaChunk;
  const int n = min(kCaChunk, p.T - t0);
  const size_t row0 = static_cast<size_t>(kvb) * p.row_keys + t0;  // first key row of the chunk
  const size_t col = static_cast<size_t>(h) * dh + sub * V;         // this thread's features
  const KV* k = static_cast<const KV*>(p.k);
  const KV* v = static_cast<const KV*>(p.v);
  const Q* q = static_cast<const Q*>(p.q) + static_cast<size_t>(b) * p.q_stride;

  float qv[V];
#pragma unroll
  for (int i = 0; i < V; ++i) qv[i] = to_f(q[col + i]) * p.qscale;

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
      if (j < n && sub == 0) sp[j] = p.ks ? s * p.ks[row0 + j] : s;
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
    sp[j] = p.vs ? e * p.vs[row0 + j] : e;  // the per-key value scale folds into the weight
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
  const size_t part = (static_cast<size_t>(b) * p.H + h) * p.nchunks + c;
  if (tid < dh) {
    float s = 0.f;
    for (int g = 0; g < groups; ++g) s += sacc[g * dh + tid];
    p.acc_part[part * dh + tid] = s;
  }
  if (tid == 0) {
    p.m_part[part] = mx;
    p.l_part[part] = lsum;
  }
}

// Merge the chunks' partials of one (head, row), plus the row's own new key
// and value when k_new is given (rows at new_stride elements, like q).
// grid (H, rows), dh threads; out is (rows, D) contiguous.
template <typename Q, typename O>
__global__ void __launch_bounds__(kCaThreads) attn_combine_kernel(const DecodeAttnArgs p,
                                                                  const Q* __restrict__ k_new,
                                                                  const Q* __restrict__ v_new,
                                                                  long long new_stride,
                                                                  O* __restrict__ out) {
  __shared__ float red[kCaThreads];
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int dh = p.D / p.H;
  const size_t col = static_cast<size_t>(h) * dh + d;
  const size_t p0 = (static_cast<size_t>(b) * p.H + h) * p.nchunks;
  float mx = -INFINITY;
  for (int c = 0; c < p.nchunks; ++c) mx = fmaxf(mx, p.m_part[p0 + c]);
  float s_new = 0.f, v_own = 0.f;
  if (k_new) {
    const Q* q = static_cast<const Q*>(p.q) + static_cast<size_t>(b) * p.q_stride;
    const size_t r = static_cast<size_t>(b) * new_stride;
    red[d] = to_f(q[col]) * p.qscale * to_f(k_new[r + col]);
    __syncthreads();
    for (int i = 0; i < dh; ++i) s_new += red[i];  // every thread, the same order
    v_own = to_f(v_new[r + col]);
    mx = fmaxf(mx, s_new);
  }
  float l = 0.f, a = 0.f;
  for (int c = 0; c < p.nchunks; ++c) {
    const float w = expf(p.m_part[p0 + c] - mx);
    l += p.l_part[p0 + c] * w;
    a += p.acc_part[(p0 + c) * dh + d] * w;
  }
  if (k_new) {
    const float w = expf(s_new - mx);
    l += w;
    a += w * v_own;
  }
  out[static_cast<size_t>(b) * p.D + col] = from_f<O>(a / l);
}

// Launch the partial pass (when T > 0) and the combine. K/V rows must be
// 16-byte aligned; rows = kv rows * kv_group.
template <typename KV, typename Q, typename O>
int launch_decode_attention(const DecodeAttnArgs& p, int rows, const Q* k_new, const Q* v_new,
                            long long new_stride, O* out, cudaStream_t s) {
  constexpr int V = 16 / sizeof(KV);
  const int dh = p.D / p.H;
  // 16-byte loads along each head, lanes of one key inside one warp
  if (dh < V || dh % V != 0 || 32 % (dh / V) != 0 || dh > kCaThreads) return cudaErrorInvalidValue;
  if (p.kv_group <= 0 || rows % p.kv_group != 0) return cudaErrorInvalidValue;
  if (p.T > 0) {
    const dim3 grid(p.nchunks * p.kv_group, p.H, rows / p.kv_group);
    attn_partial_kernel<KV, Q><<<grid, kCaThreads, 0, s>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  attn_combine_kernel<Q, O><<<dim3(p.H, rows), dh, 0, s>>>(p, k_new, v_new, new_stride, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace olm
