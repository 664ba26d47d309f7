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
// Two variants of the partial pass:
//   * ancestry (beam search): with `anc` set, query row b's key and value at
//     position t come from kv row g * G + anc[b, t], g = b / G the row's
//     group of G = kv_group beams, instead of kv row b / G;
//   * int8 q.K (`quant_q`, int8 keys): q is rounded per head to int8 with
//     its own scale, amax(|q_h|) / 127, and the logit is the s32 dot product
//     of the int8 vectors (__dp4a, four products an instruction) times that
//     scale, then times ks[t], as the TPU kernel's _qk_logits takes it.
// and the TPU kernels' bf16 dot dtype, as a template argument kRound of the
// pass (bf16 activations; 0 keeps every product fp32, as the decode-step
// kernels of the split chain do):
//   * 1: each softmax weight, after the value scale, is rounded to bf16 before
//     the value product (_self_decode_body over int8 rings);
//   * 2: also q (for the exact q.K product) and each weight-value product are
//     rounded to bf16 (_cross_decode_kernel: `qm.astype(dd)`, `w_full * v`
//     in bf16).
//   The pass rounds the chunk's unnormalised weights (flash-decoding defers
//   the normalisation to the combine), the TPU kernel the normalised ones:
//   the same relative rounding of each weight, not the same bits.
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

#include <type_traits>

#include "common.cuh"

namespace olm {
namespace {

constexpr int kCaThreads = 128;
constexpr int kCaChunk = 128;
constexpr int kCaUnroll = 4;  // loads a thread issues before using them

struct DecodeAttnArgs {
  const void* q = nullptr;    // (rows, D) query rows, row stride q_stride elements
  long long q_stride = 0;
  const void* k = nullptr;    // kv row r, key t at (r * row_keys + t) * D
  const void* v = nullptr;
  const float* ks = nullptr;  // (kv rows, row_keys) per-position scales, or null
  const float* vs = nullptr;
  // (rows, row_keys) ancestry, or null. With it there is one kv row per query
  // row, and row b reads key t from kv row (b / kv_group) * kv_group +
  // anc[b * row_keys + t]; an entry outside [0, kv_group) reads the group's
  // first row, as the TPU kernel's masked pick does.
  const int* anc = nullptr;
  float* m_part = nullptr;    // (rows, H, nchunks)
  float* l_part = nullptr;
  float* acc_part = nullptr;  // (rows, H, nchunks, dh)
  int T = 0;                  // keys attended per row
  int row_keys = 0;           // keys stored per kv row (>= T)
  int D = 0, H = 0, nchunks = 0, kv_group = 1;
  float qscale = 1.f;
  int quant_q = 0;            // int8 keys only: the int8 q.K product
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

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// 16 bytes of KV elements, widened to fp32.
template <typename KV, int V>
__device__ __forceinline__ void widen(const uint4& raw, float (&out)[V]) {
  const KV* e = reinterpret_cast<const KV*>(&raw);
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = to_f(e[i]);
}

// One block of the partial pass: chunk c, head h, query row b, and g = b /
// kv_group, its kv row (without ancestry) or group (with it); kRound: see the
// head of this file.
template <typename KV, typename Q, int kRound = 0>
__device__ __forceinline__ void attn_partial_block(const DecodeAttnArgs p, int c, int h, int b,
                                                   int g) {
  constexpr int V = 16 / sizeof(KV);  // elements per 16-byte load
  constexpr bool kInt8 = std::is_same<KV, int8_t>::value;
  __shared__ float sp[kCaChunk];
  __shared__ float sacc[kCaThreads * V];  // (key group, feature) partial sums
  __shared__ float scratch[kCaThreads / 32];
  __shared__ int srow[kCaChunk];  // ancestry: each key's kv row

  const int G = p.kv_group;
  const int D = p.D, dh = D / p.H;
  const int lpk = dh / V;  // lanes per key: a power of two dividing 32 (checked)
  const int tid = threadIdx.x, sub = tid % lpk, kg = tid / lpk;
  const int groups = kCaThreads / lpk;  // keys in flight per block-wide load
  const int t0 = c * kCaChunk;
  const int n = min(kCaChunk, p.T - t0);
  const size_t col = static_cast<size_t>(h) * dh + sub * V;  // this thread's features
  const KV* k = static_cast<const KV*>(p.k);
  const KV* v = static_cast<const KV*>(p.v);
  const Q* q = static_cast<const Q*>(p.q) + static_cast<size_t>(b) * p.q_stride;

  __syncthreads();  // a previous block body of this block is done with the shared arrays
  if (p.anc) {  // the chunk's ancestry, read once by the block
    const int* anc = p.anc + static_cast<size_t>(b) * p.row_keys + t0;
    for (int j = tid; j < n; j += kCaThreads) {
      const int a = anc[j];
      srow[j] = g * G + (static_cast<unsigned>(a) < static_cast<unsigned>(G) ? a : 0);
    }
    __syncthreads();
  }
  // key t0 + j as a row of the (kv rows * row_keys, D) view
  auto key_row = [&](int j) -> size_t {
    return static_cast<size_t>(p.anc ? srow[j] : g) * p.row_keys + t0 + j;
  };

  float qv[V];
#pragma unroll
  for (int i = 0; i < V; ++i) qv[i] = to_f(q[col + i]) * p.qscale;
  // int8 q.K: the head's amax over its lpk lanes, then q rounded to int8
  // (round half to even, clipped to +-127) and packed four to a word
  const bool q8 = kInt8 && p.quant_q;
  if (kRound == 2 && !q8) {
#pragma unroll
    for (int i = 0; i < V; ++i) qv[i] = bf16_round(qv[i]);
  }
  float q8_scale = 0.f;
  int qp[(V + 3) / 4] = {};
  if (q8) {
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) amax = fmaxf(amax, fabsf(qv[i]));
    for (int o = lpk / 2; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(kFullMask, amax, o));
    q8_scale = fmaxf(amax, 1e-20f) / 127.0f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int qi = static_cast<int>(fminf(fmaxf(rintf(qv[i] / q8_scale), -127.f), 127.f));
      qp[i / 4] |= (qi & 0xff) << (8 * (i % 4));
    }
  }

  // logits: lpk lanes per key, a shuffle tree sums their partial dots
  for (int base = 0; base < n; base += groups * kCaUnroll) {
    uint4 raw[kCaUnroll];
#pragma unroll
    for (int u = 0; u < kCaUnroll; ++u) {
      const int j = base + u * groups + kg;
      raw[u] = j < n ? *reinterpret_cast<const uint4*>(k + key_row(j) * D + col)
                     : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kCaUnroll; ++u) {
      float s;
      if (q8) {
        const int* kw = reinterpret_cast<const int*>(&raw[u]);
        int acc = 0;
#pragma unroll
        for (int w = 0; w < V / 4; ++w) acc = __dp4a(kw[w], qp[w], acc);
        for (int o = lpk / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(kFullMask, acc, o);
        s = static_cast<float>(acc) * q8_scale;
      } else {
        float e[V];
        widen<KV, V>(raw[u], e);
        s = 0.f;
#pragma unroll
        for (int i = 0; i < V; ++i) s += qv[i] * e[i];
        for (int o = lpk / 2; o > 0; o >>= 1) s += __shfl_xor_sync(kFullMask, s, o);
      }
      const int j = base + u * groups + kg;
      if (j < n && sub == 0) sp[j] = p.ks ? s * p.ks[key_row(j)] : s;
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
    const float w = p.vs ? e * p.vs[key_row(j)] : e;  // the per-key value scale folds in
    sp[j] = kRound ? bf16_round(w) : w;
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
      raw[u] = in ? *reinterpret_cast<const uint4*>(v + key_row(j) * D + col)
                  : make_uint4(0, 0, 0, 0);
      w[u] = in ? sp[j] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kCaUnroll; ++u) {
      float e[V];
      widen<KV, V>(raw[u], e);
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] += kRound == 2 ? bf16_round(w[u] * e[i]) : w[u] * e[i];
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) sacc[kg * dh + sub * V + i] = acc[i];
  __syncthreads();
  const size_t part = (static_cast<size_t>(b) * p.H + h) * p.nchunks + c;
  if (tid < dh) {
    float s = 0.f;
    for (int gi = 0; gi < groups; ++gi) s += sacc[gi * dh + tid];
    p.acc_part[part * dh + tid] = s;
  }
  if (tid == 0) {
    p.m_part[part] = mx;
    p.l_part[part] = lsum;
  }
}

// grid (nchunks * kv_group, H, rows / kv_group). The coordinates are formed
// here in blockIdx's unsigned arithmetic: the same sums on int coordinates
// inside the body cost 16 registers more and 12% more time (int8, B = 64).
template <typename KV, typename Q, int kRound>
__global__ void __launch_bounds__(kCaThreads) attn_partial_kernel(const DecodeAttnArgs p) {
  const int G = p.kv_group;
  attn_partial_block<KV, Q, kRound>(p, blockIdx.x / G, blockIdx.y,
                                    blockIdx.z * G + blockIdx.x % G, blockIdx.z);
}

// Merge the chunks' partials of head h of row b, plus the row's own new key
// and value when k_new is given (rows at new_stride elements, like q). Thread
// d < dh writes feature d; any further threads of the block only take part in
// its barriers. out is (rows, D) contiguous.
template <typename Q, typename O>
__device__ __forceinline__ void attn_combine_block(const DecodeAttnArgs p,
                                                   const Q* __restrict__ k_new,
                                                   const Q* __restrict__ v_new,
                                                   long long new_stride, O* __restrict__ out,
                                                   int h, int b) {
  __shared__ float red[kCaThreads];
  const int d = threadIdx.x;
  const int dh = p.D / p.H;
  const bool live = d < dh;
  const size_t col = static_cast<size_t>(h) * dh + d;
  const size_t p0 = (static_cast<size_t>(b) * p.H + h) * p.nchunks;
  float mx = -INFINITY;
  for (int c = 0; c < p.nchunks; ++c) mx = fmaxf(mx, p.m_part[p0 + c]);
  float s_new = 0.f, v_own = 0.f;
  if (k_new) {
    const Q* q = static_cast<const Q*>(p.q) + static_cast<size_t>(b) * p.q_stride;
    const size_t r = static_cast<size_t>(b) * new_stride;
    __syncthreads();  // a previous block body of this block is done with red
    if (live) red[d] = to_f(q[col]) * p.qscale * to_f(k_new[r + col]);
    __syncthreads();
    for (int i = 0; i < dh; ++i) s_new += red[i];  // every thread, the same order
    if (live) v_own = to_f(v_new[r + col]);
    mx = fmaxf(mx, s_new);
  }
  if (!live) return;
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

// grid (H, rows), dh threads
template <typename Q, typename O>
__global__ void __launch_bounds__(kCaThreads) attn_combine_kernel(const DecodeAttnArgs p,
                                                                  const Q* __restrict__ k_new,
                                                                  const Q* __restrict__ v_new,
                                                                  long long new_stride,
                                                                  O* __restrict__ out) {
  attn_combine_block<Q, O>(p, k_new, v_new, new_stride, out, blockIdx.x, blockIdx.y);
}

// Whether the pass can take these widths: 16-byte loads along each head,
// the lanes of one key inside one warp.
template <typename KV>
__host__ __device__ constexpr bool decode_attention_fits(int D, int H) {
  return D % H == 0 && D / H >= 16 / static_cast<int>(sizeof(KV)) &&
         (D / H) % (16 / static_cast<int>(sizeof(KV))) == 0 &&
         32 % ((D / H) / (16 / static_cast<int>(sizeof(KV)))) == 0 && D / H <= kCaThreads;
}

// Launch the partial pass (when T > 0) and the combine. K/V rows must be
// 16-byte aligned; rows = kv rows * kv_group (with ancestry: rows = kv rows,
// in groups of kv_group). Q is the type of q and of k_new/v_new.
template <typename KV, int kRound = 0, typename Q, typename O>
int launch_decode_attention(const DecodeAttnArgs& p, int rows, const Q* k_new, const Q* v_new,
                            long long new_stride, O* out, cudaStream_t s) {
  const int dh = p.D / p.H;
  if (!decode_attention_fits<KV>(p.D, p.H)) return cudaErrorInvalidValue;
  if (p.kv_group <= 0 || rows % p.kv_group != 0) return cudaErrorInvalidValue;
  if (p.T > 0) {
    const dim3 grid(p.nchunks * p.kv_group, p.H, rows / p.kv_group);
    attn_partial_kernel<KV, Q, kRound><<<grid, kCaThreads, 0, s>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  attn_combine_kernel<Q, O><<<dim3(p.H, rows), dh, 0, s>>>(p, k_new, v_new, new_stride, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace olm
