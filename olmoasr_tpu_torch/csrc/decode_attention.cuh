// Single-query attention over cached keys/values: the shared cores of the
// decode-step cross attention (cross_attention.cu) and self attention
// (self_attention.cu).
//
// For query row b and head h, over the first T keys of kv row b / kv_group:
//   logit[t] = (q_h * qscale) . k[t, h] * ks[t]
//   w        = softmax_t(logit)            (fp32)
//   out_h    = sum_t w[t] * vs[t] * v[t, h]
// with per-position fp32 scales ks/vs (null: ones), and optionally one more
// key/value per row (this step's own k_new/v_new in self attention) folded
// into the softmax, its logit taken from the unrounded q.
//
// The arithmetic options, shared by both cores:
//   * int8 q.K (int8 keys under bf16 activations): q is rounded per head to
//     int8 with its own scale, amax(|q_h|) / 127, and the logit is the s32
//     dot product of the int8 vectors (__dp4a, four products an
//     instruction) times that scale, then times ks[t], as the TPU kernel's
//     _qk_logits takes it;
//   * the TPU kernels' bf16 dot dtype, as the single-pass core's template
//     argument kRound (bf16 activations; 0 keeps every product fp32, as
//     cross_block_decode's attention and the self attention over bf16 and
//     fp32 rings do, and the split-position pass always):
//       1: each softmax weight, after the value scale, is rounded to bf16
//          before the value product (_self_decode_body over int8 rings);
//       2: also q (for the exact q.K product) and each weight-value product
//          are rounded to bf16 (_cross_decode_kernel: `qm.astype(dd)`,
//          `w_full * v` in bf16).
//     The core rounds unnormalised weights (relative to a running max; the
//     normalisation comes last), the TPU kernel the normalised ones: the
//     same relative rounding of each weight, not the same bits.
//
// What bounds both: the K/V read, 2 * T * D elements per kv row; FLOPs are
// 2 per element read and query row, below the card's rate. Tensor cores are
// of no use: a kv row has 1 query row, or kv_group (5 for beams and best_of
// samples) in cross_block_decode, so an mma tile would compute most of its
// 16 rows for nothing. The work is to keep enough K/V bytes in flight over
// the whole card, to read each of them from device memory once, and to pay
// little beside them.
//
// 1. The split-position pass (row 4b, self attention with beam ancestry, and
//    the fp32 fused layer of layer_block.cu, whose phases run its blocks):
//    * one block per (T-chunk of 128 keys, head, query row) writes a
//      partial (max, sum, weighted values) triple to device memory; a second
//      launch combines them (flash-decoding style);
//    * every load is 16 bytes: a key's head slice is read by dh*sizeof/16
//      neighbouring lanes (8 for bf16 at dh = 64), so a warp covers several
//      keys per load, and each thread issues kCaUnroll loads before it uses
//      any; K first, then two block-wide reductions, then V;
//    * ancestry (beam search): with `anc` set, query row b's key and value at
//      position t come from kv row g * G + anc[b, t], g = b / G the row's
//      group of G = kv_group beams, instead of kv row b / G;
//    * the kv_group query rows that share a kv row are neighbours in the
//      grid's fastest dimension, so their blocks run together and all but
//      the first read the chunk from L2: device memory sees each kv row once.
//
// 2. The single-pass core (namespace onepass; rows 8, 4, 4a and row 1's
//    attention: replaces _cross_decode_kernel, olmoasr_tpu/ops/attention.py:39,
//    behind cross_attend_decode, :725; _self_decode_kernel /
//    _self_decode_body, :312 / :123, and _self_decode_kernel_q8, :322, behind
//    self_attend_decode, :495, over bf16, fp32 and int8 rings without
//    ancestry; the attention of _cross_block_kernel behind
//    cross_block_decode, :986). What held the split pass back there: two
//    launches a call with fp32 partials through device memory between them
//    (2.4 MB at B = 64, T = 1500), K and V never in flight together, a
//    block's fixed costs paid on 32 KB of data, and with kv_group G the G
//    query rows of a kv row each reading its keys, G times from L2 (160 rows
//    over 32 windows: about a quarter of the bound; PERF.md, section 6). The
//    design:
//    * one launch. A (query row, head) pair's keys are split into S slices;
//      the S blocks of a pair form one thread-block cluster (a launch
//      attribute, so S may change from call to call). S (1 <= S <= 16) gives
//      the grid about four blocks an SM, slices of at least kMinSliceKeys
//      keys. On an H100 80GB HBM3 at 700 W (perf/probe_decode_attention.py,
//      row 8 bf16 at T = 1500, behind a spin): at 1 row S = 16 took 0.0098
//      ms, S = 8 0.0107 and S = 1 0.0364; at 5 rows S = 8 0.0137, S = 16
//      0.0158; at 64 rows S = 1 0.1000 and S = 2 0.1175 (a second wave of
//      blocks pays their start and end latency again). So the decode step's
//      64 rows take S = 1, and the cluster serves one file and small
//      batches. Each block streams its slice; ranks other than 0 send their
//      (acc[dh], m, l) into rank 0's shared memory (st.async, distributed
//      shared memory, counted on rank 0's mbarrier), and rank 0 merges the S
//      triples in rank order, so the result does not depend on timing. Rank
//      0 then folds in the row's own key and value (self attention) and
//      writes the output. No partial leaves the cluster; S = 1 has no
//      cluster and no exchange;
//    * K and V in flight together: a block streams its slice through a ring
//      of two shared-memory stages of 8 KB of K and V (kKeys keys, 32 for
//      bf16 at dh = 64) and their scales, a stage's K, V and scales issued
//      together (cp.async.cg, 16 bytes a thread), the next stage in flight
//      while one is used. More bytes in flight a block was slower, not
//      faster: rings of 3 and 4 such stages, or two of 16 KB, took 2-4% more
//      on the same card at B = 64 (row 8 bf16 T = 1500: 0.0999 ms behind a
//      spin against 0.1017, 0.1035 and 0.1028; row 4 offset 224: 0.0199
//      against 0.0202, 0.0214 and 0.0206), and two of 4 KB 8% more (0.1077);
//    * an online softmax (running max, sum, accumulator) in each warp's
//      registers: a warp takes kKeys / kWarps keys of each stage, its lanes
//      in groups of dh*sizeof/16, each lane 16 bytes of a key; the rescale
//      uses the accurate expf. The block's warps merge in shared memory once,
//      at the end;
//    * the head of a block is one head (grid (S, H, kv rows * row groups)):
//      a key's head slice is 128 contiguous bytes (bf16, dh = 64), a whole
//      line; the same bytes with each head's keys contiguous took the same
//      time (perf/probe_decode_attention.py), so no block takes a whole key
//      row;
//    * G query rows a kv row (cross_block_decode's kv_group; group_kernel,
//      where attend_kernel takes one): a block takes up to kMaxGroup of them (a larger G splits as evenly as it goes over
//      several blocks of the same kv row). Each stage of K, V and scales is
//      staged once and used by all the block's rows: a key's bytes are read
//      from shared memory and widened once, then each row's q.K, online
//      softmax (m, l, acc in registers, G states a warp) and value product
//      run on them. The warp and cluster merges carry G triples in a fixed
//      order. S counts blocks over (kv rows x row groups x heads). What
//      bounds it is no longer the bytes but the instructions a key costs
//      five times over, so the grouped blocks do without what the one-row
//      kernel pays per row: no branch per row (a group of fewer rows
//      repeats its last and writes only its own), the rescale only where a
//      row's max moved, stages of 16 KB (twice the keys per stage's fixed
//      work), each thread's copy offsets formed once; int8 keys are read 8
//      bytes a lane, so that each row keeps 8 q features and 8 accumulators
//      a lane; and one exp a lane, for one row of its key, the weights
//      passed to the other rows' lanes by shuffle. G = 1 runs attend_kernel,
//      as rows 8, 4 and 4a do.
//
// Everything here has internal linkage: each .cu that includes it gets its
// own instantiations.
#pragma once

#include <algorithm>
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
// kv_group, its kv row (without ancestry) or group (with it).
template <typename KV, typename Q>
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
    sp[j] = w;
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
      for (int i = 0; i < V; ++i) acc[i] += w[u] * e[i];
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
template <typename KV, typename Q>
__global__ void __launch_bounds__(kCaThreads) attn_partial_kernel(const DecodeAttnArgs p) {
  const int G = p.kv_group;
  attn_partial_block<KV, Q>(p, blockIdx.x / G, blockIdx.y, blockIdx.z * G + blockIdx.x % G,
                            blockIdx.z);
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
template <typename KV, typename Q, typename O>
int launch_decode_attention(const DecodeAttnArgs& p, int rows, const Q* k_new, const Q* v_new,
                            long long new_stride, O* out, cudaStream_t s) {
  const int dh = p.D / p.H;
  if (!decode_attention_fits<KV>(p.D, p.H)) return cudaErrorInvalidValue;
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

// ---------------------------------------------------------------------------
// 2. the single-pass core
// ---------------------------------------------------------------------------

namespace onepass {

constexpr int kThreads = 128, kWarps = kThreads / 32;
constexpr int kStages = 2;       // the ring: one stage in flight while one is used
constexpr int kMaxSlices = 16;   // blocks of a cluster (above 8: a non-portable size)
constexpr int kMinSliceKeys = 64;  // keys a slice at least, where the launch picks S
constexpr int kBlocksPerSm = 4;    // the grid the launch's S aims at
// query rows a block at most, where several share a kv row: each keeps its q
// and accumulator in registers, 166-168 a thread at 5 rows (three blocks an
// SM); 8 rows took 214-238, two blocks an SM, and ran slower than the split
// pass (PERF.md, section 6, PR 13)
constexpr int kMaxGroup = 5;

struct Args {
  const void* q = nullptr;      // (rows, q_stride) query rows, in the q type
  const void* k_new = nullptr;  // this step's own key and value (rows at q_stride, q type), or null
  const void* v_new = nullptr;
  long long q_stride = 0;
  const void* k = nullptr;      // kv row r, key t at (r * row_keys + t) * D
  const void* v = nullptr;
  const float* ks = nullptr;    // (kv rows, row_keys) per-position scales, or null (ones)
  const float* vs = nullptr;
  void* out = nullptr;          // (rows, D) contiguous, in the activation type
  int T = 0, row_keys = 0, D = 0, H = 0;
  int kv_group = 1;             // query rows a kv row: query row b reads kv row b / kv_group
  float qscale = 1.f;
  // set by the launch: the keys a rank streams (rank r takes [r * slice,
  // (r + 1) * slice)), and a kv row's query rows in row_groups blocks of at
  // most group_rows
  int slice = 0, row_groups = 1, group_rows = 1;
};

// The bytes of a key a lane reads from a stage at once: 16, or 8 of int8 keys
// where a block takes several rows.
template <int LB>
struct alignas(LB) Lane {
  uint32_t w[LB / 4];
};

// A lane's CF KV elements as fp32; int8 by byte permutation (int8_lane), not
// the quarter-rate conversion.
template <typename KV, int CF, int LB>
__device__ __forceinline__ void widen_lane(const Lane<LB>& raw, float (&out)[CF]) {
  static_assert(CF * sizeof(KV) == LB, "a lane's elements fill its bytes");
  if constexpr (std::is_same<KV, int8_t>::value) {
#pragma unroll
    for (int i = 0; i < CF; ++i) out[i] = int8_lane(raw.w[i / 4], i % 4);
  } else {
    const KV* e = reinterpret_cast<const KV*>(raw.w);
#pragma unroll
    for (int i = 0; i < CF; ++i) out[i] = to_f(e[i]);
  }
}

// 16 bytes of KV elements as fp32.
template <typename KV, int V>
__device__ __forceinline__ void widen_kv(const uint4& raw, float (&out)[V]) {
  widen_lane<KV, V, 16>(reinterpret_cast<const Lane<16>&>(raw), out);
}

// Whether the core takes head width dh: a key's head slice in whole 16-byte
// lanes of one warp (int8 needs dh >= 16).
template <typename KV>
constexpr bool head_fits(int dh) {
  constexpr int fpl = 16 / static_cast<int>(sizeof(KV));
  return dh % fpl == 0 && 32 % (dh / fpl) == 0 && dh <= kThreads;
}

// The shared memory of a block taking NQ query rows: the ring (each stage
// kKeys keys of K, of V, then their kKeys key and kKeys value scales), the
// warps' (acc, m, l) triples of each row, rank 0's mbarrier and the own
// key's logit (one row), then where S > 1 the cluster's triples at rank 0
// (slot r: rank r's NQ rows). A lane computes on CF features of a key: its
// 16-byte chunk, but 8 bytes of int8 keys where a block takes several rows,
// so that each row's q and accumulator stay 8 registers a lane.
template <typename KV, int DH, int NQ>
struct Cfg {
  static constexpr bool kInt8 = std::is_same<KV, int8_t>::value;
  static constexpr int FPL = 16 / static_cast<int>(sizeof(KV));  // features a 16-byte chunk
  static constexpr int CF = NQ > 1 && kInt8 ? 8 : FPL;            // features a lane
  static constexpr int LB = CF * static_cast<int>(sizeof(KV));     // bytes a lane reads of a key
  static constexpr int LPK = DH / CF;                              // lanes a key
  static constexpr int KPI = 32 / LPK;                             // keys a warp reads at once
  static constexpr int KB = DH * static_cast<int>(sizeof(KV));     // bytes of a key's head slice
  // keys a stage, kKeys / kWarps a warp: 8 KB of K and V, 16 KB where a
  // block takes several rows (its per-stage work spread over twice the keys)
  static constexpr int kKeys = (NQ > 1 ? 8192 : 4096) / KB;
  static constexpr int R = kKeys / kWarps / KPI;                   // reads a warp makes a stage
  static constexpr int kStage = 2 * kKeys * KB + 2 * kKeys * 4;
  static constexpr int kSlot = DH + 4;  // floats of a triple: acc[DH], m, l, two unused
  static constexpr size_t kWarp = size_t(kStages) * kStage;
  static constexpr size_t kMbar = kWarp + size_t(kWarps) * NQ * kSlot * 4;
  static constexpr size_t kRecv = kMbar + 16;
  static constexpr size_t bytes(int S) {
    return kRecv + (S > 1 ? size_t(S) * NQ * kSlot * 4 : 0);
  }
  static_assert(head_fits<KV>(DH) && DH % CF == 0 && 32 % LPK == 0 && R >= 1 &&
                    R * KPI * kWarps == kKeys,
                "a key's head slice in whole lanes of one warp, whole keys a read");
  static_assert(kStage % 16 == 0 && kSlot % 4 == 0, "16-byte aligned stages and slots");
};

// One query row a kv row: grid (S, H, rows), clusters of S along x where
// S > 1. Q is the type of q, k_new and v_new, A the activations' (the
// output's): the int8 q.K product is taken for int8 keys under bf16
// activations.
template <typename KV, typename Q, typename A, int DH, int kRound>
__global__ void __launch_bounds__(kThreads) attend_kernel(const Args p) {
  using Cf = Cfg<KV, DH, 1>;
  constexpr int FPL = Cf::FPL, LPK = Cf::LPK, KPI = Cf::KPI, R = Cf::R, KB = Cf::KB;
  constexpr int kSlot = Cf::kSlot, kKeys = Cf::kKeys;
  constexpr bool kQ8 = Cf::kInt8 && std::is_same<A, __nv_bfloat16>::value;
  extern __shared__ __align__(16) char smem[];
  const int S = gridDim.x, rank = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, kq = lane / LPK, sub = lane % LPK;
  float* wacc = reinterpret_cast<float*>(smem + Cf::kWarp);
  float* recv = reinterpret_cast<float*>(smem + Cf::kRecv);
  const uint32_t mbar = smem_u32(smem + Cf::kMbar);
  float* s_own = reinterpret_cast<float*>(smem + Cf::kMbar + 8);
  if (S > 1) {
    if (rank == 0 && threadIdx.x == 0) {  // rank 0 expects S - 1 triples
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(mbar) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      expect_bytes(mbar, (S - 1) * kSlot * 4);
    }
    // every block of the cluster has started, rank 0's mbarrier ready,
    // before any send: arrive now, wait before the sends
    asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  }

  // the slice's keys, and its first stages: K, V and the scales together
  const int t0 = rank * p.slice, n = max(0, min(p.slice, p.T - t0));
  const int nst = (n + kKeys - 1) / kKeys;
  const size_t row0 = static_cast<size_t>(b) * p.row_keys + t0;  // the slice's first key
  const size_t key_bytes = static_cast<size_t>(p.D) * sizeof(KV);
  const size_t head0 = row0 * key_bytes + static_cast<size_t>(h) * KB;
  const char* kb = static_cast<const char*>(p.k) + head0;
  const char* vb = static_cast<const char*>(p.v) + head0;
  auto issue = [&](int s) {
    if (s < nst) {
      char* st = smem + (s % kStages) * Cf::kStage;
      constexpr int CPK = KB / 16;
      for (int i = threadIdx.x; i < kKeys * CPK; i += kThreads) {
        const int key = i / CPK, ch = i % CPK, j = s * kKeys + key;
        const bool ok = j < n;
        const size_t off = static_cast<size_t>(ok ? j : 0) * key_bytes + ch * 16;
        cp_async16(st + key * KB + ch * 16, kb + off, ok);
        cp_async16(st + (kKeys + key) * KB + ch * 16, vb + off, ok);
      }
      for (int i = threadIdx.x; i < 2 * kKeys; i += kThreads) {
        const float* sc = i < kKeys ? p.ks : p.vs;
        const int j = s * kKeys + i % kKeys;
        if (sc)
          cp_async4(reinterpret_cast<float*>(st + 2 * kKeys * KB) + i, sc + row0 + (j < n ? j : 0),
                    j < n);
      }
    }
    cp_commit();
  };
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  // q: this lane's FPL features of head h, scaled; rounded to bf16 for the
  // exact product under kRound 2, or to int8 per head for the int8 one
  const Q* q = static_cast<const Q*>(p.q) + static_cast<size_t>(b) * p.q_stride + h * DH;
  constexpr int QV = 16 / static_cast<int>(sizeof(Q));  // q's elements a 16-byte load
  static_assert(FPL % QV == 0, "a lane's q features in whole 16-byte loads");
  float qv[FPL];
#pragma unroll
  for (int u = 0; u < FPL / QV; ++u) {
    float e[QV];
    widen<Q, QV>(reinterpret_cast<const uint4*>(q + sub * FPL)[u], e);
#pragma unroll
    for (int i = 0; i < QV; ++i) qv[u * QV + i] = e[i] * p.qscale;
  }
  if constexpr (kRound == 2 && !kQ8) {
#pragma unroll
    for (int i = 0; i < FPL; ++i) qv[i] = bf16_round(qv[i]);
  }
  float q8_scale = 0.f;
  int qp[(FPL + 3) / 4] = {};
  if constexpr (kQ8) {
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < FPL; ++i) amax = fmaxf(amax, fabsf(qv[i]));
#pragma unroll
    for (int o = LPK / 2; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(kFullMask, amax, o));
    q8_scale = fmaxf(amax, 1e-20f) / 127.0f;
#pragma unroll
    for (int i = 0; i < FPL; ++i) {
      const int qi = static_cast<int>(fminf(fmaxf(rintf(qv[i] / q8_scale), -127.f), 127.f));
      qp[i / 4] |= (qi & 0xff) << (8 * (i % 4));
    }
  }
  // this step's own key and value (rank 0): the logit from the unrounded q
  const bool own = p.k_new != nullptr && rank == 0;
  float v_own = 0.f;
  if (own) {
    const size_t row = static_cast<size_t>(b) * p.q_stride + h * DH;
    if (warp == 0) {
      const Q* kn = static_cast<const Q*>(p.k_new) + row;
      float s = 0.f;
      for (int f = lane; f < DH; f += 32) s += to_f(q[f]) * p.qscale * to_f(kn[f]);
      s = warp_sum(s);
      if (lane == 0) *s_own = s;
    }
    if (threadIdx.x < DH) v_own = to_f(static_cast<const Q*>(p.v_new)[row + threadIdx.x]);
  }

  // the stream: each warp's online softmax over its keys of every stage
  float m = -INFINITY, l = 0.f, acc[FPL] = {};
  for (int s = 0; s < nst; ++s) {
    cp_wait<kStages - 2>();
    __syncthreads();  // stage s is in for every thread; stage s - 1 is free again
    issue(s + kStages - 1);
    const char* sk = smem + (s % kStages) * Cf::kStage;
    const char* sv = sk + kKeys * KB;
    const float* sks = reinterpret_cast<const float*>(sk + 2 * kKeys * KB);
    float sc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int key = warp * (kKeys / kWarps) + r * KPI + kq;
      const uint4 raw = *reinterpret_cast<const uint4*>(sk + key * KB + sub * 16);
      float dot;
      if constexpr (kQ8) {
        const int* kw = reinterpret_cast<const int*>(&raw);
        int d = 0;
#pragma unroll
        for (int w = 0; w < FPL / 4; ++w) d = __dp4a(kw[w], qp[w], d);
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1) d += __shfl_xor_sync(kFullMask, d, o);
        dot = static_cast<float>(d) * q8_scale;
      } else {
        float e[FPL];
        widen_kv<KV, FPL>(raw, e);
        dot = 0.f;
#pragma unroll
        for (int i = 0; i < FPL; ++i) dot += qv[i] * e[i];
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(kFullMask, dot, o);
      }
      if (p.ks) dot *= sks[key];
      sc[r] = s * kKeys + key < n ? dot : -INFINITY;
    }
    float mx = sc[0];
#pragma unroll
    for (int r = 1; r < R; ++r) mx = fmaxf(mx, sc[r]);
#pragma unroll
    for (int o = LPK; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, o));
    const float m_new = fmaxf(m, mx);
    if (m_new == -INFINITY) continue;  // warp-uniform: no key of this warp yet
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < FPL; ++i) acc[i] *= alpha;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int key = warp * (kKeys / kWarps) + r * KPI + kq;
      const float e = expf(sc[r] - m_new);  // 0 past the slice
      l += e;
      float w = p.vs ? e * sks[kKeys + key] : e;  // the per-key value scale folds in
      if constexpr (kRound != 0) w = bf16_round(w);
      float ve[FPL];
      widen_kv<KV, FPL>(*reinterpret_cast<const uint4*>(sv + key * KB + sub * 16), ve);
      if constexpr (kRound == 2) {  // each product rounded to bf16, two to an instruction
#pragma unroll
        for (int i = 0; i < FPL; i += 2) {
          const float2 r = __bfloat1622float2(__floats2bfloat162_rn(w * ve[i], w * ve[i + 1]));
          acc[i] += r.x;
          acc[i + 1] += r.y;
        }
      } else {
#pragma unroll
        for (int i = 0; i < FPL; ++i) acc[i] += w * ve[i];
      }
    }
    m = m_new;
  }

  // the warp's key groups, then the block's warps: the output where S = 1,
  // else the block's triple into slot `rank`
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1) {
    l += __shfl_xor_sync(kFullMask, l, o);
#pragma unroll
    for (int i = 0; i < FPL; ++i) acc[i] += __shfl_xor_sync(kFullMask, acc[i], o);
  }
  if (lane < LPK) {
#pragma unroll
    for (int i = 0; i < FPL; ++i) wacc[warp * kSlot + sub * FPL + i] = acc[i];
  }
  if (lane == 0) wacc[warp * kSlot + DH] = m, wacc[warp * kSlot + DH + 1] = l;
  __syncthreads();
  float* mine = recv + rank * kSlot;
  if (threadIdx.x < DH) {
    const int d = threadIdx.x;
    float M = own && S == 1 ? *s_own : -INFINITY;  // one slice: the own key joins here
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wacc[w * kSlot + DH]);
    float a = 0.f, L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = wacc[w * kSlot + DH];
      const float e = mw == -INFINITY ? 0.f : expf(mw - M);
      L += wacc[w * kSlot + DH + 1] * e;
      a += wacc[w * kSlot + d] * e;
    }
    if (S == 1) {  // no cluster: the output at once
      if (own) {
        const float e = expf(*s_own - M);
        L += e;
        a += e * v_own;
      }
      static_cast<A*>(p.out)[static_cast<size_t>(b) * p.D + h * DH + d] = from_f<A>(a / L);
      return;
    }
    mine[d] = a;
    if (d == 0) mine[DH] = M, mine[DH + 1] = L;
  }
  if (S == 1) return;
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // the start barrier
  if (rank > 0) {  // the triple into slot `rank` of rank 0
    if (threadIdx.x < kSlot / 4) {
      const uint32_t at = smem_u32(mine + 4 * threadIdx.x);
      st_async(mapa(at, 0), reinterpret_cast<const float4*>(mine)[threadIdx.x], mapa(mbar, 0));
    }
    return;
  }
  wait_phase(mbar, 0);

  // rank 0 of a cluster: the S triples in rank order, then the own key and
  // value
  if (threadIdx.x < DH) {
    const int d = threadIdx.x;
    float M = own ? *s_own : -INFINITY;
    for (int r = 0; r < S; ++r) M = fmaxf(M, recv[r * kSlot + DH]);
    float a = 0.f, L = 0.f;
    for (int r = 0; r < S; ++r) {
      const float mr = recv[r * kSlot + DH];
      const float e = mr == -INFINITY ? 0.f : expf(mr - M);
      L += recv[r * kSlot + DH + 1] * e;
      a += recv[r * kSlot + d] * e;
    }
    if (own) {
      const float e = expf(*s_own - M);
      L += e;
      a += e * v_own;
    }
    static_cast<A*>(p.out)[static_cast<size_t>(b) * p.D + h * DH + d] = from_f<A>(a / L);
  }
}


// G query rows a kv row (cross_block_decode's kv_group): grid (S, H, kv rows
// * row groups), clusters of S along x where S > 1; a block takes kv row b
// and nq <= NQ of its query rows (a group of fewer than NQ repeats its last
// row: every row is computed without a branch, only nq written). Q is q's
// type, A the activations' (the output's): the int8 q.K product is taken
// for int8 keys under bf16 activations; every product is fp32 (kRound 0).
template <typename KV, typename Q, typename A, int DH, int NQ>
__global__ void __launch_bounds__(kThreads) group_kernel(const Args p) {
  static_assert(NQ > 1, "one row a kv row: attend_kernel");
  using Cf = Cfg<KV, DH, NQ>;
  constexpr int CF = Cf::CF, LB = Cf::LB, LPK = Cf::LPK, KPI = Cf::KPI, R = Cf::R, KB = Cf::KB;
  constexpr int kSlot = Cf::kSlot, kKeys = Cf::kKeys;
  constexpr bool kQ8 = Cf::kInt8 && std::is_same<A, __nv_bfloat16>::value;
  constexpr int kOut = (NQ * DH + kThreads - 1) / kThreads;  // (row, feature) outputs a thread
  // a key's lanes at least as many as the rows: lane `sub` takes the weight
  // of row min(sub, NQ - 1) for its key, one exp a lane instead of one a
  // row, and every lane fetches each row's from its key's lanes
  constexpr bool kSpread = LPK >= NQ;
  extern __shared__ __align__(16) char smem[];
  const int S = gridDim.x, rank = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / p.row_groups;  // the kv row; the query rows [b0, b0 + nq)
  const int first = (blockIdx.z % p.row_groups) * p.group_rows;
  const int b0 = b * p.kv_group + first, nq = min(p.group_rows, p.kv_group - first);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, kq = lane / LPK, sub = lane % LPK;
  float* wacc = reinterpret_cast<float*>(smem + Cf::kWarp);
  float* recv = reinterpret_cast<float*>(smem + Cf::kRecv);
  const uint32_t mbar = smem_u32(smem + Cf::kMbar);
  if (S > 1) {
    if (rank == 0 && threadIdx.x == 0) {  // rank 0 expects S - 1 blocks of nq triples
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(mbar) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      expect_bytes(mbar, (S - 1) * nq * kSlot * 4);
    }
    // every block of the cluster has started, rank 0's mbarrier ready,
    // before any send: arrive now, wait before the sends
    asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  }

  // the slice's keys, and its first stages: K, V and the scales together. A
  // thread's 16-byte chunks of a stage are the same chunk of keys
  // kThreads / CPK apart in every stage: their offsets are formed once
  const int t0 = rank * p.slice, n = max(0, min(p.slice, p.T - t0));
  const int nst = (n + kKeys - 1) / kKeys;
  const size_t row0 = static_cast<size_t>(b) * p.row_keys + t0;  // the slice's first key
  const size_t key_bytes = static_cast<size_t>(p.D) * sizeof(KV);
  const size_t head0 = row0 * key_bytes + static_cast<size_t>(h) * KB;
  const char* kb = static_cast<const char*>(p.k) + head0;
  const char* vb = static_cast<const char*>(p.v) + head0;
  constexpr int CPK = KB / 16;
  static_assert(kKeys * CPK % kThreads == 0, "whole chunks a thread");
  const int key0 = threadIdx.x / CPK;
  const size_t goff0 = static_cast<size_t>(key0) * key_bytes + threadIdx.x % CPK * 16;
  const size_t gstep = static_cast<size_t>(kThreads / CPK) * key_bytes;
  auto issue = [&](int s) {
    if (s < nst) {
      char* st = smem + (s % kStages) * Cf::kStage;
      const size_t sbase = static_cast<size_t>(s) * kKeys * key_bytes + goff0;
#pragma unroll
      for (int c = 0; c < kKeys * CPK / kThreads; ++c) {
        const bool ok = s * kKeys + key0 + c * (kThreads / CPK) < n;
        const size_t off = ok ? sbase + c * gstep : 0;
        char* dst = st + threadIdx.x * 16 + c * kThreads * 16;
        cp_async16(dst, kb + off, ok);
        cp_async16(dst + kKeys * KB, vb + off, ok);
      }
      for (int i = threadIdx.x; i < 2 * kKeys; i += kThreads) {
        const float* sc = i < kKeys ? p.ks : p.vs;
        const int j = s * kKeys + i % kKeys;
        if (sc)
          cp_async4(reinterpret_cast<float*>(st + 2 * kKeys * KB) + i, sc + row0 + (j < n ? j : 0),
                    j < n);
      }
    }
    cp_commit();
  };
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  // each row's q: this lane's CF features of head h, scaled; rounded to int8
  // per head and row for the int8 product
  const Q* q = static_cast<const Q*>(p.q) + static_cast<size_t>(b0) * p.q_stride + h * DH;
  constexpr int QV = 16 / static_cast<int>(sizeof(Q));  // q's elements a 16-byte load
  static_assert(CF % QV == 0, "a lane's q features in whole 16-byte loads");
  float qv[NQ][CF];
  float q8_scale[NQ];
  int qp[NQ][(CF + 3) / 4];
#pragma unroll
  for (int r = 0; r < NQ; ++r) {
    const Q* qr = q + min(r, nq - 1) * p.q_stride + sub * CF;
#pragma unroll
    for (int u = 0; u < CF / QV; ++u) {
      float e[QV];
      widen<Q, QV>(reinterpret_cast<const uint4*>(qr)[u], e);
#pragma unroll
      for (int i = 0; i < QV; ++i) qv[r][u * QV + i] = e[i] * p.qscale;
    }
    q8_scale[r] = 0.f;
#pragma unroll
    for (int w = 0; w < (CF + 3) / 4; ++w) qp[r][w] = 0;
    if constexpr (kQ8) {
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < CF; ++i) amax = fmaxf(amax, fabsf(qv[r][i]));
#pragma unroll
      for (int o = LPK / 2; o > 0; o >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(kFullMask, amax, o));
      q8_scale[r] = fmaxf(amax, 1e-20f) / 127.0f;
#pragma unroll
      for (int i = 0; i < CF; ++i) {
        const int qi = static_cast<int>(fminf(fmaxf(rintf(qv[r][i] / q8_scale[r]), -127.f), 127.f));
        qp[r][i / 4] |= (qi & 0xff) << (8 * (i % 4));
      }
    }
  }

  // the stream: each warp's online softmax of each row over its keys of
  // every stage; a key's bytes read and widened once for all the rows
  float m[NQ], l[NQ], acc[NQ][CF];
#pragma unroll
  for (int r = 0; r < NQ; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < CF; ++i) acc[r][i] = 0.f;
  }
  const int my_row = min(sub, NQ - 1);
  float l_own = 0.f;  // kSpread: the sum of row my_row's weights of this lane's keys
  const int wkey = warp * (kKeys / kWarps) + kq;  // this lane's first key of a stage
  for (int s = 0; s < nst; ++s) {
    cp_wait<kStages - 2>();
    __syncthreads();  // stage s is in for every thread; stage s - 1 is free again
    issue(s + kStages - 1);
    const char* sk = smem + (s % kStages) * Cf::kStage;
    const char* sv = sk + kKeys * KB;
    const float* sks = reinterpret_cast<const float*>(sk + 2 * kKeys * KB);
    float sc[NQ][R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int key = wkey + k * KPI;
      const Lane<LB> raw = *reinterpret_cast<const Lane<LB>*>(sk + key * KB + sub * LB);
      float e[CF];
      if constexpr (!kQ8) widen_lane<KV, CF, LB>(raw, e);
      // the key's scale and the slice's end, in one instruction a row
      const float ksc = p.ks ? sks[key] : 1.f;
      const float kmask = s * kKeys + key < n ? 0.f : -INFINITY;
#pragma unroll
      for (int r = 0; r < NQ; ++r) {
        float dot;
        if constexpr (kQ8) {
          int d = 0;
#pragma unroll
          for (int w = 0; w < CF / 4; ++w) d = __dp4a(static_cast<int>(raw.w[w]), qp[r][w], d);
#pragma unroll
          for (int o = LPK / 2; o > 0; o >>= 1) d += __shfl_xor_sync(kFullMask, d, o);
          dot = static_cast<float>(d) * q8_scale[r];
        } else {
          dot = 0.f;
#pragma unroll
          for (int i = 0; i < CF; ++i) dot += qv[r][i] * e[i];
#pragma unroll
          for (int o = LPK / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(kFullMask, dot, o);
        }
        sc[r][k] = fmaf(dot, ksc, kmask);
      }
    }
    float mu[NQ];  // each row's running max, the weights' reference
#pragma unroll
    for (int r = 0; r < NQ; ++r) {
      float mx = sc[r][0];
#pragma unroll
      for (int k = 1; k < R; ++k) mx = fmaxf(mx, sc[r][k]);
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, o));
      const float m_new = fmaxf(m[r], mx);
      // no key of this warp yet: every weight below is 0, the state stays empty
      const float m_ref = m_new == -INFINITY ? 0.f : m_new;
      if (m_new != m[r]) {  // the rescale only where the max moved (warp-uniform)
        const float alpha = expf(m[r] - m_ref);
        l[r] *= alpha;
        if (kSpread && my_row == r) l_own *= alpha;
#pragma unroll
        for (int i = 0; i < CF; ++i) acc[r][i] *= alpha;
      }
      mu[r] = m_ref;
      m[r] = m_new;
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int key = wkey + k * KPI;
      float ve[CF];
      widen_lane<KV, CF, LB>(*reinterpret_cast<const Lane<LB>*>(sv + key * KB + sub * LB), ve);
      const float vsc = p.vs ? sks[kKeys + key] : 1.f;  // the per-key value scale folds in
      float w_mine = 0.f;
      if constexpr (kSpread) {
        float s_mine = sc[NQ - 1][k], m_mine = mu[NQ - 1];
#pragma unroll
        for (int r = 0; r < NQ - 1; ++r) {
          if (my_row == r) s_mine = sc[r][k], m_mine = mu[r];
        }
        const float e = expf(s_mine - m_mine);  // 0 past the slice
        l_own += e;
        w_mine = e * vsc;
      }
#pragma unroll
      for (int r = 0; r < NQ; ++r) {
        float w;
        if constexpr (kSpread) {
          w = __shfl_sync(kFullMask, w_mine, kq * LPK + r);
        } else {
          const float e = expf(sc[r][k] - mu[r]);  // 0 past the slice
          l[r] += e;
          w = e * vsc;
        }
#pragma unroll
        for (int i = 0; i < CF; ++i) acc[r][i] += w * ve[i];
      }
    }
  }

  // each row: the warp's key groups, then the block's warps; the output
  // where S = 1, else the block's triples into its slots
  if constexpr (kSpread) {  // row r's sum: lane r's, over the key groups
#pragma unroll
    for (int o = LPK; o < 32; o <<= 1) l_own += __shfl_xor_sync(kFullMask, l_own, o);
#pragma unroll
    for (int r = 0; r < NQ; ++r) l[r] = __shfl_sync(kFullMask, l_own, r);
  }
#pragma unroll
  for (int r = 0; r < NQ; ++r) {
    if (r >= nq) continue;
#pragma unroll
    for (int o = LPK; o < 32; o <<= 1) {
      if constexpr (!kSpread) l[r] += __shfl_xor_sync(kFullMask, l[r], o);
#pragma unroll
      for (int i = 0; i < CF; ++i) acc[r][i] += __shfl_xor_sync(kFullMask, acc[r][i], o);
    }
    float* slot = wacc + (warp * NQ + r) * kSlot;
    if (lane < LPK) {
#pragma unroll
      for (int i = 0; i < CF; ++i) slot[sub * CF + i] = acc[r][i];
    }
    if (lane == 0) slot[DH] = m[r], slot[DH + 1] = l[r];
  }
  __syncthreads();
  A* out = static_cast<A*>(p.out) + static_cast<size_t>(b0) * p.D + h * DH;
  float* mine = recv + rank * NQ * kSlot;
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    const int i = threadIdx.x + k * kThreads, r = i / DH, d = i % DH;
    if (i >= nq * DH) continue;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wacc[(w * NQ + r) * kSlot + DH]);
    float a = 0.f, L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* slot = wacc + (w * NQ + r) * kSlot;
      const float e = slot[DH] == -INFINITY ? 0.f : expf(slot[DH] - M);
      L += slot[DH + 1] * e;
      a += slot[d] * e;
    }
    if (S == 1) {  // no cluster: the output at once
      out[static_cast<size_t>(r) * p.D + d] = from_f<A>(a / L);
    } else {
      mine[r * kSlot + d] = a;
      if (d == 0) mine[r * kSlot + DH] = M, mine[r * kSlot + DH + 1] = L;
    }
  }
  if (S == 1) return;
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // the start barrier
  if (rank > 0) {  // the nq triples into rank 0's slot `rank`, 16 bytes a thread
    for (int i = threadIdx.x; i < nq * kSlot / 4; i += kThreads) {
      const uint32_t at = smem_u32(mine + 4 * i);
      st_async(mapa(at, 0), reinterpret_cast<const float4*>(mine)[i], mapa(mbar, 0));
    }
    return;
  }
  wait_phase(mbar, 0);

  // rank 0 of a cluster: each row's S triples in rank order
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    const int i = threadIdx.x + k * kThreads, r = i / DH, d = i % DH;
    if (i >= nq * DH) continue;
    float M = -INFINITY;
    for (int rr = 0; rr < S; ++rr) M = fmaxf(M, recv[(rr * NQ + r) * kSlot + DH]);
    float a = 0.f, L = 0.f;
    for (int rr = 0; rr < S; ++rr) {
      const float* slot = recv + (rr * NQ + r) * kSlot;
      const float e = slot[DH] == -INFINITY ? 0.f : expf(slot[DH] - M);
      L += slot[DH + 1] * e;
      a += slot[d] * e;
    }
    out[static_cast<size_t>(r) * p.D + d] = from_f<A>(a / L);
  }
}

// The kernel of NQ rows a block: one row, attend_kernel; several,
// group_kernel (every product fp32).
template <typename KV, typename Q, typename A, int DH, int kRound, int NQ>
auto kernel_of() {
  if constexpr (NQ == 1) {
    return &attend_kernel<KV, Q, A, DH, kRound>;
  } else {
    static_assert(kRound == 0, "several rows a block: every product fp32");
    return &group_kernel<KV, Q, A, DH, NQ>;
  }
}

template <typename KV, typename Q, typename A, int DH, int kRound, int NQ>
int launch_dh(Args a, int rows, int slices, cudaStream_t stream) {
  if constexpr (!head_fits<KV>(DH)) {
    return cudaErrorInvalidValue;
  } else {
    using Cf = Cfg<KV, DH, NQ>;
    const auto kernel = kernel_of<KV, Q, A, DH, kRound, NQ>();
    // raised once per process (not stream operations, so a CUDA graph
    // capture of a later call never sees them): the dynamic shared-memory
    // limit and clusters above the portable 8 blocks
    static const cudaError_t configured = [] {
      const auto k = kernel_of<KV, Q, A, DH, kRound, NQ>();
      cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(Cf::bytes(kMaxSlices)));
      if (e == cudaSuccess && kMaxSlices > 8)
        e = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      return e;
    }();
    if (configured != cudaSuccess) return static_cast<int>(configured);
    static int sms = 0;
    if (sms == 0) {
      int dev = 0;
      cudaError_t e = cudaGetDevice(&dev);
      if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    // a kv row's query rows in as few blocks of at most NQ as hold them, as
    // even as can be
    a.row_groups = (a.kv_group + NQ - 1) / NQ;
    a.group_rows = (a.kv_group + a.row_groups - 1) / a.row_groups;
    const int blocks = rows / a.kv_group * a.row_groups;  // (kv row, row group) pairs
    // S: as many slices as give the grid about kBlocksPerSm blocks an SM,
    // slices of at least kMinSliceKeys keys, no rank without a key
    int S = slices > 0 ? slices : kBlocksPerSm * sms / (blocks * a.H);
    S = std::min(S, (a.T + kMinSliceKeys - 1) / kMinSliceKeys);
    S = S < 1 ? 1 : S > kMaxSlices ? kMaxSlices : S;
    a.slice = (a.T + S - 1) / S;
    if (a.slice > 0) S = (a.T + a.slice - 1) / a.slice;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(S, a.H, blocks);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = Cf::bytes(S);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = S, attr[0].val.clusterDim.y = 1, attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = S > 1 ? 1 : 0;
    return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, a));
  }
}

template <typename KV, typename Q, typename A, int kRound, int NQ>
int launch_rows(const Args& a, int rows, int slices, cudaStream_t stream) {
  switch (a.D / a.H) {
    case 8: return launch_dh<KV, Q, A, 8, kRound, NQ>(a, rows, slices, stream);
    case 16: return launch_dh<KV, Q, A, 16, kRound, NQ>(a, rows, slices, stream);
    case 32: return launch_dh<KV, Q, A, 32, kRound, NQ>(a, rows, slices, stream);
    case 64: return launch_dh<KV, Q, A, 64, kRound, NQ>(a, rows, slices, stream);
    case 128: return launch_dh<KV, Q, A, 128, kRound, NQ>(a, rows, slices, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Launch the single-pass core over `rows` query rows, a.kv_group of them a
// kv row (above 1 only where kGrouped, and without k_new: the G rows of a kv
// row in blocks of up to kMaxGroup, each stage of K and V read once for
// them; kGrouped also instantiates those blocks); a head width of
// 8-128 dividing 128 (int8 keys: 16-128); `slices` the ranks of a cluster
// (1..kMaxSlices), or 0 for the launch's choice. K/V rows must be 16-byte
// aligned. Q is the type of q, k_new and v_new, A that of the activations
// and the output.
template <typename KV, typename Q, typename A, int kRound, bool kGrouped = false>
int launch(const Args& a, int rows, int slices, cudaStream_t stream) {
  if (rows <= 0 || a.H <= 0 || a.D % a.H != 0 || a.T < 0 || a.row_keys < a.T ||
      slices < 0 || slices > kMaxSlices || a.kv_group < 1 || rows % a.kv_group != 0 ||
      (a.kv_group != 1 && (!kGrouped || a.k_new)))
    return cudaErrorInvalidValue;
  if constexpr (kGrouped) {
    if (a.kv_group > 1) return launch_rows<KV, Q, A, kRound, kMaxGroup>(a, rows, slices, stream);
  }
  return launch_rows<KV, Q, A, kRound, 1>(a, rows, slices, stream);
}

}  // namespace onepass

}  // namespace
}  // namespace olm
