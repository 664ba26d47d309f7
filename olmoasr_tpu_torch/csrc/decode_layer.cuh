// Device core of the bf16 decode layer (decode_layer.cu): the projection
// phase and the single-query attention phase that its cooperative launches
// run, one grid-wide barrier between two phases. The launch is in clusters
// of kCS = 4 blocks, one block an SM.
//
// Projection: out = store(A @ W^T) for every row of an M group (up to 64
// rows, 16-row mma tiles) and a cluster's BN-column tiles. The cluster's 4
// blocks each take a quarter of K (split-K inside the cluster): each holds
// its K slice of A in shared memory and streams its slice of W through a
// cp.async ring of 64-column stages (192 for the MLP's second product), the
// first stages issued before the barrier that publishes A, since W does not
// depend on it. mma.sync m16n8k16, bf16 operands, fp32 accumulation,
// operands through ldmatrix from padded shared rows (an odd number of
// 16-byte chunks a row, so the 8 rows an ldmatrix reads fall in 8 bank
// groups). Rank q of the cluster stores rows 16q.. of the tile: the other
// ranks store their partial sums of those rows into its shared memory
// (distributed shared memory), and it adds them in rank order after one
// cluster barrier, so the sum does not depend on timing. No partial sum
// goes through device memory and no phase sums partials.
// A is the LayerNorm of fp32 or bf16 residual rows (the prologue: each block
// sums its slice of every row, the 4 ranks exchange the sums through
// distributed shared memory, the mean, then the squares about it, two
// cluster barriers) or a copy of bf16 rows.
//
// Attention: one block per (row, head). The block walks every key of its row
// in stages of 256 keys (K, V and, for the int8 cache, their scales) through
// a cp.async ring of 2-3 stages; each warp takes 32 keys of a stage, 8 to a
// group of 8 lanes (a lane holds dh / 8 features), and keeps its own online
// max, sum and accumulator in registers; the block merges its 8 warps in
// shared memory at the end of the item and writes the head's output, so no
// partials leave the block. The q.K product is fp32 over bf16 rings and the
// int8 one over the int8 cross cache (q rounded per head to int8 at
// amax / 127, __dp4a, times that scale, then the key scale:
// decode_attention.cuh's int8 path); int8 values become floats by byte
// permutation, not the quarter-rate conversion. A stage's keys do not depend
// on the phase before, so a block issues its first stages before the barrier
// that publishes q, and loads the next item's q while it runs this one.
//
// Data written inside the launch is read with ld.global.cg / cp.async.cg
// (L2, not the SM's L1, which other SMs' writes do not reach).
#pragma once

#include <cuda_bf16.h>

#include <cooperative_groups.h>

#include <type_traits>

#include "attention_mma.cuh"
#include "common.cuh"

namespace olm {
namespace dl {
namespace {

using bf = __nv_bfloat16;
using mma::ldsm_x4;
using mma::mma16816;

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kCS = 4;         // blocks in a cluster: the K splits of a projection
constexpr int kKC = 64;        // K columns per projection stage
constexpr int kMG = 64;        // rows per M group
constexpr int kKeys = 256;     // keys per attention stage: 32 a warp, 8 a lane group
constexpr int kSmemMax = 232448;

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// The global timer (ns) into tr[i], by thread 0, where tr is given.
__device__ __forceinline__ void sub_mark(unsigned long long* tr, int i) {
  if (tr && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    tr[i] = t;
  }
}

// ---------------------------------------------------------------------------
// projection
// ---------------------------------------------------------------------------

// How a projection's A is made from its source rows: a copy (bf16), or the
// LayerNorm of bf16 or fp32 rows, rounded to bf16.
enum AKind : int { kCopy = 0, kLnBf16 = 1, kLnF32 = 2 };

// Shared memory of a projection phase: the W ring, the partial tiles the
// cluster's ranks send this block (two, by item parity), the rows'
// LayerNorm sums from every rank and their mean and rstd, A (the block's K
// slice of every row of the M group) and, for a LayerNorm, the raw slice it
// is made from.
template <int BN, int KC = kKC>
struct ProjLayout {
  static_assert(BN == 16 || BN == 32 || BN == 64, "8-column n-blocks over 8 warps");
  static_assert(KC % 64 == 0, "whole 16-byte chunks and k-steps a stage row");
  static constexpr int NS = KC == kKC ? 6 : 3;
  static constexpr int KS = 64 / BN;  // K slices of a stage among the warps
  static constexpr int kLd = KC + 8;  // padded stage row: an odd number of 16-byte chunks
  static constexpr size_t kRecv = size_t(NS) * BN * kLd * 2;
  static constexpr int kRecvFloats = kCS * KS * 16 * BN;  // one item's: (rank, slice, row, col)
  static constexpr size_t kStats = kRecv + 2 * size_t(kRecvFloats) * 4;
  static constexpr size_t kA = kStats + (2 * kCS + 2) * kMG * 4;
  __host__ __device__ static constexpr int slice(int K) { return round_up((K + kCS - 1) / kCS, KC); }
  __host__ __device__ static constexpr size_t kRaw(int K) { return kA + size_t(kMG) * (slice(K) + 8) * 2; }
  __host__ __device__ static constexpr size_t bytes(int K, int kind) {
    return kRaw(K) + (kind == kCopy ? 0 : size_t(kMG) * slice(K) * (kind == kLnF32 ? 4 : 2));
  }
};

struct Proj {
  const bf* w;        // (N, K)
  const void* a;      // A's source rows (M, K): bf16, or fp32 with kLnF32
  const bf *g, *b;    // the LayerNorm's, or null (kCopy)
  int kind, M, N, K;
  unsigned long long* tr = nullptr;  // this block's two sub-phase marks, or null
};

// What a projection stores, from the fp32 sum v of A[m] . W[n] (the plain
// twins' order): v + bias, then the GELU, then residual + that; out_f (fp32)
// and out_b (rounded) at row stride ldo; with kv_new the QKV projection's
// key and value columns (n >= D) also go there rounded, as (2, M, D).
struct Epi {
  const bf* bias;
  bool gelu;
  const bf* res_b;     // bf16 residual (M, ldo), or null
  const float* res_f;  // fp32 residual (M, ldo) written in this launch, or null
  float* out_f;
  bf* out_b;
  bf* kv_new;
  int ldo, D;
};

// The bias and residual of output (m, n), loaded ahead of the sum.
struct EpiIn {
  float bias, res;
};

__device__ __forceinline__ EpiIn fetch(const Epi& e, int m, int n) {
  const size_t i = static_cast<size_t>(m) * e.ldo + n;
  return {__bfloat162float(e.bias[n]),
          e.res_b ? __bfloat162float(e.res_b[i]) : e.res_f ? __ldcg(e.res_f + i) : 0.f};
}

__device__ __forceinline__ void store(const Epi& e, const EpiIn& in, int M, int m, int n, float v) {
  v += in.bias;
  if (e.gelu) v = gelu_erf(v);
  const size_t i = static_cast<size_t>(m) * e.ldo + n;
  if (e.res_b || e.res_f) v = in.res + v;
  if (e.out_f) e.out_f[i] = v;
  if (e.out_b) e.out_b[i] = __float2bfloat16(v);
  if (e.kv_new && n >= e.D)
    e.kv_new[(static_cast<size_t>(n / e.D - 1) * M + m) * e.D + n % e.D] = __float2bfloat16(v);
}

// The cluster's column tiles: tile = cluster + j * clusters.
template <int BN>
__device__ __forceinline__ int proj_items(const Proj& p) {
  const int tiles = (p.N + BN - 1) / BN, cluster = blockIdx.x / kCS, clusters = gridDim.x / kCS;
  return tiles > cluster ? (tiles - 1 - cluster) / clusters + 1 : 0;
}

// Stage s of the block's stream of W (item s / nk, K chunk s % nk of its
// slice), then a commit: an empty group past the end keeps the ring's
// counting uniform.
template <int BN, int KC>
__device__ __forceinline__ void proj_issue(const Proj& p, char* smem, int s, int S, int nk) {
  using Lay = ProjLayout<BN, KC>;
  if (s < S) {
    const int n0 = (blockIdx.x / kCS + (s / nk) * (gridDim.x / kCS)) * BN;
    const int k0 = blockIdx.x % kCS * Lay::slice(p.K) + (s % nk) * KC;
    bf* ws = reinterpret_cast<bf*>(smem) + (s % Lay::NS) * BN * Lay::kLd;
    for (int i = threadIdx.x; i < BN * (KC / 8); i += kThreads) {
      const int r = i / (KC / 8), k = k0 + i % (KC / 8) * 8, n = n0 + r;
      const bool ok = n < p.N && k < p.K;
      cp_async16(ws + r * Lay::kLd + k - k0, p.w + (ok ? static_cast<size_t>(n) * p.K + k : 0), ok);
    }
  }
  cp_commit();
}

// The first stages, issued before the barrier that publishes A's source (W
// does not depend on it).
template <int BN, int KC = kKC>
__device__ __forceinline__ void proj_pre(const Proj& p, char* smem) {
  using Lay = ProjLayout<BN, KC>;
  const int nk = Lay::slice(p.K) / KC, S = proj_items<BN>(p) * nk;
  for (int s = 0; s < Lay::NS - 1; ++s) proj_issue<BN, KC>(p, smem, s, S, nk);
}

// Rows m0 + r (r < rows) of the (M, K) matrix src, columns [k0, k0 + n), into
// shared rows of ld elements from dst, in 16-byte chunks: a warp a row, a
// lane a chunk; past Mg rows or `valid` columns, zeros.
template <typename X>
__device__ __forceinline__ void copy_rows(X* dst, int ld, const X* src, int K, int m0, int Mg,
                                          int rows, int k0, int n, int valid) {
  constexpr int per = 16 / sizeof(X);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kWarps) {
    const X* row = src + static_cast<size_t>(m0 + min(r, Mg - 1)) * K + k0;
    for (int k = lane * per; k < n; k += 32 * per) {
      const bool ok = r < Mg && k < valid;
      cp_async16(dst + r * ld + k, ok ? row + k : src, ok);
    }
  }
  cp_commit();
}

constexpr int kMaxCols = 12;  // slice columns a lane takes: slices up to 384 (D up to 1536)

// The LayerNorm form of build_a, over source rows of type X.
template <int BN, int KC, typename X>
__device__ __noinline__ void build_ln(const Proj& p, char* smem, int m0, int Mg, int mt) {
  namespace cg = cooperative_groups;
  using Lay = ProjLayout<BN, KC>;
  const int ks = Lay::slice(p.K), lda = ks + 8, k0 = blockIdx.x % kCS * ks;
  const int rows = 16 * mt, valid = max(0, min(ks, p.K - k0));
  bf* A = reinterpret_cast<bf*>(smem + Lay::kA);
  X* raw = reinterpret_cast<X*>(smem + Lay::kRaw(p.K));
  copy_rows(raw, ks, static_cast<const X*>(p.a), p.K, m0, Mg, rows, k0, ks, valid);
  // each lane keeps its columns' scale and shift while the copy lands
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float gv[kMaxCols], bv[kMaxCols];
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) {
    const int k = 2 * lane + 64 * (j / 2) + j % 2;  // the normalising pass's columns
    gv[j] = k < valid ? __bfloat162float(p.g[k0 + k]) : 0.f;
    bv[j] = k < valid ? __bfloat162float(p.b[k0 + k]) : 0.f;
  }
  cp_wait<0>();
  __syncthreads();
  // (rank, row) sums, (rank, row) squares, then the rows' mean and rstd: each
  // rank stores its row sums into every rank's shared memory, then each sums
  // its own copy in rank order
  float* stats = reinterpret_cast<float*>(smem + Lay::kStats);
  float* mean_of = stats + 2 * kCS * kMG;
  float* rstd_of = mean_of + kMG;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x % kCS;
  auto gather = [&](int part) {
    float v[kCS];
#pragma unroll
    for (int q = 0; q < kCS; ++q) v[q] = stats[(part * kCS + q) * kMG + threadIdx.x];
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < kCS; ++q) t += v[q];
    return t;
  };
  for (int r = warp; r < rows; r += kWarps) {
    float t = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j)
      if (lane + 32 * j < valid) t += to_f(raw[r * ks + lane + 32 * j]);
    t = warp_sum(t);
    if (lane == 0) mean_of[r] = t;  // staged here, then sent in one round
  }
  __syncthreads();
  if (threadIdx.x < kCS * rows) {
    const int q = threadIdx.x / rows, r = threadIdx.x % rows;
    cluster.map_shared_rank(stats, q)[rank * kMG + r] = mean_of[r];
  }
  cluster.sync();
  if (threadIdx.x < rows) mean_of[threadIdx.x] = gather(0) / p.K;
  __syncthreads();
  for (int r = warp; r < rows; r += kWarps) {
    const float mean = mean_of[r];
    float t = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) {
      if (lane + 32 * j < valid) {
        const float d = to_f(raw[r * ks + lane + 32 * j]) - mean;
        t += d * d;
      }
    }
    t = warp_sum(t);
    if (lane == 0) rstd_of[r] = t;  // staged here, then sent in one round
  }
  __syncthreads();
  if (threadIdx.x < kCS * rows) {
    const int q = threadIdx.x / rows, r = threadIdx.x % rows;
    cluster.map_shared_rank(stats, q)[(kCS + rank) * kMG + r] = rstd_of[r];
  }
  cluster.sync();
  if (threadIdx.x < rows) rstd_of[threadIdx.x] = 1.0f / sqrtf(gather(1) / p.K + 1e-5f);
  __syncthreads();
  // the row's values in registers first, so A's stores do not hold up the
  // loads; two neighbouring columns a lane, one 4-byte store
  const X* __restrict__ in = raw;
  __nv_bfloat162* __restrict__ out = reinterpret_cast<__nv_bfloat162*>(A);
  for (int r = warp; r < rows; r += kWarps) {
    const float mean = mean_of[r], rstd = rstd_of[r];
    float v[kMaxCols];
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) {
      const int k = 2 * lane + 64 * (j / 2) + j % 2;
      v[j] = r < Mg && k < valid ? to_f(in[r * ks + k]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kMaxCols; j += 2) {
      const int k = 2 * lane + 64 * (j / 2);
      if (k < ks) {
        const bool ok = r < Mg && k < valid;  // valid is even: both columns or neither
        out[(r * lda + k) / 2] = __floats2bfloat162_rn(ok ? (v[j] - mean) * rstd * gv[j] + bv[j] : 0.f,
                                                       ok ? (v[j + 1] - mean) * rstd * gv[j + 1] + bv[j + 1] : 0.f);
      }
    }
  }
}

// A for rows m0.. (Mg of them; up to 16 * mt rows, zeros past the data): the
// block's K slice [k0, k0 + ks) of each row, columns past K zeros. A
// LayerNorm takes its row statistics over the whole row from the cluster:
// each block sums its slice, the blocks read each other's sums from shared
// memory in rank order (two passes: the mean, then the squares about it).
template <int BN, int KC>
__device__ __noinline__ void build_a(const Proj& p, char* smem, int m0, int Mg, int mt) {
  using Lay = ProjLayout<BN, KC>;
  const int ks = Lay::slice(p.K), lda = ks + 8, k0 = blockIdx.x % kCS * ks;
  const int rows = 16 * mt, valid = max(0, min(ks, p.K - k0));
  bf* A = reinterpret_cast<bf*>(smem + Lay::kA);
  if (p.kind == kCopy) {
    copy_rows(A, lda, static_cast<const bf*>(p.a), p.K, m0, Mg, rows, k0, ks, valid);
    return;
  }
  if (p.kind == kLnF32)
    build_ln<BN, KC, float>(p, smem, m0, Mg, mt);
  else
    build_ln<BN, KC, bf>(p, smem, m0, Mg, mt);
}

// One projection phase: out[m, n] = store(epi, m, n, sum_k A[m, k] W[n, k]) for
// every row and the cluster's column tiles. The kCS blocks of a cluster take
// one K slice each; rank q stores rows 16q.. of the tile: the other ranks
// send it their partial sums of those rows into its shared memory, and it
// adds them in rank order. `pre`: proj_pre ran.
template <int BN, int KC = kKC>
__device__ __noinline__ void project(const Proj& p, char* smem, bool pre, const Epi& epi) {
  namespace cg = cooperative_groups;
  using Lay = ProjLayout<BN, KC>;
  constexpr int NS = Lay::NS, NB = BN / 8, KS = Lay::KS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nb = warp % NB, kq = warp / NB, g = lane / 4, t = lane % 4;
  const int ks = Lay::slice(p.K), nk = ks / KC, items = proj_items<BN>(p), S = items * nk;
  const int lda = ks + 8, rank = blockIdx.x % kCS;
  const bf* A = reinterpret_cast<const bf*>(smem + Lay::kA);
  float* recv = reinterpret_cast<float*>(smem + Lay::kRecv);
  cg::cluster_group cluster = cg::this_cluster();
  int done = 0;  // items finished, over the M groups: the parity of the receive buffer
  for (int m0 = 0; m0 < p.M && items > 0; m0 += kMG) {  // items: the same in the cluster
    const int Mg = min(kMG, p.M - m0), mt = (Mg + 15) / 16;
    if (m0 > 0 || !pre)
      for (int s = 0; s < NS - 1; ++s) proj_issue<BN, KC>(p, smem, s, S, nk);
    build_a<BN, KC>(p, smem, m0, Mg, mt);
    cp_wait<0>();
    __syncthreads();
    if (m0 == 0) sub_mark(p.tr, 0);  // A built
    float acc[4][4] = {};
    for (int s = 0; s < S; ++s) {
      cp_wait<NS - 2>();
      __syncthreads();
      proj_issue<BN, KC>(p, smem, s + NS - 1, S, nk);
      const int c = s % nk;
      const bf* ws = reinterpret_cast<const bf*>(smem) + (s % NS) * BN * Lay::kLd;
#pragma unroll
      for (int jj = 0; jj < KC / 16 / KS; ++jj) {
        const int j = kq + jj * KS;
        uint32_t b0, b1;
        ldsm_x2(b0, b1, smem_u32(ws + (nb * 8 + (lane & 7)) * Lay::kLd + j * 16 + (lane >> 3 & 1) * 8));
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          if (m < mt) {
            uint32_t a[4];
            ldsm_x4(a, smem_u32(A + (m * 16 + (lane & 15)) * lda + c * KC + j * 16 +
                                (lane >> 4) * 8));
            mma16816(acc[m], a, b0, b1);
          }
        }
      }
      if (c == nk - 1) {  // the item's last chunk: the tile's partials meet
        // m-tile m is rows 16m.. of the group, which rank m stores: each warp
        // sends its partial of them to that rank's receive buffer
        const int buf = done++ % 2;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          if (m < mt) {
            float* r = cluster.map_shared_rank(recv, m) + buf * Lay::kRecvFloats +
                       ((rank * KS + kq) * 16 + g) * BN + nb * 8 + 2 * t;
            *reinterpret_cast<float2*>(r) = make_float2(acc[m][0], acc[m][1]);
            *reinterpret_cast<float2*>(r + 8 * BN) = make_float2(acc[m][2], acc[m][3]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[m][i] = 0.f;
        }
        // this rank's outputs: bias and residual load while the sends land
        const int n0 = (blockIdx.x / kCS + (s / nk) * (gridDim.x / kCS)) * BN;
        const int rn = max(0, min(16, Mg - 16 * rank));
        constexpr int kOut = 16 * BN / kThreads;  // outputs a thread stores
        EpiIn in[kOut];
#pragma unroll
        for (int o = 0; o < kOut; ++o) {
          const int i = threadIdx.x + o * kThreads, r = i / BN, n = i % BN;
          if (r < rn && n0 + n < p.N) in[o] = fetch(epi, m0 + 16 * rank + r, n0 + n);
        }
        // a rank's next item sends to the other buffer, so this one is read
        // before anyone writes it again (one barrier later)
        cluster.sync();
        const float* got = recv + buf * Lay::kRecvFloats;
#pragma unroll
        for (int o = 0; o < kOut; ++o) {
          const int i = threadIdx.x + o * kThreads, r = i / BN, n = i % BN;
          if (r < rn && n0 + n < p.N) {
            float v = 0.f;
#pragma unroll
            for (int q = 0; q < kCS * KS; ++q) v += got[(q * 16 + r) * BN + n];  // rank, then slice
            store(epi, in[o], p.M, m0 + 16 * rank + r, n0 + n, v);
          }
        }
      }
    }
    cp_wait<0>();
    __syncthreads();
  }
  sub_mark(p.tr, 1);  // the stream and the epilogues done
}

// ---------------------------------------------------------------------------
// single-query attention
// ---------------------------------------------------------------------------

struct Attn {
  const float* q;  // (rows, q_stride) fp32, not yet scaled
  int q_stride;
  const void *k, *v;            // kv row b, key t at (b * row_keys + t) * D
  const float *ks, *vs;         // (rows, row_keys) key and value scales (int8), or null
  const float *k_new, *v_new;   // this step's own key and value (rows at q_stride), or null
  bf* out;                      // (rows, D)
  int B, H, D, nkeys, row_keys;
  float qscale;
  unsigned long long* tr = nullptr;  // this block's two sub-phase marks, or null
};

template <typename KV, int DH>
struct AttnCfg {
  static constexpr bool kInt8 = std::is_same<KV, int8_t>::value;
  static constexpr int FPL = DH / 8;                        // features a lane
  static constexpr int KB = DH * static_cast<int>(sizeof(KV));  // bytes of a key's head slice
  static constexpr int NW = FPL * static_cast<int>(sizeof(KV)) / 4;  // 32-bit words a lane reads
  static constexpr int kStage = 2 * kKeys * KB + (kInt8 ? 2 * kKeys * 4 : 0);
  static constexpr int NS = 114688 / kStage < 2 ? 2 : 114688 / kStage > 6 ? 6 : 114688 / kStage;
  static constexpr size_t kComb = size_t(NS) * kStage;
  static constexpr size_t bytes = kComb + (2 * kWarps + 4 + kWarps * DH) * 4;
  static_assert(KB % 16 == 0 && NW >= 1, "16-byte chunks of a key, whole words a lane");
};

template <int NW>
__device__ __forceinline__ void lds_words(uint32_t (&w)[NW], const char* p) {
  if constexpr (NW % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NW / 4; ++i) *reinterpret_cast<uint4*>(&w[4 * i]) = reinterpret_cast<const uint4*>(p)[i];
  } else if constexpr (NW == 2) {
    *reinterpret_cast<uint2*>(w) = *reinterpret_cast<const uint2*>(p);
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

template <typename KV, int DH>
__device__ __forceinline__ void attend_issue(const Attn& p, char* smem, int s, int S, int nst) {
  using Cfg = AttnCfg<KV, DH>;
  if (s < S) {
    const int item = blockIdx.x + (s / nst) * gridDim.x, b = item / p.H, h = item % p.H;
    const int t0 = (s % nst) * kKeys;
    char* st = smem + (s % Cfg::NS) * Cfg::kStage;
    const char* kb = static_cast<const char*>(p.k);
    const char* vb = static_cast<const char*>(p.v);
    constexpr int CPK = Cfg::KB / 16;
    for (int i = threadIdx.x; i < kKeys * CPK; i += kThreads) {
      const int key = i / CPK, ch = i % CPK, t = t0 + key;
      const bool ok = t < p.nkeys;
      const size_t off = (static_cast<size_t>(b) * p.row_keys + (ok ? t : 0)) * p.D * sizeof(KV) +
                         static_cast<size_t>(h) * Cfg::KB + ch * 16;
      cp_async16(st + key * Cfg::KB + ch * 16, kb + off, ok);
      cp_async16(st + (kKeys + key) * Cfg::KB + ch * 16, vb + off, ok);
    }
    if constexpr (Cfg::kInt8) {
      float* sc = reinterpret_cast<float*>(st + 2 * kKeys * Cfg::KB);
      for (int i = threadIdx.x; i < kKeys; i += kThreads) {
        const int t = t0 + i;
        const bool ok = t < p.nkeys;
        const size_t off = static_cast<size_t>(b) * p.row_keys + (ok ? t : 0);
        cp_async4(sc + i, p.ks + off, ok);
        cp_async4(sc + kKeys + i, p.vs + off, ok);
      }
    }
  }
  cp_commit();
}

// The block's first stages, issued before the barrier that publishes q.
template <typename KV, int DH>
__device__ __forceinline__ int attend_stages(const Attn& p) {
  const int items = p.B * p.H;
  const int mine = items > static_cast<int>(blockIdx.x) ? (items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  return mine * ((p.nkeys + kKeys - 1) / kKeys);
}

template <typename KV, int DH>
__device__ __forceinline__ void attend_pre(const Attn& p, char* smem) {
  const int S = attend_stages<KV, DH>(p), nst = (p.nkeys + kKeys - 1) / kKeys;
  for (int s = 0; s < AttnCfg<KV, DH>::NS - 1; ++s) attend_issue<KV, DH>(p, smem, s, S, nst);
}

// One attention phase over every (row, head); attend_pre ran.
template <typename KV, int DH>
__device__ __forceinline__ void attend(const Attn& p, char* smem) {
  using Cfg = AttnCfg<KV, DH>;
  constexpr int NS = Cfg::NS, FPL = Cfg::FPL, NW = Cfg::NW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, kq = lane >> 3, fc = lane & 7;
  const int nst = (p.nkeys + kKeys - 1) / kKeys, S = attend_stages<KV, DH>(p);
  float* cm = reinterpret_cast<float*>(smem + Cfg::kComb);
  float* cl = cm + kWarps;
  float* cs = cl + kWarps;
  float* cacc = cs + 4;
  // the next item's q (and own key and value) load while this item runs
  constexpr int OWN = (DH + 31) / 32;  // own-key features a lane of warp 0 takes
  float4 qn[FPL / 4];
  float qo[OWN] = {}, ko[OWN] = {}, vo = 0.f;
  auto load = [&](int item) {
    const size_t row = static_cast<size_t>(item / p.H) * p.q_stride + item % p.H * DH;
#pragma unroll
    for (int i = 0; i < FPL / 4; ++i)
      qn[i] = __ldcg(reinterpret_cast<const float4*>(p.q + row + fc * FPL) + i);
    if (!p.k_new) return;
#pragma unroll
    for (int i = 0; i < OWN; ++i) {
      const int f = lane + 32 * i;
      qo[i] = warp == 0 && f < DH ? __ldcg(p.q + row + f) : 0.f;
      ko[i] = warp == 0 && f < DH ? __ldcg(p.k_new + row + f) : 0.f;
    }
    if (threadIdx.x < DH) vo = __ldcg(p.v_new + row + threadIdx.x);
  };
  if (static_cast<int>(blockIdx.x) < p.B * p.H) load(blockIdx.x);
  int s = 0;
  for (int item = blockIdx.x; item < p.B * p.H; item += gridDim.x) {
    const int b = item / p.H, h = item % p.H;
    float qv[FPL];
#pragma unroll
    for (int i = 0; i < FPL / 4; ++i) {
      qv[4 * i] = qn[i].x * p.qscale, qv[4 * i + 1] = qn[i].y * p.qscale;
      qv[4 * i + 2] = qn[i].z * p.qscale, qv[4 * i + 3] = qn[i].w * p.qscale;
    }
    float own = 0.f;  // warp 0: this step's own key's logit, lane partials
#pragma unroll
    for (int i = 0; i < OWN; ++i) own += qo[i] * p.qscale * ko[i];
    const float v_own = vo;
    if (item + static_cast<int>(gridDim.x) < p.B * p.H) load(item + gridDim.x);
    // the int8 q.K product: q rounded per head to int8 at amax / 127
    float q8_scale = 0.f;
    int qp[Cfg::kInt8 ? NW : 1] = {};
    if constexpr (Cfg::kInt8) {
      float amax = 0.f;
#pragma unroll
      for (int f = 0; f < FPL; ++f) amax = fmaxf(amax, fabsf(qv[f]));
      for (int o = 1; o < 8; o <<= 1) amax = fmaxf(amax, __shfl_xor_sync(kFullMask, amax, o));
      q8_scale = fmaxf(amax, 1e-20f) / 127.0f;
#pragma unroll
      for (int f = 0; f < FPL; ++f) {
        const int qi = static_cast<int>(fminf(fmaxf(rintf(qv[f] / q8_scale), -127.f), 127.f));
        qp[f / 4] |= (qi & 0xff) << (8 * (f % 4));
      }
    }
    float m = -INFINITY, l = 0.f, acc[FPL] = {};
    for (int st = 0; st < nst; ++st, ++s) {
      cp_wait<NS - 2>();
      __syncthreads();
      if (s == 0) sub_mark(p.tr, 0);  // the first stage in
      attend_issue<KV, DH>(p, smem, s + NS - 1, S, nst);
      const char* sk = smem + (s % NS) * Cfg::kStage;
      const char* sv = sk + kKeys * Cfg::KB;
      const float* sks = reinterpret_cast<const float*>(sk + 2 * kKeys * Cfg::KB);
      const int t0 = st * kKeys;
      constexpr int kPer = kKeys / kWarps / 4;  // keys a lane group takes
      float sc[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int key = warp * (kKeys / kWarps) + 4 * i + kq;
        uint32_t kw[NW];
        lds_words<NW>(kw, sk + key * Cfg::KB + fc * FPL * sizeof(KV));
        float dot;
        if constexpr (Cfg::kInt8) {
          int d = 0;
#pragma unroll
          for (int w = 0; w < NW; ++w) d = __dp4a(static_cast<int>(kw[w]), qp[w], d);
          for (int o = 1; o < 8; o <<= 1) d += __shfl_xor_sync(kFullMask, d, o);
          dot = static_cast<float>(d) * q8_scale * sks[key];
        } else {
          const bf* e = reinterpret_cast<const bf*>(kw);
          dot = 0.f;
#pragma unroll
          for (int f = 0; f < FPL; ++f) dot += qv[f] * __bfloat162float(e[f]);
          for (int o = 1; o < 8; o <<= 1) dot += __shfl_xor_sync(kFullMask, dot, o);
        }
        sc[i] = t0 + key < p.nkeys ? dot : -INFINITY;
      }
      float mx = sc[0];
#pragma unroll
      for (int i = 1; i < kPer; ++i) mx = fmaxf(mx, sc[i]);
      mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 16));
      const float m_new = fmaxf(m, mx);
      if (m_new == -INFINITY) continue;  // warp-uniform: no key of this warp's slice
      const float alpha = __expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int f = 0; f < FPL; ++f) acc[f] *= alpha;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int key = warp * (kKeys / kWarps) + 4 * i + kq;
        const float e = __expf(sc[i] - m_new);
        l += e;
        const float w = Cfg::kInt8 ? e * sks[kKeys + key] : e;  // the value scale folds in
        uint32_t vw[NW];
        lds_words<NW>(vw, sv + key * Cfg::KB + fc * FPL * sizeof(KV));
        if constexpr (Cfg::kInt8) {
#pragma unroll
          for (int f = 0; f < FPL; ++f) acc[f] += w * int8_lane(vw[f / 4], f % 4);
        } else {
          const bf* ve = reinterpret_cast<const bf*>(vw);
#pragma unroll
          for (int f = 0; f < FPL; ++f) acc[f] += w * __bfloat162float(ve[f]);
        }
      }
      m = m_new;
    }
    // the warp's slices of keys, then the block's warps
    l += __shfl_xor_sync(kFullMask, l, 8);
    l += __shfl_xor_sync(kFullMask, l, 16);
#pragma unroll
    for (int f = 0; f < FPL; ++f) {
      acc[f] += __shfl_xor_sync(kFullMask, acc[f], 8);
      acc[f] += __shfl_xor_sync(kFullMask, acc[f], 16);
    }
    if (lane < 8) {
#pragma unroll
      for (int f = 0; f < FPL; ++f) cacc[warp * DH + fc * FPL + f] = acc[f];
    }
    if (lane == 0) cm[warp] = m, cl[warp] = l;
    if (p.k_new && warp == 0) {  // this step's own key, fp32 q and k
      own = warp_sum(own);
      if (lane == 0) cs[0] = own;
    }
    __syncthreads();
    if (threadIdx.x < DH) {
      const int d = threadIdx.x;
      float M = p.k_new ? cs[0] : -INFINITY;
      for (int w = 0; w < kWarps; ++w) M = fmaxf(M, cm[w]);
      float a = 0.f, den = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        const float e = __expf(cm[w] - M);
        den += cl[w] * e;
        a += cacc[w * DH + d] * e;
      }
      if (p.k_new) {
        const float e = __expf(cs[0] - M);
        den += e;
        a += e * v_own;
      }
      p.out[static_cast<size_t>(b) * p.D + h * DH + d] = __float2bfloat16(a / den);
    }
    __syncthreads();
  }
  sub_mark(p.tr, 1);  // every item done
  cp_wait<0>();
  __syncthreads();
}

}  // namespace
}  // namespace dl
}  // namespace olm
