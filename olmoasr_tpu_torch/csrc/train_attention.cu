// One-pass-softmax attention forward, the port of _attn_fwd
// (olmoasr_tpu/ops/train_attention.py: _make_fwd_row_kernel/_make_fwd_kernel,
// _softmax_rows, _mask_block).
//
// Per (batch, head) and query row i, with q pre-scaled by dh^-0.5 in q's type:
//   s[j] = q_i . k_j (fp32) + bias[b, j]; s[j] = -1e9 where causal and j > i
//   m    = max_j s[j]          over the WHOLE key row
//   p[j] = exp(s[j] - m)       (fp32); l = sum_j p[j] (fp32)
//   o_i  = (sum_j bf16(p[j]) * v_j) / l
// The rounding of p to bf16 before P.V uses the row's final max, so an online
// softmax (running max, rescaled sums) would round differently. The kernel
// therefore passes over the keys twice: the first pass finds each row's max,
// the second forms p, sums l and accumulates P.V. Keys past the end of the
// sequence (the ragged last tile) are not keys at all and get p = 0; keys
// masked by the bias keep the TPU kernel's -1e9 semantics.
//
// What bounds it: tensor-core FLOPs. The encoder at small.en, B = 64, T = 1500,
// dh = 64, 12 heads does 4 * B * H * T^2 * dh = 442 GFLOP of products per layer
// (the two-pass form adds a second Q.K^T, 1.5x that). The bf16 kernel runs
// every product on the tensor cores (WMMA 16x16x16, fp32 accumulation) on
// tiles held in shared memory: a block owns 64 query rows of one (b, h); each
// of its 4 warps owns 16 rows, so the row max, row sum and P stay warp-local.
// The fp32 kernel is a plain CUDA-core tiling for exact-precision checks.
#include <mma.h>

#include "common.cuh"

namespace olm {

constexpr float kNeg = -1e9f;
constexpr int kTq = 64;  // query rows per block
constexpr int kTk = 64;  // keys per tile
constexpr int kDh = 64;  // head width (every OLMoASR/Whisper size)

struct AttnArgs {
  const void* q;  // (B, Tq, D), head h at columns h*dh..
  const void* k;  // (B, Tk, D)
  const void* v;  // (B, Tk, D)
  const float* bias;  // (Bb, Tk) additive key bias, or null
  void* out;          // (B, Tq, D)
  int B, H, Tq, Tk, D;
  int bias_bstride;  // Tk when the bias has a row per batch, 0 when shared
  int causal;
  float scale;  // dh^-0.5 as a value of q's type
};

// Score of query row qi against key j after bias and masks; -inf for keys past
// the end of the sequence. (Args: AttnArgs or BwdArgs.)
template <class Args>
__device__ __forceinline__ float masked_score(float s, const Args& p, const float* bias_row,
                                              int qi, int key) {
  if (key >= p.Tk) return -INFINITY;
  if (bias_row) s += bias_row[key];
  if (p.causal && key > qi) s = kNeg;
  return s;
}

// Number of key tiles a query tile needs: with the causal mask, keys beyond the
// tile's last row only ever carry -1e9 and contribute exp(-1e9 - m) = 0.
template <class Args>
__device__ __forceinline__ int key_tiles(const Args& p, int q0) {
  int n = (p.Tk + kTk - 1) / kTk;
  if (p.causal) n = min(n, (q0 + kTq + kTk - 1) / kTk);
  return n;
}

// ---------------------------------------------------------------------------
// bf16: 128 threads, WMMA.
// ---------------------------------------------------------------------------

constexpr int kDP = kDh + 8;  // bf16 row pitch of Q/K/V/P tiles (144 bytes)
constexpr int kSP = kTk + 4;  // fp32 row pitch of the score tile (272 bytes)
constexpr size_t kBf16Smem = 4 * kTq * kDP * sizeof(__nv_bfloat16) + kTq * kSP * sizeof(float);

__global__ void __launch_bounds__(128) attn_fwd_bf16_kernel(AttnArgs p) {
  using bf = __nv_bfloat16;
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  bf* Qs = reinterpret_cast<bf*>(smem);
  bf* Ks = Qs + kTq * kDP;
  bf* Vs = Ks + kTk * kDP;
  bf* Ps = Vs + kTk * kDP;
  float* Ss = reinterpret_cast<float*>(Ps + kTq * kDP);

  const int q0 = blockIdx.x * kTq, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t hoff = static_cast<size_t>(h) * kDh;
  const bf* Q = static_cast<const bf*>(p.q) + static_cast<size_t>(b) * p.Tq * p.D + hoff;
  const bf* K = static_cast<const bf*>(p.k) + static_cast<size_t>(b) * p.Tk * p.D + hoff;
  const bf* V = static_cast<const bf*>(p.v) + static_cast<size_t>(b) * p.Tk * p.D + hoff;
  const float* bias_row = p.bias ? p.bias + static_cast<size_t>(b) * p.bias_bstride : nullptr;

  // 64 rows x 64 features = 512 chunks of 8 bf16 per tile, 4 per thread
  for (int c = tid; c < kTq * (kDh / 8); c += 128) {
    const int r = c / 8, col = (c % 8) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < p.Tq) {
      val = *reinterpret_cast<const uint4*>(Q + static_cast<size_t>(q0 + r) * p.D + col);
      bf* e = reinterpret_cast<bf*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = from_f<bf>(to_f(e[j]) * p.scale);
    }
    *reinterpret_cast<uint4*>(Qs + r * kDP + col) = val;
  }
  auto load_tile = [&](const bf* src, bf* dst, int k0) {
    for (int c = tid; c < kTk * (kDh / 8); c += 128) {
      const int r = c / 8, col = (c % 8) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);  // zero rows past the end: 0 * p, never NaN
      if (k0 + r < p.Tk) val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(k0 + r) * p.D + col);
      *reinterpret_cast<uint4*>(dst + r * kDP + col) = val;
    }
  };
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf, wmma::row_major> qf[kDh / 16];
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], Qs + warp * 16 * kDP + kk * 16, kDP);

  // this warp's 16 x 64 score block of the current key tile, into Ss
  auto scores = [&]() {
#pragma unroll
    for (int n = 0; n < kTk / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
      wmma::fill_fragment(s, 0.0f);
#pragma unroll
      for (int kk = 0; kk < kDh / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, Ks + n * 16 * kDP + kk * 16, kDP);
        wmma::mma_sync(s, qf[kk], kf, s);
      }
      wmma::store_matrix_sync(Ss + warp * 16 * kSP + n * 16, s, kSP, wmma::mem_row_major);
    }
    __syncwarp();
  };

  // row ownership for the softmax: two lanes per row, 32 columns each
  const int r = warp * 16 + lane / 2, c0 = (lane % 2) * 32, qi = q0 + r;
  const int nkt = key_tiles(p, q0);

  float m_row = -INFINITY;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kTk;
    __syncthreads();
    load_tile(K, Ks, k0);
    __syncthreads();
    scores();
    float mx = -INFINITY;
    for (int j = 0; j < 32; ++j)
      mx = fmaxf(mx, masked_score(Ss[r * kSP + c0 + j], p, bias_row, qi, k0 + c0 + j));
    m_row = fmaxf(m_row, fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 1)));
    __syncwarp();
  }

  float l_row = 0.f;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> of[kDh / 16];
#pragma unroll
  for (int n = 0; n < kDh / 16; ++n) wmma::fill_fragment(of[n], 0.0f);
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kTk;
    __syncthreads();
    load_tile(K, Ks, k0);
    load_tile(V, Vs, k0);
    __syncthreads();
    scores();
    for (int j = 0; j < 32; ++j) {
      const float s = masked_score(Ss[r * kSP + c0 + j], p, bias_row, qi, k0 + c0 + j);
      const float e = expf(s - m_row);
      l_row += e;
      Ps[r * kDP + c0 + j] = from_f<bf>(e);
    }
    __syncwarp();
#pragma unroll
    for (int n = 0; n < kDh / 16; ++n) {
#pragma unroll
      for (int kk = 0; kk < kTk / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, Ps + warp * 16 * kDP + kk * 16, kDP);
        wmma::load_matrix_sync(vf, Vs + kk * 16 * kDP + n * 16, kDP);
        wmma::mma_sync(of[n], pf, vf, of[n]);
      }
    }
    __syncwarp();
  }
  l_row += __shfl_xor_sync(kFullMask, l_row, 1);

#pragma unroll
  for (int n = 0; n < kDh / 16; ++n)
    wmma::store_matrix_sync(Ss + warp * 16 * kSP + n * 16, of[n], kSP, wmma::mem_row_major);
  __syncwarp();
  if (qi < p.Tq) {
    bf* o = static_cast<bf*>(p.out) + (static_cast<size_t>(b) * p.Tq + qi) * p.D + hoff;
    for (int j = 0; j < 32; ++j) o[c0 + j] = from_f<bf>(Ss[r * kSP + c0 + j] / l_row);
  }
}

// ---------------------------------------------------------------------------
// fp32: 256 threads on the CUDA cores, 4x4 outputs per thread.
// ---------------------------------------------------------------------------

constexpr int kFP = kDh + 1;  // fp32 row pitch of Q/K/score tiles
constexpr size_t kF32Smem = (3 * kTq * kFP + kTk * kDh + kTq) * sizeof(float);

__global__ void __launch_bounds__(256) attn_fwd_f32_kernel(AttnArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + kTq * kFP;
  float* Ss = Ks + kTk * kFP;
  float* Vs = Ss + kTq * kFP;
  float* Ls = Vs + kTk * kDh;

  const int q0 = blockIdx.x * kTq, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t hoff = static_cast<size_t>(h) * kDh;
  const float* Q = static_cast<const float*>(p.q) + static_cast<size_t>(b) * p.Tq * p.D + hoff;
  const float* K = static_cast<const float*>(p.k) + static_cast<size_t>(b) * p.Tk * p.D + hoff;
  const float* V = static_cast<const float*>(p.v) + static_cast<size_t>(b) * p.Tk * p.D + hoff;
  const float* bias_row = p.bias ? p.bias + static_cast<size_t>(b) * p.bias_bstride : nullptr;

  for (int c = tid; c < kTq * kDh; c += 256) {
    const int r = c / kDh, d = c % kDh;
    Qs[r * kFP + d] = q0 + r < p.Tq ? Q[static_cast<size_t>(q0 + r) * p.D + d] * p.scale : 0.f;
  }
  auto load_tile = [&](const float* src, float* dst, int pitch, int k0) {
    for (int c = tid; c < kTk * kDh; c += 256) {
      const int r = c / kDh, d = c % kDh;
      dst[r * pitch + d] = k0 + r < p.Tk ? src[static_cast<size_t>(k0 + r) * p.D + d] : 0.f;
    }
  };
  auto scores = [&]() {
    float s[4][4] = {};
    for (int d = 0; d < kDh; ++d) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = Qs[(ty * 4 + i) * kFP + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv * Ks[(tx + 16 * j) * kFP + d];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ss[(ty * 4 + i) * kFP + tx + 16 * j] = s[i][j];
  };

  // row ownership for the softmax: four threads per row, 16 columns each
  const int r = tid / 4, c0 = (tid % 4) * 16, qi = q0 + r;
  const int nkt = key_tiles(p, q0);

  float m_row = -INFINITY;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kTk;
    __syncthreads();
    load_tile(K, Ks, kFP, k0);
    __syncthreads();
    scores();
    __syncthreads();
    float mx = -INFINITY;
    for (int j = 0; j < 16; ++j)
      mx = fmaxf(mx, masked_score(Ss[r * kFP + c0 + j], p, bias_row, qi, k0 + c0 + j));
    mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 2));
    m_row = fmaxf(m_row, mx);
  }

  float l_row = 0.f;
  float o[4][4] = {};
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kTk;
    __syncthreads();
    load_tile(K, Ks, kFP, k0);
    load_tile(V, Vs, kDh, k0);
    __syncthreads();
    scores();
    __syncthreads();
    for (int j = 0; j < 16; ++j) {
      const float s = masked_score(Ss[r * kFP + c0 + j], p, bias_row, qi, k0 + c0 + j);
      const float e = expf(s - m_row);
      l_row += e;
      Ss[r * kFP + c0 + j] = __bfloat162float(__float2bfloat16(e));
    }
    __syncthreads();
    for (int c = 0; c < kTk; ++c) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pv = Ss[(ty * 4 + i) * kFP + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] += pv * Vs[c * kDh + tx + 16 * j];
      }
    }
  }
  l_row += __shfl_xor_sync(kFullMask, l_row, 1);
  l_row += __shfl_xor_sync(kFullMask, l_row, 2);
  if (tid % 4 == 0) Ls[r] = l_row;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.Tq) continue;
    float* out = static_cast<float*>(p.out) + (static_cast<size_t>(b) * p.Tq + row) * p.D + hoff;
#pragma unroll
    for (int j = 0; j < 4; ++j) out[tx + 16 * j] = o[i][j] / Ls[ty * 4 + i];
  }
}


// ---------------------------------------------------------------------------
// backward: the port of _attn_bwd (olmoasr_tpu/ops/train_attention.py:
// _make_bwd_row_kernel with ATTN_DEFER_L, ATTN_BF16_EXP and ATTN_D128 off).
//
// Per (batch, head), with q pre-scaled and do cast to q's type:
//   s  = q.K^T + bias (causal: -1e9 where j > i); pn = exp(s - max) / l (fp32)
//   dp = do.V^T (fp32); delta_i = sum_j dp_ij pn_ij
//   ds = bf16(pn (dp - delta)); pnb = bf16(pn)   (bf16 even for fp32 inputs)
//   dq = ds.K (rounded to q's type, then times the scale in q's type)
//   dK = ds^T.q; dV = pnb^T.do                    (k's and v's types)
// delta uses the fp32 pn, not rowsum(do * o): o was formed from the bf16 P.
//
// The TPU kernel holds a whole (b, h) row in VMEM and loops over query
// blocks, accumulating dK and dV of all Tk keys in fp32 scratch. A block here
// cannot hold 1500 x 64 x 2 fp32 accumulators beside K and V, so the work is
// split in two launches, both deterministic (no atomics; every sum is taken in
// a fixed order):
//   (a) attn_bwd_dq_kernel, one block per (64-query tile, h, b): one pass over
//       the key tiles for the row max, row sum and sum_j p dp (online, with
//       rescaling: nothing is rounded there), so delta = (sum_j p dp) / l;
//       then a second pass forms ds and accumulates dq = ds.K. It leaves each
//       query's fp32 (max, sum, delta) in a workspace;
//   (b) attn_bwd_dkv_kernel, one block per (64-key tile, h, b): a loop over
//       the query tiles (with the causal mask only those on or below the
//       diagonal) that recomputes pn and dp from the workspace's statistics
//       and accumulates dK and dV in registers.
// What bounds it: tensor-core FLOPs. The minimum is five products of
// 2 T^2 dh per (b, h) (S, dP, dq, dK, dV); this design does nine (S and dP
// twice in (a) and once more in (b)). bf16 runs every product on the tensor
// cores (WMMA 16x16x16, fp32 accumulation), each warp owning 16 rows of a
// 64 x 64 tile; fp32 runs them on the CUDA cores (4 x 4 outputs a thread) for
// exact-precision training and checks.

struct BwdArgs {
  const void* q;     // (B, Tq, D)
  const void* k;     // (B, Tk, D)
  const void* v;     // (B, Tk, D)
  const void* dout;  // (B, Tq, D), q's type
  const float* bias;  // (Bb, Tk) additive key bias, or null
  void* dq;           // (B, Tq, D)
  void* dk;           // (B, Tk, D)
  void* dv;           // (B, Tk, D)
  float* stats;       // (3, B, H, Tq): row max, row sum, delta
  int B, H, Tq, Tk, D;
  int bias_bstride;
  int causal;
  float scale;
};

template <typename T>
struct BwdCfg;
template <>
struct BwdCfg<__nv_bfloat16> {
  static constexpr int kThreads = 128;  // 4 warps x 16 rows
  static constexpr int kPitch = kDh + 8;  // bf16 row pitch (144 bytes: WMMA-aligned)
};
template <>
struct BwdCfg<float> {
  static constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
  static constexpr int kPitch = kDh + 1;  // conflict-free column reads
};

template <typename T>
constexpr size_t bwd_smem(int operand_tiles) {
  return operand_tiles * kTq * BwdCfg<T>::kPitch * sizeof(T) + 2 * kTq * kSP * sizeof(float) +
         3 * kTq * sizeof(float);
}

__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16(x)); }

// rows r0.. of a (rows, D) tensor, this head's 64 columns, into a 64-row tile;
// rows at or past n are zero. `scaled` multiplies by s in T (q's pre-scale).
template <typename T>
__device__ __forceinline__ void load_rows(const T* src, T* dst, int r0, int n, int ld, bool scaled,
                                          float s) {
  constexpr int V = 16 / sizeof(T), P = BwdCfg<T>::kPitch;
  for (int c = threadIdx.x; c < kTq * (kDh / V); c += BwdCfg<T>::kThreads) {
    const int r = c / (kDh / V), col = (c % (kDh / V)) * V;
    alignas(16) T vals[V];
    if (r0 + r < n) {
      *reinterpret_cast<uint4*>(vals) =
          *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + r) * ld + col);
      if (scaled) {
#pragma unroll
        for (int j = 0; j < V; ++j) vals[j] = from_f<T>(to_f(vals[j]) * s);
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) vals[j] = from_f<T>(0.f);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) dst[r * P + col + j] = vals[j];
  }
}

// C (fp32, pitch kSP) = A . B^T for 64 x 64 operand tiles stored row-major
__device__ __forceinline__ void tile_nt(const __nv_bfloat16* A, const __nv_bfloat16* Bm, float* C) {
  using namespace nvcuda;
  using bf = __nv_bfloat16;
  constexpr int P = BwdCfg<bf>::kPitch;
  const int warp = threadIdx.x / 32;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf, wmma::row_major> af[kDh / 16];
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) wmma::load_matrix_sync(af[kk], A + warp * 16 * P + kk * 16, P);
#pragma unroll
  for (int n = 0; n < kTk / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf, wmma::col_major> bfr;
      wmma::load_matrix_sync(bfr, Bm + n * 16 * P + kk * 16, P);
      wmma::mma_sync(acc, af[kk], bfr, acc);
    }
    wmma::store_matrix_sync(C + warp * 16 * kSP + n * 16, acc, kSP, wmma::mem_row_major);
  }
}

__device__ __forceinline__ void tile_nt(const float* A, const float* Bm, float* C) {
  constexpr int P = BwdCfg<float>::kPitch;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[4][4] = {};
  for (int d = 0; d < kDh; ++d) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = A[(ty * 4 + i) * P + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] += a * Bm[(tx + 16 * j) * P + d];
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) C[(ty * 4 + i) * kSP + tx + 16 * j] = s[i][j];
}

// a 64 x 64 fp32 accumulator: acc += A . B for row-major operand tiles
template <typename T>
struct TileAcc;

template <>
struct TileAcc<__nv_bfloat16> {
  using bf = __nv_bfloat16;
  static constexpr int P = BwdCfg<bf>::kPitch;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> f[kDh / 16];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int n = 0; n < kDh / 16; ++n) nvcuda::wmma::fill_fragment(f[n], 0.0f);
  }
  __device__ __forceinline__ void add(const bf* A, const bf* Bm) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int kk = 0; kk < kTk / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf, wmma::row_major> af;
      wmma::load_matrix_sync(af, A + warp * 16 * P + kk * 16, P);
#pragma unroll
      for (int n = 0; n < kDh / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf, wmma::row_major> bfr;
        wmma::load_matrix_sync(bfr, Bm + kk * 16 * P + n * 16, P);
        wmma::mma_sync(f[n], af, bfr, f[n]);
      }
    }
  }
  __device__ __forceinline__ void store(float* C) const {
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int n = 0; n < kDh / 16; ++n)
      nvcuda::wmma::store_matrix_sync(C + warp * 16 * kSP + n * 16, f[n], kSP,
                                      nvcuda::wmma::mem_row_major);
  }
};

template <>
struct TileAcc<float> {
  static constexpr int P = BwdCfg<float>::kPitch;
  float a[4][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[i][j] = 0.f;
  }
  __device__ __forceinline__ void add(const float* A, const float* Bm) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
    for (int c = 0; c < kTk; ++c) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = A[(ty * 4 + i) * P + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) a[i][j] += x * Bm[c * P + tx + 16 * j];
      }
    }
  }
  __device__ __forceinline__ void store(float* C) const {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) C[(ty * 4 + i) * kSP + tx + 16 * j] = a[i][j];
  }
};

// rows r0.. of the fp32 tile C into this head's columns of a (rows, D) output
template <typename T, class F>
__device__ __forceinline__ void store_rows(const float* C, T* dst, int r0, int n, int ld, F conv) {
  for (int e = threadIdx.x; e < kTq * kDh; e += BwdCfg<T>::kThreads) {
    const int r = e / kDh, d = e % kDh;
    if (r0 + r < n) dst[static_cast<size_t>(r0 + r) * ld + d] = conv(C[r * kSP + d]);
  }
}

template <typename T>
__global__ void __launch_bounds__(BwdCfg<T>::kThreads) attn_bwd_dq_kernel(BwdArgs p) {
  constexpr int P = BwdCfg<T>::kPitch, kLanes = BwdCfg<T>::kThreads / kTq, kCols = kTk / kLanes;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + kTq * P;
  T* Ks = dOs + kTq * P;
  T* Vs = Ks + kTk * P;
  T* Ps = Vs + kTk * P;
  float* Ss = reinterpret_cast<float*>(Ps + kTq * P);
  float* Ds = Ss + kTq * kSP;

  const int q0 = blockIdx.x * kTq, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const size_t hoff = static_cast<size_t>(h) * kDh;
  const T* Q = static_cast<const T*>(p.q) + static_cast<size_t>(b) * p.Tq * p.D + hoff;
  const T* dO = static_cast<const T*>(p.dout) + static_cast<size_t>(b) * p.Tq * p.D + hoff;
  const T* K = static_cast<const T*>(p.k) + static_cast<size_t>(b) * p.Tk * p.D + hoff;
  const T* V = static_cast<const T*>(p.v) + static_cast<size_t>(b) * p.Tk * p.D + hoff;
  const float* bias_row = p.bias ? p.bias + static_cast<size_t>(b) * p.bias_bstride : nullptr;

  load_rows(Q, Qs, q0, p.Tq, p.D, true, p.scale);
  load_rows(dO, dOs, q0, p.Tq, p.D, false, 1.f);
  // row ownership for the elementwise work: kLanes neighbouring threads a row
  const int r = tid / kLanes, c0 = (tid % kLanes) * kCols, qi = q0 + r;
  const int nkt = key_tiles(p, q0);
  auto scores = [&](int k0) {
    __syncthreads();
    load_rows(K, Ks, k0, p.Tk, p.D, false, 1.f);
    load_rows(V, Vs, k0, p.Tk, p.D, false, 1.f);
    __syncthreads();
    tile_nt(Qs, Ks, Ss);
    tile_nt(dOs, Vs, Ds);
    __syncthreads();
  };

  // pass 1: this thread's share of the row max, sum of p and sum of p * dp,
  // rescaled as the max grows
  float m = -INFINITY, l = 0.f, pd = 0.f;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kTk;
    scores(k0);
    float tmax = -INFINITY;
    for (int j = 0; j < kCols; ++j)
      tmax = fmaxf(tmax, masked_score(Ss[r * kSP + c0 + j], p, bias_row, qi, k0 + c0 + j));
    const float nm = fmaxf(m, tmax);
    if (nm == -INFINITY) continue;  // no key of this share exists yet
    const float c = expf(m - nm);
    l *= c;
    pd *= c;
    for (int j = 0; j < kCols; ++j) {
      const float e = expf(masked_score(Ss[r * kSP + c0 + j], p, bias_row, qi, k0 + c0 + j) - nm);
      l += e;
      pd += e * Ds[r * kSP + c0 + j];
    }
    m = nm;
  }
  // the row's shares combined (key 0 is always a key, so the row's max is
  // finite; a share that saw no key has m = -inf and weighs 0)
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) {
    const float om = __shfl_xor_sync(kFullMask, m, o);
    const float ol = __shfl_xor_sync(kFullMask, l, o);
    const float opd = __shfl_xor_sync(kFullMask, pd, o);
    const float nm = fmaxf(m, om);
    const float a = m == -INFINITY ? 0.f : expf(m - nm);
    const float c = om == -INFINITY ? 0.f : expf(om - nm);
    l = l * a + ol * c;
    pd = pd * a + opd * c;
    m = nm;
  }
  const float delta = pd / l;
  if (tid % kLanes == 0 && qi < p.Tq) {
    const size_t row = (static_cast<size_t>(b) * p.H + h) * p.Tq + qi;
    const size_t plane = static_cast<size_t>(p.B) * p.H * p.Tq;
    p.stats[row] = m;
    p.stats[plane + row] = l;
    p.stats[2 * plane + row] = delta;
  }

  // pass 2: ds = bf16(pn (dp - delta)), dq += ds . K
  TileAcc<T> acc;
  acc.zero();
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kTk;
    scores(k0);
    for (int j = 0; j < kCols; ++j) {
      const float s = masked_score(Ss[r * kSP + c0 + j], p, bias_row, qi, k0 + c0 + j);
      const float pn = expf(s - m) / l;
      Ps[r * P + c0 + j] = from_f<T>(round_bf16(pn * (Ds[r * kSP + c0 + j] - delta)));
    }
    __syncthreads();
    acc.add(Ps, Ks);
  }
  __syncthreads();
  acc.store(Ss);
  __syncthreads();
  const float scale = p.scale;
  store_rows(Ss, static_cast<T*>(p.dq) + static_cast<size_t>(b) * p.Tq * p.D + hoff, q0, p.Tq,
             p.D, [scale](float x) { return from_f<T>(to_f(from_f<T>(x)) * scale); });
}

template <typename T>
__global__ void __launch_bounds__(BwdCfg<T>::kThreads) attn_bwd_dkv_kernel(BwdArgs p) {
  constexpr int P = BwdCfg<T>::kPitch, kLanes = BwdCfg<T>::kThreads / kTk, kCols = kTq / kLanes;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + kTk * P;
  T* Qs = Vs + kTk * P;
  T* dOs = Qs + kTq * P;
  T* Ps = dOs + kTq * P;
  T* DSs = Ps + kTk * P;
  float* Ss = reinterpret_cast<float*>(DSs + kTk * P);
  float* Ds = Ss + kTk * kSP;
  float* Ms = Ds + kTk * kSP;
  float* Ls = Ms + kTq;
  float* Dl = Ls + kTq;

  const int k0 = blockIdx.x * kTk, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const size_t hoff = static_cast<size_t>(h) * kDh;
  const T* Q = static_cast<const T*>(p.q) + static_cast<size_t>(b) * p.Tq * p.D + hoff;
  const T* dO = static_cast<const T*>(p.dout) + static_cast<size_t>(b) * p.Tq * p.D + hoff;
  const T* K = static_cast<const T*>(p.k) + static_cast<size_t>(b) * p.Tk * p.D + hoff;
  const T* V = static_cast<const T*>(p.v) + static_cast<size_t>(b) * p.Tk * p.D + hoff;
  const float* bias_row = p.bias ? p.bias + static_cast<size_t>(b) * p.bias_bstride : nullptr;
  const size_t srow = (static_cast<size_t>(b) * p.H + h) * p.Tq;
  const size_t plane = static_cast<size_t>(p.B) * p.H * p.Tq;

  load_rows(K, Ks, k0, p.Tk, p.D, false, 1.f);
  load_rows(V, Vs, k0, p.Tk, p.D, false, 1.f);
  // row ownership: a row is a key, its columns are the tile's queries
  const int r = tid / kLanes, c0 = (tid % kLanes) * kCols, key = k0 + r;
  TileAcc<T> dk, dv;
  dk.zero();
  dv.zero();
  const int nqt = (p.Tq + kTq - 1) / kTq;
  // with the causal mask, query tiles above the diagonal see none of these keys
  for (int qt = p.causal ? k0 / kTq : 0; qt < nqt; ++qt) {
    const int q0 = qt * kTq;
    __syncthreads();
    load_rows(Q, Qs, q0, p.Tq, p.D, true, p.scale);
    load_rows(dO, dOs, q0, p.Tq, p.D, false, 1.f);
    for (int e = tid; e < kTq; e += BwdCfg<T>::kThreads) {
      const bool in = q0 + e < p.Tq;
      Ms[e] = in ? p.stats[srow + q0 + e] : 0.f;
      Ls[e] = in ? p.stats[plane + srow + q0 + e] : 1.f;
      Dl[e] = in ? p.stats[2 * plane + srow + q0 + e] : 0.f;
    }
    __syncthreads();
    tile_nt(Ks, Qs, Ss);  // S^T: keys x queries
    tile_nt(Vs, dOs, Ds);  // dP^T
    __syncthreads();
    for (int j = 0; j < kCols; ++j) {
      const int c = c0 + j, qi = q0 + c;
      float pn = 0.f, ds = 0.f;
      if (qi < p.Tq) {
        const float s = masked_score(Ss[r * kSP + c], p, bias_row, qi, key);
        pn = expf(s - Ms[c]) / Ls[c];
        ds = round_bf16(pn * (Ds[r * kSP + c] - Dl[c]));
      }
      Ps[r * P + c] = from_f<T>(round_bf16(pn));
      DSs[r * P + c] = from_f<T>(ds);
    }
    __syncthreads();
    dv.add(Ps, dOs);
    dk.add(DSs, Qs);
  }
  __syncthreads();
  dk.store(Ss);
  dv.store(Ds);
  __syncthreads();
  auto same = [](float x) { return from_f<T>(x); };
  store_rows(Ss, static_cast<T*>(p.dk) + static_cast<size_t>(b) * p.Tk * p.D + hoff, k0, p.Tk,
             p.D, same);
  store_rows(Ds, static_cast<T*>(p.dv) + static_cast<size_t>(b) * p.Tk * p.D + hoff, k0, p.Tk,
             p.D, same);
}

template <typename T>
int launch_bwd(const BwdArgs& p, cudaStream_t s) {
  constexpr int NT = BwdCfg<T>::kThreads;
  constexpr size_t kA = bwd_smem<T>(5), kB = bwd_smem<T>(6);
  // raise the dynamic shared-memory limits once per process and type
  static const cudaError_t configured = [] {
    cudaError_t e = cudaFuncSetAttribute(attn_bwd_dq_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kA));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(attn_bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(kB));
  }();
  if (configured != cudaSuccess) return static_cast<int>(configured);
  attn_bwd_dq_kernel<T><<<dim3((p.Tq + kTq - 1) / kTq, p.H, p.B), NT, kA, s>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  attn_bwd_dkv_kernel<T><<<dim3((p.Tk + kTk - 1) / kTk, p.H, p.B), NT, kB, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace olm

extern "C" int olm_attention_fwd(const void* q, const void* k, const void* v, const float* bias,
                                 int bias_bstride, void* out, int B, int H, int Tq, int Tk, int D,
                                 int causal, float scale, int dtype, void* stream) {
  using namespace olm;
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || D != H * kDh) return cudaErrorInvalidValue;
  AttnArgs p{q, k, v, bias, out, B, H, Tq, Tk, D, bias_bstride, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((Tq + kTq - 1) / kTq, H, B);
  // raise the dynamic shared-memory limit once per process (not a stream
  // operation, so a CUDA graph capture of a later call never sees it)
  static const cudaError_t configured = [] {
    cudaError_t e = cudaFuncSetAttribute(attn_fwd_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kBf16Smem));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(attn_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(kF32Smem));
  }();
  if (configured != cudaSuccess) return static_cast<int>(configured);
  if (dtype == kBF16)
    attn_fwd_bf16_kernel<<<grid, 128, kBf16Smem, s>>>(p);
  else if (dtype == kF32)
    attn_fwd_f32_kernel<<<grid, 256, kF32Smem, s>>>(p);
  else
    return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}

extern "C" int olm_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                                 const float* bias, int bias_bstride, void* dq, void* dk, void* dv,
                                 float* stats, int B, int H, int Tq, int Tk, int D, int causal,
                                 float scale, int dtype, void* stream) {
  using namespace olm;
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || D != H * kDh) return cudaErrorInvalidValue;
  BwdArgs p{q, k, v, dout, bias, dq, dk, dv, stats, B, H, Tq, Tk, D, bias_bstride, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return launch_bwd<__nv_bfloat16>(p, s);
  if (dtype == kF32) return launch_bwd<float>(p, s);
  return cudaErrorInvalidValue;
}
