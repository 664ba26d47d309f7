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
// the end of the sequence.
__device__ __forceinline__ float masked_score(float s, const AttnArgs& p, const float* bias_row,
                                              int qi, int key) {
  if (key >= p.Tk) return -INFINITY;
  if (bias_row) s += bias_row[key];
  if (p.causal && key > qi) s = kNeg;
  return s;
}

// Number of key tiles a query tile needs: with the causal mask, keys beyond the
// tile's last row only ever carry -1e9 and contribute exp(-1e9 - m) = 0.
__device__ __forceinline__ int key_tiles(const AttnArgs& p, int q0) {
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
