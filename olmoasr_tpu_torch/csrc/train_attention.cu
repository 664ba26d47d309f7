// Whole-row softmax attention, the port of _attn_fwd and _attn_bwd
// (olmoasr_tpu/ops/train_attention.py: _make_fwd_row_kernel/_make_fwd_kernel,
// _softmax_rows, _mask_block, _make_bwd_row_kernel).
//
// Per (batch, head) and query row i, with q pre-scaled by dh^-0.5 in q's type:
//   s[j] = q_i . k_j (fp32) + bias[b, j]; s[j] = -1e9 where causal and j > i
//   m    = max_j s[j]          over the WHOLE key row
//   p[j] = exp(s[j] - m)       (fp32); l = sum_j p[j] (fp32)
//   o_i  = (sum_j bf16(p[j]) * v_j) / l
// The rounding of p to bf16 before P.V uses the row's final max, so an online
// softmax (running max, rescaled sums) would round differently. The kernels
// therefore pass over the keys twice: the first pass finds each row's max,
// the second forms p, sums l and accumulates P.V. Keys past the end of the
// sequence (the ragged last tile) are not keys at all and get p = 0; keys
// masked by the bias keep the TPU kernel's -1e9 semantics.
//
// What bounds it: tensor-core FLOPs. The encoder at small.en, B = 64, T = 1500,
// dh = 64, 12 heads does 4 * B * H * T^2 * dh = 442 GFLOP of products per layer
// (the two-pass form adds a second Q.K^T, 1.5x that). bf16 runs on the
// register-resident mma.sync core of attention_mma.cuh: a block owns 128
// query rows of one (b, h), 8 warps of 16 rows, two blocks an SM, Q
// pre-scaled into registers, K and V streamed through a 2-stage cp.async
// ring, scores, p and O in registers. Its exp is ex2.approx(s log2 e - m log2
// e), one fma a score, within 5e-6 of exp's relative value (rows whose |m|
// passes 64 take the unfolded form), so p's bf16 rounding moves by a
// step only where p lies that close to a rounding boundary: far inside the
// two-bf16-step tolerance of the checks. The fp32 kernels are a plain
// CUDA-core tiling for exact-precision checks.
#include "attention_mma.cuh"
#include "attention_tiles.cuh"

namespace olm {

constexpr float kNeg = -1e9f;

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
//   (a) attn_bwd_dq_kernel (bf16: attn_bwd_dq_mma_kernel), one block per
//       (64-query tile, h, b): one pass over
//       the key tiles for the row max, row sum and sum_j p dp (online, with
//       rescaling: nothing is rounded there), so delta = (sum_j p dp) / l;
//       then a second pass forms ds and accumulates dq = ds.K. It leaves each
//       query's fp32 (max, sum, delta) in a workspace;
//   (b) attn_bwd_dkv_kernel (bf16: attn_bwd_dkv_mma_kernel), one block per
//       (64-key tile, h, b): a loop over
//       the query tiles (with the causal mask only those on or below the
//       diagonal) that recomputes pn and dp from the workspace's statistics
//       and accumulates dK and dV in registers.
// What bounds it: tensor-core FLOPs. The minimum is five products of
// 2 T^2 dh per (b, h) (S, dP, dq, dK, dV); this design does nine (S and dP
// twice in (a) and once more in (b)). bf16 runs the register-resident
// mma.sync core of attention_mma.cuh (S, dP, p and ds never leave the
// registers; tiles stream through cp.async rings; 1 / l is stored, so no
// element is divided); fp32 runs the kernels below on the CUDA cores (4 x 4
// outputs a thread) for exact-precision training and checks.

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
constexpr size_t bwd_smem(int operand_tiles) {
  return operand_tiles * kTq * BwdCfg<T>::kPitch * sizeof(T) + 2 * kTq * kSP * sizeof(float) +
         3 * kTq * sizeof(float);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    using bf = __nv_bfloat16;
    const mma::FwdParams p{static_cast<const bf*>(q), static_cast<const bf*>(k),
                           static_cast<const bf*>(v), bias, out, B, H, Tq, Tk, D,
                           bias_bstride, causal, scale};
    return mma::launch_fwd<kDh, 1, mma::kFwdRows, mma::kStages, mma::kExp2>(p, s);
  }
  if (dtype != kF32) return cudaErrorInvalidValue;
  AttnArgs p{q, k, v, bias, out, B, H, Tq, Tk, D, bias_bstride, causal, scale};
  // raise the dynamic shared-memory limit once per process (not a stream
  // operation, so a CUDA graph capture of a later call never sees it)
  static const cudaError_t configured = cudaFuncSetAttribute(
      attn_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kF32Smem));
  if (configured != cudaSuccess) return static_cast<int>(configured);
  attn_fwd_f32_kernel<<<dim3((Tq + kTq - 1) / kTq, H, B), 256, kF32Smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int olm_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                                 const float* bias, int bias_bstride, void* dq, void* dk, void* dv,
                                 float* stats, int B, int H, int Tq, int Tk, int D, int causal,
                                 float scale, int dtype, void* stream) {
  using namespace olm;
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || D != H * kDh) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    using bf = __nv_bfloat16;
    const mma::BwdParams p{static_cast<const bf*>(q), static_cast<const bf*>(k),
                           static_cast<const bf*>(v), static_cast<const bf*>(dout), bias,
                           static_cast<bf*>(dq), static_cast<bf*>(dk), static_cast<bf*>(dv),
                           stats, B, H, Tq, Tk, D, bias_bstride, causal, scale};
    return mma::launch_bwd<mma::kBwdRows>(p, s);
  }
  if (dtype != kF32) return cudaErrorInvalidValue;
  BwdArgs p{q, k, v, dout, bias, dq, dk, dv, stats, B, H, Tq, Tk, D, bias_bstride, causal, scale};
  return launch_bwd<float>(p, s);
}
