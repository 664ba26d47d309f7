// Online-softmax attention with segment ids, forward and backward: the port of
// the stock Pallas TPU flash attention that olmoasr_tpu/ops/flash.py::flash_mha
// calls (jax.experimental.pallas.ops.tpu.flash_attention: the forward kernel
// _flash_attention_kernel_single_batch, and the backward's
// _flash_attention_dkv_kernel and _flash_attention_dq_kernel).
//
// Per (batch, head), query row i, key tiles of 64 taken in order:
//   s   = fp32(q_i . k_j) * scale                  (q is not pre-scaled)
//   s  += kMaskValue where q_ids[i] != kv_ids[j], or causal and j > i
//   m'  = max(m, max_j s); p = exp(s - m'); c = exp(m - m') * l
//   l'  = sum_j p + c;     acc = acc * (c / l') + (round(p) . V) / l'
// round() is to the input type (bf16: before P.V on the tensor cores; fp32: a
// no-op). The forward writes o and the fp32 row max m and sum l, the residuals
// of the stock kernel. The backward takes di = sum(o * do) from the caller
// (a torch reduction, as the stock kernel computes it outside its kernels):
//   p  = exp(s - m) * (1 / l); dp = do . v^T (fp32); ds = (dp - di) * p * scale
//   dv = round(p)^T . do; dk = round(ds)^T . q; dq = round(ds) . k
// Keys past Tk (the ragged last tile) are not keys: their p is 0. Key tiles
// wholly above the diagonal are skipped (the stock kernel's below_or_on_diag):
// there every score is masked and adds exp(mask - m) = 0.
//
// The TPU kernel walks a sequential grid and carries m, l and the accumulator
// in VMEM scratch from one key block to the next. Here the loop over key tiles
// runs inside one block, which keeps each row's m and l in registers and its
// accumulator in registers too (the row's owner threads apply the per-row
// rescale to a P.V tile that the tensor cores leave in shared memory). The
// backward is two launches, both deterministic (no atomics): per 64-key tile,
// dk and dv accumulate over the query tiles (for causal, only those at or
// below the diagonal); per 64-query tile, dq accumulates over the key tiles.
//
// What bounds it: tensor-core FLOPs. At the encoder shape of small.en (B = 64,
// T = 1500, 12 heads of 64) the forward does 4 B H T^2 dh = 442 GFLOP of
// products per layer (0.447 ms at 989 TFLOP/s), against 4 x 147 MB of q, k,
// v and o (0.176 ms at 3.35 TB/s); the backward needs five products of
// 2 T^2 dh per (b, h) (S, dP, dV, dK, dQ) and does seven: the dq launch
// computes S and dP again. bf16 runs every product on the tensor cores (WMMA
// 16x16x16, fp32 accumulation), each warp owning 16 rows of a 64 x 64 tile;
// fp32 runs them on the CUDA cores for exact-precision checks.
// Head width 64 only (every OLMoASR/Whisper size).
#include "attention_tiles.cuh"

namespace olm {
namespace {

// the stock kernel's DEFAULT_MASK_VALUE, -0.7 * FLT_MAX rounded to fp32
constexpr float kMaskValue = static_cast<float>(-0.7 * 3.4028234663852886e38);

struct FlashArgs {
  const void* q;       // (B, Tq, D), head h at columns h*64..
  const void* k;       // (B, Tk, D)
  const void* v;       // (B, Tk, D)
  const void* dout;    // (B, Tq, D), q's type (backward)
  const int* q_ids;    // (B, Tq) segment ids, or null (no segment mask)
  const int* kv_ids;   // (B, Tk), null with q_ids
  void* out;           // (B, Tq, D) (forward)
  float* m;            // (B, H, Tq) row max: written by the forward, read by the backward
  float* l;            // (B, H, Tq) row sum
  const float* di;     // (B, H, Tq) sum(o * do) (backward)
  void* dq;            // (B, Tq, D)
  void* dk;            // (B, Tk, D)
  void* dv;            // (B, Tk, D)
  int B, H, Tq, Tk, D;
  int causal;
  float scale;  // dh^-0.5, applied to the fp32 scores
};

// The score of query qi (segment qid) against key `key` (segment kid), scaled
// and masked; -inf for keys past the end of the sequence.
__device__ __forceinline__ float flash_score(float dot, const FlashArgs& p, int qid, int kid,
                                             int qi, int key) {
  if (key >= p.Tk) return -INFINITY;
  const float s = __fmul_rn(dot, p.scale);
  const bool keep = (p.q_ids == nullptr || qid == kid) && !(p.causal && key > qi);
  return keep ? s : __fadd_rn(s, kMaskValue);
}

template <typename T>
constexpr size_t flash_smem(int operand_tiles, int score_tiles, int vectors) {
  return operand_tiles * kTq * BwdCfg<T>::kPitch * sizeof(T) +
         score_tiles * kTq * kSP * sizeof(float) + vectors * kTq * sizeof(float);
}

// the 64 segment ids of rows r0.. (0 past n, or when there are no ids)
__device__ __forceinline__ void load_ids(const int* ids, int* dst, int r0, int n, int nt) {
  for (int e = threadIdx.x; e < kTq; e += nt) dst[e] = ids && r0 + e < n ? ids[r0 + e] : 0;
}

template <typename T>
__global__ void __launch_bounds__(BwdCfg<T>::kThreads) flash_fwd_kernel(FlashArgs p) {
  constexpr int P = BwdCfg<T>::kPitch, NT = BwdCfg<T>::kThreads;
  constexpr int kLanes = NT / kTq, kCols = kTk / kLanes;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + kTq * P;
  T* Vs = Ks + kTk * P;
  T* Ps = Vs + kTk * P;
  float* Ss = reinterpret_cast<float*>(Ps + kTq * P);
  int* Kid = reinterpret_cast<int*>(Ss + kTq * kSP);

  const int q0 = blockIdx.x * kTq, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const size_t hoff = static_cast<size_t>(h) * kDh;
  const T* Q = static_cast<const T*>(p.q) + static_cast<size_t>(b) * p.Tq * p.D + hoff;
  const T* K = static_cast<const T*>(p.k) + static_cast<size_t>(b) * p.Tk * p.D + hoff;
  const T* V = static_cast<const T*>(p.v) + static_cast<size_t>(b) * p.Tk * p.D + hoff;
  const int* kv_ids = p.kv_ids ? p.kv_ids + static_cast<size_t>(b) * p.Tk : nullptr;

  load_rows(Q, Qs, q0, p.Tq, p.D, false, 1.f);
  // row ownership: kLanes neighbouring threads a row, kCols columns each
  const int r = tid / kLanes, c0 = (tid % kLanes) * kCols, qi = q0 + r;
  const int qid = p.q_ids && qi < p.Tq ? p.q_ids[static_cast<size_t>(b) * p.Tq + qi] : 0;
  const int nkt = key_tiles(p, q0);

  float m = -INFINITY, l = 0.f, acc[kCols], s[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;
  TileAcc<T> pv;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kTk;
    __syncthreads();
    load_rows(K, Ks, k0, p.Tk, p.D, false, 1.f);
    load_rows(V, Vs, k0, p.Tk, p.D, false, 1.f);
    load_ids(kv_ids, Kid, k0, p.Tk, NT);
    __syncthreads();
    tile_nt(Qs, Ks, Ss);
    __syncthreads();
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      s[j] = flash_score(Ss[r * kSP + c0 + j], p, qid, Kid[c0 + j], qi, k0 + c0 + j);
      mx = fmaxf(mx, s[j]);
    }
#pragma unroll
    for (int o = 1; o < kLanes; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, o));
    // the tile holds key k0 < Tk, whose score is finite: m_next is finite
    const float m_next = fmaxf(m, mx);
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float e = expf(s[j] - m_next);
      ps += e;
      Ps[r * P + c0 + j] = from_f<T>(e);
    }
#pragma unroll
    for (int o = 1; o < kLanes; o <<= 1) ps += __shfl_xor_sync(kFullMask, ps, o);
    const float l_corr = __fmul_rn(expf(m - m_next), l);
    const float l_next = __fadd_rn(ps, l_corr);
    const float inv = l_next == 0.f ? 1.f : 1.f / l_next;
    const float corr = __fmul_rn(l_corr, inv);
    m = m_next;
    l = l_next;
    __syncthreads();  // P complete, every score read
    pv.zero();
    pv.add(Ps, Vs);
    pv.store(Ss);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      acc[j] = __fadd_rn(__fmul_rn(acc[j], corr), __fmul_rn(Ss[r * kSP + c0 + j], inv));
  }
  if (qi < p.Tq) {
    T* o = static_cast<T*>(p.out) + (static_cast<size_t>(b) * p.Tq + qi) * p.D + hoff + c0;
#pragma unroll
    for (int j = 0; j < kCols; ++j) o[j] = from_f<T>(acc[j]);
    if (tid % kLanes == 0) {
      const size_t row = (static_cast<size_t>(b) * p.H + h) * p.Tq + qi;
      p.m[row] = m;
      p.l[row] = l;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(BwdCfg<T>::kThreads) flash_bwd_dq_kernel(FlashArgs p) {
  constexpr int P = BwdCfg<T>::kPitch, NT = BwdCfg<T>::kThreads;
  constexpr int kLanes = NT / kTq, kCols = kTk / kLanes;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + kTq * P;
  T* Ks = dOs + kTq * P;
  T* Vs = Ks + kTk * P;
  T* Ps = Vs + kTk * P;
  float* Ss = reinterpret_cast<float*>(Ps + kTq * P);
  float* Ds = Ss + kTq * kSP;
  int* Kid = reinterpret_cast<int*>(Ds + kTq * kSP);

  const int q0 = blockIdx.x * kTq, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const size_t hoff = static_cast<size_t>(h) * kDh;
  const T* Q = static_cast<const T*>(p.q) + static_cast<size_t>(b) * p.Tq * p.D + hoff;
  const T* dO = static_cast<const T*>(p.dout) + static_cast<size_t>(b) * p.Tq * p.D + hoff;
  const T* K = static_cast<const T*>(p.k) + static_cast<size_t>(b) * p.Tk * p.D + hoff;
  const T* V = static_cast<const T*>(p.v) + static_cast<size_t>(b) * p.Tk * p.D + hoff;
  const int* kv_ids = p.kv_ids ? p.kv_ids + static_cast<size_t>(b) * p.Tk : nullptr;

  load_rows(Q, Qs, q0, p.Tq, p.D, false, 1.f);
  load_rows(dO, dOs, q0, p.Tq, p.D, false, 1.f);
  const int r = tid / kLanes, c0 = (tid % kLanes) * kCols, qi = q0 + r;
  const bool in = qi < p.Tq;
  const size_t row = (static_cast<size_t>(b) * p.H + h) * p.Tq + qi;
  const int qid = p.q_ids && in ? p.q_ids[static_cast<size_t>(b) * p.Tq + qi] : 0;
  const float m = in ? p.m[row] : 0.f, linv = in ? 1.f / p.l[row] : 0.f, di = in ? p.di[row] : 0.f;
  const int nkt = key_tiles(p, q0);

  TileAcc<T> acc;
  acc.zero();
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * kTk;
    __syncthreads();
    load_rows(K, Ks, k0, p.Tk, p.D, false, 1.f);
    load_rows(V, Vs, k0, p.Tk, p.D, false, 1.f);
    load_ids(kv_ids, Kid, k0, p.Tk, NT);
    __syncthreads();
    tile_nt(Qs, Ks, Ss);
    tile_nt(dOs, Vs, Ds);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = c0 + j;
      float ds = 0.f;
      if (in) {
        const float pr = __fmul_rn(expf(flash_score(Ss[r * kSP + c], p, qid, Kid[c], qi, k0 + c) - m), linv);
        ds = __fmul_rn(__fmul_rn(__fsub_rn(Ds[r * kSP + c], di), pr), p.scale);
      }
      Ps[r * P + c] = from_f<T>(ds);
    }
    __syncthreads();
    acc.add(Ps, Ks);
  }
  __syncthreads();
  acc.store(Ss);
  __syncthreads();
  store_rows(Ss, static_cast<T*>(p.dq) + static_cast<size_t>(b) * p.Tq * p.D + hoff, q0, p.Tq,
             p.D, [](float x) { return from_f<T>(x); });
}

template <typename T>
__global__ void __launch_bounds__(BwdCfg<T>::kThreads) flash_bwd_dkv_kernel(FlashArgs p) {
  constexpr int P = BwdCfg<T>::kPitch, NT = BwdCfg<T>::kThreads;
  constexpr int kLanes = NT / kTk, kCols = kTq / kLanes;
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
  float* Linv = Ms + kTq;
  float* Dl = Linv + kTq;
  int* Qid = reinterpret_cast<int*>(Dl + kTq);

  const int k0 = blockIdx.x * kTk, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const size_t hoff = static_cast<size_t>(h) * kDh;
  const T* Q = static_cast<const T*>(p.q) + static_cast<size_t>(b) * p.Tq * p.D + hoff;
  const T* dO = static_cast<const T*>(p.dout) + static_cast<size_t>(b) * p.Tq * p.D + hoff;
  const T* K = static_cast<const T*>(p.k) + static_cast<size_t>(b) * p.Tk * p.D + hoff;
  const T* V = static_cast<const T*>(p.v) + static_cast<size_t>(b) * p.Tk * p.D + hoff;
  const int* q_ids = p.q_ids ? p.q_ids + static_cast<size_t>(b) * p.Tq : nullptr;
  const size_t srow = (static_cast<size_t>(b) * p.H + h) * p.Tq;

  load_rows(K, Ks, k0, p.Tk, p.D, false, 1.f);
  load_rows(V, Vs, k0, p.Tk, p.D, false, 1.f);
  // row ownership: a row is a key, its columns are the tile's queries
  const int r = tid / kLanes, c0 = (tid % kLanes) * kCols, key = k0 + r;
  const int kid = p.kv_ids && key < p.Tk ? p.kv_ids[static_cast<size_t>(b) * p.Tk + key] : 0;
  TileAcc<T> dk, dv;
  dk.zero();
  dv.zero();
  const int nqt = (p.Tq + kTq - 1) / kTq;
  // with the causal mask, query tiles above the diagonal see none of these keys
  for (int qt = p.causal ? k0 / kTq : 0; qt < nqt; ++qt) {
    const int q0 = qt * kTq;
    __syncthreads();
    load_rows(Q, Qs, q0, p.Tq, p.D, false, 1.f);
    load_rows(dO, dOs, q0, p.Tq, p.D, false, 1.f);
    for (int e = tid; e < kTq; e += NT) {
      const bool in = q0 + e < p.Tq;
      Ms[e] = in ? p.m[srow + q0 + e] : 0.f;
      Linv[e] = in ? 1.f / p.l[srow + q0 + e] : 0.f;
      Dl[e] = in ? p.di[srow + q0 + e] : 0.f;
    }
    load_ids(q_ids, Qid, q0, p.Tq, NT);
    __syncthreads();
    tile_nt(Ks, Qs, Ss);   // S^T: keys x queries
    tile_nt(Vs, dOs, Ds);  // dP^T
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = c0 + j, qi = q0 + c;
      float pr = 0.f, ds = 0.f;
      if (qi < p.Tq && key < p.Tk) {
        pr = __fmul_rn(expf(flash_score(Ss[r * kSP + c], p, Qid[c], kid, qi, key) - Ms[c]), Linv[c]);
        ds = __fmul_rn(__fmul_rn(__fsub_rn(Ds[r * kSP + c], Dl[c]), pr), p.scale);
      }
      Ps[r * P + c] = from_f<T>(pr);
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

// shared memory of each kernel: operand tiles, fp32 tiles, 64-vectors
template <typename T>
constexpr size_t kFwdSmem = flash_smem<T>(4, 1, 1);
template <typename T>
constexpr size_t kDqSmem = flash_smem<T>(5, 2, 1);
template <typename T>
constexpr size_t kDkvSmem = flash_smem<T>(6, 2, 4);

// raise the dynamic shared-memory limits once per process and type (not a
// stream operation, so a CUDA graph capture of a later call never sees it)
template <typename T>
cudaError_t configure() {
  static const cudaError_t configured = [] {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kFwdSmem<T>));
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(flash_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kDqSmem<T>));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(flash_bwd_dkv_kernel<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(kDkvSmem<T>));
  }();
  return configured;
}

template <typename T>
int launch_fwd(const FlashArgs& p, cudaStream_t s) {
  if (cudaError_t e = configure<T>(); e != cudaSuccess) return static_cast<int>(e);
  flash_fwd_kernel<T><<<dim3((p.Tq + kTq - 1) / kTq, p.H, p.B), BwdCfg<T>::kThreads,
                        kFwdSmem<T>, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const FlashArgs& p, cudaStream_t s) {
  if (cudaError_t e = configure<T>(); e != cudaSuccess) return static_cast<int>(e);
  constexpr int NT = BwdCfg<T>::kThreads;
  flash_bwd_dkv_kernel<T><<<dim3((p.Tk + kTk - 1) / kTk, p.H, p.B), NT, kDkvSmem<T>, s>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dq_kernel<T><<<dim3((p.Tq + kTq - 1) / kTq, p.H, p.B), NT, kDqSmem<T>, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace olm

extern "C" int olm_flash_fwd(const void* q, const void* k, const void* v, const int* q_ids,
                             const int* kv_ids, void* out, float* m, float* l, int B, int H,
                             int Tq, int Tk, int D, int causal, float scale, int dtype,
                             void* stream) {
  using namespace olm;
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || D != H * kDh || (!q_ids) != (!kv_ids))
    return cudaErrorInvalidValue;
  FlashArgs p{q, k, v, nullptr, q_ids, kv_ids, out, m, l, nullptr, nullptr, nullptr, nullptr,
              B, H, Tq, Tk, D, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return launch_fwd<__nv_bfloat16>(p, s);
  if (dtype == kF32) return launch_fwd<float>(p, s);
  return cudaErrorInvalidValue;
}

extern "C" int olm_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                             const int* q_ids, const int* kv_ids, const float* m, const float* l,
                             const float* di, void* dq, void* dk, void* dv, int B, int H, int Tq,
                             int Tk, int D, int causal, float scale, int dtype, void* stream) {
  using namespace olm;
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || D != H * kDh || (!q_ids) != (!kv_ids))
    return cudaErrorInvalidValue;
  FlashArgs p{q, k, v, dout, q_ids, kv_ids, nullptr, const_cast<float*>(m), const_cast<float*>(l),
              di, dq, dk, dv, B, H, Tq, Tk, D, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return launch_bwd<__nv_bfloat16>(p, s);
  if (dtype == kF32) return launch_bwd<float>(p, s);
  return cudaErrorInvalidValue;
}
