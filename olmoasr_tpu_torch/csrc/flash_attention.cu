// Online-softmax attention with segment ids, forward and backward: the port of
// the stock Pallas TPU flash attention that olmoasr_tpu/ops/flash.py::flash_mha
// calls (jax.experimental.pallas.ops.tpu.flash_attention: the forward kernel
// _flash_attention_kernel_single_batch, and the backward's
// _flash_attention_dkv_kernel and _flash_attention_dq_kernel).
//
// Per (batch, head), query row i, key tiles of 64 taken in order:
//   s   = fp32(q_i . k_j) * scale                  (q is not pre-scaled)
//   s  += -0.7 FLT_MAX where q_ids[i] != kv_ids[j], or causal and j > i
//   m'  = max(m, max_j s); p = exp(s - m'); c = exp(m - m') * l
//   l'  = sum_j p + c;     acc = acc * (c / l') + (round(p) . V) / l'
// round() is to the input type (bf16: before P.V on the tensor cores; fp32: a
// no-op). The forward writes o and the fp32 row max m and sum l, the residuals
// of the stock kernel. The backward first takes di = sum(o * do) in a pass
// of its own (the stock kernel takes it from XLA, outside its kernels):
//   p  = exp(s - m) * (1 / l); dp = do . v^T (fp32); ds = (dp - di) * p * scale
//   dv = round(p)^T . do; dk = round(ds)^T . q; dq = round(ds) . k
// Keys past Tk (the ragged last tile) are not keys: their p is 0. Key tiles
// wholly above the diagonal are skipped (the stock kernel's below_or_on_diag):
// there every score is masked and adds exp(mask - m) = 0.
//
// What bounds it: tensor-core FLOPs. At the encoder shape of small.en (B = 64,
// T = 1500, 12 heads of 64) the forward does 4 B H T^2 dh = 442 GFLOP of
// products per layer (0.447 ms at 989 TFLOP/s), against 4 x 147 MB of q, k,
// v and o (0.176 ms at 3.35 TB/s); the backward needs five products of
// 2 T^2 dh per (b, h) (S, dP, dV, dK, dQ) and does seven: the dq launch
// computes S and dP again. The di pass is bound by the bytes of o and do.
//
// bf16 runs on the register-resident mma.sync core of attention_mma.cuh (the
// training attention's, rows 3 and 9) under its flash score policy (kFlash):
// the forward is one block per 128 query rows of one (b, h), 8 warps of 16
// rows, Q fragments in registers, K, V and the kv ids streamed through a
// 2-stage cp.async ring, and the scores, the running max and sum, p and O in
// registers (p packed to bf16 straight into the P.V fragments; its exp is
// ex2.approx with the running max folded into one fma while |m| <= 64, the
// unfolded form past it, as for a row whose keys so far are all masked).
// The backward is the two launches of row 9 under the same policy: per 64
// query rows dq over the key tiles (S, dP and dQ: the statistics come from
// the forward, so row 9's first pass is not run), then per 64 keys dk and dv
// over the query tiles, with m, 1 / l, di and the q ids streamed beside Q and
// dO; the accurate expf, no atomics. fp32 runs the plain CUDA-core tiling
// below for exact-precision checks (no rounding on the route in fp32).
// Head width 64 only (every OLMoASR/Whisper size).
#include "attention_mma.cuh"
#include "attention_tiles.cuh"

namespace olm {
namespace {

// the fp32 kernels' arguments
struct FlashArgs {
  const float* q;      // (B, Tq, D), head h at columns h*64..
  const float* k;      // (B, Tk, D)
  const float* v;      // (B, Tk, D)
  const float* dout;   // (B, Tq, D) (backward)
  const int* q_ids;    // (B, Tq) segment ids, or null (no segment mask)
  const int* kv_ids;   // (B, Tk), null with q_ids
  float* out;          // (B, Tq, D) (forward)
  float* m;            // (B, H, Tq) row max: written by the forward, read by the backward
  float* l;            // (B, H, Tq) row sum
  const float* di;     // (B, H, Tq) sum(o * do) (backward)
  float* dq;           // (B, Tq, D)
  float* dk;           // (B, Tk, D)
  float* dv;           // (B, Tk, D)
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
  return keep ? s : __fadd_rn(s, mma::kFlashMask);
}

using T = float;
constexpr int P = BwdCfg<T>::kPitch, NT = BwdCfg<T>::kThreads;

constexpr size_t flash_smem(int operand_tiles, int score_tiles, int vectors) {
  return operand_tiles * kTq * P * sizeof(T) + score_tiles * kTq * kSP * sizeof(float) +
         vectors * kTq * sizeof(float);
}

// the 64 segment ids of rows r0.. (0 past n, or when there are no ids)
__device__ __forceinline__ void load_ids(const int* ids, int* dst, int r0, int n, int nt) {
  for (int e = threadIdx.x; e < kTq; e += nt) dst[e] = ids && r0 + e < n ? ids[r0 + e] : 0;
}

__global__ void __launch_bounds__(NT) flash_fwd_kernel(FlashArgs p) {
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
  const T* Q = p.q + static_cast<size_t>(b) * p.Tq * p.D + hoff;
  const T* K = p.k + static_cast<size_t>(b) * p.Tk * p.D + hoff;
  const T* V = p.v + static_cast<size_t>(b) * p.Tk * p.D + hoff;
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
    T* o = p.out + (static_cast<size_t>(b) * p.Tq + qi) * p.D + hoff + c0;
#pragma unroll
    for (int j = 0; j < kCols; ++j) o[j] = from_f<T>(acc[j]);
    if (tid % kLanes == 0) {
      const size_t row = (static_cast<size_t>(b) * p.H + h) * p.Tq + qi;
      p.m[row] = m;
      p.l[row] = l;
    }
  }
}

__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(FlashArgs p) {
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
  const T* Q = p.q + static_cast<size_t>(b) * p.Tq * p.D + hoff;
  const T* dO = p.dout + static_cast<size_t>(b) * p.Tq * p.D + hoff;
  const T* K = p.k + static_cast<size_t>(b) * p.Tk * p.D + hoff;
  const T* V = p.v + static_cast<size_t>(b) * p.Tk * p.D + hoff;
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
  store_rows(Ss, p.dq + static_cast<size_t>(b) * p.Tq * p.D + hoff, q0, p.Tq,
             p.D, [](float x) { return from_f<T>(x); });
}

__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(FlashArgs p) {
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
  const T* Q = p.q + static_cast<size_t>(b) * p.Tq * p.D + hoff;
  const T* dO = p.dout + static_cast<size_t>(b) * p.Tq * p.D + hoff;
  const T* K = p.k + static_cast<size_t>(b) * p.Tk * p.D + hoff;
  const T* V = p.v + static_cast<size_t>(b) * p.Tk * p.D + hoff;
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
  store_rows(Ss, p.dk + static_cast<size_t>(b) * p.Tk * p.D + hoff, k0, p.Tk,
             p.D, same);
  store_rows(Ds, p.dv + static_cast<size_t>(b) * p.Tk * p.D + hoff, k0, p.Tk,
             p.D, same);
}

// di[b, h, i] = sum_d o[b, i, h*64 + d] * do[b, i, h*64 + d] in fp32: L
// lanes a (row, head), 16 bytes of each a lane, summed by shuffles (a group
// never straddles a warp); bound by the bytes of o and do
template <typename E>
__global__ void __launch_bounds__(256) flash_di_kernel(const E* o, const E* dout, float* di, int H,
                                                       int Tq, long long pairs) {
  constexpr int V = 16 / sizeof(E), L = kDh / V;
  const long long e = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  const long long pair = e / L;  // (b * Tq + i) * H + h
  const int lane = static_cast<int>(e % L);
  float sum = 0.f;
  if (pair < pairs) {
    const size_t off = static_cast<size_t>(pair) * kDh + lane * V;
    alignas(16) E a[V], c[V];
    *reinterpret_cast<uint4*>(a) = *reinterpret_cast<const uint4*>(o + off);
    *reinterpret_cast<uint4*>(c) = *reinterpret_cast<const uint4*>(dout + off);
#pragma unroll
    for (int j = 0; j < V; ++j) sum += to_f(a[j]) * to_f(c[j]);
  }
#pragma unroll
  for (int d = L / 2; d > 0; d >>= 1) sum += __shfl_xor_sync(kFullMask, sum, d);
  if (pair < pairs && lane == 0) {
    const long long row = pair / H, b = row / Tq, i = row % Tq;
    di[(b * H + pair % H) * Tq + i] = sum;
  }
}

template <typename E>
int launch_di(const void* o, const void* dout, float* di, int B, int H, int Tq, cudaStream_t s) {
  constexpr int L = kDh / (16 / static_cast<int>(sizeof(E)));
  const long long pairs = static_cast<long long>(B) * Tq * H;
  flash_di_kernel<E><<<static_cast<unsigned>((pairs * L + 255) / 256), 256, 0, s>>>(
      static_cast<const E*>(o), static_cast<const E*>(dout), di, H, Tq, pairs);
  return static_cast<int>(cudaGetLastError());
}

// shared memory of each kernel: operand tiles, fp32 tiles, 64-vectors
constexpr size_t kFwdSmem = flash_smem(4, 1, 1);
constexpr size_t kDqSmem = flash_smem(5, 2, 1);
constexpr size_t kDkvSmem = flash_smem(6, 2, 4);

// raise the dynamic shared-memory limits once per process (not a stream
// operation, so a CUDA graph capture of a later call never sees it)
cudaError_t configure() {
  static const cudaError_t configured = [] {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kFwdSmem));
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kDqSmem));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(kDkvSmem));
  }();
  return configured;
}

int launch_fwd(const FlashArgs& p, cudaStream_t s) {
  if (cudaError_t e = configure(); e != cudaSuccess) return static_cast<int>(e);
  flash_fwd_kernel<<<dim3((p.Tq + kTq - 1) / kTq, p.H, p.B), NT, kFwdSmem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int launch_bwd(const FlashArgs& p, cudaStream_t s) {
  if (cudaError_t e = configure(); e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dkv_kernel<<<dim3((p.Tk + kTk - 1) / kTk, p.H, p.B), NT, kDkvSmem, s>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dq_kernel<<<dim3((p.Tq + kTq - 1) / kTq, p.H, p.B), NT, kDqSmem, s>>>(p);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    using mma::bf;
    mma::FwdParams p{static_cast<const bf*>(q), static_cast<const bf*>(k),
                     static_cast<const bf*>(v), nullptr, out, B, H, Tq, Tk, D, 0, causal, scale,
                     q_ids, kv_ids, m, l};
    return mma::launch_fwd<kDh, 1, mma::kFwdRows, mma::kStages, mma::kExp2 | mma::kFlash>(p, s);
  }
  if (dtype != kF32) return cudaErrorInvalidValue;
  FlashArgs p{static_cast<const float*>(q), static_cast<const float*>(k),
              static_cast<const float*>(v), nullptr, q_ids, kv_ids, static_cast<float*>(out),
              m, l, nullptr, nullptr, nullptr, nullptr, B, H, Tq, Tk, D, causal, scale};
  return launch_fwd(p, s);
}

// di: the (B, H, Tq) fp32 workspace of the di pass
extern "C" int olm_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const int* q_ids, const int* kv_ids, const float* m,
                             const float* l, float* di, void* dq, void* dk, void* dv, int B, int H,
                             int Tq, int Tk, int D, int causal, float scale, int dtype,
                             void* stream) {
  using namespace olm;
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || D != H * kDh || (!q_ids) != (!kv_ids))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != kBF16 && dtype != kF32) return cudaErrorInvalidValue;
  const int e = dtype == kBF16 ? launch_di<__nv_bfloat16>(o, dout, di, B, H, Tq, s)
                               : launch_di<float>(o, dout, di, B, H, Tq, s);
  if (e != cudaSuccess) return e;
  if (dtype == kBF16) {
    using mma::bf;
    const mma::FlashBwdParams p{
        {static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
         static_cast<const bf*>(dout), nullptr, static_cast<bf*>(dq), static_cast<bf*>(dk),
         static_cast<bf*>(dv), nullptr, B, H, Tq, Tk, D, 0, causal, scale},
        q_ids, kv_ids, m, l, di};
    return mma::launch_bwd<mma::kBwdRows, true>(p, s);
  }
  FlashArgs p{static_cast<const float*>(q), static_cast<const float*>(k),
              static_cast<const float*>(v), static_cast<const float*>(dout), q_ids, kv_ids,
              nullptr, const_cast<float*>(m), const_cast<float*>(l), di,
              static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv),
              B, H, Tq, Tk, D, causal, scale};
  return launch_bwd(p, s);
}
