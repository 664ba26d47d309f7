// Skinny linear layer for the decode step: out = epilogue(A @ W^T), and the
// row LayerNorm that feeds it.
//
// Used by four ported TPU kernels (olmoasr_tpu/ops/attention.py):
//   * mlp_block (_mlp_kernel): LN, then W1 + b1 + exact GELU, then W2 + b2 +
//     residual;
//   * cross_block_decode (_cross_block_kernel): LN, then the q projection,
//     and the output projection + bias + residual;
//   * ln_matmul (_ln_matmul_kernel): LN, then the fused QKV projection with
//     N = 3D;
//   * matmul_residual (_matmul_residual_kernel): the self-attention output
//     projection + bias + residual.
//
// Shapes on the decode path: A is (B, K) with B = batch rows (64 at the
// slice's size), W is (N, K) in torch's (out, in) layout. At B = 64 the
// products are bound by the weight bytes (small.en MLP: 9.4 MB per layer in
// bf16), not by FLOPs. A 32x32 output tile per block gives too few blocks to
// keep the card's memory busy (48 for a 768x768 weight), so the wrapper
// splits K over a third grid dimension until about two blocks sit on every
// SM; each split writes an fp32 partial and a second launch sums the partials
// and applies the epilogue. Without a split the epilogue runs in place.
//
// LayerNorm: fp32 two-pass mean/variance per row, eps from the caller, result
// rounded to the weight type (the TPU kernels cast h to the weight dtype
// before their dots). Epilogue (fp32): + bias, optional GELU, optional +
// residual, one rounding at the store (fp32 or the weight type).
//
// bf16: WMMA 16x16x16 tensor-core tiles with fp32 accumulation; the next K
// tile is fetched into registers while the current one is multiplied.
// fp32: a plain shared-memory tiled product on the CUDA cores (full fp32, as
// the TPU kernel's fp32 path; used for checks, not for speed).
#include <mma.h>

#include <algorithm>

#include "common.cuh"

namespace olm {

struct LinearArgs {
  const void* a;      // (M, K) activations, weight type
  const void* w;      // (N, K) weight
  const void* bias;   // (N,) or null
  const void* resid;  // (M, N) weight type, or null
  void* out;          // (M, N) fp32 or weight type
  float* ws;          // (splits, M, N) fp32 partials when split
  int M, N, K;
  int tiles_per_split;  // K tiles each split covers
  int split;            // nonzero: write partials, the epilogue launch follows
  int out_f32;
  int gelu;
};

template <typename T>
__device__ __forceinline__ void store_epilogue(const LinearArgs& p, int m, int n, float v) {
  if (p.bias) v += to_f(static_cast<const T*>(p.bias)[n]);
  if (p.gelu) v = gelu_erf(v);
  const size_t i = static_cast<size_t>(m) * p.N + n;
  if (p.resid) v += to_f(static_cast<const T*>(p.resid)[i]);
  if (p.out_f32)
    static_cast<float*>(p.out)[i] = v;
  else
    static_cast<T*>(p.out)[i] = from_f<T>(v);
}

template <typename T>
__device__ __forceinline__ void finish(const LinearArgs& p, int m, int n, float v) {
  if (p.split)
    p.ws[(static_cast<size_t>(blockIdx.z) * p.M + m) * p.N + n] = v;
  else
    store_epilogue<T>(p, m, n, v);
}

// ---------------------------------------------------------------------------
// bf16: 32x32 output tile per block, 4 warps of one 16x16 WMMA tile each.
// ---------------------------------------------------------------------------

constexpr int kBM = 32, kBN = 32, kBK = 64;
constexpr int kBKP = kBK + 8;  // padded row (144 bytes): 16-byte chunks, 32-byte WMMA rows
constexpr int kBCP = kBN + 4;

__global__ void __launch_bounds__(128) linear_bf16_kernel(LinearArgs p) {
  using bf = __nv_bfloat16;
  using namespace nvcuda;
  __shared__ __align__(128) bf As[kBM][kBKP];
  __shared__ __align__(128) bf Ws[kBN][kBKP];
  __shared__ __align__(128) float Cs[kBM][kBCP];

  const bf* A = static_cast<const bf*>(p.a);
  const bf* W = static_cast<const bf*>(p.w);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, warp = tid / 32;
  const int kt0 = blockIdx.z * p.tiles_per_split;
  const int kt1 = min((p.K + kBK - 1) / kBK, kt0 + p.tiles_per_split);

  // A tile and W tile: 32 rows x 64 columns = 256 chunks of 8 bf16 each,
  // two chunks per thread. K is a multiple of 8 (checked by the caller), so
  // a chunk lies wholly inside or wholly outside the matrix.
  uint4 ra[2], rw[2];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * 128, r = c / 8, k = k0 + (c % 8) * 8;
      const int m = m0 + r, n = n0 + r;
      ra[i] = make_uint4(0, 0, 0, 0);
      rw[i] = make_uint4(0, 0, 0, 0);
      if (m < p.M && k < p.K)
        ra[i] = *reinterpret_cast<const uint4*>(A + static_cast<size_t>(m) * p.K + k);
      if (n < p.N && k < p.K)
        rw[i] = *reinterpret_cast<const uint4*>(W + static_cast<size_t>(n) * p.K + k);
    }
  };

  const int wm = (warp / 2) * 16, wn = (warp % 2) * 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.0f);
  if (kt0 < kt1) fetch(kt0 * kBK);
  for (int kt = kt0; kt < kt1; ++kt) {
    __syncthreads();  // the previous tile's products are done with As/Ws
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * 128, r = c / 8, col = (c % 8) * 8;
      *reinterpret_cast<uint4*>(&As[r][col]) = ra[i];
      *reinterpret_cast<uint4*>(&Ws[r][col]) = rw[i];
    }
    __syncthreads();
    if (kt + 1 < kt1) fetch((kt + 1) * kBK);  // in flight during the products
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, &As[wm][kk], kBKP);
      wmma::load_matrix_sync(fb, &Ws[wn][kk], kBKP);
      wmma::mma_sync(acc, fa, fb, acc);
    }
  }
  wmma::store_matrix_sync(&Cs[wm][wn], acc, kBCP, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < kBM * kBN; i += 128) {
    const int r = i / kBN, c = i % kBN, m = m0 + r, n = n0 + c;
    if (m < p.M && n < p.N) finish<bf>(p, m, n, Cs[r][c]);
  }
}

// ---------------------------------------------------------------------------
// fp32: 32x32 output tile per block, 256 threads of 2x2 outputs each.
// ---------------------------------------------------------------------------

constexpr int kFT = 32;

__global__ void __launch_bounds__(256) linear_f32_kernel(LinearArgs p) {
  __shared__ float As[kFT][kFT + 1];
  __shared__ float Ws[kFT][kFT + 1];

  const float* A = static_cast<const float*>(p.a);
  const float* W = static_cast<const float*>(p.w);
  const int m0 = blockIdx.y * kFT, n0 = blockIdx.x * kFT;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int kt0 = blockIdx.z * p.tiles_per_split;
  const int kt1 = min((p.K + kFT - 1) / kFT, kt0 + p.tiles_per_split);

  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * kFT;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tid + i * 256, r = c / kFT, col = c % kFT, k = k0 + col;
      const int m = m0 + r, n = n0 + r;
      As[r][col] = m < p.M && k < p.K ? A[static_cast<size_t>(m) * p.K + k] : 0.f;
      Ws[r][col] = n < p.N && k < p.K ? W[static_cast<size_t>(n) * p.K + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kFT; ++kk) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) acc[i][j] += As[ty + 16 * i][kk] * Ws[tx + 16 * j][kk];
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m < p.M && n < p.N) finish<float>(p, m, n, acc[i][j]);
    }
}

// Sum of the split partials, then the epilogue.
template <typename T>
__global__ void linear_epilogue_kernel(LinearArgs p, int splits) {
  const size_t total = static_cast<size_t>(p.M) * p.N;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += p.ws[s * total + i];
    store_epilogue<T>(p, static_cast<int>(i / p.N), static_cast<int>(i % p.N), v);
  }
}

// ---------------------------------------------------------------------------
// LayerNorm of rows: one warp per row, 4 rows per block.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(128) layer_norm_kernel(const T* __restrict__ x,
                                                         const T* __restrict__ g,
                                                         const T* __restrict__ b,
                                                         T* __restrict__ out, int M, int K,
                                                         float eps) {
  const int m = blockIdx.x * 4 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (m >= M) return;
  const T* row = x + static_cast<size_t>(m) * K;
  float s = 0.f;
  for (int k = lane; k < K; k += 32) s += to_f(row[k]);
  const float mean = warp_sum(s) / K;
  float v = 0.f;
  for (int k = lane; k < K; k += 32) {
    const float d = to_f(row[k]) - mean;
    v += d * d;
  }
  const float rstd = 1.0f / sqrtf(warp_sum(v) / K + eps);
  T* o = out + static_cast<size_t>(m) * K;
  for (int k = lane; k < K; k += 32)
    o[k] = from_f<T>((to_f(row[k]) - mean) * rstd * to_f(g[k]) + to_f(b[k]));
}

}  // namespace olm

static int k_tile(int dtype) { return dtype == olm::kBF16 ? olm::kBK : olm::kFT; }

// `ws` holds `splits` fp32 (M, N) partials; each split covers
// ceil(tiles / splits) K tiles, so fewer splits than asked may be used.
extern "C" int olm_linear(const void* a, const void* w, const void* bias, const void* resid,
                          void* out, float* ws, int M, int N, int K, int splits, int dtype,
                          int out_f32, int gelu, void* stream) {
  using namespace olm;
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 != 0 || splits <= 0) return cudaErrorInvalidValue;
  if (dtype != kBF16 && dtype != kF32) return cudaErrorInvalidValue;
  const int tiles = (K + k_tile(dtype) - 1) / k_tile(dtype);
  const int per = (tiles + splits - 1) / splits;
  const int eff = (tiles + per - 1) / per;
  if (eff > 1 && ws == nullptr) return cudaErrorInvalidValue;
  LinearArgs p{a, w, bias, resid, out, ws, M, N, K, per, eff > 1, out_f32, gelu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, eff);
    linear_bf16_kernel<<<grid, 128, 0, s>>>(p);
  } else {
    dim3 grid((N + kFT - 1) / kFT, (M + kFT - 1) / kFT, eff);
    linear_f32_kernel<<<grid, 256, 0, s>>>(p);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || eff == 1) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(M) * N;
  const int blocks = static_cast<int>(std::min<size_t>((total + 255) / 256, 4096));
  if (dtype == kBF16)
    linear_epilogue_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(p, eff);
  else
    linear_epilogue_kernel<float><<<blocks, 256, 0, s>>>(p, eff);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int olm_layer_norm(const void* x, const void* g, const void* b, void* out, int M,
                              int K, float eps, int dtype, void* stream) {
  using namespace olm;
  if (M <= 0 || K <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (M + 3) / 4;
  if (dtype == kBF16) {
    using bf = __nv_bfloat16;
    layer_norm_kernel<bf><<<blocks, 128, 0, s>>>(static_cast<const bf*>(x),
                                                 static_cast<const bf*>(g),
                                                 static_cast<const bf*>(b), static_cast<bf*>(out),
                                                 M, K, eps);
  } else if (dtype == kF32) {
    layer_norm_kernel<float><<<blocks, 128, 0, s>>>(static_cast<const float*>(x),
                                                    static_cast<const float*>(g),
                                                    static_cast<const float*>(b),
                                                    static_cast<float*>(out), M, K, eps);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* olm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
