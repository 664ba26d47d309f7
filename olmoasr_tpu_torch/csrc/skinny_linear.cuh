// Device code of the skinny linear layer (out = epilogue(A @ W^T)) and the
// row LayerNorm that feeds it: the block bodies that linear.cu launches one
// kernel each, and that layer_block.cu runs as phases of one launch.
//
// Shapes on the decode path: A is (M, K) with M = batch rows (64 at the
// slice's size), W is (N, K) in torch's (out, in) layout. Each block body
// computes one 32x32 output tile over one split of K: `split` names the
// split, whose fp32 partial goes to ws[split] when the product is split (the
// sum and the epilogue follow in another pass), or through the epilogue to
// `out` when it is not.
//
// LayerNorm: fp32 two-pass mean/variance per row, eps from the caller, result
// rounded to the output type (the TPU kernels cast h to the weight dtype
// before their dots). Epilogue (fp32): + bias, optional GELU, optional +
// residual, one rounding at the store (fp32 or the weight type).
//
// bf16: WMMA 16x16x16 tensor-core tiles with fp32 accumulation; the next K
// tile is fetched into registers while the current one is multiplied.
// fp32: a plain shared-memory tiled product on the CUDA cores (full fp32, as
// the TPU kernel's fp32 path; used for checks, not for speed).
//
// Both tile bodies run on 128 threads. Everything here has internal linkage:
// each .cu that includes it gets its own instantiations.
#pragma once

#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace olm {
namespace {

constexpr int kLinThreads = 128;

struct LinearArgs {
  const void* a;      // (M, K) activations, weight type
  const void* w;      // (N, K) weight
  const void* bias;   // (N,) or null
  const void* resid;  // (M, N) weight type, or null
  void* out;          // (M, N) fp32 or weight type
  float* ws;          // (splits, M, N) fp32 partials when split
  int M, N, K;
  int tiles_per_split;  // K tiles each split covers
  int split;            // nonzero: write partials, the epilogue pass follows
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
__device__ __forceinline__ void finish(const LinearArgs& p, int split, int m, int n, float v) {
  if (p.split)
    p.ws[(static_cast<size_t>(split) * p.M + m) * p.N + n] = v;
  else
    store_epilogue<T>(p, m, n, v);
}

// Sum of the split partials of element i of the (M, N) output, in split order.
__device__ __forceinline__ float split_sum(const float* ws, int splits, size_t total, size_t i) {
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += ws[s * total + i];
  return v;
}

// ---------------------------------------------------------------------------
// bf16: 32x32 output tile per block, 4 warps of one 16x16 WMMA tile each.
// ---------------------------------------------------------------------------

constexpr int kBM = 32, kBN = 32, kBK = 64;
constexpr int kBKP = kBK + 8;  // padded row (144 bytes): 16-byte chunks, 32-byte WMMA rows
constexpr int kBCP = kBN + 4;

// Output tile (bn, bm) over K split `split`.
__device__ __forceinline__ void linear_bf16_tile(const LinearArgs p, int bn, int bm, int split) {
  using bf = __nv_bfloat16;
  using namespace nvcuda;
  __shared__ __align__(128) bf As[kBM][kBKP];
  __shared__ __align__(128) bf Ws[kBN][kBKP];
  __shared__ __align__(128) float Cs[kBM][kBCP];

  const bf* A = static_cast<const bf*>(p.a);
  const bf* W = static_cast<const bf*>(p.w);
  const int m0 = bm * kBM, n0 = bn * kBN;
  const int tid = threadIdx.x, warp = tid / 32;
  const int kt0 = split * p.tiles_per_split;
  const int kt1 = min((p.K + kBK - 1) / kBK, kt0 + p.tiles_per_split);

  // A tile and W tile: 32 rows x 64 columns = 256 chunks of 8 bf16 each,
  // two chunks per thread. K is a multiple of 8 (checked by the caller), so
  // a chunk lies wholly inside or wholly outside the matrix.
  uint4 ra[2], rw[2];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kLinThreads, r = c / 8, k = k0 + (c % 8) * 8;
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
  __syncthreads();  // a previous tile of this block is done with Cs
  for (int kt = kt0; kt < kt1; ++kt) {
    __syncthreads();  // the previous K tile's products are done with As/Ws
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kLinThreads, r = c / 8, col = (c % 8) * 8;
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
  for (int i = tid; i < kBM * kBN; i += kLinThreads) {
    const int r = i / kBN, c = i % kBN, m = m0 + r, n = n0 + c;
    if (m < p.M && n < p.N) finish<bf>(p, split, m, n, Cs[r][c]);
  }
}

// ---------------------------------------------------------------------------
// fp32: 32x32 output tile per block, 128 threads of 4x2 outputs each.
// ---------------------------------------------------------------------------

constexpr int kFT = 32;

__device__ __forceinline__ void linear_f32_tile(const LinearArgs p, int bn, int bm, int split) {
  __shared__ float As[kFT][kFT + 1];
  __shared__ float Ws[kFT][kFT + 1];

  const float* A = static_cast<const float*>(p.a);
  const float* W = static_cast<const float*>(p.w);
  const int m0 = bm * kFT, n0 = bn * kFT;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int kt0 = split * p.tiles_per_split;
  const int kt1 = min((p.K + kFT - 1) / kFT, kt0 + p.tiles_per_split);

  float acc[4][2] = {};
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * kFT;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kFT * kFT / kLinThreads; ++i) {
      const int c = tid + i * kLinThreads, r = c / kFT, col = c % kFT, k = k0 + col;
      const int m = m0 + r, n = n0 + r;
      As[r][col] = m < p.M && k < p.K ? A[static_cast<size_t>(m) * p.K + k] : 0.f;
      Ws[r][col] = n < p.N && k < p.K ? W[static_cast<size_t>(n) * p.K + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kFT; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) acc[i][j] += As[ty + 8 * i][kk] * Ws[tx + 16 * j][kk];
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = m0 + ty + 8 * i, n = n0 + tx + 16 * j;
      if (m < p.M && n < p.N) finish<float>(p, split, m, n, acc[i][j]);
    }
}

template <typename T>
__device__ __forceinline__ void linear_tile(const LinearArgs p, int bn, int bm, int split) {
  if constexpr (std::is_same<T, float>::value)
    linear_f32_tile(p, bn, bm, split);
  else
    linear_bf16_tile(p, bn, bm, split);
}

template <typename T>
constexpr int linear_k_tile() {
  return std::is_same<T, float>::value ? kFT : kBK;
}

// Output tiles of an (M, N) product: 32x32 for both types.
__host__ __device__ __forceinline__ int linear_tiles(int M, int N) {
  return ((N + kBN - 1) / kBN) * ((M + kBM - 1) / kBM);
}

// ---------------------------------------------------------------------------
// LayerNorm of one row by one warp.
// ---------------------------------------------------------------------------

template <typename In, typename Out>
__device__ __forceinline__ void layer_norm_row(const In* __restrict__ row, const Out* __restrict__ g,
                                               const Out* __restrict__ b, Out* __restrict__ o,
                                               int K, float eps) {
  const int lane = threadIdx.x % 32;
  float s = 0.f;
  for (int k = lane; k < K; k += 32) s += to_f(row[k]);
  const float mean = warp_sum(s) / K;
  float v = 0.f;
  for (int k = lane; k < K; k += 32) {
    const float d = to_f(row[k]) - mean;
    v += d * d;
  }
  const float rstd = 1.0f / sqrtf(warp_sum(v) / K + eps);
  for (int k = lane; k < K; k += 32)
    o[k] = from_f<Out>((to_f(row[k]) - mean) * rstd * to_f(g[k]) + to_f(b[k]));
}

}  // namespace
}  // namespace olm
