// Device code of the fp32 skinny linear layer (out = epilogue(A @ W^T)) and
// the row LayerNorm that feeds it: the block bodies that linear.cu launches
// one kernel each, and that layer_block.cu runs as phases of one launch.
// fp32 only: they serve the exact checks of the decode kernels, not speed
// (every bf16 projection runs on skinny_proj.cu or decode_layer.cu).
//
// Shapes on the decode path: A is (M, K) with M = batch rows (64 at the
// slice's size), W is (N, K) in torch's (out, in) layout. Each block body
// computes one 32x32 output tile over one split of K: `split` names the
// split, whose fp32 partial goes to ws[split] when the product is split (the
// sum and the epilogue follow in another pass), or through the epilogue to
// `out` when it is not.
//
// LayerNorm: fp32 two-pass mean/variance per row, eps from the caller.
// Epilogue (fp32): + bias, optional GELU, optional + residual.
//
// The tile: a plain shared-memory tiled product on the CUDA cores (full
// fp32, as the TPU kernel's fp32 path), on 128 threads. Everything here has
// internal linkage: each .cu that includes it gets its own instantiations.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace olm {
namespace {

constexpr int kLinThreads = 128;

struct LinearArgs {
  const float* a;      // (M, K) activations
  const float* w;      // (N, K) weight
  const float* bias;   // (N,) or null
  const float* resid;  // (M, N), or null
  float* out;          // (M, N)
  float* ws;           // (splits, M, N) partials when split
  int M, N, K;
  int tiles_per_split;  // K tiles each split covers
  int split;            // nonzero: write partials, the epilogue pass follows
  int gelu;
};

__device__ __forceinline__ void store_epilogue(const LinearArgs& p, int m, int n, float v) {
  if (p.bias) v += p.bias[n];
  if (p.gelu) v = gelu_erf(v);
  const size_t i = static_cast<size_t>(m) * p.N + n;
  if (p.resid) v += p.resid[i];
  p.out[i] = v;
}

__device__ __forceinline__ void finish(const LinearArgs& p, int split, int m, int n, float v) {
  if (p.split)
    p.ws[(static_cast<size_t>(split) * p.M + m) * p.N + n] = v;
  else
    store_epilogue(p, m, n, v);
}

// Sum of the split partials of element i of the (M, N) output, in split order.
__device__ __forceinline__ float split_sum(const float* ws, int splits, size_t total, size_t i) {
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += ws[s * total + i];
  return v;
}

// ---------------------------------------------------------------------------
// fp32: 32x32 output tile per block, 128 threads of 4x2 outputs each.
// ---------------------------------------------------------------------------

constexpr int kFT = 32;

__device__ __forceinline__ void linear_f32_tile(const LinearArgs p, int bn, int bm, int split) {
  __shared__ float As[kFT][kFT + 1];
  __shared__ float Ws[kFT][kFT + 1];

  const float* A = p.a;
  const float* W = p.w;
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
      if (m < p.M && n < p.N) finish(p, split, m, n, acc[i][j]);
    }
}

// The tile body of an element type: fp32 only (bf16 products run on
// skinny_proj.cu and decode_layer.cu).
template <typename T>
__device__ __forceinline__ void linear_tile(const LinearArgs p, int bn, int bm, int split) {
  static_assert(std::is_same<T, float>::value, "the split-K tile is fp32 only");
  linear_f32_tile(p, bn, bm, split);
}

template <typename T>
constexpr int linear_k_tile() {
  static_assert(std::is_same<T, float>::value, "the split-K tile is fp32 only");
  return kFT;
}

// Output tiles of an (M, N) product: 32x32.
__host__ __device__ __forceinline__ int linear_tiles(int M, int N) {
  return ((N + kFT - 1) / kFT) * ((M + kFT - 1) / kFT);
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
