// 64 x 64 tiles of the fp32 attention kernels (train_attention.cu,
// flash_attention.cu; their bf16 kernels run on attention_mma.cuh): the tile
// sizes, the block shape, loads and stores of one head's rows, and the two
// tile products on the CUDA cores, for exact-precision checks.
#pragma once

#include "common.cuh"

namespace olm {

constexpr int kTq = 64;  // query rows per block
constexpr int kTk = 64;  // keys per tile
constexpr int kDh = 64;  // head width (every OLMoASR/Whisper size)
constexpr int kSP = kTk + 4;  // fp32 row pitch of the score tile (272 bytes)

// Number of key tiles a query tile needs: with the causal mask, keys beyond the
// tile's last row are masked in every row and contribute exp(mask - m) = 0.
template <class Args>
__device__ __forceinline__ int key_tiles(const Args& p, int q0) {
  int n = (p.Tk + kTk - 1) / kTk;
  if (p.causal) n = min(n, (q0 + kTq + kTk - 1) / kTk);
  return n;
}

template <typename T>
struct BwdCfg;
template <>
struct BwdCfg<float> {
  static constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
  static constexpr int kPitch = kDh + 1;  // conflict-free column reads
};

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

// C (pitch kSP) = A . B^T for 64 x 64 operand tiles stored row-major
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

}  // namespace olm
