// Skinny linear layer for the decode step: out = epilogue(A @ W^T), and the
// row LayerNorm that feeds it.
//
// Used by four ported TPU kernels (olmoasr_tpu/ops/attention.py):
//   * cross_block_decode (_cross_block_kernel): LN, then the q projection,
//     and the output projection + bias + residual;
//   * ln_matmul (_ln_matmul_kernel): LN, then the fused QKV projection with
//     N = 3D;
//   * in fp32 only (the checks; skinny_proj.cu takes their bf16 path):
//     mlp_block (_mlp_kernel): LN, then W1 + b1 + exact GELU, then W2 + b2 +
//     residual; matmul_residual (_matmul_residual_kernel): the
//     self-attention output projection + bias + residual.
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
// The block bodies, the LayerNorm and the precision contract are in
// skinny_linear.cuh, which layer_block.cu shares.
#include <algorithm>

#include "skinny_linear.cuh"

namespace olm {
namespace {

__global__ void __launch_bounds__(kLinThreads) linear_bf16_kernel(LinearArgs p) {
  linear_bf16_tile(p, blockIdx.x, blockIdx.y, blockIdx.z);
}

__global__ void __launch_bounds__(kLinThreads) linear_f32_kernel(LinearArgs p) {
  linear_f32_tile(p, blockIdx.x, blockIdx.y, blockIdx.z);
}

// Sum of the split partials, then the epilogue.
template <typename T>
__global__ void linear_epilogue_kernel(LinearArgs p, int splits) {
  const size_t total = static_cast<size_t>(p.M) * p.N;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x)
    store_epilogue<T>(p, static_cast<int>(i / p.N), static_cast<int>(i % p.N),
                      split_sum(p.ws, splits, total, i));
}

// LayerNorm of rows: one warp per row, 4 rows per block.
template <typename T>
__global__ void __launch_bounds__(128) layer_norm_kernel(const T* __restrict__ x,
                                                         const T* __restrict__ g,
                                                         const T* __restrict__ b,
                                                         T* __restrict__ out, int M, int K,
                                                         float eps) {
  const int m = blockIdx.x * 4 + threadIdx.x / 32;
  if (m >= M) return;
  layer_norm_row(x + static_cast<size_t>(m) * K, g, b, out + static_cast<size_t>(m) * K, K, eps);
}

}  // namespace
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
    linear_bf16_kernel<<<grid, kLinThreads, 0, s>>>(p);
  } else {
    dim3 grid((N + kFT - 1) / kFT, (M + kFT - 1) / kFT, eff);
    linear_f32_kernel<<<grid, kLinThreads, 0, s>>>(p);
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
