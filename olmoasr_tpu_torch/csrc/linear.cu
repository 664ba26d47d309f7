// fp32 skinny linear layer for the decode kernels' exact checks: out =
// epilogue(A @ W^T), and the row LayerNorm that feeds it.
//
// Serves the fp32 path (the checks, not speed) of four ported TPU kernels
// (olmoasr_tpu/ops/attention.py): cross_block_decode (LN, the q projection,
// the output projection + bias + residual), ln_matmul (LN, the fused QKV
// projection with N = 3D), mlp_block (LN, W1 + b1 + exact GELU, W2 + b2 +
// residual) and matmul_residual (the output projection + bias + residual).
// Their bf16 paths, the decode step's, run on skinny_proj.cu; olm_linear and
// olm_layer_norm refuse bf16.
//
// Shapes on the decode path: A is (B, K) with B = batch rows (64 at the
// slice's size), W is (N, K) in torch's (out, in) layout. A 32x32 output
// tile per block gives few blocks (48 for a 768x768 weight at 64 rows), so
// the wrapper splits K over a third grid dimension until about two blocks
// sit on every SM; each split writes an fp32 partial and a second launch
// sums the partials and applies the epilogue. Without a split the epilogue
// runs in place.
//
// The block bodies, the LayerNorm and the precision contract are in
// skinny_linear.cuh, which layer_block.cu shares.
#include <algorithm>

#include "skinny_linear.cuh"

namespace olm {
namespace {

__global__ void __launch_bounds__(kLinThreads) linear_f32_kernel(LinearArgs p) {
  linear_f32_tile(p, blockIdx.x, blockIdx.y, blockIdx.z);
}

// Sum of the split partials, then the epilogue.
__global__ void linear_epilogue_kernel(LinearArgs p, int splits) {
  const size_t total = static_cast<size_t>(p.M) * p.N;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x)
    store_epilogue(p, static_cast<int>(i / p.N), static_cast<int>(i % p.N),
                   split_sum(p.ws, splits, total, i));
}

// LayerNorm of rows: one warp per row, 4 rows per block.
__global__ void __launch_bounds__(128) layer_norm_kernel(const float* __restrict__ x,
                                                         const float* __restrict__ g,
                                                         const float* __restrict__ b,
                                                         float* __restrict__ out, int M, int K,
                                                         float eps) {
  const int m = blockIdx.x * 4 + threadIdx.x / 32;
  if (m >= M) return;
  layer_norm_row(x + static_cast<size_t>(m) * K, g, b, out + static_cast<size_t>(m) * K, K, eps);
}

}  // namespace
}  // namespace olm

// fp32 throughout (dtype must be the fp32 code; bf16 is refused). `ws`
// holds `splits` fp32 (M, N) partials; each split covers ceil(tiles /
// splits) K tiles, so fewer splits than asked may be used.
extern "C" int olm_linear(const void* a, const void* w, const void* bias, const void* resid,
                          void* out, float* ws, int M, int N, int K, int splits, int dtype,
                          int gelu, void* stream) {
  using namespace olm;
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 != 0 || splits <= 0 || dtype != kF32)
    return cudaErrorInvalidValue;
  const int tiles = (K + kFT - 1) / kFT;
  const int per = (tiles + splits - 1) / splits;
  const int eff = (tiles + per - 1) / per;
  if (eff > 1 && ws == nullptr) return cudaErrorInvalidValue;
  LinearArgs p{static_cast<const float*>(a), static_cast<const float*>(w),
               static_cast<const float*>(bias), static_cast<const float*>(resid),
               static_cast<float*>(out), ws, M, N, K, per, eff > 1, gelu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  linear_f32_kernel<<<dim3((N + kFT - 1) / kFT, (M + kFT - 1) / kFT, eff), kLinThreads, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || eff == 1) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(M) * N;
  const int blocks = static_cast<int>(std::min<size_t>((total + 255) / 256, 4096));
  linear_epilogue_kernel<<<blocks, 256, 0, s>>>(p, eff);
  return static_cast<int>(cudaGetLastError());
}

// fp32 only (dtype must be the fp32 code; bf16 is refused).
extern "C" int olm_layer_norm(const void* x, const void* g, const void* b, void* out, int M,
                              int K, float eps, int dtype, void* stream) {
  using namespace olm;
  if (M <= 0 || K <= 0 || dtype != kF32) return cudaErrorInvalidValue;
  layer_norm_kernel<<<(M + 3) / 4, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(g), static_cast<const float*>(b),
      static_cast<float*>(out), M, K, eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* olm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
