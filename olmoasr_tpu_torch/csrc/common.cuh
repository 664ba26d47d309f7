// Shared helpers for the hand-written Hopper kernels of olmoasr_tpu_torch.
//
// Every kernel library entry point has a plain C signature (bound from Python
// with ctypes), launches on the stream it is given, allocates nothing, and
// returns cudaGetLastError() so that a refused launch is reported at once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace olm {

// Element types, as the Python wrappers encode them.
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

// Signed byte j of w as an exact float, in two full-rate instructions (the
// integer-to-float conversion runs at a quarter of their rate): 2^23 + (b +
// 128) is a float whose low mantissa byte is b ^ 0x80.
__device__ __forceinline__ float int8_lane(uint32_t w, int j) {
  return __uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7540 + j)) - 8388736.0f;
}

// Shared-memory addresses and cp.async (sm_80 and later).
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(pred ? 16 : 0));
}

// 4 bytes global -> shared, asynchronously; zeros when !pred
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Distributed shared memory between the blocks of a cluster (sm_90): a
// sender stores straight into another rank's shared memory with st.async,
// which counts the bytes on that rank's mbarrier; the owner announces the
// bytes it expects and waits for the phase. Addresses are 32-bit shared
// ones (smem_u32).
__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_async(uint32_t addr, float4 v, uint32_t mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(mbar)
      : "memory");
}
__device__ __forceinline__ void expect_bytes(uint32_t mbar, int bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n"
      ::"r"(mbar), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void wait_phase(uint32_t mbar, int parity) {
  asm volatile(
      "{\n .reg .pred done;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT_%=;\n}\n"
      ::"r"(mbar), "r"(parity)
      : "memory");
}

// Exact (erf) GELU, as torch.nn.functional.gelu(approximate="none").
__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752440f));
}

}  // namespace olm
