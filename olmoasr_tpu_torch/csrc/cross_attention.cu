// Single-query cross attention over the cached audio keys/values: the
// attention core of cross_block_decode (olmoasr_tpu/ops/attention.py,
// _cross_block_kernel, non-transposed keys, kv_group query rows per cache
// row).
//
// For query row b and head h, with q already projected (fp32, bias added):
//   logit[t] = (q_h * dh^-0.5) . k[b / G, t, h] * ks[b / G, t]
//   w        = softmax_t(logit)            (fp32)
//   attn_h   = sum_t w[t] * vs[b / G, t] * v[b / G, t, h]
// K/V are bf16, fp32 or int8 with per-position fp32 scales (ones when the
// cache is not quantized). q stays unquantized: the TPU kernel's int8 q.K
// product (q quantized per head) is a matrix-unit rate device, and the port
// keeps the exact product of its fp32 path.
//
// What bounds it: every decode step reads the whole cross cache of every
// layer, B * T * D * 2 elements per layer for B cache rows (small.en, B = 64,
// T = 1500, D = 768, bf16: 295 MB per layer). With G query rows per cache
// row (best_of samples, beams) the G rows' blocks are grid neighbours and
// share the read through L2, so device memory still sees B rows, not B * G.
// The split-position design (decode_attention.cuh) spreads the read over
// every SM: one block per (128-key chunk, head, query row) -- 9216 blocks at
// B = 64 -- and a combine launch.
#include "decode_attention.cuh"

// Scratch: m_part and l_part hold B*H*nchunks floats, acc_part B*H*nchunks*dh,
// with nchunks = olm_decode_attention_chunks(T), B = query rows. K and V rows
// must be 16-byte aligned.
extern "C" int olm_decode_attention_chunks(int T) {
  return (T + olm::kCaChunk - 1) / olm::kCaChunk;
}

extern "C" int olm_cross_attention(const float* q, const void* k, const void* v, const float* ks,
                                   const float* vs, float* m_part, float* l_part,
                                   float* acc_part, void* out, int B, int T, int D, int H,
                                   int kv_group, int kv_dtype, int out_dtype, float qscale,
                                   void* stream) {
  using namespace olm;
  if (B <= 0 || T <= 0 || H <= 0 || D % H != 0) return cudaErrorInvalidValue;
  const DecodeAttnArgs p{q,     D,     k, v, ks, vs, m_part, l_part, acc_part, T, T, D, H,
                         olm_decode_attention_chunks(T), kv_group, qscale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* none = nullptr;  // no new key: cross attention sees the cache only
  auto run = [&](auto* o) -> int {
    if (kv_dtype == kBF16)
      return launch_decode_attention<__nv_bfloat16>(p, B, none, none, 0, o, s);
    if (kv_dtype == kF32) return launch_decode_attention<float>(p, B, none, none, 0, o, s);
    if (kv_dtype == kI8) return launch_decode_attention<int8_t>(p, B, none, none, 0, o, s);
    return cudaErrorInvalidValue;
  };
  if (out_dtype == kBF16) return run(static_cast<__nv_bfloat16*>(out));
  if (out_dtype == kF32) return run(static_cast<float*>(out));
  return cudaErrorInvalidValue;
}
