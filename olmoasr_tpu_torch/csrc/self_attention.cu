// Single-query self attention of one decode step over the read-only rings:
// replaces self_attend_decode (olmoasr_tpu/ops/attention.py:495,
// _self_decode_kernel with its body _self_decode_body; bf16 or fp32 rings).
//
// For batch row b and head h of layer `layer`, with offset valid positions:
//   logit[t] = (q_h * dh^-0.5) . k_ring[layer, b, t, h]     t < offset
//   logit_n  = (q_h * dh^-0.5) . k_new[b, h]                this step's key
//   w        = softmax over the offset + 1 logits            (fp32)
//   out_h    = sum_t w[t] v_ring[layer, b, t, h] + w_n v_new[b, h]
// The layer is chosen by pointer arithmetic on the stacked (L, B, C, D)
// rings: no per-layer copy. The rings are not written here; the caller writes
// k_new/v_new at position offset after the attention.
//
// What bounds it: the ring read, 2 * B * offset * D elements per layer and
// step (small.en, B = 64, offset 224, bf16: 44 MB per layer, a tenth of the
// cross read). It is the cross kernel's split-position pass
// (decode_attention.cuh) with the ring's row stride C, one kv row per query
// row, and the new key and value folded in by the combine launch. q, k_new and
// v_new are row views of the fused QKV projection: rows `row_stride` elements
// apart.
#include <type_traits>

#include "decode_attention.cuh"

// Scratch as olm_cross_attention: m_part and l_part B*H*nchunks floats,
// acc_part B*H*nchunks*dh, nchunks = olm_decode_attention_chunks(offset).
extern "C" int olm_self_attention(const void* q, const void* k_new, const void* v_new,
                                  long long row_stride, const void* k_ring, const void* v_ring,
                                  float* m_part, float* l_part, float* acc_part, void* out, int L,
                                  int layer, int B, int C, int offset, int D, int H, int dtype,
                                  float qscale, void* stream) {
  using namespace olm;
  if (B <= 0 || H <= 0 || D % H != 0 || layer < 0 || layer >= L || offset < 0 || offset > C)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t layer_elems = static_cast<size_t>(layer) * B * C * D;
  auto run = [&](auto* typed_out) -> int {
    using T = std::remove_pointer_t<decltype(typed_out)>;
    const T* ring_k = static_cast<const T*>(k_ring) + layer_elems;
    const T* ring_v = static_cast<const T*>(v_ring) + layer_elems;
    const int nchunks = (offset + kCaChunk - 1) / kCaChunk;
    const DecodeAttnArgs p{q, row_stride, ring_k, ring_v, nullptr, nullptr, m_part, l_part,
                           acc_part, offset, C, D, H, nchunks, 1, qscale};
    return launch_decode_attention<T>(p, B, static_cast<const T*>(k_new),
                                      static_cast<const T*>(v_new), row_stride, typed_out, s);
  };
  if (dtype == kBF16) return run(static_cast<__nv_bfloat16*>(out));
  if (dtype == kF32) return run(static_cast<float*>(out));
  return cudaErrorInvalidValue;
}
