// Single-query self attention of one decode step over the read-only rings:
// replaces self_attend_decode (olmoasr_tpu/ops/attention.py:495,
// _self_decode_kernel with its body _self_decode_body over bf16 or fp32
// rings, _self_decode_kernel_q8 over int8 rings, and the beam-search variant
// _self_decode_kernel_beam with _anc_kv_select).
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
// cross read). q, k_new and v_new are row views of the fused QKV projection:
// rows `row_stride` elements apart.
//
// Without ancestry the rings of every type run on the single-pass core of
// decode_attention.cuh (one launch: the ring's positions of a (row, head)
// pair split over the blocks of one cluster, merged in distributed shared
// memory in rank order; rank 0 folds in the new key and value, the key's
// logit from the unrounded q; no partials in device memory), with the
// ring's row stride C. Beam ancestry keeps the split-position pass and its
// combine launch, which folds in the new key and value.
//
// bf16 and fp32 rings: every product fp32 (kRound = 0).
//
// int8 rings (the JAX package's init_cache(quantize_self=True); replaces
// _self_decode_kernel_q8): ks/vs are the rings' (L, B, 1, C) fp32
// per-position scales, read at this layer's (B, C) block. The ring logit is
// the TPU kernel's _qk_logits times ks[t] (under bf16 activations q rounded
// per head to int8 and an s32 __dp4a product; under fp32 the exact one),
// vs[t] folds into the weight, and under bf16 the weight is rounded to bf16
// before the value product (kRound = 1), as _self_decode_body rounds w_old to
// its dot dtype. This step's own key and value are not quantized (the
// caller quantizes them into the ring afterwards): rank 0 takes their logit
// from the unrounded fp32 q, as the TPU body does. The ring read halves
// against bf16 (B * offset * D bytes for each ring, plus 4 bytes a position
// of scales).
//
// Beam search (anc non-null): the rings are never reordered when beams are
// re-ranked. anc (B, C) int32 names, for row b and position t, the ring row
// within b's group of beam_k rows that holds its key and value:
//   k_eff[b, t] = k_ring[layer, (b / beam_k) * beam_k + anc[b, t], t]
// Each block loads its chunk's 128 entries into shared memory once and reads
// every key's head slice from its own ring row, still 16 bytes a lane. The
// beam_k rows of a group are neighbours in the grid's fastest dimension (the
// kv_group layout of the cross pass), so their blocks run together and read
// mostly the same ancestor rows, the repeats from L2: device memory sees each
// group's rings about once, the bytes of the pass without ancestry.
#include <type_traits>

#include "decode_attention.cuh"

namespace olm {
namespace {

// The split-position pass with ancestry: ring elements and activations (q,
// k_new, v_new, out) T.
template <typename T>
int self_attention_beam(DecodeAttnArgs p, const void* k_ring, const void* v_ring,
                        size_t layer_elems, const void* k_new, const void* v_new,
                        long long row_stride, void* out, int B, cudaStream_t s) {
  p.k = static_cast<const T*>(k_ring) + layer_elems;
  p.v = static_cast<const T*>(v_ring) + layer_elems;
  return launch_decode_attention<T>(p, B, static_cast<const T*>(k_new),
                                    static_cast<const T*>(v_new), row_stride,
                                    static_cast<T*>(out), s);
}

// The single-pass core over the rings without ancestry (kv_dtype: the
// activation type, or int8 with this layer's scales); slices as
// onepass::launch's.
int self_attend(const void* q, const void* k_new, const void* v_new, long long row_stride,
                const void* k_ring, const void* v_ring, const float* ks, const float* vs,
                size_t layer_rows, void* out, int B, int C, int offset, int D, int H,
                int kv_dtype, int dtype, float qscale, int slices, cudaStream_t s) {
  onepass::Args p;
  p.q = q;
  p.k_new = k_new;
  p.v_new = v_new;
  p.q_stride = row_stride;
  p.ks = ks ? ks + layer_rows : nullptr;
  p.vs = vs ? vs + layer_rows : nullptr;
  p.out = out;
  p.T = offset;
  p.row_keys = C;
  p.D = D;
  p.H = H;
  p.qscale = qscale;
  const size_t elems = layer_rows * D;
  auto run = [&](auto* act) -> int {
    using T = std::remove_pointer_t<decltype(act)>;
    if (kv_dtype == kI8) {
      p.k = static_cast<const int8_t*>(k_ring) + elems;
      p.v = static_cast<const int8_t*>(v_ring) + elems;
      constexpr int kRound = std::is_same<T, __nv_bfloat16>::value ? 1 : 0;
      return onepass::launch<int8_t, T, T, kRound>(p, B, slices, s);
    }
    if (kv_dtype != dtype) return cudaErrorInvalidValue;
    p.k = static_cast<const T*>(k_ring) + elems;
    p.v = static_cast<const T*>(v_ring) + elems;
    return onepass::launch<T, T, T, 0>(p, B, slices, s);
  };
  if (dtype == kBF16) return run(static_cast<__nv_bfloat16*>(nullptr));
  if (dtype == kF32) return run(static_cast<float*>(nullptr));
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace olm

// The split pass's chunks of 128 positions over T positions.
extern "C" int olm_decode_attention_chunks(int T) {
  return (T + olm::kCaChunk - 1) / olm::kCaChunk;
}

// Scratch (ancestry only; null otherwise): m_part and l_part B*H*nchunks
// floats, acc_part B*H*nchunks*dh, nchunks = olm_decode_attention_chunks(offset).
// anc: null (beam_k must be 1) or (B, C) int32 with B a multiple of beam_k.
// kv_dtype: the rings' type, `dtype` or int8; int8 rings need ks and vs,
// (L, B, 1, C) fp32, and no ancestry map.
extern "C" int olm_self_attention(const void* q, const void* k_new, const void* v_new,
                                  long long row_stride, const void* k_ring, const void* v_ring,
                                  const float* ks, const float* vs, const int* anc, float* m_part,
                                  float* l_part, float* acc_part, void* out, int L, int layer,
                                  int B, int C, int offset, int D, int H, int beam_k,
                                  int kv_dtype, int dtype, float qscale, void* stream) {
  using namespace olm;
  if (B <= 0 || H <= 0 || D % H != 0 || layer < 0 || layer >= L || offset < 0 || offset > C)
    return cudaErrorInvalidValue;
  if (anc ? (beam_k < 1 || B % beam_k != 0) : beam_k != 1) return cudaErrorInvalidValue;
  const bool q8 = kv_dtype == kI8;
  if (q8 ? (!ks || !vs || anc) : (kv_dtype != dtype || ks || vs)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t rows = static_cast<size_t>(layer) * B * C;  // this layer's first (row, position)
  if (!anc)  // the single-pass core
    return self_attend(q, k_new, v_new, row_stride, k_ring, v_ring, ks, vs, rows, out, B, C,
                       offset, D, H, kv_dtype, dtype, qscale, 0, s);
  DecodeAttnArgs p;
  p.q = q;
  p.q_stride = row_stride;
  p.anc = anc;
  p.m_part = m_part;
  p.l_part = l_part;
  p.acc_part = acc_part;
  p.T = offset;
  p.row_keys = C;
  p.D = D;
  p.H = H;
  p.nchunks = (offset + kCaChunk - 1) / kCaChunk;
  p.kv_group = beam_k;
  p.qscale = qscale;
  const size_t elems = rows * D;
  if (dtype == kBF16)
    return self_attention_beam<__nv_bfloat16>(p, k_ring, v_ring, elems, k_new, v_new,
                                              row_stride, out, B, s);
  if (dtype == kF32)
    return self_attention_beam<float>(p, k_ring, v_ring, elems, k_new, v_new, row_stride, out,
                                      B, s);
  return cudaErrorInvalidValue;
}

// The single-pass core's route of olm_self_attention (bf16 or fp32 rings, no
// ancestry) with the blocks a (row, head) pair's positions are split over
// named, 1..16 (at most one per 64 positions), for
// perf/probe_decode_attention.py.
extern "C" int olm_self_attend_probe(const void* q, const void* k_new, const void* v_new,
                                     long long row_stride, const void* k_ring, const void* v_ring,
                                     void* out, int L, int layer, int B, int C, int offset, int D,
                                     int H, int dtype, float qscale, int slices, void* stream) {
  using namespace olm;
  if (B <= 0 || H <= 0 || D % H != 0 || layer < 0 || layer >= L || offset < 0 || offset > C ||
      slices < 1)
    return cudaErrorInvalidValue;
  const size_t rows = static_cast<size_t>(layer) * B * C;
  return self_attend(q, k_new, v_new, row_stride, k_ring, v_ring, nullptr, nullptr, rows, out, B,
                     C, offset, D, H, dtype, dtype, qscale, slices,
                     static_cast<cudaStream_t>(stream));
}
