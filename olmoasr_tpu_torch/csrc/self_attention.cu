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
// bf16 and fp32 rings without ancestry run on the single-pass core of
// decode_attention.cuh (one launch: the ring's positions of a (row, head)
// pair split over the blocks of one cluster, merged in distributed shared
// memory in rank order; rank 0 folds in the new key and value, the key's
// logit from the unrounded q; no partials in device memory), with the ring's
// row stride C and every product fp32 (kRound = 0). int8 rings and beam
// ancestry keep the split-position pass and its combine launch, which folds
// in the new key and value.
//
// int8 rings (the JAX package's init_cache(quantize_self=True)): ks/vs are
// the rings' (L, B, 1, C) fp32 per-position scales, read at this layer's
// (B, C) block, and the pass is the cross pass's int8 one: the ring logit is
// the TPU kernel's _qk_logits times ks[t] (under bf16 activations q rounded
// per head to int8 and an s32 __dp4a product; under fp32 the exact one), vs[t]
// folds into the weight, and under bf16 the weight is rounded to bf16 before
// the value product, as _self_decode_body rounds w_old to its dot dtype. This
// step's own key and value are not quantized (the caller quantizes them into
// the ring afterwards): the combine takes their logit from the unrounded fp32
// q, as the TPU body does. The ring read halves against bf16 (B * offset * D
// bytes for each ring, plus 4 bytes a position of scales).
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

// The split-position pass over int8 rings or with ancestry: ring elements
// KV, activations (q, k_new, v_new, out) T.
template <typename KV, typename T>
int self_attention(DecodeAttnArgs p, const void* k_ring, const void* v_ring, size_t layer_elems,
                   const void* k_new, const void* v_new, long long row_stride, void* out, int B,
                   cudaStream_t s) {
  p.k = static_cast<const KV*>(k_ring) + layer_elems;
  p.v = static_cast<const KV*>(v_ring) + layer_elems;
  const T* kn = static_cast<const T*>(k_new);
  const T* vn = static_cast<const T*>(v_new);
  T* o = static_cast<T*>(out);
  if constexpr (std::is_same<KV, int8_t>::value && std::is_same<T, __nv_bfloat16>::value) {
    p.quant_q = 1;
    return launch_decode_attention<KV, 1>(p, B, kn, vn, row_stride, o, s);
  }
  return launch_decode_attention<KV>(p, B, kn, vn, row_stride, o, s);
}

// The single-pass core over bf16 or fp32 rings without ancestry; slices as
// onepass::launch's.
int self_attend(const void* q, const void* k_new, const void* v_new, long long row_stride,
                const void* k_ring, const void* v_ring, size_t layer_elems, void* out, int B,
                int C, int offset, int D, int H, int dtype, float qscale, int slices,
                cudaStream_t s) {
  onepass::Args p;
  p.q = q;
  p.k_new = k_new;
  p.v_new = v_new;
  p.q_stride = row_stride;
  p.out = out;
  p.T = offset;
  p.row_keys = C;
  p.D = D;
  p.H = H;
  p.qscale = qscale;
  if (dtype == kBF16) {
    using bf = __nv_bfloat16;
    p.k = static_cast<const bf*>(k_ring) + layer_elems;
    p.v = static_cast<const bf*>(v_ring) + layer_elems;
    return onepass::launch<bf, bf, 0>(p, B, slices, s);
  }
  if (dtype == kF32) {
    p.k = static_cast<const float*>(k_ring) + layer_elems;
    p.v = static_cast<const float*>(v_ring) + layer_elems;
    return onepass::launch<float, float, 0>(p, B, slices, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace olm

// Scratch (int8 rings and ancestry only; null otherwise) as
// olm_cross_attention: m_part and l_part B*H*nchunks floats, acc_part
// B*H*nchunks*dh, nchunks = olm_decode_attention_chunks(offset).
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
  const size_t elems = rows * D;
  if (!q8 && !anc)  // the single-pass core
    return self_attend(q, k_new, v_new, row_stride, k_ring, v_ring, elems, out, B, C, offset, D,
                       H, dtype, qscale, 0, s);
  DecodeAttnArgs p;
  p.q = q;
  p.q_stride = row_stride;
  p.ks = q8 ? ks + rows : nullptr;
  p.vs = q8 ? vs + rows : nullptr;
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
  auto run = [&](auto* act) -> int {
    using T = std::remove_pointer_t<decltype(act)>;
    return q8 ? self_attention<int8_t, T>(p, k_ring, v_ring, elems, k_new, v_new, row_stride, out,
                                          B, s)
              : self_attention<T, T>(p, k_ring, v_ring, elems, k_new, v_new, row_stride, out, B,
                                     s);
  };
  if (dtype == kBF16) return run(static_cast<__nv_bfloat16*>(nullptr));
  if (dtype == kF32) return run(static_cast<float*>(nullptr));
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
  const size_t elems = static_cast<size_t>(layer) * B * C * D;
  return self_attend(q, k_new, v_new, row_stride, k_ring, v_ring, elems, out, B, C, offset, D, H,
                     dtype, qscale, slices, static_cast<cudaStream_t>(stream));
}
