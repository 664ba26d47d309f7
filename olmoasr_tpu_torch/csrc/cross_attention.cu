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
// cache is not quantized). With int8 keys under bf16 activations (the output
// type) the logit is the TPU kernel's int8 q.K product (_qk_logits): q
// rounded per head to int8 with scale amax(|q_h|) / 127, an s32 dot product
// with the int8 keys (__dp4a), times that scale, times ks[t]. fp32
// activations keep the exact product of the widened keys, as the TPU
// kernel's fp32 path does.
//
// What bounds it: every decode step reads the whole cross cache of every
// layer, B * T * D * 2 elements per layer for B cache rows (small.en, B = 64,
// T = 1500, D = 768, bf16: 295 MB per layer). With G query rows per cache
// row (best_of samples, beams) the G rows' blocks are grid neighbours and
// share the read through L2, so device memory still sees B rows, not B * G.
// The split-position design (decode_attention.cuh) spreads the read over
// every SM: one block per (128-key chunk, head, query row) -- 9216 blocks at
// B = 64 -- and a combine launch.
//
// olm_cross_attend is the attention alone, with q projected but not yet
// scaled, in the activation type: replaces cross_attend_decode
// (olmoasr_tpu/ops/attention.py:725, _cross_decode_kernel at :39), which the
// JAX step runs between an ln_matmul for the cross q and a matmul_residual.
// It runs on the single-pass core of decode_attention.cuh (one launch, the
// key slices of a (row, head) pair in one cluster, no partials in device
// memory), with the TPU kernel's bf16 dot dtype under bf16 activations
// (kRound = 2): q rounded to bf16 for the exact product (int8 keys take the
// int8 one from the unrounded q), each softmax weight rounded after its
// value scale, and each weight-value product rounded before the fp32 sum.
// One kv row per query row.
#include <type_traits>

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
  DecodeAttnArgs p;
  p.q = q;
  p.q_stride = D;
  p.k = k;
  p.v = v;
  p.ks = ks;
  p.vs = vs;
  p.m_part = m_part;
  p.l_part = l_part;
  p.acc_part = acc_part;
  p.T = p.row_keys = T;
  p.D = D;
  p.H = H;
  p.nchunks = olm_decode_attention_chunks(T);
  p.kv_group = kv_group;
  p.qscale = qscale;
  p.quant_q = kv_dtype == kI8 && out_dtype == kBF16;
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

namespace olm {
namespace {

int cross_attend(const void* q, const void* k, const void* v, const float* ks, const float* vs,
                 void* out, int B, int T, int D, int H, int kv_dtype, int dtype, float qscale,
                 int slices, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || D % H != 0) return cudaErrorInvalidValue;
  if (kv_dtype != kI8 && kv_dtype != dtype) return cudaErrorInvalidValue;
  onepass::Args p;
  p.q = q;
  p.q_stride = D;
  p.k = k;
  p.v = v;
  p.ks = ks;
  p.vs = vs;
  p.out = out;
  p.T = p.row_keys = T;
  p.D = D;
  p.H = H;
  p.qscale = qscale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto* act) -> int {
    using Q = std::remove_pointer_t<decltype(act)>;
    constexpr int kRound = std::is_same<Q, __nv_bfloat16>::value ? 2 : 0;
    if (kv_dtype == kI8) return onepass::launch<int8_t, Q, kRound>(p, B, slices, s);
    return onepass::launch<Q, Q, kRound>(p, B, slices, s);
  };
  if (dtype == kBF16) return run(static_cast<__nv_bfloat16*>(nullptr));
  if (dtype == kF32) return run(static_cast<float*>(nullptr));
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace olm

// q, out: (B, D) contiguous in `dtype`; k, v: (B, T, D) in kv_dtype (int8, or
// `dtype`), rows 16-byte aligned; ks, vs: (B, T) fp32 or null (ones); a head
// width of 8-128 dividing 128 (int8 caches: 16-128).
extern "C" int olm_cross_attend(const void* q, const void* k, const void* v, const float* ks,
                                const float* vs, void* out, int B, int T, int D, int H,
                                int kv_dtype, int dtype, float qscale, void* stream) {
  return olm::cross_attend(q, k, v, ks, vs, out, B, T, D, H, kv_dtype, dtype, qscale, 0, stream);
}

// The same with the blocks a (row, head) pair's keys are split over named,
// 1..16 (at most one per 64 keys): the single-pass core's cluster sizes, for
// perf/probe_decode_attention.py.
extern "C" int olm_cross_attend_probe(const void* q, const void* k, const void* v,
                                      const float* ks, const float* vs, void* out, int B, int T,
                                      int D, int H, int kv_dtype, int dtype, float qscale,
                                      int slices, void* stream) {
  if (slices < 1) return cudaErrorInvalidValue;
  return olm::cross_attend(q, k, v, ks, vs, out, B, T, D, H, kv_dtype, dtype, qscale, slices,
                           stream);
}
