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
// row (best_of samples, beams; the long-form slice's 16 files x 5) the cache
// is still read once: the single-pass core of decode_attention.cuh takes a
// cache row's G query rows in one block (up to kMaxGroup; more split over
// blocks of the same row), each stage of K and V staged once for all of
// them. It is one launch (a (cache row, head) pair's keys split over the
// blocks of one cluster, merged in distributed shared memory in rank order,
// no partials in device memory), with every product in fp32 (kRound = 0)
// and q fp32, unrounded, as the split-position pass took them before.
//
// olm_cross_attend is the attention alone, with q projected but not yet
// scaled, in the activation type: replaces cross_attend_decode
// (olmoasr_tpu/ops/attention.py:725, _cross_decode_kernel at :39), which the
// JAX step runs between an ln_matmul for the cross q and a matmul_residual.
// It runs on the same core (one row per cache row), with the TPU kernel's
// bf16 dot dtype under bf16 activations (kRound = 2): q rounded to bf16 for
// the exact product (int8 keys take the int8 one from the unrounded q), each
// softmax weight rounded after its value scale, and each weight-value
// product rounded before the fp32 sum.
#include <type_traits>

#include "decode_attention.cuh"

namespace olm {
namespace {

// cross_block_decode's attention: q (B, D) fp32, projected with its bias,
// unscaled; out (B, D) in the activation type; slices as onepass::launch's.
int cross_attention(const float* q, const void* k, const void* v, const float* ks,
                    const float* vs, void* out, int B, int T, int D, int H, int kv_group,
                    int kv_dtype, int out_dtype, float qscale, int slices, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || D % H != 0 || kv_group < 1 || B % kv_group != 0)
    return cudaErrorInvalidValue;
  if (kv_dtype != kI8 && kv_dtype != out_dtype) return cudaErrorInvalidValue;
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
  p.kv_group = kv_group;
  p.qscale = qscale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto* act) -> int {
    using A = std::remove_pointer_t<decltype(act)>;
    if (kv_dtype == kI8) return onepass::launch<int8_t, float, A, 0, true>(p, B, slices, s);
    return onepass::launch<A, float, A, 0, true>(p, B, slices, s);
  };
  if (out_dtype == kBF16) return run(static_cast<__nv_bfloat16*>(nullptr));
  if (out_dtype == kF32) return run(static_cast<float*>(nullptr));
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace olm

// q: (B, D) fp32; k, v: (B / kv_group, T, D) in kv_dtype (int8, or out_dtype),
// rows 16-byte aligned; ks, vs: (B / kv_group, T) fp32 or null (ones); out:
// (B, D) in out_dtype; a head width of 8-128 dividing 128 (int8 caches:
// 16-128). With int8 keys under bf16 activations the logit is the int8 q.K
// product from the unrounded q.
extern "C" int olm_cross_attention(const float* q, const void* k, const void* v, const float* ks,
                                   const float* vs, void* out, int B, int T, int D, int H,
                                   int kv_group, int kv_dtype, int out_dtype, float qscale,
                                   void* stream) {
  return olm::cross_attention(q, k, v, ks, vs, out, B, T, D, H, kv_group, kv_dtype, out_dtype,
                              qscale, 0, stream);
}

// The same with the blocks a (cache row, head) pair's keys are split over
// named, 1..16 (at most one per 64 keys), for perf/probe_decode_attention.py.
extern "C" int olm_cross_attention_probe(const float* q, const void* k, const void* v,
                                         const float* ks, const float* vs, void* out, int B,
                                         int T, int D, int H, int kv_group, int kv_dtype,
                                         int out_dtype, float qscale, int slices, void* stream) {
  if (slices < 1) return cudaErrorInvalidValue;
  return olm::cross_attention(q, k, v, ks, vs, out, B, T, D, H, kv_group, kv_dtype, out_dtype,
                              qscale, slices, stream);
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
    if (kv_dtype == kI8) return onepass::launch<int8_t, Q, Q, kRound>(p, B, slices, s);
    return onepass::launch<Q, Q, Q, kRound>(p, B, slices, s);
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
