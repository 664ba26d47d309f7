// One decoder layer for one decode step in ONE launch: replaces
// layer_block_decode (olmoasr_tpu/ops/attention.py:1228, _layer_block_impl)
// in both its modes: "sc" (include_mlp=False, the self and cross sub-blocks;
// the MLP follows as mlp_block) and the whole layer (include_mlp=True, the
// MLP's phases too). The JAX package takes it for S=1 steps over an int8
// cross cache with one token row per window and no beam ancestry
// (olmoasr_tpu/models/whisper.py, use_layer_block): greedy decoding, and
// sampling without best_of, under int8 cross K/V -- the server's default
// ("sc"), or the whole layer under OLMOASR_LAYER_BLOCK=1.
//
// Only its fp32 form is built (the exact checks); the bf16 layer is
// decode_layer.cu.
//
// For the B rows of the residual x (B, D) of layer weights in torch's (out,
// in) layout, rings of this layer (B, C, D) and the int8 cross cache (B, T, D)
// with per-position fp32 scales:
//   h   = LN1(x)                                   rounded to the weight type
//   qkv = h @ Wqkv^T + bqkv                        fp32 (B, 3D): q | k_new | v_new
//   a   = attend(q; ring[:offset] and k_new, v_new)  self attention, fp32 q/k/v
//   x1  = x + round(a) @ Wo^T + bo                 fp32
//   h2  = LN2(x1)                                  rounded
//   qc  = h2 @ Wq^T + bq                           fp32
//   c   = attend(qc; cross K/V)                    int8 q.K under bf16 (_qk_logits)
//   out = x1 + round(c) @ Wo2^T + bo2              one rounding, at the store
// and with the MLP (include_mlp), from the fp32 x2 = x1 + round(c) @ Wo2^T + bo2:
//   u   = gelu(round(LN3(x2)) @ W1^T + b1)         exact erf GELU, rounded
//   out = x2 + u @ W2^T + b2                       one rounding, at the store
// and k_new, v_new rounded to the ring type for the caller to write at
// position offset. As in the TPU kernel, the residual and the projections stay
// fp32 inside the layer; the chain of split kernels rounds them between
// launches.
//
// Design. The TPU kernel runs one grid step per row with the layer's weights
// resident in VMEM. A GPU block cannot hold 7 MB of weights, and each phase
// needs every row of the one before it (a projection reads all of h, the
// attention all of q), so the launch is cooperative: as many 128-thread
// blocks as fit on the card at once run thirteen phases in order (eighteen
// with the MLP), each a
// grid-stride loop over its work items, with a grid-wide barrier between
// phases. The work items are the block bodies that the split kernels launch
// as grids of their own (skinny_linear.cuh: 32x32 output tiles over K splits;
// decode_attention.cuh: one (128-key chunk, head, row) partial, one (head,
// row) combine). Each projection writes fp32 split partials and the phase
// after it sums them in split order with the bias (and the residual, and the
// next LayerNorm, one warp per row), so the result does not depend on the
// grid size beyond the split count.
//
// Its bytes are those of the split kernels: the cross read (small.en, B = 64,
// int8: 147 MB per layer), the ring read and the 7 MB of weights (16.5 MB
// with the MLP's). It replaces their fourteen launches (nineteen with the
// MLP's); its thirteen dependent phases, not the bytes, bound it.
#include <cooperative_groups.h>

#include <algorithm>
#include <type_traits>

#include "decode_attention.cuh"
#include "skinny_linear.cuh"

namespace olm {
namespace {

constexpr int kLbThreads = 128;
static_assert(kLbThreads == kCaThreads && kLbThreads == kLinThreads,
              "the phases share one block size");

struct LayerBlockArgs {
  const void* x;  // (B, D) residual, weight type
  const void *ln1_g, *ln1_b, *wqkv, *bqkv, *wo1, *bo1;  // self sub-block
  const void *ln2_g, *ln2_b, *wq, *bq, *wo2, *bo2;      // cross sub-block
  const void *ln3_g, *ln3_b, *w1, *b1, *w2, *b2;        // MLP, or all null ("sc")
  const void *k_ring, *v_ring;                          // this layer's (B, C, D) rings
  const int8_t *ck, *cv;                                // (B, T, D)
  const float *cks, *cvs;                               // (B, T)
  void* out;                                            // (B, D) weight type
  void* kv_new;                                         // (2, B, D) weight type
  // scratch, carved by the host
  float *qkv, *x1, *qc, *ws, *m_part, *l_part, *acc_part;
  void *h, *attn;  // (B, D) weight type
  void* u;         // (B, F) weight type: the MLP's hidden activations
  int B, D, H, C, offset, T, F;
  int s3, s1, sF, s2;          // K splits: N = 3D, N = D (K = D), W1 (N = F), W2 (K = F)
  int per3, per1, perF, per2;  // K tiles per split
  float qscale;
};

// Work items i = blockIdx.x, blockIdx.x + gridDim.x, ... < n; the bounds are
// the same for every thread of a block, so bodies may hold block barriers.
template <typename F>
__device__ __forceinline__ void each_item(int n, F&& body) {
  for (int i = blockIdx.x; i < n; i += gridDim.x) body(i);
}

// Elements i < n of a flat (M, N) array, over every thread of the grid.
template <typename F>
__device__ __forceinline__ void each_element(size_t n, F&& body) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x)
    body(i);
}

// Rows m < M, one warp each.
template <typename F>
__device__ __forceinline__ void each_row(int M, F&& body) {
  const int warps = blockDim.x / 32;
  for (int m = blockIdx.x * warps + threadIdx.x / 32; m < M; m += gridDim.x * warps) body(m);
}

// The split partials of h (M, K) @ W^T (N, K) into ws.
template <typename T>
__device__ __forceinline__ void project(const void* h, const void* w, float* ws, int M, int N,
                                        int K, int splits, int per) {
  const LinearArgs p{static_cast<const float*>(h), static_cast<const float*>(w), nullptr, nullptr,
                     nullptr, ws, M, N, K, per, 1, 0};
  const int tiles_n = (N + kFT - 1) / kFT, tiles = linear_tiles(M, N);
  each_item(tiles * splits, [&](int i) {
    const int tile = i % tiles;
    linear_tile<T>(p, tile % tiles_n, tile / tiles_n, i / tiles);
  });
}

// The partial pass of single-query attention, every (chunk, head, row).
template <typename KV>
__device__ __forceinline__ void attend_partials(const DecodeAttnArgs& p, int B) {
  const int n = p.nchunks * p.H;
  each_item(n * B, [&](int i) {  // one query row per kv row
    attn_partial_block<KV, float>(p, i % p.nchunks, i % n / p.nchunks, i / n, i / n);
  });
}

template <typename T>
__global__ void __launch_bounds__(kLbThreads) layer_block_kernel(const LayerBlockArgs a) {
  namespace cg = cooperative_groups;
  cg::grid_group grid = cg::this_grid();
  const int B = a.B, D = a.D, H = a.H;
  const T* x = static_cast<const T*>(a.x);
  T* h = static_cast<T*>(a.h);
  T* attn = static_cast<T*>(a.attn);
  const size_t BD = static_cast<size_t>(B) * D;
  auto bias = [](const void* b, int n) { return to_f(static_cast<const T*>(b)[n]); };

  // 1. h = LN1(x)
  each_row(B, [&](int m) {
    const size_t r = static_cast<size_t>(m) * D;
    layer_norm_row(x + r, static_cast<const T*>(a.ln1_g), static_cast<const T*>(a.ln1_b), h + r, D,
                   1e-5f);
  });
  grid.sync();
  // 2. the fused QKV projection's partials
  project<T>(h, a.wqkv, a.ws, B, 3 * D, D, a.s3, a.per3);
  grid.sync();
  // 3. qkv = sum + bias; this step's key and value, rounded, for the rings
  each_element(3 * BD, [&](size_t i) {
    const int n = static_cast<int>(i % (3 * D)), m = static_cast<int>(i / (3 * D));
    const float v = split_sum(a.ws, a.s3, 3 * BD, i) + bias(a.bqkv, n);
    a.qkv[i] = v;
    if (n >= D) static_cast<T*>(a.kv_new)[(n / D - 1) * BD + static_cast<size_t>(m) * D + n % D] =
        from_f<T>(v);
  });
  grid.sync();
  // 4-5. self attention over the ring's first offset positions and the own key
  DecodeAttnArgs ps;
  ps.q = a.qkv;
  ps.q_stride = 3 * D;
  ps.k = a.k_ring;
  ps.v = a.v_ring;
  ps.m_part = a.m_part;
  ps.l_part = a.l_part;
  ps.acc_part = a.acc_part;
  ps.T = a.offset;
  ps.row_keys = a.C;
  ps.D = D;
  ps.H = H;
  ps.nchunks = (a.offset + kCaChunk - 1) / kCaChunk;
  ps.qscale = a.qscale;
  attend_partials<T>(ps, B);
  grid.sync();
  each_item(H * B, [&](int i) {
    attn_combine_block<float, T>(ps, a.qkv + D, a.qkv + 2 * D, 3 * D, attn, i % H, i / H);
  });
  grid.sync();
  // 6. the self output projection's partials
  project<T>(attn, a.wo1, a.ws, B, D, D, a.s1, a.per1);
  grid.sync();
  // 7. x1 = x + sum + bias (fp32), then h = LN2(x1), one warp per row
  each_row(B, [&](int m) {
    const size_t r = static_cast<size_t>(m) * D;
    for (int k = threadIdx.x % 32; k < D; k += 32)  // the lanes LN reads back
      a.x1[r + k] = to_f(x[r + k]) + split_sum(a.ws, a.s1, BD, r + k) + bias(a.bo1, k);
    layer_norm_row(a.x1 + r, static_cast<const T*>(a.ln2_g), static_cast<const T*>(a.ln2_b),
                   h + r, D, 1e-5f);
  });
  grid.sync();
  // 8-9. the cross q projection
  project<T>(h, a.wq, a.ws, B, D, D, a.s1, a.per1);
  grid.sync();
  each_element(BD, [&](size_t i) {
    a.qc[i] = split_sum(a.ws, a.s1, BD, i) + bias(a.bq, static_cast<int>(i % D));
  });
  grid.sync();
  // 10-11. cross attention over the int8 cache
  DecodeAttnArgs pc = ps;
  pc.q = a.qc;
  pc.q_stride = D;
  pc.k = a.ck;
  pc.v = a.cv;
  pc.ks = a.cks;
  pc.vs = a.cvs;
  pc.T = pc.row_keys = a.T;
  pc.nchunks = (a.T + kCaChunk - 1) / kCaChunk;
  pc.quant_q = std::is_same<T, __nv_bfloat16>::value;
  attend_partials<int8_t>(pc, B);
  grid.sync();
  each_item(H * B, [&](int i) {
    attn_combine_block<float, T>(pc, static_cast<const float*>(nullptr),
                                 static_cast<const float*>(nullptr), 0, attn, i % H, i / H);
  });
  grid.sync();
  // 12-13. the cross output projection, bias and residual
  project<T>(attn, a.wo2, a.ws, B, D, D, a.s1, a.per1);
  grid.sync();
  if (!a.w1) {  // "sc": the MLP follows as mlp_block
    each_element(BD, [&](size_t i) {
      static_cast<T*>(a.out)[i] = from_f<T>(a.x1[i] + split_sum(a.ws, a.s1, BD, i) +
                                            bias(a.bo2, static_cast<int>(i % D)));
    });
    return;
  }
  // 13'. x2 = x1 + sum + bias (fp32, in x1's place), then h = LN3(x2), one warp a row
  each_row(B, [&](int m) {
    const size_t r = static_cast<size_t>(m) * D;
    for (int k = threadIdx.x % 32; k < D; k += 32)  // the lanes LN reads back
      a.x1[r + k] += split_sum(a.ws, a.s1, BD, r + k) + bias(a.bo2, k);
    layer_norm_row(a.x1 + r, static_cast<const T*>(a.ln3_g), static_cast<const T*>(a.ln3_b),
                   h + r, D, 1e-5f);
  });
  grid.sync();
  // 14-15. u = gelu(h @ W1^T + b1), rounded to the weight type
  const int F = a.F;
  const size_t BF = static_cast<size_t>(B) * F;
  T* u = static_cast<T*>(a.u);
  project<T>(h, a.w1, a.ws, B, F, D, a.sF, a.perF);
  grid.sync();
  each_element(BF, [&](size_t i) {
    u[i] = from_f<T>(gelu_erf(split_sum(a.ws, a.sF, BF, i) + bias(a.b1, static_cast<int>(i % F))));
  });
  grid.sync();
  // 16-17. out = x2 + u @ W2^T + b2
  project<T>(u, a.w2, a.ws, B, D, F, a.s2, a.per2);
  grid.sync();
  each_element(BD, [&](size_t i) {
    static_cast<T*>(a.out)[i] = from_f<T>(a.x1[i] + split_sum(a.ws, a.s2, BD, i) +
                                          bias(a.b2, static_cast<int>(i % D)));
  });
}

// Launch geometry: the grid that fits on the card at once, and K splits that
// give each projection phase about one work item per block.
struct Plan {
  int grid = 0, s3 = 1, s1 = 1, sF = 1, s2 = 1, per3 = 1, per1 = 1, perF = 1, per2 = 1;
  int nchunks = 0;
  size_t floats = 0;  // scratch
};

// F = 0: no MLP ("sc").
template <typename T>
int plan(int B, int D, int H, int T_keys, int offset, int F, Plan* out) {
  static int per_sm = 0;  // resident blocks per SM, the same on every call
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, layer_block_kernel<T>, kLbThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm <= 0) return cudaErrorInvalidConfiguration;
  Plan p;
  p.grid = per_sm * sms;
  auto splits = [&](int N, int K, int* s, int* per) {
    const int ktiles = (K + linear_k_tile<T>() - 1) / linear_k_tile<T>();
    const int tiles = linear_tiles(B, N);
    const int want = std::max(1, std::min(ktiles, (p.grid + tiles - 1) / tiles));
    *per = (ktiles + want - 1) / want;
    *s = (ktiles + *per - 1) / *per;
  };
  splits(3 * D, D, &p.s3, &p.per3);
  splits(D, D, &p.s1, &p.per1);
  if (F > 0) {
    splits(F, D, &p.sF, &p.perF);
    splits(D, F, &p.s2, &p.per2);
  }
  p.nchunks = std::max((offset + kCaChunk - 1) / kCaChunk, (T_keys + kCaChunk - 1) / kCaChunk);
  const size_t BD = static_cast<size_t>(B) * D, parts = static_cast<size_t>(B) * H * p.nchunks;
  const size_t BF = static_cast<size_t>(B) * F;
  auto up4 = [](size_t n) { return (n + 3) / 4 * 4; };  // 16-byte aligned pieces
  // qkv, x1, qc, h, attn (a float each, room for either type), the MLP's u,
  // split partials, attention partials: the pieces olm_layer_block takes
  const size_t ws = std::max({p.s3 * 3 * BD, p.s1 * BD, F > 0 ? p.sF * BF : 0,
                              F > 0 ? p.s2 * BD : 0});
  p.floats = up4(3 * BD) + 4 * up4(BD) + up4(BF) + up4(ws) + 2 * up4(parts) +
             up4(parts * (D / H));
  *out = p;
  return cudaSuccess;
}

template <typename T>
bool fits(int D, int H, int F) {
  return decode_attention_fits<T>(D, H) && decode_attention_fits<int8_t>(D, H) && D % 8 == 0 &&
         F >= 0 && F % 8 == 0;
}

}  // namespace
}  // namespace olm

// fp32 scratch floats that olm_layer_block needs at these sizes (F = 0: no
// MLP); 0 on an error or unsupported widths.
extern "C" long long olm_layer_block_scratch(int B, int D, int H, int T, int offset, int F,
                                             int dtype) {
  using namespace olm;
  if (B <= 0 || H <= 0 || D % H != 0 || T <= 0 || offset < 0) return 0;
  Plan p;
  if (dtype != kF32 || !fits<float>(D, H, F) || plan<float>(B, D, H, T, offset, F, &p))
    return 0;
  return static_cast<long long>(p.floats);
}

// x, out: (B, D); rings: the stacked (L, B, C, D); ck, cv: (B, T, D) int8
// with (B, T) scales; kv_new: (2, B, D). The MLP's ln3_g, ln3_b (D), w1 (F, D),
// b1 (F), w2 (D, F), b2 (D) with F > 0, or all null with F = 0 ("sc"). All
// 16-byte aligned, weight type `dtype` but the cache. scratch:
// olm_layer_block_scratch(...) floats.
extern "C" int olm_layer_block(const void* x, const void* ln1_g, const void* ln1_b,
                               const void* wqkv, const void* bqkv, const void* wo1,
                               const void* bo1, const void* ln2_g, const void* ln2_b,
                               const void* wq, const void* bq, const void* wo2, const void* bo2,
                               const void* ln3_g, const void* ln3_b, const void* w1,
                               const void* b1, const void* w2, const void* b2,
                               const void* k_ring, const void* v_ring, const void* ck,
                               const void* cv, const float* cks, const float* cvs, void* out,
                               void* kv_new, float* scratch, int L, int layer, int B, int C,
                               int offset, int D, int H, int T, int F, int dtype, float qscale,
                               void* stream) {
  using namespace olm;
  if (B <= 0 || H <= 0 || D % H != 0 || T <= 0 || layer < 0 || layer >= L || offset < 0 ||
      offset > C)
    return cudaErrorInvalidValue;
  const bool mlp = F > 0;
  for (const void* w : {ln3_g, ln3_b, w1, b1, w2, b2})
    if ((w != nullptr) != mlp) return cudaErrorInvalidValue;
  auto run = [&](auto* typed) -> int {
    using Ty = std::remove_pointer_t<decltype(typed)>;
    if (!fits<Ty>(D, H, F)) return cudaErrorInvalidValue;
    Plan p;
    const int err = plan<Ty>(B, D, H, T, offset, F, &p);
    if (err != cudaSuccess) return err;
    const size_t BD = static_cast<size_t>(B) * D, parts = static_cast<size_t>(B) * H * p.nchunks;
    const size_t layer_elems = static_cast<size_t>(layer) * B * C * D;
    LayerBlockArgs a{};
    a.x = x;
    a.ln1_g = ln1_g, a.ln1_b = ln1_b, a.wqkv = wqkv, a.bqkv = bqkv, a.wo1 = wo1, a.bo1 = bo1;
    a.ln2_g = ln2_g, a.ln2_b = ln2_b, a.wq = wq, a.bq = bq, a.wo2 = wo2, a.bo2 = bo2;
    a.ln3_g = ln3_g, a.ln3_b = ln3_b, a.w1 = w1, a.b1 = b1, a.w2 = w2, a.b2 = b2;
    a.k_ring = static_cast<const Ty*>(k_ring) + layer_elems;
    a.v_ring = static_cast<const Ty*>(v_ring) + layer_elems;
    a.ck = static_cast<const int8_t*>(ck);
    a.cv = static_cast<const int8_t*>(cv);
    a.cks = cks;
    a.cvs = cvs;
    a.out = out;
    a.kv_new = kv_new;
    float* f = scratch;
    auto take = [&](size_t n) {
      float* piece = f;
      f += (n + 3) / 4 * 4;
      return piece;
    };
    a.qkv = take(3 * BD);
    a.x1 = take(BD);
    a.qc = take(BD);
    a.h = take(BD);
    a.attn = take(BD);
    a.u = take(static_cast<size_t>(B) * F);
    a.ws = take(std::max({p.s3 * 3 * BD, p.s1 * BD, mlp ? p.sF * B * static_cast<size_t>(F) : 0,
                          mlp ? p.s2 * BD : 0}));
    a.m_part = take(parts);
    a.l_part = take(parts);
    a.acc_part = take(parts * (D / H));
    a.B = B, a.D = D, a.H = H, a.C = C, a.offset = offset, a.T = T, a.F = F;
    a.s3 = p.s3, a.s1 = p.s1, a.sF = p.sF, a.s2 = p.s2;
    a.per3 = p.per3, a.per1 = p.per1, a.perF = p.perF, a.per2 = p.per2;
    a.qscale = qscale;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(p.grid);
    cfg.blockDim = dim3(kLbThreads);
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return static_cast<int>(cudaLaunchKernelEx(&cfg, layer_block_kernel<Ty>, a));
  };
  if (dtype == kF32) return run(static_cast<float*>(nullptr));
  return cudaErrorInvalidValue;
}
