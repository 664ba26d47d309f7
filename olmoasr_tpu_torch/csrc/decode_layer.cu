// The bf16 decode layer for one decode step in ONE cooperative launch:
// olm_decode_layer replaces layer_block_decode
// (olmoasr_tpu/ops/attention.py:1228, _layer_block_impl) in both its modes,
// "sc" (the self and cross sub-blocks; the MLP follows as mlp_block, on
// skinny_proj.cu) and the whole layer (include_mlp). layer_block.cu
// keeps the fp32 layer block for the exact checks.
//
// What they compute (the plain twins of ops/attention.py define it):
//   qkv = round(LN1(x)) @ Wqkv^T + bqkv            fp32; k_new, v_new rounded at the store
//   a   = attend(q; ring[:offset], k_new, v_new)    fp32 q.K and weights
//   x1  = x + (round(a) @ Wo^T + bo)                 fp32
//   qc  = round(LN2(x1)) @ Wq^T + bq                 fp32
//   c   = attend(qc; int8 cross K/V)                 the int8 q.K product
//   x2  = x1 + (round(c) @ Wo2^T + bo2)              "sc": out = round(x2)
//   u   = round(gelu(round(LN3(x2)) @ W1^T + b1))    the whole layer
//   out = round(x2 + (u @ W2^T + b2))
//
// Phases and grid-wide barriers (decode_layer.cuh has the phases' work):
//   "sc"  QKV | self | Wo | Wq | cross | Wo2          5 barriers
//   layer the same, then | W1 | W2                   7 barriers
// Each LayerNorm is the prologue of the product that consumes it; each
// projection stores its epilogue (bias, residual, GELU, the ring values) at
// once, so no phase sums partials and none normalises.
//
// What bounds them. At small.en, B = 64, offset 224: the int8 cross K/V
// (147 MB a layer), the rings (44 MB) and the weights (7.1 MB; 16.5 MB with
// the MLP's) over 3.35 TB/s, 0.0596 ms ("sc"). The parent launch spent its time in thirteen dependent phases
// (eighteen with the MLP) and in attention that held no loads in flight
// between its work items. Here the attention phases stream every key of a
// (row, head) through a ring that starts filling before the barrier that
// publishes q; the cross pass then moves its bytes at about two thirds of
// the card's rate. What is left is the projections' own latency: each is a
// chain of dependent steps (a barrier, the LayerNorm's exchange, the
// stream, the partials' exchange) that a block of 8 warps takes in turn, so
// the phases cost several microseconds each where their bytes need well
// under one (perf/probe_decode_layer.py times each phase and step).
//
// Launch: clusters of kCS blocks, one 256-thread block an SM, as many
// clusters as fit at once (cudaOccupancyMaxActiveClusters, once per device
// and shared-memory size), cooperative, so every block is resident for the
// grid-wide barriers.
#include <cooperative_groups.h>

#include <algorithm>

#include "decode_layer.cuh"

namespace olm {
namespace dl {
namespace {

enum Mode : int { kSc = 0, kLayer = 1 };

// Column tiles of the products, each over the kCS K slices of a cluster
// (small.en on an H100: 30 clusters of 4): QKV 2304 / 64 = 36 tiles; Wo, Wq,
// Wo2 768 / 32 = 24; W1 3072 / 64 = 48; W2 768 / 32 = 24.
constexpr int kBnQkv = 64, kBnD = 32, kBnW1 = 64, kBnW2 = 32;
// W2's K slice (F / 4) streams in stages of 192 columns, the others' in 64.
constexpr int kKcW2 = 192;


struct LayerArgs {
  const bf* x;                                        // (B, D)
  const bf *ln1_g, *ln1_b, *wqkv, *bqkv, *wo1, *bo1;  // self sub-block
  const bf *ln2_g, *ln2_b, *wq, *bq, *wo2, *bo2;      // cross sub-block
  const bf *ln3_g, *ln3_b, *w1, *b1, *w2, *b2;        // MLP
  const bf *k_ring, *v_ring;                          // this layer's (B, C, D) rings
  const int8_t *ck, *cv;                              // (B, T, D)
  const float *cks, *cvs;                             // (B, T)
  bf* out;                                            // (B, D)
  bf* kv_new;                                         // (2, B, D)
  float *qkv, *x1, *qc;                               // scratch: (B, 3D), (B, D), (B, D)
  bf *attn, *u;                                       // scratch: (B, D), (B, F)
  int B, D, H, C, offset, T, F;
  float qscale;
  unsigned long long* trace;  // (grid, kMarks) phase marks, or null
};

// Phase marks: the global timer (ns) when block b starts (mark 0), ends the
// work of phase p (mark 2p + 1) and leaves the barrier after it (2p + 2),
// written by thread 0 after the phase's last block barrier; then two marks
// inside each phase p (16 + 2p: A built or the first keys in; 17 + 2p: its
// items done).
constexpr int kMarks = 32;

__device__ __forceinline__ unsigned long long* sub_marks(const LayerArgs& a, int phase) {
  return a.trace ? a.trace + blockIdx.x * kMarks + 16 + 2 * phase : nullptr;
}

__device__ __forceinline__ void mark(const LayerArgs& a, int i) {
  sub_mark(a.trace ? a.trace + blockIdx.x * kMarks : nullptr, i);
}

template <int DH>
constexpr size_t smem_bytes(int D, int F, int mode) {
  const size_t mlp = std::max(ProjLayout<kBnW1>::bytes(D, kLnF32),
                              ProjLayout<kBnW2, kKcW2>::bytes(F, kCopy));
  const size_t sc = std::max({ProjLayout<kBnQkv>::bytes(D, kLnBf16),
                              ProjLayout<kBnD>::bytes(D, kLnF32), AttnCfg<bf, DH>::bytes,
                              AttnCfg<int8_t, DH>::bytes});
  return mode == kSc ? sc : std::max(mlp, sc);
}

template <int DH, int kMode>
__global__ void __launch_bounds__(kThreads, 1) decode_layer_kernel(const LayerArgs a) {
  namespace cg = cooperative_groups;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(128) char smem[];
  const int B = a.B, D = a.D, F = a.F;
  const bf* x = a.x;
  mark(a, 0);
  // (bias, gelu, res_b, res_f, out_f, out_b, kv_new, ldo, D): see Epi
  const Proj qkv{a.wqkv, x, a.ln1_g, a.ln1_b, kLnBf16, B, 3 * D, D, sub_marks(a, 0)};
  proj_pre<kBnQkv>(qkv, smem);
  project<kBnQkv>(qkv, smem, true,
                  Epi{a.bqkv, false, nullptr, nullptr, a.qkv, nullptr, a.kv_new, 3 * D, D});
  const Attn self{a.qkv, 3 * D, a.k_ring, a.v_ring, nullptr, nullptr, a.qkv + D, a.qkv + 2 * D,
                  a.attn, B, a.H, D, a.offset, a.C, a.qscale, sub_marks(a, 1)};
  attend_pre<bf, DH>(self, smem);
  mark(a, 1);
  grid.sync();  // 1: q, k_new, v_new
  mark(a, 2);
  attend<bf, DH>(self, smem);
  const Proj wo{a.wo1, a.attn, nullptr, nullptr, kCopy, B, D, D, sub_marks(a, 2)};
  proj_pre<kBnD>(wo, smem);
  mark(a, 3);
  grid.sync();  // 2: the self attention's output
  mark(a, 4);
  project<kBnD>(wo, smem, true, Epi{a.bo1, false, x, nullptr, a.x1, nullptr, nullptr, D, D});
  const Proj wq{a.wq, a.x1, a.ln2_g, a.ln2_b, kLnF32, B, D, D, sub_marks(a, 3)};
  proj_pre<kBnD>(wq, smem);
  mark(a, 5);
  grid.sync();  // 3: x1
  mark(a, 6);
  project<kBnD>(wq, smem, true, Epi{a.bq, false, nullptr, nullptr, a.qc, nullptr, nullptr, D, D});
  const Attn cross{a.qc, D, a.ck, a.cv, a.cks, a.cvs, nullptr, nullptr,
                   a.attn, B, a.H, D, a.T, a.T, a.qscale, sub_marks(a, 4)};
  attend_pre<int8_t, DH>(cross, smem);
  mark(a, 7);
  grid.sync();  // 4: qc
  mark(a, 8);
  attend<int8_t, DH>(cross, smem);
  const Proj wo2{a.wo2, a.attn, nullptr, nullptr, kCopy, B, D, D, sub_marks(a, 5)};
  proj_pre<kBnD>(wo2, smem);
  mark(a, 9);
  grid.sync();  // 5: the cross attention's output
  mark(a, 10);
  // "sc": out = round(x1 + ...); the whole layer: x2 = x1 + ..., fp32, in x1's place
  project<kBnD>(wo2, smem, true,
                kMode == kSc ? Epi{a.bo2, false, nullptr, a.x1, nullptr, a.out, nullptr, D, D}
                             : Epi{a.bo2, false, nullptr, a.x1, a.x1, nullptr, nullptr, D, D});
  mark(a, 11);
  if constexpr (kMode == kLayer) {
    const Proj w1{a.w1, a.x1, a.ln3_g, a.ln3_b, kLnF32, B, F, D, sub_marks(a, 6)};
    proj_pre<kBnW1>(w1, smem);
    grid.sync();  // 6: x2
    mark(a, 12);
    project<kBnW1>(w1, smem, true, Epi{a.b1, true, nullptr, nullptr, nullptr, a.u, nullptr, F, D});
    const Proj w2{a.w2, a.u, nullptr, nullptr, kCopy, B, D, F, sub_marks(a, 7)};
    proj_pre<kBnW2, kKcW2>(w2, smem);
    mark(a, 13);
    grid.sync();  // 7: u
    mark(a, 14);
    project<kBnW2, kKcW2>(w2, smem, true,
                          Epi{a.b2, false, nullptr, a.x1, nullptr, a.out, nullptr, D, D});
    mark(a, 15);
  }
}

constexpr int kMaxDevices = 64;

template <int DH, int kMode>
int launch(const LayerArgs& a, cudaStream_t stream) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return cudaErrorInvalidDevice;
  const size_t smem = smem_bytes<DH>(a.D, a.F, kMode);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCS, attr[0].val.clusterDim.y = 1, attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  // the clusters that fit at once, for this kernel at this shared memory
  // size: queried once per device and size
  static size_t asked[kMaxDevices] = {};
  static int clusters[kMaxDevices] = {};
  if (asked[dev] != smem) {
    cudaError_t err = cudaFuncSetAttribute(decode_layer_kernel<DH, kMode>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    cfg.gridDim = dim3(kCS);
    cfg.numAttrs = 1;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&clusters[dev], decode_layer_kernel<DH, kMode>, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (clusters[dev] <= 0) return cudaErrorInvalidConfiguration;
    asked[dev] = smem;
  }
  cfg.gridDim = dim3(clusters[dev] * kCS);
  cfg.numAttrs = 2;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, decode_layer_kernel<DH, kMode>, a));
}

// The widths the kernels take: 16-byte rows, a LayerNorm slice in kMaxCols
// columns a lane (the launch also refuses a width whose shared memory passes
// 227 KB).
bool fits(int D, int F) {
  return D > 0 && D % 8 == 0 && D <= 32 * kMaxCols * kCS && F > 0 && F % 8 == 0;
}

// 16-byte aligned pieces of the scratch, in floats
size_t piece(size_t floats) { return (floats + 3) / 4 * 4; }

}  // namespace
}  // namespace dl
}  // namespace olm

namespace olm {
namespace dl {
namespace {

// Whether the card takes a cooperative launch in thread-block clusters: each
// block reads its cluster neighbour's shared memory, then every block meets
// at a grid-wide barrier.
__global__ void __launch_bounds__(kThreads) cluster_check_kernel(int* out) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ int mine;
  if (threadIdx.x == 0) mine = blockIdx.x;
  cluster.sync();
  const int theirs = *cluster.map_shared_rank(&mine, (cluster.block_rank() + 1) % cluster.num_blocks());
  cg::this_grid().sync();
  cluster.sync();  // the neighbour's shared memory stays until every read is done
  if (threadIdx.x == 0) out[blockIdx.x] = theirs;
}

// What the phases' steps cost a block, launched as the layer is (clusters of
// kCS, cooperative, `smem` bytes of shared memory a block): the global timer
// after each step into t[block * 11 + step]: 0 start; 1 a 24 KB cp.async copy
// of the block's own rows of src; 2 the same copy of rows every block reads;
// 3 the same 24 KB as 16-byte loads and shared stores; 4 ten cluster
// barriers; 5 ten grid barriers; 6 a 24 KB cp.async copy from another 4 MB
// region; 7 four ranks' 8 KB of shared memory read over the cluster; 8-10
// below.
__global__ void __launch_bounds__(kThreads, 1) step_probe_kernel(const uint4* src,
                                                                 unsigned long long* t,
                                                                 float* sink) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(128) char smem[];
  uint4* buf = reinterpret_cast<uint4*>(smem);
  constexpr int kChunks = 24 * 1024 / 16;
  auto mark = [&](int i) {
    if (threadIdx.x == 0) {
      unsigned long long v;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));
      t[blockIdx.x * 11 + i] = v;
    }
  };
  auto copy = [&](const uint4* from) {
    for (int i = threadIdx.x; i < kChunks; i += kThreads) cp_async16(buf + i, from + i, true);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
  };
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cluster = cg::this_cluster();
  grid.sync();
  mark(0);
  copy(src + static_cast<size_t>(blockIdx.x) * kChunks);
  mark(1);
  copy(src);
  mark(2);
  for (int i = threadIdx.x; i < kChunks; i += kThreads) buf[kChunks + i] = __ldcg(src + i + kChunks);
  __syncthreads();
  mark(3);
  for (int i = 0; i < 10; ++i) cluster.sync();
  mark(4);
  for (int i = 0; i < 10; ++i) grid.sync();
  mark(5);
  copy(src + (4u << 20) / 16 + static_cast<size_t>(blockIdx.x) * kChunks);
  mark(6);
  float acc = 0.f;
  const float* mine = reinterpret_cast<const float*>(smem);
  for (int q = 0; q < kCS; ++q)
    for (int i = threadIdx.x; i < 2048; i += kThreads) acc += cluster.map_shared_rank(mine, q)[i];
  cluster.sync();
  mark(7);
  // 8: 4096 dependent fp32 FMAs (the SM clock: 4 cycles each); 9: a
  // LayerNorm-like pass over 64 x 192 fp32 values of shared memory
  float y = acc;
  for (int i = 0; i < 4096; ++i) y = fmaf(y, 0.999f, 0.5f);
  mark(8);
  const float* vals = reinterpret_cast<const float*>(smem);
  __nv_bfloat16* outs = reinterpret_cast<__nv_bfloat16*>(smem + 64 * 192 * 4);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < 64; r += kWarps)
#pragma unroll
    for (int j = 0; j < 6; ++j)
      outs[r * 200 + lane + 32 * j] = __float2bfloat16((vals[r * 192 + lane + 32 * j] - 0.5f) * 1.5f);
  __syncthreads();
  mark(9);
  for (int r = warp; r < 64; r += kWarps)  // 10: the same pass again, its code now cached
#pragma unroll
    for (int j = 0; j < 6; ++j)
      outs[r * 200 + lane + 32 * j] = __float2bfloat16((vals[r * 192 + lane + 32 * j] - 0.25f) * 1.5f);
  __syncthreads();
  mark(10);
  if (acc == 12345.f || y == 12345.f) sink[blockIdx.x] = acc + y;  // keeps the work
}

}  // namespace
}  // namespace dl
}  // namespace olm

// Runs step_probe_kernel at the layer's launch shape with `smem` bytes of
// shared memory: t (grid * 11 marks), src (at least 8 MB), sink (grid floats);
// *grid: its blocks.
extern "C" int olm_decode_layer_step_probe(const void* src, unsigned long long* t, float* sink,
                                           int smem, int* grid, void* stream) {
  using namespace olm::dl;
  cudaError_t err = cudaFuncSetAttribute(step_probe_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCS, attr[0].val.clusterDim.y = 1, attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(kCS);
  int clusters = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&clusters, step_probe_kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  *grid = clusters * kCS;
  cfg.gridDim = dim3(*grid);
  cfg.numAttrs = 2;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, step_probe_kernel, static_cast<const uint4*>(src), t, sink));
}

// Launches cluster_check_kernel cooperatively in clusters of `cluster` blocks,
// as many as fit at once (*grid: their blocks; out needs that many ints);
// returns the launch's error (0: the card takes it).
extern "C" int olm_cluster_cooperative_check(int cluster, int* out, int* grid, void* stream) {
  using namespace olm::dl;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster, attr[0].val.clusterDim.y = 1, attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(cluster);
  int clusters = 0;
  cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, cluster_check_kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  *grid = clusters * cluster;
  cfg.gridDim = dim3(*grid);
  cfg.numAttrs = 2;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, cluster_check_kernel, out));
}

// fp32 scratch floats that olm_decode_layer needs (F = 0: "sc"); 0 on
// unsupported widths.
extern "C" long long olm_decode_layer_scratch(int B, int D, int F) {
  using namespace olm::dl;
  if (B <= 0 || !fits(D, F > 0 ? F : 8)) return 0;
  const size_t BD = static_cast<size_t>(B) * D;
  return static_cast<long long>(piece(3 * BD) + 2 * piece(BD) + piece(BD / 2 + 1) +
                                piece(static_cast<size_t>(B) * F / 2 + 1));
}

// bf16 only. x, out: (B, D); rings: the stacked (L, B, C, D); ck, cv: (B, T,
// D) int8 with (B, T) scales; kv_new: (2, B, D). The MLP's ln3_g, ln3_b (D),
// w1 (F, D), b1 (F), w2 (D, F), b2 (D) with F > 0, or all null with F = 0
// ("sc"). All 16-byte aligned. scratch: olm_decode_layer_scratch(B, D, F)
// floats. Head widths 32, 64 and 128. trace: null, or (SMs, 32) phase marks
// (kMarks) for the probe.
extern "C" int olm_decode_layer(const void* x, const void* ln1_g, const void* ln1_b,
                                const void* wqkv, const void* bqkv, const void* wo1,
                                const void* bo1, const void* ln2_g, const void* ln2_b,
                                const void* wq, const void* bq, const void* wo2, const void* bo2,
                                const void* ln3_g, const void* ln3_b, const void* w1,
                                const void* b1, const void* w2, const void* b2,
                                const void* k_ring, const void* v_ring, const void* ck,
                                const void* cv, const float* cks, const float* cvs, void* out,
                                void* kv_new, float* scratch, int L, int layer, int B, int C,
                                int offset, int D, int H, int T, int F, float qscale,
                                unsigned long long* trace, void* stream) {
  using namespace olm::dl;
  if (B <= 0 || H <= 0 || D % H != 0 || T <= 0 || layer < 0 || layer >= L || offset < 0 ||
      offset > C || !fits(D, F > 0 ? F : 8))
    return cudaErrorInvalidValue;
  const bool mlp = F > 0;
  for (const void* w : {ln3_g, ln3_b, w1, b1, w2, b2})
    if ((w != nullptr) != mlp) return cudaErrorInvalidValue;
  auto c = [](const void* p) { return static_cast<const bf*>(p); };
  const size_t BD = static_cast<size_t>(B) * D, ring = static_cast<size_t>(layer) * B * C * D;
  LayerArgs a{};
  a.x = c(x);
  a.ln1_g = c(ln1_g), a.ln1_b = c(ln1_b), a.wqkv = c(wqkv), a.bqkv = c(bqkv), a.wo1 = c(wo1);
  a.bo1 = c(bo1), a.ln2_g = c(ln2_g), a.ln2_b = c(ln2_b), a.wq = c(wq), a.bq = c(bq);
  a.wo2 = c(wo2), a.bo2 = c(bo2), a.ln3_g = c(ln3_g), a.ln3_b = c(ln3_b), a.w1 = c(w1);
  a.b1 = c(b1), a.w2 = c(w2), a.b2 = c(b2);
  a.k_ring = c(k_ring) + ring;
  a.v_ring = c(v_ring) + ring;
  a.ck = static_cast<const int8_t*>(ck);
  a.cv = static_cast<const int8_t*>(cv);
  a.cks = cks, a.cvs = cvs;
  a.out = static_cast<bf*>(out);
  a.kv_new = static_cast<bf*>(kv_new);
  float* s = scratch;
  a.qkv = s;
  a.x1 = s += piece(3 * BD);
  a.qc = s += piece(BD);
  a.attn = reinterpret_cast<bf*>(s += piece(BD));
  a.u = reinterpret_cast<bf*>(s + piece(BD / 2 + 1));
  a.B = B, a.D = D, a.H = H, a.C = C, a.offset = offset, a.T = T, a.F = F;
  a.qscale = qscale;
  a.trace = trace;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D / H) {
    case 32: return mlp ? launch<32, kLayer>(a, st) : launch<32, kSc>(a, st);
    case 64: return mlp ? launch<64, kLayer>(a, st) : launch<64, kSc>(a, st);
    case 128: return mlp ? launch<128, kLayer>(a, st) : launch<128, kSc>(a, st);
    default: return cudaErrorInvalidValue;
  }
}
