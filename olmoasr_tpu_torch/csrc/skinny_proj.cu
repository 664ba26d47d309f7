// Skinny bf16 projection for the decode step in ONE launch a product:
// out = epilogue(A @ W^T), K split over the blocks of a thread-block
// cluster and the split partials summed in distributed shared memory; and
// the row LayerNorm that feeds a product.
//
// Replaces, on the bf16 path, the projections of four TPU kernels of
// olmoasr_tpu/ops/attention.py (every bf16 projection of the split decode
// chain):
//   * matmul_residual (_matmul_residual_kernel, :412): one launch, A the
//     attention output, epilogue + bias + residual;
//   * mlp_block (_mlp_kernel, :669): three launches, the LayerNorm of x into
//     bf16 h, W1 over h with a bias + exact GELU epilogue into bf16 u (M, F),
//     then W2 over u with a bias + residual epilogue;
//   * ln_matmul (_ln_matmul_kernel, :354): two launches, the LayerNorm, then
//     the fused QKV projection (N = 3D) with a bias epilogue;
//   * cross_block_decode (_cross_block_kernel, :897): its LayerNorm, its q
//     projection with a bias epilogue stored in fp32 unrounded (the cross
//     pass of cross_attention.cu reads fp32 q), and its output projection
//     with a bias + residual epilogue.
// The fp32 paths of all four stay on linear.cu (checks, not speed).
//
// What they compute (the plain twins of ops/attention.py define it): h is
// the fp32 LayerNorm (eps 1e-5, two passes) rounded to bf16; each product is
// summed in fp32, then v + bias, the GELU, residual + v, in fp32, and one
// rounding at the store (none where the output is fp32).
//
// What bounds them. At the decode step's rows (64 greedy, 80 long-form, 160
// for 32 windows x 5 beams) a product moves its weight once (small.en: Wo
// and Wq 1.2 MB, QKV 3.5 MB, W1 and W2 4.7 MB each: 0.35-1.4 us at
// 3.35 TB/s) and its 2 * M * N * K operations are far below the tensor
// cores' rate, so a launch is bound by latency: its start, device memory's,
// the barriers'. The split-K linear these launches replaced wrote fp32
// partials as large as the weight through device memory and summed them in
// a second launch.
//
// The design against that:
//   * One ordinary launch a product. The grid is (N / kBN column tiles) x CS
//     blocks in clusters of CS; a cluster's blocks take one K slice each of
//     one column tile. Each block sends its fp32 partial of row r straight
//     into the shared memory of rank r % CS (st.async, distributed shared
//     memory), which counts the bytes on that rank's mbarrier; each rank
//     waits for its rows' bytes, adds the CS partials in rank order,
//     applies the epilogue and stores. No partial goes through device
//     memory, no launch sums them, no cluster barrier follows the sends, and
//     the sum does not depend on timing: two calls give the same bits.
//   * Up to two blocks an SM, each streaming its (column tile, K slice) of W
//     and of A through a cp.async ring of 2 stages up to 64 rows and 3
//     above (a ring with all of a slice in flight at once was no faster: its
//     issue stalls once the SM's loads are queued). A block covers up to
//     kMaxRows = 160 rows (the beam's 32 x 5) in one pass over its W; more
//     rows take further passes. Where the grid is small (Wo, Wq), or the rows
//     pass 128 and the grid stays within 192 blocks (W2), the rows are spread
//     over two groups of blocks, each of which streams W (the second read
//     mostly from L2): twice the blocks in flight beat the single read there
//     (perf/probe_proj.py's sweep).
//   * Each launch is programmatically dependent on the launch before it: its
//     blocks start while that one drains and stream their W, which does not
//     depend on it, before griddepcontrol.wait; A and the residual are read
//     after it. Each launch lets the next one start once its own stream is
//     done (griddepcontrol.launch_dependents); the LayerNorm lets the
//     product after it start at once. (cross_block_decode's Wo follows the
//     cross pass's combine, which lets nothing start early: Wo's blocks
//     start as the combine's last blocks end.)
//   * mma.sync m16n8k16, bf16 operands, fp32 accumulation, operands through
//     ldmatrix from padded shared rows (an odd number of 16-byte chunks, so
//     the 8 rows an ldmatrix reads fall in 8 bank groups). A warp takes
//     whole 16-row tiles across several 8-column blocks and loads each A
//     fragment once for all of them (up to 4 tiles: a tile and half the
//     columns a warp; up to 8: a tile and every column; more: up to three
//     tiles and half the columns); with a warp a column block instead, the
//     A fragments' reads from shared memory took most of the stream
//     (perf/probe_proj.py). The shares are compile-time, so the loads and
//     products carry no branches but a warp's skip of a tile past the rows.
//
// The LayerNorm: a warp a row, its 16-byte chunks in registers, two passes
// over them in fp32.
//
// olm_proj is the decode path's entry; olm_proj_probe, for
// perf/probe_proj.py and the tests alone, names the cluster size and row
// groups, turns the programmatic dependence off and takes timer marks.
#include <cooperative_groups.h>

#include <algorithm>
#include <vector>

#include "attention_mma.cuh"
#include "common.cuh"

namespace olm {
namespace sp {
namespace {

namespace cg = cooperative_groups;
using bf = __nv_bfloat16;
using mma::ldsm_x4;
using mma::mma16816;

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kBN = 64;        // output columns of a block: 8 column blocks of 8
constexpr int kKC = 64;        // K columns of a ring stage
constexpr int kLd = kKC + 8;   // a stage's row in shared memory, padded
constexpr int kMaxRows = 160;  // rows of a pass: 32 windows x 5 beams
constexpr int kMaxCS = 8;      // the portable cluster size
constexpr int kLnChunks = 5;   // 16-byte chunks of a LayerNorm row a lane holds: K up to 1280
constexpr int kMarks = 7;      // timer marks a block writes when traced
constexpr int kSmemMax = 232448;

__host__ __device__ constexpr int cdiv(int n, int m) { return (n + m - 1) / m; }
__host__ __device__ constexpr int round_up(int n, int m) { return cdiv(n, m) * m; }

struct Args {
  const bf* a;      // (M, K)
  const bf* w;      // (N, K)
  const bf* bias;   // (N,)
  const bf* resid;  // (M, N), or null
  void* out;        // (M, N): bf16, or fp32 where out_f32
  unsigned long long* trace;  // (grid, kMarks) global-timer marks, or null
  int M, N, K;
  int gelu;
  int out_f32;  // store the fp32 sums unrounded
  int mp;     // rows of a pass: a multiple of 16, at most kMaxRows
  int ns;     // ring stages, 2 or 3
  int slice;  // K columns of a rank: a multiple of kKC
};

// Shared memory: the ring (ns stages of W's kBN rows, then A's mp rows, each
// kLd wide), the partials the cluster's ranks send (CS senders x rows of
// this rank x kBN), and the mbarrier that counts their bytes in.
struct Layout {
  __host__ __device__ static constexpr size_t stage(int mp) { return size_t(kBN + mp) * kLd * 2; }
  __host__ __device__ static constexpr size_t recv(int mp, int ns) { return ns * stage(mp); }
  __host__ __device__ static constexpr size_t mbar(int mp, int ns, int cs) {
    return recv(mp, ns) + size_t(cs) * cdiv(mp, cs) * kBN * 4;
  }
  __host__ __device__ static constexpr size_t bytes(int mp, int ns, int cs) {
    return mbar(mp, ns, cs) + 16;
  }
};

__device__ __forceinline__ void mark(const Args& p, int i) {
  if (p.trace && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    p.trace[(blockIdx.y * gridDim.x + blockIdx.x) * kMarks + i] = t;
  }
}

// wait until at most n (0 or 1) cp.async groups of this thread are pending
__device__ __forceinline__ void cp_wait_n(int n) {
  if (n == 0)
    cp_wait<0>();
  else
    cp_wait<1>();
}

// The partials' exchange: each sender stores its fp32 pairs straight into
// the owner's shared memory with st_async (common.cuh), which counts their
// bytes on the owner's mbarrier; the owner waits for the phase, no cluster
// barrier.

// Where output column n (of a tile's row) sits in a row of received
// partials: the pairs (2t, 2t + 1) of column blocks 2j and 2j + 1 side by
// side, so a thread's pairs of two neighbouring blocks go in one 16-byte
// store.
__device__ __forceinline__ int recv_col(int n) {
  const int nb = n / 8;
  return nb / 2 * 16 + n % 8 / 2 * 4 + nb % 2 * 2 + n % 2;
}
// The programmatic dependence on the launch before (no-ops without one):
// wait until it has finished and its stores are visible; let the launch
// after start.
__device__ __forceinline__ void wait_prior() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void start_next() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// The pieces of stage s of the block's stream: W's (column tile, K chunk s
// of the block's slice) or A's (rows m0.., K chunk s); past the slice
// (s >= nk), none. A thread takes the same 16-byte pieces of every stage.
constexpr int kChunks = kKC / 8;  // 16-byte pieces of a stage's row
static_assert(kBN * kChunks % kThreads == 0, "W's stage in whole rounds of the threads");

__device__ __forceinline__ void issue_w(const Args& p, bf* ring, int s, int nk, int n0, int k0) {
  if (s >= nk) return;
  bf* st = ring + (s % p.ns) * (Layout::stage(p.mp) / 2);
  const int kk = k0 + s * kKC;
#pragma unroll
  for (int q = 0; q < kBN * kChunks / kThreads; ++q) {
    const int i = threadIdx.x + q * kThreads;
    const int r = i / kChunks, k = kk + i % kChunks * 8, n = n0 + r;
    const bool ok = n < p.N && k < p.K;
    cp_async16(st + r * kLd + i % kChunks * 8, p.w + (ok ? static_cast<size_t>(n) * p.K + k : 0),
               ok);
  }
}

__device__ __forceinline__ void issue_a(const Args& p, bf* ring, int s, int nk, int k0, int m0,
                                        int rows, int Mg) {
  if (s >= nk) return;
  bf* as = ring + (s % p.ns) * (Layout::stage(p.mp) / 2) + kBN * kLd;
  const int kk = k0 + s * kKC;
#pragma unroll
  for (int q = 0; q < cdiv(kMaxRows * kChunks, kThreads); ++q) {
    const int i = threadIdx.x + q * kThreads;
    const int r = i / kChunks, k = kk + i % kChunks * 8;
    if (i < rows * kChunks) {
      const bool ok = r < Mg && k < p.K;
      cp_async16(as + r * kLd + i % kChunks * 8,
                 p.a + (ok ? static_cast<size_t>(m0 + r) * p.K + k : 0), ok);
    }
  }
}

// The warps' share of a tile: NW groups of warps split its kBN / 8
// 8-column blocks (NBW = kBN / 8 / NW each, an even number), and the
// MW = 8 / NW warps of a group its 16-row tiles (m = mw + MW i, i < P; a
// warp skips the tiles past mt). Each A fragment a warp loads serves its
// NBW column blocks.
template <int NW>
struct Warps {
  static constexpr int NB = kBN / 8, NBW = NB / NW, MW = kWarps / NW;
  static_assert(NBW % 2 == 0 && NB % NW == 0, "whole pairs of 8-column blocks a warp");
};

// One stage's products for a warp: for each 16-column k-step, the B
// fragments of its column blocks and its P A fragments, all loaded before
// their products so the loads' latencies overlap.
template <int NW, int P>
__device__ __forceinline__ void stage_mma(float (&acc)[P][Warps<NW>::NBW][4], const bf* ws,
                                          const bf* as, int nb0, int mw, int mt, int lane) {
  using Wp = Warps<NW>;
  constexpr int NBW = Wp::NBW;
#pragma unroll
  for (int j = 0; j < kKC / 16; ++j) {
    uint32_t b[NBW][2];
#pragma unroll
    for (int c = 0; c < NBW; c += 2) {  // column blocks c and c + 1
      uint32_t r[4];
      ldsm_x4(r, smem_u32(ws + ((nb0 + c + (lane >> 4)) * 8 + (lane & 7)) * kLd + j * 16 +
                          (lane >> 3 & 1) * 8));
      b[c][0] = r[0], b[c][1] = r[1], b[c + 1][0] = r[2], b[c + 1][1] = r[3];
    }
    uint32_t a[P][4];
#pragma unroll
    for (int i = 0; i < P; ++i)
      if (mw + Wp::MW * i < mt)
        ldsm_x4(a[i], smem_u32(as + ((mw + Wp::MW * i) * 16 + (lane & 15)) * kLd + j * 16 +
                               (lane >> 4) * 8));
#pragma unroll
    for (int i = 0; i < P; ++i)
      if (mw + Wp::MW * i < mt)
#pragma unroll
        for (int c = 0; c < NBW; ++c) mma16816(acc[i][c], a[i], b[c][0], b[c][1]);
  }
}

// The stream of one pass (every stage's products for the warp's tiles; the
// first ns - 1 stages are in flight already) and the sends of its partials:
// row r of the pass to rank r % cs, at that rank's row r / cs of this
// sender. `first`: the first pass, whose sends wait for the start barrier.
template <int NW, int P>
__device__ __forceinline__ void stream_send(const Args& p, bf* ring, float* recv, uint32_t mbar,
                                            int n0, int k0, int m0, int rows, int Mg,
                                            int cs, int rank, bool first) {
  using Wp = Warps<NW>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int mw = warp / NW, nb0 = warp % NW * Wp::NBW;
  const int nk = p.slice / kKC, mt = rows / 16, rpr = cdiv(p.mp, cs);
  float acc[P][Wp::NBW][4] = {};
  for (int s = 0; s < nk; ++s) {
    cp_wait_n(p.ns - 2);
    __syncthreads();
    if (first && s == 0) mark(p, 3);  // the first stage in
    issue_w(p, ring, s + p.ns - 1, nk, n0, k0);
    issue_a(p, ring, s + p.ns - 1, nk, k0, m0, rows, Mg);
    cp_commit();
    const bf* ws = ring + (s % p.ns) * (Layout::stage(p.mp) / 2);
    if (mw < mt) stage_mma<NW, P>(acc, ws, ws + kBN * kLd, nb0, mw, mt, lane);
  }
  if (first) {
    mark(p, 4);  // the stream done
    start_next();
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");  // the start barrier
  }
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int m = mw + Wp::MW * i;
    if (m < mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m * 16 + g + 8 * h, q = r % cs;
        const uint32_t row = mapa(smem_u32(recv + (rank * rpr + r / cs) * kBN), q);
        const uint32_t bar = mapa(mbar, q);
#pragma unroll
        for (int c = 0; c < Wp::NBW; c += 2)  // column blocks nb0 + c, nb0 + c + 1: 16 bytes
          st_async(row + 4 * recv_col((nb0 + c) * 8 + 2 * t),
                   make_float4(acc[i][c][2 * h], acc[i][c][2 * h + 1], acc[i][c + 1][2 * h],
                               acc[i][c + 1][2 * h + 1]),
                   bar);
      }
    }
  }
}

// stream_send at the pass's 16-row tiles mt, in compile-time shares: up to
// 4 tiles, a tile a warp and half the columns; up to 8, a tile a warp and
// every column; more (up to 12), three tiles a warp and half the columns
__device__ __forceinline__ void stream_send_mt(int mt, const Args& p, bf* ring, float* recv,
                                               uint32_t mbar, int n0, int k0, int m0,
                                               int rows, int Mg, int cs, int rank, bool first) {
  static_assert(kMaxRows / 16 <= kWarps / 2 * 3, "the widest share covers every tile");
  if (mt <= kWarps / 2)
    stream_send<2, 1>(p, ring, recv, mbar, n0, k0, m0, rows, Mg, cs, rank, first);
  else if (mt <= kWarps)
    stream_send<1, 1>(p, ring, recv, mbar, n0, k0, m0, rows, Mg, cs, rank, first);
  else
    stream_send<2, 3>(p, ring, recv, mbar, n0, k0, m0, rows, Mg, cs, rank, first);
}

// The epilogue of a pair of outputs (m, n), (m, n + 1), from their fp32
// sums: + bias, the GELU, residual + that (zeros without one), one rounding
// at a bf16 store, none at an fp32 one.
__device__ __forceinline__ void store_pair(const Args& p, int m, int n, float2 v, float2 bias,
                                           float2 res) {
  v.x += bias.x;
  v.y += bias.y;
  if (p.gelu) {
    v.x = gelu_erf(v.x);
    v.y = gelu_erf(v.y);
  }
  if (p.resid) {
    v.x = res.x + v.x;
    v.y = res.y + v.y;
  }
  const size_t i = static_cast<size_t>(m) * p.N + n;
  if (p.out_f32)
    *reinterpret_cast<float2*>(static_cast<float*>(p.out) + i) = v;
  else
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf*>(p.out) + i) =
        __floats2bfloat162_rn(v.x, v.y);
}

__device__ __forceinline__ float2 load_pair(const bf* x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x));
}

__global__ void __launch_bounds__(kThreads, 2) proj_kernel(Args p) {
  constexpr int kPre = 4;  // outputs a thread loads the bias and residual of before the sums
  extern __shared__ __align__(16) char smem[];
  mark(p, 0);
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks()), rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / cs, n0 = tile * kBN, k0 = rank * p.slice, nk = p.slice / kKC;
  const int rpr = cdiv(p.mp, cs);  // rows a rank stores
  bf* ring = reinterpret_cast<bf*>(smem);
  float* recv = reinterpret_cast<float*>(smem + Layout::recv(p.mp, p.ns));
  const uint32_t mbar = smem_u32(smem + Layout::mbar(p.mp, p.ns, cs));
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(mbar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every block of the cluster has started, its mbarrier ready, before any
  // sends into its shared memory: arrive now, wait before the first send
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  // W does not depend on the launch before: its first stages go out first
  for (int s = 0; s < p.ns - 1; ++s) issue_w(p, ring, s, nk, n0, k0);
  cp_commit();
  mark(p, 1);  // W's first stages issued
  wait_prior();
  // row group blockIdx.y takes rows m0.. of mp each pass, every gridDim.y-th
  for (int m0 = blockIdx.y * p.mp, pass = 0; m0 < p.M; m0 += gridDim.y * p.mp, ++pass) {
    const int Mg = min(p.mp, p.M - m0), mt = cdiv(Mg, 16), rows = 16 * mt;
    // the bytes of this pass's partials every rank sends this one: its
    // rows r < rows with r % cs == rank, kBN columns of fp32 each
    if (threadIdx.x == 0)
      expect_bytes(mbar, cs * (rows / cs + (rank < rows % cs)) * kBN * 4);
    if (pass > 0) {
      for (int s = 0; s < p.ns - 1; ++s) issue_w(p, ring, s, nk, n0, k0);
      cp_commit();
    }
    // A's first stages, each its own group: stage s's pieces are in once
    // the groups after A's stage s number at most ns - 2
    for (int s = 0; s < p.ns - 1; ++s) {
      issue_a(p, ring, s, nk, k0, m0, rows, Mg);
      cp_commit();
    }
    if (pass == 0) mark(p, 2);  // A's first stages issued
    stream_send_mt(mt, p, ring, recv, mbar, n0, k0, m0, rows, Mg, cs, rank, pass == 0);
    // this rank's outputs, two neighbouring columns a thread; the bias and
    // residual of the first kPre load while the partials land
    const int items = rpr * (kBN / 2);
    auto where = [&](int i, int& r, int& c) {
      r = i / (kBN / 2) * cs + rank;
      c = 2 * (i % (kBN / 2));
      return i < items && r < Mg && n0 + c < p.N;
    };
    auto load = [&](int r, int c, float2& bias, float2& res) {
      bias = load_pair(p.bias + n0 + c);
      res = p.resid ? load_pair(p.resid + static_cast<size_t>(m0 + r) * p.N + n0 + c)
                    : make_float2(0.f, 0.f);
    };
    // the partials of this rank's row lr = i / (kBN / 2), summed in rank order
    auto finish = [&](int i, int r, int c, float2 bias, float2 res) {
      const int lr = i / (kBN / 2);
      float2 v = make_float2(0.f, 0.f);
#pragma unroll 4
      for (int q = 0; q < cs; ++q) {  // rank order
        const float2 x = *reinterpret_cast<const float2*>(recv + (q * rpr + lr) * kBN + recv_col(c));
        v.x += x.x;
        v.y += x.y;
      }
      store_pair(p, m0 + r, n0 + c, v, bias, res);
    };
    float2 pre_b[kPre], pre_r[kPre];
#pragma unroll
    for (int o = 0; o < kPre; ++o) {
      int r, c;
      if (where(threadIdx.x + o * kThreads, r, c)) load(r, c, pre_b[o], pre_r[o]);
    }
    wait_phase(mbar, pass & 1);
    if (pass == 0) mark(p, 5);  // the partials in
#pragma unroll
    for (int o = 0; o < kPre; ++o) {
      int r, c;
      const int i = threadIdx.x + o * kThreads;
      if (where(i, r, c)) finish(i, r, c, pre_b[o], pre_r[o]);
    }
    for (int i = threadIdx.x + kPre * kThreads; i < items; i += kThreads) {
      int r, c;
      float2 bias, res;
      if (where(i, r, c)) {
        load(r, c, bias, res);
        finish(i, r, c, bias, res);
      }
    }
    if (m0 + gridDim.y * p.mp < p.M) cluster.sync();  // every rank has read these partials
  }
  mark(p, 6);  // the stores issued
}

// ---------------------------------------------------------------------------
// the row LayerNorm
// ---------------------------------------------------------------------------

// h = round(LN(x)) for one row a warp, CH 16-byte chunks of the row a lane.
template <int CH>
__global__ void __launch_bounds__(kThreads) ln_kernel(const bf* __restrict__ x,
                                                      const bf* __restrict__ g,
                                                      const bf* __restrict__ b,
                                                      bf* __restrict__ h, int M, int K) {
  start_next();  // the product after reads h only after griddepcontrol.wait
  const int row = blockIdx.x * kWarps + threadIdx.x / 32, lane = threadIdx.x % 32, kch = K / 8;
  if (row >= M) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * K);
  uint4 v[CH];
#pragma unroll
  for (int j = 0; j < CH; ++j)
    v[j] = lane + 32 * j < kch ? xr[lane + 32 * j] : make_uint4(0, 0, 0, 0);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&v[j]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(e[q]);
      s += f.x + f.y;
    }
  }
  const float mean = warp_sum(s) / K;
  float d2 = 0.f;
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    if (lane + 32 * j < kch) {
      const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&v[j]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(e[q]);
        d2 += (f.x - mean) * (f.x - mean) + (f.y - mean) * (f.y - mean);
      }
    }
  }
  const float rstd = 1.0f / sqrtf(warp_sum(d2) / K + 1e-5f);
  uint4* hr = reinterpret_cast<uint4*>(h + static_cast<size_t>(row) * K);
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int c = lane + 32 * j;
    if (c < kch) {
      const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&v[j]);
      const uint4 gv = reinterpret_cast<const uint4*>(g)[c], bv = reinterpret_cast<const uint4*>(b)[c];
      const __nv_bfloat162* ge = reinterpret_cast<const __nv_bfloat162*>(&gv);
      const __nv_bfloat162* be = reinterpret_cast<const __nv_bfloat162*>(&bv);
      uint4 o;
      __nv_bfloat162* oe = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(e[q]), gf = __bfloat1622float2(ge[q]),
                     bf2 = __bfloat1622float2(be[q]);
        oe[q] = __floats2bfloat162_rn((f.x - mean) * rstd * gf.x + bf2.x,
                                      (f.y - mean) * rstd * gf.y + bf2.y);
      }
      hr[c] = o;
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

constexpr int kMaxDevices = 64;

// The cluster size and row groups a shape takes unless the probe names them
// (perf/probe_proj.py's sweeps at small.en's products and 64, 80 and 160
// rows): K slices of 192 columns or more, at most 8 of them, each a whole
// number of ring stages and none of them empty. Where that grid would hold
// 49-160 blocks, under one and a quarter an SM (QKV: 144), the grid doubles:
// up to 128 rows with slices of 128 columns or more (QKV: 6 x 128, 216
// blocks), past them with slices of 256 or more over two groups of rows
// (QKV: 3 x 256 x 2 groups). (Past 128 rows QKV's 6 slices of 128 cost 4 us
// a call more when launched programmatically dependent on the LayerNorm
// than when not, two blocks of 106 KB an SM; 3 x 2 groups of 83 KB do not.)
// W2, whose 8 slices are the most there are, keeps them. Otherwise the
// rows spread over two groups of blocks where the grid would have 48
// blocks or fewer (Wo, Wq), or the rows pass 128 (the beam's) and two
// groups stay within 192 blocks (W2; not W1).
void choose(int M, int N, int K, int& cs, int& rg) {
  if (cs == 0) {
    const int tiles = cdiv(N, kBN);
    int want = std::clamp(K / 192, 1, kMaxCS);
    if (tiles * want > 48 && tiles * want <= 160) {
      if (M <= 128) {
        want = std::clamp(K / 128, want, kMaxCS);
      } else {
        want = std::clamp(K / 256, 1, kMaxCS);
        if (rg == 0) rg = 2;
      }
    }
    cs = cdiv(K, round_up(cdiv(K, want), kKC));
  }
  if (rg == 0) {
    const int blocks = cdiv(N, kBN) * cs;
    rg = blocks <= 48 || (M > 128 && 2 * blocks <= 192) ? 2 : 1;
  }
}

int proj(const void* a, const void* w, const void* bias, const void* resid, void* out, int M,
         int N, int K, int gelu, int out_f32, int cs, int rg, bool pdl,
         unsigned long long* trace, cudaStream_t stream) {
  static int sms[kMaxDevices] = {};  // each device's SM count, 0 until its first launch
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 != 0 || N % 2 != 0 || bias == nullptr || cs < 0 ||
      rg < 0)
    return cudaErrorInvalidValue;
  choose(M, N, K, cs, rg);
  if (cs < 1 || cs > kMaxCS) return cudaErrorInvalidValue;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {  // once a device: its SM count and the kernel's shared-memory ceiling
    int n = 0;
    cudaError_t err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(proj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemMax);
    if (err != cudaSuccess) return static_cast<int>(err);
    sms[dev] = n;
  }
  // rows of a pass: the rows spread over rg groups, none of them empty
  Args p{static_cast<const bf*>(a), static_cast<const bf*>(w), static_cast<const bf*>(bias),
         static_cast<const bf*>(resid), out, trace, M, N, K, gelu != 0, out_f32 != 0,
         std::min(round_up(cdiv(M, rg), 16), kMaxRows), 2, round_up(cdiv(K, cs), kKC)};
  const int groups = std::min(rg, cdiv(M, p.mp));
  const int grid_x = cdiv(N, kBN) * cs, blocks = grid_x * groups;
  // shared memory for the blocks an SM must hold so that the grid runs at
  // once (228 KB an SM, 1 KB of it the system's a block); the ring: two
  // stages up to 64 rows, three above (perf/probe_proj.py: more stages in
  // flight at once only slowed the block's start), fewer where they do not fit
  const size_t budget = std::min<size_t>(kSmemMax, 233472 / cdiv(blocks, sms[dev]) - 1024);
  p.ns = std::min(p.mp <= 64 ? 2 : 3, p.slice / kKC + 1);
  while (p.ns > 2 && Layout::bytes(p.mp, p.ns, cs) > budget) --p.ns;
  const size_t smem = Layout::bytes(p.mp, p.ns, cs);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_x, groups);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs, attr[0].val.clusterDim.y = 1, attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 2 : 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, proj_kernel, p));
}

}  // namespace
}  // namespace sp
}  // namespace olm

// out (M, N) = epilogue(A @ W^T): bf16 operands, resid may be null; out is
// bf16 (one rounding at the store), or fp32 unrounded where out_f32;
// launched programmatically dependent on the launch before it in the stream.
extern "C" int olm_proj(const void* a, const void* w, const void* bias, const void* resid,
                        void* out, int M, int N, int K, int gelu, int out_f32, void* stream) {
  return olm::sp::proj(a, w, bias, resid, out, M, N, K, gelu, out_f32, 0, 0, true, nullptr,
                       static_cast<cudaStream_t>(stream));
}

// olm_proj for perf/probe_proj.py and the tests: cs (1..8) and rg name the
// cluster size and how many groups of blocks the rows are spread over (0:
// olm_proj's choice); pdl 0 makes the launch wait for the one before in
// full; trace, if not null, takes sp::kMarks global-timer marks a block.
extern "C" int olm_proj_probe(const void* a, const void* w, const void* bias, const void* resid,
                              void* out, int M, int N, int K, int gelu, int out_f32, int cs,
                              int rg, int pdl, unsigned long long* trace, void* stream) {
  return olm::sp::proj(a, w, bias, resid, out, M, N, K, gelu, out_f32, cs, rg, pdl != 0, trace,
                       static_cast<cudaStream_t>(stream));
}

// h (M, K) = round(LN(x)), eps 1e-5, bf16; K at most 1280.
extern "C" int olm_proj_layer_norm(const void* x, const void* g, const void* b, void* h, int M,
                                   int K, void* stream) {
  using namespace olm::sp;
  if (M <= 0 || K <= 0 || K % 8 != 0 || K > 32 * 8 * kLnChunks) return cudaErrorInvalidValue;
  const dim3 grid(cdiv(M, kWarps));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const bf*>(x);
  const auto *gb = static_cast<const bf*>(g), *bb = static_cast<const bf*>(b);
  auto* hb = static_cast<bf*>(h);
  if (K <= 32 * 8 * 3)
    ln_kernel<3><<<grid, kThreads, 0, s>>>(xb, gb, bb, hb, M, K);
  else if (K <= 32 * 8 * 4)
    ln_kernel<4><<<grid, kThreads, 0, s>>>(xb, gb, bb, hb, M, K);
  else
    ln_kernel<kLnChunks><<<grid, kThreads, 0, s>>>(xb, gb, bb, hb, M, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int olm_proj_marks() { return olm::sp::kMarks; }

// The edges of a captured CUDA graph (a cudaGraph_t) that wait on a launch's
// programmatic trigger instead of its completion: whether capture kept the
// launches' programmatic dependence. -1 on an error.
extern "C" int olm_graph_programmatic_edges(void* graph) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t n = 0;
  if (cudaGraphGetEdges_v2(g, nullptr, nullptr, nullptr, &n) != cudaSuccess) return -1;
  std::vector<cudaGraphNode_t> from(n), to(n);
  std::vector<cudaGraphEdgeData> data(n);
  if (cudaGraphGetEdges_v2(g, from.data(), to.data(), data.data(), &n) != cudaSuccess) return -1;
  int k = 0;
  for (size_t i = 0; i < n; ++i) k += data[i].type == cudaGraphDependencyTypeProgrammatic;
  return k;
}

// The kernel launches a captured CUDA graph holds (its kernel nodes): the
// device kernels one captured call launches. -1 on an error.
extern "C" int olm_graph_kernel_nodes(void* graph) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t n = 0;
  if (cudaGraphGetNodes(g, nullptr, &n) != cudaSuccess) return -1;
  std::vector<cudaGraphNode_t> nodes(n);
  if (cudaGraphGetNodes(g, nodes.data(), &n) != cudaSuccess) return -1;
  int k = 0;
  for (size_t i = 0; i < n; ++i) {
    cudaGraphNodeType type;
    if (cudaGraphNodeGetType(nodes[i], &type) != cudaSuccess) return -1;
    k += type == cudaGraphNodeTypeKernel;
  }
  return k;
}
