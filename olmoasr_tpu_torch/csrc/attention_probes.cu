// H100 probes of the training-attention kernels (rows 3 and 9): the port of
// the TPU timing probes perf/probe_pack.py (make_seq, make_pack, make_raw),
// perf/probe_pipe.py (make_whole, make_ablate) and perf/probe_bwd.py
// (make_row). Each variant is a template instantiation of the core in
// attention_mma.cuh, so the production kernels carry no runtime flags. The
// Python side (olmoasr_tpu_torch/perf/probe_*.py) names the variants, times
// them and holds each against its plain version.
//
// What they ask on this card: whether a 64- or 128-row query tile, a
// 128-wide head (zero-padded), two heads sharing one block and one ring, a
// deeper ring, or dropping a softmax stage moves the forward's time; whether
// the score product alone runs near the tensor cores' rate; and whether a
// whole-row backward of five products (one cluster of 8 blocks per (b, h),
// the statistics and the dq partials reduced through distributed shared
// memory) beats the production backward's nine.
#include <cooperative_groups.h>

#include "attention_mma.cuh"

namespace olm {
namespace mma {
namespace {

namespace cg = cooperative_groups;


// ---------------------------------------------------------------------------
// raw: the score product alone. out (B, Tq, H * 64) fp32 holds, for each
// query row and head, the sum over the key tiles of the tile's first 64
// score columns: out[b, i, h*64 + j] = sum_t s[i, 64 t + j] (keys past the
// end score 0).
// ---------------------------------------------------------------------------

template <int DH, int BQ, int STAGES>
constexpr size_t scores_smem() {
  return (BQ * DH + STAGES * kBK * DH) * sizeof(bf);
}

template <int DH, int BQ, int STAGES>
__global__ void __launch_bounds__(BQ * 2) attn_scores_mma_kernel(FwdParams p) {
  constexpr int W = DH, NT = BQ * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  bf* Qs = reinterpret_cast<bf*>(smem);
  bf* ring = Qs + BQ * W;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int row0 = warp * 16;
  const size_t hoff = static_cast<size_t>(h) * W;
  const bf* Q = p.q + static_cast<size_t>(b) * p.Tq * p.D + hoff;
  const bf* K = p.k + static_cast<size_t>(b) * p.Tk * p.D + hoff;
  const int nkt = (p.Tk + kBK - 1) / kBK;
  auto fetch = [&](int i) {
    if (i < nkt) load_tile<W, kBK, NT>(ring + (i % STAGES) * kBK * W, K, i * kBK, p.Tk, p.D);
    cp_commit();
  };
  load_tile<W, BQ, NT>(Qs, Q, q0, p.Tq, p.D);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) fetch(s);
  cp_wait<STAGES - 2>();
  scale_tile<W, BQ, NT>(Qs, p.scale);
  __syncthreads();
  uint32_t qf[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) ld_a<W>(qf[kk], Qs, row0, kk * 16);
  float acc[8][4];
  zero(acc);
  for (int i = 0; i < nkt; ++i) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    fetch(i + STAGES - 1);
    const bf* Ks = ring + (i % STAGES) * kBK * W;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        uint32_t bfr[4];
        ld_b_nk<W>(bfr, Ks, nb * 16, kk * 16);
        mma16816(acc[2 * nb], qf[kk], bfr[0], bfr[1]);
        mma16816(acc[2 * nb + 1], qf[kk], bfr[2], bfr[3]);
      }
    }
  }
  float* out = static_cast<float*>(p.out);
  const int ld = p.H * 64;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + row0 + g + 8 * r;
    if (qi >= p.Tq) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(out + (static_cast<size_t>(b) * p.Tq + qi) * ld + h * 64 + 8 * j +
                                 2 * tq) = make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
  }
}

template <int DH, int BQ, int STAGES>
int launch_scores(const FwdParams& p, cudaStream_t stream) {
  constexpr size_t kSmem = scores_smem<DH, BQ, STAGES>();
  auto kernel = attn_scores_mma_kernel<DH, BQ, STAGES>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (configured != cudaSuccess) return static_cast<int>(configured);
  if (p.D != p.H * DH) return cudaErrorInvalidValue;
  kernel<<<dim3((p.Tq + BQ - 1) / BQ, p.H, p.B), BQ * 2, kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// row: the whole-row backward, the Hopper form of probe_bwd.make_row. One
// cluster of 8 blocks holds one (b, h); block c holds keys [c KC, (c+1) KC)
// of K and V (KC = 64 ceil(Tk / 512), a warp 16 keys) and their dK and dV in
// registers. For each 64-row query tile every block computes S^T and dP^T
// of its keys, its share of each query's (max, sum p, sum p dp), combined in
// a fixed order over its warps and then over the cluster's blocks through
// distributed shared memory; then pn and ds (the production roundings),
// dV += pn^T . dO, dK += ds^T . q and its dq partial ds . K, and the 8
// partials of each query row are summed in rank order by the block that owns
// the row. Five products, no atomics. No bias and no causal mask.
// ---------------------------------------------------------------------------

constexpr int kCluster = 8;
constexpr int kRowSB = 64;  // query rows a step
constexpr int kRowMaxKC = 192;  // keys a block holds at most (Tk <= 1536)
constexpr int kDqPitch = 68;  // fp32 pitch of the dq partial

__device__ __forceinline__ void combine(float& m, float& l, float& pd, float om, float ol,
                                        float opd) {
  const float nm = fmaxf(m, om);
  if (nm == -INFINITY) return;
  const float a = m == -INFINITY ? 0.f : expf(m - nm);
  const float c = om == -INFINITY ? 0.f : expf(om - nm);
  l = l * a + ol * c;
  pd = pd * a + opd * c;
  m = nm;
}

__host__ __device__ constexpr size_t row_smem(int KC) {
  return static_cast<size_t>(2 * KC * 64 + 2 * 2 * kRowSB * 64 + KC * kRowSB) * sizeof(bf) +
         static_cast<size_t>(kRowSB * kDqPitch + (KC / 16) * kRowSB * 3 + 2 * kRowSB * 3) *
             sizeof(float);
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kRowMaxKC * 2)
    attn_bwd_row_kernel(BwdParams p, int KC) {
  constexpr int W = 64, SB = kRowSB;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int NT = blockDim.x, nw = NT / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  bf* Ks = reinterpret_cast<bf*>(smem);
  bf* Vs = Ks + KC * W;
  bf* ring = Vs + KC * W;  // 2 x (Q, dO)
  bf* dsT = ring + 2 * 2 * SB * W;  // KC x SB: ds^T, bf16
  float* dqp = reinterpret_cast<float*>(dsT + KC * SB);  // SB x kDqPitch
  float* part = dqp + SB * kDqPitch;  // nw x SB x 3: each warp's (max, sum, sum p dp)
  float* xch = part + nw * SB * 3;  // SB x 3: this block's, read by the cluster
  float* fin = xch + SB * 3;  // SB x 3: (max, 1 / l, delta)

  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int key0 = rank * KC, row0 = warp * 16;
  const size_t hoff = static_cast<size_t>(h) * W;
  const bf* Q = p.q + static_cast<size_t>(b) * p.Tq * p.D + hoff;
  const bf* dO = p.dout + static_cast<size_t>(b) * p.Tq * p.D + hoff;
  const bf* K = p.k + static_cast<size_t>(b) * p.Tk * p.D + hoff;
  const bf* V = p.v + static_cast<size_t>(b) * p.Tk * p.D + hoff;

  // loads with blockDim threads (load_tile takes a compile-time count)
  auto load = [&](bf* dst, const bf* src, int r0, int rows, int n) {
    for (int c = threadIdx.x; c < rows * 8; c += NT) {
      const int r = c / 8, ch = c % 8;
      const bool ok = r0 + r < n;
      cp_async16(dst + swz<W>(r, ch), src + static_cast<size_t>(ok ? r0 + r : 0) * p.D + ch * 8,
                 ok);
    }
  };
  const int nqt = (p.Tq + SB - 1) / SB;
  auto fetch = [&](int i) {
    if (i < nqt) {
      bf* Qs = ring + (i % 2) * 2 * SB * W;
      load(Qs, Q, i * SB, SB, p.Tq);
      load(Qs + SB * W, dO, i * SB, SB, p.Tq);
    }
    cp_commit();
  };
  load(Ks, K, key0, KC, p.Tk);
  load(Vs, V, key0, KC, p.Tk);
  fetch(0);

  float dk[8][4], dv[8][4];
  zero(dk);
  zero(dv);
  for (int i = 0; i < nqt; ++i) {
    cp_wait<0>();
    bf* Qs = ring + (i % 2) * 2 * SB * W;
    const bf* dOs = Qs + SB * W;
    for (int c = threadIdx.x; c < SB * 8; c += NT) {  // q's pre-scale, own chunks
      uint4* ptr = reinterpret_cast<uint4*>(Qs + swz<W>(c / 8, c % 8));
      uint4 v = *ptr;
      bf* e = reinterpret_cast<bf*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * p.scale);
      *ptr = v;
    }
    __syncthreads();
    fetch(i + 1);

    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    product_nt<W, 64, 8>(s, Ks, row0, 0, Qs, 0, 0);  // S^T: keys x queries
    product_nt<W, 64, 8>(dp, Vs, row0, 0, dOs, 0, 0);  // dP^T
    if (key0 + row0 + 16 > p.Tk) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + row0 + g + 8 * (e >> 1) >= p.Tk) s[j][e] = -INFINITY;
    }
    // this warp's share of each query column: over its 16 keys (rows g and
    // g + 8 of the 8 lanes that hold the column), a butterfly in fixed order
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        float mx = fmaxf(s[j][cc], s[j][2 + cc]);
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, o));
        float le = 0.f, pe = 0.f;
        if (mx != -INFINITY) {
          const float e0 = expf(s[j][cc] - mx), e1 = expf(s[j][2 + cc] - mx);
          le = e0 + e1;
          pe = e0 * dp[j][cc] + e1 * dp[j][2 + cc];
        }
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          le += __shfl_xor_sync(kFullMask, le, o);
          pe += __shfl_xor_sync(kFullMask, pe, o);
        }
        if (g == 0) {
          float* w = part + (warp * SB + 8 * j + 2 * tq + cc) * 3;
          w[0] = mx;
          w[1] = le;
          w[2] = pe;
        }
      }
    }
    __syncthreads();
    if (threadIdx.x < SB) {  // the block's share, warps in order
      float m = -INFINITY, l = 0.f, pd = 0.f;
      for (int w = 0; w < nw; ++w) {
        const float* x = part + (w * SB + threadIdx.x) * 3;
        combine(m, l, pd, x[0], x[1], x[2]);
      }
      xch[threadIdx.x * 3] = m;
      xch[threadIdx.x * 3 + 1] = l;
      xch[threadIdx.x * 3 + 2] = pd;
    }
    cluster.sync();
    if (threadIdx.x < SB) {  // the row's statistics, blocks in rank order
      float m = -INFINITY, l = 0.f, pd = 0.f;
      for (int r = 0; r < kCluster; ++r) {
        const float* x = cluster.map_shared_rank(xch, r) + threadIdx.x * 3;
        combine(m, l, pd, x[0], x[1], x[2]);
      }
      fin[threadIdx.x * 3] = m;
      fin[threadIdx.x * 3 + 1] = 1.f / l;
      fin[threadIdx.x * 3 + 2] = pd / l;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* f = fin + (8 * j + 2 * tq + (e & 1)) * 3;
        s[j][e] = expf(s[j][e] - f[0]) * f[1];  // pn
      }
    product_pv<W, 8>(dv, s, dOs, 0, 0);  // dV += bf16(pn)^T . dO
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= dp[j][e] - fin[(8 * j + 2 * tq + (e & 1)) * 3 + 2];
    product_pv<W, 8>(dk, s, Qs, 0, 0);  // dK += bf16(ds)^T . q
    stage_acc<SB, 8>(dsT, s, row0, 0, [](float x, int) { return x; });
    __syncthreads();
    // this block's dq partial, transposed: dq^T (64 x SB) = K^T . ds^T, in
    // 8 jobs of 16 dims x 32 queries
    for (int job = warp; job < 8; job += nw) {
      const int d0 = (job & 3) * 16, n0 = (job >> 2) * 32;
      float acc[4][4];
      zero(acc);
      for (int kk = 0; kk < KC / 16; ++kk) {
        uint32_t a[4];  // K^T: the K tile read through ldmatrix.trans
        ldsm_x4_t(a, smem_u32(Ks + swz<W>(kk * 16 + (lane & 7) + ((lane >> 4) << 3),
                                          (d0 >> 3) + ((lane >> 3) & 1))));
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          uint32_t bfr[4];
          ld_b_kn<SB>(bfr, dsT, kk * 16, n0 + nb * 16);
          mma16816(acc[2 * nb], a, bfr[0], bfr[1]);
          mma16816(acc[2 * nb + 1], a, bfr[2], bfr[3]);
        }
      }
#pragma unroll
      for (int jn = 0; jn < 4; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dqp[(n0 + 8 * jn + 2 * tq + (e & 1)) * kDqPitch + d0 + g + 8 * (e >> 1)] = acc[jn][e];
    }
    cluster.sync();
    // the rows this block owns: the 8 partials in rank order, rounded to q's
    // type, then times the scale in q's type
    for (int c = threadIdx.x; c < (SB / kCluster) * 64; c += NT) {
      const int ql = rank * (SB / kCluster) + c / 64, d = c % 64, qi = i * SB + ql;
      float sum = 0.f;
      for (int r = 0; r < kCluster; ++r) sum += cluster.map_shared_rank(dqp, r)[ql * kDqPitch + d];
      if (qi < p.Tq)
        p.dq[(static_cast<size_t>(b) * p.Tq + qi) * p.D + hoff + d] =
            __float2bfloat16(__bfloat162float(__float2bfloat16(sum)) * p.scale);
    }
  }
  __syncwarp();
  stage_acc<W, 8>(Ks, dk, row0, 0, [](float x, int) { return x; });
  stage_acc<W, 8>(Vs, dv, row0, 0, [](float x, int) { return x; });
  __syncwarp();
  store_rows16<W, 64>(p.dk + static_cast<size_t>(b) * p.Tk * p.D + hoff, Ks, row0, 0, key0, p.Tk,
                      p.D);
  store_rows16<W, 64>(p.dv + static_cast<size_t>(b) * p.Tk * p.D + hoff, Vs, row0, 0, key0, p.Tk,
                      p.D);
  cluster.sync();  // no block leaves while another may read its shared memory
}

int launch_row(const BwdParams& p, cudaStream_t stream) {
  static const cudaError_t configured =
      cudaFuncSetAttribute(attn_bwd_row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(row_smem(kRowMaxKC)));
  if (configured != cudaSuccess) return static_cast<int>(configured);
  if (p.bias || p.causal || p.Tk > kCluster * kRowMaxKC || p.D != p.H * 64)
    return cudaErrorInvalidValue;
  const int KC = 64 * ((p.Tk + kCluster * 64 - 1) / (kCluster * 64));
  attn_bwd_row_kernel<<<dim3(kCluster, p.H, p.B), KC * 2, row_smem(KC), stream>>>(p, KC);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mma
}  // namespace olm

// variant codes: olmoasr_tpu_torch/perf/_probes.py (FWD_VARIANTS, SCORE_VARIANTS, BWD_VARIANTS)
extern "C" int olm_probe_fwd(const void* q, const void* k, const void* v, const float* bias,
                             int bias_bstride, void* out, int B, int H, int Tq, int Tk, int D,
                             int causal, float scale, int variant, void* stream) {
  using namespace olm::mma;
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0) return cudaErrorInvalidValue;
  const FwdParams p{static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
                    bias, out, B, H, Tq, Tk, D, bias_bstride, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int X = kExp2;  // the production forward's exp
  switch (variant) {
    case 0: return launch_fwd<64, 1, 64, kStages, X>(p, s);  // seq64, pipe64
    case 1: return launch_fwd<64, 1, kFwdRows, kStages, X>(p, s);  // seq128, pipe128: production
    case 2: return launch_fwd<128, 1, 64, kStages, X>(p, s);  // pad64
    case 3: return launch_fwd<128, 1, 128, kStages, X>(p, s);  // pad128
    case 4: return launch_fwd<64, 2, 64, kStages, X>(p, s);  // pack64
    case 5: return launch_fwd<64, 2, 128, kStages, X>(p, s);  // pack128
    case 6: return launch_fwd<64, 1, 64, 1, X>(p, s);  // probe_pipe's seq64: load, then compute
    case 7: return launch_fwd<64, 1, 128, 1, X>(p, s);  // probe_pipe's seq128
    case 8: return launch_fwd<64, 1, 128, kStages, X | kDropBias>(p, s);  // ablate
    case 9: return launch_fwd<64, 1, 128, kStages, X | kDropMax>(p, s);
    case 10: return launch_fwd<64, 1, 128, kStages, kDropExp>(p, s);
    case 11: return launch_fwd<64, 1, 128, kStages, X | kDropSum>(p, s);
    case 12: return launch_fwd<64, 1, 128, kStages, X | kDropDiv>(p, s);
    case 13:
      return launch_fwd<64, 1, 128, kStages, kDropBias | kDropMax | kDropExp | kDropSum | kDropDiv>(
          p, s);
    case 14: return launch_fwd<64, 1, 128, kStages, kBf16Exp>(p, s);
    case 15: return launch_fwd<64, 1, 128, kStages, 0>(p, s);  // expf: the accurate exp
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int olm_probe_scores(const void* q, const void* k, void* out, int B, int H, int Tq,
                                int Tk, int D, float scale, int variant, void* stream) {
  using namespace olm::mma;
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0) return cudaErrorInvalidValue;
  const FwdParams p{static_cast<const bf*>(q), static_cast<const bf*>(k), nullptr, nullptr, out,
                    B, H, Tq, Tk, D, 0, 0, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return launch_scores<64, 64, 3>(p, s);  // rawd64x64
    case 1: return launch_scores<64, 128, 3>(p, s);  // rawd64x128
    case 2: return launch_scores<128, 64, 3>(p, s);  // rawd128x64
    case 3: return launch_scores<128, 128, 3>(p, s);  // rawd128x128
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int olm_probe_bwd(const void* q, const void* k, const void* v, const void* dout,
                             const float* bias, int bias_bstride, void* dq, void* dk, void* dv,
                             float* stats, int B, int H, int Tq, int Tk, int D, int causal,
                             float scale, int variant, void* stream) {
  using namespace olm::mma;
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0) return cudaErrorInvalidValue;
  const BwdParams p{static_cast<const bf*>(q), static_cast<const bf*>(k),
                    static_cast<const bf*>(v), static_cast<const bf*>(dout), bias,
                    static_cast<bf*>(dq), static_cast<bf*>(dk), static_cast<bf*>(dv),
                    stats, B, H, Tq, Tk, D, bias_bstride, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return launch_bwd<kBwdRows>(p, s);  // bq64 (the production form)
    case 1: return launch_bwd<128>(p, s);  // bq128
    case 2: return launch_row(p, s);  // row64
    default: return cudaErrorInvalidValue;
  }
}
