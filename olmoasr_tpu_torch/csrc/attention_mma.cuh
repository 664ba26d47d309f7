// Register-resident attention tiles for Hopper's tensor cores, in the
// FlashAttention-2 style: the core of the bf16 training-attention kernels
// (train_attention.cu: the forward, the dq and the dk/dv launches), of their
// timing probes (attention_probes.cu) and, under the flash score policy
// (kFlash below), of the flash route's bf16 kernels (flash_attention.cu).
//
// Every product is mma.sync.m16n8k16 (bf16 operands, fp32 accumulation). A
// warp owns 16 rows of its block's tile. Operands come from XOR-swizzled
// shared tiles through ldmatrix (.trans where the stored tile is [k][n]),
// with no padding: a 16-byte chunk c of row r sits at chunk c ^ (r & 7), so
// the 8 rows an ldmatrix reads land in 8 different bank groups. Tiles are
// filled by a ring of cp.async stages (16 bytes a thread; commit_group /
// wait_group), so the next tile lands while this one is multiplied. Scores
// stay in the accumulator registers: masks and the bias are applied there,
// the row max and sum use the 4-lane quad shuffles, and p (or ds) is packed
// to bf16 straight into the A fragments of the next product, since the
// m16n8k16 accumulator layout is the A layout. Nothing passes through shared
// memory between two products.
//
// Fragment layouts (g = lane / 4, t = lane % 4): an accumulator c[4] of a
// 16 x 8 block holds (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1); an A
// fragment a[4] of a 16 x 16 block holds pairs at (g, 2t), (g+8, 2t),
// (g, 2t+8), (g+8, 2t+8); a B fragment b[2] of a 16 x 8 block holds pairs at
// (k = 2t, n = g) and (k = 2t+8, n = g).
//
// The kernels below live in an anonymous namespace: each .cu that includes
// this header instantiates its own copies.
#pragma once

#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"

namespace olm {
namespace mma {

using bf = __nv_bfloat16;

constexpr int kBK = 64;  // keys per tile
constexpr int kStages = 2;  // the production rings' depth (probe_pipe times depth 1 beside it)
constexpr int kFwdRows = 128;  // the production forward's query tile
constexpr int kBwdRows = 64;  // the production dq launch's query tile
constexpr float kMaskNeg = -1e9f;  // the causal mask's score (the TPU kernel's)

// ---------------------------------------------------------------------------
// primitives
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a . b for one 16 x 8 x 16 block
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to bf16 (nearest even) in one register, lo first
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFullMask, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFullMask, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFullMask, x, 1);
  return x + __shfl_xor_sync(kFullMask, x, 2);
}

// ---------------------------------------------------------------------------
// swizzled tiles of bf16 rows, W wide (a multiple of 64)
// ---------------------------------------------------------------------------

template <int W>
__device__ __forceinline__ int swz(int row, int chunk) {
  static_assert(W % 64 == 0, "a row holds a multiple of 8 chunks");
  return (row * (W / 8) + (chunk ^ (row & 7))) * 8;  // in elements
}

// rows r0.. of a (rows, ld) tensor (src already at the tile's first column),
// W columns, into an R-row tile; rows at or past n are zeros
template <int W, int R, int NT>
__device__ __forceinline__ void load_tile(bf* dst, const bf* src, int r0, int n, int ld) {
  constexpr int CH = W / 8;
  for (int c = threadIdx.x; c < R * CH; c += NT) {
    const int r = c / CH, ch = c % CH;
    const bool ok = r0 + r < n;
    cp_async16(dst + swz<W>(r, ch), src + static_cast<size_t>(ok ? r0 + r : 0) * ld + ch * 8, ok);
  }
}

// q's pre-scale in q's type, applied in shared memory to the chunks this
// thread loaded with load_tile<W, R, NT> (its own copies are complete after
// its cp_wait, and the next barrier shows the result to the block)
template <int W, int R, int NT>
__device__ __forceinline__ void scale_tile(bf* t, float s) {
  constexpr int CH = W / 8;
  for (int c = threadIdx.x; c < R * CH; c += NT) {
    uint4* p = reinterpret_cast<uint4*>(t + swz<W>(c / CH, c % CH));
    uint4 v = *p;
    bf* e = reinterpret_cast<bf*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * s);
    *p = v;
  }
}

// A fragment of rows row0..row0+15, columns k0..k0+15 of a tile stored [m][k]
template <int W>
__device__ __forceinline__ void ld_a(uint32_t (&a)[4], const bf* t, int row0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, smem_u32(t + swz<W>(row0 + (lane & 15), (k0 >> 3) + (lane >> 4))));
}

// B fragments of the n-blocks n0 and n0+8 at the k-step k0, from a tile
// stored [n][k] (K for q.K^T): b[0], b[1] for n0; b[2], b[3] for n0+8
template <int W>
__device__ __forceinline__ void ld_b_nk(uint32_t (&b)[4], const bf* t, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(b, smem_u32(t + swz<W>(n0 + (lane & 7) + ((lane >> 4) << 3),
                                 (k0 >> 3) + ((lane >> 3) & 1))));
}

// the same from a tile stored [k][n] (V for P.V), through ldmatrix.trans
template <int W>
__device__ __forceinline__ void ld_b_kn(uint32_t (&b)[4], const bf* t, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(b, smem_u32(t + swz<W>(k0 + (lane & 15), (n0 >> 3) + (lane >> 4))));
}

// acc (16 x 8*NB) += A (16 x DH) . B^T, B a tile stored [n][k]: rows nrow0..
// of it are the n-blocks, columns kcol0.. the DH deep contraction; the A
// fragments are read from a tile stored [m][k] at (arow0, acol0)
template <int W, int DH, int NB>
__device__ __forceinline__ void product_nt(float (&acc)[NB][4], const bf* A, int arow0, int acol0,
                                           const bf* B, int nrow0, int kcol0) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t a[4];
    ld_a<W>(a, A, arow0, acol0 + kk * 16);
#pragma unroll
    for (int nb = 0; nb < NB / 2; ++nb) {
      uint32_t b[4];
      ld_b_nk<W>(b, B, nrow0 + nb * 16, kcol0 + kk * 16);
      mma16816(acc[2 * nb], a, b[0], b[1]);
      mma16816(acc[2 * nb + 1], a, b[2], b[3]);
    }
  }
}

// the A fragment of k-step kk (16 columns) from an accumulator of 8-wide
// n-blocks, each pair rounded to bf16
template <int NB>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c)[NB][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// acc (16 x 8*NB) += P (16 x 64, the accumulator p of one key tile, rounded
// to bf16) . V, V a tile stored [k][n] with the key tile's rows k0.. and the
// NB*8 columns from ncol0
template <int W, int NB>
__device__ __forceinline__ void product_pv(float (&acc)[NB][4], const float (&p)[kBK / 8][4],
                                           const bf* V, int k0, int ncol0) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    uint32_t a[4];
    acc_to_a(a, p, kk);
#pragma unroll
    for (int nb = 0; nb < NB / 2; ++nb) {
      uint32_t b[4];
      ld_b_kn<W>(b, V, k0 + kk * 16, ncol0 + nb * 16);
      mma16816(acc[2 * nb], a, b[0], b[1]);
      mma16816(acc[2 * nb + 1], a, b[2], b[3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

// a warp's 16 x 8*NB accumulator, converted by f(value, row), into its rows
// row0.. and columns col0.. of a swizzled tile (bf16 pairs)
template <int W, int NB, class F>
__device__ __forceinline__ void stage_acc(bf* t, const float (&c)[NB][4], int row0, int col0, F f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + g + 8 * h;
      *reinterpret_cast<uint32_t*>(t + swz<W>(r, (col0 >> 3) + j) + 2 * tq) =
          pack_bf16(f(c[j][2 * h], h), f(c[j][2 * h + 1], h));
    }
  }
}

// rows row0..row0+15, columns col0..col0+DH-1 of a swizzled tile to rows
// r0 + row0.. of a (rows, ld) tensor (dst at the tile's first column), 16
// bytes a lane, rows at or past n skipped (one warp)
template <int W, int DH>
__device__ __forceinline__ void store_rows16(bf* dst, const bf* t, int row0, int col0, int r0, int n,
                                             int ld) {
  constexpr int CH = DH / 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = row0 + c / CH, ch = (col0 >> 3) + c % CH;
    if (r0 + r < n)
      *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r0 + r) * ld + ch * 8) =
          *reinterpret_cast<const uint4*>(t + swz<W>(r, ch));
  }
}

// ---------------------------------------------------------------------------
// the softmax's exp, and the stages the forward probes may drop
// ---------------------------------------------------------------------------

enum : int {
  kDropBias = 1,  // no key bias
  kDropMax = 2,  // no max pass: p = exp(s)
  kDropExp = 4,  // p = s - m
  kDropSum = 8,  // l = 1
  kDropDiv = 16,  // o = P.V, not divided by l
  kBf16Exp = 32,  // exp in bf16
  kExp2 = 64,  // exp as ex2.approx(x log2 e): the production forward's
  kFlash = 128,  // the flash score policy (row 10; see "the flash policy" below)
};

constexpr float kLog2e = 1.4426950408889634f;
// the stock Pallas flash kernel's DEFAULT_MASK_VALUE, -0.7 * FLT_MAX in fp32
constexpr float kFlashMask = static_cast<float>(-0.7 * 3.4028234663852886e38);
// |row max| up to which the forward folds it into the exp's fma: the fold
// moves the exponent by at most |m| log2(e) 2^-24, here 5.5e-6, so p by 4e-6
// of itself at most (ex2.approx adds 2^-22)
constexpr float kFoldMax = 64.f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int FLAGS>
__device__ __forceinline__ float softmax_exp(float x) {
  if constexpr ((FLAGS & kDropExp) != 0) {
    return x;
  } else if constexpr ((FLAGS & kBf16Exp) != 0) {
    return __bfloat162float(hexp(__float2bfloat16(x)));
  } else if constexpr ((FLAGS & kExp2) != 0) {
    return ex2(x * kLog2e);
  } else {
    return expf(x);  // the accurate exp (the backward's)
  }
}

// ---------------------------------------------------------------------------
// kernel arguments
// ---------------------------------------------------------------------------

struct FwdParams {
  const bf* q;  // (B, Tq, D), head h at columns h*dh..
  const bf* k;  // (B, Tk, D)
  const bf* v;  // (B, Tk, D)
  const float* bias;  // (Bb, Tk) additive key bias, or null
  void* out;  // (B, Tq, D) bf16; the score probe: (B, Tq, H*64) fp32
  int B, H, Tq, Tk, D;  // H counts the heads of width DH in a row of D
  int bias_bstride;  // Tk when the bias has a row per batch, 0 when shared
  int causal;
  float scale;  // dh^-0.5 as a bf16 value
  // the flash policy's (null otherwise): segment ids, both or neither, and
  // the residuals the forward writes
  const int* q_ids;  // (B, Tq)
  const int* kv_ids;  // (B, Tk)
  float* m;  // (B, H, Tq) row max
  float* l;  // (B, H, Tq) row sum of the unrounded p
};

struct BwdParams {
  const bf* q;
  const bf* k;
  const bf* v;
  const bf* dout;  // (B, Tq, D)
  const float* bias;
  bf* dq;
  bf* dk;
  bf* dv;
  float* stats;  // (3, B, H, Tq): row max, 1 / row sum, delta
  int B, H, Tq, Tk, D;
  int bias_bstride;
  int causal;
  float scale;
};

// the flash policy's backward (stats unused): segment ids, both or neither,
// and the forward's residuals with the caller's di = sum(o * do) in place of
// the workspace. A struct of its own, so that row 9's launches take the
// arguments they took before (with these fields in BwdParams, ptxas spilled
// more in row 9's dk/dv launch).
struct FlashBwdParams : BwdParams {
  const int* q_ids;  // (B, Tq)
  const int* kv_ids;  // (B, Tk)
  const float* m;  // (B, H, Tq)
  const float* l;
  const float* di;
};

template <bool FLASH>
using BwdArgs = std::conditional_t<FLASH, FlashBwdParams, BwdParams>;

// the key tiles a query tile [q0, q0 + rows) needs: with the causal mask,
// keys past its last row are masked in every row and give p = 0
__device__ __forceinline__ int key_tile_count(int Tk, int causal, int q0, int rows) {
  int n = (Tk + kBK - 1) / kBK;
  if (causal) n = min(n, (q0 + rows + kBK - 1) / kBK);
  return n;
}

// s of a score at (row qi, key) after the bias and the masks: -inf for keys
// past the end (not keys at all: p = 0), the bias added, -1e9 where causal
// and key > qi
__device__ __forceinline__ float mask_score(float s, int qi, int key, int Tk, const float* bias_s,
                                            int kcol, int causal) {
  if (key >= Tk) return -INFINITY;
  if (bias_s) s += bias_s[kcol];
  if (causal && key > qi) s = kMaskNeg;
  return s;
}

// the bias and the masks on a warp's 16 x 8*NB block of scores (rows qrow
// and qrow + 8 of this thread, keys key0..; bias_s at key0's bias); a block
// with neither the sequence's end nor a causal diagonal in it only takes the
// bias, a pair of keys at a time
template <int NB>
__device__ __forceinline__ void mask_tile(float (&s)[NB][4], int qrow, int key0, int Tk,
                                          const float* bias_s, bool diag, int causal) {
  const int tq = threadIdx.x & 3;
  if (diag || key0 + NB * 8 > Tk) {
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = 8 * j + 2 * tq + (e & 1);
        s[j][e] = mask_score(s[j][e], qrow + 8 * (e >> 1), key0 + kc, Tk, bias_s, kc, causal);
      }
  } else if (bias_s) {
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float2 bv = *reinterpret_cast<const float2*>(bias_s + 8 * j + 2 * tq);
      s[j][0] += bv.x;
      s[j][1] += bv.y;
      s[j][2] += bv.x;
      s[j][3] += bv.y;
    }
  }
}

// ---------------------------------------------------------------------------
// the flash policy (row 10, the stock Pallas TPU flash attention): the fp32
// score times the scale after the product (q is not pre-scaled); segment ids
// on both sides, where a query's id differs from the key's, or causal and
// key > query, -0.7 FLT_MAX is ADDED to the score (a row whose keys so far
// are all masked then has p = 1 on them, as the stock kernel does, until a
// real key wipes them out); keys past the end are -inf. The forward is one
// pass with the running max (p rounded to bf16 against it) and writes the
// residuals m and l; the backward takes them and the caller's di.
// ---------------------------------------------------------------------------

// the flash score of a warp's 16 x 8*NB block (rows qrow and qrow + 8 of
// this thread with segment ids qid; keys key0.., their ids kid_s, or null
// without ids)
template <int NB>
__device__ __forceinline__ void flash_mask_tile(float (&s)[NB][4], int qrow, const int (&qid)[2],
                                                int key0, int Tk, const int* kid_s, bool diag,
                                                int causal, float scale) {
  const int tq = threadIdx.x & 3;
  if (kid_s || diag || key0 + NB * 8 > Tk) {
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = 8 * j + 2 * tq + (e & 1), key = key0 + kc, r = e >> 1;
        float x = s[j][e] * scale;
        if (key >= Tk)
          x = -INFINITY;
        else if ((kid_s && kid_s[kc] != qid[r]) || (causal && key > qrow + 8 * r))
          x += kFlashMask;
        s[j][e] = x;
      }
  } else {
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale;
  }
}

namespace {

// ---------------------------------------------------------------------------
// forward (row 3): p = exp(s - m) with m the row's final max, rounded to
// bf16 before P.V, o = P.V / l
// ---------------------------------------------------------------------------

// shared bytes of the forward: the Q tile, STAGES x (K, V, bias slice)
template <int DH, int HEADS, int BQ, int STAGES>
constexpr size_t fwd_smem() {
  return (BQ * HEADS * DH + STAGES * 2 * kBK * HEADS * DH) * sizeof(bf) +
         STAGES * kBK * sizeof(float);
}

// blocks an SM should hold: two or more 8-warp blocks (at most 128
// registers a thread), one where a thread needs more (width 128, 16 warps)
template <int DH, int NT>
constexpr int fwd_min_blocks() {
  return DH > 64 || NT >= 512 ? 1 : 512 / NT;
}

// One block owns BQ query rows of HEADS neighbouring heads of one batch row
// (HEADS * BQ / 16 warps, 16 rows of one head each). Pass 1 computes S only,
// for the row max; pass 2 computes S, p, l and P.V with O in registers.
// Both passes stream the key tiles through one cp.async ring of STAGES
// stages (K alone in pass 1). Causal rows stop at the diagonal tile and only
// tiles that cross a warp's diagonal are masked. Under kFlash (row 10) there
// is one pass: the kv ids ride in the bias slice's place, and each tile
// raises the running max m, rescales l and O by exp(m_old - m) and adds its
// p (rounded against the new m) and P.V; a warp skips the key tiles wholly
// above its diagonal (there p = 0 exactly); m and l go out beside O.
template <int DH, int HEADS, int BQ, int STAGES, int FLAGS>
__global__ void __launch_bounds__(HEADS * BQ * 2, (fwd_min_blocks<DH, HEADS * BQ * 2>()))
    attn_fwd_mma_kernel(FwdParams p) {
  constexpr int W = HEADS * DH, NT = HEADS * BQ * 2, NO = DH / 8;
  constexpr bool kOnline = (FLAGS & kFlash) != 0;
  constexpr bool kMaxPass = (FLAGS & kDropMax) == 0 && !kOnline;
  static_assert(!kOnline || HEADS == 1, "the flash policy takes one head a block");
  extern __shared__ __align__(128) unsigned char smem[];
  bf* Qs = reinterpret_cast<bf*>(smem);
  bf* ring = Qs + BQ * W;
  float* bias_ring = reinterpret_cast<float*>(ring + STAGES * 2 * kBK * W);
  int* id_ring = reinterpret_cast<int*>(bias_ring);  // the flash policy's kv ids

  const int q0 = blockIdx.x * BQ, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
  const int hw = warp / (BQ / 16), row0 = (warp % (BQ / 16)) * 16, col0 = hw * DH;
  const size_t hoff = static_cast<size_t>(blockIdx.y) * W;
  const bf* Q = p.q + static_cast<size_t>(b) * p.Tq * p.D + hoff;
  const bf* K = p.k + static_cast<size_t>(b) * p.Tk * p.D + hoff;
  const bf* V = p.v + static_cast<size_t>(b) * p.Tk * p.D + hoff;
  const float* bias_row = ((FLAGS & kDropBias) == 0 && p.bias && !kOnline)
                              ? p.bias + static_cast<size_t>(b) * p.bias_bstride : nullptr;
  const int* kid_row = kOnline && p.kv_ids ? p.kv_ids + static_cast<size_t>(b) * p.Tk : nullptr;

  const int nkt = key_tile_count(p.Tk, p.causal, q0, BQ);
  const int pass1 = kMaxPass ? nkt : 0, total = pass1 + nkt;
  auto fetch = [&](int i) {
    if (i < total) {
      const bool second = i >= pass1;
      const int k0 = (second ? i - pass1 : i) * kBK, st = i % STAGES;
      bf* Ks = ring + st * 2 * kBK * W;
      load_tile<W, kBK, NT>(Ks, K, k0, p.Tk, p.D);
      if (second) load_tile<W, kBK, NT>(Ks + kBK * W, V, k0, p.Tk, p.D);
      if (bias_row && threadIdx.x < kBK) {
        const int key = k0 + threadIdx.x;
        cp_async4(bias_ring + st * kBK + threadIdx.x, bias_row + (key < p.Tk ? key : 0),
                  key < p.Tk);
      }
      if (kid_row && threadIdx.x < kBK) {
        const int key = k0 + threadIdx.x;
        cp_async4(id_ring + st * kBK + threadIdx.x, kid_row + (key < p.Tk ? key : 0), key < p.Tk);
      }
    }
    cp_commit();
  };

  load_tile<W, BQ, NT>(Qs, Q, q0, p.Tq, p.D);
  if constexpr (STAGES == 1) {
    cp_commit();
    cp_wait<0>();
  } else {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) fetch(s);
    cp_wait<STAGES - 2>();
  }
  if constexpr (!kOnline) scale_tile<W, BQ, NT>(Qs, p.scale);
  __syncthreads();
  uint32_t qf[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) ld_a<W>(qf[kk], Qs, row0, col0 + kk * 16);

  constexpr bool kRunMax = kMaxPass || kOnline;
  float m[2] = {kRunMax ? -INFINITY : 0.f, kRunMax ? -INFINITY : 0.f};
  float l[2] = {0.f, 0.f};
  // exp as ex2 with the max folded into one fma (the production form)
  constexpr bool kFold = (FLAGS & (kExp2 | kDropExp | kBf16Exp)) == kExp2;
  float ml[2] = {0.f, 0.f};
  bool folded = kFold && !kMaxPass;
  float o[NO][4];
  zero(o);
  const int qrow = q0 + row0 + g;  // this thread's rows: qrow, qrow + 8
  int qid[2] = {0, 0};  // the flash policy's query ids
  if (kOnline && p.q_ids) {
    const int* ids = p.q_ids + static_cast<size_t>(b) * p.Tq;
    qid[0] = qrow < p.Tq ? ids[qrow] : 0;
    qid[1] = qrow + 8 < p.Tq ? ids[qrow + 8] : 0;
  }

  for (int i = 0; i < total; ++i) {
    if constexpr (STAGES == 1) {  // load, then compute
      __syncthreads();  // every warp is done with the last tile
      fetch(i);
      cp_wait<0>();
      __syncthreads();
    } else {
      cp_wait<STAGES - 2>();
      __syncthreads();
      fetch(i + STAGES - 1);
    }
    const int st = i % STAGES;
    const bool second = i >= pass1;
    const int k0 = (second ? i - pass1 : i) * kBK;
    const bf* Ks = ring + st * 2 * kBK * W;
    const float* bias_s = bias_row ? bias_ring + st * kBK : nullptr;
    // the flash policy: a tile wholly above this warp's diagonal adds p = 0
    if (kOnline && p.causal && k0 > q0 + row0 + 15) continue;

    float s[kBK / 8][4];
    zero(s);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
#pragma unroll
      for (int nb = 0; nb < kBK / 16; ++nb) {
        uint32_t bfr[4];
        ld_b_nk<W>(bfr, Ks, nb * 16, col0 + kk * 16);
        mma16816(s[2 * nb], qf[kk], bfr[0], bfr[1]);
        mma16816(s[2 * nb + 1], qf[kk], bfr[2], bfr[3]);
      }
    }
    if constexpr (kOnline) {
      flash_mask_tile(s, qrow, qid, k0, p.Tk, kid_row ? id_ring + st * kBK : nullptr,
                      p.causal && k0 + kBK - 1 > q0 + row0, p.causal, p.scale);
      // the running max; the tile holds key k0 < Tk, whose score is finite
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float tmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) tmax = fmaxf(tmax, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        const float nm = fmaxf(m[r], quad_max(tmax));
        const float c = expf(m[r] - nm);  // 0 on the first tile (m = -inf)
        l[r] *= c;
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          o[j][2 * r] *= c;
          o[j][2 * r + 1] *= c;
        }
        m[r] = nm;
        ml[r] = nm * kLog2e;
      }
      // a row whose max is large (all its keys so far masked: m * log2 e
      // overflows) takes the unfolded form
      folded = kFold && !__any_sync(kFullMask, fmaxf(fabsf(m[0]), fabsf(m[1])) > kFoldMax);
    } else {
      mask_tile(s, qrow, k0, p.Tk, bias_s, p.causal && k0 + kBK - 1 > q0 + row0, p.causal);
    }
    if (!second) {  // pass 1: the row max
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        m[0] = fmaxf(m[0], fmaxf(s[j][0], s[j][1]));
        m[1] = fmaxf(m[1], fmaxf(s[j][2], s[j][3]));
      }
      if (i == pass1 - 1) {
        m[0] = quad_max(m[0]);
        m[1] = quad_max(m[1]);
        ml[0] = m[0] * kLog2e;
        ml[1] = m[1] * kLog2e;
        // where a row's max is large (every key masked, or scores past
        // kFoldMax) the warp takes the unfolded form
        folded = kFold && !__any_sync(kFullMask, fmaxf(fabsf(m[0]), fabsf(m[1])) > kFoldMax);
      }
      continue;
    }
    if (folded) {  // exp(s - m) = ex2(s log2 e - m log2 e), one fma a score
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = ex2(fmaf(s[j][e], kLog2e, -ml[e >> 1]));
          if constexpr ((FLAGS & kDropSum) == 0) l[e >> 1] += x;
          s[j][e] = x;
        }
    } else {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = softmax_exp<FLAGS>(s[j][e] - m[e >> 1]);
          if constexpr ((FLAGS & kDropSum) == 0) l[e >> 1] += x;
          s[j][e] = x;
        }
    }
    product_pv<W, NO>(o, s, Ks + kBK * W, 0, col0);
  }

  if constexpr ((FLAGS & (kDropSum | kDropDiv)) == 0) {
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
  }
  if constexpr (kOnline) {  // the residuals: the row max and the row sum
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = qrow + 8 * r;
      if ((lane & 3) == 0 && qi < p.Tq) {
        const size_t row = (static_cast<size_t>(b) * p.H + blockIdx.y) * p.Tq + qi;
        p.m[row] = m[r];
        p.l[row] = l[r];
      }
    }
  }
  // the warp's own rows of the Q tile take its output (no other warp reads them)
  __syncwarp();
  stage_acc<W, NO>(Qs, o, row0, col0, [&](float x, int h) {
    if constexpr ((FLAGS & (kDropSum | kDropDiv)) == 0) return x / l[h];
    return x;
  });
  __syncwarp();
  store_rows16<W, DH>(static_cast<bf*>(p.out) + static_cast<size_t>(b) * p.Tq * p.D + hoff, Qs,
                      row0, col0, q0, p.Tq, p.D);
}


template <int DH, int HEADS, int BQ, int STAGES, int FLAGS>
int launch_fwd(const FwdParams& p, cudaStream_t stream) {
  constexpr size_t kSmem = fwd_smem<DH, HEADS, BQ, STAGES>();
  auto kernel = attn_fwd_mma_kernel<DH, HEADS, BQ, STAGES, FLAGS>;
  // raised once per process (not a stream operation: a graph capture of a
  // later call never sees it)
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (configured != cudaSuccess) return static_cast<int>(configured);
  if (p.H % HEADS != 0 || p.D != p.H * DH) return cudaErrorInvalidValue;
  kernel<<<dim3((p.Tq + BQ - 1) / BQ, p.H / HEADS, p.B), HEADS * BQ * 2, kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// backward (row 9), launch (a): per query tile the row statistics and dq
// ---------------------------------------------------------------------------

template <int BQ>
constexpr size_t dq_smem() {
  return (2 * BQ * 64 + kStages * 2 * kBK * 64) * sizeof(bf) + kStages * kBK * sizeof(float);
}

// One block owns BQ query rows of one (b, h), a warp 16 of them; Q and dO
// stay in shared memory, K and V tiles (and the bias slice) stream through
// the ring twice. Pass 1 computes S and dP in registers with an online row
// max, sum of p and sum of p dp (rescaled as the max grows; nothing is
// rounded there), then delta = sum(p dp) / l, and writes (max, 1 / l,
// delta) to the workspace. Pass 2 computes S and dP again, forms
// ds = bf16(pn (dp - delta)) in registers and accumulates dq = ds . K.
// Under the flash policy (FLASH) the statistics are the forward's m, 1 / l
// and the caller's di, read per row, so only pass 2 runs: the kv ids ride in
// the bias slice's place, ds = bf16((dp - di) p scale) with
// p = exp(s - m) / l, and a warp skips the key tiles wholly above its
// diagonal (there ds = 0 exactly).
template <int BQ, bool FLASH>
__global__ void __launch_bounds__(BQ * 2) attn_bwd_dq_mma_kernel(BwdArgs<FLASH> p) {
  constexpr int W = 64, NT = BQ * 2, STAGES = kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  bf* Qs = reinterpret_cast<bf*>(smem);
  bf* dOs = Qs + BQ * W;
  bf* ring = dOs + BQ * W;
  float* bias_ring = reinterpret_cast<float*>(ring + STAGES * 2 * kBK * W);
  int* id_ring = reinterpret_cast<int*>(bias_ring);  // the flash policy's kv ids

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
  const int row0 = warp * 16, qrow = q0 + row0 + g;
  const size_t hoff = static_cast<size_t>(h) * W;
  const bf* Q = p.q + static_cast<size_t>(b) * p.Tq * p.D + hoff;
  const bf* dO = p.dout + static_cast<size_t>(b) * p.Tq * p.D + hoff;
  const bf* K = p.k + static_cast<size_t>(b) * p.Tk * p.D + hoff;
  const bf* V = p.v + static_cast<size_t>(b) * p.Tk * p.D + hoff;
  const float* bias_row =
      p.bias && !FLASH ? p.bias + static_cast<size_t>(b) * p.bias_bstride : nullptr;
  const int* kid_row = nullptr;
  if constexpr (FLASH) kid_row = p.kv_ids ? p.kv_ids + static_cast<size_t>(b) * p.Tk : nullptr;

  // the flash policy has its statistics: pass 2 alone
  const int nkt = key_tile_count(p.Tk, p.causal, q0, BQ), total = FLASH ? nkt : 2 * nkt;
  auto fetch = [&](int i) {
    if (i < total) {
      const int k0 = (FLASH || i < nkt ? i : i - nkt) * kBK, st = i % STAGES;
      bf* Ks = ring + st * 2 * kBK * W;
      load_tile<W, kBK, NT>(Ks, K, k0, p.Tk, p.D);
      load_tile<W, kBK, NT>(Ks + kBK * W, V, k0, p.Tk, p.D);
      if (bias_row && threadIdx.x < kBK) {
        const int key = k0 + threadIdx.x;
        cp_async4(bias_ring + st * kBK + threadIdx.x, bias_row + (key < p.Tk ? key : 0),
                  key < p.Tk);
      }
      if (kid_row && threadIdx.x < kBK) {
        const int key = k0 + threadIdx.x;
        cp_async4(id_ring + st * kBK + threadIdx.x, kid_row + (key < p.Tk ? key : 0), key < p.Tk);
      }
    }
    cp_commit();
  };
  load_tile<W, BQ, NT>(Qs, Q, q0, p.Tq, p.D);
  load_tile<W, BQ, NT>(dOs, dO, q0, p.Tq, p.D);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) fetch(s);
  cp_wait<STAGES - 2>();
  if constexpr (!FLASH) scale_tile<W, BQ, NT>(Qs, p.scale);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, pd[2] = {0.f, 0.f};
  int qid[2] = {0, 0};
  if constexpr (FLASH) {  // m, 1 / l and di of this thread's rows (0 past the end)
    const size_t srow = (static_cast<size_t>(b) * p.H + h) * p.Tq;
    const int* ids = p.q_ids ? p.q_ids + static_cast<size_t>(b) * p.Tq : nullptr;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = qrow + 8 * r;
      const bool in = qi < p.Tq;
      m[r] = in ? p.m[srow + qi] : 0.f;
      l[r] = in ? 1.f / p.l[srow + qi] : 0.f;
      pd[r] = in ? p.di[srow + qi] : 0.f;
      qid[r] = ids && in ? ids[qi] : 0;
    }
  }
  float dq[8][4];
  zero(dq);
  for (int i = 0; i < total; ++i) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    fetch(i + STAGES - 1);
    const int st = i % STAGES;
    const bool second = FLASH || i >= nkt;
    const int k0 = (FLASH || !second ? i : i - nkt) * kBK;
    const bf* Ks = ring + st * 2 * kBK * W;
    const float* bias_s = bias_row ? bias_ring + st * kBK : nullptr;
    if (FLASH && p.causal && k0 > q0 + row0 + 15) continue;

    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    product_nt<W, 64, 8>(s, Qs, row0, 0, Ks, 0, 0);
    product_nt<W, 64, 8>(dp, dOs, row0, 0, Ks + kBK * W, 0, 0);
    if constexpr (FLASH) {
      flash_mask_tile(s, qrow, qid, k0, p.Tk, kid_row ? id_ring + st * kBK : nullptr,
                      p.causal && k0 + kBK - 1 > q0 + row0, p.causal, p.scale);
    } else {
      mask_tile(s, qrow, k0, p.Tk, bias_s, p.causal && k0 + kBK - 1 > q0 + row0, p.causal);
    }
    if (!second) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float tmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) tmax = fmaxf(tmax, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        const float nm = fmaxf(m[r], tmax);
        if (nm == -INFINITY) continue;  // no key of this share exists yet
        const float c = expf(m[r] - nm);
        float lr = l[r] * c, pr = pd[r] * c;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            const float x = expf(s[j][e] - nm);
            lr += x;
            pr += x * dp[j][e];
          }
        m[r] = nm;
        l[r] = lr;
        pd[r] = pr;
      }
      if (i == nkt - 1) {
        // the row's four shares combined (key 0 is always a key, so the
        // row's max is finite; a share that saw no key has m = -inf and
        // weighs 0), then the statistics the dk/dv launch reads
        const size_t plane = static_cast<size_t>(p.B) * p.H * p.Tq;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int o = 1; o < 4; o <<= 1) {
            const float om = __shfl_xor_sync(kFullMask, m[r], o);
            const float ol = __shfl_xor_sync(kFullMask, l[r], o);
            const float opd = __shfl_xor_sync(kFullMask, pd[r], o);
            const float nm = fmaxf(m[r], om);
            const float a = m[r] == -INFINITY ? 0.f : expf(m[r] - nm);
            const float c = om == -INFINITY ? 0.f : expf(om - nm);
            l[r] = l[r] * a + ol * c;
            pd[r] = pd[r] * a + opd * c;
            m[r] = nm;
          }
          pd[r] = pd[r] / l[r];  // delta
          l[r] = 1.f / l[r];
          const int qi = qrow + 8 * r;
          if ((lane & 3) == 0 && qi < p.Tq) {
            const size_t row = (static_cast<size_t>(b) * p.H + h) * p.Tq + qi;
            p.stats[row] = m[r];
            p.stats[plane + row] = l[r];
            p.stats[2 * plane + row] = pd[r];
          }
        }
      }
      continue;
    }
    // pass 2: ds = bf16(pn (dp - delta)) into the A fragments, dq += ds . K
    // (flash: ds = bf16((dp - di) p scale), p = exp(s - m) (1 / l))
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        if constexpr (FLASH)
          s[j][e] = (dp[j][e] - pd[r]) * (expf(s[j][e] - m[r]) * l[r]) * p.scale;
        else
          s[j][e] = expf(s[j][e] - m[r]) * l[r] * (dp[j][e] - pd[r]);
      }
    product_pv<W, 8>(dq, s, Ks, 0, 0);
  }
  // dq rounded to q's type, then times the scale in q's type (flash: the
  // scale is in ds); staged in the warp's own rows of the Q tile
  __syncwarp();
  const float scale = FLASH ? 1.f : p.scale;
  stage_acc<W, 8>(Qs, dq, row0, 0,
                  [scale](float x, int) { return __bfloat162float(__float2bfloat16(x)) * scale; });
  __syncwarp();
  store_rows16<W, 64>(p.dq + static_cast<size_t>(b) * p.Tq * p.D + hoff, Qs, row0, 0, q0, p.Tq,
                      p.D);
}

// ---------------------------------------------------------------------------
// backward (row 9), launch (b): per 64-key tile dK and dV
// ---------------------------------------------------------------------------

// the resident K and V, STAGES x (Q, dO) and STAGES x the statistics (the
// flash policy's q ids a fourth vector)
template <bool FLASH>
constexpr size_t dkv_smem() {
  return (2 * kBK * 64 + kStages * 2 * 64 * 64) * sizeof(bf) +
         kStages * (FLASH ? 4 : 3) * 64 * sizeof(float);
}

// One block owns 64 keys of one (b, h), a warp 16 of them; K and V stay
// resident, the query tiles of Q, dO and their statistics stream through the
// ring (with the causal mask only those on or below the diagonal). S^T and
// dP^T are computed in registers, pn = exp(s - max) / l and ds = pn (dp -
// delta) formed there and rounded to bf16 into the A fragments of
// dV += pn^T . dO and dK += ds^T . q, whose accumulators stay in registers.
// Query rows past the end read zeros (their 1 / l is 0, so pn = ds = 0);
// key rows past the end are computed and never stored. Under the flash
// policy (FLASH) the statistics are the forward's m and l (each thread turns
// the l it loaded into 1 / l) and the caller's di, beside the q ids; the kv
// ids of this thread's two keys stay in registers, q is not pre-scaled, and
// ds = (dp - di) pn scale.
// three blocks an SM (at most 170 registers a thread)
template <bool FLASH>
__global__ void __launch_bounds__(128, 3) attn_bwd_dkv_mma_kernel(BwdArgs<FLASH> p) {
  constexpr int W = 64, NT = 128, BQ = 64, STAGES = kStages, NS = FLASH ? 4 : 3;
  extern __shared__ __align__(128) unsigned char smem[];
  bf* Ks = reinterpret_cast<bf*>(smem);
  bf* Vs = Ks + kBK * W;
  bf* ring = Vs + kBK * W;  // STAGES x (Q, dO)
  float* stat_ring = reinterpret_cast<float*>(ring + STAGES * 2 * BQ * W);  // STAGES x NS x 64

  const int k0 = blockIdx.x * kBK, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int row0 = warp * 16, key = k0 + row0 + g;  // this thread's keys: key, key + 8
  const size_t hoff = static_cast<size_t>(h) * W;
  const bf* Q = p.q + static_cast<size_t>(b) * p.Tq * p.D + hoff;
  const bf* dO = p.dout + static_cast<size_t>(b) * p.Tq * p.D + hoff;
  const bf* K = p.k + static_cast<size_t>(b) * p.Tk * p.D + hoff;
  const bf* V = p.v + static_cast<size_t>(b) * p.Tk * p.D + hoff;
  const float* bias_row =
      p.bias && !FLASH ? p.bias + static_cast<size_t>(b) * p.bias_bstride : nullptr;
  float kb[2] = {0.f, 0.f};
  if (bias_row) {
    kb[0] = key < p.Tk ? bias_row[key] : 0.f;
    kb[1] = key + 8 < p.Tk ? bias_row[key + 8] : 0.f;
  }
  bool ids = false;
  int kid[2] = {0, 0};  // the flash policy's kv ids of this thread's keys
  if constexpr (FLASH) {
    ids = p.kv_ids != nullptr;
    if (ids) {
      const int* row = p.kv_ids + static_cast<size_t>(b) * p.Tk;
      kid[0] = key < p.Tk ? row[key] : 0;
      kid[1] = key + 8 < p.Tk ? row[key + 8] : 0;
    }
  }
  const size_t srow = (static_cast<size_t>(b) * p.H + h) * p.Tq;
  const size_t plane = static_cast<size_t>(p.B) * p.H * p.Tq;

  const int qt0 = p.causal ? k0 / BQ : 0;
  const int total = (p.Tq + BQ - 1) / BQ - qt0;
  auto fetch = [&](int i) {
    if (i < total) {
      const int q0 = (qt0 + i) * BQ, st = i % STAGES;
      bf* Qs = ring + st * 2 * BQ * W;
      load_tile<W, BQ, NT>(Qs, Q, q0, p.Tq, p.D);
      load_tile<W, BQ, NT>(Qs + BQ * W, dO, q0, p.Tq, p.D);
      if constexpr (FLASH) {  // m, l, di, then the q ids
        for (int c = threadIdx.x; c < (ids ? 4 : 3) * BQ; c += NT) {
          const int e = q0 + c % BQ, pl = c / BQ, row = e < p.Tq ? e : 0;
          const void* src =
              pl == 3 ? static_cast<const void*>(p.q_ids + static_cast<size_t>(b) * p.Tq + row)
                      : (pl == 0 ? p.m : pl == 1 ? p.l : p.di) + srow + row;
          cp_async4(stat_ring + st * NS * BQ + c, src, e < p.Tq);
        }
      } else {
        for (int c = threadIdx.x; c < 3 * BQ; c += NT) {
          const int e = q0 + c % BQ;
          cp_async4(stat_ring + st * 3 * BQ + c,
                    p.stats + (c / BQ) * plane + srow + (e < p.Tq ? e : 0), e < p.Tq);
        }
      }
    }
    cp_commit();
  };
  load_tile<W, kBK, NT>(Ks, K, k0, p.Tk, p.D);
  load_tile<W, kBK, NT>(Vs, V, k0, p.Tk, p.D);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) fetch(s);

  float dk[8][4], dv[8][4];
  zero(dk);
  zero(dv);
  for (int i = 0; i < total; ++i) {
    cp_wait<STAGES - 2>();
    const int st = i % STAGES;
    bf* Qs = ring + st * 2 * BQ * W;
    const bf* dOs = Qs + BQ * W;
    const float* ms = stat_ring + st * NS * BQ;
    if constexpr (FLASH) {
      // l -> 1 / l on the entries this thread loaded (0 past the end)
      float* ls = stat_ring + st * NS * BQ + BQ;
      for (int c = threadIdx.x; c < 3 * BQ; c += NT)
        if (c / BQ == 1) ls[c - BQ] = ls[c - BQ] > 0.f ? 1.f / ls[c - BQ] : 0.f;
    } else {
      scale_tile<W, BQ, NT>(Qs, p.scale);
    }
    __syncthreads();
    fetch(i + STAGES - 1);
    const int q0 = (qt0 + i) * BQ;

    float s[8][4];
    zero(s);
    product_nt<W, 64, 8>(s, Ks, row0, 0, Qs, 0, 0);  // S^T: keys x queries
    const bool diag = p.causal && q0 < k0 + kBK;
    const int* qids = reinterpret_cast<const int*>(ms + 3 * BQ);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * tq + (e & 1), r = e >> 1;
        if constexpr (FLASH) {
          float x = s[j][e] * p.scale;
          if ((ids && qids[c] != kid[r]) || (diag && key + 8 * r > q0 + c)) x += kFlashMask;
          s[j][e] = expf(x - ms[c]) * ms[BQ + c];  // pn
        } else {
          float x = s[j][e] + kb[r];
          if (diag && key + 8 * r > q0 + c) x = kMaskNeg;
          s[j][e] = expf(x - ms[c]) * ms[BQ + c];  // pn
        }
      }
    product_pv<W, 8>(dv, s, dOs, 0, 0);  // dV += bf16(pn)^T . dO
    float dp[8][4];
    zero(dp);
    product_nt<W, 64, 8>(dp, Vs, row0, 0, dOs, 0, 0);  // dP^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (FLASH)
          s[j][e] = (dp[j][e] - ms[2 * BQ + 8 * j + 2 * tq + (e & 1)]) * s[j][e] * p.scale;
        else
          s[j][e] *= dp[j][e] - ms[2 * BQ + 8 * j + 2 * tq + (e & 1)];
      }
    product_pv<W, 8>(dk, s, Qs, 0, 0);  // dK += bf16(ds)^T . q
  }
  // the warp's own rows of K and V take dK and dV (no other warp reads them)
  __syncwarp();
  stage_acc<W, 8>(Ks, dk, row0, 0, [](float x, int) { return x; });
  stage_acc<W, 8>(Vs, dv, row0, 0, [](float x, int) { return x; });
  __syncwarp();
  store_rows16<W, 64>(p.dk + static_cast<size_t>(b) * p.Tk * p.D + hoff, Ks, row0, 0, k0, p.Tk,
                      p.D);
  store_rows16<W, 64>(p.dv + static_cast<size_t>(b) * p.Tk * p.D + hoff, Vs, row0, 0, k0, p.Tk,
                      p.D);
}

// the two launches of the backward: dq (with the statistics; the flash
// policy has them from the forward), then dk/dv
template <int BQ, bool FLASH = false>
int launch_bwd(const BwdArgs<FLASH>& p, cudaStream_t stream) {
  constexpr size_t kA = dq_smem<BQ>(), kB = dkv_smem<FLASH>();
  auto dq_kernel = attn_bwd_dq_mma_kernel<BQ, FLASH>;
  auto dkv_kernel = attn_bwd_dkv_mma_kernel<FLASH>;
  static const cudaError_t configured = [&] {
    cudaError_t e = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kA));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(kB));
  }();
  if (configured != cudaSuccess) return static_cast<int>(configured);
  if (p.D != p.H * 64) return cudaErrorInvalidValue;
  dq_kernel<<<dim3((p.Tq + BQ - 1) / BQ, p.H, p.B), BQ * 2, kA, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  dkv_kernel<<<dim3((p.Tk + kBK - 1) / kBK, p.H, p.B), 128, kB, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mma
}  // namespace olm
