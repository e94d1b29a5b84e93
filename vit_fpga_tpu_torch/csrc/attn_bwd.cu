// Attention-half backward on Hopper (sm_90a), the backward of
// attn_block.cu.
//
// Replaces vit_fpga_tpu/ops/attn_block.py:_attn_bwd_kernel (wrapper
// attn_block_bwd_pallas), one Pallas kernel on the TPU that recomputes the
// forward per image and sums the weight gradients in VMEM across its
// sequential grid.  It ports that kernel's per-head (non-pair) arithmetic
// as a sequence of launches on one stream, counted as one ported kernel;
// every sum runs in a fixed order (no atomics), so a result is the same
// from run to run:
//
//   (a) ln_rows            two-pass (mu, rstd) of x and xn = bf16(LN(x))
//   (b) GEMM               qkv = bf16(xn @ Wqkv + bqkv)
//   (c) GEMM, B K-major    gw = bf16(g @ Wo^T)
//   (d) bwd_q_kernel       per (128 query rows, image x head): ao, dq and
//                          each row's softmax values, see below
//   (e) bwd_kv_kernel      per (128 keys, image x head): dk, dv
//   (f) GEMM, A MN-major   dWo = ao^T g, (g) dWqkv = xn^T dqkv (f32, over
//                          all B * n_pad rows, split-K partials added in
//                          split order by split_sum)
//   (h) colsum             dbo = sum of g, dbqkv = sum of dqkv
//   (i) GEMM, B K-major    dxn = dqkv @ Wqkv^T                  (f32)
//   (j) ln_bwd + colsum    dx = bf16(g + LN backward of dxn), dls, dlb
//
// The five products are gemm_wgmma.cuh's persistent wgmma + TMA GEMM in the
// layouts K24 (mlp_bwd.cu) runs: the forward's for (b), the weight read
// K-major for (c) and (i), the activation read MN-major through the
// transpose bit for (f) and (g).
//
// (d) and (e) are the attention's backward on mha_wgmma.cuh's machinery,
// FlashAttention-2's backward kept deterministic and at the rounding points
// of the TPU kernel: q, k, v and gw are read through 4-D tensor maps over
// the packed (B * n_pad, 3D) qkv and the (B * n_pad, D) gw (K's and V's
// row extent n_valid, so TMA zero-fills the keys past it), 128 rows a
// tile, into a ring of mbarrier stages filled by one producer thread; two
// consumer warpgroups of 64 rows (setmaxnreg 240 / 24) hold the
// score-space tiles in registers, 64 x 64 at a time (wgmma.m64n64k16 on
// half a stage tile, f32), and feed p or dS back as the register-A
// operand of wgmma.m64n64k16.  With s = q k^T * scale and keys at or past
// n_valid masked (the zero-filled keys give s = 0, not -inf: sweep 1 and
// (e) mask them explicitly; in sweeps 2 and 3 their zero k and v rows
// already make them add nothing):
//   (d) three sweeps over the key tiles of one block of 128 query rows:
//       1. the row max m and l = sum exp(s - m) (mha_wgmma.cuh's exact
//          pass 1, on 64 x 128 score tiles);
//       2. p = exp(s - m) / l in f32, dP = gw v^T (one wgmma group with s),
//          rs += sum dP p over the f32 p, ao += bf16(p) v;
//       3. s and dP again, dS = bf16(p (dP - rs) scale), dq += dS k;
//       then ao = bf16(ao), dq = bf16(dq) and each row's (m, 1/l, rs) into
//       a small f32 scratch.  The next 64 keys' s and dP are issued before
//       these keys' register-A product, so the two overlap.
//   (e) one sweep over the query tiles for one block of 128 keys: s^T =
//       k q^T and dP^T = v gw^T (A = the block's K and V tiles, B = the
//       query tile's q and gw), p^T and dS^T from the query rows' (m, 1/l,
//       rs), which the stage brings beside q and gw (a bulk copy), then dv
//       += bf16(p)^T gw and dk += dS^T q, accumulated in registers over
//       every query row; dk = bf16(dk), dv = bf16(dv), zero past n_valid.
// Query rows past n_valid are computed, as on the TPU.  Rows past n_pad in
// the last query tile land zero-filled (q = gw = 0) and add nothing.  No
// token limit: both kernels stream their tiles, (d)'s grid has nq_pad /
// 128 columns and (e) sweeps that many query tiles, the row values take
// (B H, nq_pad / 128, 3, 128) floats and every row count of the products
// is B n_pad; only batch x heads <= MW_MAX_GRID_Y (the grids' rows)
// bounds the launch.  The JAX package runs its Pallas backward where
// _bwd_fits holds (ViT-B/16 up to 640 px, 1608 tokens), the wrapper's
// route too.
//
// Head dim 64 or 80 (DH, ViT-H/14's 1280 / 16): the tiles take the core's
// two boxes at 80 (mha_wgmma.cuh's MwDim: columns 0..63 128-byte swizzled,
// 64..79 32-byte swizzled), each product over dh takes the second box's
// k16 step, and each product into dh columns (ao, dq, dk, dv) its
// m64n16k16 into acc[32..39].  At 80, (e) would hold dk and dv (40 floats
// each) beside 64 x 64 s and dP tiles and their bf16 operands: 176
// registers a thread against ptxas's 168, so (e) walks each query tile in
// four 32-row sub-tiles (AbDim::QW; s^T and dP^T 64 x 32 by
// wgmma.m64n32k16, 128 registers); at 64 it keeps its two 64-row halves.
// (d) at 80 holds 40-float accumulators beside its 64 x 64 tiles (120).
//
// What bounds it on the H100: seven projection-sized products (22 R D^2
// flops, R = B * n_pad) plus six score-space products (6 x 2 B H n_pad
// n_valid dh), 189 GFLOP at ViT-B/16 batch 64 (0.191 ms at 989 TFLOP/s,
// 700 W), so it is bound by tensor-core operations; compulsory traffic is
// under 100 MB.  qkv, gw, ao, dqkv and the f32 dxn round-trip through
// device memory; the attention backward does eleven 128 x 128 x 64
// products a (query tile, key tile) pair on its padded tiles (71 GFLOP at
// ViT-B b64: 128-row tiles over 200 tokens).

#define VFT_NS attn_bwd
#include "common.cuh"
#include "hopper.cuh"
#include "gemm_wgmma.cuh"
#include "mha_wgmma.cuh"
#include "norm.cuh"

namespace VFT_NS {

constexpr int AB_LONG_KEYS = 256;    // more valid keys: counted apart (*long_path)
// A query tile's row values: m2 (row max of s * scale * log2 e), 1 / l and
// rs, 128 floats each.
constexpr uint32_t AB_VALS_BYTES = 3 * MW_BQ * 4;
static_assert(AB_VALS_BYTES <= 2048, "the row values fit their slot");

// The register tiles are 64 x 64 in (d) and 64 x QW in (e), a part of a
// 128-row stage tile: s, dP, the register-A operands and the accumulators
// then fit in the 168 registers ptxas gives a thread of a 384-thread block.
template <int DH>
struct AbDim {
  static constexpr uint32_t TILE = MwDim<DH>::TILE;
  static constexpr int QW = DH == 64 ? 64 : 32;  // (e)'s query rows a sub-tile
  // (e)'s stage: the query tile's q and gw, then its row values, padded to
  // the swizzle's 1 KB period (34 KB at DH 64, 42 KB at 80).
  static constexpr uint32_t KV_STAGE = 2 * TILE + 2048;
  // 1 KB of slack for the swizzle's alignment, then (d): q, gw, the K / V
  // ring and the barriers; (e): k, v, the q / gw / row-value ring and the
  // barriers.
  static constexpr size_t Q_SMEM =
      1024 + 2 * TILE + 2 * MW_STAGES * TILE + 8 * (2 * MW_STAGES + 1);
  static constexpr size_t KV_SMEM =
      1024 + 2 * TILE + MW_STAGES * KV_STAGE + 8 * (2 * MW_STAGES + 1);
};

// The maps of (d) and (e): the packed qkv's q, k, v (rows n_pad, n_valid,
// n_valid) and gw (rows n_pad), and at DH 80 their columns 64..79.
struct AbMaps {
  CUtensorMap q, k, v, g, q1, k1, v1, g1;
};

struct BwdArgs {
  bf16* ao;          // (B * n_pad, D)
  bf16* dqkv;        // (B * n_pad, 3D)
  float* vals;       // (B * H, nq_pad / 128, 3, 128) query rows' m2, 1 / l, rs
  int heads, n_pad, n_valid, nq_pad, d;
  float scale_log2;  // softmax scale * log2(e)
  float scale;
};

// One k16 step of d (64 x N, f32) (+)= A B^T, both K-major in shared
// memory.
template <int N>
__device__ __forceinline__ void ss_step(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (N == 64)
    wgmma_m64n64k16_ss(d, da, db, acc);
  else
    wgmma_m64n32k16_ss(d, da, db, acc);
}

// a = A B^T over dh: the first box's 4 k16 steps, at DH 80 the second's.
template <int DH, int N>
__device__ __forceinline__ void ss_dh(float (&d)[N / 2], MwDesc a, MwDesc b) {
#pragma unroll
  for (int k = 0; k < 4; ++k) ss_step<N>(d, a.d0 + 2 * k, b.d0 + 2 * k, k);
  if constexpr (DH == 80) ss_step<N>(d, a.d1, b.d1, 1);
}

// Issues a = A1 B1^T and b = A2 B2^T (64 x N each, both operands K-major
// in shared memory) as one wgmma group: s and dP in (d), s^T and dP^T in
// (e).
template <int DH, int N>
__device__ __forceinline__ void pair_issue(float (&a)[N / 2], float (&b)[N / 2], MwDesc a1,
                                           MwDesc b1, MwDesc a2, MwDesc b2) {
  reg_fence(a);
  reg_fence(b);
  wgmma_fence();
  ss_dh<DH, N>(a, a1, b1);
  ss_dh<DH, N>(b, a2, b2);
  wgmma_commit();
}

// Issues acc += A B for 16 KS rows of B (KS k steps of 16; A the register
// operand, B MN-major through the transpose bit, 16 rows further a step)
// as one wgmma group: B's first box into acc[0..31], at DH 80 its second
// into acc[32..39].
template <int DH, int KS>
__device__ __forceinline__ void rs_issue(float (&acc)[DH / 2], uint32_t (&pa)[4 * KS],
                                         MwDesc bd) {
  reg_fence(acc);
  reg_fence(pa);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const MwDesc b = mw_rows<DH>(bd, 16 * kk);
    wgmma_m64n64k16_rs_t(acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3], b.d0);
    if constexpr (DH == 80)
      wgmma_m64n16k16_rs_t_hi(acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                              b.d1);
  }
  wgmma_commit();
}

// (d)'s p = ex2(s2 - m2) * (1 / l) of a finished 64-key unit in place (f32);
// DS: then s = p (dP - rs) scale (rs the rows' whole sums), else rs += p dP
// (this thread's share).  Element x sits at row g + 8 ((x / 2) % 2).  A key
// at or past n_valid needs no mask here: sweep 1 left it out of l, and TMA
// zero-filled its k and v, so its dP is 0 and it adds 0 to rs, ao and dq.
template <bool DS>
__device__ __forceinline__ void bwd_probs(float (&s)[32], const float (&dp)[32], const MwRows& r,
                                          float (&rs)[2], float sl2, float scale) {
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    const int rr = (x >> 1) & 1;
    const float p = ex2(fmaf(s[x], sl2, -r.m2[rr])) * r.l[rr];
    if (DS) {
      s[x] = (p * (dp[x] - rs[rr])) * scale;
    } else {
      rs[rr] += p * dp[x];
      s[x] = p;
    }
  }
}

template <int N>
__device__ __forceinline__ void pack_probs(const float (&s)[N], uint32_t (&pa)[N / 2]) {
#pragma unroll
  for (int x = 0; x < N / 2; ++x) pa[x] = pack_bf16x2(s[2 * x], s[2 * x + 1]);
}

// (d)'s sweep 2 (!DS: ao += bf16(p) v, rs += sum dP p) or 3 (DS: dq += dS
// k) over the ntk key tiles from ring step step0, as 2 ntk units of 64
// keys (unit u: tile u / 2, half u % 2).  Unit u's s and dP are issued
// before unit u - 1's register-A product, and turned into p (and rs) or dS
// in place while that product runs (mha_wgmma.cuh's pv_next pattern: pa
// is written only once no group is in flight).  A tile's stage is released
// once its second half's product is done.
template <bool DS, int DH>
__device__ __forceinline__ void bwd_sweep(float (&s)[32], float (&dp)[32], uint32_t (&pa)[16],
                                          float (&acc)[DH / 2], const MwRows& r, float (&rs)[2],
                                          int step0, int ntk, float sl2, float scale, MwDesc qd,
                                          MwDesc gd, uint32_t ring, uint32_t bars) {
  // K at ring + 2 s TILE, V after it; the register-A product's B is K
  // (dq += dS k) or V (ao += p v).
  auto k_desc = [&](int u) {
    return mw_rows<DH>(mw_k<DH>(ring, (step0 + (u >> 1)) % MW_STAGES), (u & 1) * 64);
  };
  auto v_desc = [&](int u) {
    return mw_rows<DH>(mw_v<DH>(ring, (step0 + (u >> 1)) % MW_STAGES), (u & 1) * 64);
  };
  auto wait_tile = [&](int u) {
    const int i = step0 + (u >> 1);
    if ((u & 1) == 0) mbar_wait(bars + 8 * (i % MW_STAGES), (i / MW_STAGES) & 1);
  };
#pragma unroll
  for (int x = 0; x < DH / 2; ++x) acc[x] = 0.0f;
  const int units = 2 * ntk;
  wait_tile(0);
  pair_issue<DH, 64>(s, dp, qd, k_desc(0), gd, v_desc(0));
  wgmma_wait<0>();
  reg_fence(s);
  reg_fence(dp);
  bwd_probs<DS>(s, dp, r, rs, sl2, scale);
  pack_probs(s, pa);
  for (int u = 1; u < units; ++u) {
    wait_tile(u);
    pair_issue<DH, 64>(s, dp, qd, k_desc(u), gd, v_desc(u));
    rs_issue<DH, 4>(acc, pa, DS ? k_desc(u - 1) : v_desc(u - 1));
    wgmma_wait<1>();  // s and dP (the older group) are done
    reg_fence(s);
    reg_fence(dp);
    bwd_probs<DS>(s, dp, r, rs, sl2, scale);
    wgmma_wait<0>();
    reg_fence(acc);
    reg_fence(pa);
    if ((u & 1) == 0)  // unit u - 1 ended its tile
      mbar_arrive(bars + 8 * (MW_STAGES + (step0 + (u >> 1) - 1) % MW_STAGES));
    pack_probs(s, pa);
  }
  rs_issue<DH, 4>(acc, pa, DS ? k_desc(units - 1) : v_desc(units - 1));
  wgmma_wait<0>();
  reg_fence(acc);
  reg_fence(pa);
  mbar_arrive(bars + 8 * (MW_STAGES + (step0 + ntk - 1) % MW_STAGES));
}

// One consumer thread's rows g and g + 8 of its warp's 16 (first row row0)
// of a 64 x DH accumulator as bf16, to dst + row * ld, rows before n_pad.
template <int DH>
__device__ __forceinline__ void store_rows(const float (&acc)[DH / 2], bf16* dst, size_t ld,
                                           int row0, int n_pad, int g, int t4) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = row0 + g + 8 * rr;
    if (row >= n_pad) continue;
    bf16* out = dst + (size_t)row * ld + 2 * t4;
#pragma unroll
    for (int c = 0; c < DH / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * c) =
          __floats2bfloat162_rn(acc[4 * c + 2 * rr], acc[4 * c + 2 * rr + 1]);
  }
}

// (d): grid (nq_pad / 128, B * H).
template <int DH>
__global__ void __launch_bounds__(MW_THREADS, 1)
    bwd_q_kernel(const __grid_constant__ AbMaps m, BwdArgs p) {
  constexpr uint32_t TILE = AbDim<DH>::TILE;
  extern __shared__ unsigned char ab_smem[];
  const uint32_t q_s = (smem_u32(ab_smem) + 1023u) & ~1023u;
  const uint32_t g_s = q_s + TILE;
  const uint32_t ring = g_s + TILE;  // stage s: K at ring + 2 s TILE, V after it
  const uint32_t bars = ring + 2 * MW_STAGES * TILE;
  const uint32_t qbar = bars + 16 * MW_STAGES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (MW_STAGES + s); };
  const int tid = threadIdx.x, warp = tid >> 5;
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int q0 = blockIdx.x * MW_BQ;
  const int ntk = (p.n_valid + MW_KT - 1) / MW_KT;

  if (tid == 0) {
    for (int s = 0; s < MW_STAGES; ++s) {
      mbar_init(full(s), 1);                    // the producer's expect_tx
      mbar_init(empty(s), 128 * MW_CONSUMERS);  // every consumer thread
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * MW_CONSUMERS) {
    // Producer: q and gw once, then ring step i: K tile i of sweep 1 for i
    // < ntk, the (K, V) tile pairs of sweeps 2 and 3 after.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 128 * MW_CONSUMERS) {
      mbar_expect_tx(qbar, 2 * TILE);
      mw_load<DH>(q_s, &m.q, &m.q1, qbar, q0, h, b);
      mw_load<DH>(g_s, &m.g, &m.g1, qbar, q0, h, b);
      for (int i = 0; i < 3 * ntk; ++i) {
        const int s = i % MW_STAGES, key0 = (i % ntk) * MW_KT;
        const bool kv = i >= ntk;
        mbar_wait(empty(s), ((i / MW_STAGES) & 1) ^ 1);  // round 0 passes at once
        const uint32_t ks = ring + 2 * s * TILE;
        mbar_expect_tx(full(s), kv ? 2 * TILE : TILE);
        mw_load<DH>(ks, &m.k, &m.k1, full(s), key0, h, b);
        if (kv) mw_load<DH>(ks + TILE, &m.v, &m.v1, full(s), key0, h, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = warp >> 2, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const MwDesc qd = mw_tile<DH>(q_s, wg * 64);
    const MwDesc gd = mw_tile<DH>(g_s, wg * 64);
    const float sl2 = p.scale_log2;
    MwRows r{{-INFINITY, -INFINITY}, {0.0f, 0.0f}};
    float rs[2] = {0.0f, 0.0f};
    mbar_wait(qbar, 0);

    {  // Sweep 1: the row max and sum over 128-key tiles, two a trip (the
       // score buffers alternate); one or two tiles are left for the tail.
      float sa[64], sb[64];
      mbar_wait(full(0), 0);
      qk_issue<DH>(sa, qd, mw_k<DH>(ring, 0));
      int i = 0;
      for (; i + 2 < ntk; i += 2) {
        stats_next<true, DH>(sa, sb, r, i, sl2, qd, ring, bars);
        stats_next<true, DH>(sb, sa, r, i + 1, sl2, qd, ring, bars);
      }
      if (i + 1 < ntk) {
        stats_next<true, DH>(sa, sb, r, i, sl2, qd, ring, bars);
        stats_last(sb, r, i + 1, i + 1, p.n_valid, sl2, t4, bars);
      } else {
        stats_last(sa, r, i, i, p.n_valid, sl2, t4, bars);
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) r.l[rr] = 1.0f / quad_sum(r.l[rr]);

    const int lrow = wg * 64 + (warp & 3) * 16;  // this warp's first row in the tile
    const size_t base = (size_t)b * p.n_pad;
    float s[32], dp[32], acc[DH / 2];
    uint32_t pa[16];
    bwd_sweep<false, DH>(s, dp, pa, acc, r, rs, ntk, ntk, sl2, p.scale, qd, gd, ring, bars);
    store_rows<DH>(acc, p.ao + base * p.d + h * DH, p.d, q0 + lrow, p.n_pad, g, t4);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) rs[rr] = quad_sum(rs[rr]);
    bwd_sweep<true, DH>(s, dp, pa, acc, r, rs, 2 * ntk, ntk, sl2, p.scale, qd, gd, ring, bars);
    store_rows<DH>(acc, p.dqkv + base * 3 * p.d + h * DH, 3 * (size_t)p.d, q0 + lrow, p.n_pad, g,
                   t4);
    if (t4 == 0) {
      float* vals = p.vals + ((size_t)blockIdx.y * (p.nq_pad / MW_BQ) + blockIdx.x) * 3 * MW_BQ;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = lrow + g + 8 * rr;
        vals[row] = r.m2[rr];
        vals[MW_BQ + row] = r.l[rr];
        vals[2 * MW_BQ + row] = rs[rr];
      }
    }
  }
}

// (e): grid (nq_pad / 128, B * H), one block per 128 keys.  The same maps
// as (d); vals: (d)'s row values.
template <int DH>
__global__ void __launch_bounds__(MW_THREADS, 1)
    bwd_kv_kernel(const __grid_constant__ AbMaps m, BwdArgs p) {
  constexpr uint32_t TILE = AbDim<DH>::TILE, STAGE = AbDim<DH>::KV_STAGE;
  constexpr int QW = AbDim<DH>::QW;
  extern __shared__ unsigned char ab_smem[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int k0 = blockIdx.x * MW_KT;
  const size_t base = (size_t)b * p.n_pad;
  bf16* dk = p.dqkv + base * 3 * p.d + p.d + h * DH;  // dv at + D
  if (k0 >= p.n_valid) {
    // every key of the tile is masked: zero gradients, rows before n_pad
    for (int c = tid; c < MW_KT * 2 * (DH / 8); c += MW_THREADS) {
      const int row = k0 + c / (2 * (DH / 8)), part = (c / (DH / 8)) & 1;
      if (row < p.n_pad)
        *reinterpret_cast<uint4*>(dk + (size_t)row * 3 * p.d + part * p.d + 8 * (c % (DH / 8))) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  const uint32_t k_s = (smem_u32(ab_smem) + 1023u) & ~1023u;
  const uint32_t v_s = k_s + TILE;
  const uint32_t ring = v_s + TILE;  // stage s: q, gw, row values at ring + s STAGE
  unsigned char* ring_g = ab_smem + (ring - smem_u32(ab_smem));
  const uint32_t bars = ring + MW_STAGES * STAGE;
  const uint32_t kvbar = bars + 16 * MW_STAGES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (MW_STAGES + s); };
  const int nqt = p.nq_pad / MW_BQ;

  if (tid == 0) {
    for (int s = 0; s < MW_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128 * MW_CONSUMERS);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * MW_CONSUMERS) {
    // Producer: the block's K and V tiles once, then ring step j: query
    // tile j's q, gw and row values.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 128 * MW_CONSUMERS) {
      mbar_expect_tx(kvbar, 2 * TILE);
      mw_load<DH>(k_s, &m.k, &m.k1, kvbar, k0, h, b);
      mw_load<DH>(v_s, &m.v, &m.v1, kvbar, k0, h, b);
      const float* vals = p.vals + (size_t)blockIdx.y * nqt * 3 * MW_BQ;
      for (int j = 0; j < nqt; ++j) {
        const int s = j % MW_STAGES;
        mbar_wait(empty(s), ((j / MW_STAGES) & 1) ^ 1);
        const uint32_t st = ring + s * STAGE;
        mbar_expect_tx(full(s), 2 * TILE + AB_VALS_BYTES);
        mw_load<DH>(st, &m.q, &m.q1, full(s), j * MW_BQ, h, b);
        mw_load<DH>(st + TILE, &m.g, &m.g1, full(s), j * MW_BQ, h, b);
        bulk_load(st + 2 * TILE, vals + (size_t)j * 3 * MW_BQ, AB_VALS_BYTES, full(s));
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = warp >> 2, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const MwDesc kd = mw_tile<DH>(k_s, wg * 64);
    const MwDesc vd = mw_tile<DH>(v_s, wg * 64);
    const float sl2 = p.scale_log2, scale = p.scale;
    const int row0 = k0 + wg * 64 + (warp & 3) * 16;  // this warp's first key
    const bool valid[2] = {row0 + g < p.n_valid, row0 + g + 8 < p.n_valid};
    float s[QW / 2], dp[QW / 2], dkacc[DH / 2], dvacc[DH / 2];
    uint32_t pp[QW / 4], pd[QW / 4];
#pragma unroll
    for (int x = 0; x < DH / 2; ++x) dkacc[x] = dvacc[x] = 0.0f;
    mbar_wait(kvbar, 0);
    for (int j = 0; j < nqt; ++j) {
      const int st = j % MW_STAGES;
      mbar_wait(full(st), (j / MW_STAGES) & 1);
      const uint32_t qs = ring + st * STAGE;
      const float* vals = reinterpret_cast<const float*>(ring_g + st * STAGE + 2 * TILE);
#pragma unroll 1
      for (int sub = 0; sub < MW_BQ / QW; ++sub) {  // query rows QW sub .. of the tile
        const MwDesc qh = mw_tile<DH>(qs, QW * sub), gh = mw_tile<DH>(qs + TILE, QW * sub);
        pair_issue<DH, QW>(s, dp, kd, qh, vd, gh);
        wgmma_wait<0>();
        reg_fence(s);
        reg_fence(dp);
        // Element x: key row g + 8 ((x / 2) % 2), query QW sub + 8 (x / 4)
        // + 2 t4 + x % 2 of the tile, whose m2, 1 / l and rs the stage holds.
#pragma unroll
        for (int y = 0; y < QW / 4; ++y) {
          const int x = 2 * y, c = QW * sub + 8 * (y >> 1) + 2 * t4;
          const float2 m2 = *reinterpret_cast<const float2*>(vals + c);
          const float2 li = *reinterpret_cast<const float2*>(vals + MW_BQ + c);
          const float2 rsv = *reinterpret_cast<const float2*>(vals + 2 * MW_BQ + c);
          const bool kv = valid[y & 1];
          const float p0 = kv ? ex2(fmaf(s[x], sl2, -m2.x)) * li.x : 0.0f;
          const float p1 = kv ? ex2(fmaf(s[x + 1], sl2, -m2.y)) * li.y : 0.0f;
          pp[y] = pack_bf16x2(p0, p1);
          pd[y] = pack_bf16x2((p0 * (dp[x] - rsv.x)) * scale, (p1 * (dp[x + 1] - rsv.y)) * scale);
        }
        rs_issue<DH, QW / 16>(dvacc, pp, gh);  // dv += bf16(p)^T gw
        rs_issue<DH, QW / 16>(dkacc, pd, qh);  // dk += dS^T q
        wgmma_wait<0>();
        reg_fence(dvacc);
        reg_fence(dkacc);
        reg_fence(pp);
        reg_fence(pd);
      }
      mbar_arrive(empty(st));
    }
    store_rows<DH>(dkacc, dk, 3 * (size_t)p.d, row0, p.n_pad, g, t4);
    store_rows<DH>(dvacc, dk + p.d, 3 * (size_t)p.d, row0, p.n_pad, g, t4);
  }
}

struct AttnBwdWork {
  size_t st, xn, qkv, gw, ao, dqkv, dxn, vals, parts, lnpart, cspart, bytes;
  int splits_o, splits_qkv;  // of the weight-gradient products (f) and (g)
};

inline size_t align256(size_t x) { return (x + 255) & ~size_t(255); }

inline int nq_pad_of(int n_pad) { return (n_pad + MW_BQ - 1) / MW_BQ * MW_BQ; }

// Splits of a weight-gradient product of `tiles` 128 x 256 tiles over nk K
// steps: as many as fill the SMs once (at least four K steps a unit).  At
// ViT-B b64 dWo's 18 tiles take 7 and dWqkv's 54 take 2, where
// gemm_wgmma.cuh's four-wave gw_splits gives 30 and 10 and writes 71 MB of
// f32 partials for each.
inline int wgrad_splits(long long tiles, int nk, int sms) {
  long long s = sms / tiles;
  if (s > nk / 4) s = nk / 4;
  return s < 1 ? 1 : (int)s;
}

// The workspace at this shape on a card of `sms` SMs.
inline AttnBwdWork attn_bwd_work(int batch, int n_pad, int d, int sms) {
  const int rows = batch * n_pad;
  AttnBwdWork w;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const size_t at = off;
    off += align256(bytes);
    return at;
  };
  const int nk = (rows + GW_BK - 1) / GW_BK, row_tiles = (d + GW_BM - 1) / GW_BM;
  w.splits_o = wgrad_splits((long long)row_tiles * ((d + GW_BN - 1) / GW_BN), nk, sms);
  w.splits_qkv = wgrad_splits((long long)row_tiles * ((3 * d + GW_BN - 1) / GW_BN), nk, sms);
  const size_t po = (size_t)w.splits_o * d * d, pq = (size_t)w.splits_qkv * d * 3 * d;
  w.st = take((size_t)rows * 2 * sizeof(float));
  w.xn = take((size_t)rows * d * sizeof(bf16));
  w.qkv = take((size_t)rows * 3 * d * sizeof(bf16));
  w.gw = take((size_t)rows * d * sizeof(bf16));
  w.ao = take((size_t)rows * d * sizeof(bf16));
  w.dqkv = take((size_t)rows * 3 * d * sizeof(bf16));
  w.dxn = take((size_t)rows * d * sizeof(float));
  // heads <= D / 64 at either head dim
  w.vals = take((size_t)batch * (d / 64) * nq_pad_of(n_pad) * 3 * sizeof(float));
  w.parts = take((po > pq ? po : pq) * sizeof(float));  // (f) and (g) in turn
  w.lnpart = take((size_t)ln_bwd_blocks(rows) * 2 * d * sizeof(float));
  size_t cs = colsum_scratch_floats(rows, 3 * d);  // the largest of the three
  if (cs < colsum_scratch_floats(ln_bwd_blocks(rows), 2 * d))
    cs = colsum_scratch_floats(ln_bwd_blocks(rows), 2 * d);
  w.cspart = take(cs * sizeof(float));
  w.bytes = off;
  return w;
}

inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

template <int DH>
inline cudaError_t bwd_enable() {
  cudaError_t err = cudaFuncSetAttribute(
      bwd_q_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)AbDim<DH>::Q_SMEM);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(bwd_kv_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)AbDim<DH>::KV_SMEM);
}

// (d) then (e) at head dim DH over the packed qkv and gw.
template <int DH>
inline cudaError_t launch_attn_bwd_core(const bf16* qkv, const bf16* gw, const BwdArgs& a,
                                        int batch, cudaStream_t st) {
  const long long in_b = (long long)a.n_pad * 3 * a.d;
  AbMaps m;
  if (!mw_encode_dh<DH>(&m.q, &m.q1, qkv, in_b, DH, 3 * a.d, a.n_pad, a.heads, batch) ||
      !mw_encode_dh<DH>(&m.k, &m.k1, qkv + a.d, in_b, DH, 3 * a.d, a.n_valid, a.heads, batch) ||
      !mw_encode_dh<DH>(&m.v, &m.v1, qkv + 2 * a.d, in_b, DH, 3 * a.d, a.n_valid, a.heads,
                        batch) ||
      !mw_encode_dh<DH>(&m.g, &m.g1, gw, (long long)a.n_pad * a.d, DH, a.d, a.n_pad, a.heads,
                        batch))
    return cudaErrorInvalidValue;
  const dim3 grid(a.nq_pad / MW_BQ, batch * a.heads);
  bwd_q_kernel<DH><<<grid, MW_THREADS, AbDim<DH>::Q_SMEM, st>>>(m, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_kv_kernel<DH><<<grid, MW_THREADS, AbDim<DH>::KV_SMEM, st>>>(m, a);
  return cudaGetLastError();
}

}  // namespace VFT_NS

using namespace VFT_NS;

extern "C" {

// Finds cuTensorMapEncodeTiled and opts this unit's kernels in to the
// shared memory they use, on the current device.  Called once per device
// before the first launch.  Returns a cudaError_t.
int vft_attn_bwd_init() {
  cudaError_t err = tma_init();
  if (err != cudaSuccess) return err;
  if ((err = gw_enable()) != cudaSuccess) return err;
  if ((err = gw_enable_bwd<GW_AK_BK, GW_EPI_BF16>()) != cudaSuccess) return err;
  if ((err = gw_enable_bwd<GW_AK_BK, GW_EPI_F32>()) != cudaSuccess) return err;
  if ((err = gw_enable_bwd<GW_AM_BN, GW_EPI_F32>()) != cudaSuccess) return err;
  if ((err = bwd_enable<64>()) != cudaSuccess || (err = bwd_enable<80>()) != cudaSuccess)
    return err;
  return ln_bwd_enable();
}

// Bytes of device workspace vft_attn_block_bwd takes at this shape on the
// current device (0 if the device cannot be read).
size_t vft_attn_bwd_workspace(int batch, int n_pad, int d) {
  int sms = 0;
  return sm_count(&sms) == cudaSuccess ? attn_bwd_work(batch, n_pad, d, sms).bytes : 0;
}

// x, g, dx: (B * n_pad, D) bf16; ls, lb: (D,) f32; wqkv: (D, 3D) bf16;
// bqkv: (3D,) f32; wo: (D, D) bf16.  Outputs, f32: dln (2D,) = [dls | dlb],
// dwqkv (D, 3D), dbqkv (3D,), dwo (D, D), dbo (D,).  work:
// vft_attn_bwd_workspace bytes.  Head dim 64 or 80, 1 <= n_valid <= n_pad,
// batch x heads <= MW_MAX_GRID_Y, B * n_pad a multiple of 8, D <= 2048
// (LNB_MAX_D); every pointer 16-byte
// aligned.  *long_path is set to 1 when more than 256 keys are valid (the
// same kernels; the launch checks count those launches apart) and 0
// otherwise.  Everything is enqueued on `stream`, which belongs to the
// current device.  Returns a cudaError_t.
int vft_attn_block_bwd(const void* x, const void* g, const void* ls, const void* lb,
                       const void* wqkv, const void* bqkv, const void* wo, void* dx, void* dln,
                       void* dwqkv, void* dbqkv, void* dwo, void* dbo, void* work, int batch,
                       int n_pad, int d, int heads, int n_valid, float eps, float scale,
                       void* stream, int* long_path) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int rows = batch * n_pad;
  if (heads < 1 || d % heads || (d / heads != 64 && d / heads != 80) || batch < 1 ||
      n_valid < 1 || n_valid > n_pad || (long long)batch * heads > MW_MAX_GRID_Y || rows % 8 ||
      d > LNB_MAX_D)
    return cudaErrorInvalidValue;
  if (tma_encoder() == nullptr) return cudaErrorInitializationError;
  int sms = 0;
  cudaError_t err;
  if ((err = sm_count(&sms)) != cudaSuccess) return err;
  const AttnBwdWork w = attn_bwd_work(batch, n_pad, d, sms);
  unsigned char* ws = static_cast<unsigned char*>(work);
  float* stats = reinterpret_cast<float*>(ws + w.st);
  bf16* xn = reinterpret_cast<bf16*>(ws + w.xn);
  bf16* qkv = reinterpret_cast<bf16*>(ws + w.qkv);
  bf16* gw = reinterpret_cast<bf16*>(ws + w.gw);
  bf16* ao = reinterpret_cast<bf16*>(ws + w.ao);
  bf16* dqkv = reinterpret_cast<bf16*>(ws + w.dqkv);
  float* dxn = reinterpret_cast<float*>(ws + w.dxn);
  float* parts = reinterpret_cast<float*>(ws + w.parts);
  float* lnpart = reinterpret_cast<float*>(ws + w.lnpart);
  float* cspart = reinterpret_cast<float*>(ws + w.cspart);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gb = static_cast<const bf16*>(g);
  const bf16* wqkvb = static_cast<const bf16*>(wqkv);

  if ((err = launch_ln_rows(xb, static_cast<const float*>(ls), static_cast<const float*>(lb),
                            stats, xn, rows, d, eps, st)) != cudaSuccess)
    return err;

  GwArgs p{};  // (b) qkv = bf16(xn @ Wqkv + bqkv)
  p.bias = static_cast<const float*>(bqkv);
  p.C = qkv;
  p.M = rows;
  p.N = 3 * d;
  p.K = d;
  p.act = ACT_NONE;
  if ((err = launch_gemm_wgmma(xn, wqkvb, false, p, st)) != cudaSuccess) return err;

  p = GwArgs{};  // (c) gw = bf16(g @ Wo^T), Wo (D, D) read K-major
  p.C = gw;
  p.M = rows;
  p.N = d;
  p.K = d;
  p.act = ACT_NONE;
  if ((err = launch_gemm_wgmma<GW_AK_BK, GW_EPI_BF16>(gb, static_cast<const bf16*>(wo), false, p,
                                                       st)) != cudaSuccess)
    return err;

  // (d), (e): q, k and v are column blocks of the packed rows (head h at h
  // * dh of each, row stride 3D, image stride n_pad * 3D); gw's row stride
  // is D.
  const BwdArgs a{ao,    dqkv,    reinterpret_cast<float*>(ws + w.vals), heads, n_pad, n_valid,
                  nq_pad_of(n_pad), d, scale * 1.4426950408889634f, scale};
  err = d / heads == 80 ? launch_attn_bwd_core<80>(qkv, gw, a, batch, st)
                        : launch_attn_bwd_core<64>(qkv, gw, a, batch, st);
  if (err != cudaSuccess) return err;
  *long_path = n_valid > AB_LONG_KEYS;

  p = GwArgs{};  // (f) dWo = ao^T g, ao (rows, D) read MN-major, split over rows
  p.C32 = parts;
  p.splits = w.splits_o;
  p.M = d;
  p.N = d;
  p.K = rows;
  if ((err = launch_gemm_wgmma<GW_AM_BN, GW_EPI_F32>(ao, gb, false, p, st)) != cudaSuccess ||
      (err = launch_split_sum(parts, static_cast<float*>(dwo), (size_t)d * d, w.splits_o, st)) !=
          cudaSuccess)
    return err;
  if ((err = launch_colsum<bf16>(gb, static_cast<float*>(dbo), cspart, rows, d, st)) !=
      cudaSuccess)
    return err;

  p.splits = w.splits_qkv;  // (g) dWqkv = xn^T dqkv
  p.N = 3 * d;
  if ((err = launch_gemm_wgmma<GW_AM_BN, GW_EPI_F32>(xn, dqkv, false, p, st)) != cudaSuccess ||
      (err = launch_split_sum(parts, static_cast<float*>(dwqkv), (size_t)d * 3 * d, w.splits_qkv,
                              st)) != cudaSuccess)
    return err;
  if ((err = launch_colsum<bf16>(dqkv, static_cast<float*>(dbqkv), cspart, rows, 3 * d, st)) !=
      cudaSuccess)
    return err;

  p = GwArgs{};  // (i) dxn = dqkv @ Wqkv^T, Wqkv (D, 3D) read K-major
  p.C32 = dxn;
  p.splits = 1;
  p.M = rows;
  p.N = d;
  p.K = 3 * d;
  if ((err = launch_gemm_wgmma<GW_AK_BK, GW_EPI_F32>(dqkv, wqkvb, false, p, st)) != cudaSuccess)
    return err;

  if ((err = launch_ln_bwd(xb, stats, dxn, gb, static_cast<const float*>(ls),
                           static_cast<bf16*>(dx), lnpart, rows, d, st)) != cudaSuccess)
    return err;
  if ((err = launch_colsum<float>(lnpart, static_cast<float*>(dln), cspart, ln_bwd_blocks(rows),
                                  2 * d, st)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

}  // extern "C"
