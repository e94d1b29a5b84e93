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
// The register tiles are 64 x 64, half a 128-row stage tile (8 KB down it):
// s, dP, the register-A operand and an accumulator then fit in the 168
// registers ptxas gives a thread of a 384-thread block.
constexpr uint32_t AB_HALF_DESC = 64 * MW_ROW_BYTES >> 4;  // 64 rows, in descriptor units
// A query tile's row values: m2 (row max of s * scale * log2 e), 1 / l and
// rs, 128 floats each.
constexpr uint32_t AB_VALS_BYTES = 3 * MW_BQ * 4;
// (e)'s stage: the query tile's q and gw, then its row values, padded to
// the swizzle's 1 KB period.
constexpr uint32_t AB_KV_STAGE = 2 * MW_TILE_BYTES + 2048;  // 34 KB
static_assert(AB_VALS_BYTES <= 2048, "the row values fit their slot");
// 1 KB of slack for the swizzle's alignment, then (d): q, gw, the K / V
// ring and the barriers; (e): k, v, the q / gw / row-value ring and the
// barriers.
constexpr size_t AB_Q_SMEM =
    1024 + 2 * MW_TILE_BYTES + 2 * MW_STAGES * MW_TILE_BYTES + 8 * (2 * MW_STAGES + 1);
constexpr size_t AB_KV_SMEM =
    1024 + 2 * MW_TILE_BYTES + MW_STAGES * AB_KV_STAGE + 8 * (2 * MW_STAGES + 1);

struct BwdArgs {
  bf16* ao;          // (B * n_pad, D)
  bf16* dqkv;        // (B * n_pad, 3D)
  float* vals;       // (B * H, nq_pad / 128, 3, 128) query rows' m2, 1 / l, rs
  int heads, n_pad, n_valid, nq_pad, d;
  float scale_log2;  // softmax scale * log2(e)
  float scale;
};

// Issues a = A1 B1^T and b = A2 B2^T (64 x 64 each, both operands K-major
// in shared memory) as one wgmma group: s and dP in (d), s^T and dP^T in
// (e).
__device__ __forceinline__ void pair_issue(float (&a)[32], float (&b)[32], uint64_t a1,
                                           uint64_t b1, uint64_t a2, uint64_t b2) {
  reg_fence(a);
  reg_fence(b);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < MW_DH / 16; ++k) wgmma_m64n64k16_ss(a, a1 + 2 * k, b1 + 2 * k, k);
#pragma unroll
  for (int k = 0; k < MW_DH / 16; ++k) wgmma_m64n64k16_ss(b, a2 + 2 * k, b2 + 2 * k, k);
  wgmma_commit();
}

// Issues acc += A B for 64 rows of B (4 k steps of 16; A the register
// operand, B MN-major through the transpose bit, 2 KB further a step) as
// one wgmma group.
__device__ __forceinline__ void rs_issue(float (&acc)[32], uint32_t (&pa)[16], uint64_t bd) {
  reg_fence(acc);
  reg_fence(pa);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n64k16_rs_t(acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                         bd + 128 * kk);
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

__device__ __forceinline__ void pack_probs(const float (&s)[32], uint32_t (&pa)[16]) {
#pragma unroll
  for (int x = 0; x < 16; ++x) pa[x] = pack_bf16x2(s[2 * x], s[2 * x + 1]);
}

// (d)'s sweep 2 (!DS: ao += bf16(p) v, rs += sum dP p) or 3 (DS: dq += dS
// k) over the ntk key tiles from ring step step0, as 2 ntk units of 64
// keys (unit u: tile u / 2, half u % 2).  Unit u's s and dP are issued
// before unit u - 1's register-A product, and turned into p (and rs) or dS
// in place while that product runs (mha_wgmma.cuh's pv_next pattern: pa
// is written only once no group is in flight).  A tile's stage is released
// once its second half's product is done.
template <bool DS>
__device__ __forceinline__ void bwd_sweep(float (&s)[32], float (&dp)[32], uint32_t (&pa)[16],
                                          float (&acc)[32], const MwRows& r, float (&rs)[2],
                                          int step0, int ntk, float sl2, float scale, uint64_t qd,
                                          uint64_t gd, uint32_t ring, uint32_t bars) {
  // K at ring + 2 s TILE, V after it; the register-A product's B is K
  // (dq += dS k) or V (ao += p v).
  auto k_desc = [&](int u) {
    const int st = (step0 + (u >> 1)) % MW_STAGES;
    return sw128_desc(ring + 2 * st * MW_TILE_BYTES) + (u & 1) * AB_HALF_DESC;
  };
  auto v_desc = [&](int u) { return k_desc(u) + (MW_TILE_BYTES >> 4); };
  auto wait_tile = [&](int u) {
    const int i = step0 + (u >> 1);
    if ((u & 1) == 0) mbar_wait(bars + 8 * (i % MW_STAGES), (i / MW_STAGES) & 1);
  };
#pragma unroll
  for (int x = 0; x < 32; ++x) acc[x] = 0.0f;
  const int units = 2 * ntk;
  wait_tile(0);
  pair_issue(s, dp, qd, k_desc(0), gd, v_desc(0));
  wgmma_wait<0>();
  reg_fence(s);
  reg_fence(dp);
  bwd_probs<DS>(s, dp, r, rs, sl2, scale);
  pack_probs(s, pa);
  for (int u = 1; u < units; ++u) {
    wait_tile(u);
    pair_issue(s, dp, qd, k_desc(u), gd, v_desc(u));
    rs_issue(acc, pa, DS ? k_desc(u - 1) : v_desc(u - 1));
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
  rs_issue(acc, pa, DS ? k_desc(units - 1) : v_desc(units - 1));
  wgmma_wait<0>();
  reg_fence(acc);
  reg_fence(pa);
  mbar_arrive(bars + 8 * (MW_STAGES + (step0 + ntk - 1) % MW_STAGES));
}

// One consumer thread's rows g and g + 8 of its warp's 16 (first row row0)
// of a 64 x 64 accumulator as bf16, to dst + row * ld, rows before n_pad.
__device__ __forceinline__ void store_rows(const float (&acc)[32], bf16* dst, size_t ld, int row0,
                                           int n_pad, int g, int t4) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = row0 + g + 8 * rr;
    if (row >= n_pad) continue;
    bf16* out = dst + (size_t)row * ld + 2 * t4;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * c) =
          __floats2bfloat162_rn(acc[4 * c + 2 * rr], acc[4 * c + 2 * rr + 1]);
  }
}

// (d): grid (nq_pad / 128, B * H).  tq, tk, tv: the packed qkv's q, k, v
// (rows n_pad, n_valid, n_valid); tg: gw (rows n_pad).
__global__ void __launch_bounds__(MW_THREADS, 1)
    bwd_q_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tg,
                 BwdArgs p) {
  extern __shared__ unsigned char ab_smem[];
  const uint32_t q_s = (smem_u32(ab_smem) + 1023u) & ~1023u;
  const uint32_t g_s = q_s + MW_TILE_BYTES;
  const uint32_t ring = g_s + MW_TILE_BYTES;  // stage s: K at ring + 2 s TILE, V after it
  const uint32_t bars = ring + 2 * MW_STAGES * MW_TILE_BYTES;
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
      mbar_expect_tx(qbar, 2 * MW_TILE_BYTES);
      tma_load_4d(q_s, &tq, qbar, 0, q0, h, b);
      tma_load_4d(g_s, &tg, qbar, 0, q0, h, b);
      for (int i = 0; i < 3 * ntk; ++i) {
        const int s = i % MW_STAGES, key0 = (i % ntk) * MW_KT;
        const bool kv = i >= ntk;
        mbar_wait(empty(s), ((i / MW_STAGES) & 1) ^ 1);  // round 0 passes at once
        const uint32_t ks = ring + 2 * s * MW_TILE_BYTES;
        mbar_expect_tx(full(s), kv ? 2 * MW_TILE_BYTES : MW_TILE_BYTES);
        tma_load_4d(ks, &tk, full(s), 0, key0, h, b);
        if (kv) tma_load_4d(ks + MW_TILE_BYTES, &tv, full(s), 0, key0, h, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = warp >> 2, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const uint64_t qd = sw128_desc(q_s + wg * 64 * MW_ROW_BYTES);
    const uint64_t gd = sw128_desc(g_s + wg * 64 * MW_ROW_BYTES);
    const float sl2 = p.scale_log2;
    MwRows r{{-INFINITY, -INFINITY}, {0.0f, 0.0f}};
    float rs[2] = {0.0f, 0.0f};
    mbar_wait(qbar, 0);

    {  // Sweep 1: the row max and sum over 128-key tiles, two a trip (the
       // score buffers alternate); one or two tiles are left for the tail.
      float sa[64], sb[64];
      mbar_wait(full(0), 0);
      qk_issue(sa, qd, sw128_desc(ring));
      int i = 0;
      for (; i + 2 < ntk; i += 2) {
        stats_next(sa, sb, r, i, sl2, qd, ring, bars);
        stats_next(sb, sa, r, i + 1, sl2, qd, ring, bars);
      }
      if (i + 1 < ntk) {
        stats_next(sa, sb, r, i, sl2, qd, ring, bars);
        stats_last(sb, r, i + 1, i + 1, p.n_valid, sl2, t4, bars);
      } else {
        stats_last(sa, r, i, i, p.n_valid, sl2, t4, bars);
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) r.l[rr] = 1.0f / quad_sum(r.l[rr]);

    const int lrow = wg * 64 + (warp & 3) * 16;  // this warp's first row in the tile
    const size_t base = (size_t)b * p.n_pad;
    float s[32], dp[32], acc[32];
    uint32_t pa[16];
    bwd_sweep<false>(s, dp, pa, acc, r, rs, ntk, ntk, sl2, p.scale, qd, gd, ring, bars);
    store_rows(acc, p.ao + base * p.d + h * MW_DH, p.d, q0 + lrow, p.n_pad, g, t4);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) rs[rr] = quad_sum(rs[rr]);
    bwd_sweep<true>(s, dp, pa, acc, r, rs, 2 * ntk, ntk, sl2, p.scale, qd, gd, ring, bars);
    store_rows(acc, p.dqkv + base * 3 * p.d + h * MW_DH, 3 * (size_t)p.d, q0 + lrow, p.n_pad, g,
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
__global__ void __launch_bounds__(MW_THREADS, 1)
    bwd_kv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tg,
                  BwdArgs p) {
  extern __shared__ unsigned char ab_smem[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int k0 = blockIdx.x * MW_KT;
  const size_t base = (size_t)b * p.n_pad;
  bf16* dk = p.dqkv + base * 3 * p.d + p.d + h * MW_DH;  // dv at + D
  if (k0 >= p.n_valid) {
    // every key of the tile is masked: zero gradients, rows before n_pad
    for (int c = tid; c < MW_KT * 2 * (MW_DH / 8); c += MW_THREADS) {
      const int row = k0 + c / (2 * (MW_DH / 8)), part = (c / (MW_DH / 8)) & 1;
      if (row < p.n_pad)
        *reinterpret_cast<uint4*>(dk + (size_t)row * 3 * p.d + part * p.d + 8 * (c % (MW_DH / 8))) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  const uint32_t k_s = (smem_u32(ab_smem) + 1023u) & ~1023u;
  const uint32_t v_s = k_s + MW_TILE_BYTES;
  const uint32_t ring = v_s + MW_TILE_BYTES;  // stage s: q, gw, row values at ring + s STAGE
  unsigned char* ring_g = ab_smem + (ring - smem_u32(ab_smem));
  const uint32_t bars = ring + MW_STAGES * AB_KV_STAGE;
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
      mbar_expect_tx(kvbar, 2 * MW_TILE_BYTES);
      tma_load_4d(k_s, &tk, kvbar, 0, k0, h, b);
      tma_load_4d(v_s, &tv, kvbar, 0, k0, h, b);
      const float* vals = p.vals + (size_t)blockIdx.y * nqt * 3 * MW_BQ;
      for (int j = 0; j < nqt; ++j) {
        const int s = j % MW_STAGES;
        mbar_wait(empty(s), ((j / MW_STAGES) & 1) ^ 1);
        const uint32_t st = ring + s * AB_KV_STAGE;
        mbar_expect_tx(full(s), 2 * MW_TILE_BYTES + AB_VALS_BYTES);
        tma_load_4d(st, &tq, full(s), 0, j * MW_BQ, h, b);
        tma_load_4d(st + MW_TILE_BYTES, &tg, full(s), 0, j * MW_BQ, h, b);
        bulk_load(st + 2 * MW_TILE_BYTES, vals + (size_t)j * 3 * MW_BQ, AB_VALS_BYTES, full(s));
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = warp >> 2, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const uint64_t kd = sw128_desc(k_s + wg * 64 * MW_ROW_BYTES);
    const uint64_t vd = sw128_desc(v_s + wg * 64 * MW_ROW_BYTES);
    const float sl2 = p.scale_log2, scale = p.scale;
    const int row0 = k0 + wg * 64 + (warp & 3) * 16;  // this warp's first key
    const bool valid[2] = {row0 + g < p.n_valid, row0 + g + 8 < p.n_valid};
    float s[32], dp[32], dkacc[32], dvacc[32];
    uint32_t pp[16], pd[16];
#pragma unroll
    for (int x = 0; x < 32; ++x) dkacc[x] = dvacc[x] = 0.0f;
    mbar_wait(kvbar, 0);
    for (int j = 0; j < nqt; ++j) {
      const int st = j % MW_STAGES;
      mbar_wait(full(st), (j / MW_STAGES) & 1);
      const uint64_t qd = sw128_desc(ring + st * AB_KV_STAGE);
      const uint64_t gd = qd + (MW_TILE_BYTES >> 4);
      const float* vals =
          reinterpret_cast<const float*>(ring_g + st * AB_KV_STAGE + 2 * MW_TILE_BYTES);
#pragma unroll 1
      for (int half = 0; half < 2; ++half) {  // query rows 64 half .. of the tile
        const uint64_t qh = qd + half * AB_HALF_DESC, gh = gd + half * AB_HALF_DESC;
        pair_issue(s, dp, kd, qh, vd, gh);
        wgmma_wait<0>();
        reg_fence(s);
        reg_fence(dp);
        // Element x: key row g + 8 ((x / 2) % 2), query 64 half + 8 (x / 4)
        // + 2 t4 + x % 2 of the tile, whose m2, 1 / l and rs the stage holds.
#pragma unroll
        for (int y = 0; y < 16; ++y) {
          const int x = 2 * y, c = 64 * half + 8 * (y >> 1) + 2 * t4;
          const float2 m2 = *reinterpret_cast<const float2*>(vals + c);
          const float2 li = *reinterpret_cast<const float2*>(vals + MW_BQ + c);
          const float2 rsv = *reinterpret_cast<const float2*>(vals + 2 * MW_BQ + c);
          const bool kv = valid[y & 1];
          const float p0 = kv ? ex2(fmaf(s[x], sl2, -m2.x)) * li.x : 0.0f;
          const float p1 = kv ? ex2(fmaf(s[x + 1], sl2, -m2.y)) * li.y : 0.0f;
          pp[y] = pack_bf16x2(p0, p1);
          pd[y] = pack_bf16x2((p0 * (dp[x] - rsv.x)) * scale, (p1 * (dp[x + 1] - rsv.y)) * scale);
        }
        rs_issue(dvacc, pp, gh);  // dv += bf16(p)^T gw
        rs_issue(dkacc, pd, qh);  // dk += dS^T q
        wgmma_wait<0>();
        reg_fence(dvacc);
        reg_fence(dkacc);
        reg_fence(pp);
        reg_fence(pd);
      }
      mbar_arrive(empty(st));
    }
    store_rows(dkacc, dk, 3 * (size_t)p.d, row0, p.n_pad, g, t4);
    store_rows(dvacc, dk + p.d, 3 * (size_t)p.d, row0, p.n_pad, g, t4);
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
  w.vals = take((size_t)batch * (d / MW_DH) * nq_pad_of(n_pad) * 3 * sizeof(float));
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
  if ((err = cudaFuncSetAttribute(bwd_q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)AB_Q_SMEM)) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(bwd_kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)AB_KV_SMEM)) != cudaSuccess)
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
// vft_attn_bwd_workspace bytes.  Head dim 64, 1 <= n_valid <= n_pad,
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
  if (d != heads * MW_DH || batch < 1 || n_valid < 1 || n_valid > n_pad ||
      (long long)batch * heads > MW_MAX_GRID_Y || rows % 8 || d > LNB_MAX_D)
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
  // * 64 of each, row stride 3D, image stride n_pad * 3D); gw's row stride
  // is D.
  const long long in_b = (long long)n_pad * 3 * d;
  CUtensorMap tq, tk, tv, tg;
  if (!mw_encode(&tq, qkv, in_b, MW_DH, 3 * d, n_pad, heads, batch) ||
      !mw_encode(&tk, qkv + d, in_b, MW_DH, 3 * d, n_valid, heads, batch) ||
      !mw_encode(&tv, qkv + 2 * d, in_b, MW_DH, 3 * d, n_valid, heads, batch) ||
      !mw_encode(&tg, gw, (long long)n_pad * d, MW_DH, d, n_pad, heads, batch))
    return cudaErrorInvalidValue;
  const int nq_pad = nq_pad_of(n_pad);
  const BwdArgs a{ao,    dqkv,    reinterpret_cast<float*>(ws + w.vals), heads, n_pad, n_valid,
                  nq_pad, d,     scale * 1.4426950408889634f, scale};
  const dim3 grid(nq_pad / MW_BQ, batch * heads);
  bwd_q_kernel<<<grid, MW_THREADS, AB_Q_SMEM, st>>>(tq, tk, tv, tg, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_kv_kernel<<<grid, MW_THREADS, AB_KV_SMEM, st>>>(tq, tk, tv, tg, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
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
