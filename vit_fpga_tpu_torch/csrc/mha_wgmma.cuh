// Whole-sequence attention in bf16 on Hopper's own units, head dim 64;
// include after common.cuh and hopper.cuh.  Three modes of one kernel:
//   exact     (MW_EXACT; mha.cu K7 / K8) p = bf16(e / sum e) against the
//             row's true max, two passes over the keys;
//   max-free  (MW_MAXFREE; attn_half.cuh, K1's attention step and K4's
//             without safe_softmax) the TPU stats-chain kernels'
//             exp(clip(s * scale, -70, 80)), one pass;
//   safe      (MW_SAFE; K4 with safe_softmax) e = exp(s * scale - max),
//             rounded to bf16 unnormalised: the exact mode's pass 1 (the
//             row max alone), then the max-free mode's pass.
//
// One block per (MW_BQ query rows, image x head): MW_CONSUMERS warpgroups of
// 64 query rows each and a producer warpgroup, of which one thread issues
// TMA loads into a ring of MW_STAGES shared-memory stages, each stage one
// full and one empty mbarrier: the K tiles of pass 1, then the (K, V) tile
// pairs of pass 2 (max-free: the pairs only), MW_KT keys a tile, only the
// tiles before n_valid.  The producer gives its registers up (setmaxnreg
// 24) to the consumers (240): each of the SM's four register files holds
// one warp of each warpgroup, 2 x 240 + 24 = 504 of its 512 registers a
// lane.  The tensor maps (built on the host by cuTensorMapEncodeTiled) are
// 4-D, {64, rows, heads, batch} with the operands' own strides, so the
// packed (B, N, 3D) qkv tensor and (B, H, N, 64) read alike; K's and V's
// row extent is n_valid, so TMA zero-fills the keys past it, and Q's is n.
// Rows are 128 bytes and land 128-byte swizzled, the layout wgmma reads.
//
// Each consumer warpgroup, for its 64 rows, in the exact mode:
//   pass 1  s = q k^T by wgmma.m64n128k16 (A = Q and B = the K tile, both
//           K-major in shared memory; f32 in registers), keys >= n_valid
//           set to -inf in the last tile only; in the log2 domain s2 =
//           s * (scale log2 e), the running row max m2 and sum l = l
//           ex2(m2_old - m2) + sum ex2(s2 - m2), each exponent one fma.
//           Tile i + 1's q k^T is issued before tile i's statistics, so
//           the tensor cores and the exponentials overlap.
//   pass 2  s again (the same wgmma sequence, so the same bits), p =
//           bf16(ex2(s2 - m2) * (1 / l)), packed from the f32 accumulator
//           fragment straight into wgmma's register-A fragment, and o +=
//           p v by wgmma.m64n64k16 (B = the V tile, dh contiguous, through
//           the transpose bit); tile j + 1's q k^T and exponentials are
//           formed while tile j's p v runs.  o = bf16(o), stored by the
//           out strides; rows >= n are not written.
// The probabilities are normalised before they are rounded, as the TPU
// kernels' p = dtype(e / sum e) are; a one-pass online softmax would round
// them against a partial max (K9's function, not this one).
//
// In the max-free mode each key's e = exp(clip(s * scale, -70, 80)) needs
// no row max, so pass 2 alone runs: e = ex2(clip(s * scale, -70, 80) *
// log2 e), 0 for keys >= n_valid (set explicitly in the last tile: TMA's
// zero-filled keys give s = 0, e = 1), l += e in f32, p = bf16(e)
// unnormalised, o += p v, and at the end ao = bf16(o * (1 / l)): the
// function of attn.cuh's attn_kernel<false>.  ex2.approx and the rounding
// of the exponent's product with log2 e put e within ~5e-6 relative of
// expf's (at the clip's top), well inside a bf16 ulp (2^-8), so p's bf16
// rounding flips on rare elements only.
//
// The safe mode is the function of the TPU per-block kernel
// (attn_block.py:_mha_loop with safe_softmax): e = exp(s - max) rounded to
// bf16 before the sum over keys is known, ao = bf16((bf16(e) v) / sum e).
// Normalising first (the exact mode) rounds other values.  So pass 1 runs
// the exact mode's q k^T tiles and keeps only the row max m2 (no
// exponentials), and pass 2 is the max-free pass with e = ex2(s2 - m2):
// s is recomputed by the same wgmma sequence, so the max is the max of the
// same bits, every e <= 1 and the row's largest is 1.  The second q k^T
// costs a quarter of the attention's products.

#pragma once

namespace VFT_NS {

enum MwMode { MW_EXACT = 0, MW_MAXFREE = 1, MW_SAFE = 2 };

constexpr int MW_DH = 64;                       // head dim: one 128-byte row
constexpr int MW_CONSUMERS = 2;                 // warpgroups of 64 query rows
constexpr int MW_BQ = 64 * MW_CONSUMERS;        // query rows per block
constexpr int MW_KT = 128;                      // keys per tile
constexpr int MW_STAGES = 4;                    // ring depth
constexpr int MW_THREADS = 128 * (MW_CONSUMERS + 1);
constexpr uint32_t MW_ROW_BYTES = MW_DH * 2;
constexpr uint32_t MW_TILE_BYTES = MW_KT * MW_ROW_BYTES;  // one K or V tile
constexpr uint32_t MW_Q_BYTES = MW_BQ * MW_ROW_BYTES;
// 1024 bytes of slack to align the tiles to the 128-byte swizzle's 1 KB
// period, Q, the stages (K then V), then the barriers.
constexpr size_t MW_SMEM_BYTES =
    1024 + MW_Q_BYTES + 2 * MW_STAGES * MW_TILE_BYTES + 8 * (2 * MW_STAGES + 1);

struct MhaTmaArgs {
  void* o;
  long long out_b, out_h;  // element strides of o: image, head
  int out_r;               // and token row
  int heads, n, n_valid;   // n query rows and keys; keys >= n_valid masked
  float scale_log2;        // softmax scale * log2(e) (exact and safe modes)
  float scale;             // softmax scale (max-free mode)
};

// Issues s = q k^T for the 64 x MW_KT tile as one wgmma group: 4 k steps of
// 16 over dh, each 32 bytes further along the swizzled rows.
__device__ __forceinline__ void qk_issue(float (&s)[64], uint64_t qd, uint64_t kd) {
  reg_fence(s);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < MW_DH / 16; ++k) wgmma_m64n128k16_ss(s, qd + 2 * k, kd + 2 * k, k);
  wgmma_commit();
}

// Issues o += p v for the tile as one wgmma group: 8 k steps of 16 keys,
// each 2 KB further into the V tile (vd + 128 in the descriptor's units).
__device__ __forceinline__ void pv_issue(float (&o)[32], uint32_t (&pa)[32], uint64_t vd) {
  reg_fence(o);
  reg_fence(pa);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < MW_KT / 16; ++kk)
    wgmma_m64n64k16_rs_t(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                         vd + 128 * kk);
  wgmma_commit();
}

// Score x of a thread, or -inf for a key at or past n_valid in the last
// tile (the mask is applied as the scores are read).  Accumulator element x
// sits at row g + 8 ((x / 2) % 2), column 8 (x / 4) + 2 t4 + x % 2; key0 is
// the thread's first key.
template <bool LAST>
__device__ __forceinline__ float score(const float (&s)[64], int x, int key0, int n_valid) {
  if (!LAST) return s[x];
  return key0 + 8 * (x >> 2) + (x & 1) >= n_valid ? -INFINITY : s[x];
}

// The consumer's running state for its rows g and g + 8.
struct MwRows {
  float m2[2];  // row max of s * (scale log2 e)
  float l[2];   // this thread's share of sum ex2(s2 - m2); then 1 / the row's sum
};

// Folds a finished q k^T tile into the running max and (SUM) sum.
template <bool LAST, bool SUM = true>
__device__ __forceinline__ void fold(const float (&s)[64], MwRows& r, int key0, int n_valid,
                                     float sl2) {
  float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int x = 0; x < 64; ++x)
    tmax[(x >> 1) & 1] = fmaxf(tmax[(x >> 1) & 1], score<LAST>(s, x, key0, n_valid));
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float mn = fmaxf(r.m2[rr], quad_max(tmax[rr]) * sl2);
    if (!SUM) {
      r.m2[rr] = mn;
      continue;
    }
    float part = 0.0f;
#pragma unroll
    for (int x = 0; x < 32; ++x)
      part += ex2(fmaf(score<LAST>(s, (x >> 1) * 4 + 2 * rr + (x & 1), key0, n_valid), sl2, -mn));
    r.l[rr] = r.l[rr] * ex2(r.m2[rr] - mn) + part;
    r.m2[rr] = mn;
  }
}

// The issue and wait pattern of both passes is fixed in each loop body
// (prologue and last tile peeled), so that ptxas can see which wgmma group
// a register belongs to and does not serialise the groups.

// Pass 1, tile i (not the last), whose q k^T is in flight into s: waits for
// tile i + 1's K and issues its q k^T into nxt, then folds tile i into the
// running max and (SUM) sum while that runs on the tensor cores.
template <bool SUM = true>
__device__ __forceinline__ void stats_next(float (&s)[64], float (&nxt)[64], MwRows& r, int i,
                                           float sl2, uint64_t qd, uint32_t ring,
                                           uint32_t bars) {
  const int sn = (i + 1) % MW_STAGES;
  mbar_wait(bars + 8 * sn, ((i + 1) / MW_STAGES) & 1);
  qk_issue(nxt, qd, sw128_desc(ring + 2 * sn * MW_TILE_BYTES));
  wgmma_wait<1>();
  reg_fence(s);
  mbar_arrive(bars + 8 * (MW_STAGES + i % MW_STAGES));
  fold<false, SUM>(s, r, 0, 0, sl2);
}

// Pass 1's last tile i, in flight into s.
template <bool SUM = true>
__device__ __forceinline__ void stats_last(float (&s)[64], MwRows& r, int i, int n_valid,
                                           float sl2, int t4, uint32_t bars) {
  wgmma_wait<0>();
  reg_fence(s);
  mbar_arrive(bars + 8 * (MW_STAGES + i % MW_STAGES));
  fold<true, SUM>(s, r, i * MW_KT + 2 * t4, n_valid, sl2);
}

// p = bf16(ex2(s2 - m2) * (1 / l)) of a finished q k^T tile, packed into
// wgmma's register-A fragment: k step kk (keys 16 kk..) in pa[4 kk .. 4 kk
// + 3], each the bf16 pair of accumulator elements 2 x, 2 x + 1.
template <bool LAST>
__device__ __forceinline__ void probs(const float (&s)[64], uint32_t (&pa)[32], const MwRows& r,
                                      int key0, int n_valid, float sl2) {
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    const int rr = x & 1;
    pa[x] = pack_bf16x2(ex2(fmaf(score<LAST>(s, 2 * x, key0, n_valid), sl2, -r.m2[rr])) * r.l[rr],
                        ex2(fmaf(score<LAST>(s, 2 * x + 1, key0, n_valid), sl2, -r.m2[rr])) *
                            r.l[rr]);
  }
}

// Pass 2, tile j >= 1, with tile j - 1's p in pa: waits for tile j's stage,
// issues its q k^T into s and then tile j - 1's o += p v; while p v runs,
// turns s into tile j's probabilities in place (f32), then releases tile
// j - 1's stage and packs them into pa.  Only the retired q k^T group's
// registers are written while p v is in flight: writing pa (or any
// register the compiler later hands to a wgmma as its A operand) there
// makes ptxas serialise every wgmma of the kernel.
template <bool LAST>
__device__ __forceinline__ void pv_next(float (&s)[64], uint32_t (&pa)[32], float (&o)[32],
                                        const MwRows& r, int j, int ntiles, int n_valid,
                                        float sl2, int t4, uint64_t qd, uint32_t ring,
                                        uint32_t bars) {
  const int i = ntiles + j, st = i % MW_STAGES, sp = (i - 1) % MW_STAGES;
  mbar_wait(bars + 8 * st, (i / MW_STAGES) & 1);
  qk_issue(s, qd, sw128_desc(ring + 2 * st * MW_TILE_BYTES));
  pv_issue(o, pa, sw128_desc(ring + (2 * sp + 1) * MW_TILE_BYTES));
  wgmma_wait<1>();  // q k^T (the older group) is done
  reg_fence(s);
  const int key0 = j * MW_KT + 2 * t4;
#pragma unroll
  for (int x = 0; x < 64; ++x) {
    const int rr = (x >> 1) & 1;
    s[x] = ex2(fmaf(score<LAST>(s, x, key0, n_valid), sl2, -r.m2[rr])) * r.l[rr];
  }
  wgmma_wait<0>();
  reg_fence(o);
  reg_fence(pa);
  mbar_arrive(bars + 8 * (MW_STAGES + sp));
#pragma unroll
  for (int x = 0; x < 32; ++x) pa[x] = pack_bf16x2(s[2 * x], s[2 * x + 1]);
}

// The unnormalised e of a thread's score x, in the log2 domain: max-free
// exp(clip(s * scale, -70, 80)) (c = scale), or safe exp(s * scale - max)
// = ex2(s c - m2[row]) (c = scale log2 e); 0 for a key at or past n_valid
// in the last tile (TMA's zero-filled keys would give s = 0).
template <int MODE, bool LAST>
__device__ __forceinline__ float mf_exp(const float (&s)[64], int x, int key0, int n_valid,
                                        float c, const float (&m2)[2]) {
  const float e = MODE == MW_SAFE
                      ? ex2(fmaf(s[x], c, -m2[(x >> 1) & 1]))
                      : ex2(fminf(fmaxf(s[x] * c, -70.0f), 80.0f) * 1.4426950408889634f);
  if (!LAST) return e;
  return key0 + 8 * (x >> 2) + (x & 1) >= n_valid ? 0.0f : e;
}

// One-pass modes, the pass's tile 0 (finished q k^T in s): p = bf16(e),
// unnormalised, into wgmma's register-A fragment; l += e.
template <int MODE, bool LAST>
__device__ __forceinline__ void mf_probs(const float (&s)[64], uint32_t (&pa)[32], float (&l)[2],
                                         int key0, int n_valid, float scale,
                                         const float (&m2)[2]) {
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    const float e0 = mf_exp<MODE, LAST>(s, 2 * x, key0, n_valid, scale, m2);
    const float e1 = mf_exp<MODE, LAST>(s, 2 * x + 1, key0, n_valid, scale, m2);
    l[x & 1] += e0;
    l[x & 1] += e1;
    pa[x] = pack_bf16x2(e0, e1);
  }
}

// One-pass modes, tile j >= 1 of the pass that starts at ring step step0
// (max-free 0, safe ntiles), with tile j - 1's p in pa: pv_next's issue and
// wait pattern, e and l in place of the normalised probabilities.
template <int MODE, bool LAST>
__device__ __forceinline__ void mf_next(float (&s)[64], uint32_t (&pa)[32], float (&o)[32],
                                        float (&l)[2], int j, int step0, int n_valid, float scale,
                                        const float (&m2)[2], int t4, uint64_t qd, uint32_t ring,
                                        uint32_t bars) {
  const int i = step0 + j, st = i % MW_STAGES, sp = (i - 1) % MW_STAGES;
  mbar_wait(bars + 8 * st, (i / MW_STAGES) & 1);
  qk_issue(s, qd, sw128_desc(ring + 2 * st * MW_TILE_BYTES));
  pv_issue(o, pa, sw128_desc(ring + (2 * sp + 1) * MW_TILE_BYTES));
  wgmma_wait<1>();  // q k^T (the older group) is done
  reg_fence(s);
  const int key0 = j * MW_KT + 2 * t4;
#pragma unroll
  for (int x = 0; x < 64; ++x) {
    s[x] = mf_exp<MODE, LAST>(s, x, key0, n_valid, scale, m2);
    l[(x >> 1) & 1] += s[x];
  }
  wgmma_wait<0>();
  reg_fence(o);
  reg_fence(pa);
  mbar_arrive(bars + 8 * (MW_STAGES + sp));
#pragma unroll
  for (int x = 0; x < 32; ++x) pa[x] = pack_bf16x2(s[2 * x], s[2 * x + 1]);
}

template <int MODE>
__global__ void __launch_bounds__(MW_THREADS, 1)
    mha_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, MhaTmaArgs p) {
  extern __shared__ unsigned char mw_smem[];
  const uint32_t q_s = (smem_u32(mw_smem) + 1023u) & ~1023u;
  const uint32_t ring = q_s + MW_Q_BYTES;  // stage s: K at ring + 2 s TILE, V after it
  const uint32_t bars = ring + 2 * MW_STAGES * MW_TILE_BYTES;
  const uint32_t qbar = bars + 16 * MW_STAGES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (MW_STAGES + s); };
  const int tid = threadIdx.x, warp = tid >> 5;
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int q0 = blockIdx.x * MW_BQ;
  const int ntiles = (p.n_valid + MW_KT - 1) / MW_KT;
  const int steps = MODE == MW_MAXFREE ? ntiles : 2 * ntiles;

  if (tid == 0) {
    for (int s = 0; s < MW_STAGES; ++s) {
      mbar_init(full(s), 1);                     // the producer's expect_tx
      mbar_init(empty(s), 128 * MW_CONSUMERS);   // every consumer thread
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * MW_CONSUMERS) {
    // Producer: Q once, then ring step i = tile i of pass 1 (K) for i <
    // ntiles, tile i - ntiles of pass 2 (K and V) after (max-free: tile i,
    // K and V); step i uses stage i % MW_STAGES in round i / MW_STAGES.
    constexpr bool MAXFREE = MODE == MW_MAXFREE;
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 128 * MW_CONSUMERS) {
      mbar_expect_tx(qbar, MW_Q_BYTES);
      tma_load_4d(q_s, &tq, qbar, 0, q0, h, b);
      for (int i = 0; i < steps; ++i) {
        const int s = i % MW_STAGES;
        const bool pv = MAXFREE || i >= ntiles;
        const int key0 = (MAXFREE ? i : pv ? i - ntiles : i) * MW_KT;
        mbar_wait(empty(s), ((i / MW_STAGES) & 1) ^ 1);  // round 0 passes at once
        const uint32_t ks = ring + 2 * s * MW_TILE_BYTES;
        mbar_expect_tx(full(s), pv ? 2 * MW_TILE_BYTES : MW_TILE_BYTES);
        tma_load_4d(ks, &tk, full(s), 0, key0, h, b);
        if (pv) tma_load_4d(ks + MW_TILE_BYTES, &tv, full(s), 0, key0, h, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = warp >> 2, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const uint64_t qd = sw128_desc(q_s + wg * 64 * MW_ROW_BYTES);
    float sa[64], o[32];
    uint32_t pa[32];
    float ol[2] = {1.0f, 1.0f};  // the output's row factor: one-pass 1 / l
    mbar_wait(qbar, 0);
    if constexpr (MODE != MW_EXACT) {
      // Safe: pass 1 takes the row max m2 alone, over the exact mode's q k^T
      // tiles, two a trip (the score buffers alternate).
      MwRows r{{-INFINITY, -INFINITY}, {0.0f, 0.0f}};
      if constexpr (MODE == MW_SAFE) {
        const float sl2 = p.scale_log2;
        float sb[64];
        mbar_wait(full(0), 0);
        qk_issue(sa, qd, sw128_desc(ring));
        int i = 0;
        for (; i + 2 < ntiles; i += 2) {
          stats_next<false>(sa, sb, r, i, sl2, qd, ring, bars);
          stats_next<false>(sb, sa, r, i + 1, sl2, qd, ring, bars);
        }
        if (i + 1 < ntiles) {
          stats_next<false>(sa, sb, r, i, sl2, qd, ring, bars);
          stats_last<false>(sb, r, i + 1, p.n_valid, sl2, t4, bars);
        } else {
          stats_last<false>(sa, r, i, p.n_valid, sl2, t4, bars);
        }
      }
      // One pass from ring step step0: tile 0's p first, then per tile j
      // its q k^T beside tile j - 1's p v, then the last p v.
      const int step0 = MODE == MW_SAFE ? ntiles : 0;
      const float sc = MODE == MW_SAFE ? p.scale_log2 : p.scale;
      float l[2] = {0.0f, 0.0f};
#pragma unroll
      for (int x = 0; x < 32; ++x) o[x] = 0.0f;
      const int s0 = step0 % MW_STAGES;
      mbar_wait(full(s0), (step0 / MW_STAGES) & 1);
      qk_issue(sa, qd, sw128_desc(ring + 2 * s0 * MW_TILE_BYTES));
      wgmma_wait<0>();
      reg_fence(sa);
      if (ntiles == 1)
        mf_probs<MODE, true>(sa, pa, l, 2 * t4, p.n_valid, sc, r.m2);
      else
        mf_probs<MODE, false>(sa, pa, l, 0, 0, sc, r.m2);
      for (int j = 1; j < ntiles - 1; ++j)
        mf_next<MODE, false>(sa, pa, o, l, j, step0, p.n_valid, sc, r.m2, t4, qd, ring, bars);
      if (ntiles > 1)
        mf_next<MODE, true>(sa, pa, o, l, ntiles - 1, step0, p.n_valid, sc, r.m2, t4, qd, ring,
                            bars);
      const int sl = (step0 + ntiles - 1) % MW_STAGES;
      pv_issue(o, pa, sw128_desc(ring + (2 * sl + 1) * MW_TILE_BYTES));
      wgmma_wait<0>();
      reg_fence(o);
      reg_fence(pa);
      mbar_arrive(empty(sl));
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) ol[rr] = 1.0f / quad_sum(l[rr]);
    } else {
      const float sl2 = p.scale_log2;
      MwRows r{{-INFINITY, -INFINITY}, {0.0f, 0.0f}};
      float sb[64];

      // Pass 1: the row max and sum, two tiles a trip (the score buffers
      // alternate); one or two tiles are left for the tail.
      mbar_wait(full(0), 0);
      qk_issue(sa, qd, sw128_desc(ring));
      int i = 0;
      for (; i + 2 < ntiles; i += 2) {
        stats_next(sa, sb, r, i, sl2, qd, ring, bars);
        stats_next(sb, sa, r, i + 1, sl2, qd, ring, bars);
      }
      if (i + 1 < ntiles) {
        stats_next(sa, sb, r, i, sl2, qd, ring, bars);
        stats_last(sb, r, i + 1, p.n_valid, sl2, t4, bars);
      } else {
        stats_last(sa, r, i, p.n_valid, sl2, t4, bars);
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) r.l[rr] = 1.0f / quad_sum(r.l[rr]);

      // Pass 2: p = bf16(e / l), o += p v.  Tile 0's p first, then per tile
      // j its q k^T beside tile j - 1's p v, then the last p v.
#pragma unroll
      for (int x = 0; x < 32; ++x) o[x] = 0.0f;
      const int s0 = ntiles % MW_STAGES;
      mbar_wait(full(s0), (ntiles / MW_STAGES) & 1);
      qk_issue(sa, qd, sw128_desc(ring + 2 * s0 * MW_TILE_BYTES));
      wgmma_wait<0>();
      reg_fence(sa);
      if (ntiles == 1)
        probs<true>(sa, pa, r, 2 * t4, p.n_valid, sl2);
      else
        probs<false>(sa, pa, r, 0, 0, sl2);
      for (int j = 1; j < ntiles - 1; ++j)
        pv_next<false>(sa, pa, o, r, j, ntiles, p.n_valid, sl2, t4, qd, ring, bars);
      if (ntiles > 1)
        pv_next<true>(sa, pa, o, r, ntiles - 1, ntiles, p.n_valid, sl2, t4, qd, ring, bars);
      const int sl = (2 * ntiles - 1) % MW_STAGES;
      pv_issue(o, pa, sw128_desc(ring + (2 * sl + 1) * MW_TILE_BYTES));
      wgmma_wait<0>();
      reg_fence(o);
      reg_fence(pa);
      mbar_arrive(empty(sl));
    }

    bf16* og = static_cast<bf16*>(p.o) + (size_t)b * p.out_b + (size_t)h * p.out_h;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = q0 + wg * 64 + (warp & 3) * 16 + g + 8 * rr;
      if (row >= p.n) continue;
      bf16* orow = og + (size_t)row * p.out_r + 2 * t4;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c) =
            __floats2bfloat162_rn(o[4 * c + 2 * rr] * ol[rr], o[4 * c + 2 * rr + 1] * ol[rr]);
    }
  }
}

template <int MODE>
inline cudaError_t mha_wgmma_enable() {
  return cudaFuncSetAttribute(mha_wgmma_kernel<MODE>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MW_SMEM_BYTES);
}

template <int MODE>
inline cudaError_t launch_mha_wgmma(const CUtensorMap& tq, const CUtensorMap& tk,
                                    const CUtensorMap& tv, const MhaTmaArgs& p, int batch,
                                    cudaStream_t stream) {
  if (p.n < 1 || p.n_valid < 1 || p.n_valid > p.n) return cudaErrorInvalidValue;
  const dim3 grid((p.n + MW_BQ - 1) / MW_BQ, batch * p.heads);
  mha_wgmma_kernel<MODE><<<grid, MW_THREADS, MW_SMEM_BYTES, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

// The 4-D map {64, rows, heads, batch} of a bf16 operand with element
// strides in_r, in_h, in_b; boxes of one 64 x MW_KT tile (= MW_BQ rows of
// Q), 128-byte swizzled, zero past `rows`.
inline bool mw_encode(CUtensorMap* map, const void* base, long long in_b, long long in_h,
                      int in_r, int rows, int heads, int batch) {
  static_assert(MW_KT == MW_BQ, "one box shape serves Q, K and V");
  // A dimension of extent 1 is never stepped; give it a legal stride.
  auto stride = [](long long st, int extent) {
    return (cuuint64_t)(extent == 1 ? 16 : st * 2);
  };
  const cuuint64_t dims[4] = {(cuuint64_t)MW_DH, (cuuint64_t)rows, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {stride(in_r, rows), stride(in_h, heads), stride(in_b, batch)};
  const cuuint32_t box[4] = {(cuuint32_t)MW_DH, (cuuint32_t)MW_KT, 1, 1};
  return tma_encode_bf16(map, base, 4, dims, strides, box);
}

}  // namespace VFT_NS
