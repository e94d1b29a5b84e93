// Whole-sequence attention in bf16 on Hopper's own units, head dim 64 (all
// four modes) or 80 (the max-free and safe modes); include after common.cuh
// and hopper.cuh.  Four modes of one kernel:
//   exact     (MW_EXACT; mha.cu K7 / K8) p = bf16(e / sum e) against the
//             row's true max, two passes over the keys;
//   max-free  (MW_MAXFREE; attn_half.cuh, K1's attention step and K4's
//             without safe_softmax) the TPU stats-chain kernels'
//             exp(clip(s * scale, -70, 80)), one pass;
//   safe      (MW_SAFE; K4 with safe_softmax) e = exp(s * scale - max),
//             rounded to bf16 unnormalised: the exact mode's pass 1 (the
//             row max alone), then the max-free mode's pass.
//   online    (MW_ONLINE; flash_attn.cu K9) the blockwise online softmax
//             of the TPU flash kernel, p rounded to bf16 against the
//             running max of each key block of bk keys.
//
// One block per (MW_BQ query rows, image x head): MW_CONSUMERS warpgroups of
// 64 query rows each and a producer warpgroup, of which one thread issues
// TMA loads into a ring of MW_STAGES shared-memory stages, each stage one
// full and one empty mbarrier: the K tiles of pass 1, then the (K, V) tile
// pairs of pass 2 (max-free and online at bk = MW_KT: the pairs only;
// online at a longer bk: per key block its K tiles, then its pairs), MW_KT
// keys a tile, only the tiles before n_valid.  The producer gives its registers up (setmaxnreg
// 24) to the consumers (240): each of the SM's four register files holds
// one warp of each warpgroup, 2 x 240 + 24 = 504 of its 512 registers a
// lane.  The tensor maps (built on the host by cuTensorMapEncodeTiled) are
// 4-D, {64, rows, heads, batch} with the operands' own strides, so the
// packed (B, N, 3D) qkv tensor and (B, H, N, 64) read alike; K's and V's
// row extent is n_valid, so TMA zero-fills the keys past it, and Q's is n.
// Rows are 128 bytes and land 128-byte swizzled, the layout wgmma reads.
//
// Head dim 80 (DH, a template parameter; ViT-H/14's 1280 / 16): a row is
// 160 bytes, wider than the 128-byte swizzle atom, so each Q, K and V tile
// lands as two boxes from two maps over the same operand: columns 0..63 as
// above, then columns 64..79, 32-byte rows 32-byte swizzled (MwDim's
// BOX0 bytes further).  q k^T takes the first box's 4 k16 steps and the
// second box's one; p v runs m64n64k16 on the first box and m64n16k16 on
// the second, whose accumulator continues o's fragment (o[32..39]: columns
// 64..79), so the store is the same loop over DH / 8 column groups.  No
// column of zeros is read or multiplied.
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
// them against a partial max (K9's function, the online mode below).
//
// In the max-free mode each key's e = exp(clip(s * scale, -70, 80)) needs
// no row max, so pass 2 alone runs: e = ex2(clip(s * scale, -70, 80) *
// log2 e), 0 for keys >= n_valid (set explicitly in the last tile: TMA's
// zero-filled keys give s = 0, e = 1), l += e in f32, p = bf16(e)
// unnormalised, o += p v, and at the end ao = bf16(o * (1 / l)): the
// function of the TPU stats-chain kernels' max-free _mha_loop.  ex2.approx
// and the rounding of the exponent's product with log2 e put e within
// ~5e-6 relative of expf's (at the clip's top), well inside a bf16 ulp
// (2^-8), so p's bf16 rounding flips on rare elements only.
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
//
// The online mode is the function of the TPU flash kernel
// (flash_attention.py:_flash_kernel): per key block of bk keys (a multiple
// of MW_KT; the blocks are part of the function), m_new = max(m, max_block
// s), alpha = exp(m - m_new), p = exp(s - m_new) in f32, l = l alpha + sum
// p over the f32 p, acc = acc alpha + bf16(p) v, and o = bf16(acc / l) at
// the end.  All of it in the log2 domain (s2 = s * scale log2 e, p =
// ex2(s2 - m2), alpha = ex2(m2_old - m2_new), within a few f32 ulps of exp,
// so bf16(p) flips on rare elements only, as in the max-free mode).  At bk
// = MW_KT (the per-block path's) a key tile is a block and one sweep runs:
// per tile its q k^T (issued beside the previous tile's p v), the tile's
// row max, m2 and alpha, p in place, l = l alpha + sum p; once the previous
// p v is done, o *= alpha in registers and bf16(p) goes into the register-A
// fragment of the tile's p v: two products a tile where the exact mode
// runs three.  At bk > MW_KT each block first takes its max by the safe
// mode's pass 1 confined to its tiles (starting from the running max), then
// rescales o and l by alpha once and runs the safe mode's pass over its
// tiles with e = ex2(s2 - m2_new); the producer streams the block's K
// tiles, then its (K, V) pairs.  Blocks wholly past n_valid are never
// visited: on the TPU they leave m, l and acc unchanged.
//
// The output is bf16 o * (1 / l), or with Q8 (the max-free mode of the
// static int8 attention half, attn_int8_static.cu K18) int8 aoq =
// clip(rint(bf16(o * ((1 / l) * out_scale))), -127, 127): the static scale
// rides the reciprocal and ao is rounded to bf16 in the quant domain, as
// the TPU kernel's bf16 scratch rounds it (stack_wgmma.cuh's LQ_STATIC
// attention epilogue, in the same order).  Q8 changes the store alone.

#pragma once

namespace VFT_NS {

enum MwMode { MW_EXACT = 0, MW_MAXFREE = 1, MW_SAFE = 2, MW_ONLINE = 3 };

constexpr int MW_DH = 64;                       // head dim of the exact and online modes
constexpr int MW_CONSUMERS = 2;                 // warpgroups of 64 query rows
constexpr int MW_BQ = 64 * MW_CONSUMERS;        // query rows per block
constexpr int MW_KT = 128;                      // keys per tile
constexpr int MW_STAGES = 4;                    // ring depth
constexpr int MW_THREADS = 128 * (MW_CONSUMERS + 1);
// One block row a (image, head): the grid's y extent bounds batch x heads.
// The keys stream through the ring, so no other size bounds n or n_valid.
constexpr int MW_MAX_GRID_Y = 65535;
constexpr uint32_t MW_ROW_BYTES = MW_DH * 2;
constexpr uint32_t MW_TILE_BYTES = MW_KT * MW_ROW_BYTES;  // one K or V tile
constexpr uint32_t MW_Q_BYTES = MW_BQ * MW_ROW_BYTES;
// 1024 bytes of slack to align the tiles to the 128-byte swizzle's 1 KB
// period, Q, the stages (K then V), then the barriers.
constexpr size_t MW_SMEM_BYTES =
    1024 + MW_Q_BYTES + 2 * MW_STAGES * MW_TILE_BYTES + 8 * (2 * MW_STAGES + 1);

// A head dim's tiles: the 64-column box (128-byte rows, 128-byte swizzled)
// and, at DH 80, the 16-column box after it (32-byte rows, 32-byte
// swizzled).  Q (MW_BQ rows) and a K or V tile (MW_KT rows) are alike.
template <int DH>
struct MwDim {
  static_assert(DH == 64 || DH == 80, "head dim 64 or 80");
  static constexpr int C1 = DH - 64;                            // second box's columns
  static constexpr uint32_t BOX0 = MW_KT * MW_ROW_BYTES;
  static constexpr uint32_t TILE = BOX0 + MW_KT * C1 * 2;       // one Q, K or V tile
  static constexpr size_t SMEM = 1024 + TILE + 2 * MW_STAGES * TILE + 8 * (2 * MW_STAGES + 1);
};
static_assert(MwDim<64>::TILE == MW_TILE_BYTES && MW_KT == MW_BQ, "one tile shape");

// The wgmma descriptors of an operand's rows: d0 its 64-column box
// (128-byte swizzled), d1 its 16-column box (32-byte swizzled; DH 80 only).
struct MwDesc {
  uint64_t d0, d1;
  __device__ __forceinline__ MwDesc(uint64_t a, uint64_t b = 0) : d0(a), d1(b) {}
};

// The descriptors of a tile at t (its first box; the second BOX0 bytes
// on), from row `row` on.
template <int DH>
__device__ __forceinline__ MwDesc mw_tile(uint32_t t, int row = 0) {
  return MwDesc(sw128_desc(t + row * MW_ROW_BYTES),
                sw32_desc(t + MwDim<DH>::BOX0 + row * MwDim<DH>::C1 * 2));
}

// d moved down `rows` rows (a multiple of 8), in the descriptors' 16-byte
// units.
template <int DH>
__device__ __forceinline__ MwDesc mw_rows(MwDesc d, int rows) {
  return MwDesc(d.d0 + rows * (MW_ROW_BYTES >> 4), d.d1 + rows * (MwDim<DH>::C1 * 2 >> 4));
}

// Stage st of a ring of (K, V) tile pairs at `ring`: K's and V's descriptors.
template <int DH>
__device__ __forceinline__ MwDesc mw_k(uint32_t ring, int st) {
  return mw_tile<DH>(ring + 2 * st * MwDim<DH>::TILE);
}
template <int DH>
__device__ __forceinline__ MwDesc mw_v(uint32_t ring, int st) {
  return mw_tile<DH>(ring + (2 * st + 1) * MwDim<DH>::TILE);
}

// The maps of Q, K and V, box by box: q, k, v ({64, rows, heads, batch}),
// and at DH 80 q1, k1, v1 over columns 64..79 (unset and unread at 64).
struct MwMaps {
  CUtensorMap q, k, v, q1, k1, v1;
};

// Loads one tile of `rows` rows from row r0 (image b, head h) into t: its
// boxes from m and (DH 80) m1, completing `bar`'s transaction bytes.
template <int DH>
__device__ __forceinline__ void mw_load(uint32_t t, const CUtensorMap* m, const CUtensorMap* m1,
                                        uint32_t bar, int r0, int h, int b) {
  tma_load_4d(t, m, bar, 0, r0, h, b);
  if constexpr (DH == 80) tma_load_4d(t + MwDim<DH>::BOX0, m1, bar, 0, r0, h, b);
}

struct MhaTmaArgs {
  void* o;                 // bf16, or int8 with Q8
  long long out_b, out_h;  // element strides of o: image, head
  int out_r;               // and token row
  int heads, n, n_valid;   // n query rows and keys; keys >= n_valid masked
  float scale_log2;        // softmax scale * log2(e) (exact, safe and online modes)
  float scale;             // softmax scale (max-free mode)
  int bk;                  // key block, a multiple of MW_KT (online mode)
  float out_scale;         // Q8: the static output scale 1/a_ao
};

// Issues s = q k^T for the 64 x MW_KT tile as one wgmma group: 4 k steps of
// 16 over the first box, each 32 bytes further along the swizzled rows,
// and at DH 80 the second box's one.
template <int DH = 64>
__device__ __forceinline__ void qk_issue(float (&s)[64], MwDesc qd, MwDesc kd) {
  reg_fence(s);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < 4; ++k) wgmma_m64n128k16_ss(s, qd.d0 + 2 * k, kd.d0 + 2 * k, k);
  if constexpr (DH == 80) wgmma_m64n128k16_ss(s, qd.d1, kd.d1, 1);
  wgmma_commit();
}

// Issues o += p v for the tile as one wgmma group: 8 k steps of 16 keys,
// each 16 rows further into the V tile (mw_rows), on the first box into
// o[0..31] and at DH 80 on the second into o[32..39].
template <int DH = 64>
__device__ __forceinline__ void pv_issue(float (&o)[DH / 2], uint32_t (&pa)[32], MwDesc vd) {
  reg_fence(o);
  reg_fence(pa);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < MW_KT / 16; ++kk) {
    const MwDesc v = mw_rows<DH>(vd, 16 * kk);
    wgmma_m64n64k16_rs_t(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3], v.d0);
    if constexpr (DH == 80)
      wgmma_m64n16k16_rs_t_hi(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                              v.d1);
  }
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
template <bool SUM = true, int DH = 64>
__device__ __forceinline__ void stats_next(float (&s)[64], float (&nxt)[64], MwRows& r, int i,
                                           float sl2, MwDesc qd, uint32_t ring, uint32_t bars) {
  const int sn = (i + 1) % MW_STAGES;
  mbar_wait(bars + 8 * sn, ((i + 1) / MW_STAGES) & 1);
  qk_issue<DH>(nxt, qd, mw_k<DH>(ring, sn));
  wgmma_wait<1>();
  reg_fence(s);
  mbar_arrive(bars + 8 * (MW_STAGES + i % MW_STAGES));
  fold<false, SUM>(s, r, 0, 0, sl2);
}

// Pass 1's last key tile `tile`, ring step i, in flight into s.
template <bool SUM = true>
__device__ __forceinline__ void stats_last(float (&s)[64], MwRows& r, int i, int tile,
                                           int n_valid, float sl2, int t4, uint32_t bars) {
  wgmma_wait<0>();
  reg_fence(s);
  mbar_arrive(bars + 8 * (MW_STAGES + i % MW_STAGES));
  fold<true, SUM>(s, r, tile * MW_KT + 2 * t4, n_valid, sl2);
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
                                        float sl2, int t4, MwDesc qd, uint32_t ring,
                                        uint32_t bars) {
  const int i = ntiles + j, st = i % MW_STAGES, sp = (i - 1) % MW_STAGES;
  mbar_wait(bars + 8 * st, (i / MW_STAGES) & 1);
  qk_issue(s, qd, mw_k<64>(ring, st));
  pv_issue(o, pa, mw_v<64>(ring, sp));
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
template <int MODE, bool LAST, int DH = 64>
__device__ __forceinline__ void mf_next(float (&s)[64], uint32_t (&pa)[32], float (&o)[DH / 2],
                                        float (&l)[2], int j, int step0, int n_valid, float scale,
                                        const float (&m2)[2], int t4, MwDesc qd, uint32_t ring,
                                        uint32_t bars) {
  const int i = step0 + j, st = i % MW_STAGES, sp = (i - 1) % MW_STAGES;
  mbar_wait(bars + 8 * st, (i / MW_STAGES) & 1);
  qk_issue<DH>(s, qd, mw_k<DH>(ring, st));
  pv_issue<DH>(o, pa, mw_v<DH>(ring, sp));
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

// The one-pass sweep of the max-free and safe modes over ntiles key tiles,
// the (K, V) pairs of ring steps step0 .. step0 + ntiles - 1 (stage i %
// MW_STAGES of the ring at `ring`, whose full and empty barriers are at bars
// + 8 s and bars + 8 (MW_STAGES + s), the empty ones counting every consumer
// thread): tile 0's p first, then per tile j its q k^T beside tile j - 1's
// p v, then the last p v.  Leaves o = sum bf16(e) v and this thread's share
// of l = sum e; every stage it read is released.  Also run by the
// persistent single-launch encoders (stack_wgmma.cuh) on their own ring,
// at head dim 64.
template <int MODE, int DH = 64>
__device__ __forceinline__ void mf_sweep(float (&sa)[64], uint32_t (&pa)[32], float (&o)[DH / 2],
                                         float (&l)[2], int ntiles, int step0, int n_valid,
                                         float sc, const float (&m2)[2], int t4, MwDesc qd,
                                         uint32_t ring, uint32_t bars) {
  l[0] = l[1] = 0.0f;
#pragma unroll
  for (int x = 0; x < DH / 2; ++x) o[x] = 0.0f;
  const int s0 = step0 % MW_STAGES;
  mbar_wait(bars + 8 * s0, (step0 / MW_STAGES) & 1);
  qk_issue<DH>(sa, qd, mw_k<DH>(ring, s0));
  wgmma_wait<0>();
  reg_fence(sa);
  if (ntiles == 1)
    mf_probs<MODE, true>(sa, pa, l, 2 * t4, n_valid, sc, m2);
  else
    mf_probs<MODE, false>(sa, pa, l, 0, 0, sc, m2);
  for (int j = 1; j < ntiles - 1; ++j)
    mf_next<MODE, false, DH>(sa, pa, o, l, j, step0, n_valid, sc, m2, t4, qd, ring, bars);
  if (ntiles > 1)
    mf_next<MODE, true, DH>(sa, pa, o, l, ntiles - 1, step0, n_valid, sc, m2, t4, qd, ring,
                            bars);
  const int sl = (step0 + ntiles - 1) % MW_STAGES;
  pv_issue<DH>(o, pa, mw_v<DH>(ring, sl));
  wgmma_wait<0>();
  reg_fence(o);
  reg_fence(pa);
  mbar_arrive(bars + 8 * (MW_STAGES + sl));
}

// The online mode's step to a key block: the rows' running max m2 (log2
// domain) becomes mn, and alpha = exp(m - m_new) rescales l and o.
__device__ __forceinline__ void online_alpha(float (&m2)[2], const float (&mn)[2],
                                             float (&alpha)[2]) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    alpha[rr] = ex2(m2[rr] - mn[rr]);
    m2[rr] = mn[rr];
  }
}

// The online mode at bk = MW_KT, a finished q k^T tile in s (its keys from
// key0 + the thread's columns): the tile's row max, m2 and alpha, l = l
// alpha + sum p and p = ex2(s2 - m2) in place, f32.
template <bool LAST>
__device__ __forceinline__ void online_probs(float (&s)[64], float (&l)[2], float (&m2)[2],
                                             float (&alpha)[2], int key0, int n_valid,
                                             float sl2) {
  float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int x = 0; x < 64; ++x)
    tmax[(x >> 1) & 1] = fmaxf(tmax[(x >> 1) & 1], score<LAST>(s, x, key0, n_valid));
  float mn[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) mn[rr] = fmaxf(m2[rr], quad_max(tmax[rr]) * sl2);
  online_alpha(m2, mn, alpha);
  l[0] *= alpha[0];
  l[1] *= alpha[1];
#pragma unroll
  for (int x = 0; x < 64; ++x) {
    const int rr = (x >> 1) & 1;
    s[x] = ex2(fmaf(score<LAST>(s, x, key0, n_valid), sl2, -m2[rr]));
    l[rr] += s[x];
  }
}

// The online mode at bk = MW_KT, tile j >= 1 (ring step j), with tile j -
// 1's p in pa and o at tile j - 1's max: pv_next's issue and wait pattern;
// once tile j - 1's p v is done, o *= tile j's alpha, then its p goes into
// pa.
template <bool LAST>
__device__ __forceinline__ void online_next(float (&s)[64], uint32_t (&pa)[32], float (&o)[32],
                                            float (&l)[2], float (&m2)[2], int j, int n_valid,
                                            float sl2, int t4, MwDesc qd, uint32_t ring,
                                            uint32_t bars) {
  const int st = j % MW_STAGES, sp = (j - 1) % MW_STAGES;
  mbar_wait(bars + 8 * st, (j / MW_STAGES) & 1);
  qk_issue(s, qd, mw_k<64>(ring, st));
  pv_issue(o, pa, mw_v<64>(ring, sp));
  wgmma_wait<1>();  // q k^T (the older group) is done
  reg_fence(s);
  float alpha[2];
  online_probs<LAST>(s, l, m2, alpha, j * MW_KT + 2 * t4, n_valid, sl2);
  wgmma_wait<0>();
  reg_fence(o);
  reg_fence(pa);
  mbar_arrive(bars + 8 * (MW_STAGES + sp));
#pragma unroll
  for (int x = 0; x < 32; ++x) o[x] *= alpha[(x >> 1) & 1];
#pragma unroll
  for (int x = 0; x < 32; ++x) pa[x] = pack_bf16x2(s[2 * x], s[2 * x + 1]);
}

// Ring step i of the producer: whether it carries V (pv) and its key tile.
// Exact and safe: pass 1's K tiles, then pass 2's pairs; max-free: pairs;
// online: pairs at bk = MW_KT, else per key block of tpb tiles its K tiles,
// then its pairs.
template <int MODE>
__device__ __forceinline__ void mw_step(int i, int ntiles, int tpb, bool& pv, int& tile) {
  if (MODE == MW_MAXFREE || (MODE == MW_ONLINE && tpb == 1)) {
    pv = true;
    tile = i;
  } else if (MODE == MW_ONLINE) {
    const int f = i / (2 * tpb) * tpb, c = min(tpb, ntiles - f), w = i - 2 * f;
    pv = w >= c;
    tile = f + (pv ? w - c : w);
  } else {
    pv = i >= ntiles;
    tile = pv ? i - ntiles : i;
  }
}

template <int MODE, bool Q8 = false, int DH = 64>
__global__ void __launch_bounds__(MW_THREADS, 1)
    mha_wgmma_kernel(const __grid_constant__ MwMaps m, MhaTmaArgs p) {
  static_assert(DH == 64 || MODE == MW_MAXFREE || MODE == MW_SAFE,
                "head dim 80 in the max-free and safe modes");
  using Dim = MwDim<DH>;
  extern __shared__ unsigned char mw_smem[];
  const uint32_t q_s = (smem_u32(mw_smem) + 1023u) & ~1023u;
  const uint32_t ring = q_s + Dim::TILE;  // stage s: K at ring + 2 s TILE, V after it
  const uint32_t bars = ring + 2 * MW_STAGES * Dim::TILE;
  const uint32_t qbar = bars + 16 * MW_STAGES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (MW_STAGES + s); };
  const int tid = threadIdx.x, warp = tid >> 5;
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int q0 = blockIdx.x * MW_BQ;
  const int ntiles = (p.n_valid + MW_KT - 1) / MW_KT;
  const int tpb = MODE == MW_ONLINE ? p.bk / MW_KT : 1;  // key tiles a block
  const int steps = MODE == MW_MAXFREE || (MODE == MW_ONLINE && tpb == 1) ? ntiles : 2 * ntiles;

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
    // Producer: Q once, then ring step i (mw_step: K alone, or K and V);
    // step i uses stage i % MW_STAGES in round i / MW_STAGES.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 128 * MW_CONSUMERS) {
      mbar_expect_tx(qbar, Dim::TILE);
      mw_load<DH>(q_s, &m.q, &m.q1, qbar, q0, h, b);
      for (int i = 0; i < steps; ++i) {
        const int s = i % MW_STAGES;
        bool pv;
        int tile;
        mw_step<MODE>(i, ntiles, tpb, pv, tile);
        const int key0 = tile * MW_KT;
        mbar_wait(empty(s), ((i / MW_STAGES) & 1) ^ 1);  // round 0 passes at once
        const uint32_t ks = ring + 2 * s * Dim::TILE;
        mbar_expect_tx(full(s), pv ? 2 * Dim::TILE : Dim::TILE);
        mw_load<DH>(ks, &m.k, &m.k1, full(s), key0, h, b);
        if (pv) mw_load<DH>(ks + Dim::TILE, &m.v, &m.v1, full(s), key0, h, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = warp >> 2, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const MwDesc qd = mw_tile<DH>(q_s, wg * 64);
    float sa[64], o[DH / 2];  // o: columns 0..63, then (DH 80) 64..79
    uint32_t pa[32];
    float ol[2] = {1.0f, 1.0f};  // the output's row factor: one-pass 1 / l
    mbar_wait(qbar, 0);
    if constexpr (MODE == MW_ONLINE) {
      const float sl2 = p.scale_log2;
      float m2[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
#pragma unroll
      for (int x = 0; x < 32; ++x) o[x] = 0.0f;
      if (tpb == 1) {
        // One sweep, a key tile a block: tile 0's p first (alpha 0 against
        // the empty start), then per tile j its q k^T beside tile j - 1's
        // p v, then the last p v.
        float alpha[2];
        mbar_wait(full(0), 0);
        qk_issue(sa, qd, mw_k<64>(ring, 0));
        wgmma_wait<0>();
        reg_fence(sa);
        if (ntiles == 1)
          online_probs<true>(sa, l, m2, alpha, 2 * t4, p.n_valid, sl2);
        else
          online_probs<false>(sa, l, m2, alpha, 0, 0, sl2);
#pragma unroll
        for (int x = 0; x < 32; ++x) pa[x] = pack_bf16x2(sa[2 * x], sa[2 * x + 1]);
        for (int j = 1; j < ntiles - 1; ++j)
          online_next<false>(sa, pa, o, l, m2, j, p.n_valid, sl2, t4, qd, ring, bars);
        if (ntiles > 1)
          online_next<true>(sa, pa, o, l, m2, ntiles - 1, p.n_valid, sl2, t4, qd, ring, bars);
        const int sl = (ntiles - 1) % MW_STAGES;
        pv_issue(o, pa, mw_v<64>(ring, sl));
        wgmma_wait<0>();
        reg_fence(o);
        reg_fence(pa);
        mbar_arrive(empty(sl));
      } else {
        // Per key block of c tiles from tile f at ring step `step`: its max
        // (the safe mode's pass 1 over its tiles from the running max, one
        // score tile at a time: o stays live across the blocks, and a second
        // score tile beside it would pass ptxas's 168 registers a thread),
        // alpha once, then the safe mode's pass over its tiles.
        int step = 0;
        for (int f = 0; f < ntiles; f += tpb) {
          const int c = min(tpb, ntiles - f);
          MwRows r{{m2[0], m2[1]}, {0.0f, 0.0f}};
          for (int jj = 0; jj < c; ++jj) {
            const int sj = (step + jj) % MW_STAGES;
            mbar_wait(full(sj), ((step + jj) / MW_STAGES) & 1);
            qk_issue(sa, qd, mw_k<64>(ring, sj));
            stats_last<false>(sa, r, step + jj, f + jj, p.n_valid, sl2, t4, bars);
          }
          float alpha[2];
          online_alpha(m2, r.m2, alpha);  // no group is in flight: o is free
          l[0] *= alpha[0];
          l[1] *= alpha[1];
#pragma unroll
          for (int x = 0; x < 32; ++x) o[x] *= alpha[(x >> 1) & 1];
          const int st0 = step + c, s0 = st0 % MW_STAGES;
          mbar_wait(full(s0), (st0 / MW_STAGES) & 1);
          qk_issue(sa, qd, mw_k<64>(ring, s0));
          wgmma_wait<0>();
          reg_fence(sa);
          if (c == 1)  // only the last block has one tile
            mf_probs<MW_SAFE, true>(sa, pa, l, f * MW_KT + 2 * t4, p.n_valid, sl2, m2);
          else
            mf_probs<MW_SAFE, false>(sa, pa, l, 0, 0, sl2, m2);
          for (int j = f + 1; j < f + c - 1; ++j)
            mf_next<MW_SAFE, false>(sa, pa, o, l, j, st0 - f, p.n_valid, sl2, m2, t4, qd, ring,
                                    bars);
          if (c > 1)  // the block's last tile: masked if it is the last tile
            mf_next<MW_SAFE, true>(sa, pa, o, l, f + c - 1, st0 - f, p.n_valid, sl2, m2, t4, qd,
                                   ring, bars);
          const int sl = (st0 + c - 1) % MW_STAGES;
          pv_issue(o, pa, mw_v<64>(ring, sl));
          wgmma_wait<0>();
          reg_fence(o);
          reg_fence(pa);
          mbar_arrive(empty(sl));
          step += 2 * c;
        }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) ol[rr] = 1.0f / quad_sum(l[rr]);
    } else if constexpr (MODE != MW_EXACT) {
      // Safe: pass 1 takes the row max m2 alone, over the exact mode's q k^T
      // tiles, two a trip (the score buffers alternate).
      MwRows r{{-INFINITY, -INFINITY}, {0.0f, 0.0f}};
      if constexpr (MODE == MW_SAFE) {
        const float sl2 = p.scale_log2;
        float sb[64];
        mbar_wait(full(0), 0);
        qk_issue<DH>(sa, qd, mw_k<DH>(ring, 0));
        int i = 0;
        for (; i + 2 < ntiles; i += 2) {
          stats_next<false, DH>(sa, sb, r, i, sl2, qd, ring, bars);
          stats_next<false, DH>(sb, sa, r, i + 1, sl2, qd, ring, bars);
        }
        if (i + 1 < ntiles) {
          stats_next<false, DH>(sa, sb, r, i, sl2, qd, ring, bars);
          stats_last<false>(sb, r, i + 1, i + 1, p.n_valid, sl2, t4, bars);
        } else {
          stats_last<false>(sa, r, i, i, p.n_valid, sl2, t4, bars);
        }
      }
      const int step0 = MODE == MW_SAFE ? ntiles : 0;
      const float sc = MODE == MW_SAFE ? p.scale_log2 : p.scale;
      float l[2];
      mf_sweep<MODE, DH>(sa, pa, o, l, ntiles, step0, p.n_valid, sc, r.m2, t4, qd, ring, bars);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) ol[rr] = 1.0f / quad_sum(l[rr]);
    } else {
      const float sl2 = p.scale_log2;
      MwRows r{{-INFINITY, -INFINITY}, {0.0f, 0.0f}};
      float sb[64];

      // Pass 1: the row max and sum, two tiles a trip (the score buffers
      // alternate); one or two tiles are left for the tail.
      mbar_wait(full(0), 0);
      qk_issue(sa, qd, mw_k<64>(ring, 0));
      int i = 0;
      for (; i + 2 < ntiles; i += 2) {
        stats_next(sa, sb, r, i, sl2, qd, ring, bars);
        stats_next(sb, sa, r, i + 1, sl2, qd, ring, bars);
      }
      if (i + 1 < ntiles) {
        stats_next(sa, sb, r, i, sl2, qd, ring, bars);
        stats_last(sb, r, i + 1, i + 1, p.n_valid, sl2, t4, bars);
      } else {
        stats_last(sa, r, i, i, p.n_valid, sl2, t4, bars);
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) r.l[rr] = 1.0f / quad_sum(r.l[rr]);

      // Pass 2: p = bf16(e / l), o += p v.  Tile 0's p first, then per tile
      // j its q k^T beside tile j - 1's p v, then the last p v.
#pragma unroll
      for (int x = 0; x < 32; ++x) o[x] = 0.0f;
      const int s0 = ntiles % MW_STAGES;
      mbar_wait(full(s0), (ntiles / MW_STAGES) & 1);
      qk_issue(sa, qd, mw_k<64>(ring, s0));
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
      pv_issue(o, pa, mw_v<64>(ring, sl));
      wgmma_wait<0>();
      reg_fence(o);
      reg_fence(pa);
      mbar_arrive(empty(sl));
    }

    if constexpr (Q8) {
      static_assert(MODE == MW_MAXFREE, "the static int8 attention is max-free");
      signed char* og =
          static_cast<signed char*>(p.o) + (size_t)b * p.out_b + (size_t)h * p.out_h;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = q0 + wg * 64 + (warp & 3) * 16 + g + 8 * rr;
        if (row >= p.n) continue;
        const float rv = __fmul_rn(ol[rr], p.out_scale);
        signed char* orow = og + (size_t)row * p.out_r + 2 * t4;
#pragma unroll
        for (int c = 0; c < DH / 8; ++c) {
          const float f0 = bf16_round(__fmul_rn(o[4 * c + 2 * rr], rv));
          const float f1 = bf16_round(__fmul_rn(o[4 * c + 2 * rr + 1], rv));
          const int q0i = static_cast<int>(fminf(fmaxf(rintf(f0), -127.0f), 127.0f));
          const int q1i = static_cast<int>(fminf(fmaxf(rintf(f1), -127.0f), 127.0f));
          *reinterpret_cast<unsigned short*>(orow + 8 * c) =
              (unsigned short)((q0i & 0xff) | ((q1i & 0xff) << 8));
        }
      }
    } else {
      bf16* og = static_cast<bf16*>(p.o) + (size_t)b * p.out_b + (size_t)h * p.out_h;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = q0 + wg * 64 + (warp & 3) * 16 + g + 8 * rr;
        if (row >= p.n) continue;
        bf16* orow = og + (size_t)row * p.out_r + 2 * t4;
#pragma unroll
        for (int c = 0; c < DH / 8; ++c)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c) =
              __floats2bfloat162_rn(o[4 * c + 2 * rr] * ol[rr], o[4 * c + 2 * rr + 1] * ol[rr]);
      }
    }
  }
}

template <int MODE, bool Q8 = false, int DH = 64>
inline cudaError_t mha_wgmma_enable() {
  return cudaFuncSetAttribute(mha_wgmma_kernel<MODE, Q8, DH>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)MwDim<DH>::SMEM);
}

template <int MODE, bool Q8 = false, int DH = 64>
inline cudaError_t launch_mha_wgmma(const MwMaps& m, const MhaTmaArgs& p, int batch,
                                    cudaStream_t stream) {
  if (p.n < 1 || p.n_valid < 1 || p.n_valid > p.n || batch < 1 ||
      (long long)batch * p.heads > MW_MAX_GRID_Y ||
      (MODE == MW_ONLINE && (p.bk < MW_KT || p.bk % MW_KT)))
    return cudaErrorInvalidValue;
  const dim3 grid((p.n + MW_BQ - 1) / MW_BQ, batch * p.heads);
  mha_wgmma_kernel<MODE, Q8, DH><<<grid, MW_THREADS, MwDim<DH>::SMEM, stream>>>(m, p);
  return cudaGetLastError();
}

// The 4-D map {cols, rows, heads, batch} of a bf16 operand with element
// strides in_r, in_h, in_b; boxes of one cols x MW_KT tile (= MW_BQ rows of
// Q), zero past `rows`: 64 columns 128-byte swizzled, or the 16 columns
// 64..79 of an 80-wide head (base 64 elements on) 32-byte swizzled.
inline bool mw_encode(CUtensorMap* map, const void* base, long long in_b, long long in_h,
                      int in_r, int rows, int heads, int batch, int cols = 64) {
  // A dimension of extent 1 is never stepped; give it a legal stride.
  auto stride = [](long long st, int extent) {
    return (cuuint64_t)(extent == 1 ? 16 : st * 2);
  };
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {stride(in_r, rows), stride(in_h, heads), stride(in_b, batch)};
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)MW_KT, 1, 1};
  return (cols == 64 || cols == 16) &&
         tma_encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, 4, dims, strides, box,
                    cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B);
}

// An operand's maps at head dim DH: columns 0..63 into *m0 and (DH 80)
// columns 64..79 into *m1.
template <int DH>
inline bool mw_encode_dh(CUtensorMap* m0, CUtensorMap* m1, const bf16* base, long long in_b,
                         long long in_h, int in_r, int rows, int heads, int batch) {
  if (!mw_encode(m0, base, in_b, in_h, in_r, rows, heads, batch)) return false;
  return DH == 64 || mw_encode(m1, base + 64, in_b, in_h, in_r, rows, heads, batch, 16);
}

// The attention in MODE (any but the online mode, which takes key blocks)
// at head dim DH over a packed (B * n_pad, 3D) bf16 qkv, q, k and v column
// blocks of each row with head h at h * DH of each (row stride 3D, image
// stride n_pad * 3D), into ao (B * n_pad, D), bf16, or with Q8 int8 aoq at
// out_scale: Q's row extent n_pad, K's and V's n_valid, so that TMA
// zero-fills the keys past it.  Every query row is written.  Shared by attn_half.cuh (K1 at DH 64, K4 at 64 and
// 80), attn_int8.cu (K16, 64 and 80), attn_int8_stats.cu (K21b, 64) and,
// with Q8, attn_int8_static.cu (K18, 64 and 80).
template <int MODE, bool Q8 = false, int DH = 64>
inline cudaError_t launch_mha_packed(const bf16* qkv, void* ao, int batch, int n_pad, int d,
                                     int heads, int n_valid, float scale, cudaStream_t st,
                                     float out_scale = 1.0f) {
  static_assert(MODE != MW_ONLINE, "the online mode takes a key block");
  if (d != heads * DH) return cudaErrorInvalidValue;
  const long long in_b = (long long)n_pad * 3 * d;
  MwMaps m;
  if (!mw_encode_dh<DH>(&m.q, &m.q1, qkv, in_b, DH, 3 * d, n_pad, heads, batch) ||
      !mw_encode_dh<DH>(&m.k, &m.k1, qkv + d, in_b, DH, 3 * d, n_valid, heads, batch) ||
      !mw_encode_dh<DH>(&m.v, &m.v1, qkv + 2 * d, in_b, DH, 3 * d, n_valid, heads, batch))
    return cudaErrorInvalidValue;
  const MhaTmaArgs a{ao,     (long long)n_pad * d, DH, d, heads, n_pad, n_valid,
                     scale * 1.4426950408889634f, scale, 0, out_scale};
  return launch_mha_wgmma<MODE, Q8, DH>(m, a, batch, st);
}

}  // namespace VFT_NS
