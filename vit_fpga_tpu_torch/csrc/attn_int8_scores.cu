// Calibrated static-scale int8 attention half with int8 scores on Hopper
// (sm_90a), the static int8 serving path's attention under the int8-scores
// switch.
//
// Replaces vit_fpga_tpu/ops/quant_block.py:_attn_int8s_static_kernel (wrapper
// attn_block_int8_static_scores, attention loop _mha_loop_int8s in
// vit_fpga_tpu/ops/attn_block.py), one Pallas kernel on the TPU.  The
// calibrated scales arrive folded (models/quantized._fold_static_scales):
// ls, lb carry 1/a_x; sqkv and bqkv the quant-domain panel scales (a_x /
// s_q | s_k | s_v per third); so carries a_ao; sdq = s_q s_k / sqrt(dh)
// dequantizes the scores and pv_fold = s_v / 127 / s_ao lands the attention
// output in the out-projection's quant domain.  Five launches on one
// stream, counted as one ported kernel, the GEMMs on qgemm_wgmma.cuh's int8
// wgmma + TMA kernel at a row scale of 1 (a null sa):
//
//   (a) quant_rows<LN_ONE_PASS, STATIC>  xq = clip(rint(LN(x)), -127, 127)
//   (b) QW_Q8     qkv8 = clip(rint(float(xq wqkvq) * sqkv + bqkv)): the
//                 q | k | v panel in int8 (act none, scale 1.0: 1.0f * f ==
//                 f exactly)
//   (c) vt_kernel v's third of the panel transposed, (B, H, 64, kvs) int8
//                 with kvs = n_valid rounded up to 16: 8-bit wgmma has no
//                 transpose bit and p v reads V K-major, [dh][key]
//   (d) attn_s8_wgmma_kernel  per (128 query rows, image x head), s =
//                 float(q k^T) * sdq (s32 sums, exact), e = exp(clip(s, -70, 80))
//                 with keys at or past n_valid at 0, r = 1 / sum(e) (a true
//                 division), pq = clip(rint(e * (127 * r)), 0, 127) as
//                 int8, pv = pq v (s32), aoq = clip(rint(float(pv) *
//                 pv_fold)) from the f32 ao, never bf16
//   (e) QW_RESID  out = x + bf16(float(aoq woq) * so + bo)
//
// pq is normalised before it is rounded, so a row's sum is known before any
// p v: the attention sweeps the keys twice (mha_wgmma.cuh's exact mode's
// skeleton), first the K tiles for the row sums, then the (K, V^T) pairs.
// The int32 products are exact and expf is deterministic, so the second
// sweep's e has the first's bits.  A producer thread streams 128-key tiles
// by TMA into a 4-stage mbarrier ring; two consumer warpgroups of 64 query
// rows run wgmma.m64n128k32.s32.s8.s8 for q k^T (q and k rows are one head,
// 64 bytes: 64-byte swizzled tiles) and, in the second sweep, write pq into
// a 64 x 128 int8 tile in shared memory (K-major, 128-byte swizzled, two
// per warpgroup in alternation), fenced to the async proxy, for
// wgmma.m64n64k32.s32.s8.s8 against the V^T tile; tile j's q k^T and pq
// are formed while tile j - 1's p v runs.  The K and V^T maps' key extent
// is n_valid, so TMA zero-fills the keys past it (zero V^T; e of a
// zero-filled key is set to 0 in the last tile).  The probabilities use
// expf and IEEE products in the plain version's order, not ex2.approx, so
// pq's rint boundaries sit where the plain version's do.  The keys stream
// through the ring: the one bound is the grid (batch x heads <=
// S8_MAX_GRID_Y, mha_wgmma.cuh's MW_MAX_GRID_Y).  The TPU's head pairing is
// a layout of its 128-lane tiles and has no counterpart here.
//
// What bounds it on the H100: at ViT-B/16 batch 64 (R = 12 800 rows,
// D = 768, 12 heads of 64, n_valid 197) 8·R·D² = 60.4 G int8 operations
// plus 4·B·H·n_pad·n_valid·dh = 7.8 G int8 operations of attention (34 us
// at 1979 TOPS) against about 42 MB of compulsory traffic (13 us): bound by
// tensor-core operations.  qkv8, V^T and aoq round-trip through device
// memory (later work: the V^T pass fused into the QKV epilogue).

#define VFT_NS attn_int8_scores
#include "common.cuh"
#include "quant.cuh"
#include "hopper.cuh"
#include "qgemm_wgmma.cuh"

namespace VFT_NS {

constexpr int S8_DH = 64;                        // head dim: one 64-byte int8 row
constexpr int S8_CONSUMERS = 2;                  // warpgroups of 64 query rows
constexpr int S8_BQ = 64 * S8_CONSUMERS;         // query rows per block
constexpr int S8_KT = 128;                       // keys per tile
constexpr int S8_STAGES = 4;                     // ring depth
constexpr int S8_THREADS = 128 * (S8_CONSUMERS + 1);
constexpr int S8_MAX_GRID_Y = 65535;             // one block row an (image, head)
constexpr uint32_t S8_Q_BYTES = S8_BQ * S8_DH;   // 8 KB, 64-byte swizzled rows
constexpr uint32_t S8_K_BYTES = S8_KT * S8_DH;   // 8 KB, 64-byte swizzled rows
constexpr uint32_t S8_V_BYTES = S8_DH * S8_KT;   // 8 KB: V^T, 64 rows of 128 keys
constexpr uint32_t S8_STAGE_BYTES = S8_K_BYTES + S8_V_BYTES;
constexpr uint32_t S8_P_BYTES = 64 * S8_KT;      // a warpgroup's pq tile, 8 KB
// 1024 bytes of slack to align the tiles to the swizzles' period, Q, the
// stages (K then V^T), two pq tiles a consumer warpgroup, the barriers.
constexpr size_t S8_SMEM_BYTES = 1024 + S8_Q_BYTES + S8_STAGES * S8_STAGE_BYTES +
                                 2 * S8_CONSUMERS * S8_P_BYTES + 8 * (2 * S8_STAGES + 1);
constexpr int VT_KEYS = 64;                      // keys a block of the V^T pass
constexpr int VT_THREADS = 4 * VT_KEYS;          // a 16-byte chunk a thread each way

// (c): vt[b][h][j][key] = v of row (b, key), head h, dim j, for key <
// n_valid, 0 up to kvs (a multiple of 16).  One block per (64 keys, head,
// image): 64 rows of 64 bytes in, through shared memory, 64 rows of 64
// keys out, 16 bytes a thread each way.
__global__ void __launch_bounds__(VT_THREADS)
    vt_kernel(const signed char* __restrict__ qkv8, signed char* __restrict__ vt, int n_pad,
              int n_valid, int kvs, int d) {
  __shared__ uint32_t tile[VT_KEYS][S8_DH / 4 + 1];  // [key][dim word], a padding word
  const int k0 = blockIdx.x * VT_KEYS, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  {
    const int r = tid >> 2, c = tid & 3, key = k0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (key < n_valid)
      v = __ldg(reinterpret_cast<const uint4*>(qkv8 + ((size_t)b * n_pad + key) * 3 * d + 2 * d +
                                               h * S8_DH + c * 16));
    tile[r][4 * c] = v.x;
    tile[r][4 * c + 1] = v.y;
    tile[r][4 * c + 2] = v.z;
    tile[r][4 * c + 3] = v.w;
  }
  __syncthreads();
  const int j = tid >> 2, c = tid & 3, key = k0 + 16 * c;
  if (key >= kvs) return;
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    w[q] = 0u;
#pragma unroll
    for (int t = 0; t < 4; ++t)
      w[q] |= ((tile[16 * c + 4 * q + t][j >> 2] >> (8 * (j & 3))) & 0xffu) << (8 * t);
  }
  *reinterpret_cast<uint4*>(vt + (((size_t)b * gridDim.y + h) * S8_DH + j) * kvs + key) =
      make_uint4(w[0], w[1], w[2], w[3]);
}

struct S8Args {
  signed char* aoq;       // (B * n_pad, D) int8
  int d, heads, n_pad, n_valid;
  float sdq, pv_fold;
};

// Issues s = q k^T for the 64 x S8_KT tile as one wgmma group: dh = 64
// bytes, two k32 steps, the second 32 bytes along the 64-byte rows.
__device__ __forceinline__ void s8_qk_issue(uint32_t (&s)[64], uint64_t qd, uint64_t kd) {
  reg_fence(s);
  wgmma_fence();
  wgmma_m64n128k32_s8(s, qd, kd, 0);
  wgmma_m64n128k32_s8(s, qd + 2, kd + 2, 1);
  wgmma_commit();
}

// Issues o += pq v for the tile as one wgmma group: 4 k32 steps of keys
// over the pq tile (p_s) and the V^T tile (v_s), both 128-byte rows.
__device__ __forceinline__ void s8_pv_issue(uint32_t (&o)[32], uint32_t p_s, uint32_t v_s) {
  const uint64_t pd = sw128_desc(p_s), vd = sw128_desc(v_s);
  reg_fence(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < S8_KT / 32; ++kk) wgmma_m64n64k32_s8(o, pd + 2 * kk, vd + 2 * kk, 1);
  wgmma_commit();
}

// e = exp(clip(float(s) * sdq, -70, 80)) of a thread's score x, or 0 for a
// key at or past n_valid in the last tile (TMA's zero-filled keys would
// give s = 0, e = 1).  Accumulator element x sits at row g + 8 ((x / 2) %
// 2), column 8 (x / 4) + 2 t4 + x % 2; key0 is the thread's first key.
template <bool LAST>
__device__ __forceinline__ float s8_exp(const uint32_t (&s)[64], int x, int key0, int n_valid,
                                        float sdq) {
  const float e =
      expf(fminf(fmaxf(__fmul_rn((float)static_cast<int>(s[x]), sdq), -70.0f), 80.0f));
  if (!LAST) return e;
  return key0 + 8 * (x >> 2) + (x & 1) >= n_valid ? 0.0f : e;
}

// Folds a finished q k^T tile's e into this thread's share of the row sums.
template <bool LAST>
__device__ __forceinline__ void s8_fold(const uint32_t (&s)[64], float (&l)[2], int key0,
                                        int n_valid, float sdq) {
#pragma unroll
  for (int x = 0; x < 64; ++x) l[(x >> 1) & 1] += s8_exp<LAST>(s, x, key0, n_valid, sdq);
}

// The issue and wait pattern of both sweeps is fixed in each loop body (the
// first and last tiles peeled), so that ptxas can see which wgmma group a
// register belongs to and does not serialise the groups; no register is
// written while a group that reads or writes it is in flight.

// Sweep 1, tile i (not the last), whose q k^T is in flight into s: waits
// for tile i + 1's K and issues its q k^T into nxt, then folds tile i into
// the row sums while that runs on the tensor cores.
__device__ __forceinline__ void s8_sum_next(uint32_t (&s)[64], uint32_t (&nxt)[64], float (&l)[2],
                                            int i, float sdq, uint64_t qd, uint32_t ring,
                                            uint32_t bars) {
  const int sn = (i + 1) % S8_STAGES;
  mbar_wait(bars + 8 * sn, ((i + 1) / S8_STAGES) & 1);
  s8_qk_issue(nxt, qd, sw64_desc(ring + sn * S8_STAGE_BYTES));
  wgmma_wait<1>();
  reg_fence(s);
  mbar_arrive(bars + 8 * (S8_STAGES + i % S8_STAGES));
  s8_fold<false>(s, l, 0, 0, sdq);
}

// Sweep 1's last key tile i, in flight into s.
__device__ __forceinline__ void s8_sum_last(uint32_t (&s)[64], float (&l)[2], int i, int n_valid,
                                            float sdq, int t4, uint32_t bars) {
  wgmma_wait<0>();
  reg_fence(s);
  mbar_arrive(bars + 8 * (S8_STAGES + i % S8_STAGES));
  s8_fold<true>(s, l, i * S8_KT + 2 * t4, n_valid, sdq);
}

// pq = clip(rint(e * p127), 0, 127) of a finished q k^T tile into the
// warpgroup's pq tile at pt: row r (of 64) at r * 128, key c at byte c of
// the row, its 16-byte chunk swizzled by r % 8 (= g), as wgmma reads a
// 128-byte-swizzled K-major tile.  Two keys (one accumulator pair) a store.
template <bool LAST>
__device__ __forceinline__ void s8_probs(const uint32_t (&s)[64], unsigned char* pt, int key0,
                                         int n_valid, float sdq, const float (&p127)[2], int w4,
                                         int g, int t4) {
#pragma unroll
  for (int j = 0; j < S8_KT / 8; ++j) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int x = 4 * j + 2 * rr;
      const float e0 = s8_exp<LAST>(s, x, key0, n_valid, sdq);
      const float e1 = s8_exp<LAST>(s, x + 1, key0, n_valid, sdq);
      const int q0 = static_cast<int>(fminf(fmaxf(rintf(__fmul_rn(e0, p127[rr])), 0.0f), 127.0f));
      const int q1 = static_cast<int>(fminf(fmaxf(rintf(__fmul_rn(e1, p127[rr])), 0.0f), 127.0f));
      const int r = 16 * w4 + g + 8 * rr;
      *reinterpret_cast<unsigned short*>(pt + r * 128 + (((j >> 1) ^ g) << 4) + (j & 1) * 8 +
                                         2 * t4) = (unsigned short)(q0 | (q1 << 8));
    }
  }
}

// Sweep 2, tile j >= 1 (ring step ntiles + j), with tile j - 1's pq in the
// pq tile (j - 1) % 2: waits for tile j's stage, issues its q k^T into s and
// then tile j - 1's p v; while p v runs, writes tile j's pq into the other
// pq tile, then releases tile j - 1's stage once its p v is done.
template <bool LAST>
__device__ __forceinline__ void s8_pv_next(uint32_t (&s)[64], uint32_t (&o)[32], int j,
                                           int ntiles, int n_valid, float sdq,
                                           const float (&p127)[2], int w4, int g, int t4, int wg,
                                           uint64_t qd, uint32_t ring, uint32_t bars,
                                           uint32_t p_s, unsigned char* p_g) {
  const int i = ntiles + j, st = i % S8_STAGES, sp = (i - 1) % S8_STAGES;
  mbar_wait(bars + 8 * st, (i / S8_STAGES) & 1);
  s8_qk_issue(s, qd, sw64_desc(ring + st * S8_STAGE_BYTES));
  s8_pv_issue(o, p_s + ((j - 1) & 1) * S8_P_BYTES, ring + sp * S8_STAGE_BYTES + S8_K_BYTES);
  wgmma_wait<1>();  // q k^T (the older group) is done
  reg_fence(s);
  s8_probs<LAST>(s, p_g + (j & 1) * S8_P_BYTES, j * S8_KT + 2 * t4, n_valid, sdq, p127, w4, g,
                 t4);
  wgmma_wait<0>();
  reg_fence(o);
  // pq, before wgmma reads it; after the wait: ptxas (CUDA 12.9) crashed
  // on a fence.proxy.async followed by a wgmma wait
  fence_proxy_async();
  mbar_arrive(bars + 8 * (S8_STAGES + sp));
  named_barrier(1 + wg, 128);  // the warpgroup's whole pq tile is written
}

// qkv8: (B * n_pad, 3D) int8 through tq (rows n_pad) and tk (rows
// n_valid), 4-D {64, rows, heads, batch} maps of 64-byte swizzled boxes of
// 64 x 128 rows; vt: (B, H, 64, kvs) through tv, {keys n_valid, 64, heads,
// batch}, 128-byte swizzled boxes of 128 keys x 64.  Every query row
// below n_pad is written.
__global__ void __launch_bounds__(S8_THREADS, 1)
    attn_s8_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, S8Args p) {
  extern __shared__ unsigned char s8_smem[];
  const uint32_t base = smem_u32(s8_smem);
  const uint32_t q_s = (base + 1023u) & ~1023u;
  const uint32_t ring = q_s + S8_Q_BYTES;  // stage s: K at ring + s STAGE, V^T after it
  const uint32_t pq_s = ring + S8_STAGES * S8_STAGE_BYTES;
  const uint32_t bars = pq_s + 2 * S8_CONSUMERS * S8_P_BYTES;
  const uint32_t qbar = bars + 16 * S8_STAGES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (S8_STAGES + s); };
  const int tid = threadIdx.x, warp = tid >> 5;
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int q0 = blockIdx.x * S8_BQ;
  const int ntiles = (p.n_valid + S8_KT - 1) / S8_KT;

  if (tid == 0) {
    for (int s = 0; s < S8_STAGES; ++s) {
      mbar_init(full(s), 1);                    // the producer's expect_tx
      mbar_init(empty(s), 128 * S8_CONSUMERS);  // every consumer thread
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * S8_CONSUMERS) {
    // Producer: Q once, then ring step i: the K tiles of sweep 1 (i <
    // ntiles), then the (K, V^T) pairs of sweep 2; step i uses stage i %
    // S8_STAGES in round i / S8_STAGES.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 128 * S8_CONSUMERS) {
      mbar_expect_tx(qbar, S8_Q_BYTES);
      tma_load_4d(q_s, &tq, qbar, 0, q0, h, b);
      for (int i = 0; i < 2 * ntiles; ++i) {
        const int s = i % S8_STAGES;
        const bool pv = i >= ntiles;
        const int key0 = (pv ? i - ntiles : i) * S8_KT;
        mbar_wait(empty(s), ((i / S8_STAGES) & 1) ^ 1);  // round 0 passes at once
        const uint32_t ks = ring + s * S8_STAGE_BYTES;
        mbar_expect_tx(full(s), pv ? S8_STAGE_BYTES : S8_K_BYTES);
        tma_load_4d(ks, &tk, full(s), 0, key0, h, b);
        if (pv) tma_load_4d(ks + S8_K_BYTES, &tv, full(s), key0, 0, h, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = warp >> 2, w4 = warp & 3, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const uint64_t qd = sw64_desc(q_s + wg * 64 * S8_DH);
    const uint32_t p_s = pq_s + wg * 2 * S8_P_BYTES;
    unsigned char* p_g = s8_smem + (p_s - base);
    const float sdq = p.sdq;
    uint32_t sa[64], o[32];
    mbar_wait(qbar, 0);

    // Sweep 1: the row sums, two tiles a trip (the score buffers
    // alternate); one or two tiles are left for the tail.
    float l[2] = {0.0f, 0.0f};
    {
      uint32_t sb[64];
      mbar_wait(full(0), 0);
      s8_qk_issue(sa, qd, sw64_desc(ring));
      int i = 0;
      for (; i + 2 < ntiles; i += 2) {
        s8_sum_next(sa, sb, l, i, sdq, qd, ring, bars);
        s8_sum_next(sb, sa, l, i + 1, sdq, qd, ring, bars);
      }
      if (i + 1 < ntiles) {
        s8_sum_next(sa, sb, l, i, sdq, qd, ring, bars);
        s8_sum_last(sb, l, i + 1, p.n_valid, sdq, t4, bars);
      } else {
        s8_sum_last(sa, l, i, p.n_valid, sdq, t4, bars);
      }
    }
    float p127[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
      p127[rr] = __fmul_rn(127.0f, __fdiv_rn(1.0f, quad_sum(l[rr])));

    // Sweep 2: tile 0's pq first, then per tile j its q k^T and pq beside
    // tile j - 1's p v, then the last p v.
#pragma unroll
    for (int x = 0; x < 32; ++x) o[x] = 0u;
    const int s0 = ntiles % S8_STAGES;
    mbar_wait(full(s0), (ntiles / S8_STAGES) & 1);
    s8_qk_issue(sa, qd, sw64_desc(ring + s0 * S8_STAGE_BYTES));
    wgmma_wait<0>();
    reg_fence(sa);
    if (ntiles == 1)
      s8_probs<true>(sa, p_g, 2 * t4, p.n_valid, sdq, p127, w4, g, t4);
    else
      s8_probs<false>(sa, p_g, 0, 0, sdq, p127, w4, g, t4);
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    for (int j = 1; j < ntiles - 1; ++j)
      s8_pv_next<false>(sa, o, j, ntiles, p.n_valid, sdq, p127, w4, g, t4, wg, qd, ring, bars,
                        p_s, p_g);
    if (ntiles > 1)
      s8_pv_next<true>(sa, o, ntiles - 1, ntiles, p.n_valid, sdq, p127, w4, g, t4, wg, qd, ring,
                       bars, p_s, p_g);
    const int sl = (2 * ntiles - 1) % S8_STAGES;
    s8_pv_issue(o, p_s + ((ntiles - 1) & 1) * S8_P_BYTES, ring + sl * S8_STAGE_BYTES + S8_K_BYTES);
    wgmma_wait<0>();
    reg_fence(o);
    mbar_arrive(empty(sl));

    // aoq = clip(rint(float(pv) * pv_fold)), two neighbouring dims a store
    signed char* og = p.aoq + (size_t)b * p.n_pad * p.d + h * S8_DH;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = q0 + wg * 64 + w4 * 16 + g + 8 * rr;
      if (row >= p.n_pad) continue;
      signed char* orow = og + (size_t)row * p.d + 2 * t4;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const unsigned char lo = static_cast<unsigned char>(
            rint_sat(__fmul_rn((float)static_cast<int>(o[4 * c + 2 * rr]), p.pv_fold)));
        const unsigned char hi = static_cast<unsigned char>(
            rint_sat(__fmul_rn((float)static_cast<int>(o[4 * c + 2 * rr + 1]), p.pv_fold)));
        *reinterpret_cast<unsigned short*>(orow + 8 * c) =
            static_cast<unsigned short>(lo | (hi << 8));
      }
    }
  }
}

// A 4-D int8 map {e0, e1, heads, batch} with byte strides s1, s2, s3 and
// boxes {b0, b1, 1, 1}, zero past the extents.
inline bool s8_encode(CUtensorMap* map, const void* base, int e0, int e1, int heads, int batch,
                      long long s1, long long s2, long long s3, int b0, int b1,
                      CUtensorMapSwizzle swizzle) {
  // A dimension of extent 1 is never stepped; give it a legal stride.
  auto stride = [](long long st, int extent) { return (cuuint64_t)(extent == 1 ? 16 : st); };
  const cuuint64_t dims[4] = {(cuuint64_t)e0, (cuuint64_t)e1, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {stride(s1, e1), stride(s2, heads), stride(s3, batch)};
  const cuuint32_t box[4] = {(cuuint32_t)b0, (cuuint32_t)b1, 1, 1};
  return tma_encode_s8(map, base, 4, dims, strides, box, swizzle);
}

}  // namespace VFT_NS

using namespace VFT_NS;

extern "C" {

// Finds cuTensorMapEncodeTiled (tma_init) and opts the GEMM's epilogues and
// the attention in to their shared memory, on the current device.  Called
// once per device before the first launch.  Returns a cudaError_t.
int vft_attn_int8_scores_init() {
  cudaError_t err = tma_init();
  if (err != cudaSuccess) return err;
  if ((err = qgemm_epi_enable<QW_Q8>()) != cudaSuccess) return err;
  if ((err = qgemm_epi_enable<QW_RESID>()) != cudaSuccess) return err;
  return cudaFuncSetAttribute(attn_s8_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)S8_SMEM_BYTES);
}

// x, out: (B * n_pad, D) bf16; ls, lb, so, bo: (D,) f32; wqkv: (3D, D) int8
// (the (D, 3D) weight transposed); sqkv, bqkv: (3D,) f32, the quant-domain
// panel scales; wo: (D, D) int8 (transposed).  Scratch: q8 (B * n_pad, D)
// int8 (xq, then aoq), qkv8 (B * n_pad, 3D) int8, vt (B, H, 64, kvs) int8
// with kvs = n_valid rounded up to 16; every tensor 16-byte aligned.  Head
// dim 64, 1 <= n_valid <= n_pad, batch x heads <= S8_MAX_GRID_Y; sdq =
// sc_qk / sqrt(dh) and pv_fold the per-layer scalar dequants.  Everything
// is enqueued on `stream`, which belongs to the current device.  Returns a
// cudaError_t.
int vft_attn_block_int8_scores(const void* x, const void* ls, const void* lb, const void* wqkv,
                               const void* sqkv, const void* bqkv, const void* wo, const void* so,
                               const void* bo, void* out, void* q8, void* qkv8, void* vt,
                               int batch, int n_pad, int d, int heads, int n_valid, float eps,
                               float sdq, float pv_fold, void* stream) {
  if (heads < 1 || d != heads * S8_DH || batch < 1 || n_valid < 1 || n_valid > n_pad ||
      (long long)batch * heads > S8_MAX_GRID_Y)
    return cudaErrorInvalidValue;
  if (tma_encoder() == nullptr) return cudaErrorInitializationError;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int rows = batch * n_pad;
  const int kvs = (n_valid + 15) / 16 * 16;
  signed char* q = static_cast<signed char*>(q8);
  signed char* panel = static_cast<signed char*>(qkv8);
  signed char* vtp = static_cast<signed char*>(vt);
  cudaError_t err;
  if ((err = launch_quant_rows<bf16, LN_ONE_PASS, true>(
           static_cast<const bf16*>(x), static_cast<const float*>(ls),
           static_cast<const float*>(lb), q, nullptr, rows, d, eps, st)) != cudaSuccess)
    return err;

  QwArgs g{};
  g.M = rows;
  g.N = 3 * d;
  g.K = d;
  g.sb = static_cast<const float*>(sqkv);
  g.bias = static_cast<const float*>(bqkv);
  g.act = ACT_NONE;
  g.qscale = 1.0f;
  if ((err = launch_qgemm_epi<QW_Q8>(q, static_cast<const signed char*>(wqkv), panel, g, st)) !=
      cudaSuccess)
    return err;

  vt_kernel<<<dim3((kvs + VT_KEYS - 1) / VT_KEYS, heads, batch), VT_THREADS, 0, st>>>(
      panel, vtp, n_pad, n_valid, kvs, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const long long ld = 3LL * d, img = (long long)n_pad * ld;
  CUtensorMap tq, tk, tv;
  if (!s8_encode(&tq, panel, S8_DH, n_pad, heads, batch, ld, S8_DH, img, S8_DH, S8_BQ,
                 CU_TENSOR_MAP_SWIZZLE_64B) ||
      !s8_encode(&tk, panel + d, S8_DH, n_valid, heads, batch, ld, S8_DH, img, S8_DH, S8_KT,
                 CU_TENSOR_MAP_SWIZZLE_64B) ||
      !s8_encode(&tv, vtp, n_valid, S8_DH, heads, batch, kvs, (long long)S8_DH * kvs,
                 (long long)heads * S8_DH * kvs, S8_KT, S8_DH, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  const S8Args a{q, d, heads, n_pad, n_valid, sdq, pv_fold};
  attn_s8_wgmma_kernel<<<dim3((n_pad + S8_BQ - 1) / S8_BQ, batch * heads), S8_THREADS,
                         S8_SMEM_BYTES, st>>>(tq, tk, tv, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  QwArgs o{};
  o.M = rows;
  o.N = d;
  o.K = d;
  o.sb = static_cast<const float*>(so);
  o.bias = static_cast<const float*>(bo);
  o.residual = static_cast<const bf16*>(x);
  if ((err = launch_qgemm_epi<QW_RESID>(q, static_cast<const signed char*>(wo), out, o, st)) !=
      cudaSuccess)
    return err;
  return cudaGetLastError();
}

}  // extern "C"
