// Whole-sequence exact-softmax attention in bf16 on Hopper's own units
// (mha.cu K7 / K8); include after common.cuh and seq_attn.cuh (quad_max,
// quad_sum, pack_bf16x2).  Head dim 64.
//
// One block per (MW_BQ query rows, image x head): MW_CONSUMERS warpgroups of
// 64 query rows each and a producer warpgroup, of which one thread issues
// TMA loads into a ring of MW_STAGES shared-memory stages, each stage one
// full and one empty mbarrier: the K tiles of pass 1, then the (K, V) tile
// pairs of pass 2, MW_KT keys a tile, only the tiles before n_valid.  The
// producer gives its registers up (setmaxnreg 24) to the consumers (240):
// each of the SM's four register files holds one warp of each warpgroup,
// 2 x 240 + 24 = 504 of its 512 registers a lane.  The tensor maps
// (built on the host by cuTensorMapEncodeTiled) are 4-D, {64, rows, heads,
// batch} with the operands' own strides, so the packed (B, N, 3D) qkv tensor
// and (B, H, N, 64) read alike; K's and V's row extent is n_valid, so TMA
// zero-fills the keys past it, and Q's is n.  Rows are 128 bytes and land
// 128-byte swizzled, the layout wgmma reads.
//
// Each consumer warpgroup, for its 64 rows:
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

#pragma once

#include <cuda.h>

namespace VFT_NS {

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
// A wait this long means a lost arrival: trap instead of hanging the card.
constexpr unsigned MW_SPIN_LIMIT = 1u << 24;

struct MhaTmaArgs {
  void* o;
  long long out_b, out_h;  // element strides of o: image, head
  int out_r;               // and token row
  int heads, n, n_valid;   // n query rows and keys; keys >= n_valid masked
  float scale_log2;        // softmax scale * log2(e)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  unsigned spins = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && ++spins > MW_SPIN_LIMIT) __trap();
  } while (!done);
}

// One box of the 4-D map at {c0, c1, c2, c3} into shared memory at dst,
// completing `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile of 128-byte
// rows at saddr (1 KB aligned, or offset within a row for a K step): start
// address >> 4, leading offset 1 (unused by the swizzled layouts here),
// stride 1024 bytes between 8-row groups, layout SWIZZLE_128B.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Keeps the compiler from moving register reads or writes across the
// asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 128, f32) (+)= A (64 x 16, shared, K-major) B (16 x 128, shared,
// K-major); accumulate unless scale_d is 0.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers, the m16n8k16 A
// fragment of each warp's 16 rows) B (16 x 64, shared, MN-major: the
// transpose bit).
__device__ __forceinline__ void wgmma_m64n64k16_rs_t(float (&d)[32], uint32_t a0, uint32_t a1,
                                                     uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

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

// Folds a finished q k^T tile into the running max and sum.
template <bool LAST>
__device__ __forceinline__ void fold(const float (&s)[64], MwRows& r, int key0, int n_valid,
                                     float sl2) {
  float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int x = 0; x < 64; ++x)
    tmax[(x >> 1) & 1] = fmaxf(tmax[(x >> 1) & 1], score<LAST>(s, x, key0, n_valid));
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float mn = fmaxf(r.m2[rr], quad_max(tmax[rr]) * sl2);
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
// running max and sum while that runs on the tensor cores.
__device__ __forceinline__ void stats_next(float (&s)[64], float (&nxt)[64], MwRows& r, int i,
                                           float sl2, uint64_t qd, uint32_t ring,
                                           uint32_t bars) {
  const int sn = (i + 1) % MW_STAGES;
  mbar_wait(bars + 8 * sn, ((i + 1) / MW_STAGES) & 1);
  qk_issue(nxt, qd, sw128_desc(ring + 2 * sn * MW_TILE_BYTES));
  wgmma_wait<1>();
  reg_fence(s);
  mbar_arrive(bars + 8 * (MW_STAGES + i % MW_STAGES));
  fold<false>(s, r, 0, 0, sl2);
}

// Pass 1's last tile i, in flight into s.
__device__ __forceinline__ void stats_last(float (&s)[64], MwRows& r, int i, int n_valid,
                                           float sl2, int t4, uint32_t bars) {
  wgmma_wait<0>();
  reg_fence(s);
  mbar_arrive(bars + 8 * (MW_STAGES + i % MW_STAGES));
  fold<true>(s, r, i * MW_KT + 2 * t4, n_valid, sl2);
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
    // ntiles, tile i - ntiles of pass 2 (K and V) after; step i uses stage
    // i % MW_STAGES in round i / MW_STAGES.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 128 * MW_CONSUMERS) {
      mbar_expect_tx(qbar, MW_Q_BYTES);
      tma_load_4d(q_s, &tq, qbar, 0, q0, h, b);
      for (int i = 0; i < 2 * ntiles; ++i) {
        const int s = i % MW_STAGES;
        const bool pv = i >= ntiles;
        const int key0 = (pv ? i - ntiles : i) * MW_KT;
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
    const float sl2 = p.scale_log2;
    MwRows r{{-INFINITY, -INFINITY}, {0.0f, 0.0f}};
    float sa[64], sb[64];
    mbar_wait(qbar, 0);

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
    float o[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) o[x] = 0.0f;
    uint32_t pa[32];
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

    bf16* og = static_cast<bf16*>(p.o) + (size_t)b * p.out_b + (size_t)h * p.out_h;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = q0 + wg * 64 + (warp & 3) * 16 + g + 8 * rr;
      if (row >= p.n) continue;
      bf16* orow = og + (size_t)row * p.out_r + 2 * t4;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c) =
            __floats2bfloat162_rn(o[4 * c + 2 * rr], o[4 * c + 2 * rr + 1]);
    }
  }
}

inline cudaError_t mha_wgmma_enable() {
  return cudaFuncSetAttribute(mha_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)MW_SMEM_BYTES);
}

inline cudaError_t launch_mha_wgmma(const CUtensorMap& tq, const CUtensorMap& tk,
                                    const CUtensorMap& tv, const MhaTmaArgs& p, int batch,
                                    cudaStream_t stream) {
  if (p.n < 1 || p.n_valid < 1 || p.n_valid > p.n) return cudaErrorInvalidValue;
  const dim3 grid((p.n + MW_BQ - 1) / MW_BQ, batch * p.heads);
  mha_wgmma_kernel<<<grid, MW_THREADS, MW_SMEM_BYTES, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace VFT_NS
