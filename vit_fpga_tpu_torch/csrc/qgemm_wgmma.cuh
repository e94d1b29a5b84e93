// The int8 GEMM on Hopper's own units (int8_gemm.cu K13, and every int8
// GEMM of K14-K18, K21a, K21b and K22); include after common.cuh and
// hopper.cuh.
//
//   C = A B^T, A (M, K) and B (N, K) int8, both row-major (K-major: the
//   layout 8-bit wgmma reads, which has no transpose bit), C (M, N) int32,
//   the sums exact in any order.
//
// Design (one persistent block per SM walking 128 x BN output tiles, N
// fastest; BN 256 or 128): a producer warpgroup gives its registers up
// (setmaxnreg 40) and one of its threads streams each tile's K steps of 128
// (one 128-byte swizzle row of int8) by TMA into a ring of stages, each a
// full and an empty mbarrier: the A box (128 rows) and the B box (BN
// rows), both K-major.  K past the tensor's extent lands zero-filled, so a
// ragged K (784 = 6 x 128 + 16) needs no padding copy; rows past M or N
// land zero too.  Two consumer warpgroups (setmaxnreg 232) take 64 rows
// each and issue wgmma.m64nBNk32.s32.s8.s8 on the stage, four a K step, the
// next step waited for while the step before runs on the tensor cores.
//
// The epilogue is what bounds every shape the port runs: the int32 output
// is 4 of the ~5 bytes each product moves (ViT-B's (12 800, 768) x 3072
// writes 157 MB, 47 us at 3.35 TB/s, against 31 us of int8 products).  So
// the stores are TMA's, off the consumers' critical path: each consumer
// warpgroup writes its 64 rows 32 columns at a time (a 64 x 128-byte piece,
// 128-byte swizzled as the store reads it: two wavefronts a warp) into one
// of its EPI_BUFS staging buffers, fences it to the async proxy, and one of
// its threads issues a TMA store of the piece (cp.async.bulk.tensor, shared
// -> global) that nobody waits on: the thread only waits, before a buffer
// is written again, until the store EPI_BUFS pieces back has read it, and
// before the block exits, until all have landed.  The last pieces of a
// tile drain while the next tile's products run.  Timed against a ring of
// 2 or 3 stages holding the whole or half a 256-wide tile in staging, and
// against stores from the registers, 4 stages and 2 pieces won at ViT-B's
// shapes (PERF.md, torch_k1_ab.py --qgemm).  TMA leaves out the rows and
// columns past M and N.  An output whose row stride is not a multiple of 16
// bytes (N % 4 != 0: the dense net's N = 10) cannot be a TMA store; its
// tiles are written from the accumulator registers by masked stores, an
// epilogue of the same kernel (QW_STORE_REGS), not a fallback.
//
// K14 (quant_linear.cu), K15 (mlp_int8.cu), K21a (mlp_int8_stats.cu), K16
// (attn_int8.cu), K21b (attn_int8_stats.cu), K18 (attn_int8_static.cu),
// K17 (mlp_int8_static.cu) and K22 (attn_int8_scores.cu) run their GEMMs
// on this kernel, with dequantizing epilogues over the same accumulator
// tile (QwEpi, qw_epilogue): f = float(acc) * (sa[row] * sb[col]) +
// bias[col] in IEEE operations, in the plain versions' order, a null sa a
// row scale of 1.0 (the static scales are folded into sb: 1.0f * sb == sb
// exactly); K15's W1 then h = act(f) in f32 with the tile's row absmax of
// h in parts[col tile][row]; W2 and the out-projections out = residual +
// bf16(f), added in f32 and rounded once, in bf16; the bf16 QKV bf16(f);
// the static int8 outputs (K17's W1 hq, K22's q | k | v panel) int8
// clip(rint(act(f) * qscale), -127, 127) with the static scale folded into
// the activation (qact_scaled), saturating; K14's fused linear act(f) in
// bf16 or f32 (QW_ACT), with its textbook tanh-GELU (qact), at any N: the
// columns past a ragged N are left out by TMA, and where the output's row
// stride is not a multiple of 16 bytes the thread's results go from the
// registers to device memory, masked.  The sums pass through the staging
// buffers, whose 64 rows of 128 bytes serve every element size.

#pragma once

namespace VFT_NS {

// The epilogue of a launch over the consumer warpgroup's 64 x BN tile.
enum QwEpi {
  QW_STORE_TMA = 0,   // K13: the int32 sums, by TMA
  QW_STORE_REGS = 1,  // K13: the int32 sums from the registers (N % 4 != 0)
  QW_H = 2,           // K15's W1: f32 h = act(f) by TMA, the tile's row absmax to parts
  QW_RESID = 3,       // W2 and the out-projections: bf16 residual + bf16(f) by TMA
  QW_BF16 = 4,        // the int8 attention halves' QKV: bf16(f) by TMA
  QW_Q8 = 5,          // the static int8 outputs: rint_sat(qact_scaled(f)) by TMA
  QW_ACT = 6          // K14: act(f) in bf16 or f32, by TMA or from the registers
};

constexpr int QW_BM = 128;         // rows per tile: two consumer warpgroups of 64
constexpr int QW_BK = 128;         // one 128-byte swizzle row of int8
constexpr int QW_THREADS = 384;    // two consumer warpgroups and the producer's
constexpr int QW_EPI_COLS = 32;    // int32 columns of a staged piece: 128 bytes
constexpr uint32_t QW_A_BYTES = QW_BM * QW_BK;               // 16 KB
constexpr uint32_t QW_EPI_BYTES = 64 * QW_EPI_COLS * 4;      // 8 KB a piece
// Ring stages and staging pieces of a consumer warpgroup, by tile width.
constexpr int QW_STAGES_256 = 4;
constexpr int QW_EPI_BUFS_256 = 2;
constexpr int QW_STAGES_128 = 4;
constexpr int QW_EPI_BUFS_128 = 2;

template <int BN>
struct QwShape {
  static constexpr int STAGES = BN == 256 ? QW_STAGES_256 : QW_STAGES_128;
  static constexpr int EPI_BUFS = BN == 256 ? QW_EPI_BUFS_256 : QW_EPI_BUFS_128;
  static constexpr uint32_t STAGE_BYTES = QW_A_BYTES + BN * QW_BK;  // 48 or 32 KB
  // 1024 bytes of slack to align the ring to the swizzle's 1 KB period, the
  // stages, the staging buffers of both consumers, then the barriers.
  static constexpr size_t SMEM_BYTES =
      1024 + STAGES * STAGE_BYTES + 2 * EPI_BUFS * QW_EPI_BYTES + 16 * STAGES;
  static_assert(SMEM_BYTES <= 232448, "the shared memory a block can have");
};

struct QwArgs {
  int* C;       // (M, N) int32; read by QW_STORE_REGS
  int M, N, K;  // K a multiple of 16 (TMA's 16-byte row stride)
  // the dequantizing epilogues (K15, K16, K18, K21a, K21b)
  const float* sa;       // (M,) row scales, or null: 1.0 (quant.cuh's convention)
  const float* sb;       // (N,) column scales
  const float* bias;     // (N,)
  const bf16* residual;  // QW_RESID: (M, N)
  float* parts;          // QW_H: (col tiles, M) each tile's row absmax of h
  int act;
  float qscale;          // QW_Q8: the static output scale, folded into act
  // QW_ACT: the output is f32 (else bf16); y_regs (set by the launch where
  // the row stride is not a multiple of 16 bytes) stores it through y from
  // the registers instead of by TMA
  int y_f32, y_regs;
  void* y;
};

// Issues acc += A_stage B_stage^T over one K step of 128 as one wgmma group
// (four k32 slices, each 32 bytes further along the swizzled rows); BN 256
// or 128 (K13's tiles) or 64 (stack_wgmma.cuh's int8 items).
template <int BN>
__device__ __forceinline__ void qw_issue(uint32_t (&acc)[BN / 2], uint32_t a_s, uint32_t b_s) {
  const uint64_t da = sw128_desc(a_s), db = sw128_desc(b_s);
  reg_fence(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < QW_BK / 32; ++kk) {
    if constexpr (BN == 256)
      wgmma_m64n256k32_s8(acc, da + 2 * kk, db + 2 * kk, 1);
    else if constexpr (BN == 128)
      wgmma_m64n128k32_s8(acc, da + 2 * kk, db + 2 * kk, 1);
    else
      wgmma_m64n64k32_s8(acc, da + 2 * kk, db + 2 * kk, 1);
  }
  wgmma_commit();
}

// QW_STORE_TMA: the consumer warpgroup's 64 x BN tile, piece by piece of 32
// columns, through its EPI_BUFS staging buffers (buf: the first, generic and
// shared addresses) by TMA stores of the 64 x 32 box at {col, row0} of tc.
// Thread (warp w4, lane g, t4) holds rows 16 w4 + g (+8) and the column
// pairs 8 j + 2 t4 of each 8-column block j (acc[4 j + 2 rr + e]).  wt == 0
// issues the stores and waits for them; piece counts this warpgroup's
// pieces over the block's tiles (buffer piece % EPI_BUFS).
template <int BN>
__device__ __forceinline__ void qw_store_tma(const uint32_t (&acc)[BN / 2],
                                             const CUtensorMap* tc, const QwArgs& p, int row0,
                                             int n0, unsigned char* buf, uint32_t buf_s, int wg,
                                             int wt, int& piece) {
  constexpr int NB = QwShape<BN>::EPI_BUFS;
  const int w4 = wt >> 5, g = (wt & 31) >> 2, t4 = wt & 3;
#pragma unroll
  for (int pc = 0; pc < BN / QW_EPI_COLS; ++pc) {
    if (n0 + QW_EPI_COLS * pc >= p.N) break;
    const int b = piece % NB;
    // the store that read this buffer last (NB pieces back) is done with it
    if (wt == 0) bulk_wait_read<NB - 1>();
    named_barrier(1 + wg, 128);
    unsigned char* dst = buf + b * QW_EPI_BYTES;
#pragma unroll
    for (int jj = 0; jj < QW_EPI_COLS / 8; ++jj) {
      const int j = QW_EPI_COLS / 8 * pc + jj;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = 16 * w4 + g + 8 * rr;  // r % 8 == g
        const int chunk = (2 * jj + (t4 >> 1)) ^ g;
        *reinterpret_cast<uint2*>(dst + r * 128 + chunk * 16 + (t4 & 1) * 8) =
            make_uint2(acc[4 * j + 2 * rr], acc[4 * j + 2 * rr + 1]);
      }
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (wt == 0) {
      tma_store_2d(tc, buf_s + b * QW_EPI_BYTES, n0 + QW_EPI_COLS * pc, row0);
      bulk_commit();
    }
    ++piece;
  }
}

// Piece pc (32 columns) of the consumer warpgroup's int32 sums into raw in
// QW_STORE_TMA's staging layout, pc chosen at run time through a chain of
// compile-time pieces, so that the caller's loop over the pieces stays
// rolled and acc stays in registers.
template <int BN, int P = 0>
__device__ __forceinline__ void qw_raw_piece(const uint32_t (&acc)[BN / 2], int pc,
                                             unsigned char* raw, int wt) {
  if constexpr (P < BN / QW_EPI_COLS) {
    if (pc != P) {
      qw_raw_piece<BN, P + 1>(acc, pc, raw, wt);
      return;
    }
    const int w4 = wt >> 5, g = (wt & 31) >> 2, t4 = wt & 3;
#pragma unroll
    for (int jj = 0; jj < QW_EPI_COLS / 8; ++jj) {
      const int j = QW_EPI_COLS / 8 * P + jj;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        *reinterpret_cast<uint2*>(raw + (16 * w4 + g + 8 * rr) * 128 +
                                  (((2 * jj + (t4 >> 1)) ^ g) << 4) + (t4 & 1) * 8) =
            make_uint2(acc[4 * j + 2 * rr], acc[4 * j + 2 * rr + 1]);
    }
  }
}

// The dequantizing epilogues (QW_H, QW_RESID, QW_BF16, QW_Q8, QW_ACT) over the consumer
// warpgroup's 64 x BN tile at {n0, row0}, f = float(acc) * (sa[row] *
// sb[col]) + bias[col].
// Computed in the registers over the unrolled tile, the 128 values a
// thread of a 256-wide tile holds each inlined the activation's tanhf,
// and W1 took twice as long (PERF.md).  So each 32-column piece of the
// sums is staged in the warpgroup's first staging buffer (raw), and each
// thread then takes 16 consecutive columns of one row (thread t: row t /
// 2, columns 16 (t % 2) ..) in a loop over the pieces that stays rolled
// (16 copies of the arithmetic, not 128), writing its results to the
// second buffer, the output piece of 128-byte rows (32 f32, 64 bf16 or 128
// int8 columns), stored by TMA once complete.  Each row's absmax of h over the
// tile's valid columns goes to parts[n0 / BN][row].
template <int BN, int EPI>
__device__ __forceinline__ void qw_epilogue(const uint32_t (&acc)[BN / 2], const CUtensorMap* tc,
                                            const QwArgs& p, int row0, int n0, unsigned char* buf,
                                            uint32_t buf_s, int wg, int wt) {
  static_assert(QwShape<BN>::EPI_BUFS >= 2, "a raw piece and an output piece");
  constexpr bool H = EPI == QW_H, A = EPI == QW_ACT;
  constexpr int EB = H ? 4 : EPI == QW_Q8 ? 1 : 2;  // f32 h, int8 hq, bf16 out
  const int eb = A && p.y_f32 ? 4 : EB;             // QW_ACT's f32 out
  const bool regs = A && p.y_regs;
  const int ppo = 128 / eb / QW_EPI_COLS;  // raw pieces an output piece
  unsigned char* raw = buf;
  unsigned char* out = buf + QW_EPI_BYTES;
  const int rl = wt >> 1, half = wt & 1, row = row0 + rl, sw = rl & 7;
  const bool rin = row < p.M;
  const float sr = !rin ? 0.0f : p.sa != nullptr ? __ldg(p.sa + row) : 1.0f;
  float rmax = 0.0f;
#pragma unroll 1
  for (int pc = 0; pc < BN / QW_EPI_COLS; ++pc) {
    const int c0 = n0 + QW_EPI_COLS * pc, po = pc % ppo;
    if (c0 >= p.N) break;
    // the store that read the output piece last is done with it
    if (po == 0 && wt == 0) bulk_wait_read<0>();
    qw_raw_piece<BN>(acc, pc, raw, wt);
    named_barrier(1 + wg, 128);
    // N % 16 == 0 (all but QW_ACT): the thread's 16 columns all in or all out
    const int cb = c0 + 16 * half;
    // four consecutive columns of the thread's 16, k of 4
    auto four = [&](int k) {
      const int c = cb + 4 * k;
      if (A && c >= p.N) return;  // QW_ACT's ragged N: nothing to compute or store
      const uint4 a4 =
          *reinterpret_cast<const uint4*>(raw + rl * 128 + (((4 * half + k) ^ sw) << 4));
      const int a[4] = {(int)a4.x, (int)a4.y, (int)a4.z, (int)a4.w};
      float scv[4], biv[4];
      if (!A || c + 4 <= p.N) {
        const float4 sc = __ldg(reinterpret_cast<const float4*>(p.sb + c));
        const float4 bi = __ldg(reinterpret_cast<const float4*>(p.bias + c));
        scv[0] = sc.x, scv[1] = sc.y, scv[2] = sc.z, scv[3] = sc.w;
        biv[0] = bi.x, biv[1] = bi.y, biv[2] = bi.z, biv[3] = bi.w;
      } else {  // the last columns of a ragged N
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          scv[e] = c + e < p.N ? __ldg(p.sb + c + e) : 0.0f;
          biv[e] = c + e < p.N ? __ldg(p.bias + c + e) : 0.0f;
        }
      }
      float f[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        f[e] = __fadd_rn(__fmul_rn((float)a[e], __fmul_rn(sr, scv[e])), biv[e]);
        if constexpr (H) {
          f[e] = act_rn(f[e], p.act);
          rmax = fmaxf(rmax, fabsf(f[e]));
        }
      }
      // the four values' place in the output piece (128-byte swizzled rows)
      const int off = (QW_EPI_COLS * po + 16 * half + 4 * k) * eb;
      unsigned char* dst = out + rl * 128 + (((off >> 4) ^ sw) << 4) + (off & 15);
      if constexpr (H) {
        *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
      } else if constexpr (A) {
#pragma unroll
        for (int e = 0; e < 4; ++e) f[e] = qact(f[e], p.act);
        if (regs) {  // masked stores of the thread's own values
          const size_t o = (size_t)row * p.N + c;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (c + e >= p.N) break;
            if (p.y_f32)
              static_cast<float*>(p.y)[o + e] = f[e];
            else
              static_cast<bf16*>(p.y)[o + e] = __float2bfloat16(f[e]);
          }
        } else if (p.y_f32) {
          *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
        } else {
          *reinterpret_cast<uint2*>(dst) =
              make_uint2(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]));
        }
      } else if constexpr (EPI == QW_Q8) {
        // clip(rint(act(f) * qscale)), in the order of the former int8
        // epilogue of quant.cuh's GEMM: saturated at +-127, never wrapped
        uint32_t q4 = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          q4 |= (uint32_t)(unsigned char)rint_sat(qact_scaled(f[e], p.act, p.qscale)) << (8 * e);
        *reinterpret_cast<uint32_t*>(dst) = q4;
      } else if constexpr (EPI == QW_RESID) {
        // x + bf16(f), added in f32 and rounded once (quant.cuh's order)
        const uint2 xr =
            __ldg(reinterpret_cast<const uint2*>(p.residual + (size_t)row * p.N + c));
        const float2 x01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr.x));
        const float2 x23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr.y));
        *reinterpret_cast<uint2*>(dst) =
            make_uint2(pack_bf16x2(x01.x + bf16_round(f[0]), x01.y + bf16_round(f[1])),
                       pack_bf16x2(x23.x + bf16_round(f[2]), x23.y + bf16_round(f[3])));
      } else {  // bf16(f)
        *reinterpret_cast<uint2*>(dst) =
            make_uint2(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]));
      }
    };
    if (rin && cb < p.N) {
      // QW_H rolled: unrolled, its 16 inlined activations and row maxima
      // held enough registers beside the 256-wide tile's sums that ptxas
      // spilled 8 bytes; QW_Q8 unrolled spills nothing and its W1 runs 6%
      // faster than rolled (PERF.md); QW_ACT, with QW_H's inlined
      // activations and two output kinds, rolled as QW_H
      if constexpr (H || A) {
#pragma unroll 1
        for (int k = 0; k < 4; ++k) four(k);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) four(k);
      }
    }
    fence_proxy_async();         // the output piece, before the store reads it
    named_barrier(1 + wg, 128);  // and the raw piece is read: the next may come
    if (!regs && wt == 0 &&
        (po == ppo - 1 || c0 + QW_EPI_COLS >= p.N || pc + 1 == BN / QW_EPI_COLS)) {
      tma_store_2d(tc, buf_s + QW_EPI_BYTES, c0 - QW_EPI_COLS * po, row0);
      bulk_commit();
    }
  }
  if constexpr (H) {  // the tile's row absmax of h, both halves of the row
    rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
    if (half == 0 && rin) p.parts[(size_t)(n0 / BN) * p.M + row] = rmax;
  }
}

// QW_STORE_REGS: one consumer warp's 16 x BN rows straight from the
// accumulator, masked at M and N (8-byte pairs where N is even).
template <int BN>
__device__ __forceinline__ void qw_store_regs(const uint32_t (&acc)[BN / 2], const QwArgs& p,
                                              int row0, int n0, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t4;
    if (n0 + 8 * j >= p.N) break;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = row0 + g + 8 * rr;
      if (row >= p.M || col >= p.N) continue;
      int* c = p.C + (size_t)row * p.N + col;
      const int v0 = static_cast<int>(acc[4 * j + 2 * rr]);
      const int v1 = static_cast<int>(acc[4 * j + 2 * rr + 1]);
      if ((p.N & 1) == 0) {
        *reinterpret_cast<int2*>(c) = make_int2(v0, v1);
      } else {
        c[0] = v0;
        if (col + 1 < p.N) c[1] = v1;
      }
    }
  }
}

template <int BN, int EPI>
__global__ void __launch_bounds__(QW_THREADS, 1)
    qgemm_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                       const __grid_constant__ CUtensorMap tb,
                       const __grid_constant__ CUtensorMap tc, QwArgs p) {
  using S = QwShape<BN>;
  extern __shared__ unsigned char qw_smem[];
  const uint32_t base = smem_u32(qw_smem);
  const uint32_t ring = (base + 1023u) & ~1023u;  // stage s: A at ring + s STAGE, B after it
  constexpr int STAGES = S::STAGES;
  const uint32_t epi = ring + STAGES * S::STAGE_BYTES;
  const uint32_t bars = epi + 2 * S::EPI_BUFS * QW_EPI_BYTES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_tiles = (p.N + BN - 1) / BN;
  const int tiles = (p.M + QW_BM - 1) / QW_BM * n_tiles;
  const int nk = (p.K + QW_BK - 1) / QW_BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);   // the producer's expect_tx
      mbar_init(empty(s), 8);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // Producer: ring step `it` counts the K steps of all this block's
    // tiles; it uses stage it % STAGES in round it / STAGES.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / n_tiles * QW_BM, n0 = tile % n_tiles * BN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);  // round 0 passes at once
          const uint32_t a_s = ring + s * S::STAGE_BYTES;
          mbar_expect_tx(full(s), S::STAGE_BYTES);
          tma_load_2d(a_s, &ta, full(s), kt * QW_BK, m0);
          tma_load_2d(a_s + QW_A_BYTES, &tb, full(s), kt * QW_BK, n0);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp >> 2, wt = tid & 127;
    unsigned char* buf = qw_smem + (epi - base) + wg * S::EPI_BUFS * QW_EPI_BYTES;
    const uint32_t buf_s = epi + wg * S::EPI_BUFS * QW_EPI_BYTES;
    // Frees stage s once this warp's wgmma groups that read it are done.
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    };
    auto arrive = [&](int step) {
      mbar_wait(full(step % STAGES), (step / STAGES) & 1);
    };
    uint32_t acc[BN / 2];
    int it = 0, piece = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / n_tiles * QW_BM, n0 = tile % n_tiles * BN;
#pragma unroll
      for (int x = 0; x < BN / 2; ++x) acc[x] = 0u;
      // Step kt + 1 is waited for while step kt's group, issued just
      // before, runs on the tensor cores; step kt - 1's stage is freed
      // first, so that two stages suffice.
      if (nk > 0) {
        arrive(it);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const uint32_t a_s = ring + (it % STAGES) * S::STAGE_BYTES;
          qw_issue<BN>(acc, a_s + wg * 64 * QW_BK, a_s + QW_A_BYTES);
          wgmma_wait<1>();  // the previous K step's group is done: free its stage
          reg_fence(acc);
          if (kt > 0) release((it - 1) % STAGES);
          if (kt + 1 < nk) arrive(it + 1);
        }
        wgmma_wait<0>();
        reg_fence(acc);
        release((it - 1) % STAGES);
      }
      if constexpr (EPI == QW_STORE_TMA)
        qw_store_tma<BN>(acc, &tc, p, m0 + wg * 64, n0, buf, buf_s, wg, wt, piece);
      else if constexpr (EPI == QW_STORE_REGS)
        qw_store_regs<BN>(acc, p, m0 + wg * 64 + (warp & 3) * 16, n0, lane);
      else
        qw_epilogue<BN, EPI>(acc, &tc, p, m0 + wg * 64, n0, buf, buf_s, wg, wt);
    }
    if (EPI != QW_STORE_REGS && wt == 0) bulk_wait_all();  // before the block's memory goes
  }
}

template <int BN, int EPI>
inline cudaError_t qw_enable_one() {
  return cudaFuncSetAttribute(qgemm_wgmma_kernel<BN, EPI>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)QwShape<BN>::SMEM_BYTES);
}

// Opts K13's four variants in to their shared memory, on the current device.
inline cudaError_t qgemm_wgmma_enable() {
  cudaError_t err;
  if ((err = qw_enable_one<256, QW_STORE_TMA>()) != cudaSuccess) return err;
  if ((err = qw_enable_one<256, QW_STORE_REGS>()) != cudaSuccess) return err;
  if ((err = qw_enable_one<128, QW_STORE_TMA>()) != cudaSuccess) return err;
  return qw_enable_one<128, QW_STORE_REGS>();
}

// Opts both tile widths of epilogue EPI in, on the current device.
template <int EPI>
inline cudaError_t qgemm_epi_enable() {
  cudaError_t err = qw_enable_one<256, EPI>();
  return err != cudaSuccess ? err : qw_enable_one<128, EPI>();
}

// The tile width the launch takes: 256 columns, or 128 where N fits in
// 128.  Timed both ways on the H100 (PERF.md), 256 won at every path shape
// wider than 128 columns, even the dense net's (10 000, 784) x 256, where
// its 79 tiles leave 53 SMs idle and 128-wide tiles would fill them (158);
// 128 won at the dense net's N = 10.
inline int qgemm_wgmma_tile_n(int N) { return N <= 128 ? 128 : 256; }

// Column tiles of an N-wide output: QW_H's parts a row.
inline int qgemm_wgmma_col_tiles(int N) {
  const int bn = qgemm_wgmma_tile_n(N);
  return (N + bn - 1) / bn;
}

template <int BN, int EPI>
inline cudaError_t qw_launch(const CUtensorMap& ta, const CUtensorMap& tb, const CUtensorMap& tc,
                             const QwArgs& p, int sms, cudaStream_t stream) {
  const long long tiles = (long long)((p.M + QW_BM - 1) / QW_BM) * ((p.N + BN - 1) / BN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  constexpr size_t smem = QwShape<BN>::SMEM_BYTES;
  qgemm_wgmma_kernel<BN, EPI><<<grid, QW_THREADS, smem, stream>>>(ta, tb, tc, p);
  return cudaGetLastError();
}

template <int EPI>
inline cudaError_t qw_launch_n(int bn, const CUtensorMap& ta, const CUtensorMap& tb,
                               const CUtensorMap& tc, const QwArgs& p, int sms,
                               cudaStream_t stream) {
  return bn == 256 ? qw_launch<256, EPI>(ta, tb, tc, p, sms, stream)
                   : qw_launch<128, EPI>(ta, tb, tc, p, sms, stream);
}

inline bool qw_misaligned(const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) != 0; }

// The checks every launch makes, A's and B's maps (K-major boxes of 128 k
// x 128 rows (A) or bn rows, the tile width (B)) and the SM count.
inline cudaError_t qw_prepare(const signed char* a, const signed char* bt, int M, int N, int K,
                              int bn, CUtensorMap* ta, CUtensorMap* tb, int* sms) {
  if (M < 1 || N < 1 || K < 16 || K % 16) return cudaErrorInvalidValue;
  if (qw_misaligned(a) || qw_misaligned(bt)) return cudaErrorMisalignedAddress;
  int dev = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const cuuint64_t a_dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t b_dims[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t k_strides[1] = {(cuuint64_t)K};
  const cuuint32_t a_box[2] = {QW_BK, QW_BM};
  const cuuint32_t b_box[2] = {QW_BK, (cuuint32_t)bn};
  if (!tma_encode_s8(ta, a, 2, a_dims, k_strides, a_box) ||
      !tma_encode_s8(tb, bt, 2, b_dims, k_strides, b_box))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// C = A B^T on `stream`: a (M, K) and bt (N, K) int8 row-major, c (M, N)
// int32; M, N >= 1, K >= 16 a multiple of 16, a, bt and c 16-byte aligned.
inline cudaError_t launch_qgemm_wgmma(const signed char* a, const signed char* bt, int* c, int M,
                                      int N, int K, cudaStream_t stream) {
  CUtensorMap ta, tb, tc;
  int sms = 0;
  const int bn = qgemm_wgmma_tile_n(N);
  cudaError_t err = qw_prepare(a, bt, M, N, K, bn, &ta, &tb, &sms);
  if (err != cudaSuccess) return err;
  if (qw_misaligned(c)) return cudaErrorMisalignedAddress;
  // C: 64 rows x 32 int32 columns, stored only where its row stride suits TMA
  const bool tma_store = N % 4 == 0;
  const cuuint64_t c_dims[2] = {(cuuint64_t)N, (cuuint64_t)M};
  const cuuint64_t c_strides[1] = {(cuuint64_t)N * 4};
  const cuuint32_t c_box[2] = {QW_EPI_COLS, 64};
  if (tma_store) {
    if (!tma_encode_s32(&tc, c, 2, c_dims, c_strides, c_box)) return cudaErrorInvalidValue;
  } else {
    tc = ta;  // never read
  }
  QwArgs p{};
  p.C = c;
  p.M = M;
  p.N = N;
  p.K = K;
  return tma_store ? qw_launch_n<QW_STORE_TMA>(bn, ta, tb, tc, p, sms, stream)
                   : qw_launch_n<QW_STORE_REGS>(bn, ta, tb, tc, p, sms, stream);
}

// The dequantizing GEMMs on `stream`: a (M, K) and bt (N, K) int8
// row-major into out through epilogue EPI: QW_H f32 h (M, N), QW_RESID and
// QW_BF16 bf16 (M, N), QW_Q8 int8 (M, N), QW_ACT f32 (p.y_f32) or bf16 (M,
// N); p carries M, N, K and the epilogue's operands: sa (null: a row scale
// of 1.0), sb, bias, and parts of qgemm_wgmma_col_tiles(N) x M floats
// (QW_H), the residual (QW_RESID) or act and qscale (QW_Q8; QW_H and
// QW_ACT take act too).  K a multiple of 16, N too but with QW_ACT (N >=
// 1), a, bt and out 16-byte aligned, and with QW_ACT sb and bias too.
template <int EPI>
inline cudaError_t launch_qgemm_epi(const signed char* a, const signed char* bt, void* out,
                                    const QwArgs& p, cudaStream_t stream) {
  static_assert(EPI == QW_H || EPI == QW_RESID || EPI == QW_BF16 || EPI == QW_Q8 ||
                    EPI == QW_ACT,
                "the dequantizing epilogues");
  if ((EPI != QW_ACT && p.N % 16) || p.sb == nullptr || p.bias == nullptr ||
      (EPI == QW_RESID && p.residual == nullptr) || (EPI == QW_H && p.parts == nullptr))
    return cudaErrorInvalidValue;
  if (EPI == QW_ACT && (qw_misaligned(p.sb) || qw_misaligned(p.bias)))
    return cudaErrorMisalignedAddress;
  CUtensorMap ta, tb, tc;
  int sms = 0;
  // W2's 768 columns (ViT-B) make 3 tiles of 256 a row block, 2.3 waves of
  // 300 tiles on 132 SMs at b64: 128-wide tiles even them out (PERF.md).
  // K14 (QW_ACT) too at every shape it runs: timed both ways on the H100,
  // 128 won at the per-linear route's (8208, 768) x 2304 and x 3072 by
  // 10% and 5% (the activation epilogue sets their pace, and twice the
  // tiles spread it), at its x 768 by 22%, (8208, 3072) x 768 by 12% and
  // the heads' (64, 768) x 1000 by 41%, and lost nowhere (PERF.md).
  const int bn = EPI == QW_RESID || EPI == QW_ACT ? 128 : qgemm_wgmma_tile_n(p.N);
  cudaError_t err = qw_prepare(a, bt, p.M, p.N, p.K, bn, &ta, &tb, &sms);
  if (err != cudaSuccess) return err;
  // out: 64 rows x 128 bytes a box, the staging pieces' geometry
  if (qw_misaligned(out)) return cudaErrorMisalignedAddress;
  const int eb = EPI == QW_H || (EPI == QW_ACT && p.y_f32) ? 4 : EPI == QW_Q8 ? 1 : 2;
  QwArgs q = p;
  // QW_ACT: a row stride TMA cannot take (bf16 with N % 8 != 0, f32 with N %
  // 4 != 0) is stored from the registers
  q.y_regs = EPI == QW_ACT && (p.N * eb) % 16 != 0;
  q.y = out;
  const cuuint64_t dims[2] = {(cuuint64_t)p.N, (cuuint64_t)p.M};
  const cuuint64_t strides[1] = {(cuuint64_t)p.N * eb};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / eb), 64};
  if (q.y_regs) {
    tc = ta;  // never read
  } else {
    const bool encoded =
        EPI == QW_Q8 ? tma_encode_s8(&tc, out, 2, dims, strides, box)
                     : tma_encode(&tc, eb == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                  out, 2, dims, strides, box);
    if (!encoded) return cudaErrorInvalidValue;
  }
  return qw_launch_n<EPI>(bn, ta, tb, tc, q, sms, stream);
}

}  // namespace VFT_NS
