// The bf16 GEMM of the stats-chain halves on Hopper's own units (K1's and
// K4's QKV and out-projection GEMMs in attn_half.cuh, K2's two in
// mlp_stats.cu, K5's in mlp.cu, K3's in mlp_chunk_stats.cu, K26's bf16
// product in streamed_gemm.cu, K24's in mlp_bwd.cu: three on gw_kernel,
// two in gf_kernel); include after common.cuh and hopper.cuh.
//
//   C = epilogue(prologue(A) @ B), A (M, K) and B (K, N) bf16 row-major,
//   C (M, N) bf16, f32 accumulation:
//   LN prologue  xn = bf16(((f32(x) - mu) * rstd) * ls + lb), (mu, rstd)
//                from the (M, 2) f32 stats, ls / lb per column: the order of
//                the TPU kernels (fused_mlp.py:_mlp_stats_kernel,
//                attn_block.py:_attn_stats_kernel) and of gemm_bf16's LN.
//   epilogue     f = acc + bias (f32), apply_act(f, act), y = bf16(f); with
//                a residual, out = bf16(f32(res) + f32(y)).
//   chunks       (chunk_k > 0, K3's down-projection) the K loop splits into
//                K / chunk_k chunks; at the end of each chunk the tile runs
//                the epilogue on that chunk's sum alone, out = bf16(f32(res)
//                + f32(bf16(acc [+ bias on the last chunk]))), res = the
//                residual on the first chunk and C itself (the previous
//                chunk's out) after it, and starts the next chunk from zero.
//
// The backward's products (LAYOUT, EPI template arguments; K24):
//   GW_AK_BK     B stored (N, K) row-major (K-major): C = A B^T of the
//                stored B, e.g. a data gradient dy W^T.  One TMA box of
//                64 k x 256 n a stage, read without the transpose bit.
//   GW_AM_BN     A stored (K, M) row-major (MN-major): C = A^T B of the
//                stored A, e.g. a weight gradient x^T dy summed over the
//                token rows.  Each consumer's 64 rows of a K step are one
//                64 x 64 swizzle atom (one TMA box), read through wgmma's
//                transpose bit on A; token rows past K land zero-filled.
//   GW_EPI_F32   C32 = acc in f32, stored from the accumulator registers
//                (eight lanes a 32-byte row segment).  p.splits > 1 splits
//                the K steps of every tile into that many near-equal
//                ranges, one work unit each, so that a product of few tiles
//                (a weight gradient: 72 tiles for 132 SMs) fills the card;
//                unit s writes its partial sum to C32 + s M N, and
//                launch_split_sum adds the partials in split order (no
//                atomics: the same bits from run to run).
//
// Design (one persistent block per SM walking 128 x 256 output tiles, N
// fastest): a producer warpgroup gives its registers up (setmaxnreg 40) and
// one of its threads streams each tile's K steps of 64 (one 128-byte
// swizzle row of bf16) by TMA into a ring of 4 stages, each stage a full
// and an empty mbarrier: the A box (128 rows, K-major, the layout wgmma
// reads) and four B boxes of 64 x 64, B being the weight as the model
// stores it, (K, N) row-major, i.e. MN-major, read by wgmma's transpose
// bit with the descriptor's leading offset set to the 8 KB between two
// 64-column swizzle atoms.  Two consumer warpgroups (setmaxnreg 232) take
// 64 rows each and issue wgmma.m64n256k16 on the stage.  With LN each consumer normalises its own
// 64 rows of a landed A stage in shared memory (undoing the swizzle's XOR
// to find each 16-byte chunk's columns), fences them to the async proxy and
// syncs its warpgroup; it does so one K step ahead, while the two groups
// issued before run on the tensor cores.  Rows past M and columns past K
// land zero-filled (TMA) and stay zero; stores past M or N are masked.  The
// epilogue stages each warp's bf16 results through shared memory 64
// columns at a time and writes them, and reads the residual, in 16-byte
// pieces, whole 128-byte row segments a quarter warp, while the producer
// already fills the ring with the next tile's stages.
//
// Wave counts at ViT-B/16 b64 (M = 12 800, 100 row tiles, 132 SMs): N
// 3072 1200 tiles (9.1 waves), N 2304 900 (6.8), N 768 300 (2.3, the last
// 27% full).  A 128-wide tile (600 tiles at N 768, 4.5 waves, a 6-stage
// ring) was timed against it and lost at every step of ViT-B and ViT-L
// but the out-projection, where the two were level (PERF.md §6).

#pragma once

namespace VFT_NS {

// Operand layouts: A K-major and B MN-major (the forward's); B K-major; A
// MN-major.
enum GwLayout { GW_AK_BN = 0, GW_AK_BK = 1, GW_AM_BN = 2 };
// Epilogues: bf16 with bias / act / residual; f32 (split-K partials).
enum GwEpi { GW_EPI_BF16 = 0, GW_EPI_F32 = 1 };

constexpr int GW_BM = 128;      // rows per tile: two consumer warpgroups of 64
constexpr int GW_BN = 256;      // columns per tile: four 64-column B atoms
constexpr int GW_BK = 64;       // one 128-byte swizzle row of bf16
constexpr int GW_STAGES = 4;    // ring depth
constexpr int GW_THREADS = 384;  // two consumer warpgroups and the producer's
constexpr uint32_t GW_A_BYTES = GW_BM * GW_BK * 2;     // 16 KB
constexpr uint32_t GW_ATOM_BYTES = 64 * GW_BK * 2;     // one 64 x 64 B box: 8 KB
constexpr uint32_t GW_STAGE_BYTES = GW_A_BYTES + (GW_BN / 64) * GW_ATOM_BYTES;  // 48 KB
constexpr int GW_EPI_LD = 72;                          // bf16 a row of a staging tile
constexpr uint32_t GW_EPI_BYTES = 16 * GW_EPI_LD * 2;  // a consumer warp's 16 x 64 tile
// 1024 bytes of slack to align the ring to the swizzle's 1 KB period, the
// stages, the barriers, then the consumer warps' epilogue staging tiles.
constexpr size_t GW_SMEM_BYTES =
    1024 + GW_STAGES * GW_STAGE_BYTES + 16 * GW_STAGES + 8 * GW_EPI_BYTES;

struct GwArgs {
  const float* stats;      // (M, 2) f32 (mu, rstd); LN only
  const float* ln_scale;   // (K,) f32; LN only
  const float* ln_bias;    // (K,) f32; LN only
  const float* bias;       // (N,) f32 or null
  const bf16* residual;    // (M, N) bf16 or null
  bf16* C;                 // (M, N) bf16
  int M, N, K;
  int act;                 // an Act code
  int chunk_k;             // K extent of a chunk (a multiple of 32); 0: one chunk
  float* C32;              // GW_EPI_F32: (splits, M, N) f32
  int splits;              // GW_EPI_F32: K ranges a tile is split into (>= 1)
};

// This thread's four 16-byte chunks of its warpgroup's 64 rows in a landed
// A stage (rows lr0 + 16 i at `rows`, physical chunk pc; ls / lb the
// chunk's 8 columns): xn = bf16(((x - mu) * rstd) * ls + lb) in place.
// Rows past M (valid_rows) are skipped; a chunk at or past K is never
// passed here and stays as TMA filled it (zero).
__device__ __forceinline__ void gw_ln_stage(unsigned char* rows, int pc, const float (&mu)[4],
                                            const float (&rs)[4], int valid_rows,
                                            const float* ls, const float* lb) {
  const float4 sc0 = __ldg(reinterpret_cast<const float4*>(ls));
  const float4 sc1 = __ldg(reinterpret_cast<const float4*>(ls + 4));
  const float4 bi0 = __ldg(reinterpret_cast<const float4*>(lb));
  const float4 bi1 = __ldg(reinterpret_cast<const float4*>(lb + 4));
  const float sc[8] = {sc0.x, sc0.y, sc0.z, sc0.w, sc1.x, sc1.y, sc1.z, sc1.w};
  const float bi[8] = {bi0.x, bi0.y, bi0.z, bi0.w, bi1.x, bi1.y, bi1.z, bi1.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i >= valid_rows) break;
    uint4* ptr = reinterpret_cast<uint4*>(rows + i * 16 * 128 + pc * 16);
    uint4 v = *ptr;
    __nv_bfloat162* pv = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float2 x = __bfloat1622float2(pv[t]);
      pv[t] = __floats2bfloat162_rn(((x.x - mu[i]) * rs[i]) * sc[2 * t] + bi[2 * t],
                                    ((x.y - mu[i]) * rs[i]) * sc[2 * t + 1] + bi[2 * t + 1]);
    }
    *ptr = v;
  }
}

// The epilogue of one consumer warp, 64 columns at a time: each thread's
// accumulator pairs (rows g and g + 8 of the warp's 16, columns 8 j + 2 t4
// (+1) of each 8-column block j; acc[4 j + 2 rr + e] is row g + 8 rr,
// column 8 j + 2 t4 + e) become y = bf16(act(acc + bias)) in the warp's
// 16 x 64 staging tile (rows 144 bytes apart: no bank conflicts), then the
// warp moves the tile out in 16-byte pieces, eight lanes a 128-byte row
// segment, adding the residual's matching piece: out = bf16(f32(res) +
// f32(y)).  The residual pieces are loaded first, so that their latency
// overlaps the activations.
//
// With residual == p.C (a later chunk of K3's down-projection) the tile adds
// to the out it wrote at the previous chunk boundary in place: each lane
// loads its four residual pieces before it writes the same four pieces, and
// no other lane, warp or block touches them (the tile, its warp's 16 rows
// and the piece -> lane map are fixed), so every read sees this lane's own
// earlier store, in program order.
template <int ACT>
__device__ __forceinline__ void gw_store(const float (&acc)[GW_BN / 2], const GwArgs& p,
                                         int row0, int n0, bf16* stage, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int cc = 0; cc < GW_BN / 64; ++cc) {  // 64-column chunks
    const int col0 = n0 + 64 * cc;
    if (col0 >= p.N) break;
    // piece c = lane + 32 i of the tile: row c / 8, 8 columns from 8 (c % 8)
    uint4 res[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = lane + 32 * i, row = row0 + c / 8, col = col0 + 8 * (c % 8);
      res[i] = p.residual != nullptr && row < p.M && col < p.N
                   ? *reinterpret_cast<const uint4*>(p.residual + (size_t)row * p.N + col)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
    float2 bi[8];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = col0 + 8 * jj + 2 * t4;  // N is a multiple of 8: col < N covers col + 1
      bi[jj] = p.bias != nullptr && col < p.N
                   ? __ldg(reinterpret_cast<const float2*>(p.bias + col))
                   : make_float2(0.0f, 0.0f);
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = 8 * cc + jj;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8 * rr) * GW_EPI_LD + 8 * jj + 2 * t4) =
            __floats2bfloat162_rn(apply_act(acc[4 * j + 2 * rr] + bi[jj].x, ACT),
                                  apply_act(acc[4 * j + 2 * rr + 1] + bi[jj].y, ACT));
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = lane + 32 * i, row = row0 + c / 8, col = col0 + 8 * (c % 8);
      if (row >= p.M || col >= p.N) continue;
      uint4 y = *reinterpret_cast<const uint4*>(stage + (c / 8) * GW_EPI_LD + 8 * (c % 8));
      if (p.residual != nullptr) {
        float f[8], r[8];
        unpack8(y, f);  // the residual adds the bf16-rounded product
        unpack8(res[i], r);
#pragma unroll
        for (int t = 0; t < 8; ++t) f[t] = r[t] + f[t];
        y = pack8(f);
      }
      *reinterpret_cast<uint4*>(p.C + (size_t)row * p.N + col) = y;
    }
    __syncwarp();  // the next chunk reuses the staging tile
  }
}

// GW_EPI_F32: the accumulator pairs of one consumer warp straight into
// C32's split `ks` (rows g and g + 8 of the warp's 16, columns 8 j + 2 t4,
// + 1: eight lanes a 32-byte row segment).
__device__ __forceinline__ void gw_store_f32(const float (&acc)[GW_BN / 2], const GwArgs& p,
                                             int row0, int n0, int ks, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
  float* c = p.C32 + (size_t)ks * p.M * p.N;
#pragma unroll
  for (int j = 0; j < GW_BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * t4;
    if (n0 + 8 * j >= p.N) break;  // N is a multiple of 8
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = row0 + g + 8 * rr;
      if (row < p.M)
        *reinterpret_cast<float2*>(c + (size_t)row * p.N + col) =
            make_float2(acc[4 * j + 2 * rr], acc[4 * j + 2 * rr + 1]);
    }
  }
}

// Issues acc += A_stage B_stage over one K step of 64 as one wgmma group;
// KK0 / KK1 take the k16 slices [KK0, KK1) of the step only (a chunk of
// K3's down-projection that ends 32 columns into the step).  a_s is the
// consumer's 64 rows of the A stage, b_s the B stage.
template <int KK0 = 0, int KK1 = GW_BK / 16, int LAYOUT = GW_AK_BN>
__device__ __forceinline__ void gw_issue(float (&acc)[GW_BN / 2], uint32_t a_s, uint32_t b_s) {
  const uint64_t da = sw128_desc(a_s);
  const uint64_t db = LAYOUT == GW_AK_BK ? sw128_desc(b_s) : sw128_desc(b_s, GW_ATOM_BYTES);
  reg_fence(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = KK0; kk < KK1; ++kk) {
    // K-major: 32 bytes further along the swizzled rows; MN-major: 16 rows
    // (2 KB) down
    if constexpr (LAYOUT == GW_AK_BN)
      wgmma_m64n256k16_ss<0, 1>(acc, da + 2 * kk, db + 128 * kk);
    else if constexpr (LAYOUT == GW_AK_BK)
      wgmma_m64n256k16_ss<0, 0>(acc, da + 2 * kk, db + 2 * kk);
    else
      wgmma_m64n256k16_ss<1, 1>(acc, da + 128 * kk, db + 128 * kk);
  }
  wgmma_commit();
}

// CHUNKED: K3's down-projection (p.chunk_k > 0, no LN, ACT_NONE).  LAYOUT
// and EPI: the backward's products (GwLayout, GwEpi); LN takes GW_AK_BN.
template <bool LN, bool CHUNKED = false, int LAYOUT = GW_AK_BN, int EPI = GW_EPI_BF16>
__global__ void __launch_bounds__(GW_THREADS, 1)
    gw_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
              GwArgs p) {
  static_assert(!LN || (LAYOUT == GW_AK_BN && EPI == GW_EPI_BF16), "LN takes a K-major A");
  static_assert(!CHUNKED || (LAYOUT == GW_AK_BN && EPI == GW_EPI_BF16), "K3's layout only");
  extern __shared__ unsigned char gw_smem[];
  const uint32_t base = smem_u32(gw_smem);
  const uint32_t ring = (base + 1023u) & ~1023u;  // stage s: A at ring + s STAGE, B after it
  unsigned char* ring_g = gw_smem + (ring - base);
  const uint32_t bars = ring + GW_STAGES * GW_STAGE_BYTES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (GW_STAGES + s); };
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_tiles = (p.N + GW_BN - 1) / GW_BN;
  const int tiles = (p.M + GW_BM - 1) / GW_BM * n_tiles;
  const int nk = (p.K + GW_BK - 1) / GW_BK;
  // A work unit is one tile's K steps [kb, ke): split `ks` of `splits`
  // (GW_EPI_F32; every other variant takes a whole tile a unit).
  const int splits = EPI == GW_EPI_F32 ? p.splits : 1;
  const int units = tiles * splits;

  if (tid == 0) {
    for (int s = 0; s < GW_STAGES; ++s) {
      mbar_init(full(s), 1);   // the producer's expect_tx
      mbar_init(empty(s), 8);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // Producer: ring step `it` counts the K steps of all this block's
    // units; it uses stage it % GW_STAGES in round it / GW_STAGES.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      int it = 0;
      for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
        const int tile = unit / splits, ks = unit % splits;
        const int m0 = tile / n_tiles * GW_BM, n0 = tile % n_tiles * GW_BN;
        const int kb = ks * nk / splits, ke = (ks + 1) * nk / splits;
        for (int kt = kb; kt < ke; ++kt, ++it) {
          const int s = it % GW_STAGES;
          mbar_wait(empty(s), ((it / GW_STAGES) & 1) ^ 1);  // round 0 passes at once
          const uint32_t a_s = ring + s * GW_STAGE_BYTES;
          mbar_expect_tx(full(s), GW_STAGE_BYTES);
          if constexpr (LAYOUT == GW_AM_BN) {  // each consumer's 64 rows: one atom
            tma_load_2d(a_s, &ta, full(s), m0, kt * GW_BK);
            tma_load_2d(a_s + GW_ATOM_BYTES, &ta, full(s), m0 + 64, kt * GW_BK);
          } else {
            tma_load_2d(a_s, &ta, full(s), kt * GW_BK, m0);
          }
          if constexpr (LAYOUT == GW_AK_BK) {  // 256 rows of 64 k: one box
            tma_load_2d(a_s + GW_A_BYTES, &tb, full(s), kt * GW_BK, n0);
          } else {
#pragma unroll
            for (int j = 0; j < GW_BN / 64; ++j)
              tma_load_2d(a_s + GW_A_BYTES + j * GW_ATOM_BYTES, &tb, full(s), n0 + 64 * j,
                          kt * GW_BK);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp >> 2, wt = tid & 127;
    bf16* stage = reinterpret_cast<bf16*>(ring_g + GW_STAGES * GW_STAGE_BYTES + 16 * GW_STAGES) +
                  warp * (GW_EPI_BYTES / 2);
    // LN: this thread's rows lr0 + 16 i of the warpgroup's 64 and its
    // physical 16-byte chunk pc of each, whose columns are those of the
    // logical chunk pc ^ (row % 8) (the 128-byte swizzle).
    const int lr0 = wt >> 3, pc = wt & 7, lc = pc ^ (lr0 & 7);
    // Waits for ring step `step` (K step kt of a tile) to land and, with
    // LN, normalises this warpgroup's rows of it, fences them to the async
    // proxy and syncs the warpgroup: then its wgmma may read them.
    auto arrive_step = [&](int step, int kt, const float (&mu)[4], const float (&rs)[4],
                           int valid_rows) {
      const int s = step % GW_STAGES, k = kt * GW_BK + 8 * lc;
      mbar_wait(full(s), (step / GW_STAGES) & 1);
      if (LN) {
        if (k < p.K)  // K is a multiple of 8: the whole chunk
          gw_ln_stage(ring_g + s * GW_STAGE_BYTES + (wg * 64 + lr0) * 128, pc, mu, rs,
                      valid_rows, p.ln_scale + k, p.ln_bias + k);
        fence_proxy_async();
        named_barrier(1 + wg, 128);
      }
    };
    // Frees stage s once this warp's wgmma groups that read it are done.
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    };
    float acc[GW_BN / 2];
    int it = 0;
    for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
      const int tile = unit / splits, ks = unit % splits;
      const int m0 = tile / n_tiles * GW_BM, n0 = tile % n_tiles * GW_BN;
      const int kb = ks * nk / splits, ke = (ks + 1) * nk / splits;
      float mu[4] = {0.0f, 0.0f, 0.0f, 0.0f}, rs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      int valid_rows = 0;  // of this thread's four LN rows, those before M
      if (LN) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = m0 + wg * 64 + lr0 + 16 * i;
          if (row < p.M) {
            const float2 st = __ldg(reinterpret_cast<const float2*>(p.stats) + row);
            mu[i] = st.x;
            rs[i] = st.y;
            valid_rows = i + 1;
          }
        }
      }
#pragma unroll
      for (int x = 0; x < GW_BN / 2; ++x) acc[x] = 0.0f;
      if constexpr (CHUNKED) {
        const int row0 = m0 + wg * 64 + (warp & 3) * 16;
        // K3's down-projection: the chunk ending at K column chunk_end
        // (< K: a boundary inside the loop; the last chunk ends with the
        // tile) adds to q.residual, the residual on the first chunk and C
        // (the out this tile wrote at the previous boundary) after it.
        GwArgs q = p;
        q.bias = nullptr;  // b2 rides the last chunk only
        int chunk_end = p.chunk_k;
        // Ends the current chunk once its wgmma groups are done: its sum
        // alone through the epilogue into C, then the next chunk from zero.
        auto end_chunk = [&]() {
          gw_store<ACT_NONE>(acc, q, row0, n0, stage, lane);
#pragma unroll
          for (int x = 0; x < GW_BN / 2; ++x) acc[x] = 0.0f;
          q.residual = p.C;
          chunk_end += p.chunk_k;
        };
        arrive_step(it, 0, mu, rs, valid_rows);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const uint32_t a_s = ring + (it % GW_STAGES) * GW_STAGE_BYTES;
          bool released = false;
          if (chunk_end == kt * GW_BK + 32 && chunk_end < p.K) {
            // a chunk ends 32 columns into this step: its first two k16
            // slices close it, the last two open the next one
            gw_issue<0, 2>(acc, a_s + wg * 64 * 128, a_s + GW_A_BYTES);
            wgmma_wait<0>();
            reg_fence(acc);
            if (kt > 0) release((it - 1) % GW_STAGES);
            released = true;
            end_chunk();
            gw_issue<2, 4>(acc, a_s + wg * 64 * 128, a_s + GW_A_BYTES);
          } else {
            gw_issue(acc, a_s + wg * 64 * 128, a_s + GW_A_BYTES);
          }
          if (kt + 1 < nk) arrive_step(it + 1, kt + 1, mu, rs, valid_rows);
          wgmma_wait<1>();
          reg_fence(acc);
          if (kt > 0 && !released) release((it - 1) % GW_STAGES);
          if (chunk_end == (kt + 1) * GW_BK && chunk_end < p.K) {
            wgmma_wait<0>();  // a chunk ends with this step
            reg_fence(acc);
            end_chunk();
          }
        }
        wgmma_wait<0>();
        reg_fence(acc);
        release((it - 1) % GW_STAGES);
        q.bias = p.bias;
        gw_store<ACT_NONE>(acc, q, row0, n0, stage, lane);
        continue;
      }
      // Step kt + 1 is waited for (and normalised) while step kt's group,
      // issued just before, and step kt - 1's run on the tensor cores.
      arrive_step(it, kb, mu, rs, valid_rows);
      for (int kt = kb; kt < ke; ++kt, ++it) {
        const uint32_t a_s = ring + (it % GW_STAGES) * GW_STAGE_BYTES;
        gw_issue<0, GW_BK / 16, LAYOUT>(acc, a_s + wg * 64 * 128, a_s + GW_A_BYTES);
        if (kt + 1 < ke) arrive_step(it + 1, kt + 1, mu, rs, valid_rows);
        wgmma_wait<1>();  // the previous K step's group is done: free its stage
        reg_fence(acc);
        if (kt > kb) release((it - 1) % GW_STAGES);
      }
      wgmma_wait<0>();
      reg_fence(acc);
      release((it - 1) % GW_STAGES);

      const int row0 = m0 + wg * 64 + (warp & 3) * 16;
      if constexpr (EPI == GW_EPI_F32) {
        gw_store_f32(acc, p, row0, n0, ks, lane);
        continue;
      }
      switch (p.act) {
        case ACT_GELU: gw_store<ACT_GELU>(acc, p, row0, n0, stage, lane); break;
        case ACT_GELU_TANH: gw_store<ACT_GELU_TANH>(acc, p, row0, n0, stage, lane); break;
        case ACT_QUICK_GELU: gw_store<ACT_QUICK_GELU>(acc, p, row0, n0, stage, lane); break;
        case ACT_RELU: gw_store<ACT_RELU>(acc, p, row0, n0, stage, lane); break;
        default: gw_store<ACT_NONE>(acc, p, row0, n0, stage, lane);
      }
    }
  }
}

// Opts the three forward variants in to their shared memory, on the current
// device.
inline cudaError_t gw_enable() {
  cudaError_t err = cudaFuncSetAttribute(
      gw_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)GW_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(gw_kernel<false, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)GW_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(gw_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)GW_SMEM_BYTES);
}

// Opts one backward variant (no LN, no chunks) in to its shared memory.
template <int LAYOUT, int EPI>
inline cudaError_t gw_enable_bwd() {
  return cudaFuncSetAttribute(gw_kernel<false, false, LAYOUT, EPI>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)GW_SMEM_BYTES);
}

// Splits for a GW_EPI_F32 product of `tiles` tiles and nk K steps on `sms`
// SMs: enough units for about four waves, at least four K steps a unit.
inline int gw_splits(long long tiles, int nk, int sms) {
  long long s = (4LL * sms + tiles - 1) / tiles;
  if (s > nk / 4) s = nk / 4;
  return s < 1 ? 1 : (int)s;
}

// C = epilogue(prologue(A) @ B) on `stream`; ln picks the LN prologue (p's
// stats, ln_scale and ln_bias then non-null).  A, B, C, the residual, bias,
// ln_scale and ln_bias must be 16-byte aligned, stats 8-byte, and N and K
// multiples of 8 (TMA's 16-byte strides).  p.chunk_k > 0 (no LN, ACT_NONE)
// splits K into chunks of that many columns, a multiple of 32 dividing K.
// LAYOUT GW_AK_BK reads B stored (N, K), GW_AM_BN A stored (K, M) (M then
// a multiple of 8 too); EPI GW_EPI_F32 writes p.C32 (p.splits K ranges,
// 1 <= splits <= the K steps; no bias, act or residual).
template <int LAYOUT = GW_AK_BN, int EPI = GW_EPI_BF16>
inline cudaError_t launch_gemm_wgmma(const bf16* A, const bf16* B, bool ln, const GwArgs& p,
                                     cudaStream_t stream) {
  const bool fwd = LAYOUT == GW_AK_BN && EPI == GW_EPI_BF16;
  const int k_steps = (p.K + GW_BK - 1) / GW_BK;
  if (p.M < 1 || p.N < 8 || p.K < 8 || p.N % 8 || p.K % 8 ||
      (EPI != GW_EPI_F32 && p.C == nullptr) ||
      (ln && (!fwd || p.stats == nullptr || p.ln_scale == nullptr || p.ln_bias == nullptr)) ||
      p.chunk_k < 0 ||
      (p.chunk_k > 0 && (!fwd || ln || p.act != ACT_NONE || p.chunk_k % 32 || p.K % p.chunk_k)) ||
      (LAYOUT == GW_AM_BN && p.M % 8) ||
      (EPI == GW_EPI_F32 && (p.C32 == nullptr || p.splits < 1 || p.splits > k_steps ||
                             p.bias != nullptr || p.residual != nullptr || p.act != ACT_NONE)))
    return cudaErrorInvalidValue;
  auto misaligned = [](const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) != 0; };
  if (misaligned(A) || misaligned(B) || (p.C != nullptr && misaligned(p.C)) ||
      (p.residual != nullptr && misaligned(p.residual)) ||
      (p.bias != nullptr && misaligned(p.bias)) ||
      (ln && (misaligned(p.ln_scale) || misaligned(p.ln_bias) ||
              (reinterpret_cast<uintptr_t>(p.stats) & 7) != 0)) ||
      (EPI == GW_EPI_F32 && misaligned(p.C32)))
    return cudaErrorMisalignedAddress;
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  CUtensorMap ta, tb;
  // A: (M, K) K-major in boxes of 128 rows, or (K, M) MN-major in 64 x 64
  // boxes; B: (K, N) MN-major in 64 x 64 boxes, or (N, K) K-major in boxes
  // of 256 rows.
  const bool am = LAYOUT == GW_AM_BN, bk = LAYOUT == GW_AK_BK;
  const cuuint64_t a_dims[2] = {(cuuint64_t)(am ? p.M : p.K), (cuuint64_t)(am ? p.K : p.M)};
  const cuuint64_t a_strides[1] = {(cuuint64_t)a_dims[0] * 2};
  const cuuint32_t a_box[2] = {GW_BK, am ? 64u : (cuuint32_t)GW_BM};
  const cuuint64_t b_dims[2] = {(cuuint64_t)(bk ? p.K : p.N), (cuuint64_t)(bk ? p.N : p.K)};
  const cuuint64_t b_strides[1] = {(cuuint64_t)b_dims[0] * 2};
  const cuuint32_t b_box[2] = {64, bk ? (cuuint32_t)GW_BN : (cuuint32_t)GW_BK};
  if (!tma_encode_bf16(&ta, A, 2, a_dims, a_strides, a_box) ||
      !tma_encode_bf16(&tb, B, 2, b_dims, b_strides, b_box))
    return cudaErrorInvalidValue;
  const long long tiles = (long long)((p.M + GW_BM - 1) / GW_BM) * ((p.N + GW_BN - 1) / GW_BN);
  const long long units = tiles * (EPI == GW_EPI_F32 ? p.splits : 1);
  const int grid = (int)(units < sms ? units : sms);
  if constexpr (LAYOUT != GW_AK_BN || EPI != GW_EPI_BF16)
    gw_kernel<false, false, LAYOUT, EPI><<<grid, GW_THREADS, GW_SMEM_BYTES, stream>>>(ta, tb, p);
  else if (ln)
    gw_kernel<true><<<grid, GW_THREADS, GW_SMEM_BYTES, stream>>>(ta, tb, p);
  else if (p.chunk_k > 0)
    gw_kernel<false, true><<<grid, GW_THREADS, GW_SMEM_BYTES, stream>>>(ta, tb, p);
  else
    gw_kernel<false><<<grid, GW_THREADS, GW_SMEM_BYTES, stream>>>(ta, tb, p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// gf_kernel, K24's steps (b) and (c) (mlp_bwd.cu) on one 128 x 128 tile of
// (T, M), so that the (T, M) f32 da never reaches device memory: each
// consumer warpgroup holds da = g W2^T (W2 read K-major) and h = xn W1 (W1
// MN-major, through the transpose bit) for its 64 rows, 64 + 64 f32
// registers, over the same 64-deep K steps of a 64 KB stage (g, xn, W2 and
// W1 boxes, 3 stages), gw_kernel's producer / consumer ring with
// wgmma.m64n128k16; then the epilogue writes a = bf16(act(h + b1)) and dh =
// bf16(da * act'(h + b1)) and col_partials[r * M + n] = the f32 sum of da *
// act'(h + b1) over rows 64 r .. 64 r + 63 (shuffles over a warp's 16
// rows, then the warpgroup's four warps in order through shared memory).
// ---------------------------------------------------------------------------

constexpr int GF_COLSUM_ROWS = 64;  // rows of one column-sum partial

constexpr int GF_BN = 128;                             // columns per tile
constexpr int GF_STAGES = 3;
constexpr uint32_t GF_BOX_BYTES = 128 * GW_BK * 2;     // a 128 x 64 box: 16 KB
constexpr uint32_t GF_STAGE_BYTES = 4 * GF_BOX_BYTES;  // g, xn, W2, W1: 64 KB
constexpr size_t GF_SMEM_BYTES =
    1024 + GF_STAGES * GF_STAGE_BYTES + 16 * GF_STAGES + 8 * GW_EPI_BYTES;

struct GfArgs {
  const float* bias;     // b1 (N,) f32
  bf16* a;               // (M, N) bf16(act(h))
  bf16* dh;              // (M, N) bf16(da * act'(h))
  float* col_partials;   // (ceil(M / 64), N) f32
  int M, N, K;           // M token rows, N hidden units, K the model width
  int act;               // an Act code
};

// One consumer warp's epilogue, 32 columns at a time: h = acc_h + b1, a =
// bf16(act(h)), dh = da * act'(h) (f32), bf16(dh); each column's f32 sum
// of dh over the warp's 16 rows (its two rows, then a fixed xor tree over
// the lanes of one t4) lands in `part` (128 floats).  Rows past M add
// nothing.
template <int ACT>
__device__ __forceinline__ void gf_store(const float (&da)[GF_BN / 2], const float (&hacc)[GF_BN / 2],
                                         const GfArgs& p, int row0, int n0, float* part,
                                         int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int cc = 0; cc < GF_BN / 32; ++cc) {
    if (n0 + 32 * cc >= p.N) break;
    float2 bi[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = n0 + 32 * cc + 8 * jj + 2 * t4;  // col < N covers col + 1
      bi[jj] = col < p.N ? __ldg(reinterpret_cast<const float2*>(p.bias + col))
                         : make_float2(0.0f, 0.0f);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = 4 * cc + jj, col = n0 + 8 * j + 2 * t4;
      float cs0 = 0.0f, cs1 = 0.0f;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = row0 + g + 8 * rr, x = 4 * j + 2 * rr;
        float a0, d0, a1, d1;
        act_and_grad(hacc[x] + bi[jj].x, ACT, a0, d0);
        act_and_grad(hacc[x + 1] + bi[jj].y, ACT, a1, d1);
        const float dh0 = da[x] * d0, dh1 = da[x + 1] * d1;
        if (row < p.M && col < p.N) {
          const size_t off = (size_t)row * p.N + col;
          *reinterpret_cast<__nv_bfloat162*>(p.a + off) = __floats2bfloat162_rn(a0, a1);
          *reinterpret_cast<__nv_bfloat162*>(p.dh + off) = __floats2bfloat162_rn(dh0, dh1);
          cs0 += dh0;
          cs1 += dh1;
        }
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        cs0 += __shfl_xor_sync(0xffffffffu, cs0, o);
        cs1 += __shfl_xor_sync(0xffffffffu, cs1, o);
      }
      if (g == 0) *reinterpret_cast<float2*>(part + 8 * j + 2 * t4) = make_float2(cs0, cs1);
    }
  }
}

// tg, txn: g and xn (M, K) in 128-row boxes; tw2: W2 (N, K) in 128-row
// boxes (K-major); tw1: W1 (K, N) in 64 x 64 boxes (MN-major).
__global__ void __launch_bounds__(GW_THREADS, 1)
    gf_kernel(const __grid_constant__ CUtensorMap tg, const __grid_constant__ CUtensorMap txn,
              const __grid_constant__ CUtensorMap tw2, const __grid_constant__ CUtensorMap tw1,
              GfArgs p) {
  extern __shared__ unsigned char gf_smem[];
  const uint32_t base = smem_u32(gf_smem);
  const uint32_t ring = (base + 1023u) & ~1023u;  // stage s: g, xn, W2, W1 boxes
  unsigned char* ring_g = gf_smem + (ring - base);
  const uint32_t bars = ring + GF_STAGES * GF_STAGE_BYTES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (GF_STAGES + s); };
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_tiles = (p.N + GF_BN - 1) / GF_BN;
  const int tiles = (p.M + GW_BM - 1) / GW_BM * n_tiles;
  const int nk = (p.K + GW_BK - 1) / GW_BK;

  if (tid == 0) {
    for (int s = 0; s < GF_STAGES; ++s) {
      mbar_init(full(s), 1);   // the producer's expect_tx
      mbar_init(empty(s), 8);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / n_tiles * GW_BM, n0 = tile % n_tiles * GF_BN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % GF_STAGES;
          mbar_wait(empty(s), ((it / GF_STAGES) & 1) ^ 1);  // round 0 passes at once
          const uint32_t st = ring + s * GF_STAGE_BYTES;
          mbar_expect_tx(full(s), GF_STAGE_BYTES);
          tma_load_2d(st, &tg, full(s), kt * GW_BK, m0);
          tma_load_2d(st + GF_BOX_BYTES, &txn, full(s), kt * GW_BK, m0);
          tma_load_2d(st + 2 * GF_BOX_BYTES, &tw2, full(s), kt * GW_BK, n0);
          tma_load_2d(st + 3 * GF_BOX_BYTES, &tw1, full(s), n0, kt * GW_BK);
          tma_load_2d(st + 3 * GF_BOX_BYTES + GW_ATOM_BYTES, &tw1, full(s), n0 + 64, kt * GW_BK);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp >> 2, wt = tid & 127;
    float* part = reinterpret_cast<float*>(ring_g + GF_STAGES * GF_STAGE_BYTES + 16 * GF_STAGES +
                                           warp * GW_EPI_BYTES);
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    };
    float da[GF_BN / 2], hacc[GF_BN / 2];
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / n_tiles * GW_BM, n0 = tile % n_tiles * GF_BN;
#pragma unroll
      for (int x = 0; x < GF_BN / 2; ++x) da[x] = hacc[x] = 0.0f;
      mbar_wait(full(it % GF_STAGES), (it / GF_STAGES) & 1);
      for (int kt = 0; kt < nk; ++kt, ++it) {
        // Both products of step kt as one wgmma group: A 32 bytes along
        // the swizzled rows a k16 slice; W2 (K-major) likewise, W1
        // (MN-major) 16 rows (2 KB) down.
        const uint32_t st = ring + (it % GF_STAGES) * GF_STAGE_BYTES;
        const uint64_t dg = sw128_desc(st + wg * 64 * 128);
        const uint64_t dx = sw128_desc(st + GF_BOX_BYTES + wg * 64 * 128);
        const uint64_t dw2 = sw128_desc(st + 2 * GF_BOX_BYTES);
        const uint64_t dw1 = sw128_desc(st + 3 * GF_BOX_BYTES, GW_ATOM_BYTES);
        reg_fence(da);
        reg_fence(hacc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < GW_BK / 16; ++kk) {
          wgmma_m64n128k16_ss<0>(da, dg + 2 * kk, dw2 + 2 * kk, 1);
          wgmma_m64n128k16_ss<1>(hacc, dx + 2 * kk, dw1 + 128 * kk, 1);
        }
        wgmma_commit();
        if (kt + 1 < nk) mbar_wait(full((it + 1) % GF_STAGES), ((it + 1) / GF_STAGES) & 1);
        wgmma_wait<1>();  // the previous K step's group is done: free its stage
        reg_fence(da);
        reg_fence(hacc);
        if (kt > 0) release((it - 1) % GF_STAGES);
      }
      wgmma_wait<0>();
      reg_fence(da);
      reg_fence(hacc);
      release((it - 1) % GF_STAGES);

      // The tile's epilogue; then thread wt of the warpgroup adds column wt
      // over its four warps, in order, into the 64-row block's partial.
      const int row0 = m0 + wg * 64 + (warp & 3) * 16;
      switch (p.act) {
        case ACT_GELU: gf_store<ACT_GELU>(da, hacc, p, row0, n0, part, lane); break;
        case ACT_GELU_TANH: gf_store<ACT_GELU_TANH>(da, hacc, p, row0, n0, part, lane); break;
        case ACT_QUICK_GELU: gf_store<ACT_QUICK_GELU>(da, hacc, p, row0, n0, part, lane); break;
        case ACT_RELU: gf_store<ACT_RELU>(da, hacc, p, row0, n0, part, lane); break;
        default: gf_store<ACT_NONE>(da, hacc, p, row0, n0, part, lane);
      }
      named_barrier(1 + wg, 128);
      const int rb = (m0 + wg * 64) / GF_COLSUM_ROWS;
      if (rb * GF_COLSUM_ROWS < p.M && n0 + wt < p.N) {
        const float* parts = part - (warp & 3) * (GW_EPI_BYTES / 4);
        float v = parts[wt];
#pragma unroll
        for (int w = 1; w < 4; ++w) v += parts[w * (GW_EPI_BYTES / 4) + wt];
        p.col_partials[(size_t)rb * p.N + n0 + wt] = v;
      }
      named_barrier(1 + wg, 128);  // the partials' room is free again
    }
  }
}

inline cudaError_t gf_enable() {
  return cudaFuncSetAttribute(gf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)GF_SMEM_BYTES);
}

// gf_kernel on `stream`: g, xn (M, K), w2 (N, K), w1 (K, N) bf16 row-major;
// M >= 1, N and K multiples of 8, every pointer 16-byte aligned.
inline cudaError_t launch_act_bwd_fused(const bf16* g, const bf16* xn, const bf16* w2,
                                        const bf16* w1, const GfArgs& p, cudaStream_t stream) {
  if (p.M < 1 || p.N < 8 || p.K < 8 || p.N % 8 || p.K % 8 || p.bias == nullptr ||
      p.a == nullptr || p.dh == nullptr || p.col_partials == nullptr)
    return cudaErrorInvalidValue;
  auto misaligned = [](const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) != 0; };
  if (misaligned(g) || misaligned(xn) || misaligned(w2) || misaligned(w1) ||
      misaligned(p.bias) || misaligned(p.a) || misaligned(p.dh))
    return cudaErrorMisalignedAddress;
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  CUtensorMap tg, txn, tw2, tw1;
  const cuuint64_t rows_dims[2] = {(cuuint64_t)p.K, (cuuint64_t)p.M};
  const cuuint64_t w2_dims[2] = {(cuuint64_t)p.K, (cuuint64_t)p.N};
  const cuuint64_t k_strides[1] = {(cuuint64_t)p.K * 2};
  const cuuint32_t k_box[2] = {GW_BK, 128};
  const cuuint64_t w1_dims[2] = {(cuuint64_t)p.N, (cuuint64_t)p.K};
  const cuuint64_t w1_strides[1] = {(cuuint64_t)p.N * 2};
  const cuuint32_t w1_box[2] = {64, GW_BK};
  if (!tma_encode_bf16(&tg, g, 2, rows_dims, k_strides, k_box) ||
      !tma_encode_bf16(&txn, xn, 2, rows_dims, k_strides, k_box) ||
      !tma_encode_bf16(&tw2, w2, 2, w2_dims, k_strides, k_box) ||
      !tma_encode_bf16(&tw1, w1, 2, w1_dims, w1_strides, w1_box))
    return cudaErrorInvalidValue;
  const long long tiles = (long long)((p.M + GW_BM - 1) / GW_BM) * ((p.N + GF_BN - 1) / GF_BN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  gf_kernel<<<grid, GW_THREADS, GF_SMEM_BYTES, stream>>>(tg, txn, tw2, tw1, p);
  return cudaGetLastError();
}

// out = sum over s of part[s] in split order (s = 0 first), n floats (a
// multiple of 4) each: the partials of a GW_EPI_F32 launch with splits > 1.
__global__ void __launch_bounds__(256)
    gw_split_sum_kernel(const float4* __restrict__ part, float4* __restrict__ out, size_t n4,
                        int splits) {
  for (size_t i = (size_t)blockIdx.x * 256 + threadIdx.x; i < n4; i += (size_t)gridDim.x * 256) {
    float4 v = part[i];
    for (int s = 1; s < splits; ++s) {
      const float4 w = part[(size_t)s * n4 + i];
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
    out[i] = v;
  }
}

inline cudaError_t launch_split_sum(const float* part, float* out, size_t n, int splits,
                                    cudaStream_t stream) {
  if (n % 4 || splits < 1) return cudaErrorInvalidValue;
  const size_t n4 = n / 4;
  const size_t blocks = (n4 + 255) / 256;
  gw_split_sum_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(part), reinterpret_cast<float4*>(out), n4, splits);
  return cudaGetLastError();
}

}  // namespace VFT_NS
