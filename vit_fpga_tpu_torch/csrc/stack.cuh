// Device pieces of the single-launch encoders: K11's (vit_stack.cu) tiles
// and attention items, and the stage clock, the launch and the scalar
// helpers that every encoder takes (K19a, K19b, K20 and K12 run on
// stack_wgmma.cuh); include after common.cuh and quant.cuh.
//
// The encoders are cooperative and persistent: one grid of blocks stays
// resident for the whole encoder, walks the layers in a loop and separates
// its stages with grid-wide barriers.  A stage is a list of work items
// (GEMM tiles, attention chunks, token rows) that the blocks take in turn.
//
//   tile_bf16   one 64 x 64 output tile of A (M, K) times a weight over k
//       in [k0, k0 + kn): bf16 on mma.sync m16n8k16 with f32 sums, the
//       weight stored (K, N) row-major; operand fragments by ldmatrix.
//       Operands arrive by cp.async.cg (through L2, never the non-coherent
//       path) into a 4-deep ring; the caller's epilogue gets each lane's 16
//       results of one row.
//   attn_item   16-row query tiles of one (image, head) against all its keys
//       (the softmax rows spread over every warp of the block):
//       s = (q k^T) * scale in f32, keys at or past n_valid masked,
//       e = exp(clip(s, -70, 80)), ao = bf16((bf16(e) @ v) * (1 / sum(e))).
//   prefetch_l2 spreads prefetch.global.L2 of a weight over the grid.
//
// Data one stage writes and a later one reads (after a grid barrier) is
// read with cp.async.cg or __ldcg, so no stale line is read from L1 or
// through ld.global.nc.

#pragma once

#include <cooperative_groups.h>

namespace VFT_NS {

namespace cg = cooperative_groups;

constexpr int SK_THREADS = 256;
constexpr int SK_WARPS = SK_THREADS / 32;
constexpr int ST_BM = 64;
constexpr int ST_BN = 64;
constexpr int ST_STAGES = 4;          // 3 k-steps in flight per tile
constexpr int ST_BK = 64;             // bf16 k-step (elements)
constexpr int ST_KQ = 16;             // K granularity: one wmma fragment
constexpr int ST_MAX_KV = 256;        // keys per (image, head)
constexpr int ST_DH = 64;             // head dim
constexpr int ST_QWARPS = 2;          // 16-row query tiles per attention item
constexpr int ST_QCHUNK = 16 * ST_QWARPS;
constexpr int ST_C_LD = 32 + 4;       // per-warp epilogue staging, [16][ST_C_LD]
constexpr int ST_MAX_SPLIT = 4;       // split-K slices of a partial-sum stage

// bf16 ring: A [64][BK + 8], B [BK][64 + 8]
constexpr int SA_LD = ST_BK + 8;
constexpr int SB_LD = ST_BN + 8;
constexpr int SA_ELEMS = ST_BM * SA_LD;
constexpr int SB_ELEMS = ST_BK * SB_LD;
constexpr size_t ST_GEMM_BYTES = (size_t)ST_STAGES * (SA_ELEMS + SB_ELEMS) * 2;
// each thread copies two 16-byte chunks of each operand per k-step
static_assert(ST_BM * ST_BK / 8 == 2 * SK_THREADS && ST_BK * ST_BN / 8 == 2 * SK_THREADS,
              "bf16 copy plan");

static_assert(ST_GEMM_BYTES >= (size_t)SK_WARPS * 16 * ST_C_LD * 4, "bf16 staging fits the ring");

// Slices of a k range of `k` (a multiple of ST_KQ) for split-K: the
// largest s <= want that cuts it into whole fragments.
__host__ __device__ inline int pick_split(int k, int want) {
  for (int s = want; s > 1; --s)
    if (k % (s * ST_KQ) == 0) return s;
  return 1;
}

__host__ __device__ inline size_t align256(size_t x) { return (x + 255) & ~size_t(255); }

// The activations of the stack kernels in f32, each product and sum
// rounded on its own (no contraction into fma), as the plain versions
// compute them: the fma-form tanh-GELU of fused_mlp._act, quick_gelu.
__device__ __forceinline__ float stack_act(float h, int act) {
  if (act == ACT_QUICK_GELU) return __fmul_rn(h, __frcp_rn(__fadd_rn(1.0f, expf(__fmul_rn(-1.702f, h)))));
  const float h2 = __fmul_rn(h, h);
  const float u = __fmul_rn(h, __fadd_rn(0.7978845608028654f, __fmul_rn(0.035677408136300125f, h2)));
  const float hh = __fmul_rn(0.5f, h);
  return __fadd_rn(hh, __fmul_rn(hh, tanhf(u)));
}

__device__ __forceinline__ void ldcg8(const bf16* p, float* f) {
  unpack8(__ldcg(reinterpret_cast<const uint4*>(p)), f);
}

__device__ __forceinline__ void ldcg8f(const float* p, float* f) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcg(reinterpret_cast<const float4*>(p + 4));
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// Block-wide reductions for the row passes (one block per token row):
// each warp reduces, then every thread adds the warps' results in a fixed
// order.  Every thread of the block calls them.
__device__ __forceinline__ float2 block_sum2(float a, float b) {
  __shared__ float red[2 * SK_WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  a = warp_sum(a);
  b = warp_sum(b);
  __syncthreads();  // the previous reduction has read red
  if (lane == 0) {
    red[warp] = a;
    red[SK_WARPS + warp] = b;
  }
  __syncthreads();
  float sa = 0.0f, sb = 0.0f;
#pragma unroll
  for (int w = 0; w < SK_WARPS; ++w) {
    sa += red[w];
    sb += red[SK_WARPS + w];
  }
  return make_float2(sa, sb);
}

// The warp's 16 x 32 accumulators (four 16 x 8 mma tiles) into its
// [16][ST_C_LD] staging rows, then each lane's 16 values of row lane / 2.
template <typename T>
__device__ __forceinline__ void stage_acc(T* cs, const T (*acc)[4], T* f) {
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2, gc = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    cs[gr * ST_C_LD + j * 8 + gc] = acc[j][0];
    cs[gr * ST_C_LD + j * 8 + gc + 1] = acc[j][1];
    cs[(gr + 8) * ST_C_LD + j * 8 + gc] = acc[j][2];
    cs[(gr + 8) * ST_C_LD + j * 8 + gc + 1] = acc[j][3];
  }
  __syncwarp();
  const int r = lane >> 1, c = (lane & 1) * 16;
#pragma unroll
  for (int t = 0; t < 16; ++t) f[t] = cs[r * ST_C_LD + c + t];
}

// ---------------------------------------------------------------------------
// GEMM tiles: 8 warps as 4 (rows, 16 each) x 2 (columns, 32 each), four
// 16 x 8 mma.sync accumulators per warp.  Rows past M are zero-filled and never
// written; N is a multiple of 64 and kn of ST_KQ (k past kn is
// zero-filled).  The epilogue is
// called as epi(row, col, f) with the lane's 16 results of `row`, columns
// col .. col + 15, in a [16] float array; row may be past M (the callee
// skips it).  Every thread of the block calls a tile.
// ---------------------------------------------------------------------------

template <typename Epi>
__device__ void tile_bf16(const bf16* A, int lda, const bf16* B, int ldb, int M, int m0, int n0,
                          int k0, int kn, unsigned char* smem, Epi epi) {
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + ST_STAGES * SA_ELEMS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  // two 16-byte chunks of each operand per thread and k-step
  int ar[2], akc[2], bkr[2], bnc[2];
  bool aok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * SK_THREADS;
    ar[i] = c >> 3;
    akc[i] = (c & 7) * 8;
    aok[i] = m0 + ar[i] < M;
    bkr[i] = c >> 3;
    bnc[i] = (c & 7) * 8;
  }
  auto load = [&](int s, int kt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ka = kt * ST_BK + akc[i];
      const bool va = aok[i] && ka < kn;
      cp_async16(As + s * SA_ELEMS + ar[i] * SA_LD + akc[i],
                 va ? A + (size_t)(m0 + ar[i]) * lda + k0 + ka : A, va);
      const int kb = kt * ST_BK + bkr[i];
      const bool vb = kb < kn;
      cp_async16(Bs + s * SB_ELEMS + bkr[i] * SB_LD + bnc[i],
                 vb ? B + (size_t)(k0 + kb) * ldb + n0 + bnc[i] : B, vb);
    }
  };
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[j][t] = 0.0f;
  const int nk = (kn + ST_BK - 1) / ST_BK;
  __syncthreads();  // the previous tile's epilogue is done with the ring
#pragma unroll
  for (int s = 0; s < ST_STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  // ldmatrix row addresses: A rows wm*16 + lane%16 at k + 8*(lane/16); B
  // (k-major) rows k = lane%16 at column wn*32 + 8*(lane/16), transposed
  const int a_off = (wm * 16 + (lane & 15)) * SA_LD + (lane >> 4) * 8;
  const int b_off = (lane & 15) * SB_LD + wn * 32 + (lane >> 4) * 8;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % ST_STAGES;
    cp_async_wait<ST_STAGES - 2>();
    __syncthreads();
    const int next = kt + ST_STAGES - 1;
    if (next < nk) load(next % ST_STAGES, next);
    cp_async_commit();
    const bf16* as = As + s * SA_ELEMS + a_off;
    const bf16* bs = Bs + s * SB_ELEMS + b_off;
#pragma unroll
    for (int kk = 0; kk < ST_BK / 16; ++kk) {
      unsigned a[4], b[8];
      ldsm_x4(a, as + kk * 16);
      ldsm_x4_t(b, bs + kk * 16 * SB_LD);
      ldsm_x4_t(b + 4, bs + kk * 16 * SB_LD + 16);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_bf16(acc[j], a, b[2 * j], b[2 * j + 1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the epilogue stages through it
  float f[16];
  stage_acc(reinterpret_cast<float*>(smem) + warp * 16 * ST_C_LD, acc, f);
  epi(m0 + wm * 16 + (lane >> 1), n0 + wn * 32 + (lane & 1) * 16, f);
}

// Writes 16 values of a row as bf16 / f32.
__device__ __forceinline__ void store16(bf16* dst, const float* f) {
  *reinterpret_cast<uint4*>(dst) = pack8(f);
  *reinterpret_cast<uint4*>(dst + 8) = pack8(f + 8);
}
__device__ __forceinline__ void store16(float* dst, const float* f) {
#pragma unroll
  for (int t = 0; t < 16; t += 4)
    *reinterpret_cast<float4*>(dst + t) = make_float4(f[t], f[t + 1], f[t + 2], f[t + 3]);
}

// ---------------------------------------------------------------------------
// Attention items.  Shared memory: the head's keys and values up to kvp,
// then per query warp a 16-row q tile, its f32 scores (the bf16
// probabilities overwrite them row by row, then the f32 PV output) and the
// 16 reciprocal denominators.
// ---------------------------------------------------------------------------

struct StAttnSmem {
  int ldq, lds;
  size_t v_off, w_off, w_bytes, s_rel, r_rel, bytes;
};

__host__ __device__ inline StAttnSmem st_attn_smem(int kvp) {
  StAttnSmem m;
  m.ldq = ST_DH + 8;
  m.lds = (kvp > ST_DH ? kvp : ST_DH) + 4;
  m.v_off = round128((size_t)kvp * m.ldq * 2);
  m.w_off = m.v_off + round128((size_t)kvp * m.ldq * 2);
  m.s_rel = round128((size_t)16 * m.ldq * 2);
  m.r_rel = m.s_rel + round128((size_t)16 * m.lds * 4);
  m.w_bytes = m.r_rel + round128(16 * 4);
  m.bytes = m.w_off + ST_QWARPS * m.w_bytes;
  return m;
}

// Dynamic shared memory of a stack kernel at kvp keys.
__host__ __device__ inline size_t stack_smem_bytes(int kvp) {
  size_t b = st_attn_smem(kvp).bytes;
  if (b < ST_GEMM_BYTES) b = ST_GEMM_BYTES;
  return b;
}

// qkv (B * n_pad, 3D) bf16, q | k | v; ao (B * n_pad, D) bf16.  Query rows
// q0 .. q0 + ST_QCHUNK - 1 (those below n_pad) of image b, head h.  Every
// thread of the block calls it.
__device__ __noinline__ void attn_item(const bf16* qkv, bf16* ao, int b, int h, int q0, int n_pad,
                                       int n_valid, int kvp, int d, float scale,
                                       unsigned char* smem) {
  constexpr int CPR = ST_DH / 8;
  constexpr int NF = ST_DH / 16;
  const StAttnSmem L = st_attn_smem(kvp);
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L.v_off);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t ld3 = 3 * (size_t)d;
  const bf16* base = qkv + (size_t)b * n_pad * ld3 + h * ST_DH;

  __syncthreads();  // the previous item is done with the shared memory
  // Keys and values past n_valid are masked, so they are zero-filled here;
  // every copy is in flight at once (cp.async, through L2).
  for (int c = tid; c < kvp * CPR; c += SK_THREADS) {
    const int r = c / CPR, cc = c % CPR;
    const bool ok = r < n_valid;
    const bf16* row = base + (ok ? (size_t)r * ld3 + cc * 8 : 0);
    cp_async16(Ks + r * L.ldq + cc * 8, row + d, ok);
    cp_async16(Vs + r * L.ldq + cc * 8, row + 2 * d, ok);
  }
  const int qs = q0 + warp * 16;
  const bool qwarp = warp < ST_QWARPS && qs < n_pad;
  unsigned char* wbase = smem + L.w_off + warp * L.w_bytes;
  bf16* Qs = reinterpret_cast<bf16*>(wbase);
  if (qwarp) {
    for (int c = lane; c < 16 * CPR; c += 32) {
      const int r = c / CPR, cc = c % CPR;
      const bool ok = qs + r < n_pad;
      cp_async16(Qs + r * L.ldq + cc * 8, base + (ok ? (size_t)(qs + r) * ld3 + cc * 8 : 0), ok);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (qwarp) {  // scores s = q k^T (f32) of the warp's 16 query rows
    float* S = reinterpret_cast<float*>(wbase + L.s_rel);
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[NF];
#pragma unroll
    for (int kk = 0; kk < NF; ++kk) wmma::load_matrix_sync(qa[kk], Qs + kk * 16, L.ldq);
    for (int j = 0; j < kvp / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < NF; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
        wmma::load_matrix_sync(kb, Ks + (j * 16) * L.ldq + kk * 16, L.ldq);
        wmma::mma_sync(acc, qa[kk], kb, acc);
      }
      wmma::store_matrix_sync(S + j * 16, acc, L.lds, wmma::mem_row_major);
    }
  }
  __syncthreads();
  // Max-free softmax numerators, the item's rows spread over every warp; a
  // row's scores are all read into registers before its bf16
  // probabilities are written over them.
  for (int rr = warp; rr < ST_QCHUNK; rr += SK_WARPS) {
    const int qw = rr / 16, r = rr % 16;
    if (qw >= ST_QWARPS || q0 + qw * 16 >= n_pad) continue;
    unsigned char* wb = smem + L.w_off + qw * L.w_bytes;
    float* srow = reinterpret_cast<float*>(wb + L.s_rel) + r * L.lds;
    bf16* prow = reinterpret_cast<bf16*>(wb + L.s_rel) + r * 2 * L.lds;
    float* rinv = reinterpret_cast<float*>(wb + L.r_rel);
    float e[ST_MAX_KV / 32];
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < ST_MAX_KV / 32; ++i) {
      const int c = lane + 32 * i;
      float v = 0.0f;
      if (c < n_valid) v = expf(fminf(fmaxf(srow[c] * scale, -70.0f), 80.0f));
      e[i] = v;
      sum += v;
    }
    sum = warp_sum(sum);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < ST_MAX_KV / 32; ++i) {
      const int c = lane + 32 * i;
      if (c < kvp) prow[c] = __float2bfloat16(e[i]);
    }
    if (lane == 0) rinv[r] = 1.0f / sum;
  }
  __syncthreads();
  if (qwarp) {  // o = bf16(e) @ v (f32), then ao = bf16(o * (1 / sum(e)))
    float* S = reinterpret_cast<float*>(wbase + L.s_rel);
    bf16* P = reinterpret_cast<bf16*>(S);
    float* rinv = reinterpret_cast<float*>(wbase + L.r_rel);
    const int ldp = 2 * L.lds;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[NF];
#pragma unroll
    for (int j = 0; j < NF; ++j) wmma::fill_fragment(oacc[j], 0.0f);
    for (int kk = 0; kk < kvp / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
      wmma::load_matrix_sync(pa, P + kk * 16, ldp);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(vb, Vs + (kk * 16) * L.ldq + j * 16, L.ldq);
        wmma::mma_sync(oacc[j], pa, vb, oacc[j]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < NF; ++j) wmma::store_matrix_sync(S + j * 16, oacc[j], L.lds, wmma::mem_row_major);
    __syncwarp();
    for (int c = lane; c < 16 * CPR; c += 32) {
      const int r = c / CPR, cc = c % CPR;
      const int q = qs + r;
      if (q >= n_pad) continue;
      const float rv = rinv[r];
      const float* src = S + r * L.lds + cc * 8;
      const size_t off = ((size_t)b * n_pad + q) * d + h * ST_DH + cc * 8;
      float f[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) f[t] = __fmul_rn(src[t], rv);
      *reinterpret_cast<uint4*>(ao + off) = pack8(f);
    }
  }
}

// The attention stage: items (image, head, ST_QCHUNK query rows) taken by
// the blocks in turn.
__device__ void attn_stage(const bf16* qkv, bf16* ao, int batch, int heads, int n_pad, int n_valid,
                           int d, float scale, unsigned char* smem) {
  const int kvp = (n_valid + 15) / 16 * 16;
  const int chunks = (n_pad + ST_QCHUNK - 1) / ST_QCHUNK;
  const int items = batch * heads * chunks;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int qc = it % chunks, bh = it / chunks;
    attn_item(qkv, ao, bh / heads, bh % heads, qc * ST_QCHUNK, n_pad, n_valid, kvp, d, scale,
              smem);
  }
}

// ---------------------------------------------------------------------------
// The int8 encoders' scalar helpers (stack_wgmma.cuh).
// ---------------------------------------------------------------------------

__device__ __forceinline__ float dequant(int acc, float srow, float scol, float bias) {
  return __fadd_rn(__fmul_rn((float)acc, __fmul_rn(srow, scol)), bias);
}

__device__ __forceinline__ void ldcg8i(const int* p, int* a) {
  const int4 u = __ldcg(reinterpret_cast<const int4*>(p));
  const int4 w = __ldcg(reinterpret_cast<const int4*>(p + 4));
  a[0] = u.x; a[1] = u.y; a[2] = u.z; a[3] = u.w;
  a[4] = w.x; a[5] = w.y; a[6] = w.z; a[7] = w.w;
}

// prefetch.global.L2 of [p, p + bytes), 128-byte lines spread over the grid.
__device__ __forceinline__ void prefetch_l2(const void* p, size_t bytes) {
  const char* c = static_cast<const char*>(p);
  const size_t lines = (bytes + 127) / 128;
  for (size_t i = (size_t)blockIdx.x * SK_THREADS + threadIdx.x; i < lines;
       i += (size_t)gridDim.x * SK_THREADS)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(c + i * 128));
}

// ---------------------------------------------------------------------------
// Stage clock: with a trace buffer, thread 0 of each block adds, per stage
// kind, the globaltimer nanoseconds from the end of the previous barrier
// to the end of its block's work (slot 0) and the time it then waits in
// the grid barrier (slot 1): trace[(block * ST_TRACE_KINDS + kind) * 2 +
// slot], int64, zeroed by the caller.  Without one it is the barrier alone.
// ---------------------------------------------------------------------------

constexpr int ST_TRACE_KINDS = 16;
constexpr int ST_TRACE_BLOCKS = 1024;

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

struct StageClock {
  long long* trace;
  // The last reading (thread 0's) lives in shared memory: a 64-bit value
  // live across every stage of a layer loop would hold two registers that
  // the stages need, and ptxas spilled around the barriers for it.
  __device__ static unsigned long long& last() {
    __shared__ unsigned long long t;
    return t;
  }
  __device__ void start() {
    if (trace != nullptr && threadIdx.x == 0) last() = global_ns();
  }
  __device__ void work_done(int kind) {
    if (trace == nullptr) return;
    __syncthreads();
    if (threadIdx.x == 0) {
      const unsigned long long now = global_ns();
      trace[((size_t)blockIdx.x * ST_TRACE_KINDS + kind) * 2] += (long long)(now - last());
      last() = now;
    }
  }
  // the end of stage `kind`: its work, then the grid barrier
  __device__ void sync(cg::grid_group& grid, int kind) {
    work_done(kind);
    grid.sync();
    if (trace != nullptr && threadIdx.x == 0) {
      const unsigned long long now = global_ns();
      trace[((size_t)blockIdx.x * ST_TRACE_KINDS + kind) * 2 + 1] += (long long)(now - last());
      last() = now;
    }
  }
};

// ---------------------------------------------------------------------------
// Launch: a cooperative grid of `threads`-thread blocks as large as can be
// resident at once, or a loud error (ST_TRACE_BLOCKS at most when traced).
// The grid size is kept per device and shared memory size.
// ---------------------------------------------------------------------------

inline cudaError_t coop_launch(const void* fn, void* args, size_t smem, bool traced,
                               cudaStream_t stream, int threads = SK_THREADS) {
  static int dev_smem[64];
  static int dev_blocks[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (dev_smem[dev] != (int)smem || dev_blocks[dev] == 0) {
    int coop = 0, sms = 0, occ = 0;
    if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, threads, smem)) != cudaSuccess)
      return err;
    if (occ < 1) return cudaErrorCooperativeLaunchTooLarge;
    dev_blocks[dev] = occ * sms;
    dev_smem[dev] = (int)smem;
  }
  const int blocks = traced && dev_blocks[dev] > ST_TRACE_BLOCKS ? ST_TRACE_BLOCKS : dev_blocks[dev];
  void* kargs[] = {args};
  err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(threads), kargs, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace VFT_NS
