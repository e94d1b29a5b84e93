// Shared device code for the port's kernels.
//
//   gemm_bf16   C = epilogue(op(A) @ op(B)): bf16 operands on nvcuda::wmma
//               16x16x16 fragments with f32 accumulators.  Template flags
//               pick the layouts: TA reads A stored (K, M) row-major (the
//               product is A^T B, e.g. a weight gradient x^T dy summed over
//               every token row), TB reads B stored (N, K) row-major (A B^T,
//               e.g. a data gradient dy W^T); wmma col_major fragments give
//               both transposes from the same shared-memory ring.  With LN
//               (row-major A only) the LayerNorm of A is applied from
//               per-row (mu, rstd) stats and per-column (scale, bias) to the
//               A tiles in shared memory, so the normalised activations
//               never reach device memory.  The epilogue adds an optional f32
//               bias, applies the activation in f32 and writes f32, or rounds
//               to bf16 and optionally adds a bf16 residual in bf16 (the JAX
//               kernels' `x + y.astype(x.dtype)`).
//   row_stats   per-row one-pass LayerNorm statistics in f32:
//               mu = mean(x), rstd = 1/sqrt(max(mean(x^2) - mu^2, 0) + eps),
//               stored as f32 or (the int8 chain's bf16 tiles) rounded to bf16.
//
// Everything lives in the namespace VFT_NS, which each translation unit
// defines before including this header: each gets its own copy of the
// kernels, under a name that tells the launch sites apart in a trace.
// Each unit's init entry point opts the GEMM variants it launches in to
// their shared memory once per device (gemm_enable); the launches
// themselves set no attributes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#ifndef VFT_NS
#error "define VFT_NS before including common.cuh"
#endif

namespace VFT_NS {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

__host__ __device__ inline size_t round128(size_t x) { return (x + 127) & ~size_t(127); }

// Activation codes shared with vit_fpga_tpu_torch/ops/fused_mlp.py (_ACT_CODES).
enum Act { ACT_NONE = 0, ACT_GELU = 1, ACT_GELU_TANH = 2, ACT_QUICK_GELU = 3, ACT_RELU = 4 };

__device__ __forceinline__ float apply_act(float h, int act) {
  switch (act) {
    case ACT_GELU:  // erf form
      return 0.5f * h * (1.0f + erff(h * 0.7071067811865476f));
    case ACT_GELU_TANH: {  // the fma form of vit_fpga_tpu/ops/fused_mlp.py:_act
      const float h2 = h * h;
      const float u = h * (0.7978845608028654f + 0.035677408136300125f * h2);
      const float hh = 0.5f * h;
      return hh + hh * tanhf(u);
    }
    case ACT_QUICK_GELU:
      return h / (1.0f + expf(-1.702f * h));
    case ACT_RELU:
      return fmaxf(h, 0.0f);
    default:
      return h;
  }
}

// act(h) and act'(h) in the closed forms of
// vit_fpga_tpu/ops/fused_mlp.py:_act_and_grad (erf-GELU's own derivative
// for ACT_GELU).
__device__ __forceinline__ void act_and_grad(float h, int act, float& a, float& d) {
  switch (act) {
    case ACT_GELU: {
      const float cdf = 0.5f * (1.0f + erff(h * 0.7071067811865476f));
      a = h * cdf;
      d = cdf + h * 0.3989422804014327f * expf(-0.5f * h * h);
      return;
    }
    case ACT_GELU_TANH: {
      const float c = 0.7978845608028654f;
      const float t = tanhf(c * (h + 0.044715f * h * h * h));
      a = 0.5f * h * (1.0f + t);
      d = 0.5f * (1.0f + t) + 0.5f * h * (1.0f - t * t) * c * (1.0f + 0.134145f * h * h);
      return;
    }
    case ACT_QUICK_GELU: {
      const float s = 1.0f / (1.0f + expf(-1.702f * h));
      a = h * s;
      d = s * (1.0f + 1.702f * h * (1.0f - s));
      return;
    }
    case ACT_RELU:
      a = fmaxf(h, 0.0f);
      d = h > 0.0f ? 1.0f : 0.0f;
      return;
    default:
      a = h;
      d = 1.0f;
  }
}

__device__ __forceinline__ void unpack8(const uint4& v, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 v;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

__device__ __forceinline__ float bf16_round(float v) { return __bfloat162float(__float2bfloat16(v)); }

// An f32 already in the quant domain -> int8: round half to even, then
// saturate at +-127 (the JAX kernels' clip(rint(x), -127, 127)).
__device__ __forceinline__ signed char rint_sat(float v) {
  return static_cast<signed char>(static_cast<int>(fminf(fmaxf(rintf(v), -127.0f), 127.0f)));
}

// 8 values already in the quant domain -> 8 int8 (rint_sat), one 8-byte store.
__device__ __forceinline__ void store_rint8(signed char* dst, const float* f) {
  union {
    signed char c[8];
    uint2 u;
  } q;
#pragma unroll
  for (int t = 0; t < 8; ++t) q.c[t] = rint_sat(f[t]);
  *reinterpret_cast<uint2*>(dst) = q.u;
}

__device__ __forceinline__ void load8f(const float* src, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void store8f(float* dst, const float* f) {
  *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(f[4], f[5], f[6], f[7]);
}

// Two floats as a packed bf16 pair (lo in the low half).
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// max / sum over the 4 lanes of a quad (one accumulator row).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// GEMM: block tile 128 x 128 x 32, 8 warps as 2 (rows) x 4 (cols), each warp
// a 64 x 32 patch of 4 x 2 fragments.  Operand tiles are copied with
// cp.async into a GEMM_STAGES-deep shared-memory ring, so the copies for
// the next GEMM_STAGES - 1 k-steps are in flight while the tensor cores
// work on this one.  A row-major tile is stored [m][k], a transposed one
// [k][m] (and likewise for B), each row padded by 8 elements against bank
// conflicts.  Edges are zero-filled: N and K (and M when TA) must be
// multiples of 8.
// With the LayerNorm prologue each thread normalises the A chunks it
// copied, in shared memory, once they have landed, with the LN scale and
// bias staged in shared memory (2 K floats after the ring).
// ---------------------------------------------------------------------------

constexpr int GEMM_BM = 128;
constexpr int GEMM_BN = 128;
constexpr int GEMM_BK = 32;
constexpr int GEMM_STAGES = 4;
constexpr int GEMM_THREADS = 256;
constexpr int GEMM_C_LD = 16 + 4;        // f32 staging of one fragment per warp
constexpr int GEMM_MAX_LN_K = 4096;      // LN GEMMs stage K floats of scale and of bias

// Row length (elements) and size of one operand tile in shared memory: a
// [rows][BK] tile, or a [BK][rows] one when the operand is stored k-major
// (A stored (K, M), B stored (K, N)).
__host__ __device__ constexpr int tile_ld(bool kmajor, int rows) {
  return kmajor ? rows + 8 : GEMM_BK + 8;
}
__host__ __device__ constexpr int tile_elems(bool kmajor, int rows) {
  return kmajor ? GEMM_BK * (rows + 8) : rows * (GEMM_BK + 8);
}

template <bool TA, bool TB>
__host__ __device__ constexpr size_t gemm_ring_bytes() {
  return (size_t)GEMM_STAGES * (tile_elems(TA, GEMM_BM) + tile_elems(!TB, GEMM_BN)) * sizeof(bf16);
}

// Epilogue staging (one fragment per warp) reuses the operand ring.
static_assert(gemm_ring_bytes<true, false>() >=
                  (GEMM_THREADS / 32) * 16 * GEMM_C_LD * sizeof(float),
              "the epilogue staging reuses the operand ring");

template <bool LN, bool TA, bool TB>
inline size_t gemm_smem_bytes(int k) {
  return gemm_ring_bytes<TA, TB>() + (LN ? 2 * (size_t)k * sizeof(float) : 0);
}

struct GemmArgs {
  const bf16* A;         // (M, K) row-major; (K, M) row-major when TA
  const float* stats;    // (M, 2) f32 (mu, rstd) when the LN prologue is on
  const float* ln_scale; // (K,) f32
  const float* ln_bias;  // (K,) f32
  const bf16* B;         // (K, N) row-major; (N, K) row-major when TB
  const float* bias;     // (N,) f32 or nullptr
  const bf16* residual;  // (M, N) bf16 or nullptr (bf16 output only)
  void* C;               // (M, N) bf16, or f32 when c_f32
  int M, N, K;
  int act;
  int c_f32;
};

// 16-byte global -> shared copy; zero-fills the destination when !pred.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Tensor-core fragments by hand (the stack tiles, the sequence attention
// tiles): ldmatrix from shared memory and mma.sync (wmma's own fragment
// loads cost a third of the stack tile's time).
__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d (16 x 8, f32) += a (16 x 16 bf16, row) b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d (16 x 8, s32) += a (16 x 32 s8, row) b (32 x 8 s8, col), exact
__device__ __forceinline__ void mma_s8(int* d, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One operand's copy plan for this thread: two 8-element chunks per stage.
// A chunk sits at shared offset `soff` of the stage; its global source is
// `src + k0 * kstep` at k-step k0, valid while `ok` (inside M or N) and
// k0 + koff < K.
struct ChunkPlan {
  const bf16* src[2];
  size_t kstep[2];
  int koff[2];
  int soff[2];
  bool ok[2];
};

// rows: GEMM_BM or GEMM_BN; r0: the block's first row (m0 or n0);
// rdim: M or N.  Not transposed, the operand is (rdim, K) row-major (A, or
// B stored (N, K)); transposed, it is (K, rdim) row-major.
template <bool KMAJOR_ROWS>
__device__ __forceinline__ void plan_chunks(ChunkPlan& pl, const bf16* base, int tid, int rows,
                                            int r0, int rdim, int K) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * GEMM_THREADS;
    if (!KMAJOR_ROWS) {  // [rows][BK] tile: 4 chunks per row
      const int r = c >> 2, kc = (c & 3) * 8;
      pl.ok[i] = r0 + r < rdim;
      pl.soff[i] = r * tile_ld(false, rows) + kc;
      pl.koff[i] = kc;
      pl.kstep[i] = 1;
      pl.src[i] = base + (pl.ok[i] ? (size_t)(r0 + r) * K + kc : 0);
    } else {  // [BK][rows] tile: rows / 8 chunks per k-row
      const int cpr = rows / 8;
      const int kr = c / cpr, rc = (c % cpr) * 8;
      pl.ok[i] = r0 + rc < rdim;
      pl.soff[i] = kr * tile_ld(true, rows) + rc;
      pl.koff[i] = kr;
      pl.kstep[i] = (size_t)rdim;
      pl.src[i] = base + (pl.ok[i] ? (size_t)kr * rdim + r0 + rc : 0);
    }
  }
}

// B stored (K, N) row-major is the [BK][BN] (k-major) case; B stored
// (N, K) row-major (TB) the [BN][BK] one.  A is the reverse.
template <bool LN, bool TA, bool TB>
__global__ void __launch_bounds__(GEMM_THREADS, 2) gemm_bf16_kernel(GemmArgs p) {
  static_assert(!(LN && TA), "the LayerNorm prologue takes a row-major A");
  constexpr int A_ELEMS = tile_elems(TA, GEMM_BM);
  constexpr int B_ELEMS = tile_elems(!TB, GEMM_BN);
  constexpr int A_LD = tile_ld(TA, GEMM_BM);
  constexpr int B_LD = tile_ld(!TB, GEMM_BN);
  extern __shared__ __align__(128) unsigned char gemm_smem[];
  bf16* As = reinterpret_cast<bf16*>(gemm_smem);
  bf16* Bs = As + GEMM_STAGES * A_ELEMS;
  float* ls_s = reinterpret_cast<float*>(gemm_smem + gemm_ring_bytes<TA, TB>());  // LN only
  float* lb_s = ls_s + p.K;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 2;  // 0..1
  const int wn = warp & 3;   // 0..3
  const int m0 = blockIdx.y * GEMM_BM;
  const int n0 = blockIdx.x * GEMM_BN;

  ChunkPlan pa, pb;
  plan_chunks<TA>(pa, p.A, tid, GEMM_BM, m0, p.M, p.K);
  plan_chunks<!TB>(pb, p.B, tid, GEMM_BN, n0, p.N, p.K);

  float a_mu[2] = {0.0f, 0.0f}, a_rs[2] = {0.0f, 0.0f};
  if (LN) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ar = (tid + i * GEMM_THREADS) >> 2;
      if (pa.ok[i]) {
        a_mu[i] = p.stats[2 * (size_t)(m0 + ar)];
        a_rs[i] = p.stats[2 * (size_t)(m0 + ar) + 1];
      }
    }
  }

  auto load_stage = [&](int s, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool va = pa.ok[i] && k0 + pa.koff[i] < p.K;
      cp_async16(As + s * A_ELEMS + pa.soff[i], va ? pa.src[i] + k0 * pa.kstep[i] : p.A, va);
      const bool vb = pb.ok[i] && k0 + pb.koff[i] < p.K;
      cp_async16(Bs + s * B_ELEMS + pb.soff[i], vb ? pb.src[i] + k0 * pb.kstep[i] : p.B, vb);
    }
  };

  // xn = bf16(((f32(x) - mu) * rstd) * scale + bias), over this thread's
  // own (landed) A chunks of stage s; padding rows and columns stay zero.
  auto ln_stage = [&](int s, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kc = pa.koff[i];
      if (!pa.ok[i] || k0 + kc >= p.K) continue;
      // two halves of 4 values keep few registers live beside the
      // accumulators
      uint2* dst = reinterpret_cast<uint2*>(As + s * A_ELEMS + pa.soff[i]);
#pragma unroll
      for (int hlf = 0; hlf < 2; ++hlf) {
        const int k = k0 + kc + 4 * hlf;
        const float4 sc = *reinterpret_cast<const float4*>(ls_s + k);
        const float4 bi = *reinterpret_cast<const float4*>(lb_s + k);
        uint2 v = dst[hlf];
        __nv_bfloat162* pv = reinterpret_cast<__nv_bfloat162*>(&v);
        const float2 x0 = __bfloat1622float2(pv[0]);
        const float2 x1 = __bfloat1622float2(pv[1]);
        pv[0] = __floats2bfloat162_rn(((x0.x - a_mu[i]) * a_rs[i]) * sc.x + bi.x,
                                      ((x0.y - a_mu[i]) * a_rs[i]) * sc.y + bi.y);
        pv[1] = __floats2bfloat162_rn(((x1.x - a_mu[i]) * a_rs[i]) * sc.z + bi.z,
                                      ((x1.y - a_mu[i]) * a_rs[i]) * sc.w + bi.w);
        dst[hlf] = v;
      }
    }
  };

  using ALayout = typename std::conditional<TA, wmma::col_major, wmma::row_major>::type;
  using BLayout = typename std::conditional<TB, wmma::col_major, wmma::row_major>::type;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int nk = (p.K + GEMM_BK - 1) / GEMM_BK;
#pragma unroll
  for (int s = 0; s < GEMM_STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s * GEMM_BK);
    cp_async_commit();
  }
  if (LN) {
    for (int k = tid; k < p.K; k += GEMM_THREADS) {
      ls_s[k] = p.ln_scale[k];
      lb_s[k] = p.ln_bias[k];
    }
    __syncthreads();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % GEMM_STAGES;
    cp_async_wait<GEMM_STAGES - 2>();  // this thread's copies of step kt landed
    if (LN) ln_stage(s, kt * GEMM_BK);
    __syncthreads();  // everyone's copies of step kt are in; step kt-1 is consumed
    const int next = kt + GEMM_STAGES - 1;
    if (next < nk) load_stage(next % GEMM_STAGES, next * GEMM_BK);
    cp_async_commit();  // one group per step, empty or not, keeps the count
    const bf16* as = As + s * A_ELEMS;
    const bf16* bs = Bs + s * B_ELEMS;
#pragma unroll
    for (int kk = 0; kk < GEMM_BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> af[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> bfr[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = wm * 64 + i * 16;
        wmma::load_matrix_sync(af[i], TA ? as + kk * 16 * A_LD + m : as + m * A_LD + kk * 16,
                               A_LD);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = wn * 32 + j * 16;
        wmma::load_matrix_sync(bfr[j], TB ? bs + n * B_LD + kk * 16 : bs + kk * 16 * B_LD + n,
                               B_LD);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the epilogue stages through it

  // Epilogue, one fragment at a time through the warp's staging tile: lane
  // L owns row L/2, columns 8*(L%2) .. +8.
  float* cs = reinterpret_cast<float*>(gemm_smem) + warp * 16 * GEMM_C_LD;
  const int er = lane >> 1;
  const int ec = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], GEMM_C_LD, wmma::mem_row_major);
      __syncwarp();
      const int gr = m0 + wm * 64 + i * 16 + er;
      const int gc = n0 + wn * 32 + j * 16 + ec;
      if (gr < p.M && gc < p.N) {
        float f[8];
        load8f(cs + er * GEMM_C_LD + ec, f);
        if (p.bias != nullptr) {
          float bi[8];
          load8f(p.bias + gc, bi);
#pragma unroll
          for (int t = 0; t < 8; ++t) f[t] += bi[t];
        }
        const size_t off = (size_t)gr * p.N + gc;
#pragma unroll
        for (int t = 0; t < 8; ++t) f[t] = apply_act(f[t], p.act);
        if (p.c_f32) {
          store8f(static_cast<float*>(p.C) + off, f);
        } else {
          uint4 y = pack8(f);
          if (p.residual != nullptr) {
            float r[8];
            unpack8(*reinterpret_cast<const uint4*>(p.residual + off), r);
            unpack8(y, f);  // the residual adds the bf16-rounded product
#pragma unroll
            for (int t = 0; t < 8; ++t) f[t] = r[t] + f[t];
            y = pack8(f);
          }
          *reinterpret_cast<uint4*>(static_cast<bf16*>(p.C) + off) = y;
        }
      }
      __syncwarp();
    }
  }
}

// Opts one GEMM variant in to the shared memory it may use (above the
// 48 KB default), on the current device.
template <bool LN, bool TA, bool TB>
inline cudaError_t gemm_enable() {
  return cudaFuncSetAttribute(gemm_bf16_kernel<LN, TA, TB>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)gemm_smem_bytes<LN, TA, TB>(LN ? GEMM_MAX_LN_K : 0));
}

template <bool LN, bool TA, bool TB>
inline cudaError_t launch_gemm_t(const GemmArgs& p, cudaStream_t stream) {
  if ((LN && p.K > GEMM_MAX_LN_K) || (TA && p.M % 8) || p.N % 8 || p.K % 8)
    return cudaErrorInvalidValue;
  const dim3 grid((p.N + GEMM_BN - 1) / GEMM_BN, (p.M + GEMM_BM - 1) / GEMM_BM);
  gemm_bf16_kernel<LN, TA, TB><<<grid, GEMM_THREADS, gemm_smem_bytes<LN, TA, TB>(p.K), stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Row statistics: one warp per row, 8 bf16 per lane per step.
// ---------------------------------------------------------------------------

constexpr int STATS_THREADS = 256;

__device__ __forceinline__ void put_stat(float* p, float v) { *p = v; }
__device__ __forceinline__ void put_stat(bf16* p, float v) { *p = __float2bfloat16(v); }

template <typename ST>
__global__ void __launch_bounds__(STATS_THREADS)
    row_stats_kernel(const bf16* __restrict__ x, ST* __restrict__ st, int rows, int d,
                     float eps) {
  const int row = (blockIdx.x * STATS_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const bf16* xr = x + (size_t)row * d;
  float s = 0.0f, ss = 0.0f;
  for (int c = lane * 8; c < d; c += 32 * 8) {
    float f[8];
    unpack8(*reinterpret_cast<const uint4*>(xr + c), f);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      s += f[t];
      ss += f[t] * f[t];
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  if (lane == 0) {
    const float mu = s / (float)d;
    const float var = fmaxf(ss / (float)d - mu * mu, 0.0f);
    put_stat(st + 2 * (size_t)row, mu);
    put_stat(st + 2 * (size_t)row + 1, 1.0f / sqrtf(var + eps));
  }
}

// st: (rows, 2) f32 or bf16.
template <typename ST>
inline cudaError_t launch_row_stats(const bf16* x, ST* st, int rows, int d, float eps,
                                    cudaStream_t stream) {
  const int rows_per_block = STATS_THREADS / 32;
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  row_stats_kernel<ST><<<blocks, STATS_THREADS, 0, stream>>>(x, st, rows, d, eps);
  return cudaGetLastError();
}

}  // namespace VFT_NS
