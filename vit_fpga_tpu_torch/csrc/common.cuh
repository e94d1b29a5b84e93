// Shared device code for the stats-chain kernels (attn_stats.cu, mlp_stats.cu).
//
//   gemm_bf16   C = epilogue(A' @ B): bf16 operands on nvcuda::wmma 16x16x16
//               fragments with f32 accumulators.  A' is either A itself or
//               the LayerNorm of A applied from per-row (mu, rstd) stats and
//               per-column (scale, bias) to the A tiles in shared memory,
//               so the normalised activations never reach device memory.  The epilogue adds an f32 bias, applies
//               the activation in f32, rounds to bf16 and optionally adds a
//               bf16 residual in bf16 (the JAX kernels' `x + y.astype(x.dtype)`).
//   row_stats   per-row one-pass LayerNorm statistics in f32:
//               mu = mean(x), rstd = 1/sqrt(max(mean(x^2) - mu^2, 0) + eps).
//
// Everything lives in the namespace VFT_NS, which each translation unit
// defines before including this header: each gets its own copy of the
// kernels, under a name that tells the launch sites apart in a trace.
// Each unit's init entry point calls gemm_init() once per device before
// its first launch; the launches themselves set no attributes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#ifndef VFT_NS
#error "define VFT_NS before including common.cuh"
#endif

namespace VFT_NS {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// GEMM: block tile 128 x 128 x 32, 8 warps as 2 (rows) x 4 (cols), each warp
// a 64 x 32 patch of 4 x 2 fragments.  Operand tiles are copied with
// cp.async into a GEMM_STAGES-deep shared-memory ring, so the copies for
// the next GEMM_STAGES - 1 k-steps are in flight while the tensor cores
// work on this one.  With the LayerNorm prologue each thread normalises the
// A chunks it copied, in shared memory, once they have landed, with the LN
// scale and bias staged in shared memory (2 K floats after the ring).
// ---------------------------------------------------------------------------

constexpr int GEMM_BM = 128;
constexpr int GEMM_BN = 128;
constexpr int GEMM_BK = 32;
constexpr int GEMM_STAGES = 4;
constexpr int GEMM_THREADS = 256;
constexpr int GEMM_A_LD = GEMM_BK + 8;   // bf16 elements; +8 breaks bank conflicts
constexpr int GEMM_B_LD = GEMM_BN + 8;
constexpr int GEMM_C_LD = 16 + 4;        // f32 staging of one fragment per warp
constexpr int GEMM_MAX_LN_K = 4096;      // LN GEMMs stage K floats of scale and of bias
constexpr int GEMM_A_STAGE = GEMM_BM * GEMM_A_LD;
constexpr int GEMM_B_STAGE = GEMM_BK * GEMM_B_LD;
constexpr size_t GEMM_SMEM_BYTES =
    (size_t)GEMM_STAGES * (GEMM_A_STAGE + GEMM_B_STAGE) * sizeof(bf16);
static_assert(GEMM_SMEM_BYTES >= (GEMM_THREADS / 32) * 16 * GEMM_C_LD * sizeof(float),
              "the epilogue staging reuses the operand ring");

inline size_t gemm_smem_bytes(bool ln, int k) {
  return GEMM_SMEM_BYTES + (ln ? 2 * (size_t)k * sizeof(float) : 0);
}

struct GemmArgs {
  const bf16* A;         // (M, K) row-major
  const float* stats;    // (M, 2) f32 (mu, rstd) when the LN prologue is on
  const float* ln_scale; // (K,) f32
  const float* ln_bias;  // (K,) f32
  const bf16* B;         // (K, N) row-major
  const float* bias;     // (N,) f32
  const bf16* residual;  // (M, N) or nullptr
  bf16* C;               // (M, N)
  int M, N, K;
  int act;
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

// 2 blocks per SM: caps registers at 128 a thread.
template <bool LN>
__global__ void __launch_bounds__(GEMM_THREADS, 2) gemm_bf16_kernel(GemmArgs p) {
  extern __shared__ __align__(128) unsigned char gemm_smem[];
  bf16* As = reinterpret_cast<bf16*>(gemm_smem);
  bf16* Bs = As + GEMM_STAGES * GEMM_A_STAGE;
  float* ls_s = reinterpret_cast<float*>(gemm_smem + GEMM_SMEM_BYTES);  // LN only
  float* lb_s = ls_s + p.K;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 2;  // 0..1
  const int wn = warp & 3;   // 0..3
  const int m0 = blockIdx.y * GEMM_BM;
  const int n0 = blockIdx.x * GEMM_BN;

  // Each thread copies two 8-element chunks of A (rows fixed across k) and
  // two of B (columns fixed across k) per stage.
  int a_off[2], b_off[2];
  const bf16* a_src[2];
  const bf16* b_src[2];
  bool a_ok[2], b_ok[2];
  float a_mu[2], a_rs[2];
  int a_col[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * GEMM_THREADS;
    const int ar = c >> 2, ac = c & 3;
    a_ok[i] = (m0 + ar) < p.M;
    a_off[i] = ar * GEMM_A_LD + ac * 8;
    a_col[i] = ac * 8;
    a_src[i] = a_ok[i] ? p.A + (size_t)(m0 + ar) * p.K + ac * 8 : p.A;
    a_mu[i] = 0.0f;
    a_rs[i] = 0.0f;
    if (LN && a_ok[i]) {
      a_mu[i] = p.stats[2 * (size_t)(m0 + ar)];
      a_rs[i] = p.stats[2 * (size_t)(m0 + ar) + 1];
    }
    const int br = c >> 4, bc = c & 15;
    b_ok[i] = (n0 + bc * 8) < p.N;
    b_off[i] = br * GEMM_B_LD + bc * 8;
    b_src[i] = b_ok[i] ? p.B + (size_t)br * p.N + n0 + bc * 8 : p.B;
  }

  auto load_stage = [&](int s, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      cp_async16(As + s * GEMM_A_STAGE + a_off[i], a_ok[i] ? a_src[i] + k0 : p.A, a_ok[i]);
      cp_async16(Bs + s * GEMM_B_STAGE + b_off[i],
                 b_ok[i] ? b_src[i] + (size_t)k0 * p.N : p.B, b_ok[i]);
    }
  };

  // xn = bf16(((f32(x) - mu) * rstd) * scale + bias), over this thread's
  // own (landed) A chunks of stage s; padding rows stay zero.
  auto ln_stage = [&](int s, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!a_ok[i]) continue;
      // two halves of 4 values keep few registers live beside the
      // accumulators
      uint2* dst = reinterpret_cast<uint2*>(As + s * GEMM_A_STAGE + a_off[i]);
#pragma unroll
      for (int hlf = 0; hlf < 2; ++hlf) {
        const int k = k0 + a_col[i] + 4 * hlf;
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

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int nk = p.K / GEMM_BK;
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
    const bf16* as = As + s * GEMM_A_STAGE;
    const bf16* bs = Bs + s * GEMM_B_STAGE;
#pragma unroll
    for (int kk = 0; kk < GEMM_BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(af[i], as + (wm * 64 + i * 16) * GEMM_A_LD + kk * 16, GEMM_A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], bs + (kk * 16) * GEMM_B_LD + wn * 32 + j * 16, GEMM_B_LD);
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
        const float4 c0 = *reinterpret_cast<const float4*>(cs + er * GEMM_C_LD + ec);
        const float4 c1 = *reinterpret_cast<const float4*>(cs + er * GEMM_C_LD + ec + 4);
        f[0] = c0.x; f[1] = c0.y; f[2] = c0.z; f[3] = c0.w;
        f[4] = c1.x; f[5] = c1.y; f[6] = c1.z; f[7] = c1.w;
        const float4 b0 = *reinterpret_cast<const float4*>(p.bias + gc);
        const float4 b1 = *reinterpret_cast<const float4*>(p.bias + gc + 4);
        const float bi[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int t = 0; t < 8; ++t) f[t] = apply_act(f[t] + bi[t], p.act);
        uint4 y = pack8(f);
        if (p.residual != nullptr) {
          float r[8];
          unpack8(*reinterpret_cast<const uint4*>(p.residual + (size_t)gr * p.N + gc), r);
          unpack8(y, f);  // the residual adds the bf16-rounded product
#pragma unroll
          for (int t = 0; t < 8; ++t) f[t] = r[t] + f[t];
          y = pack8(f);
        }
        *reinterpret_cast<uint4*>(p.C + (size_t)gr * p.N + gc) = y;
      }
      __syncwarp();
    }
  }
}

// Opts both GEMM kinds in to the shared memory they may use (above the
// 48 KB default), on the current device.
inline cudaError_t gemm_init() {
  cudaError_t err =
      cudaFuncSetAttribute(gemm_bf16_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)gemm_smem_bytes(true, GEMM_MAX_LN_K));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(gemm_bf16_kernel<false>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)gemm_smem_bytes(false, 0));
}

template <bool LN>
inline cudaError_t launch_gemm_t(const GemmArgs& p, cudaStream_t stream) {
  if (LN && p.K > GEMM_MAX_LN_K) return cudaErrorInvalidValue;
  const dim3 grid((p.N + GEMM_BN - 1) / GEMM_BN, (p.M + GEMM_BM - 1) / GEMM_BM);
  gemm_bf16_kernel<LN><<<grid, GEMM_THREADS, gemm_smem_bytes(LN, p.K), stream>>>(p);
  return cudaGetLastError();
}

inline cudaError_t launch_gemm(bool ln, const GemmArgs& p, cudaStream_t stream) {
  return ln ? launch_gemm_t<true>(p, stream) : launch_gemm_t<false>(p, stream);
}

// ---------------------------------------------------------------------------
// Row statistics: one warp per row, 8 bf16 per lane per step.
// ---------------------------------------------------------------------------

constexpr int STATS_THREADS = 256;

__global__ void __launch_bounds__(STATS_THREADS)
    row_stats_kernel(const bf16* __restrict__ x, float* __restrict__ st, int rows, int d,
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
    st[2 * (size_t)row] = mu;
    st[2 * (size_t)row + 1] = 1.0f / sqrtf(var + eps);
  }
}

inline cudaError_t launch_row_stats(const bf16* x, float* st, int rows, int d, float eps,
                                    cudaStream_t stream) {
  const int rows_per_block = STATS_THREADS / 32;
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  row_stats_kernel<<<blocks, STATS_THREADS, 0, stream>>>(x, st, rows, d, eps);
  return cudaGetLastError();
}

}  // namespace VFT_NS
