// Shared device code for the port's kernels.
//
//   activations  the Act codes, act(h) and act'(h) in f32, and act(h) * s
//                with a static int8 scale folded in (qact_scaled)
//   bf16 / int8  packing, rounding and the quant domain's rint_sat
//   reductions   quad, warp sums and maxima
//   cp.async     16-byte global -> shared copies with zero fill
//   row_stats    per-row one-pass LayerNorm statistics in f32:
//                mu = mean(x), rstd = 1/sqrt(max(mean(x^2) - mu^2, 0) + eps),
//                stored as f32 or (the int8 chain's bf16 tiles) rounded to bf16.
//
// The per-block and chain kernels' bf16 GEMMs run on gemm_wgmma.cuh (wgmma
// + TMA), the int8 ones on qgemm_wgmma.cuh, and the single-launch encoders
// on stack_wgmma.cuh's layer loop.
// Everything lives in the namespace VFT_NS, which each
// translation unit defines before including this header: each gets its own
// copy of the kernels, under a name that tells the launch sites apart in a
// trace.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#ifndef VFT_NS
#error "define VFT_NS before including common.cuh"
#endif

namespace VFT_NS {

using bf16 = __nv_bfloat16;

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

// The fma-form tanh-GELU, quick_gelu or relu in f32 with each product and
// sum rounded on its own (no contraction into fma), as the plain versions
// compute them (fused_mlp._act): the activation of the single-launch
// encoders' W1 epilogue (stack_wgmma.cuh) and of K15's (qgemm_wgmma.cuh).
__device__ __forceinline__ float act_rn(float h, int act) {
  if (act == ACT_RELU) return fmaxf(h, 0.0f);
  if (act == ACT_QUICK_GELU) return __fmul_rn(h, __frcp_rn(__fadd_rn(1.0f, expf(__fmul_rn(-1.702f, h)))));
  const float h2 = __fmul_rn(h, h);
  const float u = __fmul_rn(h, __fadd_rn(0.7978845608028654f, __fmul_rn(0.035677408136300125f, h2)));
  const float hh = __fmul_rn(0.5f, h);
  return __fadd_rn(hh, __fmul_rn(hh, tanhf(u)));
}

// Activation code of the fused linear's textbook tanh-GELU,
// jax.nn.gelu(approximate=True): h * 0.5 * (1 + tanh(c * (h + 0.044715 h^3))).
// The int8 blocks (K15) take the fma form, ACT_GELU_TANH.
constexpr int ACT_GELU_TANH_JAX = 5;

// K14's activation (qgemm_wgmma.cuh's QW_ACT): the textbook tanh-GELU with
// each step rounded, as jax.nn.gelu's ops are, else apply_act.
__device__ __forceinline__ float qact(float h, int act) {
  if (act == ACT_GELU_TANH_JAX) {
    const float h3 = __fmul_rn(__fmul_rn(h, h), h);
    const float u = __fmul_rn(0.7978846f, __fadd_rn(h, __fmul_rn(0.044715f, h3)));
    return __fmul_rn(h, __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(u))));
  }
  return apply_act(h, act);
}

// act(h) * s with the static scale folded into the emission constants, in
// the order of the JAX kernels' _apply_act_scaled: gelu_tanh's 0.5 * h
// becomes (0.5 * s) * h, quick_gelu (s * h) * sigmoid(1.702 h), relu
// max(s * h, 0); each product and sum rounded on its own.
__device__ __forceinline__ float qact_scaled(float h, int act, float s) {
  switch (act) {
    case ACT_GELU_TANH: {
      const float h2 = __fmul_rn(h, h);
      const float u = __fmul_rn(h, __fadd_rn(0.7978845608028654f, __fmul_rn(0.035677408136300125f, h2)));
      const float hh = __fmul_rn(__fmul_rn(0.5f, s), h);
      return __fadd_rn(hh, __fmul_rn(hh, tanhf(u)));
    }
    case ACT_QUICK_GELU:
      return __fmul_rn(__fmul_rn(s, h), __frcp_rn(__fadd_rn(1.0f, expf(__fmul_rn(-1.702f, h)))));
    case ACT_RELU:
      return fmaxf(__fmul_rn(s, h), 0.0f);
    default:
      return __fmul_rn(s, h);
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
