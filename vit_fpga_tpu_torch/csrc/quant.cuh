// The int8 kernels' row passes (quant_linear.cu K14, mlp_int8.cu K15,
// attn_int8.cu K16, mlp_int8_static.cu K17, attn_int8_static.cu K18,
// mlp_int8_stats.cu K21a, attn_int8_stats.cu K21b, attn_int8_scores.cu
// K22); their GEMMs run on qgemm_wgmma.cuh.  Include after common.cuh.
//
//   quant_rows_kernel<T, LN, STATIC, ST>  one warp per row of a (rows, k)
//       bf16 or f32 matrix: an optional f32 LayerNorm (LN_ONE_PASS: var =
//       max(E[x^2] - mu^2, 0), the JAX int8 blocks' _ln_f32; LN_TWO_PASS:
//       var = mean((x - mu)^2), the fused linear's jnp.var; LN_STATS: no
//       reduction, (mu, rstd) read from the producer's (rows, 2) stats of
//       type ST, f32 or bf16, the int8 chain's halves) with per-column
//       scale and bias, then the row's absmax floored at 1e-12, s = absmax
//       / 127 and q = clip(rint(x / s), -127, 127) as int8.  STATIC (the
//       calibrated scale folded into the LN affine): q = clip(rint(x)),
//       no absmax and no division.
//   quant_amax_kernel   the same quantization of an f32 matrix whose row
//       absmax arrives as per-column-tile partials (qgemm_wgmma.cuh's QW_H
//       epilogue: K15, K21a), so the matrix is read once.
//
// Rounding follows the plain PyTorch versions (ops/quant_*.py): every
// product, sum and quotient of the normalisation and quantization is an
// IEEE round-to-nearest operation in the plain version's order (__fmul_rn
// and friends keep nvcc from contracting them into fma), x / s is a true
// division, rint rounds half to even and the clip stops at -127.  Only the
// f32 LayerNorm sums run in another order.

#pragma once

namespace VFT_NS {

__device__ __forceinline__ signed char quant1(float v, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.0f), 127.0f);
  return static_cast<signed char>(static_cast<int>(q));
}

// ---------------------------------------------------------------------------
// Row quantization: one warp per row, 8 elements per lane per step; k % 8 == 0.
// ---------------------------------------------------------------------------

constexpr int QR_THREADS = 256;
enum { LN_NONE = 0, LN_ONE_PASS = 1, LN_TWO_PASS = 2, LN_STATS = 3 };

__device__ __forceinline__ void load8(const bf16* p, float* f) {
  unpack8(*reinterpret_cast<const uint4*>(p), f);
}
__device__ __forceinline__ void load8(const float* p, float* f) { load8f(p, f); }

__device__ __forceinline__ float stat_f32(float v) { return v; }
__device__ __forceinline__ float stat_f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store_q8(signed char* dst, const float* f, float s) {
  union {
    signed char c[8];
    uint2 u;
  } q;
#pragma unroll
  for (int t = 0; t < 8; ++t) q.c[t] = quant1(f[t], s);
  *reinterpret_cast<uint2*>(dst) = q.u;
}

template <typename T, int LN, bool STATIC, typename ST>
__global__ void __launch_bounds__(QR_THREADS)
    quant_rows_kernel(const T* __restrict__ x, const float* __restrict__ ls,
                      const float* __restrict__ lb, const ST* __restrict__ st,
                      signed char* __restrict__ q, float* __restrict__ s, int rows, int k,
                      float eps) {
  const int row = (blockIdx.x * QR_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + (size_t)row * k;
  float mu = 0.0f, rstd = 1.0f;
  if (LN == LN_STATS) {
    mu = stat_f32(st[2 * (size_t)row]);
    rstd = stat_f32(st[2 * (size_t)row + 1]);
  } else if (LN != LN_NONE) {
    float sm = 0.0f, ss = 0.0f;
    for (int c = lane * 8; c < k; c += 32 * 8) {
      float f[8];
      load8(xr + c, f);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        sm += f[t];
        if (LN == LN_ONE_PASS) ss += f[t] * f[t];
      }
    }
    mu = __fdiv_rn(warp_sum(sm), (float)k);
    float var;
    if (LN == LN_TWO_PASS) {
      for (int c = lane * 8; c < k; c += 32 * 8) {
        float f[8];
        load8(xr + c, f);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float dv = __fsub_rn(f[t], mu);
          ss += dv * dv;
        }
      }
      var = __fdiv_rn(warp_sum(ss), (float)k);
    } else {
      var = fmaxf(__fsub_rn(__fdiv_rn(warp_sum(ss), (float)k), __fmul_rn(mu, mu)), 0.0f);
    }
    rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
  }
  // xn = ((x - mu) * rstd) * scale + bias, in that order
  auto norm8 = [&](int c, float* f) {
    load8(xr + c, f);
    if (LN == LN_NONE) return;
    float sc[8], bi[8];
    load8f(ls + c, sc);
    load8f(lb + c, bi);
#pragma unroll
    for (int t = 0; t < 8; ++t)
      f[t] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f[t], mu), rstd), sc[t]), bi[t]);
  };
  if (STATIC) {  // already in the quant domain
    for (int c = lane * 8; c < k; c += 32 * 8) {
      float f[8];
      norm8(c, f);
      store_rint8(q + (size_t)row * k + c, f);
    }
    return;
  }
  float amax = 0.0f;
  for (int c = lane * 8; c < k; c += 32 * 8) {
    float f[8];
    norm8(c, f);
#pragma unroll
    for (int t = 0; t < 8; ++t) amax = fmaxf(amax, fabsf(f[t]));
  }
  const float sc = __fdiv_rn(fmaxf(warp_max(amax), 1e-12f), 127.0f);
  for (int c = lane * 8; c < k; c += 32 * 8) {
    float f[8];
    norm8(c, f);
    store_q8(q + (size_t)row * k + c, f, sc);
  }
  if (lane == 0) s[row] = sc;
}

// s may be null with STATIC (no scale is written); st is read with LN_STATS
// only.
template <typename T, int LN, bool STATIC = false, typename ST = float>
inline cudaError_t launch_quant_rows(const T* x, const float* ls, const float* lb, signed char* q,
                                     float* s, int rows, int k, float eps, cudaStream_t stream,
                                     const ST* st = nullptr) {
  if (k % 8 || (LN == LN_STATS && st == nullptr)) return cudaErrorInvalidValue;
  const int per_block = QR_THREADS / 32;
  quant_rows_kernel<T, LN, STATIC, ST>
      <<<(rows + per_block - 1) / per_block, QR_THREADS, 0, stream>>>(x, ls, lb, st, q, s, rows,
                                                                      k, eps);
  return cudaGetLastError();
}

// h (rows, k) f32; parts (nparts, rows): per-column-block row absmax.
__global__ void __launch_bounds__(QR_THREADS)
    quant_amax_kernel(const float* __restrict__ h, const float* __restrict__ parts, int nparts,
                      signed char* __restrict__ q, float* __restrict__ s, int rows, int k) {
  const int row = (blockIdx.x * QR_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float amax = 0.0f;
  for (int p = lane; p < nparts; p += 32) amax = fmaxf(amax, parts[(size_t)p * rows + row]);
  const float sc = __fdiv_rn(fmaxf(warp_max(amax), 1e-12f), 127.0f);
  const float* hr = h + (size_t)row * k;
  for (int c = lane * 8; c < k; c += 32 * 8) {
    float f[8];
    load8f(hr + c, f);
    store_q8(q + (size_t)row * k + c, f, sc);
  }
  if (lane == 0) s[row] = sc;
}

inline cudaError_t launch_quant_amax(const float* h, const float* parts, int nparts,
                                     signed char* q, float* s, int rows, int k,
                                     cudaStream_t stream) {
  if (k % 8) return cudaErrorInvalidValue;
  const int per_block = QR_THREADS / 32;
  quant_amax_kernel<<<(rows + per_block - 1) / per_block, QR_THREADS, 0, stream>>>(
      h, parts, nparts, q, s, rows, k);
  return cudaGetLastError();
}

}  // namespace VFT_NS
