// Int8 pieces of the int8 kernels (quant_linear.cu K14, mlp_int8.cu K15,
// attn_int8.cu K16, mlp_int8_static.cu K17, attn_int8_static.cu K18,
// mlp_int8_stats.cu K21a, attn_int8_stats.cu K21b, attn_int8_scores.cu
// K22): the row passes serve them all; the wmma GEMM serves K14 alone
// (K13, K15-K18, K21a, K21b and K22 run qgemm_wgmma.cuh's); include after
// common.cuh.
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
//   qgemm_kernel<EPI_PLAIN>   C = act(A B^T dequantized) in bf16 or f32
//       (K14's fused linear): int8 A (M, K) and B (N, K), both
//       k-contiguous, on nvcuda::wmma 16x16x16 signed-char fragments with
//       exact int32 accumulation; the epilogue dequantizes as the TPU
//       kernels do, f = float(acc) * (sa[m] * sb[n]) + bias[n] (a null sa
//       is a row scale of 1.0: f = float(acc) * sb[n] + bias[n] exactly),
//       then act(f).  The static int8 epilogue's activation times its
//       scale, qact_scaled, lives in common.cuh (qgemm_wgmma.cuh's QW_Q8,
//       stack_wgmma.cuh's LQ_STATIC).
//
// Rounding follows the plain PyTorch versions (ops/quant_*.py): every
// product, sum and quotient of the normalisation, quantization and
// dequantization is an IEEE round-to-nearest operation in the plain
// version's order (__fmul_rn and friends keep nvcc from contracting them
// into fma), x / s is a true division, rint rounds half to even and the
// clip stops at -127.  Only the f32 LayerNorm sums run in another order.

#pragma once

namespace VFT_NS {

// Activation code of the fused linear's textbook tanh-GELU,
// jax.nn.gelu(approximate=True): h * 0.5 * (1 + tanh(c * (h + 0.044715 h^3))).
// The int8 blocks (K15) take the fma form, ACT_GELU_TANH.
constexpr int ACT_GELU_TANH_JAX = 5;

__device__ __forceinline__ float qact(float h, int act) {
  if (act == ACT_GELU_TANH_JAX) {  // each step rounded, as jax.nn.gelu's ops are
    const float h3 = __fmul_rn(__fmul_rn(h, h), h);
    const float u = __fmul_rn(0.7978846f, __fadd_rn(h, __fmul_rn(0.044715f, h3)));
    return __fmul_rn(h, __fmul_rn(0.5f, __fadd_rn(1.0f, tanhf(u))));
  }
  return apply_act(h, act);
}

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

// ---------------------------------------------------------------------------
// Int8 GEMM: block tile 128 x 128 x 64, 8 warps as 2 (rows) x 4 (cols), each
// warp a 64 x 32 patch of 4 x 2 int32 fragments.  A stage holds each
// operand as QG_BK / 16 slabs of [128 rows][16 bytes], so every fragment
// starts on a 256-byte boundary (wmma's alignment) with a 16-byte row
// stride; cp.async fills a QG_STAGES-deep ring of stages.  Rows past M or
// N and k past K are zero-filled: K must be a multiple of 16, M and N are
// free.
// ---------------------------------------------------------------------------

enum { EPI_PLAIN = 0 };

constexpr int QG_BM = 128;
constexpr int QG_BN = 128;
constexpr int QG_BK = 64;
constexpr int QG_SLAB = 16;
constexpr int QG_STAGES = 4;
constexpr int QG_THREADS = 256;
constexpr int QG_TILE = QG_BM * QG_BK;  // bytes of one operand's stage
constexpr int QG_C_LD = 16 + 4;         // int32 staging of one fragment per warp
constexpr size_t QG_SMEM = (size_t)QG_STAGES * 2 * QG_TILE;

static_assert(QG_BM == QG_BN, "one chunk plan serves both operands");
static_assert(QG_SMEM >= (QG_THREADS / 32) * 16 * QG_C_LD * sizeof(float),
              "the epilogue staging reuses the operand ring");

struct QGemmArgs {
  const signed char* A;  // (M, K) row-major int8
  const float* sa;       // (M,) f32 row scales, or null for 1.0
  const signed char* B;  // (N, K) row-major int8 (the (K, N) weight, transposed)
  const float* sb;       // (N,) f32 column scales
  const float* bias;     // (N,) f32
  void* C;               // (M, N): bf16, or f32 with c_f32
  int M, N, K;
  int act;
  int c_f32;
};

template <int EPI>
__global__ void __launch_bounds__(QG_THREADS, 2) qgemm_kernel(QGemmArgs p) {
  extern __shared__ __align__(128) unsigned char qg_smem[];
  signed char* As = reinterpret_cast<signed char*>(qg_smem);
  signed char* Bs = As + QG_STAGES * QG_TILE;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp >> 2;  // 0..1
  const int wn = warp & 3;   // 0..3
  const int m0 = blockIdx.y * QG_BM;
  const int n0 = blockIdx.x * QG_BN;

  // Copy plan: 128 rows x 4 chunks of 16 bytes per operand and stage, two
  // chunks per thread; four neighbouring threads read one row's 64 bytes.
  const signed char* asrc[2];
  const signed char* bsrc[2];
  int soff[2], kof[2];
  bool aok[2], bok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * QG_THREADS;
    const int r = c >> 2, kc = c & 3;
    soff[i] = kc * QG_BM * QG_SLAB + r * QG_SLAB;
    kof[i] = kc * QG_SLAB;
    aok[i] = m0 + r < p.M;
    bok[i] = n0 + r < p.N;
    asrc[i] = p.A + (aok[i] ? (size_t)(m0 + r) * p.K + kof[i] : 0);
    bsrc[i] = p.B + (bok[i] ? (size_t)(n0 + r) * p.K + kof[i] : 0);
  }
  auto load_stage = [&](int s, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool kin = k0 + kof[i] < p.K;
      const bool va = aok[i] && kin, vb = bok[i] && kin;
      cp_async16(As + s * QG_TILE + soff[i], va ? asrc[i] + k0 : p.A, va);
      cp_async16(Bs + s * QG_TILE + soff[i], vb ? bsrc[i] + k0 : p.B, vb);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  const int nk = (p.K + QG_BK - 1) / QG_BK;
#pragma unroll
  for (int s = 0; s < QG_STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s * QG_BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % QG_STAGES;
    cp_async_wait<QG_STAGES - 2>();
    __syncthreads();  // step kt landed for everyone; step kt-1 is consumed
    const int next = kt + QG_STAGES - 1;
    if (next < nk) load_stage(next % QG_STAGES, next * QG_BK);
    cp_async_commit();
    const signed char* as = As + s * QG_TILE;
    const signed char* bs = Bs + s * QG_TILE;
#pragma unroll
    for (int kk = 0; kk < QG_BK / QG_SLAB; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> af[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(af[i], as + kk * QG_BM * QG_SLAB + (wm * 64 + i * 16) * QG_SLAB,
                               QG_SLAB);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], bs + kk * QG_BN * QG_SLAB + (wn * 32 + j * 16) * QG_SLAB,
                               QG_SLAB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the epilogue stages through it

  // Epilogue, one fragment at a time: lane L owns row L/2, columns
  // 8*(L%2) .. +8 of the fragment.
  int* cs = reinterpret_cast<int*>(qg_smem) + warp * 16 * QG_C_LD;
  const int er = lane >> 1;
  const int ec = (lane & 1) * 8;
  const bool c_f32 = p.c_f32;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], QG_C_LD, wmma::mem_row_major);
      __syncwarp();
      const int gr = m0 + wm * 64 + i * 16 + er;
      const int gc = n0 + wn * 32 + j * 16 + ec;
      if (gr < p.M && gc < p.N) {
        const bool vec = gc + 8 <= p.N && p.N % 8 == 0;
        const float srow = p.sa != nullptr ? p.sa[gr] : 1.0f;
        const int* src = cs + er * QG_C_LD + ec;
        float f[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          if (gc + t < p.N) {
            const float v = __fmul_rn((float)src[t], __fmul_rn(srow, p.sb[gc + t]));
            f[t] = __fadd_rn(v, p.bias[gc + t]);
          } else {
            f[t] = 0.0f;
          }
        }
        const size_t off = (size_t)gr * p.N + gc;
#pragma unroll
        for (int t = 0; t < 8; ++t) f[t] = qact(f[t], p.act);
        if (c_f32) {
          float* dst = static_cast<float*>(p.C) + off;
          if (vec) {
            store8f(dst, f);
          } else {
#pragma unroll
            for (int t = 0; t < 8; ++t)
              if (gc + t < p.N) dst[t] = f[t];
          }
        } else {
          bf16* dst = static_cast<bf16*>(p.C) + off;
          if (vec) {
            *reinterpret_cast<uint4*>(dst) = pack8(f);
          } else {
#pragma unroll
            for (int t = 0; t < 8; ++t)
              if (gc + t < p.N) dst[t] = __float2bfloat16(f[t]);
          }
        }
      }
      __syncwarp();
    }
  }
}

template <int EPI>
inline cudaError_t qgemm_enable() {
  return cudaFuncSetAttribute(qgemm_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)QG_SMEM);
}

template <int EPI>
inline cudaError_t launch_qgemm(const QGemmArgs& p, cudaStream_t stream) {
  if (p.K % QG_SLAB || p.M < 1 || p.N < 1 || p.bias == nullptr) return cudaErrorInvalidValue;
  const dim3 grid((p.N + QG_BN - 1) / QG_BN, (p.M + QG_BM - 1) / QG_BM);
  qgemm_kernel<EPI><<<grid, QG_THREADS, QG_SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace VFT_NS
