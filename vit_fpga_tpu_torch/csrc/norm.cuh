// Row and column reductions for the per-block kernels (mlp.cu,
// attn_bwd.cu, mlp_bwd.cu); include after common.cuh.
//
//   ln_rows   per-row two-pass LayerNorm statistics (the JAX kernels'
//             jnp.var): mu = mean(x), rstd = 1/sqrt(mean((x - mu)^2) + eps),
//             and optionally xn = bf16(((x - mu) * rstd) * scale + bias)
//   ln_bwd    LayerNorm backward plus the residual, per row:
//             dx = bf16(g + (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) * rstd)
//             with dxhat = dxn * scale, and each block's column sums of
//             dxn * xhat (dscale) and dxn (dbias)
//   colsum    column sums of a (rows, cols) bf16 or f32 matrix in f32, in two
//             launches: row slabs of COLSUM_ROWS rows into partial sums, then
//             the partials in slab order.
//
// Every sum runs in a fixed order, with no atomics, so a result is the
// same from run to run.

#pragma once

namespace VFT_NS {

constexpr int LN_THREADS = 256;

// One warp per row, 8 bf16 per lane per step; d % 8 == 0.
__global__ void __launch_bounds__(LN_THREADS)
    ln_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ ls,
                   const float* __restrict__ lb, float* __restrict__ st, bf16* __restrict__ xn,
                   int rows, int d, float eps) {
  const int row = (blockIdx.x * LN_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const bf16* xr = x + (size_t)row * d;
  float s = 0.0f;
  for (int c = lane * 8; c < d; c += 32 * 8) {
    float f[8];
    unpack8(*reinterpret_cast<const uint4*>(xr + c), f);
#pragma unroll
    for (int t = 0; t < 8; ++t) s += f[t];
  }
  const float mu = warp_sum(s) / (float)d;
  float ss = 0.0f;
  for (int c = lane * 8; c < d; c += 32 * 8) {
    float f[8];
    unpack8(*reinterpret_cast<const uint4*>(xr + c), f);
#pragma unroll
    for (int t = 0; t < 8; ++t) ss += (f[t] - mu) * (f[t] - mu);
  }
  const float rstd = 1.0f / sqrtf(warp_sum(ss) / (float)d + eps);
  if (lane == 0) {
    st[2 * (size_t)row] = mu;
    st[2 * (size_t)row + 1] = rstd;
  }
  if (xn == nullptr) return;
  for (int c = lane * 8; c < d; c += 32 * 8) {
    float f[8], sc[8], bi[8];
    unpack8(*reinterpret_cast<const uint4*>(xr + c), f);
    load8f(ls + c, sc);
    load8f(lb + c, bi);
#pragma unroll
    for (int t = 0; t < 8; ++t) f[t] = ((f[t] - mu) * rstd) * sc[t] + bi[t];
    *reinterpret_cast<uint4*>(xn + (size_t)row * d + c) = pack8(f);
  }
}

inline cudaError_t launch_ln_rows(const bf16* x, const float* ls, const float* lb, float* st,
                                  bf16* xn, int rows, int d, float eps, cudaStream_t stream) {
  if (d % 8) return cudaErrorInvalidValue;
  const int rows_per_block = LN_THREADS / 32;
  ln_rows_kernel<<<(rows + rows_per_block - 1) / rows_per_block, LN_THREADS, 0, stream>>>(
      x, ls, lb, st, xn, rows, d, eps);
  return cudaGetLastError();
}

// LN backward: LNB_ROWS rows per block, one warp per row at a time.  Each
// warp sums its rows' dscale / dbias terms into its own shared-memory row
// (lane-owned columns), and the block adds the 8 warp rows in order into
// partials[blockIdx.x] = [dscale (d) | dbias (d)].
constexpr int LNB_ROWS = 64;
constexpr int LNB_WARPS = LN_THREADS / 32;
constexpr int LNB_MAX_D = 2048;

inline size_t ln_bwd_smem_bytes(int d) { return (size_t)LNB_WARPS * 2 * d * sizeof(float); }
inline int ln_bwd_blocks(int rows) { return (rows + LNB_ROWS - 1) / LNB_ROWS; }

__global__ void __launch_bounds__(LN_THREADS)
    ln_bwd_kernel(const bf16* __restrict__ x, const float* __restrict__ st,
                  const float* __restrict__ dxn, const bf16* __restrict__ g,
                  const float* __restrict__ ls, bf16* __restrict__ dx,
                  float* __restrict__ partials, int rows, int d) {
  extern __shared__ __align__(16) float lnb_smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float* acc = lnb_smem + (size_t)warp * 2 * d;
  for (int c = lane; c < 2 * d; c += 32) acc[c] = 0.0f;
  __syncwarp();
  const int r0 = blockIdx.x * LNB_ROWS;
  const int r1 = min(r0 + LNB_ROWS, rows);
  for (int r = r0 + warp; r < r1; r += LNB_WARPS) {
    const float mu = st[2 * (size_t)r];
    const float rstd = st[2 * (size_t)r + 1];
    const bf16* xr = x + (size_t)r * d;
    const float* dr = dxn + (size_t)r * d;
    float s1 = 0.0f, s2 = 0.0f;
    for (int c = lane * 8; c < d; c += 32 * 8) {
      float xf[8], dn[8], sc[8];
      unpack8(*reinterpret_cast<const uint4*>(xr + c), xf);
      load8f(dr + c, dn);
      load8f(ls + c, sc);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float xh = (xf[t] - mu) * rstd;
        const float dxh = dn[t] * sc[t];
        s1 += dxh;
        s2 += dxh * xh;
        acc[c + t] += dn[t] * xh;
        acc[d + c + t] += dn[t];
      }
    }
    const float m1 = warp_sum(s1) / (float)d;
    const float m2 = warp_sum(s2) / (float)d;
    for (int c = lane * 8; c < d; c += 32 * 8) {
      float xf[8], dn[8], sc[8], gf[8];
      unpack8(*reinterpret_cast<const uint4*>(xr + c), xf);
      load8f(dr + c, dn);
      load8f(ls + c, sc);
      unpack8(*reinterpret_cast<const uint4*>(g + (size_t)r * d + c), gf);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float xh = (xf[t] - mu) * rstd;
        const float dxh = dn[t] * sc[t];
        gf[t] = gf[t] + (dxh - m1 - xh * m2) * rstd;
      }
      *reinterpret_cast<uint4*>(dx + (size_t)r * d + c) = pack8(gf);
    }
  }
  __syncthreads();
  for (int c = tid; c < 2 * d; c += LN_THREADS) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < LNB_WARPS; ++w) s += lnb_smem[(size_t)w * 2 * d + c];
    partials[(size_t)blockIdx.x * 2 * d + c] = s;
  }
}

inline cudaError_t ln_bwd_enable() {
  return cudaFuncSetAttribute(ln_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)ln_bwd_smem_bytes(LNB_MAX_D));
}

inline cudaError_t launch_ln_bwd(const bf16* x, const float* st, const float* dxn, const bf16* g,
                                 const float* ls, bf16* dx, float* partials, int rows, int d,
                                 cudaStream_t stream) {
  if (d % 8 || d > LNB_MAX_D) return cudaErrorInvalidValue;
  ln_bwd_kernel<<<ln_bwd_blocks(rows), LN_THREADS, ln_bwd_smem_bytes(d), stream>>>(
      x, st, dxn, g, ls, dx, partials, rows, d);
  return cudaGetLastError();
}

// Column sums.  Stage 1: block (column group of COLSUM_THREADS, row slab)
// writes part[slab][col]; stage 2 adds the slabs in order.
constexpr int COLSUM_THREADS = 256;
constexpr int COLSUM_ROWS = 128;

inline size_t colsum_scratch_floats(int rows, int cols) {
  return (size_t)((rows + COLSUM_ROWS - 1) / COLSUM_ROWS) * cols;
}

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<bf16>(bf16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(COLSUM_THREADS)
    colsum_partial_kernel(const T* __restrict__ src, float* __restrict__ part, int rows,
                          int cols) {
  const int col = blockIdx.x * COLSUM_THREADS + threadIdx.x;
  if (col >= cols) return;
  const int r0 = blockIdx.y * COLSUM_ROWS;
  const int r1 = min(r0 + COLSUM_ROWS, rows);
  float s = 0.0f;
  for (int r = r0; r < r1; ++r) s += to_f32<T>(src[(size_t)r * cols + col]);
  part[(size_t)blockIdx.y * cols + col] = s;
}

__global__ void __launch_bounds__(COLSUM_THREADS)
    colsum_final_kernel(const float* __restrict__ part, float* __restrict__ out, int slabs,
                        int cols) {
  const int col = blockIdx.x * COLSUM_THREADS + threadIdx.x;
  if (col >= cols) return;
  float s = 0.0f;
  for (int i = 0; i < slabs; ++i) s += part[(size_t)i * cols + col];
  out[col] = s;
}

// out (cols,) f32 = column sums of src (rows, cols); scratch holds
// colsum_scratch_floats(rows, cols) floats.
template <typename T>
inline cudaError_t launch_colsum(const T* src, float* out, float* scratch, int rows, int cols,
                                 cudaStream_t stream) {
  const int slabs = (rows + COLSUM_ROWS - 1) / COLSUM_ROWS;
  const int gx = (cols + COLSUM_THREADS - 1) / COLSUM_THREADS;
  colsum_partial_kernel<T><<<dim3(gx, slabs), COLSUM_THREADS, 0, stream>>>(src, scratch, rows,
                                                                            cols);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  colsum_final_kernel<<<gx, COLSUM_THREADS, 0, stream>>>(scratch, out, slabs, cols);
  return cudaGetLastError();
}

}  // namespace VFT_NS
