// K26: the streamed GEMM on Hopper (sm_90a).
//
// Replaces vit_fpga_tpu/ops/streamed_gemm.py:_streamed_kernel (wrapper
// streamed_gemm): out = (x @ w) in x's dtype, x (T, K) and w (K, N) both f32
// or both bf16, every product summed in f32.  The TPU kernel keeps a row
// tile of x resident and streams the K-tiles of W from HBM through two VMEM
// slots with manual DMAs, starting the copy of tile k + 1 before it waits
// for tile k: the double-buffered weight stream of BASELINE config 4.
//
// The pattern is the point, so it is kept: a block owns one output tile,
// and the K-tiles of W and of x stream through two shared-memory slots
// with cp.async (one commit group per tile, zero-fill past K, T and N), so
// the copy of tile k + 1 is in flight while the block computes tile k.
//
//   bf16: a 128 x 128 tile, 8 warps as 4 (rows) x 2 (columns), each warp
//         32 x 64 on ldmatrix + mma.sync.m16n8k16 with f32 accumulators;
//         32-deep K tiles.
//   f32:  a 64 x 64 tile, each of 256 threads 4 x 4 outputs by FMA on the
//         CUDA cores (no TF32: it would round the operands to 10 bits);
//         16-deep K tiles.
//
// What bounds it on the H100: at (584, 1024) x (1024, 4096) bf16 (the
// ViT-L/16 @384 b1 MLP up-projection) 4.9 GFLOP at 989 TFLOP/s, 5.0 us,
// against 14.4 MB at 3.35 TB/s, 4.3 us: operations, barely.  In f32 the
// CUDA cores' 67 TFLOP/s bound it.  A TMA + mbarrier ring feeding wgmma is
// the way to that bound and is later work.
//
// cp.async copies 16 bytes, so rows of x and w must start 16-byte aligned
// and a copy must not straddle the end of K or N: K and N are multiples of
// 8 (bf16) or 4 (f32).  The wrapper zero-pads them, as the TPU wrapper
// pads K to its tile, which changes no sum.

#define VFT_NS streamed_gemm
#include "common.cuh"

namespace VFT_NS {

// ---- bf16 ----------------------------------------------------------------
constexpr int HB_M = 128, HB_N = 128, HB_K = 32;
constexpr int HB_LDA = HB_K + 8;  // bf16 elements per A row in shared memory
constexpr int HB_LDB = HB_N + 8;  // per B (k) row
constexpr int HB_A = HB_M * HB_LDA;
constexpr int HB_B = HB_K * HB_LDB;

__global__ void __launch_bounds__(256)
    gemm_bf16_streamed(const bf16* __restrict__ x, const bf16* __restrict__ w,
                       bf16* __restrict__ out, int T, int K, int N) {
  __shared__ __align__(128) bf16 As[2][HB_A];
  __shared__ __align__(128) bf16 Bs[2][HB_B];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * HB_M, n0 = blockIdx.x * HB_N;

  // Copy plan: two 16-byte chunks of each operand per thread and K tile.
  // A: row c / 4, k chunk (c % 4) * 8.  B: k row c / 16, column (c % 16) * 8.
  auto load = [&](int kt, int s) {
    const int k0 = kt * HB_K;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + 256 * i;
      const int ar = c >> 2, ak = (c & 3) * 8;
      const bool va = m0 + ar < T && k0 + ak < K;
      cp_async16(&As[s][ar * HB_LDA + ak], va ? x + (size_t)(m0 + ar) * K + k0 + ak : x, va);
      const int bk = c >> 4, bn = (c & 15) * 8;
      const bool vb = k0 + bk < K && n0 + bn < N;
      cp_async16(&Bs[s][bk * HB_LDB + bn], vb ? w + (size_t)(k0 + bk) * N + n0 + bn : w, vb);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][j][t] = 0.0f;

  const int nk = (K + HB_K - 1) / HB_K;
  load(0, 0);
  cp_async_commit();
  // ldmatrix addresses: A rows wm*32 + 16 i + lane % 16 at k + 8 (lane / 16);
  // B (k-major) rows k = lane % 16 at column wn*64 + 16 p + 8 (lane / 16),
  // transposed
  const int a_off = (wm * 32 + (lane & 15)) * HB_LDA + (lane >> 4) * 8;
  const int b_off = (lane & 15) * HB_LDB + wn * 64 + (lane >> 4) * 8;
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load(kt + 1, (kt + 1) & 1);
    cp_async_commit();   // one group per tile, empty or not, keeps the count
    cp_async_wait<1>();  // this thread's copies of tile kt landed
    __syncthreads();     // everyone's have
    const bf16* as = As[kt & 1] + a_off;
    const bf16* bs = Bs[kt & 1] + b_off;
#pragma unroll
    for (int kk = 0; kk < HB_K / 16; ++kk) {
      unsigned a[2][4], b[16];
#pragma unroll
      for (int i = 0; i < 2; ++i) ldsm_x4(a[i], as + i * 16 * HB_LDA + kk * 16);
#pragma unroll
      for (int p = 0; p < 4; ++p) ldsm_x4_t(b + 4 * p, bs + kk * 16 * HB_LDB + p * 16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_bf16(acc[i][j], a[i], b[2 * j], b[2 * j + 1]);
    }
    __syncthreads();  // tile kt's slot is free for the copies of tile kt + 2
  }
  cp_async_wait<0>();

  // acc[i][j]: rows wm*32 + 16 i + lane/4 (+ 8), columns wn*64 + 8 j + 2 (lane % 4)
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = m0 + wm * 32 + 16 * i + g + 8 * rr;
      if (row >= T) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + wn * 64 + 8 * j + 2 * t4;
        if (col < N)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
              __floats2bfloat162_rn(acc[i][j][2 * rr], acc[i][j][2 * rr + 1]);
      }
    }
}

// ---- f32 -----------------------------------------------------------------
constexpr int HF_M = 64, HF_N = 64, HF_K = 16;
constexpr int HF_LDA = HF_K + 4;  // floats per A row in shared memory
constexpr int HF_LDB = HF_N + 4;  // per B (k) row

__global__ void __launch_bounds__(256)
    gemm_f32_streamed(const float* __restrict__ x, const float* __restrict__ w,
                      float* __restrict__ out, int T, int K, int N) {
  __shared__ __align__(16) float As[2][HF_M * HF_LDA];
  __shared__ __align__(16) float Bs[2][HF_K * HF_LDB];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * HF_M, n0 = blockIdx.x * HF_N;
  // one 16-byte chunk of each operand per thread and K tile: A row tid / 4,
  // k (tid % 4) * 4; B k row tid / 16, column (tid % 16) * 4
  const int ar = tid >> 2, ak = (tid & 3) * 4;
  const int bk = tid >> 4, bn = (tid & 15) * 4;
  auto load = [&](int kt, int s) {
    const int k0 = kt * HF_K;
    const bool va = m0 + ar < T && k0 + ak < K;
    cp_async16(&As[s][ar * HF_LDA + ak], va ? x + (size_t)(m0 + ar) * K + k0 + ak : x, va);
    const bool vb = k0 + bk < K && n0 + bn < N;
    cp_async16(&Bs[s][bk * HF_LDB + bn], vb ? w + (size_t)(k0 + bk) * N + n0 + bn : w, vb);
  };
  // this thread's outputs: rows ty + 16 i, columns tx + 16 j (conflict-free
  // shared reads: a warp reads two A rows and 16 neighbouring B columns)
  const int tx = tid & 15, ty = tid >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  const int nk = (K + HF_K - 1) / HF_K;
  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* as = As[kt & 1];
    const float* bs = Bs[kt & 1];
#pragma unroll
    for (int kk = 0; kk < HF_K; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[(ty + 16 * i) * HF_LDA + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[kk * HF_LDB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= T) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N) out[(size_t)row * N + col] = acc[i][j];
    }
  }
}

}  // namespace VFT_NS

using namespace VFT_NS;

extern "C" {

// x: (T, K), w: (K, N), out: (T, N), all bf16 when bf16 else f32,
// contiguous on the current device; K and N multiples of 8 (bf16) or 4
// (f32).  Enqueued on `stream`.  Returns a cudaError_t.
int vft_streamed_gemm(const void* x, const void* w, void* out, int T, int K, int N, int bf16_io,
                      void* stream) {
  const int align = bf16_io ? 8 : 4;
  if (T < 1 || K < 1 || N < 1 || K % align || N % align) return cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (bf16_io) {
    const dim3 grid((N + HB_N - 1) / HB_N, (T + HB_M - 1) / HB_M);
    gemm_bf16_streamed<<<grid, 256, 0, st>>>(static_cast<const bf16*>(x),
                                             static_cast<const bf16*>(w),
                                             static_cast<bf16*>(out), T, K, N);
  } else {
    const dim3 grid((N + HF_N - 1) / HF_N, (T + HF_M - 1) / HF_M);
    gemm_f32_streamed<<<grid, 256, 0, st>>>(static_cast<const float*>(x),
                                            static_cast<const float*>(w),
                                            static_cast<float*>(out), T, K, N);
  }
  return cudaGetLastError();
}

}  // extern "C"
