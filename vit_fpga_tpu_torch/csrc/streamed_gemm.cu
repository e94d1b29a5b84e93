// K26: the streamed GEMM on Hopper (sm_90a).
//
// Replaces vit_fpga_tpu/ops/streamed_gemm.py:_streamed_kernel (wrapper
// streamed_gemm): out = (x @ w) in x's dtype, x (T, K) and w (K, N) both f32
// or both bf16, every product summed in f32.  The TPU kernel keeps a row
// tile of x resident and streams the K-tiles of W from HBM through two VMEM
// slots with manual DMAs, starting the copy of tile k + 1 before it waits
// for tile k: the double-buffered weight stream of BASELINE config 4.
//
//   bf16: gemm_wgmma.cuh's persistent GEMM (no LN, no bias, no residual,
//         ACT_NONE): one block an SM walks 128 x 256 output tiles, one
//         producer thread streams the 64-deep K tiles of x and W by TMA into
//         a 4-stage mbarrier ring, two consumer warpgroups issue
//         wgmma.m64n256k16 on each landed stage.  The same weight stream as
//         the TPU's, four stages deep instead of two, in place of
//         128 x 128 mma.sync tiles fed by a two-slot cp.async ring.
//   f32:  a 64 x 64 tile, each of 256 threads 4 x 4 outputs by FMA on the
//         CUDA cores (no TF32: it would round the operands to 10 bits);
//         16-deep K tiles of x and W through two shared-memory slots with
//         cp.async (one commit group per tile, zero-fill past K, T and N),
//         the copy of tile k + 1 in flight while the block computes tile k.
//
// What bounds it on the H100: at (584, 1024) x (1024, 4096) bf16 (the
// ViT-L/16 @384 b1 MLP up-projection) 4.9 GFLOP at 989 TFLOP/s, 5.0 us,
// against 14.4 MB at 3.35 TB/s, 4.3 us: operations, barely.  There the
// GEMM has 5 x 16 = 80 tiles for 132 SMs, one partial wave of 16 K steps
// each: a tile is 67 MFLOP, 9 us at one SM's share of the peak, plus the
// ring's fill and the epilogue, so the tile's latency, not the card's rate,
// sets the time.  Measured on an H100 SXM at 700 W: 13.5 us of device time
// a call, 0.58 us a 64-deep K step (96% of one SM's share of the peak, on
// the 80 SMs that hold a tile) plus ~4 us of launch, fill and epilogue;
// spreading the K steps over all 132 SMs (stream-K) is what would close
// the rest.  In f32 the CUDA cores' 67 TFLOP/s bound it.
//
// TMA and cp.async copy 16-byte pieces, so rows of x and w must start
// 16-byte aligned: K and N are multiples of 8 (bf16) or 4 (f32).  The
// wrapper zero-pads them, as the TPU wrapper pads K to its tile, which
// changes no sum.

#define VFT_NS streamed_gemm
#include "common.cuh"
#include "hopper.cuh"
#include "gemm_wgmma.cuh"

namespace VFT_NS {

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

// Finds cuTensorMapEncodeTiled and opts the bf16 GEMM in to the shared
// memory it uses, on the current device.  Called once per device
// before the first launch.  Returns a cudaError_t.
int vft_streamed_gemm_init() {
  cudaError_t err = tma_init();
  if (err != cudaSuccess) return err;
  return gw_enable();
}

// x: (T, K), w: (K, N), out: (T, N), all bf16 when bf16 else f32,
// contiguous on the current device, 16-byte aligned; K and N multiples of
// 8 (bf16) or 4 (f32).  Enqueued on `stream`.  Returns a cudaError_t.
int vft_streamed_gemm(const void* x, const void* w, void* out, int T, int K, int N, int bf16_io,
                      void* stream) {
  const int align = bf16_io ? 8 : 4;
  if (T < 1 || K < 1 || N < 1 || K % align || N % align) return cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (bf16_io) {
    if (tma_encoder() == nullptr) return cudaErrorInitializationError;
    GwArgs p{};
    p.C = static_cast<bf16*>(out);
    p.M = T;
    p.N = N;
    p.K = K;
    p.act = ACT_NONE;
    return launch_gemm_wgmma(static_cast<const bf16*>(x), static_cast<const bf16*>(w), false, p,
                             st);
  }
  const dim3 grid((N + HF_N - 1) / HF_N, (T + HF_M - 1) / HF_M);
  gemm_f32_streamed<<<grid, 256, 0, st>>>(static_cast<const float*>(x),
                                          static_cast<const float*>(w),
                                          static_cast<float*>(out), T, K, N);
  return cudaGetLastError();
}

}  // extern "C"
