// Stats-chain MLP half on Hopper (sm_90a).
//
// Replaces vit_fpga_tpu/ops/fused_mlp.py:_mlp_stats_kernel, one Pallas
// kernel on the TPU.  Here it is a short sequence of launches on one
// stream, counted as one ported kernel:
//
//   (a) gw_kernel<LN>   h = bf16(act(LN(x; mu, rstd, ls, lb) @ W1 + b1))
//   (b) gw_kernel       out = x + bf16(h @ W2 + b2)
//   (c) row_stats       next (mu, rstd) of out, only when emit_stats is set
//
// (a) and (b) are gemm_wgmma.cuh's GEMM: wgmma + TMA, a producer warpgroup
// streaming the A and B tiles into a shared-memory ring and two consumer
// warpgroups, the LN applied to the landed A tiles in shared memory and the
// activation in (a)'s epilogue.
//
// What bounds it on the H100: at ViT-B/16 batch 64 (12 800 token rows,
// D = 768, M = 3072) the launch does 4 T D M = 121 GFLOP, so it is bound by
// tensor-core operations (122 us at 989 TFLOP/s, 700 W).  The normalised
// activations never reach device memory.  The (rows, M) bf16 hidden tensor
// h (79 MB at ViT-B b64) still round-trips through device memory, about
// 47 us of HBM traffic that overlaps the products: keeping it on chip means
// one block holding an output row block's 768 f32 columns, 128 x 768 f32 =
// 384 registers a thread over two consumer warpgroups, so three or more
// warpgroups must split it; that is later work.

#define VFT_NS mlp_half
#include "common.cuh"
#include "hopper.cuh"
#include "gemm_wgmma.cuh"

using namespace VFT_NS;

extern "C" {

// Finds the driver's tensor-map encoder and opts this unit's GEMMs in to
// the shared memory they use, on the current device.  Called once per
// device before the first launch.  Returns a cudaError_t.
int vft_mlp_init() {
  cudaError_t err = tma_init();
  if (err != cudaSuccess) return err;
  return gw_enable();
}

// x, out: (T, D) bf16; stats, stats_out: (T, 2) f32; ls, lb, b2: (D,) f32;
// w1: (D, M) bf16; b1: (M,) f32; w2: (M, D) bf16; h: (T, M) bf16 scratch;
// every pointer 16-byte aligned, D and M multiples of 8.  act is one of the
// Act codes in common.cuh.  stats_out may be null.  Everything is enqueued
// on `stream`, which belongs to the current device.  Returns a cudaError_t.
int vft_fused_mlp_stats(const void* x, const void* stats, const void* ls, const void* lb,
                        const void* w1, const void* b1, const void* w2, const void* b2,
                        void* out, void* stats_out, void* h, int t, int d, int m, int act,
                        float eps, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (tma_encoder() == nullptr) return cudaErrorInitializationError;
  cudaError_t err;

  GwArgs up{};
  up.stats = static_cast<const float*>(stats);
  up.ln_scale = static_cast<const float*>(ls);
  up.ln_bias = static_cast<const float*>(lb);
  up.bias = static_cast<const float*>(b1);
  up.residual = nullptr;
  up.C = static_cast<bf16*>(h);
  up.M = t;
  up.N = m;
  up.K = d;
  up.act = act;
  if ((err = launch_gemm_wgmma(static_cast<const bf16*>(x), static_cast<const bf16*>(w1), true,
                               up, st)) != cudaSuccess)
    return err;

  GwArgs down{};
  down.bias = static_cast<const float*>(b2);
  down.residual = static_cast<const bf16*>(x);
  down.C = static_cast<bf16*>(out);
  down.M = t;
  down.N = d;
  down.K = m;
  down.act = ACT_NONE;
  if ((err = launch_gemm_wgmma(static_cast<const bf16*>(h), static_cast<const bf16*>(w2), false,
                               down, st)) != cudaSuccess)
    return err;

  if (stats_out != nullptr &&
      (err = launch_row_stats(static_cast<const bf16*>(out), static_cast<float*>(stats_out), t,
                              d, eps, st)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

}  // extern "C"
