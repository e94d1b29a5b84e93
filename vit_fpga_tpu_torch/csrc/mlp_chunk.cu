// Per-block MLP half over column chunks of M on Hopper (sm_90a), the MLP
// that _block runs under mlp_impl="pallas" where the weights take chunks
// (ViT-L: 2, ViT-H: 4).
//
// Replaces vit_fpga_tpu/ops/fused_mlp.py:_mlp_chunk_kernel over the whole
// chunk loop of fused_mlp_chunked_pallas (n_chunks launches of it on the
// TPU, one per column chunk of M, the running output round-tripping through
// HBM in the input dtype).  Here it is one call of a short sequence of
// launches on one stream, counted as one ported kernel, as K5:
//
//   (a) ln_rows           two-pass (mu, rstd) of x (the TPU kernel's jnp.var;
//                         every chunk recomputes the same LN of the same x)
//   (b) gw_kernel<LN>     h = bf16(act(LN(x; mu, rstd, ls, lb) @ W1 + b1))
//                         over all M columns: the chunks' hidden tiles are
//                         the column slices of this one h
//   (c) gw_kernel<CHUNKED> out = the running output over the chunks, acc =
//                         bf16(acc + bf16(h_c @ W2_c [+ b2 on the last
//                         chunk])), acc starting at x
//
// (b) and (c) are exactly K3's two launches (mlp_chunk_stats.cu) on
// gemm_wgmma.cuh's wgmma + TMA GEMM, fed the two-pass statistics of (a) in
// place of the chain's one-pass stats input, with no stats output.  In
// bf16 it is not K5's function: K5 adds one f32 sum over all of M to x
// once.
//
// What bounds it on the H100: at ViT-L/16 batch 8 (1 600 token rows,
// D = 1024, M = 4096) the call does 4 * T * D * M = 26.8 GFLOP, so it is
// bound by tensor-core operations (27 us at 989 TFLOP/s, 700 W) against
// about 23 MB of compulsory traffic.  The normalised activations never
// reach device memory (LN is applied to the landed A tiles in shared
// memory) and the activation runs in (b)'s epilogue; the (T, M) bf16
// hidden tensor round-trips through device memory.  At that shape (b) is
// 13 x 16 = 208 tiles of 128 x 256 (1.6 waves of 132 SMs) and (c) 13 x 4 =
// 52, one partial wave, which stays its limit: the chunks' bf16 rounding of
// the running output rules out splitting its K loop.
//
// Every pointer must be 16-byte aligned (TMA), stats 8-byte.

#define VFT_NS mlp_chunk_blk
#include "common.cuh"
#include "hopper.cuh"
#include "gemm_wgmma.cuh"
#include "norm.cuh"

using namespace VFT_NS;

extern "C" {

// Finds cuTensorMapEncodeTiled and opts this unit's GEMMs in to the
// shared memory they use, on the current device.  Called once per device
// before the first launch.  Returns a cudaError_t.
int vft_mlp_chunk_blk_init() {
  cudaError_t err = tma_init();
  if (err != cudaSuccess) return err;
  return gw_enable();
}

// x, out: (T, D) bf16; ls, lb, b2: (D,) f32; w1: (D, M) bf16; b1: (M,) f32;
// w2: (M, D) bf16.  Scratch: stats (T, 2) f32, h (T, M) bf16.  n_chunks is
// 2 or 4; D % 32 == 0 and M % (32 * n_chunks) == 0.  act is one of the Act
// codes in common.cuh.  Everything is enqueued on `stream`, which belongs
// to the current device.  Returns a cudaError_t.
int vft_fused_mlp_chunked(const void* x, const void* ls, const void* lb, const void* w1,
                          const void* b1, const void* w2, const void* b2, void* out, void* stats,
                          void* h, int t, int d, int m, int n_chunks, int act, float eps,
                          void* stream) {
  if ((n_chunks != 2 && n_chunks != 4) || d % 32 || m % (32 * n_chunks))
    return cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (tma_encoder() == nullptr) return cudaErrorInitializationError;
  const bf16* xb = static_cast<const bf16*>(x);
  cudaError_t err;
  if ((err = launch_ln_rows(xb, nullptr, nullptr, static_cast<float*>(stats), nullptr, t, d, eps,
                            st)) != cudaSuccess)
    return err;

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
  if ((err = launch_gemm_wgmma(xb, static_cast<const bf16*>(w1), true, up, st)) != cudaSuccess)
    return err;

  GwArgs down{};
  down.bias = static_cast<const float*>(b2);  // the last chunk's
  down.residual = xb;
  down.C = static_cast<bf16*>(out);
  down.M = t;
  down.N = d;
  down.K = m;
  down.act = ACT_NONE;
  down.chunk_k = m / n_chunks;
  if ((err = launch_gemm_wgmma(static_cast<const bf16*>(h), static_cast<const bf16*>(w2), false,
                               down, st)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

}  // extern "C"
