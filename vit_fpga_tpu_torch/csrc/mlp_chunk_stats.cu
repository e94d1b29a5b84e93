// Stats-chain MLP half over column chunks of M on Hopper (sm_90a).
//
// Replaces vit_fpga_tpu/ops/fused_mlp.py:_mlp_chunk_stats_kernel over the
// whole chunk loop of fused_mlp_chunked_stats_pallas (n_chunks launches of
// it on the TPU, one per column chunk of M, the running output
// round-tripping through HBM in the input dtype).  Here it is one call of
// a short sequence of launches on one stream, counted as one ported
// kernel, as K2:
//
//   (a) gw_kernel<LN>     h = bf16(act(LN(x; mu, rstd, ls, lb) @ W1 + b1))
//                         over all M columns.  Every chunk normalises the
//                         same input x from the same stats, so the chunks'
//                         hidden tiles are the column slices of this one h.
//   (b) gw_kernel<CHUNKED> per 128 x 256 output tile, for c = 0 .. n_chunks-1:
//                           y   = h[:, c*mc:(c+1)*mc] @ W2[c*mc:(c+1)*mc, :]
//                                 in f32, + b2 on the last chunk only
//                           acc = bf16(acc + bf16(y)), acc starting at x
//                         The K loop over M runs on without a break in the
//                         TMA ring; at each chunk boundary the tile's
//                         consumers wait for their wgmma groups, run the
//                         epilogue on the chunk's sum (residual x on the
//                         first chunk, then the out they wrote at the
//                         previous boundary) and start the next chunk from
//                         zero.  The running output goes through out, as
//                         the TPU's goes through HBM, and is rounded to
//                         bf16 at each boundary where the TPU's is.
//   (c) row_stats         next (mu, rstd) of out, only when emit_stats is set
//
// In bf16 this is not K2's function: K2 adds one f32 sum over all of M
// (b2 included) to x once.
//
// (a) and (b) are gemm_wgmma.cuh's GEMM (wgmma + TMA, a producer warpgroup
// streaming A and B tiles into a 4-stage ring, two consumer warpgroups of
// 64 rows, the LN applied to the landed A tiles, the activation in (a)'s
// epilogue), as K6's (mlp_chunk.cu) are.  The gate allows a
// chunk of 32 columns past a multiple of the GEMM's 64-deep K step (M a
// multiple of 32 * n_chunks); such a boundary falls between the step's
// second and third wgmma.m64n256k16, and the step is issued in two halves
// around the epilogue.
//
// What bounds it on the H100: at CLIP ViT-L/14 batch 64 (16 896 token rows,
// D = 1024, M = 4096) the call does 4 * T * D * M = 283 GFLOP, so it is
// bound by tensor-core operations (287 us at the H100's 989 TFLOP/s bf16
// peak, 700 W) against about 86 MB of compulsory traffic.  The normalised
// activations never reach device memory and the activation runs in the
// first GEMM's epilogue; the (T, M) bf16 hidden tensor (138 MB at CLIP b64)
// round-trips through device memory, overlapped with the products by the
// ring.  Each chunk boundary but the last adds one epilogue pass a tile
// (the tensor cores idle through it, as in every epilogue of this GEMM)
// and re-reads at most 64 KB of the tile's out, written a chunk earlier,
// from L2.  Measured on an H100 SXM at 700 W in the CLIP forward (quick-
// GELU): 0.69 ms a call, (a) 0.465 ms (305 TFLOP/s: its activation
// epilogue does not overlap the products) and (b) 0.209 ms (679 TFLOP/s,
// the chunk boundary included), so the epilogue, not the chunking, is
// what stands between K3 and its bound.
//
// Every pointer must be 16-byte aligned (TMA), stats 8-byte.
//
// The f32 mode, vft_fused_mlp_stats_f32, is K2's and K3's f32 launch alike
// (K2's wrapper calls it with one chunk): true f32 fma on the CUDA cores,
// gemm_f32.cuh's GEMM for both products and row_stats_f32 for the stats.
//   (a) gemm_f32_kernel<FG_PRO_LN, FG_EPI_BIAS_ACT>
//           h = act(LN(x; mu, rstd, ls, lb) @ W1 + b1), (T, M) f32
//   (b) gemm_f32_kernel<FG_PRO_NONE, FG_EPI_BIAS_RESID>, one launch a
//           chunk over its M / n_chunks columns of h (rows M apart) and rows
//           of W2: out = x + y_0, then out = out + y_c in place,
//           b2 riding the last chunk (in f32 the chunk boundaries change
//           only the order of the sum; they are kept so that the function
//           is the plain version's to the rounding)
//   (c) row_stats_f32   next (mu, rstd) of out's own f32 values
// Bound there: 4 T D M flop at 67 TFLOP/s, 1.80 ms at ViT-B/16 b64 (T 12 800,
// D 768, M 3072), against about 88 MB of compulsory traffic; the (T, M) f32
// hidden tensor (157 MB there) round-trips through device memory.

#define VFT_NS mlp_chunk
#include "common.cuh"
#include "hopper.cuh"
#include "gemm_wgmma.cuh"
#include "gemm_f32.cuh"

using namespace VFT_NS;

extern "C" {

// Finds cuTensorMapEncodeTiled and opts this unit's GEMMs in to the
// shared memory they use, on the current device.  Called once per
// device before the first launch.  Returns a cudaError_t.
int vft_mlp_chunk_init() {
  cudaError_t err = tma_init();
  if (err != cudaSuccess) return err;
  return gw_enable();
}

// x, out: (T, D) bf16; stats, stats_out: (T, 2) f32; ls, lb, b2: (D,) f32;
// w1: (D, M) bf16; b1: (M,) f32; w2: (M, D) bf16; h: (T, M) bf16 scratch.
// n_chunks is 2 or 4; D % 32 == 0 and M % (32 * n_chunks) == 0.  act is
// one of the Act codes in common.cuh.  stats_out may be null.  Everything
// is enqueued on `stream`, which belongs to the current device.  Returns a
// cudaError_t.
int vft_fused_mlp_chunked_stats(const void* x, const void* stats, const void* ls, const void* lb,
                                const void* w1, const void* b1, const void* w2, const void* b2,
                                void* out, void* stats_out, void* h, int t, int d, int m,
                                int n_chunks, int act, float eps, void* stream) {
  if ((n_chunks != 2 && n_chunks != 4) || d % 32 || m % (32 * n_chunks))
    return cudaErrorInvalidValue;
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
  down.bias = static_cast<const float*>(b2);  // the last chunk's
  down.residual = static_cast<const bf16*>(x);
  down.C = static_cast<bf16*>(out);
  down.M = t;
  down.N = d;
  down.K = m;
  down.act = ACT_NONE;
  down.chunk_k = m / n_chunks;
  if ((err = launch_gemm_wgmma(static_cast<const bf16*>(h), static_cast<const bf16*>(w2), false,
                               down, st)) != cudaSuccess)
    return err;

  if (stats_out != nullptr &&
      (err = launch_row_stats(static_cast<const bf16*>(out), static_cast<float*>(stats_out), t,
                              d, eps, st)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

// x, out: (T, D) f32; stats, stats_out: (T, 2) f32; ls, lb, b2: (D,) f32;
// w1: (D, M) f32; b1: (M,) f32; w2: (M, D) f32; h: (T, M) f32 scratch.
// n_chunks is 1, 2 or 4; D % 4 == 0 and M % (4 * n_chunks) == 0.  act is
// one of the Act codes in common.cuh.  stats_out may be null.  Everything
// is enqueued on `stream`, which belongs to the current device.  Returns a
// cudaError_t.
int vft_fused_mlp_stats_f32(const void* x, const void* stats, const void* ls, const void* lb,
                            const void* w1, const void* b1, const void* w2, const void* b2,
                            void* out, void* stats_out, void* h, int t, int d, int m,
                            int n_chunks, int act, float eps, void* stream) {
  if ((n_chunks != 1 && n_chunks != 2 && n_chunks != 4) || d % 4 || m % (4 * n_chunks))
    return cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;

  FgArgs up{};
  up.A = static_cast<const float*>(x);
  up.B = static_cast<const float*>(w1);
  up.C = static_cast<float*>(h);
  up.M = t;
  up.N = m;
  up.K = d;
  up.stats = static_cast<const float*>(stats);
  up.ls = static_cast<const float*>(ls);
  up.lb = static_cast<const float*>(lb);
  up.bias = static_cast<const float*>(b1);
  up.act = act;
  if ((err = launch_gemm_f32<FG_PRO_LN, FG_EPI_BIAS_ACT>(up, st)) != cudaSuccess) return err;

  // the chunks in order, each over its M / n_chunks columns of h and rows
  // of W2 into the running output (x first, then out itself), b2 riding
  // the last
  const int mc = m / n_chunks;
  for (int c = 0; c < n_chunks; ++c) {
    FgArgs down{};
    down.A = static_cast<const float*>(h) + (size_t)c * mc;
    down.lda = m;
    down.B = static_cast<const float*>(w2) + (size_t)c * mc * d;
    down.C = static_cast<float*>(out);
    down.M = t;
    down.N = d;
    down.K = mc;
    down.bias = c == n_chunks - 1 ? static_cast<const float*>(b2) : nullptr;
    down.resid = c == 0 ? static_cast<const float*>(x) : static_cast<const float*>(out);
    if ((err = launch_gemm_f32<FG_PRO_NONE, FG_EPI_BIAS_RESID>(down, st)) != cudaSuccess) return err;
  }

  if (stats_out != nullptr &&
      (err = launch_row_stats_f32(static_cast<const float*>(out),
                                  static_cast<float*>(stats_out), t, d, eps, st)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

}  // extern "C"
