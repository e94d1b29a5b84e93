// Stats-chain MLP half over column chunks of M on Hopper (sm_90a).
//
// Replaces vit_fpga_tpu/ops/fused_mlp.py:_mlp_chunk_stats_kernel over the
// whole chunk loop of fused_mlp_chunked_stats_pallas (n_chunks launches of
// it on the TPU, one per column chunk of M, the running output
// round-tripping through HBM in the input dtype).  Here it is one call of
// a short sequence of launches on one stream, counted as one ported
// kernel, as K2:
//
//   (a) gemm_bf16<LN>     h = bf16(act(LN(x; mu, rstd, ls, lb) @ W1 + b1))
//                         over all M columns.  Every chunk normalises the
//                         same input x from the same stats, so the chunks'
//                         hidden tiles are the column slices of this one h.
//   (b) chunk_down_kernel per 128 x 128 output tile, for c = 0 .. n_chunks-1:
//                           y   = h[:, c*mc:(c+1)*mc] @ W2[c*mc:(c+1)*mc, :]
//                                 in f32, + b2 on the last chunk only
//                           acc = bf16(acc + bf16(y)), acc starting at x
//                         The running acc stays in registers across the
//                         chunks and is rounded to bf16 at each chunk
//                         boundary, where the TPU's round trip through HBM
//                         rounds it; only the last chunk writes it out.
//   (c) row_stats         next (mu, rstd) of out, only when emit_stats is set
//
// In bf16 this is not K2's function: K2 adds one f32 sum over all of M
// (b2 included) to x once.
//
// What bounds it on the H100: at CLIP ViT-L/14 batch 64 (16 896 token rows,
// D = 1024, M = 4096) the call does 4 * T * D * M = 283 GFLOP, so it is
// bound by tensor-core operations (287 us at the H100's 989 TFLOP/s bf16
// peak, 700 W) against about 86 MB of compulsory traffic.  As in K2 the
// normalised activations never reach device memory and the activation
// runs in the first GEMM's epilogue; the (T, M) bf16 hidden tensor
// round-trips through device memory, and the GEMMs run on wmma fragments
// (wgmma and TMA are later work).

#define VFT_NS mlp_chunk
#include "common.cuh"
#include "chunk.cuh"

using namespace VFT_NS;

extern "C" {

// Opts this unit's kernels in to the shared memory they use, on the
// current device.  Called once per device before the first launch.
// Returns a cudaError_t.
int vft_mlp_chunk_init() {
  cudaError_t err = gemm_enable<true, false, false>();
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(chunk_down_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)chunk_down_smem_bytes());
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
  cudaError_t err;

  GemmArgs up{};
  up.A = static_cast<const bf16*>(x);
  up.stats = static_cast<const float*>(stats);
  up.ln_scale = static_cast<const float*>(ls);
  up.ln_bias = static_cast<const float*>(lb);
  up.B = static_cast<const bf16*>(w1);
  up.bias = static_cast<const float*>(b1);
  up.residual = nullptr;
  up.C = static_cast<bf16*>(h);
  up.M = t;
  up.N = m;
  up.K = d;
  up.act = act;
  if ((err = launch_gemm_t<true, false, false>(up, st)) != cudaSuccess) return err;

  ChunkDownArgs down{};
  down.h = static_cast<const bf16*>(h);
  down.w2 = static_cast<const bf16*>(w2);
  down.b2 = static_cast<const float*>(b2);
  down.x = static_cast<const bf16*>(x);
  down.out = static_cast<bf16*>(out);
  down.T = t;
  down.D = d;
  down.M = m;
  down.n_chunks = n_chunks;
  if ((err = launch_chunk_down(down, st)) != cudaSuccess) return err;

  if (stats_out != nullptr &&
      (err = launch_row_stats(static_cast<const bf16*>(out), static_cast<float*>(stats_out), t,
                              d, eps, st)) != cudaSuccess)
    return err;
  return cudaGetLastError();
}

}  // extern "C"
